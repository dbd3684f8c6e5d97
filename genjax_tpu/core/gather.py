"""Fused row-gather over pytrees: the fast path for particle resampling.

New capability with no reference counterpart (the reference ships no
resampling at all — SURVEY.md §2 C26 note; its only particle indexing is
the per-leaf `jnp.take` idiom of `combinators/vmap.py:277-332`, which this
module replaces on the hot path).

`jnp.take` on each leaf separately lowers to one scalar-element gather
per leaf. Packing the leaves into one `(N, F)` matrix per dtype and
gathering ROWS shares one index stream across all columns. Whether the
packing copies pay for themselves on the GPU is an open measurement
(ROADMAP D3). The systematic-resampling hot paths use the streaming
expansion in `ops/expand.py` instead; `take_rows` is the general path
(arbitrary/permuted indices, multinomial resampling, row lookups) and
the plain reference `expand_rows` must equal.
"""

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np


def _packable(leaf) -> bool:
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return False
    try:
        return jnp.issubdtype(dtype, jnp.number) or dtype == jnp.bool_
    except TypeError:
        return False


def take_rows(tree, idx, n_rows: int | None = None):
    """`tree_map(lambda v: v[idx], tree)` over the leading axis, lowered
    as one packed row-gather per dtype group.

    With `n_rows` given, leaves whose leading dimension is not `n_rows`
    are treated as SHARED across rows and pass through untouched — the
    layout produced by `mcmc.share_chain_args`, where per-particle traces
    reference one copy of the model arguments (gathering N identical
    copies would be pure wasted bandwidth).

    >>> import jax.numpy as jnp
    >>> from genjax_tpu.core.gather import take_rows
    >>> tree = {"a": jnp.arange(4.0), "b": jnp.arange(8.0).reshape(4, 2)}
    >>> out = take_rows(tree, jnp.array([2, 0]))
    >>> out["a"].tolist()
    [2.0, 0.0]
    >>> out["b"].tolist()
    [[4.0, 5.0], [0.0, 1.0]]
    >>> shared = {"w": jnp.arange(4.0), "X": jnp.zeros((7, 3))}
    >>> out = take_rows(shared, jnp.array([1, 1, 0, 2]), n_rows=4)
    >>> out["X"].shape  # shared leaf untouched
    (7, 3)
    """
    leaves, treedef = jtu.tree_flatten(tree)
    if not leaves:
        return tree
    idx = jnp.asarray(idx)
    out: list = [None] * len(leaves)

    groups: dict = {}
    for i, leaf in enumerate(leaves):
        ndim = getattr(leaf, "ndim", 0)
        if n_rows is not None and (ndim == 0 or jnp.shape(leaf)[0] != n_rows):
            out[i] = leaf  # shared across rows
        elif _packable(leaf) and ndim >= 1:
            groups.setdefault(jnp.result_type(leaf), []).append(i)
        else:
            out[i] = jtu.tree_map(lambda v: v[idx], leaf)

    for dtype, members in groups.items():
        n = leaves[members[0]].shape[0]
        flats, widths = [], []
        for i in members:
            f = jnp.reshape(leaves[i], (n, -1))
            flats.append(f)
            widths.append(f.shape[1])
        packed = flats[0] if len(flats) == 1 else jnp.concatenate(flats, axis=1)
        gathered = jnp.take(packed, idx, axis=0)
        offsets = np.concatenate([[0], np.cumsum(widths)])
        for k, i in enumerate(members):
            segment = gathered[:, offsets[k] : offsets[k + 1]]
            out[i] = jnp.reshape(segment, idx.shape[:1] + leaves[i].shape[1:])

    return jtu.tree_unflatten(treedef, out)


def map_packed_rows(tree, fn, n_rows: int):
    """Apply `fn` to each per-dtype packed `(n_rows, F)` matrix of the
    tree's leaves and unpack the results back into the tree structure.
    Leaves whose leading dim is not `n_rows` are shared and pass through
    (the `take_rows` convention). `fn` must preserve the matrix shape."""
    import jax.numpy as jnp
    import jax.tree_util as jtu
    import numpy as np

    leaves, treedef = jtu.tree_flatten(tree)
    out: list = [None] * len(leaves)
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        ndim = getattr(leaf, "ndim", 0)
        if ndim == 0 or jnp.shape(leaf)[0] != n_rows:
            out[i] = leaf
        elif _packable(leaf):
            groups.setdefault(jnp.result_type(leaf), []).append(i)
        else:
            raise TypeError(f"map_packed_rows: unsupported leaf {type(leaf)}")

    for _dtype, members in groups.items():
        flats, widths = [], []
        for i in members:
            f = jnp.reshape(leaves[i], (n_rows, -1))
            flats.append(f)
            widths.append(f.shape[1])
        packed = flats[0] if len(flats) == 1 else jnp.concatenate(flats, axis=1)
        result = fn(packed)
        offsets = np.concatenate([[0], np.cumsum(widths)])
        for k, i in enumerate(members):
            segment = result[:, offsets[k] : offsets[k + 1]]
            out[i] = jnp.reshape(segment, (n_rows,) + leaves[i].shape[1:])

    return jtu.tree_unflatten(treedef, out)

"""Streaming exact expansion for systematic-resampling ancestors.

New capability with no reference counterpart (the reference ships no
resampling at all — SURVEY.md §2 C26). Replaces the row-gather `x[anc]`
on the systematic-resampling hot paths.

Why: it was designed for a backend whose gathers and scatters cost per
index, not per byte, while rolls and selects stream at full bandwidth.
On the H100 the plain row gather `take_rows(x, systematic_resample(...))`
measured faster at 1M rows (PERF.md); which of the two realizations
stays is decided per call site by measurement (ROADMAP S3, D2).
Systematic/stratified resampling produces NON-DECREASING ancestors, and
a non-decreasing gather is an *expansion*: surviving
particle j's row is copied into the contiguous output block
[N_{j-1}, N_j) given cumulative counts N. That structure admits an exact
O(log N)-depth algorithm built entirely from `jnp.roll` + `jnp.where`
passes over the packed row matrix:

1. **Compact**: one variadic `lax.sort` moves survivors (in order) to
   the front, dead rows to the back; the block counts ride as the only
   bookkeeping payload (`live` and the block starts are derived after
   the sort). The sort is irreplaceable here: compaction's displacement
   is non-decreasing along the row order while the movement is LEFT, so
   MSB-first binary routing is NOT conflict-free for it (see the
   comment in `expand_cols`).
2. **Spread** (right-shift): the survivor at rank c moves right to its
   block start t_c — one-sided non-decreasing (t_{c+1} >= t_c + 1
   implies t_c - c non-decreasing), so MSB-first binary hops ARE
   conflict-free: movers form a suffix at every stage, and a mover's
   landing lane is either empty or simultaneously vacated.
3. **Fill forward**: pointer-doubling max-scan copies each block start's
   row across its run.

Phase 2 is a `lax.scan` over a STATIC log2(N) stage schedule — a stage
whose hop bit is set in no row's remaining displacement is an automatic
no-op pass. Phase 3 stays a `while_loop` whose trip count adapts to the
runtime max run length (near-uniform weights fill in 2-3 passes). The
`lax.sort` carries every payload column, which is why the payload is
kept minimal. No ancestor vector is ever materialized, so the scalar
scatter the ancestor-based resamplers pay is skipped.

Interface: `expand_rows(tree, cum_counts, n_rows=...)` — consumes the
cumulative-count vector that `systematic_resample` (inference/smc.py)
already computes internally, NOT the ancestor vector (deriving
survivor flags from ancestors would need a scatter, reintroducing the
per-index cost).
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np

from genjax_tpu.core.typing import IntArray




def _route(cols, rem, n: int, direction: int):
    """Move rows (stored as a TUPLE of (N,) column arrays, so every pass
    streams whole columns) by their exact remaining displacement `rem`
    (one-sided, non-decreasing over occupied lanes; rem < 0 marks an
    empty lane), via MSB-first binary hops. `direction` is +1 (toward
    higher lanes) or -1 (toward lower lanes). Conflict-free: final
    targets are strictly increasing in current order and high-to-low bit
    processing keeps intermediate positions strictly increasing.

    One `lax.scan` over a STATIC log2(n) stage schedule (bits above the
    runtime displacement bound are set in no row, so those passes are
    automatic no-ops). The body is compiled once, so compile time stays
    small next to an unrolled per-stage cond chain."""
    n_stages = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    ks = jnp.arange(n_stages - 1, -1, -1, dtype=jnp.int32)

    def body(state, k):
        cols, rem = state
        hop = jnp.left_shift(jnp.int32(1), k)
        shift = direction * hop
        src_rem = jnp.roll(rem, shift)
        incoming = (src_rem >= 0) & ((src_rem & hop) != 0)
        # A lane never both keeps a finished row and receives one
        # (conflict-freedom above), so the two selects can't clash.
        vacated = (rem >= 0) & ((rem & hop) != 0)
        new_cols = tuple(
            jnp.where(incoming, jnp.roll(c, shift), c) for c in cols
        )
        new_rem = jnp.where(
            incoming, src_rem - hop, jnp.where(vacated, -1, rem)
        )
        return (new_cols, new_rem), None

    (cols, rem), _ = jax.lax.scan(body, (cols, rem), ks)
    return cols, rem


def _route_right(cols, rem, n: int):
    return _route(cols, rem, n, 1)


def _fill_forward(cols, marked, max_run, n: int):
    """Copy each marked lane's row rightward across its run (to every lane
    whose nearest marked lane at-or-before it is that one), by pointer
    doubling on (columns, source-index). Column-tuple layout and one
    `while_loop` body — see `_route_right` for why."""
    iota = jnp.arange(n, dtype=jnp.int32)
    src = jnp.where(marked, iota, -1)

    def cond(state):
        hop, _, _ = state
        return hop < max_run

    def body(state):
        hop, cols, src = state
        cand_src = jnp.where(iota >= hop, jnp.roll(src, hop), -1)
        take = cand_src > src
        new_cols = tuple(
            jnp.where(take, jnp.roll(c, hop), c) for c in cols
        )
        return hop * 2, new_cols, jnp.maximum(src, cand_src)

    _, cols, _ = jax.lax.while_loop(cond, body, (jnp.int32(1), cols, src))
    return cols


def expand_cols(cols, cum_counts: IntArray):
    """Expand a tuple of (N,) column arrays by cumulative block counts:
    output slot i of every column gets its row j where N_{j-1} <= i < N_j.
    Exactly `c[anc]` per column for the systematic/stratified ancestor
    vector derived from `cum_counts`."""
    n = cols[0].shape[0]
    assert cum_counts.shape[0] == n, (
        "streaming expansion requires as many sources as output slots"
    )
    cum = cum_counts.astype(jnp.int32)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), cum[:-1]])
    counts = cum - starts
    survive = counts > 0
    iota = jnp.arange(n, dtype=jnp.int32)

    # Phase 1 — compact survivors to rank lanes via ONE variadic sort
    # (survivors keep their order, dead rows sink to the back). MSB-first
    # routing CANNOT replace this sort: compaction moves rows left while
    # its displacement (dead-before count) is non-decreasing along the
    # row order, so a mover's intermediate hop can land on a stationary
    # earlier row (concrete clash: rem=[0,-,-,-,-,4,4,-,-,6,6,-,-,8,..] —
    # the rem-8 row's first hop lands exactly on the stationary rem-4
    # row). The spread phase is safe precisely because ITS movers form a
    # suffix at every stage. Payload is kept minimal — the block counts
    # ride the sort; `live` and the block starts are derived AFTER the
    # sort (live = key < n, starts = exclusive cumsum of sorted counts),
    # saving one full column per pass of the sort network.
    key1 = jnp.where(survive, iota, iota + n)
    sorted_key, sorted_counts, *sorted_cols = jax.lax.sort(
        (key1, counts) + tuple(cols), num_keys=1
    )
    live = sorted_key < n
    csum = jnp.cumsum(sorted_counts)
    start_at = csum - sorted_counts

    # Phase 2 — spread rank-c survivor right to its block start t_c
    # (t_c - c is one-sided non-decreasing). rem < 0 marks empty lanes.
    rem = jnp.where(live, start_at - iota, -1)
    sorted_cols, rem = _route_right(tuple(sorted_cols), rem, n)

    # Phase 3 — fill each block forward across its run.
    return _fill_forward(sorted_cols, rem == 0, jnp.max(counts), n)


def expand_rows_packed(x, cum_counts: IntArray):
    """(N, F)-matrix convenience wrapper over `expand_cols`."""
    cols = expand_cols(tuple(x[:, f] for f in range(x.shape[1])), cum_counts)
    return jnp.stack(cols, axis=1)


def expand_rows(tree, cum_counts: IntArray, n_rows: int | None = None):
    """`take_rows(tree, anc)` for the monotone ancestors encoded by
    `cum_counts`, lowered as streaming passes instead of a per-index
    gather. Leaves whose leading dim differs from `n_rows` pass through
    untouched (shared model args), matching `take_rows` semantics.

    Every leaf is decomposed into (N,) columns and all columns ride ONE
    sort + route + fill pipeline (mixed dtypes are fine — `lax.sort` is
    variadic), so the per-lane layout stays fully utilized."""
    leaves, treedef = jtu.tree_flatten(tree)
    if not leaves:
        return tree
    cum_counts = jnp.asarray(cum_counts)
    out: list = [None] * len(leaves)
    cols: list = []
    spans: list = []  # (leaf index, first column, n columns)
    for i, leaf in enumerate(leaves):
        ndim = getattr(leaf, "ndim", 0)
        if n_rows is not None and (ndim == 0 or jnp.shape(leaf)[0] != n_rows):
            out[i] = leaf
            continue
        if not hasattr(leaf, "dtype") or ndim < 1:
            raise TypeError(f"expand_rows: unsupported leaf {type(leaf)}")
        n = leaf.shape[0]
        flat = jnp.reshape(leaf, (n, -1))
        spans.append((i, len(cols), flat.shape[1]))
        cols.extend(flat[:, f] for f in range(flat.shape[1]))

    if cols:
        expanded = expand_cols(tuple(cols), cum_counts)
        for i, first, width in spans:
            leaf_cols = expanded[first : first + width]
            rebuilt = (
                leaf_cols[0]
                if width == 1 and leaves[i].ndim == 1
                else jnp.reshape(
                    jnp.stack(leaf_cols, axis=1),
                    (leaf_cols[0].shape[0],) + leaves[i].shape[1:],
                )
            )
            out[i] = rebuilt

    return jtu.tree_unflatten(treedef, out)

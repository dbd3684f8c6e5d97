"""Stein variational gradient descent over trace particle batches.

New relative to the reference (no SVGD exists in genjax-community/genjax;
its inference library is SMC/MCMC/VI only, `_src/inference/`): SVGD
(Liu & Wang 2016) transports a set of particles along the kernelized
Stein discrepancy's steepest-descent direction, giving a deterministic,
gradient-based posterior approximation that needs no accept/reject and
no step-size/trajectory tuning beyond a learning rate.

Accelerator notes
-----------------
SVGD is unusually accelerator-friendly: one iteration is a vmapped
fused density+gradient pass (the same `value_and_grad`-of-`assess`
closure HMC uses) followed by an N x N RBF kernel built from one
`x @ x.T` matmul and applied with two more matmuls — the entire
interaction term runs as matrix products. State is a dense (n_particles, dim)
matrix; the loop is one `lax.scan`. Model arguments are stored once and
broadcast (the shared-args layout, ARCHITECTURE.md 4b), not copied per
particle.
"""

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.flatten_util import ravel_pytree

from genjax_tpu.core.choice_map import ChoiceMap, Selection
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu.core.typing import PRNGKey
from genjax_tpu.inference.mcmc import _chain_axes, share_chain_args
from genjax_tpu.inference.requests.hmc import grad_tree_unzip, grad_tree_zip


# Particle-count cap for the median-heuristic estimate: a full-matrix
# median is a sort of n^2 elements EVERY step, far more work than the
# kernel matmuls it feeds (16M elements at n=4096). A 128x128 block is
# 16k exchangeable d^2 samples — the median's sampling error is far
# inside the heuristic's own slack — and its sort is small.
_MEDIAN_SAMPLE = 128


def rbf_kernel(x: jax.Array, bandwidth: float | None = None):
    """RBF kernel matrix over particle rows, squared distances via one
    symmetric matmul. `bandwidth=None` applies the median heuristic
    h = median(d^2) / log(n + 1) (Liu & Wang 2016, sec. 5), with the
    median taken over a `_MEDIAN_SAMPLE`-sized particle block (sorting
    the full n x n matrix would dominate the whole update at scale).

    Returns `(K, h)` with `K[i, j] = exp(-||x_i - x_j||^2 / h)`.
    """
    x2 = jnp.sum(x * x, axis=-1)
    d2 = x2[:, None] + x2[None, :] - 2.0 * (x @ x.T)
    d2 = jnp.maximum(d2, 0.0)
    h = _bandwidth_from_d2_block(d2, x.shape[0], bandwidth)
    return jnp.exp(-d2 / h), h


def _bandwidth_from_d2_block(d2_block, n_total: int, bandwidth):
    """Median-heuristic bandwidth from a (rows, cols) squared-distance
    block, capped at `_MEDIAN_SAMPLE` per axis (full-matrix medians are
    an n^2 sort every step)."""
    if bandwidth is not None:
        return jnp.asarray(bandwidth)
    m_r = min(d2_block.shape[0], _MEDIAN_SAMPLE)
    m_c = min(d2_block.shape[1], _MEDIAN_SAMPLE)
    h = jnp.median(d2_block[:m_r, :m_c]) / jnp.log(float(n_total + 1))
    return jnp.maximum(h, 1e-12)


def stein_phi_block(
    x_rows: jax.Array,
    x_all: jax.Array,
    g_all: jax.Array,
    h: jax.Array,
    n_total: int,
    kernel_dtype=None,
):
    """Rows of the Stein direction for the particles `x_rows` against the
    full set `(x_all, g_all)`, sharing one kernel block `K[rows, all]`.

    Memory-traffic shape (the design constraint): the naive form makes
    FOUR passes over the n x n kernel matrix per step (write K, then
    `K @ grads`, `K @ x`, `sum(K)`), and at small particle dimension D
    the whole update is bandwidth-bound on exactly that traffic. Here
    the three contractions share ONE matmul against the augmented matrix
    `[grads | x | 1]` (contraction over the particle axis, so the
    matmul sees a deep K-dim regardless of D), and `kernel_dtype=bfloat16`
    halves the remaining K bytes with f32 accumulation
    (`preferred_element_type`); its effect on the H100 is in PERF.md
    (`chip_smoke.py` phase `svgd_d16`).

    Used by both the dense driver and `parallel.sharded_svgd` (rows =
    the local shard), so dense and sharded transports stay bit-exact
    for a given `h`.
    """
    d = x_all.shape[-1]
    x2_rows = jnp.sum(x_rows * x_rows, axis=-1)
    x2_all = jnp.sum(x_all * x_all, axis=-1)
    if kernel_dtype is not None:
        # Low-precision kernel path: the distance matmul's operands cast
        # BEFORE the dot (half the dot-output bytes — the n x n f32
        # intermediate is the single largest traffic term), with f32
        # accumulation; the exact row norms stay f32, so d2's diagonal
        # is still ~0 and the relative error is O(bf16 eps) ~ 0.4%.
        prod = jax.lax.dot_general(
            x_rows.astype(kernel_dtype),
            x_all.astype(kernel_dtype),
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    else:
        prod = x_rows @ x_all.T
    d2 = x2_rows[:, None] + x2_all[None, :] - 2.0 * prod
    d2 = jnp.maximum(d2, 0.0)
    K = jnp.exp(-d2 / h)
    aug = jnp.concatenate(
        [g_all, x_all, jnp.ones((x_all.shape[0], 1), x_all.dtype)], axis=1
    )
    if kernel_dtype is not None:
        K = K.astype(kernel_dtype)
        aug = aug.astype(kernel_dtype)
    out = jax.lax.dot_general(
        K,
        aug,
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    smoothed, kx, ksum = out[:, :d], out[:, d : 2 * d], out[:, 2 * d :]
    repulsion = (2.0 / h) * (ksum * x_rows - kx)
    return (smoothed + repulsion) / float(n_total)


def stein_direction(
    x: jax.Array,
    grads: jax.Array,
    bandwidth: float | None = None,
    kernel_dtype=None,
):
    """The kernelized Stein descent direction phi at each particle:

        phi_i = (1/n) sum_j [ K_ij grad_j + (2/h) K_ij (x_i - x_j) ]

    i.e. a kernel-smoothed gradient plus a repulsion term keeping the
    particle set spread — evaluated as a single fused contraction
    against the kernel block (see `stein_phi_block` for the traffic
    analysis). Returns `(phi, h)`."""
    n = x.shape[0]
    if bandwidth is None:
        m = min(n, _MEDIAN_SAMPLE)
        xm = x[:m]
        x2m = jnp.sum(xm * xm, axis=-1)
        d2m = x2m[:, None] + x2m[None, :] - 2.0 * (xm @ xm.T)
        h = _bandwidth_from_d2_block(jnp.maximum(d2m, 0.0), n, None)
    else:
        h = jnp.asarray(bandwidth)
    return stein_phi_block(x, x, grads, h, n, kernel_dtype), h


def _prepare_particles(
    key: PRNGKey,
    model: GenerativeFunction[Any],
    args: tuple,
    observations: ChoiceMap,
    selection: Selection,
    n_particles: int,
):
    """Shared SVGD setup (used by this driver and `parallel.sharded_svgd`):
    importance-initialize a shared-args trace batch and flatten the
    selected (continuous) latents to an (n, dim) matrix. Returns
    `(traces, x0, unravel, complement, compl_axes)`."""
    keys = jax.random.split(key, n_particles)
    traces, _ = jax.vmap(model.importance, in_axes=(0, None, None))(
        keys, observations, args
    )
    traces = share_chain_args(traces, args)

    chm = traces.get_choices()
    filtered = chm.filter(selection)
    complement = chm.filter(~selection)
    grad_tree, nongrad_tree = grad_tree_unzip(filtered)
    # None leaves are dropped by tree_leaves, so any survivor is a real
    # non-differentiable selected site.
    if jtu.tree_leaves(nongrad_tree):
        raise TypeError(
            "svgd: the selection covers non-differentiable (e.g. integer) "
            "sites; SVGD transports continuous latents only — narrow the "
            "selection or marginalize the discrete sites."
        )

    template = jtu.tree_map(lambda v: v[0], grad_tree)
    _, unravel = ravel_pytree(template)
    x0 = jax.vmap(lambda t: ravel_pytree(t)[0])(grad_tree)
    compl_axes = _chain_axes(complement, n_particles)
    return traces, x0, unravel, complement, compl_axes


def _rebuild_particles(key, traces, x, unravel, args, n_particles):
    """Write transported values back with one vmapped GFI edit so
    scores/retvals are consistent with the new choices."""
    tr_axes = _chain_axes(traces, n_particles)
    edit_keys = jax.random.split(key, n_particles)

    def rebuild(k, tr, vec):
        new_tr, _, _, _ = Update(unravel(vec)).edit(
            k, tr, Diff.no_change(args)
        )
        return new_tr

    return jax.vmap(rebuild, in_axes=(0, tr_axes, 0), out_axes=tr_axes)(
        edit_keys, traces, x
    )


def svgd(
    key: PRNGKey,
    model: GenerativeFunction[Any],
    args: tuple,
    observations: ChoiceMap,
    selection: Selection,
    n_particles: int,
    n_steps: int,
    step_size: float = 0.1,
    bandwidth: float | None = None,
    optimizer: Any = None,
    collect: Callable[[jax.Array], Any] | None = None,
    kernel_dtype=None,
) -> tuple[Trace[Any], Any]:
    """Run SVGD on the selected (continuous) latent sites of `model`
    conditioned on `observations`.

    Particles are initialized by vmapped `importance` (i.e. from the
    prior given the observations), flattened into an
    (n_particles, dim) matrix, transported for `n_steps` deterministic
    updates, and written back into a batch of traces with one vmapped
    `Update` edit — so the result is a standard batched trace (in the
    shared-args layout) usable with every other driver.

    `optimizer` is an optional optax transform (the paper uses
    Adagrad); when None, plain gradient steps of `step_size` are taken.
    `collect(x)` extracts a per-step statistic from the flat particle
    matrix (defaults to the mean |phi| — a convergence diagnostic).
    `kernel_dtype=jnp.bfloat16` halves the kernel-matrix HBM traffic
    (the bandwidth bottleneck at small D) with f32 accumulation; the
    transport direction changes by O(bf16 eps) per step, well inside
    SVGD's own approximation error (default: full f32).

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.svgd import svgd
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> traces, _ = svgd(
    ...     jax.random.key(0), model, (), gx.ChoiceMap.kw(obs=2.0),
    ...     gx.Selection.at["mu"], n_particles=64, n_steps=200,
    ... )
    >>> bool(jnp.abs(jnp.mean(traces.get_choices()["mu"]) - 1.0) < 0.2)
    True
    """
    k_init, k_edit = jax.random.split(key)
    traces, x0, unravel, complement, compl_axes = _prepare_particles(
        k_init, model, args, observations, selection, n_particles
    )

    def logp(vec, compl):
        full = unravel(vec).merge(compl)
        w, _ = model.assess(full, args)
        return w

    grad_batch = jax.vmap(jax.grad(logp), in_axes=(0, compl_axes))

    if optimizer is not None:
        opt_state0 = optimizer.init(x0)

        def step(carry, _):
            x, opt_state = carry
            g = grad_batch(x, complement)
            phi, _ = stein_direction(x, g, bandwidth, kernel_dtype)
            # optax transforms descend a loss; feed -phi so the applied
            # update ascends the Stein direction.
            updates, opt_state = optimizer.update(-phi, opt_state, x)
            x = x + updates
            out = collect(x) if collect is not None else jnp.mean(jnp.abs(phi))
            return (x, opt_state), out

        (x, _), outs = jax.lax.scan(step, (x0, opt_state0), None, length=n_steps)
    else:

        def step(x, _):
            g = grad_batch(x, complement)
            phi, _ = stein_direction(x, g, bandwidth, kernel_dtype)
            x = x + step_size * phi
            out = collect(x) if collect is not None else jnp.mean(jnp.abs(phi))
            return x, out

        x, outs = jax.lax.scan(step, x0, None, length=n_steps)

    new_traces = _rebuild_particles(
        k_edit, traces, x, unravel, args, n_particles
    )
    return new_traces, outs


def packed_svgd(
    key: PRNGKey,
    model: GenerativeFunction[Any],
    args_list: list,
    observations_list: list,
    selection: Selection,
    n_particles: int,
    n_steps: int,
    step_size: float = 0.1,
    bandwidth: float | None = None,
    optimizer: Any = None,
    collect: Callable[[jax.Array], Any] | None = None,
    kernel_dtype=None,
) -> tuple[list, Any]:
    """Transport C independent small-D inference problems in ONE joint
    SVGD — the feature-packing variant.

    Why: at small particle dimension D (e.g. 16) both Stein matmuls are
    too narrow to fill a matrix unit — the distance contraction is only
    D deep and the fused `[grads | x | 1]` output only 2D+1 wide — so
    single-problem SVGD uses a small share of the matmul rate no matter
    how fast the kernel is. Packing C problems feature-wise (`x_joint`
    is `(n, sum_c D_c)`) fills that width with OTHER PROBLEMS' useful
    work: at C*D = 128 both contractions are 128 wide, and C posteriors
    come out for roughly the price of one. Whether this pays on the H100
    is an open measurement (ROADMAP S6, D6).

    What it computes: SVGD targeting the PRODUCT density
    `prod_c p_c(x_c | obs_c)` with a joint RBF kernel on the packed
    vector. Particle i carries one coupled replicate of every problem;
    problems interact only through the scalar kernel weights (the joint
    kernel factorizes no further), so this is *not* bit-identical to C
    separate runs — it is a valid SVGD whose stationary point is the
    product target, and each problem's marginal is its own posterior.
    For C = 1 the joint kernel reduces to the plain RBF kernel and the
    PRNG stream matches, so the packed driver IS `svgd` bit-for-bit
    (asserted in tests/inference/test_svgd.py); per-problem marginal
    moments are certified against conjugate oracles in the same tests.
    Use it when you have many *same-shaped small-D* problems —
    cross-validation folds, per-group fits, independent replicates — and
    want them at matmul-roof throughput; use `svgd` for one problem.

    `args_list` / `observations_list`: per-problem model args tuples and
    observation choice maps (length C). The selection must be continuous
    for every problem (same rule as `svgd`). Returns
    `(traces_per_problem, per_step_diagnostics)` where
    `traces_per_problem[c]` is a standard shared-args trace batch.

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.svgd import packed_svgd
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> traces, _ = packed_svgd(
    ...     jax.random.key(0), model,
    ...     [(), ()], [gx.ChoiceMap.kw(obs=2.0), gx.ChoiceMap.kw(obs=-2.0)],
    ...     gx.Selection.at["mu"], n_particles=64, n_steps=200,
    ... )
    >>> m0 = float(jnp.mean(traces[0].get_choices()["mu"]))
    >>> m1 = float(jnp.mean(traces[1].get_choices()["mu"]))
    >>> bool(abs(m0 - 1.0) < 0.25 and abs(m1 + 1.0) < 0.25)
    True
    """
    if len(args_list) != len(observations_list):
        raise ValueError(
            "packed_svgd: args_list and observations_list must have the "
            f"same length (got {len(args_list)} vs {len(observations_list)})."
        )
    n_problems = len(args_list)
    k_init, k_edit = jax.random.split(key)

    # With one problem the PRNG stream matches `svgd` exactly, so packed
    # C=1 is bit-for-bit the plain driver (regression-tested); with C>1
    # each problem folds its index in.
    def _pkey(base, c):
        return base if n_problems == 1 else jax.random.fold_in(base, c)

    traces_c, x0_c, unravel_c, complement_c, caxes_c = [], [], [], [], []
    for c in range(n_problems):
        tr, x0, unravel, compl, caxes = _prepare_particles(
            _pkey(k_init, c),
            model,
            args_list[c],
            observations_list[c],
            selection,
            n_particles,
        )
        traces_c.append(tr)
        x0_c.append(x0)
        unravel_c.append(unravel)
        complement_c.append(compl)
        caxes_c.append(caxes)

    dims = [x.shape[1] for x in x0_c]
    offsets = [0]
    for d in dims:
        offsets.append(offsets[-1] + d)
    x0_joint = jnp.concatenate(x0_c, axis=1)

    def logp(c, vec, compl):
        full = unravel_c[c](vec).merge(compl)
        w, _ = model.assess(full, args_list[c])
        return w

    grad_batches = [
        jax.vmap(
            jax.grad(lambda v, comp, c=c: logp(c, v, comp)),
            in_axes=(0, caxes_c[c]),
        )
        for c in range(n_problems)
    ]

    def grad_joint(x):
        # Per-problem density gradients: independent blocks of the packed
        # vector (XLA runs the C small grad passes as one fused program).
        parts = [
            grad_batches[c](
                x[:, offsets[c] : offsets[c + 1]], complement_c[c]
            )
            for c in range(n_problems)
        ]
        return jnp.concatenate(parts, axis=1)

    if optimizer is not None:
        opt_state0 = optimizer.init(x0_joint)

        def step(carry, _):
            x, opt_state = carry
            g = grad_joint(x)
            phi, _ = stein_direction(x, g, bandwidth, kernel_dtype)
            updates, opt_state = optimizer.update(-phi, opt_state, x)
            x = x + updates
            out = collect(x) if collect is not None else jnp.mean(jnp.abs(phi))
            return (x, opt_state), out

        (x, _), outs = jax.lax.scan(
            step, (x0_joint, opt_state0), None, length=n_steps
        )
    else:

        def step(x, _):
            g = grad_joint(x)
            phi, _ = stein_direction(x, g, bandwidth, kernel_dtype)
            x = x + step_size * phi
            out = collect(x) if collect is not None else jnp.mean(jnp.abs(phi))
            return x, out

        x, outs = jax.lax.scan(step, x0_joint, None, length=n_steps)

    new_traces = [
        _rebuild_particles(
            _pkey(k_edit, c),
            traces_c[c],
            x[:, offsets[c] : offsets[c + 1]],
            unravel_c[c],
            args_list[c],
            n_particles,
        )
        for c in range(n_problems)
    ]
    return new_traces, outs


__all__ = [
    "packed_svgd",
    "rbf_kernel",
    "stein_direction",
    "stein_phi_block",
    "svgd",
]

"""NUTS: the No-U-Turn sampler as an edit request.

Beyond the reference (SURVEY.md §2 C27 ships fixed-(eps, L) HMC only).
This is multinomial NUTS with the generalized (momentum-sum) U-turn
criterion: per draw, the trajectory doubles away from the start in
random directions until a sub-trajectory "turns" (the momentum sum
points against a boundary velocity) or diverges, and the returned state
is a multinomial draw from the visited states weighted by
`exp(-energy)` (progressive within a subtree, biased toward the new
subtree across doublings). The move leaves the target invariant; like
`EllipticalSlice`, the returned weight is 0.0 so it composes with
`mh`/`mh_chain`/`run_chains` and the sharded chain drivers unchanged.

Accelerator-shaped formulation
------------------------------
Recursive NUTS is unbatchable (per-chain tree recursion). This
implementation is ITERATIVE with a fully static schedule: doubling
level `d` runs a `lax.scan` of exactly `2**d` leapfrog steps, so one
draw always costs `2**max_depth - 1` gradient evaluations, with
per-chain termination handled by masking. Within a subtree, the U-turn
checks that the recursion would perform at every internal binary node
are reproduced with an O(max_depth) checkpoint stack: leaf `i` of a
subtree starts a binary node iff `i` is even (checkpoint slot =
popcount(i >> 1)) and closes the nodes whose span ends at `i` — the
`trailing-ones(i)` innermost slots. All of that indexing is static
numpy precomputed per level and fed through scan `xs`.

The padding cost is the honest price of SIMD batching (a chain batch
pads every draw to the deepest tree — see `inference/chees.py` for the
adaptive alternative that avoids it); for single or few chains NUTS's
per-draw adaptivity wins.

References: Hoffman & Gelman (2014); Betancourt (2017) for multinomial
state selection and the momentum-sum termination criterion; the
checkpoint indexing is re-derived in comments below.
"""

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp
import jax.random as jrand
import jax.tree_util as jtu
from jax.flatten_util import ravel_pytree

from genjax_tpu.core.choice_map import Selection
from genjax_tpu.core.concepts import Argdiffs, EditRequest, Retdiff, Weight
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import Trace, Update
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.typing import FloatArray, PRNGKey
from genjax_tpu.inference.requests.hmc import (
    _mass_tree,
    grad_tree_unzip,
    grad_tree_zip,
    make_selection_grad_fn,
)

__all__ = ["NUTS", "NUTSInfo", "nuts_kernel", "nuts_warmup"]

_MAX_DELTA_ENERGY = 1000.0  # Stan's divergence threshold


@Pytree.dataclass
class NUTSInfo(Pytree):
    """Per-draw diagnostics: `accept_stat` is the mean Metropolis
    acceptance statistic over visited states (the dual-averaging
    signal), `depth` the number of completed doublings, `diverged`
    whether the trajectory hit the energy-error threshold."""

    accept_stat: FloatArray
    depth: Any
    diverged: Any


def _popcount(x: int) -> int:
    return bin(x).count("1")


def _trailing_ones(x: int) -> int:
    t = 0
    while x & 1:
        t += 1
        x >>= 1
    return t


def _level_schedule(d: int, max_depth: int):
    """Static per-leaf checkpoint bookkeeping for a depth-`d` subtree.

    Within a subtree, traversal leaf `i` (0-based):
      - even `i` STARTS binary nodes (of every size 2^j with
        i % 2^j == 0); we checkpoint its momentum and the cumulative
        momentum sum *before* it, at slot popcount(i >> 1) — distinct
        for all nodes simultaneously open, at most `d` slots.
      - odd `i` CLOSES the nodes whose last `j` bits are ones,
        j = 1..trailing_ones(i); their start leaves occupy checkpoint
        slots popcount(i >> 1) - trailing_ones(i) + 1 .. popcount(i >> 1).
    """
    n = 1 << d
    idx = np.arange(n)
    is_store = (idx % 2 == 0).astype(np.bool_)
    slot = np.array([_popcount(i >> 1) for i in idx], dtype=np.int32)
    check = np.zeros((n, max(max_depth, 1)), dtype=np.bool_)
    for i in idx:
        if i % 2 == 1:
            hi = _popcount(i >> 1)
            lo = hi - _trailing_ones(i) + 1
            check[i, lo : hi + 1] = True
    return idx.astype(np.int32), is_store, slot, check


def _flat_problem(selection: Selection, tr: Trace[Any], argdiffs, inv_mass):
    """Flatten the selected differentiable leaves into one vector and
    return (q0, im, logp_grad, rebuild)."""
    filtered = tr.get_choices().filter(selection)
    grad_tree, nongrad_tree = grad_tree_unzip(filtered)
    q0, unravel = ravel_pytree(grad_tree)
    if q0.size == 0:
        raise ValueError(
            "NUTS: the selection matched no differentiable addresses."
        )
    im, _ = ravel_pytree(_mass_tree(inv_mass, grad_tree))
    grad_fn = make_selection_grad_fn(selection, tr, argdiffs)

    def logp_grad(q):
        vals = grad_tree_zip(unravel(q), nongrad_tree)
        score, g = grad_fn(vals)
        gflat, _ = ravel_pytree(grad_tree_unzip(g)[0])
        return score, gflat

    def rebuild(q):
        return grad_tree_zip(unravel(q), nongrad_tree)

    return q0, im, logp_grad, rebuild


def _nuts_draw(key, q0, im, logp_grad, eps, max_depth: int):
    """One NUTS trajectory on the flat problem; returns (q_new, info)."""

    def kinetic(p):
        return 0.5 * jnp.sum(im * jnp.square(p))

    def leapfrog(q, p, g, eps_s):
        p = p + 0.5 * eps_s * g
        q = q + eps_s * im * p
        logp, g = logp_grad(q)
        p = p + 0.5 * eps_s * g
        return q, p, g, -logp + kinetic(p)

    k_mom, k_tree = jrand.split(key)
    p0 = jrand.normal(k_mom, q0.shape) / jnp.sqrt(im)
    logp0, g0 = logp_grad(q0)
    h0 = -logp0 + kinetic(p0)

    neg_inf = jnp.asarray(-jnp.inf)
    state = dict(
        left=(q0, p0, g0),
        right=(q0, p0, g0),
        rho=p0,
        prop=q0,
        log_w=jnp.asarray(0.0),  # the root leaf has weight exp(-(h0-h0))
        done=jnp.asarray(False),
        diverged=jnp.asarray(False),
        depth=jnp.asarray(0, dtype=jnp.int32),
        acc_sum=jnp.asarray(0.0),
        n_acc=jnp.asarray(0.0),
    )

    for d in range(max_depth):
        k_d = jrand.fold_in(k_tree, d)
        k_dir, k_leaf, k_merge = jrand.split(k_d, 3)
        go_right = jrand.bernoulli(k_dir)
        eps_s = jnp.where(go_right, eps, -eps)
        bq, bp, bg = jtu.tree_map(
            lambda r, l: jnp.where(go_right, r, l),
            state["right"],
            state["left"],
        )

        idx, is_store, slot, check = _level_schedule(d, max_depth)
        nslots = check.shape[1]
        carry = dict(
            q=bq, p=bp, g=bg,
            rho_cum=jnp.zeros_like(q0),
            log_w=neg_inf,
            prop=bq,
            ckpt_p=jnp.zeros((nslots, q0.shape[0]), q0.dtype),
            ckpt_rho=jnp.zeros((nslots, q0.shape[0]), q0.dtype),
            failed=jnp.asarray(False),
            diverged=jnp.asarray(False),
            acc_sum=jnp.asarray(0.0),
            n_acc=jnp.asarray(0.0),
        )

        def leaf_step(c, xs, eps_s=eps_s, k_leaf=k_leaf):
            i, store_i, slot_i, check_i = xs
            alive = ~c["failed"]
            q, p, g, h = leapfrog(c["q"], c["p"], c["g"], eps_s)
            delta = h - h0
            div = ~(delta < _MAX_DELTA_ENERGY)  # NaN-safe: NaN => diverged
            log_w_leaf = -delta

            # progressive multinomial proposal within the subtree
            log_w_new = jnp.logaddexp(c["log_w"], log_w_leaf)
            u = jrand.uniform(jrand.fold_in(k_leaf, i))
            take = alive & ~div & (jnp.log(u) < log_w_leaf - log_w_new)

            # checkpoint store (even leaves open binary nodes)
            rho_before = c["rho_cum"]
            ckpt_p = jnp.where(
                store_i, c["ckpt_p"].at[slot_i].set(p), c["ckpt_p"]
            )
            ckpt_rho = jnp.where(
                store_i,
                c["ckpt_rho"].at[slot_i].set(rho_before),
                c["ckpt_rho"],
            )
            rho_cum = rho_before + p

            # close the binary nodes ending at this (odd) leaf: each
            # checked span [a..i] turns iff its momentum sum points
            # against the velocity at either end.
            rho_seg = rho_cum[None, :] - ckpt_rho  # (S, dim)
            turn_a = jnp.sum(rho_seg * (im * ckpt_p), axis=-1) < 0.0
            turn_b = jnp.sum(rho_seg * (im * p)[None, :], axis=-1) < 0.0
            turned = jnp.any(check_i & (turn_a | turn_b))

            ok = alive & ~div
            acc = jnp.exp(jnp.minimum(-delta, 0.0))
            new = dict(
                q=q, p=p, g=g,
                rho_cum=jnp.where(ok, rho_cum, rho_before),
                log_w=jnp.where(ok, log_w_new, c["log_w"]),
                prop=jnp.where(take, q, c["prop"]),
                ckpt_p=ckpt_p,
                ckpt_rho=ckpt_rho,
                failed=c["failed"] | div | (ok & turned),
                diverged=c["diverged"] | (alive & div),
                acc_sum=c["acc_sum"]
                + jnp.where(alive, jnp.nan_to_num(acc), 0.0),
                n_acc=c["n_acc"] + jnp.where(alive, 1.0, 0.0),
            )
            return new, None

        carry, _ = jax.lax.scan(
            leaf_step, carry, (idx, is_store, slot, check)
        )

        active = ~state["done"]
        sub_ok = ~carry["failed"]
        merge = active & sub_ok

        # biased progressive merge across doublings: prefer the fresh
        # subtree in proportion to its total weight.
        u = jnp.log(jrand.uniform(k_merge))
        take_sub = merge & (u < carry["log_w"] - state["log_w"])
        prop = jnp.where(take_sub, carry["prop"], state["prop"])
        log_w = jnp.where(
            merge, jnp.logaddexp(state["log_w"], carry["log_w"]),
            state["log_w"],
        )
        rho = jnp.where(merge, state["rho"] + carry["rho_cum"], state["rho"])
        endpoint = (carry["q"], carry["p"], carry["g"])
        right = jtu.tree_map(
            lambda new, old: jnp.where(merge & go_right, new, old),
            endpoint, state["right"],
        )
        left = jtu.tree_map(
            lambda new, old: jnp.where(merge & ~go_right, new, old),
            endpoint, state["left"],
        )
        turn_tree = (
            jnp.sum(rho * (im * left[1])) < 0.0
        ) | (jnp.sum(rho * (im * right[1])) < 0.0)

        state = dict(
            left=left,
            right=right,
            rho=rho,
            prop=prop,
            log_w=log_w,
            done=state["done"] | ~sub_ok | (merge & turn_tree),
            diverged=state["diverged"] | (active & carry["diverged"]),
            depth=state["depth"] + jnp.where(merge, 1, 0).astype(jnp.int32),
            acc_sum=state["acc_sum"]
            + jnp.where(active, carry["acc_sum"], 0.0),
            n_acc=state["n_acc"] + jnp.where(active, carry["n_acc"], 0.0),
        )

    info = NUTSInfo(
        accept_stat=state["acc_sum"] / jnp.maximum(state["n_acc"], 1.0),
        depth=state["depth"],
        diverged=state["diverged"],
    )
    return state["prop"], info


def nuts_kernel(
    key: PRNGKey,
    tr: Trace[Any],
    selection: Selection,
    eps,
    max_depth: int = 8,
    inv_mass=None,
    argdiffs=None,
) -> tuple[Trace[Any], NUTSInfo]:
    """One NUTS draw on `tr`'s selected addresses; returns the new trace
    plus diagnostics (used by `nuts_warmup` for step-size adaptation)."""
    if argdiffs is None:
        argdiffs = Diff.no_change(tr.get_args())
    q0, im, logp_grad, rebuild = _flat_problem(selection, tr, argdiffs, inv_mass)
    k_draw, k_edit = jrand.split(key)
    q_new, info = _nuts_draw(k_draw, q0, im, logp_grad, eps, max_depth)
    new_tr, _, _, _ = Update(rebuild(q_new)).edit(k_edit, tr, argdiffs)
    return new_tr, info


@Pytree.dataclass(match_args=True)
class NUTS(EditRequest):
    """No-U-Turn move over the selected addresses. Always a valid draw
    from the NUTS kernel (weight 0.0, like `EllipticalSlice`), so it
    composes with `mh`/`mh_chain`/`run_chains` and the sharded drivers.

    `max_depth` caps the doubling count; each draw costs exactly
    `2**max_depth - 1` gradient passes (the static SIMD-batched
    formulation — see the module docstring, and `inference.chees` for
    the large-batch alternative). Tune `eps`/`inv_mass` with
    `nuts_warmup`.

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.requests import NUTS
    >>> from genjax_tpu.inference.mcmc import mh
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> tr, _ = model.importance(jax.random.key(0), gx.ChoiceMap.kw(y=1.0), ())
    >>> req = NUTS(gx.Selection.at["mu"], jnp.asarray(0.5), max_depth=5)
    >>> new_tr, accepted = mh(jax.random.key(1), tr, req)
    >>> bool(accepted)  # weight 0.0: every proposal is the new state
    True
    """

    selection: Selection
    eps: FloatArray
    max_depth: int = Pytree.static(default=8)
    inv_mass: Any = None

    def edit(
        self, key: PRNGKey, tr: Trace[Any], argdiffs: Argdiffs
    ) -> tuple[Trace[Any], Weight, Retdiff, EditRequest]:
        assert Diff.static_check_no_change(argdiffs)
        new_tr, _ = nuts_kernel(
            key, tr, self.selection, self.eps, self.max_depth,
            self.inv_mass, argdiffs,
        )
        return (
            new_tr,
            jnp.asarray(0.0),
            Diff.unknown_change(new_tr.get_retval()),
            NUTS(self.selection, self.eps, self.max_depth, self.inv_mass),
        )


def nuts_warmup(
    key: PRNGKey,
    traces: Trace[Any],
    selection: Selection,
    n_steps: int = 150,
    *,
    max_depth: int = 6,
    eps0: float = 0.1,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
    n_chains: int | None = None,
):
    """Warm up a chain batch for NUTS: dual-average a shared step size on
    the cross-chain mean accept statistic and (optionally) estimate a
    shared diagonal mass matrix, with the same three-phase schedule as
    `adaptation.warmup_chains`. Returns `(warmed_traces, WarmupResult)`;
    sample with `NUTS(sel, result.eps, max_depth, result.inv_mass)`.
    """
    from genjax_tpu.inference.adaptation import (
        WarmupResult,
        cross_chain_inv_mass,
        da_final,
        da_init,
        da_update,
    )
    from genjax_tpu.inference.mcmc import _chain_axes

    if n_chains is None:
        n_chains = jnp.shape(traces.get_score())[0]
    axes = _chain_axes(traces, n_chains)

    def phase(key, traces, da, inv_mass, n):
        def step(carry, step_key):
            traces, da = carry
            eps = jnp.exp(da.log_eps)
            keys = jrand.split(step_key, n_chains)

            def one(k, tr):
                new_tr, info = nuts_kernel(
                    k, tr, selection, eps, max_depth, inv_mass
                )
                return new_tr, info.accept_stat

            traces, stats = jax.vmap(one, in_axes=(0, axes), out_axes=(axes, 0))(
                keys, traces
            )
            mean_stat = jnp.mean(stats)
            return (traces, da_update(da, mean_stat, target=target_accept)), mean_stat

        keys = jrand.split(key, n)
        (traces, da), hist = jax.lax.scan(step, (traces, da), keys)
        return traces, da, hist

    n1 = max(1, int(0.3 * n_steps))
    n3 = max(1, int(0.2 * n_steps))
    n2 = max(1, n_steps - n1 - n3)
    k1, k2, k3 = jrand.split(key, 3)

    da = da_init(eps0)
    inv_mass = None
    traces, da, _ = phase(k1, traces, da, inv_mass, n1)
    if adapt_mass:
        inv_mass = cross_chain_inv_mass(traces, selection, n_chains)
        # Metric changed: under a variance-matched mass the conditioned
        # target is roughly unit-scale, so restart averaging from eps = 1
        # (same rationale as adaptation.warmup_chains).
        da = da_init(1.0)
    traces, da, _ = phase(k2, traces, da, inv_mass, n2)
    if adapt_mass:
        inv_mass = cross_chain_inv_mass(traces, selection, n_chains)
    traces, da, hist = phase(k3, traces, da, inv_mass, n3)
    return traces, WarmupResult(
        eps=da_final(da), inv_mass=inv_mass, accept_rate=jnp.mean(hist)
    )

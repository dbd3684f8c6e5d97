"""Cookbook: JAX patterns for probabilistic programs on an accelerator.

Mirrors the reference cookbook's JAX-basics notes (active/jax_basics.ipynb
topics), accelerator-first: jit/vmap/scan discipline, PRNG keys, static vs traced
values (`Const`), the kwargs path, and the opt-in `checked_mode` for
catching call mistakes early.
"""

import jax
import jax.numpy as jnp

import genjax_tpu as genjax
from genjax_tpu import ChoiceMap, checked_mode
from genjax_tpu.core.pytree import Const
from genjax_tpu import gen, normal


@gen
def model(mu, n: Const):
    # `Const` carries a static value through jit: shapes must be concrete
    # at trace time, and treating n as a plain (traced) int would fail.
    xs = normal(mu * jnp.ones(n.unwrap()), 1.0) @ "xs"
    return jnp.sum(xs)


def main():
    key = jax.random.key(0)

    # --- jit: trace once, run compiled; static structure via Const ---
    tr = jax.jit(model.simulate)(key, (0.5, Const(8)))
    assert tr.get_choices()["xs"].shape == (8,)

    # --- vmap: particle axes are just batch axes ---
    keys = jax.random.split(key, 32)
    trs = jax.vmap(lambda k: model.simulate(k, (0.5, Const(8))))(keys)
    assert trs.get_score().shape == (32,)

    # --- scan: time axes compile to one step body ---
    @gen
    def walk(z, _x):
        z = normal(z, 1.0) @ "z"
        return (z, z)

    ssm = genjax.scan(n=16)(walk)
    tr = jax.jit(ssm.simulate)(key, (0.0, None))
    carry, zs = tr.get_retval()
    assert zs.shape == (16,)

    # --- PRNG discipline: keys are values, never reused ---
    k1, k2 = jax.random.split(key)
    a = model.simulate(k1, (0.0, Const(4))).get_score()
    b = model.simulate(k2, (0.0, Const(4))).get_score()
    assert not jnp.isclose(a, b)  # different keys, different draws

    # --- kwargs work through the GFI ---
    @gen
    def kw_model():
        return normal(loc=1.0, scale=0.1) @ "v"

    v = kw_model.simulate(key, ()).get_retval()
    assert 0.5 < float(v) < 1.5

    # --- checked_mode: catch call mistakes with targeted errors ---
    with checked_mode():
        try:
            model.simulate(42, (0.0, Const(4)))  # raw seed, not a key
            raise AssertionError("should have raised")
        except TypeError as e:
            assert "PRNG key" in str(e)
        try:
            model.generate(key, {"xs": jnp.zeros(4)}, (0.0, Const(4)))
            raise AssertionError("should have raised")
        except TypeError as e:
            assert "ChoiceMap" in str(e)

    # --- everything composes: jit(vmap(generate)) on an accelerator ---
    constraint = ChoiceMap.kw(xs=jnp.zeros(8))

    @jax.jit
    def importance_batch(keys):
        return jax.vmap(
            lambda k: model.importance(k, constraint, (0.0, Const(8)))[1]
        )(keys)

    ws = importance_batch(jax.random.split(key, 64))
    assert ws.shape == (64,) and bool(jnp.all(jnp.isfinite(ws)))

    print("jax-patterns cookbook: all checks passed")


if __name__ == "__main__":
    main()

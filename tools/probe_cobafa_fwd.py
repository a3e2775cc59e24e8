#!/usr/bin/env python
"""Dissect the cobafa field FORWARD at the flagship budget.

Candidate costs of the field forward beyond its builds and gathers, each
isolated here:

  (a) the gather-fold pathology (a fwd-only program may fold the oct
      build's final reshape into the consuming gather, lowering it to a
      general gather) surviving the `_TABLE_BARRIER` optimization_barrier;
  (b) the per-level Dropout masks (7 x threefry bernoulli over
      [cap, C] — RNG lanes are not free);
  (c) the coefficient product / per-level elementwise work.

Run: python tools/probe_cobafa_fwd.py [--cap 819200]
"""

from __future__ import annotations

import argparse
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def timeit(name, f, *args, iters=10):
    import jax
    import jax.numpy as jnp

    def _sync(out):
        leaf = jax.tree_util.tree_leaves(out)[0]
        float(jnp.sum(leaf.astype(jnp.float32)))

    _sync(f(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args)
    _sync(out)
    ms = (time.perf_counter() - t0) / iters * 1e3
    print(f"{name:52s} {ms:9.2f} ms", flush=True)
    return out


def main() -> None:
    import jax
    import jax.numpy as jnp

    from tinynerf.models.cobafa import CobafaFeatureField
    from tinynerf.ops import interp as I

    ap = argparse.ArgumentParser()
    ap.add_argument("--cap", type=int, default=819_200)
    args = ap.parse_args()
    cap = args.cap

    print(f"devices: {jax.devices()}  cap={cap}", flush=True)
    field = CobafaFeatureField()
    params = field.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-1, 1, size=(cap, 3)).astype(np.float32))
    gd = jnp.bfloat16
    key = jax.random.PRNGKey(1)

    # ---- full apply: dropout on vs off (isolates the RNG masks)
    timeit(
        "field.apply fwd (dropout ON)",
        jax.jit(lambda p, x: field.apply(p, x, jnp.bfloat16, dropout_key=key)),
        params, x,
    )
    timeit(
        "field.apply fwd (dropout OFF)",
        jax.jit(lambda p, x: field.apply(p, x, jnp.bfloat16)),
        params, x,
    )

    # ---- build + gather in ONE jit (the shipped path), barrier as shipped
    grids = [params["coef"]] + list(params["basis"])

    @jax.jit
    def build_and_gather(params, x):
        outs = []
        for g in [params["coef"]] + list(params["basis"]):
            r0, r1, r2, f = g.shape
            oct_t = I._build_oct(g, gd)
            cell, w = I._cell_3d(x, r0, r1, r2)
            rows = jnp.take(oct_t, cell, axis=0).astype(jnp.float32)
            vals = rows.reshape(*cell.shape, 8, f)
            outs.append(jnp.sum(vals * w[..., None], axis=-2))
        return tuple(outs)

    timeit("build+gather ONE jit (barrier as shipped)", build_and_gather,
           params, x)

    # ---- same, barrier forced OFF (measures what the barrier buys)
    orig = I._TABLE_BARRIER
    try:
        I._TABLE_BARRIER = False

        @jax.jit
        def build_and_gather_nobar(params, x):
            outs = []
            for g in [params["coef"]] + list(params["basis"]):
                r0, r1, r2, f = g.shape
                oct_t = I._build_oct(g, gd)
                cell, w = I._cell_3d(x, r0, r1, r2)
                rows = jnp.take(oct_t, cell, axis=0).astype(jnp.float32)
                vals = rows.reshape(*cell.shape, 8, f)
                outs.append(jnp.sum(vals * w[..., None], axis=-2))
            return tuple(outs)

        timeit("build+gather ONE jit (barrier OFF)", build_and_gather_nobar,
               params, x)
    finally:
        I._TABLE_BARRIER = orig

    # ---- gathers from PRE-BUILT oct tables passed as jit args (no fold
    # possible: the tables are materialized inputs)
    octs = jax.jit(
        lambda ps: tuple(I._build_oct(g, gd) for g in [ps["coef"]] + list(ps["basis"]))
    )(params)

    @jax.jit
    def gather_only(octs, x):
        outs = []
        for g, oct_t in zip(grids, octs):
            r0, r1, r2, f = g.shape
            cell, w = I._cell_3d(x, r0, r1, r2)
            rows = jnp.take(oct_t, cell, axis=0).astype(jnp.float32)
            vals = rows.reshape(*cell.shape, 8, f)
            outs.append(jnp.sum(vals * w[..., None], axis=-2))
        return tuple(outs)

    timeit("gathers from PRE-BUILT octs (args)", gather_only, octs, x)

    @jax.jit
    def builds_only(params):
        return tuple(
            I._build_oct(g, gd) for g in [params["coef"]] + list(params["basis"])
        )

    timeit("builds only (all 7)", builds_only, params)

    # ---- the sawtooth/coords/weights VPU work alone
    @jax.jit
    def coords_only(x):
        outs = []
        for g, f in zip(grids, [None] + list(field.freqs)):
            r0, r1, r2, _ = g.shape
            c = x if f is None else I.sawtooth(x, f)
            outs.append(I._cell_3d(c, r0, r1, r2))
        return tuple(outs)

    timeit("cell+weights VPU (all 7)", coords_only, x)


if __name__ == "__main__":
    main()

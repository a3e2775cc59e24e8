#!/usr/bin/env python
"""Isolate the reshape-fold-into-gather pathology on the fused-fine forward.

Hypothesis: the quad/oct table builds end in a reshape ([X, m*4F] ->
[M, 4F]) that XLA may fold into the consuming row gather, lowering it to a
general gather.  An optimization_barrier on the built table
(ops/interp.py _TABLE_BARRIER) forces materialization; this times the field
with the shipped settings so the two can be compared.

Run: python tools/probe_gather_fold.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def timeit(f, *args, iters=10):
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
    return (time.perf_counter() - t0) / iters


def main() -> None:
    import jax
    import jax.numpy as jnp

    from tinynerf.models.kplanes import KPlanesFeatureField

    print(f"devices: {jax.devices()}", flush=True)
    rng = np.random.default_rng(0)
    n = 819_200
    coords = jnp.asarray(rng.uniform(-1, 1, (n, 3)).astype(np.float32))

    from dataclasses import replace

    base = KPlanesFeatureField()
    params = {"field": base.init(jax.random.PRNGKey(0))}

    combos = [
        dict(fwd_mode="perscale", gather_dtype="bfloat16"),
        dict(fwd_mode="fusedfine", gather_dtype="bfloat16"),
        dict(lookup_mode="quad", gather_dtype="bfloat16"),
    ]
    for kw in combos:
        field = replace(base, **kw)

        @jax.jit
        def fwd(p, c, field=field):
            return sum(
                jnp.sum(t.astype(jnp.float32))
                for t in field.apply_pieces(p["field"], c, jnp.float32)
            )

        @jax.jit
        def fwdbwd(p, c, fwd=fwd):
            return jax.grad(lambda pp: fwd(pp, c))(p)

        ms_f = timeit(fwd, params, coords) * 1e3
        ms_g = timeit(fwdbwd, params, coords) * 1e3
        print(f"{kw}: field fwd {ms_f:7.2f} ms   fwd+bwd {ms_g:7.2f} ms",
              flush=True)


if __name__ == "__main__":
    main()

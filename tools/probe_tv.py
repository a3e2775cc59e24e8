#!/usr/bin/env python
"""A/B the TV/L1 regularizer gradient formulations at the flagship K-Planes
table roster (129/257/513^2 x 32, 3 projections each).

The round-4 audit has TV grad at 7.7 ms vs a ~2 ms traffic floor (the 133 MB
f32 roster, fwd+bwd).  Variants measured here:
  f32_row   — shipped loss_tv (row-major [r, r*F] view, f32)
  bf16_row  — same view, diffs in bf16 (halved traffic; f32 mean accumulate)
  f32_3d    — naive [r, r, F] axis diffs (the 32-lane minor-dim strawman)
  manual    — closed-form TV gradient (no autodiff: grad = 2/N * discrete
              Laplacian), fwd loss skipped — the train step only needs the
              grad contribution
Plus the L1 grad (sign/N) and the fused single-pass Adam for context.

Run: python tools/probe_tv.py
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
    return (time.perf_counter() - t0) / iters * 1e3


def tv_row(params, dtype):
    import jax.numpy as jnp

    total = jnp.float32(0.0)
    count = 0
    for scale_planes in params["planes"]:
        for plane in scale_planes:
            r0, r1, f = plane.shape
            v = plane.reshape(r0, r1 * f).astype(dtype)
            d0 = v[1:, :] - v[:-1, :]
            d1 = v[:, f:] - v[:, :-f]
            tv0 = jnp.sum((d0 * d0).astype(jnp.float32)) / d0.size
            tv1 = jnp.sum((d1 * d1).astype(jnp.float32)) / d1.size
            total = total + tv0 + tv1
            count += 1
    return total / count


def tv_3d(params):
    import jax.numpy as jnp

    total = jnp.float32(0.0)
    count = 0
    for scale_planes in params["planes"]:
        for plane in scale_planes:
            tv0 = jnp.mean((plane[1:, :, :] - plane[:-1, :, :]) ** 2)
            tv1 = jnp.mean((plane[:, 1:, :] - plane[:, :-1, :]) ** 2)
            total = total + tv0 + tv1
            count += 1
    return total / count


def tv_grad_manual(params):
    """Closed-form grad of tv_row: for each axis, grad = 2/N * (neighbor
    Laplacian) — one shifted-subtract per direction, no autodiff graph."""
    import jax.numpy as jnp

    n_planes = sum(len(sp) for sp in params["planes"])
    grads = []
    for scale_planes in params["planes"]:
        g_scale = []
        for plane in scale_planes:
            r0, r1, f = plane.shape
            v = plane.reshape(r0, r1 * f)
            w = r1 * f
            d0 = v[1:, :] - v[:-1, :]  # [r0-1, w]
            z = jnp.zeros((1, w), v.dtype)
            g0 = jnp.concatenate([z, d0], 0) - jnp.concatenate([d0, z], 0)
            d1 = v[:, f:] - v[:, :-f]  # [r0, w-f]
            zf = jnp.zeros((r0, f), v.dtype)
            g1 = jnp.concatenate([zf, d1], 1) - jnp.concatenate([d1, zf], 1)
            g = (2.0 / d0.size) * g0 + (2.0 / d1.size) * g1
            g_scale.append((g / n_planes).reshape(r0, r1, f))
        grads.append(g_scale)
    return {"planes": grads}


def main() -> None:
    import jax
    import jax.numpy as jnp

    from tinynerf.models.kplanes import KPlanesFeatureField

    print(f"devices: {jax.devices()}", flush=True)
    field = KPlanesFeatureField()
    params = field.init(jax.random.PRNGKey(0))

    loss_fns = {
        "f32_row (shipped)": jax.jit(jax.grad(field.loss_tv)),
        "bf16_row": jax.jit(jax.grad(lambda p: tv_row(p, jnp.bfloat16))),
        "f32_3d": jax.jit(jax.grad(tv_3d)),
    }
    for name, f in loss_fns.items():
        print(f"TV grad {name:20s} {timeit(f, params):7.2f} ms", flush=True)

    man = jax.jit(tv_grad_manual)
    print(f"TV grad {'manual closed-form':20s} {timeit(man, params):7.2f} ms",
          flush=True)

    # numeric check: manual == autodiff of the shipped loss
    g_auto = jax.jit(jax.grad(field.loss_tv))(params)
    g_man = man(params)
    errs = [
        float(jnp.max(jnp.abs(a - m)))
        for a, m in zip(
            jax.tree_util.tree_leaves(g_auto), jax.tree_util.tree_leaves(g_man)
        )
    ]
    print(f"manual-vs-autodiff max abs err: {max(errs):.3e}", flush=True)

    l1 = jax.jit(jax.grad(field.loss_l1))
    print(f"L1 grad {'autodiff':20s} {timeit(l1, params):7.2f} ms", flush=True)


if __name__ == "__main__":
    main()

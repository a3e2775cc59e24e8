#!/usr/bin/env python
"""GPU timings behind four defaults.

  weights   the packed transmittance (ops/weights.py) at 819,200 samples,
            fwd+bwd: the Triton kernel `compute_weights_packed` lowers to
            on CUDA against the plain XLA form, on three ragged layouts.
  step      the same choice end to end: the steady-state K-Planes step of
            bench.py with the renderer's packed op lowering to the Triton
            kernel and to the plain XLA form, `--pairs` pairs of runs,
            alternating which side runs first.
  scatter   the table-gradient row scatter at the Cobafa 127^3 oct shape
            (2,048,383 rows x 64 f32, 819,200 updates): plain `.at[].add`
            against the lane-packed form (4 rows side by side, 512,096
            rows x 256) that earlier versions used.
  field     the K-Planes fused field (field_scale 1.0) at 819,200 samples:
            forward, and forward + backward (`jax.vjp`); the backward's time
            against the least device-memory traffic any backward must move
            (its HBM roofline share), and, under its own name, the traffic
            of the present design's intermediate buffers.

Needs an NVIDIA GPU.  Prints the card's name and power limit, then one JSON
line per measurement.

Run: python tools/bench_ops.py [--sections weights,step,scatter,field]
         [--iters 20] [--pairs 20] [--steps 20]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth at the 700 W power limit
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def timed(fn, *args, iters: int) -> float:
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def scatter_packed(n_rows, idx, contrib, p):
    """The lane-packed scatter: view [n_rows, w] as [ceil(n_rows/p), p*w],
    one-hot-expand each update into its lane group, scatter, reshape back."""
    n, w = contrib.shape
    n_pack = -(-n_rows // p)
    onehot = ((idx % p)[:, None] == jnp.arange(p)[None, :]).astype(contrib.dtype)
    upd = (onehot[:, :, None] * contrib[:, None, :]).reshape(n, p * w)
    acc = jnp.zeros((n_pack, p * w), contrib.dtype).at[idx // p].add(upd)
    return acc.reshape(n_pack * p, w)[:n_rows]


def bench_weights(iters: int) -> list:
    from chip_smoke import packed_problem
    from tinynerf.ops.weights import compute_weights_packed, compute_weights_packed_xla

    def fwd_bwd(op):
        return jax.jit(lambda s, d, c, g: jax.value_and_grad(
            lambda s: jnp.sum(op(s, d, c, 1e-4) * g))(s))

    fns = {"triton": fwd_bwd(compute_weights_packed),
           "xla": fwd_bwd(compute_weights_packed_xla)}
    rows = []
    for seed, n_rays, max_len in ((1, 2048, 400), (2, 16_384, 100), (3, 49_152, 33)):
        _, arrays, _ = packed_problem(seed, n_rays, max_len, 819_200, 0.013)
        args = tuple(map(jnp.asarray, arrays))
        out = {"triton": [], "xla": []}
        for name in ("xla", "triton", "triton", "xla"):  # in turns
            out[name].append(timed(fns[name], *args, iters=iters))
        rows.append({"op": "packed_weights_fwd_bwd", "rays": n_rays,
                     "max_run": max_len, "ms": out})
    return rows


def quartiles(xs) -> dict:
    q1, med, q3 = np.percentile(xs, (25, 50, 75))
    return {"q1": float(q1), "median": float(med), "q3": float(q3)}


def bench_step(pairs: int, steps: int) -> list:
    """Steady-state K-Planes step (bench.make_steady_state), renderer's packed
    op on the plain XLA form ("xla", traced while patched in) and on the
    Triton kernel ("triton"): ms/step of `pairs` pairs of `steps`-step runs,
    alternating which side runs first.  The kernel counts as faster when it
    wins 9 of 10 pairs and the medians differ by more than the XLA runs'
    interquartile spread."""
    from unittest import mock

    import bench
    from tinynerf.core import renderer as renderer_mod
    from tinynerf.ops.weights import compute_weights_packed_xla

    runs = {}
    with mock.patch.object(renderer_mod, "compute_weights_packed", compute_weights_packed_xla):
        runs["xla"], info = bench.make_steady_state()
        runs["xla"](2)  # traces and compiles the step under the patch
    runs["triton"], _ = bench.make_steady_state()
    runs["triton"](2)
    ms = {"xla": [], "triton": []}
    for i in range(pairs):
        for name in ("xla", "triton") if i % 2 == 0 else ("triton", "xla"):
            t0 = time.perf_counter()
            runs[name](steps)
            ms[name].append((time.perf_counter() - t0) / steps * 1e3)
    wins = sum(t < x for t, x in zip(ms["triton"], ms["xla"]))
    q = {k: quartiles(v) for k, v in ms.items()}
    spread = q["xla"]["q3"] - q["xla"]["q1"]
    gain = q["xla"]["median"] - q["triton"]["median"]
    return [{"op": "kplanes_step_packed_weights_ab", **info, "pairs": pairs,
             "steps_per_run": steps, "ms": ms, "quartiles": q,
             "triton_wins": wins, "median_gain_ms": gain, "xla_iqr_ms": spread,
             "triton_faster": wins >= 0.9 * pairs and gain > spread}]


def bench_scatter(iters: int) -> list:
    n_rows, w, n = 127**3, 64, 819_200
    rng = np.random.default_rng(0)
    idx = jnp.asarray(rng.integers(0, n_rows, n).astype(np.int32))
    upd = jnp.asarray(rng.normal(size=(n, w)).astype(np.float32))
    plain = jax.jit(lambda i, u: jnp.zeros((n_rows, w), jnp.float32).at[i].add(u))
    packed = jax.jit(lambda i, u: scatter_packed(n_rows, i, u, 4))
    np.testing.assert_allclose(
        np.asarray(plain(idx, upd)), np.asarray(packed(idx, upd)), atol=1e-4
    )
    out = {"plain": [], "packed_p4": []}
    for name in ("plain", "packed_p4", "packed_p4", "plain"):  # in turns
        fn = plain if name == "plain" else packed
        out[name].append(timed(fn, idx, upd, iters=iters))
    return [{"op": f"scatter_{k}", "rows": n_rows, "width": w, "updates": n,
             "ms": v} for k, v in out.items()]


def field_bwd_design_bytes(resolutions, f, n) -> int:
    """HBM traffic of the present fused K-Planes backward's buffers per call:
    for each of the 3 projections, read the [n, f_tot] cotangent, write and
    read back the [(r-1)^2, 4 f_tot] quad gradient and the [r, r, f_tot]
    fine gradient, and write the per-scale master gradients (f32)."""
    r = max(resolutions)
    f_tot = f * len(resolutions)
    quad = (r - 1) ** 2 * 4 * f_tot * 4
    fine = r * r * f_tot * 4
    masters = sum(q * q for q in resolutions) * f * 4
    return 3 * (n * f_tot * 4 + 2 * quad + 2 * fine + masters)


def nbytes(tree) -> int:
    return sum(a.nbytes for a in jax.tree_util.tree_leaves(tree))


def bench_field(iters: int, n: int = 819_200) -> list:
    from tinynerf.models import make_model

    field, _, _ = make_model("kplanes")
    params = field.init(jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (n, 3), minval=-1, maxval=1)
    cot = tuple(
        jax.random.normal(jax.random.PRNGKey(2 + i), (n, field.feature_dim_per_plane))
        for i in range(len(field.resolutions))
    )
    fwd = jax.jit(lambda p, x: field.apply_pieces(p, x))
    fwd_bwd = jax.jit(lambda p, x, c: jax.vjp(lambda p: field.apply_pieces(p, x), p)[1](c))
    t_fwd = timed(fwd, params, x, iters=iters)
    t_all = timed(fwd_bwd, params, x, cot, iters=iters)
    peak = PEAK_BYTES_PER_S[jax.devices()[0].device_kind]
    # the least any backward must move: the cotangent, the sample positions
    # and the tables (the other projections' values) read once, the
    # table gradients written once
    floor = nbytes(cot) + x.nbytes + 2 * nbytes(params)
    design = field_bwd_design_bytes(field.resolutions, field.feature_dim_per_plane, n)
    t_bwd = t_all - t_fwd
    return [{"op": "kplanes_field", "samples": n, "fwd_ms": t_fwd,
             "fwd_bwd_ms": t_all, "bwd_ms": t_bwd,
             "bwd_floor_bytes": floor, "bwd_roofline_ms": floor / peak * 1e3,
             "bwd_roofline_share": floor / peak * 1e3 / t_bwd,
             "bwd_design_bytes": design, "bwd_design_ms_at_peak": design / peak * 1e3}]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default="weights,step,scatter,field")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--pairs", type=int, default=20, help="step section: A/B pairs")
    ap.add_argument("--steps", type=int, default=20, help="step section: steps a run")
    args = ap.parse_args()

    from tinynerf.utils.runtime import card_line, enable_compile_cache, require_gpu

    require_gpu()
    print(f"device: {card_line()}", flush=True)
    enable_compile_cache()
    sections = {
        "weights": lambda: bench_weights(args.iters),
        "step": lambda: bench_step(args.pairs, args.steps),
        "scatter": lambda: bench_scatter(args.iters),
        "field": lambda: bench_field(args.iters),
    }
    for name in args.sections.split(","):
        for row in sections[name]():
            print(json.dumps(row), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())

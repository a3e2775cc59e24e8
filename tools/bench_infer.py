#!/usr/bin/env python
"""Serving-throughput benchmark: rendered rays/sec for the packed eval
path vs the dense brute-force path (the reference's infer(),
/root/reference/src/run.py:15-50 — it has no packed inference at all).

Same steady-state setup as bench.py (shell-converged occupancy at the
flagship budget), timed per fixed-size ray chunk.

Usage: python tools/bench_infer.py [--method kplanes] [--chunk 8192]
       [--spr_cap 64] [--scene_type aabb]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from tinynerf.train import TrainConfig, build_renderer
    from tinynerf.train.loop import (
        make_render_chunk,
        make_render_chunk_packed,
    )
    from tinynerf.utils import make_shell_occupancy

    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="kplanes")
    ap.add_argument("--scene_type", default="aabb",
                    choices=["aabb", "unbounded"])
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--spr_cap", type=int, default=64,
                    help="packed eval capacity in samples per ray")
    ap.add_argument("--n", type=int, default=10, help="timed chunks")
    args = ap.parse_args()

    cfg = TrainConfig(
        method=args.method,
        scene_type=args.scene_type,
        batch_size=args.chunk,
        n_samples=400,
        occupancy_res=128,
    )
    renderer = build_renderer(cfg, scene_scale=1.0,
                              bg_color=np.ones(3, np.float32))
    params = renderer.init(jax.random.PRNGKey(0))
    occ_state = make_shell_occupancy(renderer, cfg.occupancy_res)

    rng = np.random.default_rng(0)
    d = rng.normal(size=(args.n + 2, args.chunk, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -4.0 * d
    o_dev = jnp.asarray(o)
    d_dev = jnp.asarray(d)

    @jax.jit
    def _scalar(x):
        return jnp.sum(x.astype(jnp.float32))

    def bench(name, fn, *extra):
        # warmup / compile
        out = fn(params, occ_state, o_dev[0], d_dev[0], *extra)
        first = jax.tree_util.tree_leaves(out)[0]
        float(_scalar(first))
        t0 = time.perf_counter()
        outs = []
        for i in range(args.n):
            out = fn(params, occ_state, o_dev[2 + i], d_dev[2 + i], *extra)
            outs.append(jax.tree_util.tree_leaves(out)[0])
        float(_scalar(sum(_scalar(x) for x in outs)))
        dt = (time.perf_counter() - t0) / args.n
        rps = args.chunk / dt
        print(f"{name:40s} {dt*1e3:8.2f} ms/chunk  {rps/1e3:9.1f}k rays/s",
              flush=True)
        if name.startswith("packed"):
            ok = np.asarray(out[1])
            print(f"{'':40s} ok: {ok.mean()*100:.1f}% of rays "
                  f"(rest would fall back)", flush=True)
        return rps

    dense_fn = make_render_chunk(renderer)
    rps_dense = bench("dense (reference eval semantics)", dense_fn)

    cap = args.chunk * args.spr_cap
    packed_fn = make_render_chunk_packed(renderer, cap, march="dense")
    rps_packed = bench(f"packed dense-march (cap {args.spr_cap}/ray)",
                       packed_fn)

    if renderer.supports_skip_march:
        grid = jax.jit(renderer.skip_grid)(occ_state)
        skip_fn = make_render_chunk_packed(renderer, cap, march="skip")
        rps_skip = bench(f"packed skip-march (cap {args.spr_cap}/ray)",
                         skip_fn, grid)
    else:
        rps_skip = float("nan")

    best = max(rps_packed, rps_skip if rps_skip == rps_skip else 0.0)
    print(f"\nserving speedup vs dense: {best / rps_dense:.2f}x")


if __name__ == "__main__":
    main()

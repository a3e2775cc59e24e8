#!/usr/bin/env python
"""Training-throughput benchmark: trained rays/s per card on the flagship
config (K-Planes, AABB scene, 2048-ray x 400-sample budget — the reference's
default schedule, reference train.py:17-18).

Measures STEADY-STATE training throughput: the occupancy grid is set to a
converged-like thin shell (utils/fixtures.py make_shell_occupancy), so the
bucketed candidate batching runs at a realistic multiplier — the regime the
reference's dynamic batching reaches after its occupancy grid converges.

Needs an NVIDIA GPU.  Prints the card's name and power limit, then ONE JSON
line: {"metric", "value", "unit", "device", ...}.

Run: python bench.py [--method kplanes] [--scene_type aabb]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

N_STEPS = 20


def make_steady_state(method: str = "kplanes", scene_type: str = "aabb",
                      batch_size: int = 2048):
    """Build the steady-state train step; returns (run, info) where
    `run(n_steps)` executes n steps and returns the rays that entered the
    loss (synchronised)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tinynerf.parallel import make_mesh
    from tinynerf.train import TrainConfig, build_renderer, make_optimizer
    from tinynerf.train.loop import MarchPolicy, make_train_step, pick_bucket
    from tinynerf.utils import make_shell_occupancy

    mesh = make_mesh()
    cfg = TrainConfig(method=method, scene_type=scene_type,
                      batch_size=batch_size, n_samples=400, occupancy_res=128)
    renderer = build_renderer(cfg, scene_scale=1.0, bg_color=np.ones(3, np.float32))
    optimizer = make_optimizer(cfg)
    state = {"params": renderer.init(jax.random.PRNGKey(0))}
    state["opt"] = optimizer.init(state["params"])
    occ_state = make_shell_occupancy(renderer, cfg.occupancy_res)

    # ray pool: cameras on a sphere of radius 4 aimed at the scene center
    rng = np.random.default_rng(0)
    n_pool = 1 << 20
    d = rng.normal(size=(n_pool, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sh = NamedSharding(mesh, P("data"))
    pools = tuple(
        jax.device_put(a, sh)
        for a in (-4.0 * d, d, rng.uniform(size=(n_pool, 3)).astype(np.float32))
    )

    # steady-state bucket: largest whose expected demand fits the cap (one
    # bucket-1 probe step estimates samples/ray)
    probe = make_train_step(renderer, optimizer, cfg, mesh, n_cand=cfg.batch_size)
    state["params"], state["opt"], m = probe(
        state["params"], state["opt"], occ_state, *pools, jax.random.PRNGKey(9)
    )
    fill, rays = float(m["fill"]), float(m["rays_used"])
    avg_spr = max(1.0, fill * cfg.sample_cap / max(rays, 1.0))
    bucket = pick_bucket(cfg, avg_spr)
    march = MarchPolicy(
        renderer.supports_skip_march, cfg.march, renderer.skip_steps
    ).pick(avg_spr)
    grid_args = (jax.jit(renderer.skip_grid)(occ_state),) if march == "skip" else ()
    n_cand = bucket * cfg.batch_size
    step_fn = make_train_step(renderer, optimizer, cfg, mesh, n_cand=n_cand, march=march)

    def run(n_steps: int, seed: int = 100) -> float:
        used = []
        for i in range(n_steps):
            state["params"], state["opt"], m = step_fn(
                state["params"], state["opt"], occ_state, *grid_args, *pools,
                jax.random.PRNGKey(seed + i),
            )
            used.append(m["rays_used"])
        return float(sum(jax.device_get(used)))

    info = {"bucket": bucket, "march": march, "n_cand": n_cand,
            "avg_samples_per_ray": round(avg_spr, 2), "n_devices": mesh.devices.size}
    return run, info


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch_size", type=int, default=2048)
    ap.add_argument("--method", default="kplanes")
    ap.add_argument("--scene_type", default="aabb", choices=["aabb", "unbounded"])
    args = ap.parse_args()

    import jax

    from tinynerf.utils.runtime import card_line, enable_compile_cache, require_gpu

    require_gpu()
    card = card_line()
    print(f"device: {card}", file=sys.stderr, flush=True)
    enable_compile_cache()

    run, info = make_steady_state(args.method, args.scene_type, args.batch_size)
    print(f"steady state: {info}", file=sys.stderr, flush=True)
    run(2)  # compile + warm-up
    t0 = time.perf_counter()
    rays_used = run(N_STEPS)
    elapsed = time.perf_counter() - t0
    print(f"{elapsed / N_STEPS * 1e3:.2f} ms/step, {rays_used / N_STEPS:.0f} "
          f"trained rays/step", file=sys.stderr, flush=True)

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "train_rays_per_sec_per_chip",
        "value": rays_used / elapsed / info["n_devices"],
        "unit": "rays/s/chip",
        "ms_per_step": elapsed / N_STEPS * 1e3,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **info,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

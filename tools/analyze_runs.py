#!/usr/bin/env python
"""Measure same-cell RUN LENGTHS in the packed sample stream (CPU, exact).

Question (round-4 directive): consecutive samples of a ray that land in the
same projected plane cell could share one table-gather row / one scatter
row — merging runs would cut the row count both floored ops pay for.  The
achievable row reduction is bounded by 1 - n_runs / n_samples, measured
here on the bench's exact steady-state geometry (shell occupancy, sphere
cameras, flagship 2048x400 budget) by replaying the renderer's own marching
+ compaction on CPU.

Run: python tools/analyze_runs.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tinynerf.train import TrainConfig, build_renderer
    from tinynerf.utils import make_shell_occupancy

    cfg = TrainConfig(method="kplanes", scene_type="aabb",
                      batch_size=2048, n_samples=400, occupancy_res=128)
    renderer = build_renderer(cfg, scene_scale=1.0, bg_color=np.ones(3, np.float32))
    occ_state = make_shell_occupancy(renderer, cfg.occupancy_res)

    rng = np.random.default_rng(0)
    n_rays = 4096  # enough rays for tight run statistics
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -4.0 * d

    cpos, deltas, maskf = renderer._march(
        jnp.asarray(o), jnp.asarray(d), occ_state, jax.random.PRNGKey(0)
    )
    cpos = np.asarray(cpos)          # [R, S, 3] contracted coords in [-1, 1]
    mask = np.asarray(maskf) > 0.0   # [R, S]
    n_samp = int(mask.sum())
    spr = mask.sum(axis=1)
    print(f"rays={n_rays} surviving samples={n_samp} "
          f"(mean {n_samp / n_rays:.1f}/ray, max {spr.max()})")

    # packed stream is ray-major: concatenate valid samples per ray in order
    ray_id = np.broadcast_to(np.arange(n_rays)[:, None], mask.shape)[mask]
    pts = cpos[mask]  # [n_samp, 3] in packed order

    print(f"\n{'proj':>5} {'res':>5} {'runs/samples':>14} {'E[runlen]':>10} "
          f"{'row reduction':>14}")
    for res in (129, 257, 513):
        for axes, name in (((0, 1), "xy"), ((0, 2), "xz"), ((1, 2), "yz")):
            # align_corners cell = floor of continuous index (interp.py)
            ij = np.clip((pts[:, axes] + 1.0) * 0.5 * (res - 1), 0, res - 1)
            cell = np.floor(ij[:, 0]).astype(np.int64) * res + np.floor(
                ij[:, 1]
            ).astype(np.int64)
            same = (cell[1:] == cell[:-1]) & (ray_id[1:] == ray_id[:-1])
            n_runs = n_samp - int(same.sum())
            print(f"{name:>5} {res:>5} {n_runs:>7}/{n_samp:<7} "
                  f"{n_samp / n_runs:>9.2f} {1 - n_runs / n_samp:>13.1%}")

    # 3-D voxel runs (cobafa grids / occupancy-scale tables)
    print()
    for res in (64, 128):
        ijk = np.clip((pts + 1.0) * 0.5 * (res - 1), 0, res - 1)
        c = np.floor(ijk).astype(np.int64)
        cell = (c[:, 0] * res + c[:, 1]) * res + c[:, 2]
        same = (cell[1:] == cell[:-1]) & (ray_id[1:] == ray_id[:-1])
        n_runs = n_samp - int(same.sum())
        print(f"  vox {res:>4} {n_runs:>7}/{n_samp:<7} "
              f"{n_samp / n_runs:>9.2f} {1 - n_runs / n_samp:>13.1%}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Render a turntable orbit from a trained checkpoint (novel-view synthesis).

The reference shows a rendered demo video in its README; this produces the
frames (PNG sequence) from any experiment directory's checkpoint.

Usage:
  python tools/render_turntable.py --ckpt runs/<exp>/ckpt_4096.pkl \
      --method kplanes --out frames/ --n_frames 60 --res 400
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, required=True)
    ap.add_argument("--method", type=str, required=True,
                    choices=["vanilla", "kplanes", "cobafa"])
    ap.add_argument("--scene_type", default="aabb", choices=["aabb", "unbounded"])
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--n_frames", type=int, default=60)
    ap.add_argument("--res", type=int, default=400)
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--elevation", type=float, default=0.5,
                    help="camera height as a fraction of radius")
    ap.add_argument("--n_samples", type=int, default=400)
    ap.add_argument("--chunk", type=int, default=8192)
    args = ap.parse_args()

    import jax

    from tinynerf.data import Intrinsics, NerfData, PoseSet
    from tinynerf.train import TrainConfig, build_renderer, load_checkpoint
    from tinynerf.train.loop import infer, make_render_chunk_packed
    from tinynerf.utils.fixtures import CAMERA_ANGLE_X, look_at_matrix

    step, state = load_checkpoint(Path(args.ckpt))
    cfg = TrainConfig(
        method=args.method, scene_type=args.scene_type,
        n_samples=args.n_samples,
        occupancy_res=int(np.asarray(state["occ_state"].grid).shape[0]),
    )
    renderer = build_renderer(cfg, scene_scale=1.0, bg_color=np.ones(3, np.float32))

    focal = args.res / (2.0 * np.tan(0.5 * CAMERA_ANGLE_X))
    K = Intrinsics(focal, focal, args.res / 2.0, args.res / 2.0, args.res, args.res)
    cams = []
    for i in range(args.n_frames):
        theta = 2 * np.pi * i / args.n_frames
        eye = args.radius * np.array(
            [np.cos(theta), np.sin(theta), args.elevation]
        )
        cams.append(look_at_matrix(eye).astype(np.float32))
    data = NerfData(cameras=np.stack(cams), intrinsics=K)
    poses = PoseSet(data)

    # packed serving path (+ skip marching when supported); overflow rays
    # fall back to the dense path inside infer()
    can_skip = renderer.supports_skip_march
    packed_fn = make_render_chunk_packed(
        renderer, args.chunk * cfg.eval_samples_per_ray,
        march="skip" if can_skip else "dense",
    )
    grid_args = (
        (jax.jit(renderer.skip_grid)(state["occ_state"]),) if can_skip else ()
    )

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    infer(
        renderer, state["params"], state["occ_state"], poses,
        list(range(args.n_frames)), out, "frame", chunk=args.chunk,
        packed_fn=packed_fn, grid_args=grid_args,
    )
    print(f"{args.n_frames} frames written to {out} (checkpoint step {step})")


if __name__ == "__main__":
    main()

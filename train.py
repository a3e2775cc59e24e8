#!/usr/bin/env python
"""CLI entry point — same surface as the reference's train.py (flags:
--data --datatype --output --scene_type --method --batch_size --n_samples
--eval/--eval_every/--eval_n; SEED env var; unique experiment directory
{uuid8}_{method}_{scene}_{n_samples}), plus extras (--dtype, --resume,
--steps, --checkpoint_every, --render_only, ...).
"""

from __future__ import annotations

import argparse
import os
import uuid
from pathlib import Path

from tinynerf.data import PoseSet, RayPool, parse_nerf_synthetic, parse_nerfstudio
from tinynerf.train import TrainConfig, train
from tinynerf.utils.runtime import enable_compile_cache


def main(argv=None):
    """Run the CLI on `argv` (default: sys.argv).  Returns what `train`
    returns, or the per-image metrics of `--render_only`."""
    parser = argparse.ArgumentParser(
        prog="tinynerf", description="Train a radiance field"
    )
    parser.add_argument("--data", type=str, required=True, help="path to the data folder")
    parser.add_argument(
        "--datatype", type=str, required=True, choices=["synthetic", "nerfstudio"]
    )
    parser.add_argument("--output", type=str, required=True, help="output folder")
    parser.add_argument("--scene_type", type=str, default="aabb", choices=["aabb", "unbounded"])
    parser.add_argument("--method", type=str, required=True, choices=["vanilla", "kplanes", "cobafa"])
    parser.add_argument("--batch_size", type=int, default=2048)
    parser.add_argument("--n_samples", type=int, default=400, help="samples per ray")
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--eval_every", type=int, default=None)
    parser.add_argument("--eval_n", type=int, default=1)
    parser.add_argument("--steps", type=int, default=None, help="override step count")
    parser.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--resume", action="store_true", help="resume from latest checkpoint in --output")
    parser.add_argument("--render_only", action="store_true",
                        help="no training: render the test split from the "
                             "latest checkpoint in --output (an experiment "
                             "dir) and report metrics")
    parser.add_argument("--checkpoint_every", type=int, default=0)
    parser.add_argument("--profile_start", type=int, default=None,
                        help="capture a jax.profiler trace starting at this step")
    parser.add_argument("--profile_count", type=int, default=5)
    parser.add_argument("--march", type=str, default="auto",
                        choices=["auto", "dense", "skip"],
                        help="marching strategy (auto = empty-space skipping "
                             "once demand allows)")
    parser.add_argument("--max_bucket", type=int, default=None,
                        help="cap the candidate-ray bucket ladder (rays/step "
                             "<= max_bucket * batch_size); for tiny datasets "
                             "where the converged ladder overfits")
    parser.add_argument("--eval_render", type=str, default="packed",
                        choices=["packed", "dense"],
                        help="full-image render path: packed = training-style "
                             "sample compaction (+ skip marching) with exact "
                             "dense fallback for overflow rays; dense = "
                             "brute force")
    parser.add_argument("--remat", type=str, default="auto",
                        choices=["auto", "on", "off"],
                        help="rematerialize the field in the backward pass")
    parser.add_argument("--shard_tables", action="store_true",
                        help="ZeRO-1 sharded-table training on multi-device "
                             "meshes: scatter table grads, shard Adam state, "
                             "all_gather updated tables (parallel/zero.py)")
    parser.add_argument("--shard_bwd", action="store_true",
                        help="with --shard_tables: also shard the fused "
                             "K-Planes backward's fine-gradient pullback over "
                             "the mesh (ops/interp.py _sharded_pullback)")
    parser.add_argument("--field_scale", type=float, default=1.0,
                        help="scale the field's spatial capacity (table "
                             "resolutions / MLP width) preserving structure; "
                             "1.0 = reference configuration")
    args = parser.parse_args(argv)
    enable_compile_cache()

    seed = int(os.environ.get("SEED", 0))

    data_path = Path(args.data)
    if args.datatype == "synthetic":
        train_rays = RayPool(parse_nerf_synthetic(data_path, "train"))
        eval_set = PoseSet(parse_nerf_synthetic(data_path, "val"))
        test_set = PoseSet(parse_nerf_synthetic(data_path, "test"))
    elif args.datatype == "nerfstudio":
        train_rays = RayPool(parse_nerfstudio(data_path, "train"))
        eval_set = PoseSet(parse_nerfstudio(data_path, "val"))
        test_set = PoseSet(parse_nerfstudio(data_path, "test"))
    else:
        raise NotImplementedError(args.datatype)

    output = Path(args.output)
    if args.resume or args.render_only:
        experiment_dir = output  # operate on an existing experiment dir
    else:
        while True:
            exp_id = str(uuid.uuid4())[:8]
            name = f"{exp_id}_{args.method}_{args.scene_type}_{args.n_samples}"
            if not (output / name).is_dir():
                break
        experiment_dir = output / name
        experiment_dir.mkdir(parents=True)

    print(f"Experiment saved to {experiment_dir}")

    cfg = TrainConfig(
        method=args.method,
        scene_type=args.scene_type,
        output=experiment_dir,
        batch_size=args.batch_size,
        n_samples=args.n_samples,
        eval_every=args.eval_every,
        eval_n=args.eval_n,
        steps=args.steps,
        seed=seed,
        compute_dtype=args.dtype,
        checkpoint_every=args.checkpoint_every,
        profile_start=args.profile_start,
        profile_count=args.profile_count,
        march=args.march,
        eval_render=args.eval_render,
        max_bucket=args.max_bucket,
        remat_field=None if args.remat == "auto" else (args.remat == "on"),
        shard_tables=args.shard_tables,
        shard_bwd=args.shard_bwd,
        field_scale=args.field_scale,
    )
    if args.render_only:
        from tinynerf.train.loop import render_only

        return render_only(cfg, test_set)

    # --eval without an explicit cadence evaluates 8 times over the run
    if args.eval and cfg.eval_every is None:
        cfg.eval_every = max(1, cfg.total_steps // 8)
    return train(cfg, train_rays, eval_set, test_set, resume=args.resume)


if __name__ == "__main__":
    main()

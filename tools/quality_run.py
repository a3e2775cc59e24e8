#!/usr/bin/env python
"""Quality smoke: train on a generated analytic scene and report test PSNR.

Validates training dynamics end-to-end (does PSNR actually climb?) and lets
lookup/precision variants be A/B-tested without external datasets (the
container has no network access to fetch Blender scenes).

Usage: python tools/quality_run.py [--method kplanes] [--steps 300]
       [--lookup quad|mixed|plain] [--gather-dtype bfloat16|float32]
"""

import argparse
import sys
import tempfile
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="kplanes")
    ap.add_argument("--scene_type", default="aabb", choices=["aabb", "unbounded"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--n_samples", type=int, default=128)
    ap.add_argument("--lookup", default=None, choices=[None, "fused", "quad", "mixed", "plain"])
    ap.add_argument("--fwd-mode", default=None, choices=[None, "perscale", "fusedfine"],
                    help="kplanes fused-mode forward gather shape")
    ap.add_argument("--eval-every", type=int, default=None,
                    help="eval cadence for the time-to-PSNR timeline")
    ap.add_argument("--eval-n", type=int, default=2)
    ap.add_argument("--gather-dtype", default=None, choices=[None, "bfloat16", "float32", "float8"])
    ap.add_argument("--res", type=int, default=100)
    ap.add_argument("--n_train", type=int, default=12)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--scene", default="spheres", choices=["blob", "spheres"])
    ap.add_argument("--occ_threshold", type=float, default=0.01,
                    help="0 disables occupancy culling")
    ap.add_argument("--lr", type=float, default=None,
                    help="None = method-dependent default")
    ap.add_argument("--lr-tables", type=float, default=None,
                    help="split lr for feature tables (None = same as --lr)")
    ap.add_argument("--tv", type=float, default=1e-4)
    # --- deviation-parity switches ---
    ap.add_argument("--init-range", default=None,
                    help="kplanes plane init, e.g. '0,1' (reference) or "
                         "'0.5,1.5' (ours, the default)")
    ap.add_argument("--occ-interp", default=None,
                    choices=[None, "nearest", "trilinear"],
                    help="occupancy query interp (reference: trilinear)")
    ap.add_argument("--decay-tables", action="store_true",
                    help="weight-decay feature tables too (reference does)")
    ap.add_argument("--no-fwd-clamp", action="store_true",
                    help="unclamped truncated_exp forward (reference)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--max-bucket", type=int, default=None,
                    help="cap the bucket ladder (sparse-view overfit knob)")
    ap.add_argument("--march", default="auto", choices=["auto", "dense", "skip"],
                    help="marching strategy A/B (quality effect of skip-march "
                         "ray truncation)")
    args = ap.parse_args()

    import numpy as np

    from tinynerf.utils.fixtures import make_synthetic_scene as _make_synthetic_scene

    from tinynerf.data import PoseSet, RayPool, parse_nerf_synthetic
    from tinynerf.train import TrainConfig, train
    import tinynerf.train.loop as loop_mod

    scene = Path(tempfile.mkdtemp()) / args.scene
    _make_synthetic_scene(
        scene, n_train=args.n_train, n_test=2, res=args.res, kind=args.scene
    )

    cfg = TrainConfig(
        method=args.method,
        scene_type=args.scene_type,
        output=Path(tempfile.mkdtemp()) / "exp",
        batch_size=args.batch_size,
        n_samples=args.n_samples,
        steps=args.steps,
        occupancy_res=64,
        occupancy_threshold=args.occ_threshold,
        occupancy_interp=args.occ_interp or "nearest",
        decay_tables=args.decay_tables,
        lr_init=args.lr,
        lr_tables=args.lr_tables,
        tv_reg_alpha=args.tv,
        seed=args.seed,
        compute_dtype=args.dtype,
        eval_every=args.eval_every,
        eval_n=args.eval_n if args.eval_every else None,
        march=args.march,
        max_bucket=args.max_bucket,
    )

    if args.no_fwd_clamp:
        cfg.fwd_clamp = False

    # optionally override field construction knobs via the registry
    if args.lookup or args.gather_dtype or args.init_range or args.fwd_mode:
        from tinynerf.models import registry

        orig = registry.make_model

        def patched(method, **mk_kw):
            field, sd, rd = orig(method, **mk_kw)
            kw = {}
            if args.lookup and hasattr(field, "lookup_mode"):
                kw["lookup_mode"] = args.lookup
            if args.gather_dtype and hasattr(field, "gather_dtype"):
                kw["gather_dtype"] = args.gather_dtype
            if args.fwd_mode and hasattr(field, "fwd_mode"):
                kw["fwd_mode"] = args.fwd_mode
            if args.init_range and hasattr(field, "init_range"):
                lo, hi = (float(v) for v in args.init_range.split(","))
                kw["init_range"] = (lo, hi)
            if kw:
                field = replace(field, **kw)
            return field, sd, rd

        registry.make_model = patched
        loop_mod.make_model = patched

    print(f"scene={scene} output={cfg.output}")
    train_rays = RayPool(parse_nerf_synthetic(scene, "train"))
    test_set = PoseSet(parse_nerf_synthetic(scene, "test"))
    out = train(
        cfg, train_rays, test_set=test_set,
        eval_set=test_set if args.eval_every else None,
    )

    psnrs = [m.psnr for m in out["test_metrics"]]
    ssims = [m.ssim for m in out["test_metrics"]]
    first_loss = out["train_metrics"][0].loss
    last_loss = out["train_metrics"][-1].loss
    dev = []
    if args.init_range:
        dev.append(f"init={args.init_range}")
    if args.occ_interp:
        dev.append(f"occ={args.occ_interp}")
    if args.decay_tables:
        dev.append("decay_tables")
    if args.no_fwd_clamp:
        dev.append("no_fwd_clamp")
    if args.lr is not None:
        dev.append(f"lr={args.lr}")
    if args.lr_tables is not None:
        dev.append(f"lr_tables={args.lr_tables}")
    print(
        f"RESULT scene={args.scene} method={args.method} lookup={args.lookup or 'default'} "
        f"gather={args.gather_dtype or 'default'} dtype={args.dtype} steps={args.steps} "
        f"deviations=[{','.join(dev) or 'none'}] "
        f"loss {first_loss:.4f}->{last_loss:.5f} "
        f"test PSNR {np.mean(psnrs):.2f} dB  SSIM {np.mean(ssims):.3f} "
        f"rays/s/chip {out['rays_per_sec_per_chip']:.0f}"
    )
    timeline = out.get("eval_timeline") or []
    for thr in (28.0, 30.0, 32.0):
        hit = next((e for e in timeline if e["psnr"] >= thr), None)
        if hit:
            print(
                f"TIME-TO-{thr:.0f}dB: {hit['elapsed_s']:.1f} s "
                f"(step {hit['step']}, psnr {hit['psnr']:.2f})"
            )
    if timeline:
        print("TIMELINE " + " ".join(
            f"{e['step']}:{e['elapsed_s']:.0f}s:{e['psnr']:.2f}" for e in timeline))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""End-to-end smoke run of the trainer and the packed renderer on one NVIDIA
GPU, through the CLI entry point (train.py) at full K-Planes width.

Phases, in order (any failure exits non-zero):
  device    JAX's backend must be "gpu"; prints the card's name and power
            limit (nvidia-smi).
  scene     a generated 3-sphere Blender-format scene, 16 train views of
            400x400 plus val/test views.
  train     `train.main` in this process: K-Planes, field_scale 1.0, 2048 rays
            x 400 samples, float32, 40 steps (two occupancy updates and
            skip-grid rebuilds); the loss must be finite and fall.
  serve     `train.main --render_only` on that checkpoint (packed renderer +
            dense fallback): finite PSNR; the packed frame must equal a dense
            render of the same frame.
  kernels   the packed transmittance op against the dense float32 reference
            (ops/weights.py) at 819,200 samples, forward and gradient, on
            three ragged problems per layout; one full training step, on
            three batches, against a float32 plain-lookup dense-render
            reference, and a bf16-decoder control that must fail those
            limits; the positional encoding's float32 products.
Then prints one JSON line: {"ok": true, "device": {...}}.

`--cards 4` runs only the multi-card phase instead: the 1-vs-4-device loss
equality checks of __graft_entry__.check_multichip on real cards.

Run: python chip_smoke.py [--cards 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke"

# packed-vs-dense frame: both renders run the same float32 field on the same
# samples, but the packed path's decoders see other matmul shapes (per-ray
# direction branch, `cap` rows), so TF32 rounds them differently
FRAME_MAX_ABS = 2e-2
FRAME_MIN_PSNR = 40.0
# one training step vs the float32 reference (f32 plain lookups at "highest"
# precision): the trainer gathers the planes in bf16 and runs the decoders in
# TF32.  On the H100 that reads loss rel <= 1.4e-5 and gradient rel L2
# <= 8.6e-4 over six batches; the same step with bf16 decoders reads
# 2.5e-4..2.6e-4 and 3.0e-3..4.8e-3 (PERF.md).  The limits sit between the two, and
# the smoke run checks that the bf16 control still fails one of them.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_REL_L2 = 2e-3
STEP_SEEDS = (0, 1, 2)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args, iters: int = 10) -> float:
    """Median wall time of `fn(*args)` in ms, after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# ------------------------------------------------------------------ phases


def phase_scene(root: Path, n_train: int = 16, n_test: int = 2, res: int = 400) -> Path:
    from tinynerf.utils import make_synthetic_scene

    scene = root / "scene"
    make_synthetic_scene(scene, n_train=n_train, n_test=n_test, res=res, kind="spheres")
    log(f"scene: {n_train} train + {n_test} test views of {res}x{res} at {scene}")
    return scene


def phase_train(scene: Path, out: Path, steps: int = 40, field_scale: float = 1.0,
                batch: int = 2048, n_samples: int = 400) -> Path:
    import train

    argv = [
        "--data", str(scene), "--datatype", "synthetic", "--output", str(out),
        "--method", "kplanes", "--batch_size", str(batch),
        "--n_samples", str(n_samples), "--dtype", "float32",
        "--steps", str(steps), "--field_scale", str(field_scale),
    ]
    t0 = time.perf_counter()
    train.main(argv)
    wall = time.perf_counter() - t0
    (exp,) = [p for p in out.iterdir() if p.is_dir()]
    losses = [m["loss"] for m in json.loads((exp / "metrics_train.json").read_text())]
    thr = json.loads((exp / "throughput.json").read_text())
    k = max(1, len(losses) // 8)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    log(f"train: {len(losses)} steps in {wall:.1f} s wall (compiles included); "
        f"loss {first:.5f} -> {last:.5f}; "
        f"{thr['rays_per_sec_per_chip']:.0f} trained rays/s over the run")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    return exp


def _trained_state(exp: Path, cfg, scene: Path):
    from tinynerf.data import PoseSet, parse_nerf_synthetic
    from tinynerf.train import build_renderer
    from tinynerf.train.checkpoint import latest_checkpoint, load_checkpoint

    test_set = PoseSet(parse_nerf_synthetic(scene, "test"))
    renderer = build_renderer(
        cfg, scene_scale=test_set.scene_scale, bg_color=np.asarray(test_set.bg_color)
    )
    _, state = load_checkpoint(latest_checkpoint(exp))
    return renderer, state, test_set


def phase_serve(scene: Path, exp: Path, cfg) -> None:
    import jax

    import train
    from tinynerf.train.loop import infer, make_render_chunk, make_render_chunk_packed

    metrics = train.main([
        "--data", str(scene), "--datatype", "synthetic", "--output", str(exp),
        "--method", cfg.method, "--batch_size", str(cfg.batch_size),
        "--n_samples", str(cfg.n_samples), "--dtype", cfg.compute_dtype,
        "--field_scale", str(cfg.field_scale), "--render_only",
    ])
    psnrs = [m.psnr for m in metrics]
    log(f"serve: --render_only psnr {psnrs}")
    if not np.all(np.isfinite(psnrs)):
        raise AssertionError(f"non-finite render PSNR: {psnrs}")

    renderer, state, test_set = _trained_state(exp, cfg, scene)
    params, occ = state["params"], state["occ_state"]
    dense_fn = make_render_chunk(renderer)
    can_skip = renderer.supports_skip_march
    packed_fn = make_render_chunk_packed(
        renderer, cfg.batch_size * cfg.eval_samples_per_ray,
        march="skip" if can_skip else "dense",
    )
    grid = (jax.jit(renderer.skip_grid)(occ),) if can_skip else ()
    kw = dict(chunk=cfg.batch_size, render_chunk_fn=dense_fn)
    folder = WORK / "frames"
    packed = infer(renderer, params, occ, test_set, [0], folder, "packed",
                   packed_fn=packed_fn, grid_args=grid, **kw)[0]
    dense = infer(renderer, params, occ, test_set, [0], folder, "dense", **kw)[0]
    diff = np.abs(packed - dense)
    psnr = -10.0 * np.log10(max(float(np.mean(diff**2)), 1e-20))
    log(f"serve: packed vs dense frame: max |d| {diff.max():.3e}, "
        f"mean |d| {diff.mean():.3e}, psnr {psnr:.1f} dB "
        f"(limits {FRAME_MAX_ABS}, {FRAME_MIN_PSNR} dB)")
    if not (diff.max() <= FRAME_MAX_ABS and psnr >= FRAME_MIN_PSNR):
        raise AssertionError("packed frame differs from the dense frame")


def packed_problem(seed: int, n_rays: int, max_len: int, cap: int, step: float):
    """Ragged runs of 0..max_len samples per ray, packed ray-major to `cap`;
    returns the dense [n_rays, max_len] twin holding exactly the packed
    samples (spilled samples are masked out of it)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_len + 1, n_rays).astype(np.int32)
    mask = np.arange(max_len)[None, :] < counts[:, None]
    sig = np.exp(rng.normal(2.0, 1.5, (n_rays, max_len))).astype(np.float32)
    dlt = (step * rng.uniform(0.5, 1.5, (n_rays, max_len))).astype(np.float32)
    idx = np.nonzero(mask.reshape(-1))[0][:cap]
    kept = np.zeros(mask.size, bool)
    kept[idx] = True
    sig_c = np.zeros(cap, np.float32)
    dlt_c = np.ones(cap, np.float32)
    sig_c[: idx.size] = sig.reshape(-1)[idx]
    dlt_c[: idx.size] = dlt.reshape(-1)[idx]
    g_c = rng.normal(size=cap).astype(np.float32)
    g_d = np.zeros(mask.size, np.float32)
    g_d[idx] = g_c[: idx.size]
    dense = (sig, dlt, kept.reshape(mask.shape).astype(np.float32), g_d.reshape(mask.shape))
    return dense, (sig_c, dlt_c, counts, g_c), idx


@functools.lru_cache(maxsize=None)
def packed_weights_fns(threshold: float):
    """Jitted (weights, d sum(w g)/d sigma) of the packed op and of the
    dense float32 reference."""
    import jax
    import jax.numpy as jnp

    from tinynerf.ops import compute_weights, compute_weights_packed

    @jax.jit
    def packed(s, d, c, g):
        f = lambda s: jnp.sum(compute_weights_packed(s, d, c, threshold) * g)
        return compute_weights_packed(s, d, c, threshold), jax.grad(f)(s)

    @jax.jit
    def dense(s, d, m, g):
        f = lambda s: jnp.sum(compute_weights(s, d, m, threshold) * g)
        return compute_weights(s, d, m, threshold), jax.grad(f)(s)

    return packed, dense


def check_packed_weights(seeds, n_rays, max_len, cap, step, threshold=1e-4):
    """Packed op vs the dense f32 reference, one ragged problem per seed:
    forward atol 1e-5; gradient |d| <= 1e-4 |ref| + 1e-6 max|ref| (the
    closed form subtracts two suffix sums, so entries near zero carry the
    larger terms' rounding).  Prints the largest |d|/limit ratios."""
    import jax.numpy as jnp

    packed, dense = packed_weights_fns(threshold)
    fwd_err, ratio, zero_err, ok = 0.0, 0.0, 0.0, True
    for seed in seeds:
        (sig, dlt, msk, g_d), (sig_c, dlt_c, counts, g_c), idx = packed_problem(
            seed, n_rays, max_len, cap, step
        )
        pa = tuple(map(jnp.asarray, (sig_c, dlt_c, counts, g_c)))
        da = tuple(map(jnp.asarray, (sig, dlt, msk, g_d)))
        w_p, gs_p = (np.asarray(a) for a in packed(*pa))
        w_d, gs_d = (np.asarray(a).reshape(-1)[idx] for a in dense(*da))
        n = idx.size
        fwd_err = max(fwd_err, float(np.abs(w_p[:n] - w_d).max()))
        d = np.abs(gs_p[:n] - gs_d)
        tol = 1e-4 * np.abs(gs_d) + 1e-6 * np.abs(gs_d).max()
        ratio = max(ratio, float(np.max(d / tol)))
        zero_err = max(zero_err, float(d[gs_d == 0.0].max(initial=0.0)))
        ok &= bool(np.all(gs_p[n:] == 0.0) and np.all(w_p[n:] == 0.0))
    t_packed = timed(packed, *pa)
    t_dense = timed(dense, *da)
    log(f"kernels: packed weights {n_rays} rays x 0..{max_len} -> cap {cap}, "
        f"seeds {list(seeds)}: fwd max|d| {fwd_err:.2e} (limit 1e-5); grad "
        f"max |d|/limit {ratio:.3f}, max |d| where the reference is 0: "
        f"{zero_err:.2e}; fwd+bwd {t_packed:.3f} ms packed vs {t_dense:.3f} ms "
        f"dense [{n_rays}, {max_len}]")
    if not fwd_err <= 1e-5:
        raise AssertionError(f"packed weights forward off by {fwd_err}")
    if not (ratio <= 1.0 and ok):
        raise AssertionError("packed weights gradient disagrees with the dense op")


def train_step_check(exp: Path, scene: Path, cfg):
    """One deterministic training step (packed path, bf16 gathers, decoders
    in `cfg.compute_dtype`) against a float32 reference of the same loss:
    plain lookups, dense marching and the dense weights op, at "highest"
    precision, on the same params and batch.  Returns `errors(seed)` ->
    (loss, reference loss, loss rel error, gradient rel L2 error) on a batch
    drawn with `seed`, `run(seed, pools)`, the step alone, and
    `pools(seed)`, that batch on the card."""
    import jax
    import jax.numpy as jnp

    from tinynerf.data import RayPool, parse_nerf_synthetic
    from tinynerf.parallel import make_mesh, shard_rays
    from tinynerf.train import make_optimizer, make_train_step

    renderer, state, _ = _trained_state(exp, cfg, scene)
    params, occ = state["params"], state["occ_state"]
    rays = [np.asarray(a) for a in RayPool(parse_nerf_synthetic(scene, "train")).arrays()]
    mesh = make_mesh(jax.devices()[:1])
    optimizer = make_optimizer(cfg)
    step = make_train_step(
        renderer, optimizer, cfg, mesh, n_cand=cfg.batch_size, deterministic=True
    )
    ref_field = dataclasses.replace(renderer.field, lookup_mode="plain")
    ref = dataclasses.replace(renderer, field=ref_field, compute_dtype=jnp.float32)

    def ref_loss(p, o, d, rgb):
        out = ref.render_dense(p, occ, o, d)
        data = jnp.mean((out.rgb - rgb) ** 2)
        return data + cfg.tv_reg_alpha * ref_field.loss_tv(p["field"])

    ref_fn = jax.jit(jax.value_and_grad(ref_loss))

    def batch(seed):
        pick = np.random.default_rng(seed).choice(rays[0].shape[0], cfg.batch_size,
                                                  replace=False)
        return [a[pick] for a in rays]

    def run(seed, pools):
        copy = lambda t: jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), t)
        return step(copy(params), optimizer.init(params), occ, *pools,
                    jax.random.PRNGKey(seed))[2]

    def errors(seed):
        o, d, rgb = batch(seed)
        m = run(seed, shard_rays(mesh, o, d, rgb))
        loss, grads = float(m["loss"]), m["grads"]
        with jax.default_matmul_precision("highest"):
            l_ref, g_ref = ref_fn(params, *map(jnp.asarray, (o, d, rgb)))
        l_ref = float(l_ref)
        pairs = zip(jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(g_ref))
        num = sum(float(jnp.sum((a - b) ** 2)) for a, b in pairs)
        den = sum(float(jnp.sum(b**2)) for b in jax.tree_util.tree_leaves(g_ref))
        return loss, l_ref, abs(loss - l_ref) / abs(l_ref), (num / den) ** 0.5

    return errors, run, lambda seed: shard_rays(mesh, *batch(seed))


def check_train_step(exp: Path, scene: Path, cfg, seeds=STEP_SEEDS) -> None:
    """`train_step_check` over `seeds`, held to STEP_LOSS_RTOL and
    STEP_GRAD_REL_L2."""
    errors, run, pools = train_step_check(exp, scene, cfg)
    loss_rel, grad_rel, finite = 0.0, 0.0, True
    for seed in seeds:
        loss, l_ref, lr, gr = errors(seed)
        log(f"kernels: train step seed {seed}: loss {loss:.6f} vs f32 reference "
            f"{l_ref:.6f} (rel {lr:.2e}); grad rel L2 {gr:.2e}")
        loss_rel, grad_rel = max(loss_rel, lr), max(grad_rel, gr)
        finite &= bool(np.isfinite(loss))
    batch = pools(seeds[0])
    ms = timed(lambda: run(seeds[0], batch)["loss"], iters=10)
    log(f"kernels: train step over seeds {list(seeds)}: max loss rel {loss_rel:.2e} "
        f"(limit {STEP_LOSS_RTOL}), max grad rel L2 {grad_rel:.2e} (limit "
        f"{STEP_GRAD_REL_L2}); bucket-1 step {ms:.2f} ms (incl. param copy)")
    if not (finite and loss_rel <= STEP_LOSS_RTOL):
        raise AssertionError("train-step loss disagrees with the f32 reference")
    if not grad_rel <= STEP_GRAD_REL_L2:
        raise AssertionError("train-step gradients disagree with the f32 reference")

    # control: the step with bf16 decoders must fail a limit, or the limits
    # are too loose to see a precision fault
    errors, _, _ = train_step_check(exp, scene, dataclasses.replace(cfg, compute_dtype="bfloat16"))
    _, _, lr, gr = errors(seeds[0])
    log(f"kernels: control, bf16 decoders, seed {seeds[0]}: loss rel {lr:.2e}, "
        f"grad rel L2 {gr:.2e} (must exceed a limit)")
    if lr <= STEP_LOSS_RTOL and gr <= STEP_GRAD_REL_L2:
        raise AssertionError("the bf16-decoder control passes the train-step limits")


def check_posenc(n: int = 1 << 16, n_freqs: int = 10) -> None:
    """positional_encoding's f32 products at Precision.HIGHEST: TF32 inputs
    (10-bit mantissa) would move the 2^9*pi band's phase by O(1)."""
    import jax
    import jax.numpy as jnp

    from tinynerf.models.encodings import positional_encoding

    x = np.random.default_rng(0).uniform(-1, 1, (n, 3)).astype(np.float32)
    got = np.asarray(jax.jit(positional_encoding, static_argnums=1)(jnp.asarray(x), n_freqs))
    freqs = (2.0 ** np.arange(n_freqs)) * np.pi
    xf = x.astype(np.float64)[..., None] * freqs.astype(np.float32).astype(np.float64)
    want = np.concatenate([np.sin(xf), np.cos(xf)], -1).reshape(n, -1)
    err = float(np.abs(got - want).max())
    log(f"kernels: positional encoding max |d| {err:.2e} vs float64 (limit 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("positional encoding lost float32 precision")


def phase_multicard(n_cards: int) -> None:
    import jax

    import __graft_entry__

    devices = jax.devices()
    if len(devices) < n_cards:
        raise RuntimeError(f"--cards {n_cards} but JAX sees {len(devices)} device(s)")
    # exact-equality checks: keep TF32 out of the comparison
    with jax.default_matmul_precision("highest"):
        log(__graft_entry__.check_multichip(devices[:n_cards]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4 = run only the multi-card loss-equality phase")
    args = ap.parse_args()

    import jax

    from tinynerf.train import TrainConfig
    from tinynerf.utils.runtime import card_line, enable_compile_cache, require_gpu

    require_gpu()
    log(f"device: {card_line()}")
    enable_compile_cache()
    t0 = time.perf_counter()

    if args.cards > 1:
        phase_multicard(args.cards)
    else:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir(parents=True)
        scene = phase_scene(WORK)
        exp = phase_train(scene, WORK / "runs")
        cfg = TrainConfig(method="kplanes", batch_size=2048, n_samples=400,
                          compute_dtype="float32", output=exp)
        phase_serve(scene, exp, cfg)
        # AABB [-1.5, 1.5]^3 marched in 400 steps: ~0.013 per step
        check_packed_weights((1, 2, 3), 2048, 400, 819_200, 0.013)
        check_packed_weights((4, 5, 6), 16_384, 100, 819_200, 0.013)
        check_train_step(exp, scene, cfg)
        check_posenc()

    log(f"total {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

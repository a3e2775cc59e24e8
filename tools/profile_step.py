#!/usr/bin/env python
"""Component-level timing of the train step at steady state.

Times each stage of the packed render path in isolation (with host syncs)
at a given candidate-ray bucket, using the same converged-shell occupancy
state as bench.py, so the numbers attribute the bench's steady-state step.

Usage: python tools/profile_step.py [--bucket 16] [--method kplanes]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from tinynerf.train import TrainConfig, build_renderer, make_optimizer
from tinynerf.utils import make_shell_occupancy


@jax.jit
def _scalar_of(x):
    return jnp.sum(x.astype(jnp.float32))


def _sync(out):
    """Force execution with a device-side sum + scalar fetch (4 bytes of
    device-to-host traffic, not the whole output)."""
    leaf = jax.tree_util.tree_leaves(out)[0]
    float(_scalar_of(leaf))


def timeit(name, fn, *args, n=10):
    out = fn(*args)  # compile
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    _sync(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:42s} {dt*1e3:9.2f} ms", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bucket", type=int, default=16)
    ap.add_argument("--method", default="kplanes")
    ap.add_argument("--march", default="dense", choices=["dense", "skip"])
    ap.add_argument("--n", type=int, default=10)
    args = ap.parse_args()

    cfg = TrainConfig(method=args.method, batch_size=2048, n_samples=400,
                      occupancy_res=128)
    R = args.bucket * cfg.batch_size
    S = cfg.n_samples
    CAP = cfg.sample_cap
    total = R * S
    print(f"bucket={args.bucket}  rays={R}  samples/ray={S}  cap={CAP}  "
          f"candidates={total}", flush=True)

    renderer = build_renderer(cfg, 1.0, np.ones(3, np.float32))
    optimizer = make_optimizer(cfg)
    key = jax.random.PRNGKey(0)
    params = renderer.init(key)
    opt_state = optimizer.init(params)
    occ_state = make_shell_occupancy(renderer, cfg.occupancy_res)

    rng = np.random.default_rng(0)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o = jnp.asarray(-4.0 * d)
    rays_d = jnp.asarray(d)
    rgbs = jnp.asarray(rng.uniform(size=(R, 3)).astype(np.float32))

    marcher = renderer.marcher
    contraction = renderer.contraction

    if args.march == "skip":
        from tinynerf.core.skipmarch import skip_march

        skip_grid = jax.jit(renderer.skip_grid)(occ_state)

        @jax.jit
        def stage_skipgrid(occ_state):
            return renderer.skip_grid(occ_state)

        timeit("skip-grid build (per occ update)", stage_skipgrid, occ_state,
               n=args.n)

        @jax.jit
        def stage_scan(rays_o, rays_d, skip_grid):
            t_min, t_exit = marcher.entry_exit(rays_o, rays_d)
            return skip_march(
                rays_o, rays_d, t_min, t_exit, marcher.step_size,
                cfg.n_samples, contraction, skip_grid,
                jax.random.PRNGKey(5), renderer.skip_steps,
            )

        k_idx, complete = timeit(
            f"skip-march scan (K={renderer.skip_steps})", stage_scan,
            rays_o, rays_d, skip_grid, n=args.n)
        print(f"   (emitted {int(jnp.sum(k_idx >= 0))} samples; "
              f"{float(jnp.mean(complete)):.4f} complete)", flush=True)

        @jax.jit
        def stage_skip_front(rays_o, rays_d, skip_grid):
            return renderer._march_skip(
                rays_o, rays_d, skip_grid, jax.random.PRNGKey(5)
            )

        cpos, deltas, maskf, complete = timeit(
            "skip front (scan + positions)", stage_skip_front,
            rays_o, rays_d, skip_grid, n=args.n)
        S_cand = renderer.skip_steps
        total_cand = R * S_cand

        @jax.jit
        def stage_compact_skip(cpos, maskf):
            iota = jax.lax.broadcasted_iota(jnp.int32, (total_cand,), 0)
            keys = jnp.where((maskf > 0).reshape(-1), iota, jnp.int32(total_cand))
            neg_vals, _ = jax.lax.top_k(-keys, min(CAP, total_cand))
            valid_idx = -neg_vals
            is_pad = valid_idx >= total_cand
            safe = jnp.where(is_pad, 0, valid_idx)
            return cpos.reshape(total_cand, 3)[safe], safe // S_cand, is_pad

        timeit("compaction (top_k over R*K)", stage_compact_skip, cpos, maskf,
               n=args.n)

        @jax.jit
        def full_grad_skip(params, occ_state, skip_grid, rays_o, rays_d):
            def loss(p):
                out = renderer.render_packed(
                    p, occ_state, rays_o, rays_d, CAP,
                    key=jax.random.PRNGKey(5), march="skip", skip_grid=skip_grid)
                per_ray = jnp.mean((out.rgb - rgbs) ** 2, axis=-1)
                return jnp.sum(per_ray * out.ray_valid) / jnp.maximum(
                    jnp.sum(out.ray_valid), 1.0)
            return jax.grad(loss)(params)

        timeit("render_packed(skip) fwd+bwd", full_grad_skip, params,
               occ_state, skip_grid, rays_o, rays_d, n=max(3, args.n // 2))

    # ---- stage: march (positions + contraction, no occupancy)
    @jax.jit
    def stage_march_only(rays_o, rays_d):
        t, deltas = marcher(rays_o, rays_d)
        pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        cpos, maskf = contraction(pos)
        return cpos, deltas, maskf

    cpos, deltas, maskin = timeit("march+contract (no occ)", stage_march_only,
                                  rays_o, rays_d, n=args.n)

    # ---- stage: occupancy query alone (R*S point queries)
    @jax.jit
    def stage_occ(occ_state, cpos, maskin):
        return maskin * renderer.occupancy.query(occ_state, cpos)

    maskf = timeit("occupancy query (R*S)", stage_occ, occ_state, cpos, maskin,
                   n=args.n)
    fill = float(jnp.sum(maskf)) / total
    print(f"   (valid fraction {fill:.4f} -> {fill*total:.0f} valid samples)",
          flush=True)

    # ---- stage: compaction (top_k, the shipped path)
    @jax.jit
    def stage_compact(cpos, maskf):
        iota = jax.lax.broadcasted_iota(jnp.int32, (total,), 0)
        keys = jnp.where((maskf > 0).reshape(-1), iota, jnp.int32(total))
        neg_vals, _ = jax.lax.top_k(-keys, min(CAP, total))
        valid_idx = -neg_vals
        is_pad = valid_idx >= total
        safe = jnp.where(is_pad, 0, valid_idx)
        return cpos.reshape(total, 3)[safe], safe // S, is_pad

    cpos_cap, seg, is_pad = timeit("compaction (top_k) + pos gather",
                                   stage_compact, cpos, maskf, n=args.n)

    # ---- stage: field fwd on CAP points
    @jax.jit
    def stage_field(params, x):
        return renderer.field.apply(params["field"], x, renderer.compute_dtype)

    feats = timeit("field fwd (CAP pts)", stage_field, params, cpos_cap,
                   n=args.n)

    # ---- stage: field fwd+bwd (isolates the table-gradient scatter)
    @jax.jit
    def stage_field_grad(params, x):
        def f(p):
            y = renderer.field.apply(p["field"], x, renderer.compute_dtype)
            return jnp.sum(y.astype(jnp.float32) ** 2)
        return jax.grad(f)(params)

    timeit("field fwd+bwd (CAP pts)", stage_field_grad, params, cpos_cap,
           n=max(3, args.n // 2))

    # ---- decoders
    @jax.jit
    def stage_sigma(params, feats):
        return renderer.sigma_decoder.apply(params["sigma"], feats,
                                            renderer.compute_dtype)

    sigma = timeit("sigma decoder fwd", stage_sigma, params, feats, n=args.n)

    dirs_cap = rays_d[jnp.where(is_pad, 0, seg)]

    @jax.jit
    def stage_rgb(params, feats, dirs):
        return renderer.rgb_decoder.apply(params["rgb"], feats, dirs,
                                          renderer.compute_dtype)

    timeit("rgb decoder fwd", stage_rgb, params, feats, dirs_cap, n=args.n)

    @jax.jit
    def stage_decoders_grad(params, feats, dirs):
        def f(p):
            s = renderer.sigma_decoder.apply(p["sigma"], feats,
                                             renderer.compute_dtype)
            c = renderer.rgb_decoder.apply(p["rgb"], feats, dirs,
                                           renderer.compute_dtype)
            return jnp.sum(s) + jnp.sum(c)
        return jax.grad(f)(params)

    timeit("decoders fwd+bwd", stage_decoders_grad, params, feats, dirs_cap,
           n=max(3, args.n // 2))

    # ---- packed weights
    @jax.jit
    def stage_weights(sigma, deltas, seg, is_pad):
        from tinynerf.ops import compute_weights_packed
        delta_cap = deltas.reshape(-1)[jnp.where(is_pad, 0, seg * S)]
        counts = jax.ops.segment_sum(
            (~is_pad).astype(jnp.int32), seg, num_segments=deltas.shape[0]
        )
        return compute_weights_packed(
            sigma.astype(jnp.float32), delta_cap, counts, 1e-4)

    timeit("packed weights fwd", stage_weights, sigma,
           deltas, seg, is_pad, n=args.n)

    # ---- optimizer update (on zero grads; cost is the Adam math + tree ops)
    zero_grads = jax.tree_util.tree_map(jnp.zeros_like, params)

    @jax.jit
    def stage_opt(params, opt_state, grads):
        import optax
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    timeit("optimizer update", stage_opt, params, opt_state, zero_grads,
           n=args.n)

    # ---- TV reg grad
    if args.method == "kplanes":
        @jax.jit
        def reg_grad(params):
            return jax.grad(lambda p: renderer.field.loss_tv(p["field"]))(params)

        timeit("TV reg grad", reg_grad, params, n=max(3, args.n // 2))

    # ---- full fwd / fwd+bwd / full train step
    @jax.jit
    def full_fwd(params, occ_state, rays_o, rays_d):
        return renderer.render_packed(params, occ_state, rays_o, rays_d, CAP).rgb

    timeit("render_packed fwd", full_fwd, params, occ_state, rays_o, rays_d,
           n=max(3, args.n // 2))

    @jax.jit
    def full_grad(params, occ_state, rays_o, rays_d):
        def loss(p):
            out = renderer.render_packed(p, occ_state, rays_o, rays_d, CAP)
            per_ray = jnp.mean((out.rgb - rgbs) ** 2, axis=-1)
            return jnp.sum(per_ray * out.ray_valid) / jnp.maximum(
                jnp.sum(out.ray_valid), 1.0)
        return jax.grad(loss)(params)

    timeit("render_packed fwd+bwd", full_grad, params, occ_state, rays_o,
           rays_d, n=max(3, args.n // 2))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""A/B the shared sigma/rgb decoder stage at the flagship sample budget.

The decoders' matmul FLOPs are small; their cost is device-memory traffic:
the f32 [cap, 96] feature tensor read twice, per-layer activations stored
for the backward, and the f32 feature cotangent written back.  Variants
measured here:

  shipped       — f32 feats in, bf16 matmuls, plain autodiff
  bf16_feats    — feats handed to the decoders already in bf16 (halves the
                  feature read; the table-grad payload quantizes the
                  cotangent to bf16 anyway, so f32 inbound adds no precision
                  downstream)
  remat         — jax.checkpoint around each decoder apply: the backward
                  re-runs the tiny forward instead of loading stored
                  activations (trades matmul work for ~1 GB of traffic)
  bf16+remat    — both

Each variant times grad(loss) wrt (params, feats) — the training contract:
cotangents must flow back to the field.  Also prints the component split
(sigma-only, rgb-only, posenc-only) for attribution.

Run: python tools/probe_decoders.py [--cap 819200]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from tinynerf.models import make_model
    from tinynerf.models.encodings import positional_encoding

    ap = argparse.ArgumentParser()
    ap.add_argument("--cap", type=int, default=819200)
    ap.add_argument("--n", type=int, default=10)
    args = ap.parse_args()

    @jax.jit
    def _scalar_of(x):
        return jnp.sum(x.astype(jnp.float32))

    def _sync(out):
        leaf = jax.tree_util.tree_leaves(out)[0]
        float(_scalar_of(leaf))

    def timeit(name, fn, *a, n=args.n):
        out = fn(*a)
        _sync(out)
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*a)
        _sync(out)
        print(f"{name:40s} {(time.perf_counter() - t0) / n * 1e3:9.2f} ms",
              flush=True)
        return out

    print(f"devices: {jax.devices()}  cap={args.cap}", flush=True)
    _, sigma_dec, rgb_dec = make_model("kplanes")
    key = jax.random.PRNGKey(0)
    params = {
        "sigma": sigma_dec.init(key),
        "rgb": rgb_dec.init(jax.random.PRNGKey(1)),
    }
    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.normal(size=(args.cap, 96)).astype(np.float32))
    dirs = rng.normal(size=(args.cap, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = jnp.asarray(dirs)
    bf16 = jnp.bfloat16

    def decode(p, f, d, sig_fn, rgb_fn):
        sigma = sig_fn(p["sigma"], f)
        rgb = rgb_fn(p["rgb"], f, d)
        return jnp.sum(sigma.astype(jnp.float32)) + jnp.sum(
            rgb.astype(jnp.float32)
        )

    def sig_plain(p, f):
        return sigma_dec.apply(p, f, bf16)

    def rgb_plain(p, f, d):
        return rgb_dec.apply(p, f, d, bf16)

    variants = {
        "shipped (f32 feats)": (feats, sig_plain, rgb_plain),
        "bf16 feats": (feats.astype(bf16), sig_plain, rgb_plain),
        "remat": (feats, jax.checkpoint(sig_plain), jax.checkpoint(rgb_plain)),
        "bf16 + remat": (
            feats.astype(bf16),
            jax.checkpoint(sig_plain),
            jax.checkpoint(rgb_plain),
        ),
    }
    for name, (f, sf, rf) in variants.items():
        g = jax.jit(
            jax.grad(lambda p, ff: decode(p, ff, dirs, sf, rf), argnums=(0, 1))
        )
        timeit(f"decoders fwd+bwd [{name}]", g, params, f)

    # component attribution (shipped config)
    g_sig = jax.jit(jax.grad(
        lambda p, f: jnp.sum(sig_plain(p["sigma"], f).astype(jnp.float32)),
        argnums=(0, 1),
    ))
    timeit("sigma only fwd+bwd", g_sig, params, feats)
    g_rgb = jax.jit(jax.grad(
        lambda p, f: jnp.sum(
            rgb_plain(p["rgb"], f, dirs).astype(jnp.float32)
        ),
        argnums=(0, 1),
    ))
    timeit("rgb only fwd+bwd", g_rgb, params, feats)
    pe = jax.jit(lambda d: positional_encoding(d, 8))
    timeit("posenc(dirs, 8) fwd", pe, dirs)

    # numeric drift of the bf16-feed variant vs shipped (params grads)
    g_ref, _ = jax.jit(jax.grad(
        lambda p, f: decode(p, f, dirs, sig_plain, rgb_plain), argnums=(0, 1)
    ))(params, feats)
    g_b16, _ = jax.jit(jax.grad(
        lambda p, f: decode(p, f, dirs, sig_plain, rgb_plain), argnums=(0, 1)
    ))(params, feats.astype(bf16))
    rel = [
        float(jnp.max(jnp.abs(a - b)) / (jnp.max(jnp.abs(a)) + 1e-30))
        for a, b in zip(
            jax.tree_util.tree_leaves(g_ref), jax.tree_util.tree_leaves(g_b16)
        )
    ]
    print(f"bf16-feed max rel param-grad drift: {max(rel):.3e}", flush=True)


if __name__ == "__main__":
    main()

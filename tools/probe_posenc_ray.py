#!/usr/bin/env python
"""A/B: rgb-decoder direction branch — per-SAMPLE posenc (ship) vs per-RAY
posenc + row gather, at the flagship packed budget.

Motivation (round-5 decoder audit, tools/probe_decoders.py): the rgb decoder
is 10.1 ms fwd+bwd of which posenc(dirs, deg=8) alone is 5.2 ms at cap rows
— and directions are CONSTANT per ray (49,152 rays vs 819,200 samples, so
16.7x fewer distinct rows).  The counter-argument from the measured gather
model (CLAUDE.md): row gathers carry a ~6 ns/row latency floor, so gathering
ANY per-ray row to cap samples costs >= ~4.9 ms — the same as computing the
encoding.  This probe prices both, plus the variant that gathers the whole
first-layer direction contribution (hidden-wide rows).

Run: python tools/probe_posenc_ray.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from tinynerf.models.encodings import positional_encoding, posenc_dim
    from tinynerf.models.kplanes import KPlanesExplicitColorDecoder
    from tinynerf.models.mlp import mlp_apply_split

    def timeit(f, *args, iters=10):
        out = f(*args)
        float(jnp.sum(jax.tree_util.tree_leaves(out)[0].astype(jnp.float32)))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(*args)
        float(jnp.sum(jax.tree_util.tree_leaves(out)[0].astype(jnp.float32)))
        return (time.perf_counter() - t0) / iters * 1e3

    rng = np.random.default_rng(0)
    n_rays, cap, fdim, n_freqs = 49_152, 819_200, 32, 8
    cdt = jnp.bfloat16
    print(f"devices: {jax.devices()}  rays={n_rays} cap={cap}", flush=True)

    dec = KPlanesExplicitColorDecoder(feature_dim=fdim, n_freqs=n_freqs)
    params = dec.init(jax.random.PRNGKey(0))
    feats = jnp.asarray(rng.normal(size=(cap, fdim)).astype(np.float32))
    d_ray = jnp.asarray(rng.normal(size=(n_rays, 3)).astype(np.float32))
    d_ray = d_ray / jnp.linalg.norm(d_ray, axis=-1, keepdims=True)
    # packed layout: samples sorted by ray (contiguous segments)
    seg = jnp.sort(
        jnp.asarray(rng.integers(0, n_rays, size=(cap,)).astype(np.int32))
    )

    # --- ship: gather 3-wide dirs, posenc at cap rows ------------------
    @jax.jit
    def ship(params, feats, d_ray, seg):
        dirs = d_ray[seg]
        return dec.apply(params, feats, dirs, cdt)

    ms = timeit(ship, params, feats, d_ray, seg)
    print(f"ship fwd (posenc at cap rows):            {ms:7.2f} ms", flush=True)

    lossf = lambda f: lambda p, x, d, s: jnp.sum(f(p, x, d, s))
    g_ship = jax.jit(jax.grad(lossf(ship)))
    ms = timeit(g_ship, params, feats, d_ray, seg)
    print(f"ship fwd+bwd:                             {ms:7.2f} ms", flush=True)

    # --- variant A: per-ray posenc, bf16 row gather to cap -------------
    @jax.jit
    def per_ray_pe(params, feats, d_ray, seg):
        pe_ray = positional_encoding(d_ray, n_freqs).astype(cdt)
        pieces = (pe_ray[seg], d_ray[seg].astype(cdt), feats.astype(cdt))
        basis = mlp_apply_split(params["mlp"], pieces, cdt)
        b3 = basis.astype(jnp.float32).reshape(*basis.shape[:-1], 3, fdim)
        return jax.nn.sigmoid(jnp.einsum("...f,...cf->...c", feats, b3))

    ms = timeit(per_ray_pe, params, feats, d_ray, seg)
    print(f"A: per-ray posenc + bf16 gather, fwd:     {ms:7.2f} ms", flush=True)
    g_a = jax.jit(jax.grad(lossf(per_ray_pe)))
    ms = timeit(g_a, params, feats, d_ray, seg)
    print(f"A: fwd+bwd:                               {ms:7.2f} ms", flush=True)

    # --- variant B: whole first-layer dir contribution per ray ---------
    @jax.jit
    def per_ray_h1(params, feats, d_ray, seg):
        first = params["mlp"][0]
        pe_ray = positional_encoding(d_ray, n_freqs)
        pdim = posenc_dim(3, n_freqs)
        w_pe = first["w"][:pdim].astype(cdt)
        w_d = first["w"][pdim : pdim + 3].astype(cdt)
        h_ray = (
            jnp.dot(pe_ray.astype(cdt), w_pe, preferred_element_type=jnp.float32)
            + jnp.dot(d_ray.astype(cdt), w_d, preferred_element_type=jnp.float32)
        ).astype(cdt)
        w_f = first["w"][pdim + 3 :].astype(cdt)
        h = (
            h_ray[seg].astype(jnp.float32)
            + jnp.dot(feats.astype(cdt), w_f, preferred_element_type=jnp.float32)
            + first["b"].astype(jnp.float32)
        ).astype(cdt)
        x = jax.nn.relu(h)
        from tinynerf.models.mlp import linear_apply

        for layer in params["mlp"][1:-1]:
            x = jax.nn.relu(linear_apply(layer, x, cdt))
        basis = linear_apply(params["mlp"][-1], x, cdt)
        b3 = basis.astype(jnp.float32).reshape(*basis.shape[:-1], 3, fdim)
        return jax.nn.sigmoid(jnp.einsum("...f,...cf->...c", feats, b3))

    ms = timeit(per_ray_h1, params, feats, d_ray, seg)
    print(f"B: per-ray first-layer + gather, fwd:     {ms:7.2f} ms", flush=True)
    g_b = jax.jit(jax.grad(lossf(per_ray_h1)))
    ms = timeit(g_b, params, feats, d_ray, seg)
    print(f"B: fwd+bwd:                               {ms:7.2f} ms", flush=True)

    # --- bare gather floors for the record ------------------------------
    pe_ray = positional_encoding(d_ray, n_freqs)
    for name, arr in (
        ("posenc rows bf16 [51L]", pe_ray.astype(jnp.bfloat16)),
        ("posenc rows f32  [51L]", pe_ray),
        ("hidden rows bf16 [128L]", jnp.zeros((n_rays, 128), jnp.bfloat16)),
    ):
        gf = jax.jit(lambda a, s: jnp.take(a, s, axis=0))
        ms = timeit(gf, arr, seg)
        print(f"bare gather {name}:   {ms:7.2f} ms", flush=True)

    # numeric check: A vs ship (bf16 gather of the encoding is the only delta)
    ra = per_ray_pe(params, feats, d_ray, seg)
    rs = ship(params, feats, d_ray, seg)
    print(f"A-vs-ship max abs err: {float(jnp.max(jnp.abs(ra - rs))):.3e}",
          flush=True)


if __name__ == "__main__":
    main()

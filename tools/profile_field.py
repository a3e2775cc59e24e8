#!/usr/bin/env python
"""Fine-grained timing of the field fwd/bwd pieces at the flagship budget.

profile_step.py attributes the train step to stages; this tool splits the
dominant stage — the field fwd+bwd — into its constituent ops.

Usage: python tools/profile_field.py [--method kplanes|cobafa] [--cap 819200]
"""

import argparse
import sys
import time
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _scalar_of(x):
    return jnp.sum(x.astype(jnp.float32))


def _sync(out):
    leaf = jax.tree_util.tree_leaves(out)[0]
    float(_scalar_of(leaf))


def timeit(name, fn, *args, n=10):
    out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    _sync(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:46s} {dt*1e3:9.2f} ms", flush=True)
    return out


def profile_kplanes(cap: int, n: int):
    from tinynerf.models.kplanes import DIMENSION_PAIRS, KPlanesFeatureField
    from tinynerf.ops import interp as I

    field = KPlanesFeatureField()
    params = field.init(jax.random.PRNGKey(0))
    gd = jnp.float8_e4m3fn
    r_fine = max(field.resolutions)
    f_tot = field.feature_dim
    n_cells = (r_fine - 1) * (r_fine - 1)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-1, 1, size=(cap, 3)).astype(np.float32))
    g = jnp.asarray(rng.normal(size=(cap, f_tot)).astype(np.float32))

    tables_by_proj = tuple(
        tuple(params["planes"][s][p] for s in range(len(field.resolutions)))
        for p in range(len(DIMENSION_PAIRS))
    )
    coords_by_proj = tuple(x[..., jnp.array((i, j))] for (i, j) in DIMENSION_PAIRS)

    print(f"kplanes: cap={cap} f_tot={f_tot} r_fine={r_fine}", flush=True)

    # ---- forward pieces
    @jax.jit
    def fused_build(ts):
        # the build part of _multiscale_value's "fusedfine" path
        outs = []
        for tables in ts:
            cast = tuple(t.astype(gd).astype(jnp.bfloat16) for t in tables)
            fine = jnp.concatenate(
                [I.upsample_to(t, r_fine, r_fine) for t in cast], axis=-1
            )
            outs.append(I._build_quad(fine, gd))
        return tuple(outs)

    timeit("fwd: fused quad build (x3 proj)", fused_build, tables_by_proj, n=n)

    @jax.jit
    def fwd_value(ts, cs):
        return tuple(
            I._multiscale_value(t, c, gd, "fusedfine") for t, c in zip(ts, cs)
        )

    timeit("fwd: full value (build+gather, x3)", fwd_value, tables_by_proj,
           coords_by_proj, n=n)

    # ---- backward pieces
    cells, ws = [], []
    for c in coords_by_proj:
        cell, w = I._cell_2d(c, r_fine, r_fine)
        cells.append(cell.reshape(-1))
        ws.append(w.reshape(-1, 4))

    timeit("bwd: _cell_2d x3 (recompute)",
           jax.jit(lambda cs: tuple(I._cell_2d(c, r_fine, r_fine)
                                    for c in cs)),
           coords_by_proj, n=n)

    @jax.jit
    def contrib_build(w, g):
        return (w[:, :, None] * g[:, None, :]).reshape(-1, 4 * f_tot)

    contrib = timeit("bwd: contrib build (w x g, 1 proj)", contrib_build,
                     ws[0], g, n=n)

    timeit("bwd: scatter_add_rows alone (1 proj)",
           jax.jit(partial(I.scatter_add_rows, n_cells)),
           cells[0], contrib, n=n)

    @jax.jit
    def contrib_and_scatter(w, g, cell):
        contrib = (w[:, :, None] * g[:, None, :]).reshape(-1, 4 * f_tot)
        return I.scatter_add_rows(n_cells, cell, contrib)

    gq = timeit("bwd: contrib+scatter fused (1 proj)", contrib_and_scatter,
                ws[0], g, cells[0], n=n)

    timeit("bwd: _fine_from_quad (1 proj)",
           jax.jit(partial(I._fine_from_quad, r_fine=r_fine, f_tot=f_tot)),
           gq, n=n)

    fine = I._fine_from_quad(gq, r_fine, f_tot)
    timeit("bwd: _pullback_scales (1 proj)",
           jax.jit(lambda f: I._pullback_scales(f, tables_by_proj[0])),
           fine, n=n)

    gs = tuple(g for _ in range(3))
    timeit("bwd: full _multiproj_bwd (3 proj)",
           jax.jit(lambda res, gs: I._multiproj_bwd(
               gd, "scatter", "fusedfine", res, gs)),
           (tables_by_proj, coords_by_proj), gs, n=max(3, n // 2))

    # ---- whole custom-VJP field fwd+bwd vs apply fwd+bwd (product overhead)
    @jax.jit
    def field_grad(params, x):
        def f(p):
            y = field.apply(p, x, jnp.bfloat16)
            return jnp.sum(y.astype(jnp.float32) ** 2)
        return jax.grad(f)(params)

    timeit("field.apply fwd+bwd (incl product rule)", field_grad, params, x,
           n=max(3, n // 2))


def profile_cobafa(cap: int, n: int):
    from tinynerf.models.cobafa import CobafaFeatureField
    from tinynerf.ops import interp as I
    from tinynerf.ops.interp import sawtooth

    field = CobafaFeatureField()
    params = field.init(jax.random.PRNGKey(0))
    gd = jnp.bfloat16

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-1, 1, size=(cap, 3)).astype(np.float32))

    print(f"cobafa: cap={cap} basis_res={field.basis_res} "
          f"channels={field.channels} coef_res={field.coef_res}", flush=True)

    grids = [("coef", params["coef"])] + [
        (f"basis{i}(r={g.shape[0]},c={g.shape[-1]})", g)
        for i, g in enumerate(params["basis"])
    ]

    def build_oct_stack(table, gather_dtype):
        # the pre-round-3 stack+reshape formulation, kept for A/B
        t = table.astype(gather_dtype)
        q = jnp.stack(
            [t[:-1, :-1, :-1], t[:-1, :-1, 1:], t[:-1, 1:, :-1],
             t[:-1, 1:, 1:], t[1:, :-1, :-1], t[1:, :-1, 1:],
             t[1:, 1:, :-1], t[1:, 1:, 1:]], axis=3)
        r0, r1, r2, f = table.shape
        return q.reshape((r0 - 1) * (r1 - 1) * (r2 - 1), 8 * f)

    for name, grid in grids:
        timeit(f"oct build: {name}",
               jax.jit(partial(I._build_oct, gather_dtype=gd)), grid, n=n)
    timeit("oct build (stack A/B): basis5",
           jax.jit(partial(build_oct_stack, gather_dtype=gd)),
           params["basis"][-1], n=n)

    @jax.jit
    def all_builds(params):
        outs = [I._build_oct(params["coef"], gd)]
        for gr in params["basis"]:
            outs.append(I._build_oct(gr, gd))
        return tuple(outs)

    octs = timeit("oct build: ALL grids", all_builds, params, n=n)

    @jax.jit
    def all_gathers(octs, x):
        outs = []
        for name_grid, oct_t in zip(grids, octs):
            grid = name_grid[1]
            r0, r1, r2, f = grid.shape
            cell, w = I._cell_3d(x, r0, r1, r2)
            rows = jnp.take(oct_t, cell, axis=0).astype(jnp.float32)
            vals = rows.reshape(*cell.shape, 8, f)
            outs.append(jnp.sum(vals * w[..., None], axis=-2))
        return tuple(outs)

    timeit("gathers: ALL grids (same coords)", all_gathers, octs, x, n=n)

    # bwd: scatter + oct->grid reduction per grid
    @jax.jit
    def all_bwd(params, x):
        outs = []
        for key_grid in [params["coef"]] + list(params["basis"]):
            r0, r1, r2, f = key_grid.shape
            g = jnp.ones((cap, f), jnp.float32)
            cell, w = I._cell_3d(x, r0, r1, r2)
            contrib = (g[:, None, :] * w[..., :, None]).reshape(-1, 8 * f)
            gq = I.scatter_add_rows(
                (r0 - 1) * (r1 - 1) * (r2 - 1), cell.reshape(-1), contrib
            ).reshape(r0 - 1, r1 - 1, r2 - 1, 8 * f)
            grad = jnp.zeros((r0, r1, r2, f), jnp.float32)
            c = 0
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        sl = gq[..., c * f:(c + 1) * f]
                        grad = grad + jnp.pad(
                            sl, [(dx, 1 - dx), (dy, 1 - dy), (dz, 1 - dz),
                                 (0, 0)])
                        c += 1
            outs.append(grad)
        return tuple(outs)

    timeit("bwd: scatter+reduce ALL grids", all_bwd, params, x,
           n=max(3, n // 2))

    # whole field
    @jax.jit
    def field_grad(params, x):
        def f(p):
            y = field.apply(p, x, jnp.bfloat16,
                            dropout_key=jax.random.PRNGKey(1))
            return jnp.sum(y.astype(jnp.float32) ** 2)
        return jax.grad(f)(params)

    timeit("field.apply fwd+bwd", field_grad, params, x, n=max(3, n // 2))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="kplanes",
                    choices=["kplanes", "cobafa"])
    ap.add_argument("--cap", type=int, default=819200)
    ap.add_argument("--n", type=int, default=10)
    args = ap.parse_args()
    if args.method == "kplanes":
        profile_kplanes(args.cap, args.n)
    else:
        profile_cobafa(args.cap, args.n)


if __name__ == "__main__":
    main()

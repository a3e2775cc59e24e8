"""Bilinear / trilinear table lookups — the `grid_sample` equivalents.

The reference leans on torch's grid_sample for K-Planes planes
(src/models.py:108), Cobafa grids (src/models.py:232) and the occupancy grid
query (src/core.py:151), all with align_corners=True.  The layout keeps each
corner fetch one contiguous row:

  * tables are stored FEATURE-LAST (`[r0, r1, F]` / `[r0, r1, r2, F]`) and
    flattened so each corner fetch is ONE row gather of F contiguous floats,
    not F strided scalar gathers;
  * corner indices are clamped to the table edge (coords from the scene
    contractions are already in [-1, 1]; out-of-box samples are masked
    upstream, so clamp vs zero-pad is semantically invisible).

Coordinates are in [-1, 1] with align_corners=True semantics:
coord -1 maps to index 0, coord +1 maps to index (res - 1).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _to_index_space(c, res):
    """[-1,1] -> continuous index in [0, res-1], clamped to the table."""
    x = (c + 1.0) * 0.5 * (res - 1)
    return jnp.clip(x, 0.0, res - 1)


# Cell-pack build formulation: "stack" (slice-stack-reshape, the same form
# as build_oct_ref / build_quad_ref) or "pad" (interior-pad dilation).  Both
# are bit-identical to the references (tests/test_octbuild.py).
_OCT_BUILD_MODE = "stack"  # "stack" | "pad"
_QUAD_BUILD_MODE = "stack"  # same values

# Force materialization of built cell-packed tables before the consuming
# gather, so XLA cannot fold the build's final reshape into the gather's
# index computation.
_TABLE_BARRIER = True

# corner order: last axis fastest — must match `_cell_3d` / `_cell_2d`
# weight order
CORNERS_3D = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))
CORNERS_2D = tuple((dx, dy) for dx in (0, 1) for dy in (0, 1))


def build_oct_ref(table: jax.Array, out_dtype=jnp.bfloat16) -> jax.Array:
    """[r0, r1, r2, F] -> [(r0-1)(r1-1)(r2-1), 8F] (semantic reference)."""
    t = table.astype(out_dtype)
    r0, r1, r2, f = table.shape
    parts = [
        t[dx : dx + r0 - 1, dy : dy + r1 - 1, dz : dz + r2 - 1, :]
        for (dx, dy, dz) in CORNERS_3D
    ]
    q = jnp.stack(parts, axis=-2)  # [r0-1, r1-1, r2-1, 8, F]
    return q.reshape((r0 - 1) * (r1 - 1) * (r2 - 1), 8 * f)


def build_quad_ref(table: jax.Array, out_dtype=jnp.bfloat16) -> jax.Array:
    """[r0, r1, F] -> [(r0-1)(r1-1), 4F] (semantic reference)."""
    t = table.astype(out_dtype)
    r0, r1, f = table.shape
    parts = [
        t[dx : dx + r0 - 1, dy : dy + r1 - 1, :] for (dx, dy) in CORNERS_2D
    ]
    q = jnp.stack(parts, axis=-2)
    return q.reshape((r0 - 1) * (r1 - 1), 4 * f)


def _materialize(table):
    if _TABLE_BARRIER:
        return jax.lax.optimization_barrier(table)
    return table


def scatter_add_rows(n_rows: int, idx, contrib, out_dtype=jnp.float32):
    """Row scatter-add `zeros([n_rows, w]).at[idx].add(contrib)`.

    idx: [n] int32 row ids; contrib: [n, w]."""
    w = contrib.shape[-1]
    return jnp.zeros((n_rows, w), out_dtype).at[idx].add(contrib.astype(out_dtype))


def _corners_2d(coords, r0, r1):
    """Corner flat indices + lerp weights for bilinear interpolation.

    Returns (idx [...,4] int32, w [...,4] f32) over corners
    (00, 01, 10, 11)."""
    x = _to_index_space(coords[..., 0], r0)
    y = _to_index_space(coords[..., 1], r1)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, r0 - 1)
    y1 = jnp.minimum(y0 + 1, r1 - 1)
    tx = x - x0
    ty = y - y0
    idx = jnp.stack(
        [x0 * r1 + y0, x0 * r1 + y1, x1 * r1 + y0, x1 * r1 + y1], axis=-1
    )
    w = jnp.stack(
        [(1 - tx) * (1 - ty), (1 - tx) * ty, tx * (1 - ty), tx * ty], axis=-1
    )
    return idx, w


def _corners_3d(coords, r0, r1, r2):
    """Corner flat indices + lerp weights for trilinear interpolation ([...,8])."""
    x = _to_index_space(coords[..., 0], r0)
    y = _to_index_space(coords[..., 1], r1)
    z = _to_index_space(coords[..., 2], r2)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    z0 = jnp.floor(z).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, r0 - 1)
    y1 = jnp.minimum(y0 + 1, r1 - 1)
    z1 = jnp.minimum(z0 + 1, r2 - 1)
    tx, ty, tz = x - x0, y - y0, z - z0

    def flat(a, b, c):
        return (a * r1 + b) * r2 + c

    idx = jnp.stack(
        [
            flat(x0, y0, z0), flat(x0, y0, z1), flat(x0, y1, z0), flat(x0, y1, z1),
            flat(x1, y0, z0), flat(x1, y0, z1), flat(x1, y1, z0), flat(x1, y1, z1),
        ],
        axis=-1,
    )
    wx0, wx1 = 1 - tx, tx
    wy0, wy1 = 1 - ty, ty
    wz0, wz1 = 1 - tz, tz
    w = jnp.stack(
        [
            wx0 * wy0 * wz0, wx0 * wy0 * wz1, wx0 * wy1 * wz0, wx0 * wy1 * wz1,
            wx1 * wy0 * wz0, wx1 * wy0 * wz1, wx1 * wy1 * wz0, wx1 * wy1 * wz1,
        ],
        axis=-1,
    )
    return idx, w


def _weighted_gather(flat_table, idx, w, gather_dtype=None):
    """Gather corner rows and reduce with lerp weights.

    flat_table [M, F], idx [..., C], w [..., C] -> [..., F] float32.
    `gather_dtype` optionally down-casts the table before the gather (bf16
    tables halve the gathered bytes).
    """
    t = flat_table if gather_dtype is None else flat_table.astype(gather_dtype)
    vals = jnp.take(t, idx, axis=0).astype(jnp.float32)  # [..., C, F]
    return jnp.sum(vals * w[..., None], axis=-2)


def bilinear_lookup(table: jax.Array, coords: jax.Array) -> jax.Array:
    """table: [r0, r1, F]; coords: [..., 2] in [-1,1] -> [..., F].
    Plain autodiff version (f32 gathers, exact scatter-add backward)."""
    r0, r1, f = table.shape
    idx, w = _corners_2d(coords, r0, r1)
    return _weighted_gather(table.reshape(r0 * r1, f), idx, w)


def trilinear_lookup(table: jax.Array, coords: jax.Array) -> jax.Array:
    """table: [r0, r1, r2, F]; coords: [..., 3] in [-1,1] -> [..., F]."""
    r0, r1, r2, f = table.shape
    idx, w = _corners_3d(coords, r0, r1, r2)
    return _weighted_gather(table.reshape(r0 * r1 * r2, f), idx, w)


# --------------------------------------------------------------------------
# Mixed-precision lookups: bf16 forward gathers (half the gathered bytes)
# with an exact f32 scatter-add
# backward via custom VJP.  NOTE: the coordinate cotangent is ZERO — valid
# here because sample coordinates come from (no-grad) ray marching; do not
# use these where gradients must flow into coords.
# --------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def bilinear_lookup_mixed(
    table, coords, gather_dtype=jnp.bfloat16, scatter_dtype=jnp.float32
):
    r0, r1, f = table.shape
    idx, w = _corners_2d(coords, r0, r1)
    return _weighted_gather(table.reshape(r0 * r1, f), idx, w, gather_dtype)


def _bilinear_mixed_fwd(table, coords, gather_dtype, scatter_dtype):
    return (
        bilinear_lookup_mixed(table, coords, gather_dtype, scatter_dtype),
        (table, coords),
    )


def _bilinear_mixed_bwd(gather_dtype, scatter_dtype, res, g):
    table, coords = res
    r0, r1, f = table.shape
    idx, w = _corners_2d(coords, r0, r1)
    contrib = (g[..., None, :] * w[..., :, None]).reshape(-1, f)
    grad_flat = (
        jnp.zeros((r0 * r1, f), scatter_dtype)
        .at[idx.reshape(-1)]
        .add(contrib.astype(scatter_dtype))
    )
    return grad_flat.reshape(r0, r1, f).astype(jnp.float32), jnp.zeros_like(coords)


bilinear_lookup_mixed.defvjp(_bilinear_mixed_fwd, _bilinear_mixed_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def trilinear_lookup_mixed(
    table, coords, gather_dtype=jnp.bfloat16, scatter_dtype=jnp.float32
):
    r0, r1, r2, f = table.shape
    idx, w = _corners_3d(coords, r0, r1, r2)
    return _weighted_gather(table.reshape(r0 * r1 * r2, f), idx, w, gather_dtype)


def _trilinear_mixed_fwd(table, coords, gather_dtype, scatter_dtype):
    return (
        trilinear_lookup_mixed(table, coords, gather_dtype, scatter_dtype),
        (table, coords),
    )


def _trilinear_mixed_bwd(gather_dtype, scatter_dtype, res, g):
    table, coords = res
    r0, r1, r2, f = table.shape
    idx, w = _corners_3d(coords, r0, r1, r2)
    contrib = (g[..., None, :] * w[..., :, None]).reshape(-1, f)
    grad_flat = scatter_add_rows(
        r0 * r1 * r2, idx.reshape(-1), contrib, out_dtype=scatter_dtype
    )
    return grad_flat.reshape(r0, r1, r2, f).astype(jnp.float32), jnp.zeros_like(coords)


trilinear_lookup_mixed.defvjp(_trilinear_mixed_fwd, _trilinear_mixed_bwd)


# --------------------------------------------------------------------------
# Cell-packed lookups: ALL interpolation corners of a cell live in ONE table
# row ([4F] for bilinear, [8F] for trilinear), so each sample costs exactly
# one gather row forward and one scatter row backward.  The packed table is
# rebuilt from the parameter table every call (a dense copy).
#
# Index convention: cell origin clamped to [0, res-2]; fractional offsets in
# [0, 1] (at coord == +1 the last cell interpolates with t == 1, which is
# exactly the edge value — identical results to the corner-clamped form).
# Coordinate cotangents are ZERO (see note above).
# --------------------------------------------------------------------------


def _cell_2d(coords, r0, r1):
    x = _to_index_space(coords[..., 0], r0)
    y = _to_index_space(coords[..., 1], r1)
    x0 = jnp.clip(jnp.floor(x), 0, r0 - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(y), 0, r1 - 2).astype(jnp.int32)
    tx = x - x0
    ty = y - y0
    cell = x0 * (r1 - 1) + y0
    w = jnp.stack(
        [(1 - tx) * (1 - ty), (1 - tx) * ty, tx * (1 - ty), tx * ty], axis=-1
    )
    return cell, w


def _interleave_shifts(t, shifts, axes):
    """Cell-pack shifted corner slices of `t` along a new minor-side axis.

    For each corner offset in `shifts` (tuples over `axes`, 0/1 each), takes
    the [dim-1]-sized slice of `t` along those axes and interleaves the
    results: output[..., i, c, :] = corner_c[..., i, :].  Built as a sum of
    lax.pad's with INTERIOR padding (dilation by len(shifts) along a fresh
    axis) — the padded supports are disjoint, so the adds are exact and XLA
    fuses the 8 (or 4) pads into one loop instead of materializing the
    stack+reshape relayout.

    t: [..., d_a0, d_a1(, d_a2), F] -> [..., (d-1 per axis), n_shifts, F]
    flattened over the sliced axes is left to the caller."""
    n = len(shifts)
    out = None
    for c, off in enumerate(shifts):
        sl = t
        for ax, d in zip(axes, off):
            size = t.shape[ax] - 1
            sl = jax.lax.slice_in_dim(sl, d, d + size, axis=ax)
        # dilate the LAST sliced axis by n with offset c, then the final
        # reshape splitting (dim*n) -> (dim, n) is layout-free
        ax = axes[-1]
        cfg = [(0, 0, 0)] * sl.ndim
        cfg[ax] = (c, n - 1 - c, n - 1)
        padded = jax.lax.pad(sl, jnp.zeros((), sl.dtype), cfg)
        out = padded if out is None else out + padded
    shape = list(out.shape)
    shape[axes[-1]] //= n
    shape.insert(axes[-1] + 1, n)
    return out.reshape(shape)


def _build_quad(table, gather_dtype):
    """[r0, r1, F] -> [(r0-1)*(r1-1), 4F]; corner order (00, 01, 10, 11).

    Formulation per _QUAD_BUILD_MODE (both bit-identical to
    build_quad_ref)."""
    t = table.astype(gather_dtype)
    r0, r1, f = table.shape
    if _QUAD_BUILD_MODE == "stack":
        q = jnp.stack(
            [t[dx : dx + r0 - 1, dy : dy + r1 - 1, :] for dx, dy in CORNERS_2D],
            axis=-2,
        )  # [r0-1, r1-1, 4, F]
    else:
        q = _interleave_shifts(
            t, [(0, 0), (0, 1), (1, 0), (1, 1)], (0, 1)
        )  # [r0-1, r1-1, 4, F]
    return _materialize(q.reshape((r0 - 1) * (r1 - 1), 4 * f))


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def bilinear_lookup_quad(table, coords, gather_dtype=jnp.bfloat16):
    """Bilinear lookup with the cell-packed (one row per sample) layout."""
    r0, r1, f = table.shape
    quad = _build_quad(table, gather_dtype)
    cell, w = _cell_2d(coords, r0, r1)
    rows = jnp.take(quad, cell, axis=0).astype(jnp.float32)
    vals = rows.reshape(*cell.shape, 4, f)
    return jnp.sum(vals * w[..., None], axis=-2)


def _bilinear_quad_fwd(table, coords, gather_dtype):
    return bilinear_lookup_quad(table, coords, gather_dtype), (table, coords)


def _bilinear_quad_bwd(gather_dtype, res, g):
    table, coords = res
    r0, r1, f = table.shape
    cell, w = _cell_2d(coords, r0, r1)
    contrib = (g[..., None, :] * w[..., :, None]).reshape(-1, 4 * f)
    gq = scatter_add_rows(
        (r0 - 1) * (r1 - 1), cell.reshape(-1), contrib
    ).reshape(r0 - 1, r1 - 1, 4 * f)
    grad = jnp.zeros((r0, r1, f), jnp.float32)
    c = 0
    for dx in (0, 1):
        for dy in (0, 1):
            sl = gq[..., c * f:(c + 1) * f]
            grad = grad + jnp.pad(sl, [(dx, 1 - dx), (dy, 1 - dy), (0, 0)])
            c += 1
    return grad, jnp.zeros_like(coords)


bilinear_lookup_quad.defvjp(_bilinear_quad_fwd, _bilinear_quad_bwd)


def _cell_3d(coords, r0, r1, r2):
    x = _to_index_space(coords[..., 0], r0)
    y = _to_index_space(coords[..., 1], r1)
    z = _to_index_space(coords[..., 2], r2)
    x0 = jnp.clip(jnp.floor(x), 0, r0 - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(y), 0, r1 - 2).astype(jnp.int32)
    z0 = jnp.clip(jnp.floor(z), 0, r2 - 2).astype(jnp.int32)
    tx, ty, tz = x - x0, y - y0, z - z0
    cell = (x0 * (r1 - 1) + y0) * (r2 - 1) + z0
    wx0, wx1 = 1 - tx, tx
    wy0, wy1 = 1 - ty, ty
    wz0, wz1 = 1 - tz, tz
    w = jnp.stack(
        [
            wx0 * wy0 * wz0, wx0 * wy0 * wz1, wx0 * wy1 * wz0, wx0 * wy1 * wz1,
            wx1 * wy0 * wz0, wx1 * wy0 * wz1, wx1 * wy1 * wz0, wx1 * wy1 * wz1,
        ],
        axis=-1,
    )
    return cell, w


def _build_oct(table, gather_dtype):
    """[r0, r1, r2, F] -> [(r0-1)(r1-1)(r2-1), 8F]; corner order matches
    _corners_3d (z fastest, then y, then x).

    Formulation per _OCT_BUILD_MODE (both bit-identical to
    build_oct_ref)."""
    t = table.astype(gather_dtype)
    r0, r1, r2, f = table.shape
    if _OCT_BUILD_MODE == "stack":
        q = jnp.stack(
            [
                t[dx : dx + r0 - 1, dy : dy + r1 - 1, dz : dz + r2 - 1, :]
                for dx, dy, dz in CORNERS_3D
            ],
            axis=-2,
        )  # [r0-1, r1-1, r2-1, 8, F]
    else:
        q = _interleave_shifts(
            t,
            [
                (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1),
            ],
            (0, 1, 2),
        )  # [r0-1, r1-1, r2-1, 8, F]
    return _materialize(q.reshape((r0 - 1) * (r1 - 1) * (r2 - 1), 8 * f))


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def trilinear_lookup_oct(table, coords, gather_dtype=jnp.bfloat16):
    """Trilinear lookup with the cell-packed (one row per sample) layout."""
    r0, r1, r2, f = table.shape
    oct_t = _build_oct(table, gather_dtype)
    cell, w = _cell_3d(coords, r0, r1, r2)
    rows = jnp.take(oct_t, cell, axis=0).astype(jnp.float32)
    vals = rows.reshape(*cell.shape, 8, f)
    return jnp.sum(vals * w[..., None], axis=-2)


def _trilinear_oct_fwd(table, coords, gather_dtype):
    return trilinear_lookup_oct(table, coords, gather_dtype), (table, coords)


def _trilinear_oct_bwd(gather_dtype, res, g):
    table, coords = res
    r0, r1, r2, f = table.shape
    cell, w = _cell_3d(coords, r0, r1, r2)
    contrib = (g[..., None, :] * w[..., :, None]).reshape(-1, 8 * f)
    gq4 = scatter_add_rows(
        (r0 - 1) * (r1 - 1) * (r2 - 1), cell.reshape(-1), contrib
    ).reshape(r0 - 1, r1 - 1, r2 - 1, 8 * f)
    # oct->grid reduction as pad+add over slices of the [.., 8F] layout
    # (XLA fuses the pads into one add loop)
    grad = jnp.zeros((r0, r1, r2, f), jnp.float32)
    c = 0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                sl = gq4[..., c * f:(c + 1) * f]
                grad = grad + jnp.pad(
                    sl, [(dx, 1 - dx), (dy, 1 - dy), (dz, 1 - dz), (0, 0)]
                )
                c += 1
    return grad, jnp.zeros_like(coords)


trilinear_lookup_oct.defvjp(_trilinear_oct_fwd, _trilinear_oct_bwd)


# --------------------------------------------------------------------------
# Exact 2x upsampling for nested align_corners grids.  A bilinear interpolant
# on an (r, r) table is reproduced EXACTLY by bilinear interpolation of its
# samples on a (2r-1, 2r-1) grid (the fine grid's nodes are the coarse nodes
# plus edge/cell midpoints, and a bilinear function is determined by any
# cell's corners).  This is what lets multiple K-Planes scales share ONE
# gather row forward and ONE scatter row backward (models/kplanes.py "fused"
# mode): one scatter of wide rows per projection instead of one per scale.
# --------------------------------------------------------------------------


def _upsample2x_axis0(x: jax.Array) -> jax.Array:
    """[r, ...] -> [2r-1, ...]: nodes kept, midpoints averaged in.

    Implemented with interior padding + shifted adds (not stack/reshape
    interleaving, which XLA materializes repeatedly — the fused-fine table
    build was ~3x slower that way).  At odd rows the two shifted copies hold
    the flanking nodes, so 0.5*(up + dn) is exactly the midpoint average."""
    r = x.shape[0]
    cfg = [(0, 0, 1)] + [(0, 0, 0)] * (x.ndim - 1)
    m = jax.lax.pad(x, jnp.zeros((), x.dtype), cfg)  # x at even rows
    zero_row = jnp.zeros((1,) + x.shape[1:], x.dtype)
    up = jnp.concatenate([zero_row, m[:-1]], axis=0)  # m shifted down
    dn = jnp.concatenate([m[1:], zero_row], axis=0)  # m shifted up
    odd = (jax.lax.broadcasted_iota(jnp.int32, (2 * r - 1,), 0) % 2).astype(
        bool
    ).reshape((2 * r - 1,) + (1,) * (x.ndim - 1))
    half = jnp.asarray(0.5, x.dtype)
    return jnp.where(odd, half * (up + dn), m)


def upsample2x_exact(table: jax.Array) -> jax.Array:
    """[r0, r1, F] -> [2*r0-1, 2*r1-1, F], exact for bilinear interpolation."""
    t = _upsample2x_axis0(table)
    return jnp.swapaxes(_upsample2x_axis0(jnp.swapaxes(t, 0, 1)), 0, 1)


def upsample_to(table: jax.Array, r0: int, r1: int) -> jax.Array:
    """Repeated exact 2x upsampling up to (r0, r1); requires a power-of-two
    nesting chain ((target-1) = 2^k * (source-1))."""
    while table.shape[0] < r0 or table.shape[1] < r1:
        table = upsample2x_exact(table)
    assert table.shape[:2] == (r0, r1), (
        f"resolutions do not nest: got {table.shape[:2]}, want {(r0, r1)}"
    )
    return table


# --------------------------------------------------------------------------
# Multiscale lookup: one custom VJP over ALL scales of a projection.
#
# Forward: per-scale cell-packed lookups (narrow rows).
# Backward: gradients are computed AS IF the forward had used the exactly-
# upsampled fused fine table (valid because the two representations are the
# same function): one scatter of [4 * n_scales * F]-wide rows per sample into
# the fused quad-gradient — one wide scatter replaces n_scales narrow
# ones — then the fine gradient is pulled
# back through the (linear) upsampling transpose to each master table.
# Coordinate cotangents are ZERO (sample coords come from no-grad marching).
# --------------------------------------------------------------------------


def _quad_lookup_fwd_value(table, coords, gather_dtype):
    r0, r1, f = table.shape
    quad = _build_quad(table, gather_dtype)
    cell, w = _cell_2d(coords, r0, r1)
    rows = jnp.take(quad, cell, axis=0).astype(jnp.float32)
    vals = rows.reshape(*cell.shape, 4, f)
    return jnp.sum(vals * w[..., None], axis=-2)


def build_fused_fine(tables) -> jax.Array:
    """Exactly upsample every scale to the finest resolution and concat
    features: [r_f, r_f, f_tot].  Bilinear-exact (upsample2x_exact), so a
    bilinear lookup in the fused table equals the per-scale lookups."""
    r_fine = max(t.shape[0] for t in tables)
    return jnp.concatenate(
        [upsample_to(t, r_fine, r_fine) for t in tables], axis=-1
    )


def _multiscale_value(tables, coords, gather_dtype, fwd_impl):
    """Forward value shared by the single- and multi-projection ops."""
    if fwd_impl == "fusedfine":
        r_fine = max(t.shape[0] for t in tables)
        f_tot = sum(t.shape[-1] for t in tables)
        # round to the gather dtype FIRST (coarse nodes then match the
        # perscale path bit-for-bit) and upsample in bf16 — midpoint halving
        # averages of fp8 values are EXACT in bf16 through the 2-level
        # nesting chain, and the build traffic is 1/2 of the f32 path
        hold = jnp.float32 if gather_dtype == jnp.float32 else jnp.bfloat16
        cast = tuple(t.astype(gather_dtype).astype(hold) for t in tables)
        fine = jnp.concatenate(
            [upsample_to(t, r_fine, r_fine) for t in cast], axis=-1
        )
        quad = _build_quad(fine, gather_dtype)
        cell, w = _cell_2d(coords, r_fine, r_fine)
        rows = jnp.take(quad, cell, axis=0)
        # corner reduce via feature SLICES rather than a [n, 4F] ->
        # [n, 4, F] reshape of the whole gather output
        out = None
        for c in range(4):
            v = rows[..., c * f_tot : (c + 1) * f_tot].astype(jnp.float32)
            term = v * w[..., c : c + 1]
            out = term if out is None else out + term
        return out
    return jnp.concatenate(
        [_quad_lookup_fwd_value(t, coords, gather_dtype) for t in tables],
        axis=-1,
    )


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def bilinear_lookup_multiscale(
    tables, coords, gather_dtype=jnp.bfloat16, fwd_impl="perscale",
):
    """tables: tuple of [r_s, r_s, F] planes whose (r-1) nest by powers of
    two; coords [..., 2] in [-1,1].  Returns the feature-wise concat of the
    per-scale bilinear lookups, [..., n_scales * F].

    The backward accumulates the fused fine-table gradient with one XLA
    scatter-add of [4 * n_scales * F]-wide rows.

    `fwd_impl` selects the forward gather shape:
      "perscale"  — one cell-packed gather per scale (narrow rows);
      "fusedfine" — gather ONE [4 * f_tot]-wide row per sample from the
                    exactly-upsampled fused fine table.  Upsampled midpoint
                    nodes round to gather_dtype once more than "perscale".
    """
    return _multiscale_value(tables, coords, gather_dtype, fwd_impl)


def _multiscale_fwd(tables, coords, gather_dtype, fwd_impl):
    return (
        bilinear_lookup_multiscale(tables, coords, gather_dtype, fwd_impl),
        (tables, coords),
    )


def _pullback_scales(fine, tables):
    """Split the fused fine-grid gradient feature-wise and pull each slice
    back through the (linear) exact-upsampling transpose to its master."""
    r_fine = fine.shape[0]
    grads = []
    off = 0
    for t in tables:
        sl = fine[..., off : off + t.shape[-1]]
        off += t.shape[-1]
        if t.shape[0] == r_fine:
            grads.append(sl)
        else:
            _, pullback = jax.vjp(
                lambda tt: upsample_to(tt, r_fine, r_fine), jnp.zeros_like(t)
            )
            grads.append(pullback(sl)[0])
    return tuple(grads)


def _down_transpose_axis0_band(g):
    """Transpose of `_upsample2x_axis0` restricted to a row band.

    `g` holds fine-grid gradient rows covering GLOBAL rows [s, s+m-1] with s
    EVEN; returns the coarse-row contributions this band can compute:
    out[c] = g[2c] + 0.5*(g[2c-1] + g[2c+1]) with out-of-band terms dropped
    (they are computed by the neighboring band — or do not exist at the
    global edge — and every consumer SUMS the per-band outputs, so dropped
    terms are exactly the neighbor's contribution, never a loss).  Output
    covers global coarse rows [s/2, s/2 + m//2] (length m//2 + 1).  With
    s == 0 and odd m this is the exact full transpose, so the same function
    serves the full (column) axis."""
    m = g.shape[0]
    no = m // 2 + 1
    even = g[::2]  # g[2c]
    odd = g[1::2]  # g[2c+1]
    zero = jnp.zeros_like(g[:1])
    if even.shape[0] < no:
        even = jnp.concatenate([even, zero], axis=0)
    up = jnp.concatenate([zero, odd], axis=0)  # g[2c-1]
    dn = odd if odd.shape[0] == no else jnp.concatenate([odd, zero], axis=0)
    return even + 0.5 * (up + dn)


def _down_transpose_axis1_full(g):
    t = jnp.swapaxes(g, 0, 1)
    return jnp.swapaxes(_down_transpose_axis0_band(t), 0, 1)


def sharded_pullback_unit(r_fine: int, resolutions) -> int:
    """Row-band granularity for the sharded pullback: bands must start on a
    multiple of 2^k_max so every halving level keeps even global starts."""
    k_max = max(
        int(round(math.log2((r_fine - 1) // (r - 1)))) for r in resolutions
    )
    return 2 ** k_max


def _sharded_pullback(gq_by_proj, tables_by_proj, r_fine, f_tot, shard_axis):
    """Mesh-sharded fused-fine pullback (must run INSIDE shard_map).

    Each device holds the quad gradient of ITS sample shard over the full
    table.  Instead of every device running the table-sized
    upsample-transpose chain on its partial (replicated work that does not
    divide by the mesh), the
    device-summed FINE gradient is `psum_scatter`'d over padded rows, each
    device pulls back only its row band through the (linear) transpose
    chain, and the band lands in a zero-filled full-shape master gradient.
    The per-device outputs SUM to the exact replicated gradient (pullback
    is linear; band-boundary rows carry partial values that the reduction
    completes), so the downstream psum / psum_scatter needs no change."""
    axis_name, n_dev = shard_axis
    unit = sharded_pullback_unit(
        r_fine, [t.shape[0] for t in tables_by_proj[0]]
    )
    band = -(-r_fine // (unit * n_dev)) * unit  # rows per device
    rows_pad = band * n_dev
    s0 = jax.lax.axis_index(axis_name) * band
    out = []
    for p, gq in enumerate(gq_by_proj):
        fine = _fine_from_quad(gq, r_fine, f_tot)
        fine = jnp.pad(fine, ((0, rows_pad - r_fine), (0, 0), (0, 0)))
        loc = jax.lax.psum_scatter(
            fine, axis_name, scatter_dimension=0, tiled=True
        )  # [band, r_fine, f_tot] — the SUMMED fine grad, rows [s0, s0+band)
        grads = []
        off = 0
        for t in tables_by_proj[p]:
            f = t.shape[-1]
            k = int(round(math.log2((r_fine - 1) // (t.shape[0] - 1))))
            g = loc[..., off : off + f]
            off += f
            for _ in range(k):
                g = _down_transpose_axis1_full(g)
                g = _down_transpose_axis0_band(g)
            start = s0 // (2 ** k)  # integer: band % 2^k == 0
            pad_rows = rows_pad // (2 ** k) + (1 if k else 0)
            full = jnp.zeros((pad_rows, t.shape[1], f), jnp.float32)
            full = jax.lax.dynamic_update_slice(full, g, (start, 0, 0))
            grads.append(full[: t.shape[0]])
        out.append(tuple(grads))
    return tuple(out)


def _fine_from_quad(gq, r_fine, f_tot):
    """[n_cells, 4*f_tot] corner-major quad gradient -> [r, r, f_tot].

    Quad->grid corner reduction as pad+add over slices of the [.., 4F]
    layout — XLA fuses the pads into one add loop."""
    r = r_fine - 1
    gq4 = gq.reshape(r, r, 4 * f_tot)
    fine = jnp.zeros((r_fine, r_fine, f_tot), jnp.float32)
    c = 0
    for dx in (0, 1):
        for dy in (0, 1):
            sl = gq4[..., c * f_tot:(c + 1) * f_tot]
            fine = fine + jnp.pad(sl, [(dx, 1 - dx), (dy, 1 - dy), (0, 0)])
            c += 1
    return fine


def _multiscale_bwd(gather_dtype, fwd_impl, res, g):
    tables, coords = res
    r_fine = max(t.shape[0] for t in tables)
    f_tot = sum(t.shape[-1] for t in tables)
    n_cells = (r_fine - 1) * (r_fine - 1)
    cell, w = _cell_2d(coords, r_fine, r_fine)
    # corner-major rows [c0(f_tot), c1, c2, c3]
    contrib = (w[..., :, None] * g[..., None, :]).reshape(-1, 4 * f_tot)
    gq = scatter_add_rows(n_cells, cell.reshape(-1), contrib)
    fine = _fine_from_quad(gq, r_fine, f_tot)
    return _pullback_scales(fine, tables), jnp.zeros_like(coords)


bilinear_lookup_multiscale.defvjp(_multiscale_fwd, _multiscale_bwd)


# --------------------------------------------------------------------------
# Multi-projection multiscale lookup: ONE custom VJP over all three K-Planes
# projections (one scatter per projection), with an optional mesh-sharded
# fine-gradient pullback.
# --------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def multiscale_lookup_multiproj(
    tables_by_proj,  # tuple over projections of tuples over scales
    coords_by_proj,  # tuple over projections of [..., 2] coords in [-1,1]
    gather_dtype=jnp.bfloat16,
    fwd_impl="perscale",
    shard_axis=None,
):
    """Per-projection multiscale lookups with one shared (batched) backward.

    Returns a tuple over projections of [..., n_scales * F] features —
    value-identical to calling bilinear_lookup_multiscale per projection
    (same fwd_impl semantics); gradients are identical up to f32 summation
    order.

    `shard_axis`: optional `(mesh_axis_name, n_devices)`.  When set, the
    call MUST run inside shard_map over that axis with each device holding
    its own sample shard; the backward then psum_scatters the device-summed
    fine gradient and each device pulls back only its row band
    (_sharded_pullback) — the returned per-device table grads SUM across
    the mesh to the replicated gradient (feed them to psum/psum_scatter
    exactly like unsharded grads)."""
    return tuple(
        _multiscale_value(t, c, gather_dtype, fwd_impl)
        for t, c in zip(tables_by_proj, coords_by_proj)
    )


def _multiproj_fwd(tables_by_proj, coords_by_proj, gather_dtype, fwd_impl, shard_axis):
    out = multiscale_lookup_multiproj(
        tables_by_proj, coords_by_proj, gather_dtype, fwd_impl, shard_axis
    )
    return out, (tables_by_proj, coords_by_proj)


def _multiproj_bwd(gather_dtype, fwd_impl, shard_axis, res, gs):
    tables_by_proj, coords_by_proj = res
    n_proj = len(tables_by_proj)
    r_fine = max(t.shape[0] for t in tables_by_proj[0])
    f_tot = sum(t.shape[-1] for t in tables_by_proj[0])
    n_cells = (r_fine - 1) * (r_fine - 1)
    n = int(np.prod(gs[0].shape[:-1])) if gs[0].ndim > 1 else 1

    # per-projection scatters, NOT stacked — a stack materializes an extra
    # copy of the quad grads
    gq_by_proj = []
    for coords, g in zip(coords_by_proj, gs):
        cell, w = _cell_2d(coords, r_fine, r_fine)
        contrib = (w.reshape(n, 4, 1) * g.reshape(n, 1, f_tot)).reshape(
            n, 4 * f_tot
        )
        gq_by_proj.append(scatter_add_rows(n_cells, cell.reshape(n), contrib))

    coord_grads = tuple(jnp.zeros_like(c) for c in coords_by_proj)
    if shard_axis is not None:
        return (
            _sharded_pullback(
                gq_by_proj, tables_by_proj, r_fine, f_tot, shard_axis
            ),
            coord_grads,
        )
    table_grads = []
    for p in range(n_proj):
        fine = _fine_from_quad(gq_by_proj[p], r_fine, f_tot)
        table_grads.append(_pullback_scales(fine, tables_by_proj[p]))
    return tuple(table_grads), coord_grads


multiscale_lookup_multiproj.defvjp(_multiproj_fwd, _multiproj_bwd)


def sawtooth(x: jax.Array, f: float) -> jax.Array:
    """Periodic tiling encoding: 2*((f*x) mod 1) - 1, output in [-1, 1].

    (Reference SawtoothEncoding, src/models.py:209-214.)
    """
    return 2.0 * jnp.mod(f * x, 1.0) - 1.0

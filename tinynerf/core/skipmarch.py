"""Empty-space-skipping ray marching (occupancy culling without a query at
every sample).

The reference culls empty space by evaluating the occupancy grid at every
marched sample (src/core.py:176): n_rays x n_samples point queries, one
scalar gather each.

This module replaces brute-force querying with empty-space skipping recast
for XLA.  A CONE DISTANCE TRANSFORM precomputed from the occupancy grid
stores, per voxel and per (dominant axis, sign), how many axis slices a ray
may advance before possibly hitting an occupied voxel: for a ray whose
dominant direction component is +x, every voxel it can visit after advancing
k x-slices lies within |lateral| <= k (+1 slop), i.e. inside a cone — and
D[v] = min over occupied u in that cone of (u_x - v_x) is computable with a
single reverse sweep per direction (6 sweeps of lax.scan over slices).
Unlike an isotropic (Chebyshev-ball) skip pyramid, a cone skip jumps
straight to the next occupied region instead of halving the distance per
hop, so a ray needs ~(surviving samples + one hop per empty span) scan steps.

Marching is a fixed-length `lax.scan`, vectorized over rays, that per step
gathers ONE cone value per ray and either emits the sample (occupied voxel)
or jumps the certified-empty span.

EXACTNESS: the emitted sample set equals the brute-force path's surviving
set exactly — including jitter — because (a) the cone transform runs on a
laterally dilated occupancy, which absorbs the <= one-voxel lateral slop of
rounding and jitter, and the sample-advance bound is conservative along the
axis, and (b) both paths draw the per-(ray, sample) jitter from the same
stateless hash (ops/hashrng.py).  Tests assert set equality against the
dense reference on random grids and rays.

Rays still marching after `n_steps` scan steps are flagged incomplete so the
loss can exclude them (the same mechanism as sample-cap overflow).  The
training loop only selects this path when the demand estimate leaves ample
step budget; early training (everything occupied) uses the dense path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.hashrng import hash_u01
from .contraction import ContractionAABB, ContractionMip360
from .marching import RayMarcherUnbounded

_INF = jnp.int32(1 << 20)
_MAX_D = 127  # cone distances clip here; advances saturate long before
# Upper bound on the Euclidean-in / Chebyshev-out Lipschitz constant of the
# order-inf Mip-360 contraction (incl. its final /2).  The true constant is
# ~0.50596 (attained at ||x||_inf = 1.25 with two near-equal dominant
# coordinates), NOT 1/2 — see skip_march_unbounded.
_LIPSCHITZ = 0.5065


def _probe(flat_grid: jax.Array, r2: int, flat_idx: jax.Array) -> jax.Array:
    """Skip-value lookup as a row gather + in-row select (the same values
    as `flat_grid[flat_idx]`); minor dims over 128 use the scalar gather."""
    if r2 > 128:
        return flat_grid[flat_idx]
    rows = flat_grid.reshape(-1, r2)[flat_idx // r2]
    return jnp.take_along_axis(rows, (flat_idx % r2)[:, None], axis=1)[:, 0]


def _shift2d(x: jax.Array, dy: int, dz: int, fill) -> jax.Array:
    """Shift a [r1, r2] slice by (dy, dz), filling vacated cells."""
    if dy:
        pad = jnp.full((abs(dy), x.shape[1]), fill, x.dtype)
        x = (
            jnp.concatenate([x[dy:], pad], 0)
            if dy > 0
            else jnp.concatenate([pad, x[:dy]], 0)
        )
    if dz:
        pad = jnp.full((x.shape[0], abs(dz)), fill, x.dtype)
        x = (
            jnp.concatenate([x[:, dz:], pad], 1)
            if dz > 0
            else jnp.concatenate([pad, x[:, :dz]], 1)
        )
    return x


def _cone_sweep(occ_dil: jax.Array) -> jax.Array:
    """D[v] = min slices along +axis0 to a dilated-occupied voxel within the
    bidirectional-lateral cone (|lateral| <= axis advance); 0 on dilated-
    occupied voxels.  One reverse lax.scan over axis-0 slices; the cone is
    realized by taking the min over the 9 laterally-shifted carries."""
    r0 = occ_dil.shape[0]

    def step(carry, occ_slice):
        shifted = [
            _shift2d(carry, dy, dz, _INF)
            for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)
        ]
        ahead = jnp.minimum(
            jnp.min(jnp.stack(shifted), axis=0) + 1, _INF
        )
        d = jnp.where(occ_slice, jnp.int32(0), ahead)
        return d, d

    init = jnp.full(occ_dil.shape[1:], _INF, jnp.int32)
    _, ds = jax.lax.scan(step, init, occ_dil[::-1])
    return ds[::-1]


def make_skip_grid(occ_bool: jax.Array) -> jax.Array:
    """Cone skip grids for all 6 (dominant axis, sign) directions.

    Returns int32 [6, r0, r1, r2]; value semantics per voxel v and direction:
      0  — v is TRULY occupied (the marcher emits the sample),
      k  — every voxel u the ray can visit within the next (k-1) axis slices
           (cone: |lateral| <= axis advance + 1) is truly unoccupied.
    Grid order: (+x, -x, +y, -y, +z, -z).
    """
    occ = occ_bool

    def dilate1(x, axis):
        lo = jnp.concatenate(
            [jax.lax.slice_in_dim(x, 1, x.shape[axis], axis=axis),
             jnp.zeros_like(jax.lax.slice_in_dim(x, 0, 1, axis=axis))],
            axis=axis,
        )
        hi = jnp.concatenate(
            [jnp.zeros_like(jax.lax.slice_in_dim(x, 0, 1, axis=axis)),
             jax.lax.slice_in_dim(x, 0, x.shape[axis] - 1, axis=axis)],
            axis=axis,
        )
        return x | lo | hi

    grids = []
    for axis in (0, 1, 2):
        # 2-voxel LATERAL dilation: a visited voxel's lateral offset can
        # exceed its axis advance by up to 2 (nearest-voxel rounding at both
        # the current and visited sample, for diagonal rays) — the cone
        # certifies |lateral| <= axis advance, so the slop is absorbed here
        dil = occ
        for lat in (0, 1, 2):
            if lat == axis:
                continue
            dil = dilate1(dilate1(dil, lat), lat)
        occ_a = jnp.moveaxis(occ, axis, 0)
        dil_a = jnp.moveaxis(dil, axis, 0)
        for flip in (False, True):
            d = dil_a[::-1] if flip else dil_a
            cone = _cone_sweep(d)
            if flip:
                cone = cone[::-1]
            g = jnp.where(
                occ_a, jnp.int32(0), jnp.clip(jnp.maximum(cone, 1), 0, _MAX_D)
            )
            grids.append(jnp.moveaxis(g, 0, axis))
    return jnp.stack(grids)


def _maxpool_shift(x: jax.Array, radius: int) -> jax.Array:
    """Max over shifts {-radius, 0, +radius} along every axis (zero fill);
    applied to a radius-r pooled map this yields the radius-2r pool."""
    for axis in range(x.ndim):
        n = x.shape[axis]
        r = min(radius, n)
        lo = jnp.concatenate(
            [jax.lax.slice_in_dim(x, r, n, axis=axis),
             jnp.zeros_like(jax.lax.slice_in_dim(x, 0, r, axis=axis))],
            axis=axis,
        )
        hi = jnp.concatenate(
            [jnp.zeros_like(jax.lax.slice_in_dim(x, n - r, n, axis=axis)),
             jax.lax.slice_in_dim(x, 0, n - r, axis=axis)],
            axis=axis,
        )
        x = jnp.maximum(x, jnp.maximum(lo, hi))
    return x


def make_skip_grid_iso(occ_bool: jax.Array, n_levels: int = 8) -> jax.Array:
    """Isotropic (Chebyshev-ball) skip grid for marchers whose contracted-
    space paths are CURVED (the Mip-360 contraction bends world rays), where
    a directional cone cannot be certified.

    int32 [r0, r1, r2]; value semantics per voxel v:
      0  — truly occupied (emit),
      g  — every voxel within Chebyshev radius (g - 1) of v is unoccupied.
    """
    occ = occ_bool.astype(jnp.float32)
    g = jnp.where(occ_bool, jnp.int32(0), jnp.int32(1))
    pooled = _maxpool_shift(occ, 1)
    radius = 1
    for _ in range(n_levels):
        g = jnp.where(
            ~occ_bool & (pooled == 0.0),
            jnp.int32(min(1 + radius, _MAX_D)),
            g,
        )
        pooled = _maxpool_shift(pooled, radius)
        radius *= 2
    return g


def skip_march_unbounded(
    rays_o: jax.Array,  # [R, 3]
    rays_d: jax.Array,  # [R, 3] unit-norm
    marcher: RayMarcherUnbounded,
    contraction: ContractionMip360,
    skip_grid: jax.Array,  # [r0, r1, r2] int32 from make_skip_grid_iso
    key: Optional[jax.Array],
    n_steps: int,
) -> Tuple[jax.Array, jax.Array]:
    """Empty-space-skipping march on the disparity grid of the unbounded
    marcher.

    The skip value certifies a CONTRACTED-space Chebyshev-empty ball; the
    Mip-360 contraction (including its final /2) is 1/2-Lipschitz, so a
    contracted radius rho is safe for a world advance of 2*rho.  The world
    advance converts to a sample-index jump through the closed-form inverse
    of the disparity spacing.  Same return contract as `skip_march`.
    """
    R = rays_o.shape[0]
    S = marcher.n_samples
    r0, r1, r2 = skip_grid.shape
    res = jnp.array([r0 - 1, r1 - 1, r2 - 1], jnp.float32)
    flat_grid = skip_grid.reshape(-1)
    ray_ids = jnp.arange(R, dtype=jnp.int32)
    w_c = 2.0 / float(max(r0, r1, r2) - 1)  # contracted voxel size (finest axis)

    rng = jnp.float32(marcher.uniform_range)
    near = jnp.float32(marcher.near)
    # Per-ray closest approach to the origin, for the LOCAL Lipschitz bound
    # below: along [t, inf) every point's radius is >= n_eff(t) =
    # (n_perp before the closest approach, the current radius after it).
    t_star = -jnp.sum(rays_o * rays_d, axis=-1)  # [R]
    n_perp = jnp.linalg.norm(
        rays_o + rays_d * t_star[:, None], axis=-1
    )  # [R]
    # the certificate below converts a Chebyshev voxel radius to a contracted
    # distance; the binding axis is the FINEST one (smallest voxel), so any
    # per-axis resolution asymmetry must use max(r) (today cube() always
    # builds cubic grids, but keep the latent trap closed)
    assert r0 == r1 == r2, "skip_march_unbounded requires a cubic skip grid"
    # disparity grid: x_k = k * step_x; t_k = f(x_k) * range + near — the
    # same f32 expression the marcher's dense grid uses, so positions match
    # bitwise between the two paths
    step_x = jnp.float32(marcher.step_x)
    x_last = jnp.float32(S) * step_x  # one past the final sample's x

    def t_of_x(x):
        f = jnp.where(x < 0.5, 2.0 * x, 1.0 / jnp.maximum(2.0 - 2.0 * x, 1e-9))
        return f * rng + near

    def x_of_t(t):
        y = jnp.maximum((t - near) / rng, 0.0)
        return jnp.where(y < 1.0, y * 0.5, 1.0 - 0.5 / jnp.maximum(y, 1.0))

    def one_round(k, done):
        kk = jnp.minimum(k, S - 1)
        xk = kk.astype(jnp.float32) * step_x
        t_lo = t_of_x(xk)
        delta = t_of_x((kk + 1).astype(jnp.float32) * step_x) - t_lo
        if key is not None:
            u = hash_u01(key, ray_ids, kk)
        else:
            u = jnp.float32(0.0)
        t = t_lo + u * delta
        pos = rays_o + rays_d * t[:, None]
        cpos, _ = contraction(pos)
        idx = jnp.clip(
            jnp.round((cpos + 1.0) * 0.5 * res), 0.0, res
        ).astype(jnp.int32)
        vox = (idx[:, 0] * r1 + idx[:, 1]) * r2 + idx[:, 2]
        g = _probe(flat_grid, r2, vox)

        active = ~done & (k < S)
        emit = active & (g == 0)
        # contracted-empty radius rho = (g-1)*w_c; jittered skipped samples
        # stay within t_{k+m} - t_k of the current sample, whose contracted
        # displacement is bounded by L * (t_{k+m} - t_k).  The Euclidean-in /
        # Chebyshev-out Lipschitz constant of the order-inf Mip-360
        # contraction is NOT exactly 1/2: it peaks at ~0.50596 near
        # ||x||_inf = 1.25 with two near-equal dominant coordinates, so the
        # naive 1/2 advance 2*(rho - w_c) could overshoot the certified ball
        # by ~1.2% of rho — exactly eating the one-voxel rounding margin.
        # Divide by a conservative L instead:
        # safe while t_{k+m} <= t_k + (rho - w_c) / L  (the -w_c absorbs the
        # one-voxel rounding of both endpoints)
        #
        # L is a bound on the Euclid-in/Cheb-out Lipschitz constant over the
        # REMAINING ray [t, inf), not the global worst case.  For the
        # ORDER-INF contraction, c(x) = psi(m) * x with m = ||x||_inf and
        # psi(m) = 1/m - 1/(2 m^2); each output component mixes only the
        # matching input component and the dominant axis, so (Cauchy-Schwarz
        # over those two, |x_i| <= m) the directional constant at a point of
        # inf-radius m is at most
        #   F(m) = (1/m) * sqrt((1 - 1/(2m))^2 + (1 - 1/m)^2),
        # attained near DIAGONAL points (coordinates tied at the max) —
        # asymptotically sqrt(2)/m, NOT the 1/m of the Euclidean-norm
        # contraction (a numeric sweep measures the sup of L*||x||_2 at 2.39,
        # i.e. ~sqrt(6)/n_2; assuming 1/n overshoots the certificate ~2.4x).
        # Every point past t has Euclidean radius >= n_eff (= n_perp before
        # the closest approach, the current radius after), hence inf-radius
        # >= m0 = n_eff/sqrt(3); F decreases beyond its m=1.25 peak, so for
        # n_eff >= 2.25 (m0 >= 1.30 > 1.25, also clear of the unit ball)
        # L <= F(m0).  The global constant only binds near the scene core;
        # in the contracted far field the advance still grows ~linearly with
        # the radius (geometric traversal of the disparity tail) — without
        # this, rays spent their whole scan budget walking the far field at
        # ~(rho/L_global) world units per step and the trainer's
        # completeness guard forced dense marching.
        rho = (g.astype(jnp.float32) - 1.0) * w_c
        n_k = jnp.linalg.norm(pos, axis=-1)
        n_eff = jnp.maximum(1.0, jnp.where(t < t_star, n_perp, n_k))
        m0 = jnp.maximum(n_eff * jnp.float32(1.0 / np.sqrt(3.0)), 1.3)
        f_m0 = jnp.sqrt(
            (1.0 - 0.5 / m0) ** 2 + (1.0 - 1.0 / m0) ** 2
        ) / m0
        l_inv = jnp.where(
            n_eff >= 2.25,
            # both bounds are valid here; take the larger advance
            jnp.maximum(1.0 / f_m0, jnp.float32(1.0 / _LIPSCHITZ)),
            jnp.float32(1.0 / _LIPSCHITZ),
        )
        t_safe = t_lo + jnp.maximum((rho - w_c) * l_inv, 0.0)
        k_safe = jnp.floor(
            jnp.minimum(x_of_t(t_safe), x_last) / step_x
        ).astype(jnp.int32)
        adv = jnp.maximum(k_safe - kk, 1)
        k_next = jnp.where(active, k + adv, k)
        done_next = done | (k_next >= S)
        y = jnp.where(emit, kk, jnp.int32(-1))
        return k_next, done_next, y

    unroll = 2 if n_steps % 2 == 0 else 1

    def body(carry, _):
        k, done = carry
        ys = []
        for _ in range(unroll):
            k, done, y = one_round(k, done)
            ys.append(y)
        return (k, done), jnp.stack(ys)

    init = (jnp.zeros(R, jnp.int32), jnp.zeros(R, bool))
    (k_fin, done_fin), ys = jax.lax.scan(
        body, init, None, length=n_steps // unroll
    )
    return ys.reshape(n_steps, R).T, done_fin


def skip_march(
    rays_o: jax.Array,  # [R, 3]
    rays_d: jax.Array,  # [R, 3] unit-norm
    t_min: jax.Array,  # [R] box entry (clamped to near, as the marcher does)
    t_exit: jax.Array,  # [R] box exit
    step_size: float,
    n_samples: int,
    contraction: ContractionAABB,
    skip_grid: jax.Array,  # [6, r0, r1, r2] int32 from make_skip_grid
    key: Optional[jax.Array],
    n_steps: int,
) -> Tuple[jax.Array, jax.Array]:
    """March with cone empty-space skipping.

    Returns (k_idx [R, n_steps] int32 emitted sample indices (-1 = none,
    ascending per ray), complete [R] bool — False where the step budget ran
    out before the ray finished; such rays must be excluded from the loss).
    """
    R = rays_o.shape[0]
    _, r0, r1, r2 = skip_grid.shape
    res = jnp.array([r0 - 1, r1 - 1, r2 - 1], jnp.float32)  # align_corners
    flat_grid = skip_grid.reshape(-1)
    vox_per_grid = r0 * r1 * r2
    ray_ids = jnp.arange(R, dtype=jnp.int32)
    delta = jnp.float32(step_size)

    # per-ray direction class + advance scale.  For dominant axis a:
    # x-index advance of skipping m samples is < m*delta*|d_a|/w_a + 1, so
    # skipping is safe while that stays <= g-1: m = ceil((g-1)/rate) - 1
    # with rate = delta*|d_a|/w_a (index slices per sample).
    #
    # The dominant axis is picked by INDEX rate |d_a|/w_a, not world-space
    # |d_a|: the cone certificate bounds |lateral index advance| by the axis
    # index advance, which holds iff every lateral axis's index rate is <=
    # the dominant one's — for anisotropic voxels (non-cubic cfg.aabb over a
    # cubic grid) the two rankings differ, and the world-space pick would
    # let a finer lateral axis outrun the cone and skip occupied voxels.
    lo, hi = (np.asarray(v, np.float32) for v in contraction.aabb)
    w_axis = jnp.asarray((hi - lo) / np.array([r0 - 1, r1 - 1, r2 - 1]))
    idx_rate = jnp.abs(rays_d) / w_axis[None, :]  # index slices per unit t
    dom = jnp.argmax(idx_rate, axis=-1)  # [R]
    sign_neg = jnp.take_along_axis(rays_d, dom[:, None], -1)[:, 0] < 0.0
    grid_sel = dom * 2 + sign_neg.astype(jnp.int32)  # (+a, -a) order
    grid_base = grid_sel * vox_per_grid
    rate = (
        delta * jnp.take_along_axis(idx_rate, dom[:, None], -1)[:, 0]
    )  # [R] > 0 since |d|=1 and dom is the max index-rate component

    # number of in-box samples: sample k is in the box iff t_k <= t_exit
    # (t >= t_min = entry by construction; out-of-box tails are never
    # emitted by the dense path either — its contraction mask culls them).
    # +2 margin: emission uses the contraction's coordinate mask, which can
    # disagree with the slab t_exit by 1 ulp at the boundary sample
    k_end = jnp.clip(
        jnp.floor((t_exit - t_min) / delta) + 2.0, 0.0, float(n_samples)
    ).astype(jnp.int32)

    def one_round(k, done):
        kk = jnp.minimum(k, n_samples - 1)
        if key is not None:
            u = hash_u01(key, ray_ids, kk)
        else:
            u = jnp.float32(0.0)
        # SAME f32 expression order as the dense path (t_min + k*delta, then
        # + u*delta): mixing the rounding orders disagrees by 1 ulp for
        # probes landing on voxel/box boundaries, breaking bit-equality
        t = (t_min + kk.astype(jnp.float32) * delta) + u * delta
        pos = rays_o + rays_d * t[:, None]
        # the contraction's own in-box mask makes emission bit-identical to
        # the dense path (a t <= t_exit test disagrees by 1 ulp at box edges)
        cpos, inbox = contraction(pos)
        idx = jnp.clip(
            jnp.round((cpos + 1.0) * 0.5 * res), 0.0, res
        ).astype(jnp.int32)
        vox = (idx[:, 0] * r1 + idx[:, 1]) * r2 + idx[:, 2]
        g = _probe(flat_grid, r2, grid_base + vox)  # ONE row gather/ray/round

        active = ~done & (k < k_end)
        emit = active & (g == 0) & (inbox > 0.0)
        # skipped sample k+i advances <= (i+1)*rate + 1 axis slices; all must
        # stay within the certified g-1 slices: m*rate <= g-2
        adv = jnp.maximum(
            jnp.floor((g.astype(jnp.float32) - 2.0) / rate).astype(jnp.int32),
            1,
        )
        k_next = jnp.where(active, k + adv, k)
        done_next = done | (k_next >= k_end)
        y = jnp.where(emit, kk, jnp.int32(-1))
        return k_next, done_next, y

    # 2 rounds per scan iteration: halves loop-carry overhead without
    # changing the visit sequence (outputs stay per-round)
    unroll = 2 if n_steps % 2 == 0 else 1

    def body(carry, _):
        k, done = carry
        ys = []
        for _ in range(unroll):
            k, done, y = one_round(k, done)
            ys.append(y)
        return (k, done), jnp.stack(ys)  # [unroll, R]

    init = (jnp.zeros(R, jnp.int32), jnp.zeros(R, bool))
    (k_fin, done_fin), ys = jax.lax.scan(
        body, init, None, length=n_steps // unroll
    )
    # [n_iters, unroll, R] -> [R, n_steps], round order preserved per ray
    k_idx = ys.reshape(n_steps, R).T
    return k_idx, done_fin

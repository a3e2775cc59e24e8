"""K-Planes feature field (arXiv 2301.10241).

Parity (reference src/models.py:93-205):
  * 3 scales x 3 axis-aligned planes (xy/xz/yz) at 128^2 / 256^2 / 512^2,
    feature dim 32 per plane, init U(0, 1);
  * per scale, the field value is the PRODUCT of the three bilinear plane
    lookups; scales are concatenated => feature_dim = 32 * 3 = 96.
    (The reference hardcodes feature_dim = 32 * n_scales regardless of its
    constructor arg — SURVEY.md §2 #20; here the dim is derived correctly.)
  * TV regularizer: mean squared difference of axis-shifted plane entries,
    averaged over all planes; L1 regularizer: mean |plane|, averaged.
  * The explicit (feature-bilinear) opacity/color decoders are provided for
    API parity although train() wires the vanilla decoders for K-Planes too.

Planes are stored feature-LAST ([r, r, 32]) so each bilinear corner fetch is
one contiguous 32-float row gather (see ops/interp.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.interp import (
    bilinear_lookup,
    bilinear_lookup_mixed,
    bilinear_lookup_multiscale,
    bilinear_lookup_quad,
    multiscale_lookup_multiproj,
)
from ..ops.trunc_exp import truncated_exp
from .encodings import posenc_dim, positional_encoding
from .mlp import linear_apply, linear_init, mlp_apply, mlp_apply_split, mlp_apply_split_per_ray, mlp_init

# coordinate pairs used per plane, in order: (x,y), (x,z), (y,z)
DIMENSION_PAIRS: Tuple[Tuple[int, int], ...] = ((0, 1), (0, 2), (1, 2))


@dataclass(frozen=True)
class KPlanesFeatureField:
    feature_dim_per_plane: int = 32
    # nested resolutions ((r-1) doubling chain) so the "fused" lookup can
    # upsample all scales onto one fine grid EXACTLY; the reference uses
    # (128, 256, 512) (src/models.py:126-142) — +1 is a quality-neutral
    # layout deviation (0.8% more parameters)
    resolutions: Tuple[int, ...] = (129, 257, 513)
    # plane init range: U(0,1), the reference's torch uniform_
    # (src/models.py:99).  Tables are masked out of Adam weight decay
    # (train/loop.py _decay_mask), which otherwise flattens the sparsely-
    # supervised tables under this init.
    init_range: Tuple[float, float] = (0.0, 1.0)
    # lookup strategy (see ops/interp.py):
    #   "fused" — all scales of a projection exactly upsampled onto one fine
    #             grid, cell-packed: ONE gather + ONE scatter row per sample
    #             PER PROJECTION (3 total instead of 9).  Requires nested
    #             resolutions.
    #   "quad"  — cell-packed rows per plane: one gather/scatter row per
    #             sample per plane (9 total)
    #   "mixed" — 4 corner-row gathers fwd, exact f32 scatter bwd
    #   "plain" — straight autodiff (f32 everywhere)
    lookup_mode: str = "fused"
    # forward gather dtype ("bfloat16" | "float8" | "float32"); the backward
    # scatter always accumulates f32.
    gather_dtype: str = "bfloat16"
    # mixed mode only: backward scatter accumulation dtype
    scatter_dtype: str = "float32"
    # fused mode only: forward gather shape — "fusedfine" (ONE wide row per
    # sample per projection from the exactly-upsampled fused fine table) or
    # "perscale" (one narrow gather per scale, no extra midpoint rounding)
    fwd_mode: str = "perscale"
    # fused mode only: `(mesh_axis_name, n_devices)` to shard the backward
    # fine-gradient pullback over the mesh (ops/interp.py _sharded_pullback).
    # Set ONLY by the train step when cfg.shard_bwd is on — the field must
    # then be applied inside shard_map over that axis; grads become
    # per-device partials that the step's psum/psum_scatter completes.
    shard_bwd_axis: Optional[Tuple[str, int]] = None

    @property
    def feature_dim(self) -> int:
        return self.feature_dim_per_plane * len(self.resolutions)

    # optimizer param-group declaration (train/loop.py _decay_mask)
    @property
    def table_keys(self) -> frozenset:
        return frozenset({"planes"})

    @property
    def mlp_keys(self) -> frozenset:
        return frozenset()

    def init(self, key: jax.Array):
        keys = jax.random.split(key, len(self.resolutions) * len(DIMENSION_PAIRS))
        planes = []
        ki = 0
        for res in self.resolutions:
            scale_planes = []
            for _ in DIMENSION_PAIRS:
                lo, hi = self.init_range
                scale_planes.append(
                    jax.random.uniform(
                        keys[ki],
                        (res, res, self.feature_dim_per_plane),
                        jnp.float32,
                        lo,
                        hi,
                    )
                )
                ki += 1
            planes.append(scale_planes)
        return {"planes": planes}

    def apply(self, params, x: jax.Array, compute_dtype=jnp.float32) -> jax.Array:
        """x: [..., 3] in [-1,1] -> [..., feature_dim]."""
        return jnp.concatenate(
            self.apply_pieces(params, x, compute_dtype), axis=-1
        )

    def apply_pieces(
        self, params, x: jax.Array, compute_dtype=jnp.float32
    ) -> tuple:
        """Per-scale feature pieces ([..., f] x n_scales), NOT concatenated.

        The renderer feeds these straight into the decoders' split first
        layers (mlp_apply_split), so the [n_samples, 96] activation is never
        concatenated.  `apply` remains the concatenated-API form."""
        gd = {
            "bfloat16": jnp.bfloat16,
            "float8": jnp.float8_e4m3fn,
        }.get(self.gather_dtype, jnp.float32)
        if self.lookup_mode == "fused":
            return self._apply_fused(params, x, gd, compute_dtype)
        if self.lookup_mode == "quad":
            lookup = lambda p, c: bilinear_lookup_quad(p, c, gd)
        elif self.lookup_mode == "mixed":
            sd = jnp.bfloat16 if self.scatter_dtype == "bfloat16" else jnp.float32
            lookup = lambda p, c: bilinear_lookup_mixed(p, c, gd, sd)
        else:
            lookup = bilinear_lookup
        features = []
        for scale_planes in params["planes"]:
            acc = None
            for (i, j), plane in zip(DIMENSION_PAIRS, scale_planes):
                v = lookup(plane, x[..., jnp.array((i, j))])
                acc = v if acc is None else acc * v
            features.append(acc.astype(compute_dtype))
        return tuple(features)

    def _apply_fused(self, params, x, gather_dtype, compute_dtype):
        """Multiscale lookup over all projections in ONE custom VJP
        (ops/interp.py multiscale_lookup_multiproj): forward per fwd_mode
        (per-scale narrow gathers or one fused-fine wide gather per
        projection); backward accumulates the fused fine-table gradient
        with one scatter per projection, then pulls it back to the per-scale master
        tables through the exact-upsampling transpose.  Requires nested
        resolutions; identical values/gradients to per-scale lookups up to
        f32 rounding."""
        n_scales = len(self.resolutions)
        f = self.feature_dim_per_plane
        tables_by_proj = tuple(
            tuple(params["planes"][s][p_idx] for s in range(n_scales))
            for p_idx in range(len(DIMENSION_PAIRS))
        )
        coords_by_proj = tuple(
            x[..., jnp.array((i, j))] for (i, j) in DIMENSION_PAIRS
        )
        per_proj = multiscale_lookup_multiproj(
            tables_by_proj, coords_by_proj, gather_dtype,
            self.fwd_mode, self.shard_bwd_axis,
        )
        features = []
        for s in range(n_scales):
            acc = None
            for v in per_proj:
                vs = v[..., s * f : (s + 1) * f]
                acc = vs if acc is None else acc * vs
            features.append(acc.astype(compute_dtype))
        return tuple(features)

    def loss_tv(self, params) -> jax.Array:
        """Total-variation penalty, averaged over all planes.

        Computed on the [r, r*F] row-major view: the x-diff is a full-width
        row diff and the y-diff an F-element shift within rows (no cross-x
        pairs: the slice drops the last y) — the same element sets as the
        [r, r, F] axis diffs."""
        total = jnp.float32(0.0)
        count = 0
        for scale_planes in params["planes"]:
            for plane in scale_planes:
                r0, r1, f = plane.shape
                v = plane.reshape(r0, r1 * f)
                tv0 = jnp.mean((v[1:, :] - v[:-1, :]) ** 2)
                tv1 = jnp.mean((v[:, f:] - v[:, :-f]) ** 2)
                total = total + tv0 + tv1
                count += 1
        return total / count

    def loss_l1(self, params) -> jax.Array:
        total = jnp.float32(0.0)
        count = 0
        for scale_planes in params["planes"]:
            for plane in scale_planes:
                total = total + jnp.mean(jnp.abs(plane))
                count += 1
        return total / count

    # -- row-partitioned partials (sharded-table training, parallel/zero.py)
    #
    # sum over block_idx in [0, n_blocks) == the full loss (and, through
    # jax.grad, the full regularizer gradient) while each block touches only
    # ~1/n_blocks of every plane's rows — so under data-parallel shard_map
    # each device computes its block, the grads ride the SAME psum_scatter
    # as the data grads, and the table-sized regularizer compute divides by
    # the mesh instead of replicating.  Rows are blocked contiguously with a
    # one-row halo for the cross-row diff; block_idx may be traced
    # (jax.lax.axis_index).

    def loss_tv_partial(self, params, block_idx, n_blocks: int) -> jax.Array:
        total = jnp.float32(0.0)
        count = 0
        for scale_planes in params["planes"]:
            for plane in scale_planes:
                r0, r1, f = plane.shape
                w = r1 * f
                v = plane.reshape(r0, w)
                # cross-row pairs i in [0, r0-2], blocked by pair index
                q0 = -(-(r0 - 1) // n_blocks)
                s0 = jnp.clip(block_idx * q0, 0, r0 - 1 - q0)
                rows = jax.lax.dynamic_slice(v, (s0, 0), (q0 + 1, w))
                d = rows[1:, :] - rows[:-1, :]
                i0 = jax.lax.broadcasted_iota(jnp.int32, (q0, 1), 0) + s0
                m0 = (
                    (i0 >= block_idx * q0)
                    & (i0 < (block_idx + 1) * q0)
                    & (i0 < r0 - 1)
                )
                tv0 = jnp.sum(jnp.where(m0, d * d, 0.0)) / ((r0 - 1) * w)
                # within-row pairs, blocked by row index i in [0, r0-1]
                q1 = min(-(-r0 // n_blocks), r0)
                s1 = jnp.clip(block_idx * q1, 0, r0 - q1)
                rows = jax.lax.dynamic_slice(v, (s1, 0), (q1, w))
                dd = rows[:, f:] - rows[:, :-f]
                i1 = jax.lax.broadcasted_iota(jnp.int32, (q1, 1), 0) + s1
                m1 = (
                    (i1 >= block_idx * q1)
                    & (i1 < (block_idx + 1) * q1)
                    & (i1 < r0)
                )
                tv1 = jnp.sum(jnp.where(m1, dd * dd, 0.0)) / (r0 * (w - f))
                total = total + tv0 + tv1
                count += 1
        return total / count

    def loss_l1_partial(self, params, block_idx, n_blocks: int) -> jax.Array:
        total = jnp.float32(0.0)
        count = 0
        for scale_planes in params["planes"]:
            for plane in scale_planes:
                r0, r1, f = plane.shape
                w = r1 * f
                v = plane.reshape(r0, w)
                q = min(-(-r0 // n_blocks), r0)
                s = jnp.clip(block_idx * q, 0, r0 - q)
                rows = jax.lax.dynamic_slice(v, (s, 0), (q, w))
                i = jax.lax.broadcasted_iota(jnp.int32, (q, 1), 0) + s
                m = (i >= block_idx * q) & (i < (block_idx + 1) * q) & (i < r0)
                total = total + jnp.sum(jnp.where(m, jnp.abs(rows), 0.0)) / (
                    r0 * w
                )
                count += 1
        return total / count


@dataclass(frozen=True)
class KPlanesExplicitOpacityDecoder:
    """sigma = truncated_exp(<f, W f + b> - 1) — a learned bilinear form."""

    feature_dim: int
    fwd_clamp: bool = True

    def init(self, key: jax.Array):
        return {"linear": linear_init(key, self.feature_dim, self.feature_dim)}

    def apply(self, params, features, compute_dtype=jnp.float32) -> jax.Array:
        if isinstance(features, tuple):  # bilinear form needs the full vector
            features = jnp.concatenate(features, axis=-1)
        y = linear_apply(params["linear"], features, compute_dtype)
        x = jnp.sum(features.astype(compute_dtype) * y, axis=-1)
        return truncated_exp(x.astype(jnp.float32) - 1.0, self.fwd_clamp)


@dataclass(frozen=True)
class KPlanesExplicitColorDecoder:
    """rgb = sigmoid(<features, basis(dirs, features)>) with a learned [3, F] basis."""

    feature_dim: int
    n_freqs: int = 8
    hidden_dim: int = 128

    def init(self, key: jax.Array):
        in_dim = self.feature_dim + posenc_dim(3, self.n_freqs) + 3
        return {"mlp": mlp_init(key, in_dim, self.hidden_dim, 3, 3 * self.feature_dim)}

    def apply(
        self, params, features, rays_d: jax.Array, compute_dtype=jnp.float32
    ) -> jax.Array:
        if isinstance(features, tuple):  # the basis product needs the vector
            features = jnp.concatenate(features, axis=-1)
        pieces = (positional_encoding(rays_d, self.n_freqs), rays_d, features)
        basis = mlp_apply_split(params["mlp"], pieces, compute_dtype)
        basis = basis.reshape(*features.shape[:-1], 3, self.feature_dim)
        out = jnp.sum(features[..., None, :].astype(compute_dtype) * basis, axis=-1)
        return jax.nn.sigmoid(out.astype(jnp.float32))

    def apply_per_ray(
        self, params, features, d_ray: jax.Array, seg: jax.Array,
        compute_dtype=jnp.float32,
    ) -> jax.Array:
        """Forward-only serving variant: per-RAY direction branch + f32 row
        gather (see ColorDecoder.apply_per_ray / tools/probe_posenc_ray.py)."""
        if isinstance(features, tuple):
            features = jnp.concatenate(features, axis=-1)
        ray_pieces = (positional_encoding(d_ray, self.n_freqs), d_ray)
        basis = mlp_apply_split_per_ray(
            params["mlp"], ray_pieces, seg, (features,), compute_dtype
        )
        basis = basis.reshape(*features.shape[:-1], 3, self.feature_dim)
        out = jnp.sum(features[..., None, :].astype(compute_dtype) * basis, axis=-1)
        return jax.nn.sigmoid(out.astype(jnp.float32))

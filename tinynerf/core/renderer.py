"""Volumetric renderer: field + decoders + marcher + contraction + occupancy.

Capability parity with the reference's RayProvider + NerfRenderer
(src/core.py:158-267): march rays, jitter at train time, contract, cull by
occupancy, evaluate the field, compute transmittance weights, decode color
for surviving samples, alpha-composite per ray, and composite over an
optional background color.

Static-shape redesign — the central design decision of this framework
(SURVEY.md §2 #11): the reference packs surviving samples into a
DYNAMICALLY-sized ragged array, which is hostile to XLA.  Here there are two
static-shape paths:

  * `render_dense` — the [n_rays, n_samples] grid with a validity mask.  No
    compaction; every sample is evaluated.  Simple, fully fused by XLA; used
    for eval chunks and as the semantic reference.

  * `render_packed` — fixed-CAPACITY compaction.  Valid samples (in-box AND
    occupied) are gathered, in ray-major order, into a [cap] flat buffer via
    `jnp.nonzero(..., size=cap)`; the expensive field/decoder MLPs run only
    on those `cap` samples (constant FLOPs per step — the same goal as the
    reference's dynamic constant-sample batching, src/run.py:205-244, but
    with static shapes).  The per-ray transmittance scan runs directly on the
    packed layout (ops/weights.py compute_weights_packed), and weighted
    colors are reduced per-ray with a segment-sum (the reference's
    index_add_, src/core.py:256-259).  Rays whose samples did not all fit in
    the buffer are flagged invalid so the loss can exclude them.

Rays with zero valid samples render the background color and stay valid —
matching the reference, where empty rays legitimately supervise toward bg.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..models.cobafa import CobafaFeatureField
from ..ops.hashrng import hash_u01
from ..ops.weights import compute_weights, compute_weights_packed
from .contraction import ContractionAABB, ContractionMip360
from .marching import RayMarcherAABB, RayMarcherUnbounded
from .occupancy import OccupancyGrid, OccupancyState
from .skipmarch import (
    make_skip_grid,
    make_skip_grid_iso,
    skip_march,
    skip_march_unbounded,
)


class RenderOutput(NamedTuple):
    rgb: jax.Array        # [n_rays, 3] composited colors
    opacity: jax.Array    # [n_rays] sum of weights
    ray_valid: jax.Array  # [n_rays] float32; 0 where the packed buffer overflowed
    n_samples: jax.Array  # scalar int32: valid samples this batch (fill metric)
    # scalar int32: rays that finished marching (== n_rays on the dense path;
    # may be lower on the skip path when the scan-step budget ran out — the
    # training loop watches this and falls back to dense marching)
    n_complete: jax.Array = None


@dataclass(frozen=True)
class NerfRenderer:
    field: Any
    sigma_decoder: Any
    rgb_decoder: Any
    marcher: Union[RayMarcherAABB, RayMarcherUnbounded]
    contraction: Union[ContractionAABB, ContractionMip360]
    occupancy: Optional[OccupancyGrid] = None
    bg_color: Optional[Tuple[float, float, float]] = None
    early_termination: float = 1e-4
    compute_dtype: Any = jnp.float32
    # rematerialize the feature field in the backward pass — trades one extra
    # forward for not holding per-layer activations of cap samples in device
    # memory (the wide vanilla MLP at large caps; train/loop.py build_renderer)
    remat_field: bool = False
    # scan-step budget for the empty-space-skipping marcher (core/skipmarch):
    # each step gathers one skip value per ray; rays needing more steps than
    # this are flagged incomplete and excluded from the loss.  The training
    # loop only selects the skip path when the demand estimate leaves ample
    # margin under this budget.
    skip_steps: int = 96

    # ---------------------------------------------------------------- params

    def init(self, key: jax.Array) -> dict:
        kf, ks, kr = jax.random.split(key, 3)
        return {
            "field": self.field.init(kf),
            "sigma": self.sigma_decoder.init(ks),
            "rgb": self.rgb_decoder.init(kr),
        }

    # ------------------------------------------------------------- sub-fns

    def _field_apply(self, params, x, dropout_key=None):
        if isinstance(self.field, CobafaFeatureField):
            fn = lambda p, xx: self.field.apply(
                p, xx, self.compute_dtype, dropout_key=dropout_key
            )
        elif hasattr(self.field, "apply_pieces"):
            # per-scale feature pieces flow into the decoders' split first
            # layers concat-free (models/mlp.py mlp_apply_split)
            fn = lambda p, xx: self.field.apply_pieces(p, xx, self.compute_dtype)
        else:
            fn = lambda p, xx: self.field.apply(p, xx, self.compute_dtype)
        if self.remat_field:
            fn = jax.checkpoint(fn)
        return fn(params["field"], x)

    def sigma_fn(self, params, x: jax.Array) -> jax.Array:
        """Density at contracted coords [n,3] -> [n]; feeds occupancy updates."""
        feats = self._field_apply(params, x)
        return self.sigma_decoder.apply(params["sigma"], feats, self.compute_dtype)

    def _march(self, rays_o, rays_d, occ_state, key):
        """Shared front half: sample positions + validity mask. No grads.

        Jitter comes from the stateless per-(ray, sample) hash so the dense
        and skip marching paths produce bit-identical sample positions."""
        n_rays = rays_o.shape[0]
        t, deltas = self.marcher(rays_o, rays_d)
        if key is not None:
            jkey = jax.random.fold_in(key, 0)
            u = hash_u01(
                jkey,
                jnp.arange(n_rays, dtype=jnp.int32)[:, None],
                jnp.arange(t.shape[1], dtype=jnp.int32)[None, :],
            )
            t = t + u * deltas
        pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        cpos, maskf = self.contraction(pos)
        if self.occupancy is not None and occ_state is not None:
            maskf = maskf * self.occupancy.query(occ_state, cpos)
        return cpos, deltas, maskf

    # ------------------------------------------------------- skip marching

    @property
    def supports_skip_march(self) -> bool:
        if self.occupancy is None:
            return False
        # skip grids are built from, and probed at, NEAREST-voxel occupancy;
        # with trilinear occupancy queries the dense path culls by a
        # different (interpolated) criterion, so the skip/dense sample-set
        # equality the training loop's complete_frac guard assumes would
        # silently break mid-run — force dense marching instead
        if self.occupancy.interp != "nearest":
            return False
        aabb = isinstance(self.marcher, RayMarcherAABB) and isinstance(
            self.contraction, ContractionAABB
        )
        unbounded = isinstance(self.marcher, RayMarcherUnbounded) and isinstance(
            self.contraction, ContractionMip360
        )
        return aabb or unbounded

    def skip_grid(self, occ_state: OccupancyState) -> jax.Array:
        """Precompute the skip grid(s) from the (thresholded) occupancy state:
        directional cone grids for straight (AABB) contracted-space rays, an
        isotropic Chebyshev grid for the curved Mip-360 paths.

        Recomputed once per occupancy update by the training loop and fed to
        `render_packed(march="skip")`; a pure function of the state, so it is
        never checkpointed."""
        assert self.supports_skip_march
        thr = self.occupancy._threshold(occ_state)
        if isinstance(self.marcher, RayMarcherUnbounded):
            return make_skip_grid_iso(occ_state.grid > thr)
        return make_skip_grid(occ_state.grid > thr)

    def _march_skip(self, rays_o, rays_d, skip_grid, key):
        """Skip-marching front half: candidate grid [R, skip_steps] whose
        valid entries are EXACTLY the dense path's surviving samples, plus a
        per-ray completeness flag (False = step budget exhausted)."""
        jkey = jax.random.fold_in(key, 0) if key is not None else None
        n_rays = rays_o.shape[0]

        if isinstance(self.marcher, RayMarcherUnbounded):
            k_idx, complete = skip_march_unbounded(
                rays_o, rays_d, self.marcher, self.contraction,
                skip_grid, jkey, self.skip_steps,
            )
            maskb = k_idx >= 0
            kk = jnp.maximum(k_idx, 0)
            # positions/deltas via the same closed-form grid the scan used
            t_grid, d_grid = self.marcher._grid()
            t_lo = jnp.asarray(t_grid)[kk]
            deltas = jnp.asarray(d_grid)[kk]
        else:
            t_min, t_exit = self.marcher.entry_exit(rays_o, rays_d)
            k_idx, complete = skip_march(
                rays_o, rays_d, t_min, t_exit,
                self.marcher.step_size, self.marcher.n_samples,
                self.contraction, skip_grid, jkey, self.skip_steps,
            )
            maskb = k_idx >= 0
            kk = jnp.maximum(k_idx, 0)
            t_lo = t_min[:, None] + kk.astype(jnp.float32) * jnp.float32(
                self.marcher.step_size
            )
            deltas = jnp.full(kk.shape, self.marcher.step_size, jnp.float32)

        if jkey is not None:
            u = hash_u01(
                jkey, jnp.arange(n_rays, dtype=jnp.int32)[:, None], kk
            )
            t = t_lo + u * deltas
        else:
            t = t_lo
        pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        cpos, _ = self.contraction(pos)
        return cpos, deltas, maskb.astype(jnp.float32), complete

    def _composite(self, weighted_rgb_sum, opacity):
        if self.bg_color is not None:
            bg = jnp.array(self.bg_color, dtype=jnp.float32)
            return weighted_rgb_sum + bg * (1.0 - opacity[..., None])
        return weighted_rgb_sum

    # ---------------------------------------------------------- dense path

    def render_dense(
        self,
        params: dict,
        occ_state: Optional[OccupancyState],
        rays_o: jax.Array,
        rays_d: jax.Array,
        key: Optional[jax.Array] = None,
    ) -> RenderOutput:
        cpos, deltas, maskf = self._march(rays_o, rays_d, occ_state, key)
        dkey = jax.random.fold_in(key, 1) if key is not None else None

        feats = self._field_apply(params, cpos, dropout_key=dkey)
        sigmas = self.sigma_decoder.apply(params["sigma"], feats, self.compute_dtype)
        w = compute_weights(sigmas, deltas, maskf, self.early_termination)

        dirs = jnp.broadcast_to(rays_d[:, None, :], cpos.shape)
        rgbs = self.rgb_decoder.apply(params["rgb"], feats, dirs, self.compute_dtype)

        acc_rgb = jnp.sum(w[..., None] * rgbs, axis=-2)
        opacity = jnp.sum(w, axis=-1)
        return RenderOutput(
            rgb=self._composite(acc_rgb, opacity),
            opacity=opacity,
            ray_valid=jnp.ones(rays_o.shape[0], dtype=jnp.float32),
            n_samples=jnp.sum(maskf).astype(jnp.int32),
            n_complete=jnp.int32(rays_o.shape[0]),
        )

    # --------------------------------------------------------- packed path

    def render_packed(
        self,
        params: dict,
        occ_state: Optional[OccupancyState],
        rays_o: jax.Array,
        rays_d: jax.Array,
        cap: int,
        key: Optional[jax.Array] = None,
        march: str = "dense",
        skip_grid: Optional[jax.Array] = None,
        rgb_dir_branch: str = "sample",
    ) -> RenderOutput:
        """Fixed-capacity packed rendering.

        `rgb_dir_branch="ray"` computes the rgb decoder's direction branch
        (posenc + dir first-layer contraction) once per RAY and row-gathers
        it to the samples — a FORWARD-ONLY optimization for serving/eval
        (its backward would be a cap-row segment reduction in place of one
        weight-grad matmul: tools/probe_posenc_ray.py).  Training uses the
        default "sample" branch.

        `march="dense"` evaluates the validity mask at all n_samples marched
        positions (the reference's semantics, brute force).  `march="skip"`
        uses the empty-space-skipping marcher (core/skipmarch.py) with the
        precomputed `skip_grid` — the same surviving-sample set found in
        ~skip_steps scan steps per ray instead of n_samples point queries;
        rays that exhaust the step budget are flagged invalid for the loss.
        """
        n_rays = rays_o.shape[0]
        if march == "skip":
            assert skip_grid is not None, "march='skip' needs a skip_grid"
            cpos, deltas, maskf, complete = self._march_skip(
                rays_o, rays_d, skip_grid, key
            )
            n_samples = self.skip_steps  # candidate-grid width
        else:
            cpos, deltas, maskf = self._march(rays_o, rays_d, occ_state, key)
            complete = None
            n_samples = self.marcher.n_samples
        total = n_rays * n_samples

        dkey = jax.random.fold_in(key, 1) if key is not None else None
        maskb = maskf > 0.0

        # --- compaction: first `cap` valid samples, ray-major order: top_k
        # partial selection over (index if valid else total), exactly
        # equivalent to jnp.nonzero(size=cap) including the pad fill.
        iota = jax.lax.broadcasted_iota(jnp.int32, (total,), 0)
        keys = jnp.where(maskb.reshape(-1), iota, jnp.int32(total))
        k = min(cap, total)  # top_k requires k <= input size
        neg_vals, _ = jax.lax.top_k(-keys, k)
        valid_idx = -neg_vals
        if k < cap:  # cap exceeds the candidate grid: pad like nonzero would
            valid_idx = jnp.concatenate(
                [valid_idx, jnp.full((cap - k,), total, jnp.int32)]
            )
        is_pad = valid_idx >= total
        safe_idx = jnp.where(is_pad, 0, valid_idx)
        seg_ids = jnp.where(is_pad, n_rays, safe_idx // n_samples)

        cpos_cap = cpos.reshape(total, 3)[safe_idx]
        dirs_cap = rays_d[jnp.where(is_pad, 0, seg_ids)]

        # --- expensive MLPs run on exactly `cap` samples
        feats_cap = self._field_apply(params, cpos_cap, dropout_key=dkey)
        sigma_cap = self.sigma_decoder.apply(params["sigma"], feats_cap, self.compute_dtype)

        # --- transmittance scan directly on the packed layout: per-ray
        # segmented scans over the contiguous runs (the reference's packed
        # CUDA kernel, with no scatter-to-dense round trip)
        counts = jnp.sum(maskb, axis=-1, dtype=jnp.int32)
        w_cap = compute_weights_packed(
            sigma_cap.astype(jnp.float32),
            deltas.reshape(total)[safe_idx],
            counts,
            self.early_termination,
        )

        if rgb_dir_branch == "ray" and hasattr(self.rgb_decoder, "apply_per_ray"):
            rgbs_cap = self.rgb_decoder.apply_per_ray(
                params["rgb"], feats_cap, rays_d,
                jnp.where(is_pad, 0, seg_ids), self.compute_dtype,
            )
        else:
            rgbs_cap = self.rgb_decoder.apply(params["rgb"], feats_cap, dirs_cap, self.compute_dtype)

        # --- per-ray reduction (the reference's index_add_, as a segment sum;
        # pad rows land in segment n_rays and are sliced away)
        acc_rgb = jax.ops.segment_sum(
            w_cap[:, None] * rgbs_cap, seg_ids, num_segments=n_rays + 1
        )[:n_rays]
        opacity = jax.ops.segment_sum(w_cap, seg_ids, num_segments=n_rays + 1)[:n_rays]

        # --- rays whose samples spilled past `cap` are excluded from loss;
        # zero-sample rays render exact bg regardless of position, so they
        # always stay valid (they supervise toward the background).  Skip-
        # marched rays that ran out of scan steps are likewise excluded
        # (their sample set is incomplete).
        ends = jnp.cumsum(counts)
        ray_valid = ((ends <= cap) | (counts == 0)).astype(jnp.float32)
        if complete is not None:
            ray_valid = ray_valid * complete.astype(jnp.float32)

        return RenderOutput(
            rgb=self._composite(acc_rgb, opacity),
            opacity=opacity,
            ray_valid=ray_valid,
            n_samples=jnp.minimum(jnp.sum(counts), cap).astype(jnp.int32),
            n_complete=(
                jnp.sum(complete).astype(jnp.int32)
                if complete is not None
                else jnp.int32(n_rays)
            ),
        )

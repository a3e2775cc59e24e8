"""Vanilla NeRF field + the shared sigma/color decoders.

Parity (reference src/models.py:59-89):
  * VanillaFeatureField:  posenc(n_freqs) -> MLP(hidden, layers); feature_dim
    = hidden_features.  train() config (10, 256, 8).
  * OpacityDecoder: MLP(dim -> 64 -> 1, no extra hidden) then
    truncated_exp(x - 1) => sigma >= 0.  Used by ALL three methods.
  * ColorDecoder: concat(posenc(d), d, features) -> MLP -> sigmoid.
    train() config (8, dim, 64, 3) for all methods.

Each module is a frozen dataclass of STATIC config with pure `init`/`apply`
(params are plain pytrees), so a renderer closing over these modules jits
cleanly and shards with pjit/shard_map.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..ops.trunc_exp import truncated_exp
from .encodings import posenc_dim, positional_encoding
from .mlp import mlp_apply, mlp_apply_split, mlp_apply_split_per_ray, mlp_init


@dataclass(frozen=True)
class VanillaFeatureField:
    n_freqs: int = 10
    hidden_features: int = 256
    hidden_layers: int = 8
    # "he" (default) keeps positional signal alive through the 10-layer
    # stack; "torch" replicates the reference init, under which the field is
    # near-constant at init (measured ~3x signal decay per layer) and fails
    # to differentiate positions during training
    init_mode: str = "he"

    @property
    def feature_dim(self) -> int:
        return self.hidden_features

    # optimizer param-group declaration (train/loop.py _decay_mask): which
    # top-level param keys hold raw feature TABLES (excluded from weight
    # decay, optionally split-lr) vs MLP/linear weights.  Declared by each
    # field so a new field cannot silently fall in the wrong group.
    @property
    def table_keys(self) -> frozenset:
        return frozenset()

    @property
    def mlp_keys(self) -> frozenset:
        return frozenset({"mlp"})

    def init(self, key: jax.Array):
        return {
            "mlp": mlp_init(
                key,
                posenc_dim(3, self.n_freqs),
                self.hidden_features,
                self.hidden_layers,
                init=self.init_mode,
            )
        }

    def apply(self, params, x: jax.Array, compute_dtype=jnp.float32) -> jax.Array:
        enc = positional_encoding(x, self.n_freqs)
        return mlp_apply(params["mlp"], enc, compute_dtype)


@dataclass(frozen=True)
class OpacityDecoder:
    feature_dim: int
    hidden_features: int = 64
    # static A/B switch threaded from TrainConfig.fwd_clamp (see ops/trunc_exp)
    fwd_clamp: bool = True

    def init(self, key: jax.Array):
        return {"mlp": mlp_init(key, self.feature_dim, self.hidden_features, 0, 1)}

    def apply(self, params, features, compute_dtype=jnp.float32) -> jax.Array:
        """features: [..., F] (or a tuple of pieces summing to F, fed to the
        split first layer concat-free) -> sigma [...] (last dim squeezed)."""
        pieces = features if isinstance(features, tuple) else (features,)
        x = mlp_apply_split(params["mlp"], pieces, compute_dtype)
        return truncated_exp(x.astype(jnp.float32) - 1.0, self.fwd_clamp)[..., 0]


@dataclass(frozen=True)
class ColorDecoder:
    n_freqs: int
    in_features: int
    hidden_features: int = 64
    hidden_layers: int = 3

    def init(self, key: jax.Array):
        total = self.in_features + posenc_dim(3, self.n_freqs) + 3
        return {"mlp": mlp_init(key, total, self.hidden_features, self.hidden_layers, 3)}

    def apply(
        self, params, features, rays_d: jax.Array, compute_dtype=jnp.float32
    ) -> jax.Array:
        """(features [..., F] or tuple of pieces, dirs [..., 3]) ->
        rgb [..., 3] in (0, 1).

        The [posenc | dirs | features] concat the reference feeds its MLP
        (src/models.py:84-88) is computed as a split first layer instead,
        so the [n, 86] activation is never concatenated (mlp_apply_split)."""
        feat = features if isinstance(features, tuple) else (features,)
        pieces = (positional_encoding(rays_d, self.n_freqs), rays_d) + feat
        out = mlp_apply_split(params["mlp"], pieces, compute_dtype)
        return jax.nn.sigmoid(out.astype(jnp.float32))

    def apply_per_ray(
        self, params, features, d_ray: jax.Array, seg: jax.Array,
        compute_dtype=jnp.float32,
    ) -> jax.Array:
        """Forward-only serving variant: the direction branch (posenc + dir
        first-layer contraction) is computed once per RAY (d_ray [n_rays, 3])
        and row-gathered to the sample rows via `seg` — directions are
        constant per ray, so this does ~16.7x fewer posenc rows at the cost
        of one f32 row gather (the training path keeps `apply`;
        tools/probe_posenc_ray.py)."""
        feat = features if isinstance(features, tuple) else (features,)
        ray_pieces = (positional_encoding(d_ray, self.n_freqs), d_ray)
        out = mlp_apply_split_per_ray(
            params["mlp"], ray_pieces, seg, feat, compute_dtype
        )
        return jax.nn.sigmoid(out.astype(jnp.float32))

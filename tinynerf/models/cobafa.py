"""Cobafa field: cosine/periodic basis factorization (arXiv 2302.01226).

Parity (reference src/models.py:209-266): L basis grids of increasing
resolution, each queried at sawtooth-tiled coordinates sawtooth_f(x) and
scaled by channel i of a trilinearly-interpolated coefficient grid; the
concatenated features pass through Dropout(p=0.01) and an MLP with 5 hidden
layers whose width is the field's feature_dim.

train() config (reference src/run.py:141-147): basis_res = linspace(32,128,6)
rounded to int, coef_res = 64, freqs = linspace(2,8,6), channels
[8,8,8,4,4,4], mlp_hidden_dim = 128.

Grids are stored feature-last ([r,r,r,C]) for row-gather trilinear lookups.
Dropout is a pure function of an explicit rng key (train mode only); eval is
the identity, matching torch semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.interp import (
    sawtooth,
    trilinear_lookup,
    trilinear_lookup_mixed,
    trilinear_lookup_oct,
)
from .mlp import mlp_apply_split, mlp_init


@dataclass(frozen=True)
class CobafaFeatureField:
    basis_res: Tuple[int, ...] = (32, 51, 70, 89, 108, 128)
    coef_res: int = 64
    freqs: Tuple[float, ...] = (2.0, 3.2, 4.4, 5.6, 6.8, 8.0)
    channels: Tuple[int, ...] = (8, 8, 8, 4, 4, 4)
    mlp_hidden_dim: int = 128
    dropout_p: float = 0.01
    # see KPlanesFeatureField.lookup_mode / gather_dtype / scatter_dtype.
    # "mixed" = 8 corner-row bf16 gathers forward, exact f32 scatter
    # backward; "quad" = cell-packed oct rows (ONE row gather and ONE
    # scatter row per sample per grid, plus a per-step rebuild of the packed
    # table); "plain" = straight autodiff in f32.
    lookup_mode: str = "mixed"  # mixed | quad | plain
    gather_dtype: str = "bfloat16"
    scatter_dtype: str = "float32"
    # grid init range: basis x coefficient is a two-factor product, so the
    # same self-kill dynamic as K-Planes applies under U(0,1) init (see
    # KPlanesFeatureField.init_range); U(0.5,1.5) keeps products near 1.
    # The reference's torch uniform_ = U(0,1) is available via (0.0, 1.0).
    init_range: Tuple[float, float] = (0.5, 1.5)
    # deep (7-linear-layer) MLP: He init keeps feature signal alive;
    # "torch" replicates the reference default
    mlp_init_mode: str = "he"

    def __post_init__(self):
        assert len(self.basis_res) == len(self.freqs) == len(self.channels)

    @property
    def feature_dim(self) -> int:
        return self.mlp_hidden_dim

    @property
    def n_levels(self) -> int:
        return len(self.basis_res)

    # optimizer param-group declaration (train/loop.py _decay_mask)
    @property
    def table_keys(self) -> frozenset:
        return frozenset({"basis", "coef"})

    @property
    def mlp_keys(self) -> frozenset:
        return frozenset({"mlp"})

    def init(self, key: jax.Array):
        keys = jax.random.split(key, self.n_levels + 2)
        lo, hi = self.init_range
        basis = [
            jax.random.uniform(keys[i], (r, r, r, c), jnp.float32, lo, hi)
            for i, (r, c) in enumerate(zip(self.basis_res, self.channels))
        ]
        coef = jax.random.uniform(
            keys[self.n_levels],
            (self.coef_res, self.coef_res, self.coef_res, self.n_levels),
            jnp.float32,
            lo,
            hi,
        )
        mlp = mlp_init(
            keys[self.n_levels + 1],
            sum(self.channels),
            self.mlp_hidden_dim,
            5,
            init=self.mlp_init_mode,
        )
        return {"basis": basis, "coef": coef, "mlp": mlp}

    def apply(
        self,
        params,
        x: jax.Array,
        compute_dtype=jnp.float32,
        dropout_key: Optional[jax.Array] = None,
    ) -> jax.Array:
        """x: [..., 3] in [-1,1] -> [..., feature_dim].

        `dropout_key` enables train-mode dropout; None = eval (identity).
        """
        gd = jnp.bfloat16 if self.gather_dtype == "bfloat16" else jnp.float32
        mode = self.lookup_mode
        if mode == "quad":
            lookup = lambda t, c: trilinear_lookup_oct(t, c, gd)
        elif mode == "mixed":
            sd = jnp.bfloat16 if self.scatter_dtype == "bfloat16" else jnp.float32
            lookup = lambda t, c: trilinear_lookup_mixed(t, c, gd, sd)
        else:
            lookup = trilinear_lookup
        coefs = lookup(params["coef"], x)  # [..., L]
        # per-level features stay SEPARATE all the way into the MLP's split
        # first layer (mlp_apply_split), so the [n, sum(channels)] activation
        # is never concatenated.  Dropout draws per level from a folded key — the same iid
        # Bernoulli(p) mask semantics as the reference's Dropout over the
        # concatenated features (src/models.py:259), different rng stream.
        feats = []
        for i, (f, basis) in enumerate(zip(self.freqs, params["basis"])):
            y = lookup(basis, sawtooth(x, f)) * coefs[..., i : i + 1]
            if dropout_key is not None and self.dropout_p > 0.0:
                keep = jax.random.bernoulli(
                    jax.random.fold_in(dropout_key, i),
                    1.0 - self.dropout_p,
                    y.shape,
                )
                y = jnp.where(keep, y / (1.0 - self.dropout_p), 0.0)
            feats.append(y)
        return mlp_apply_split(params["mlp"], feats, compute_dtype)

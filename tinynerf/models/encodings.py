"""Input encodings: NeRF positional (frequency) encoding.

Parity: reference PositionalEncoding (src/models.py:30-39) — frequencies
2^k * pi for k in [0, n_freqs), concat(sin, cos) per coordinate, flattened so
the layout per input coordinate is [sin(f0 x)..sin(fK x), cos(f0 x)..cos(fK x)].
Output dim = in_dim * 2 * n_freqs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# A/B hook (tools/probe_decoders.py): "matmul" = the one-hot-frequency form
# below; "stack" = the reference-shaped stack/concat/reshape chain
_IMPL = "matmul"


def positional_encoding(x: jax.Array, n_freqs: int) -> jax.Array:
    """x: [..., d] -> [..., d * 2 * n_freqs].

    Built by two one-hot-frequency matmuls instead of the
    stack/concat/reshape chain (which materializes K-minor intermediates
    and a concat over the full [n_samples, out] activation).  sin(x @ E_s) is exactly sin(f_k * x_i) on
    its selected lane and sin(0) = 0 elsewhere; the cos term is masked
    because cos(0) = 1.  Bit-identical to the stack/concat form (each lane
    is a single exact product), layout-clean everywhere.
    """
    d = x.shape[-1]
    k = n_freqs
    out = 2 * k * d
    if _IMPL == "stack":
        freqs = jnp.asarray((2.0 ** np.arange(k)) * np.pi, dtype=x.dtype)
        xf = x[..., None] * freqs  # [..., d, K]
        enc = jnp.concatenate([jnp.sin(xf), jnp.cos(xf)], axis=-1)
        return enc.reshape(*x.shape[:-1], out)
    freqs = (2.0 ** np.arange(k)) * np.pi
    # E_s[i, i*2K + j]   = f_j   (sin lanes)
    # E_c[i, i*2K+K + j] = f_j   (cos lanes)
    e_s = np.zeros((d, out), np.float32)
    e_c = np.zeros((d, out), np.float32)
    cos_mask = np.zeros((out,), np.float32)
    for i in range(d):
        e_s[i, i * 2 * k : i * 2 * k + k] = freqs
        e_c[i, i * 2 * k + k : (i + 1) * 2 * k] = freqs
        cos_mask[i * 2 * k + k : (i + 1) * 2 * k] = 1.0
    dt = x.dtype
    # HIGHEST: default f32 matmuls may round their inputs (TF32 on the GPU,
    # bf16 passes elsewhere) — these products must be the exact f32
    # f_j * x_i the reference computes elementwise (chip_smoke.py checks)
    xs = jnp.dot(x, jnp.asarray(e_s, dt), precision=jax.lax.Precision.HIGHEST,
                 preferred_element_type=dt)
    xc = jnp.dot(x, jnp.asarray(e_c, dt), precision=jax.lax.Precision.HIGHEST,
                 preferred_element_type=dt)
    return jnp.sin(xs) + jnp.cos(xc) * jnp.asarray(cos_mask, dt)


def posenc_dim(in_dim: int, n_freqs: int) -> int:
    return in_dim * 2 * n_freqs

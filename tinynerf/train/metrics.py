"""Training/eval metrics.

Parity: psnr / TrainMetrics / EvalMetrics (reference src/run.py:53-81) with
one upgrade — the reference declares an `ssim` field but never computes it
(SURVEY.md §2 #33); here SSIM is actually implemented (standard 11x11
Gaussian-window SSIM, Wang et al. 2004).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


def psnr(x: jax.Array, y: jax.Array) -> jax.Array:
    return -10.0 * jnp.log10(jnp.mean((x - y) ** 2))


@dataclass
class TrainMetrics:
    loss: float = 0.0
    occupancy: float = 1.0


@dataclass
class EvalMetrics:
    mse_loss: float = 0.0
    psnr: float = 0.0
    ssim: float = 0.0


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def ssim(x: jax.Array, y: jax.Array, max_val: float = 1.0) -> jax.Array:
    """SSIM between two [h, w, c] images in [0, max_val]."""
    k = jnp.asarray(_gaussian_kernel())[:, :, None, None]  # HWIO, per-channel

    def filt(img):
        # depthwise 11x11 gaussian via one conv per channel
        chans = [
            jax.lax.conv_general_dilated(
                img[None, :, :, c : c + 1],
                k,
                window_strides=(1, 1),
                padding="VALID",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                # fp32 accumulation is load-bearing: the variance terms are
                # differences of O(1) quantities; reduced-precision convs
                # (bf16/TF32 defaults) turn them into noise (SSIM > 1)
                precision=jax.lax.Precision.HIGHEST,
            )
            for c in range(img.shape[-1])
        ]
        return jnp.concatenate(chans, axis=-1)[0]

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    mu_x = filt(x)
    mu_y = filt(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x2 = filt(x * x) - mu_x2
    sigma_y2 = filt(y * y) - mu_y2
    sigma_xy = filt(x * y) - mu_xy

    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sigma_x2 + sigma_y2 + c2)
    return jnp.mean(num / den)


def eval_metrics(pred: np.ndarray, target: np.ndarray) -> EvalMetrics:
    """Full-image eval: MSE, PSNR, SSIM. Inputs [h, w, 3] in [0,1]."""
    p = jnp.asarray(pred)
    t = jnp.asarray(target)
    mse = float(jnp.mean((p - t) ** 2))
    return EvalMetrics(
        mse_loss=mse,
        psnr=float(psnr(p, t)),
        ssim=float(ssim(p, t)),
    )

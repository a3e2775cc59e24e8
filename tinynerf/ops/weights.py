"""Per-ray transmittance / rendering-weights op — the framework's hot kernel.

This rebuilds the reference's single native component, the CUDA
`compute_weights` fwd/bwd kernels (reference src/cuda.cu:3-58): per ray,
with alpha_k = exp(-sigma_k * delta_k),

    w_k = T_k * (1 - alpha_k),      T_k = prod_{j<k} alpha_j,

with early termination once T drops below a threshold (remaining weights are
exactly zero), and the closed-form backward

    dL/dsigma_i = delta_i * (T_{i+1} g_i - sum_{k>i} w_k g_k).

Two layouts:

  * dense `[n_rays, n_samples]` (`compute_weights`): invalid samples are
    masked to sigma*delta = 0 (alpha = 1, contributing nothing).  The per-ray
    scan is a row-wise cumulative sum and early termination a mask
    (T <= threshold => w = 0).  Used by the dense render path and as the
    numeric reference for the packed op.
  * packed `[cap]` (`compute_weights_packed`): the renderer's compacted
    sample buffer, ray-major, each ray a contiguous run.  On CUDA devices it
    lowers to the per-ray-walk Triton kernel (ops/weights_triton.py, the
    reference's one-thread-per-ray design); elsewhere to the plain XLA form
    `compute_weights_packed_xla`, whose per-ray scans are SEGMENTED scans
    (`lax.associative_scan` over (value, segment-start) pairs).  Either way
    every partial sum is segment-local: the buffer's total optical depth
    (~1e5 at the flagship budget) never enters a difference, which a
    global-cumsum-minus-offset formulation would lose to float32
    cancellation.

All dense functions take `mask` as float32 (1.0 = valid) so the custom VJP
has a well-defined (zero) cotangent for it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def compute_weights_naive(sigmas, deltas, maskf, threshold=0.0):
    """Straight-line jnp implementation — differentiable via plain autodiff.

    Used as the numeric ground truth in tests; not called in the hot path.
    """
    s = sigmas * deltas * maskf
    c_incl = jnp.cumsum(s, axis=-1)
    t_before = jnp.exp(-(c_incl - s))  # transmittance BEFORE sample k
    alpha = 1.0 - jnp.exp(-s)
    w = t_before * alpha
    return jnp.where((maskf > 0.0) & (t_before > threshold), w, 0.0)


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def compute_weights(sigmas, deltas, maskf, threshold=1e-4):
    """Rendering weights with the closed-form backward (gradients flow to
    `sigmas` only; `deltas`/`maskf` get zero cotangents, matching the
    reference autograd bridge that returns None for steps/info)."""
    return compute_weights_naive(sigmas, deltas, maskf, threshold)


def _weights_fwd(sigmas, deltas, maskf, threshold):
    w = compute_weights_naive(sigmas, deltas, maskf, threshold)
    return w, (sigmas, deltas, maskf, w)


def _weights_bwd(threshold, res, g):
    sigmas, deltas, maskf, w = res
    s = sigmas * deltas * maskf
    wg = w * g
    incl = jnp.cumsum(wg, axis=-1)
    total = incl[..., -1:]
    # acc_k = -sum_{j>k} w_j g_j   (reference src/cuda.cu:49-53 vectorized)
    acc = incl - total
    t_incl = jnp.exp(-jnp.cumsum(s, axis=-1))  # transmittance AFTER sample k
    grad_sigmas = deltas * (acc + t_incl * g) * maskf
    return grad_sigmas, jnp.zeros_like(deltas), jnp.zeros_like(maskf)


compute_weights.defvjp(_weights_fwd, _weights_bwd)


# --------------------------------------------------------------------------
# Packed layout
# --------------------------------------------------------------------------


def packed_runs(counts, cap: int):
    """Per-ray (start, length) of each run in a `[cap]` ray-major buffer.

    counts: [n_rays] int32 samples per ray, in buffer order.  Ray r owns
    [sum(counts[:r]), sum(counts[:r + 1])), clipped to the buffer: a ray
    that spills past `cap` keeps its leading samples, later rays get none."""
    ends = jnp.cumsum(counts.astype(jnp.int32))
    starts = ends - counts
    starts = jnp.minimum(starts, cap)
    return starts, jnp.minimum(ends, cap) - starts


def _segmented_cumsum(x, flags, reverse=False):
    """Inclusive cumulative sum that restarts wherever `flags` is set
    (segment starts for a forward scan, segment ends for `reverse`)."""

    def combine(a, b):
        xa, fa = a
        xb, fb = b
        return jnp.where(fb, xb, xa + xb), fa | fb

    out, _ = jax.lax.associative_scan(combine, (x, flags), reverse=reverse)
    return out


def _run_flags(counts, cap):
    """(valid, first, last) [cap] bool masks of the packed layout."""
    starts, lens = packed_runs(counts, cap)
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < (starts[-1] + lens[-1])
    live = lens > 0
    first = jnp.zeros(cap, bool).at[jnp.where(live, starts, cap)].set(
        True, mode="drop"
    )
    last = jnp.zeros(cap, bool).at[jnp.where(live, starts + lens - 1, cap)].set(
        True, mode="drop"
    )
    return valid, first, last


def _packed_fwd_math(sigmas, deltas, counts, threshold):
    valid, first, last = _run_flags(counts, sigmas.shape[0])
    s = jnp.where(valid, sigmas * deltas, 0.0)
    c = _segmented_cumsum(s, first)  # inclusive, segment-local optical depth
    t_before = jnp.exp(-(c - s))
    alpha = 1.0 - jnp.exp(-s)
    w = jnp.where(valid & (t_before > threshold), t_before * alpha, 0.0)
    return w, (valid, last, c)


def compute_weights_packed(sigmas, deltas, counts, threshold=1e-4):
    """Rendering weights on the packed `[cap]` layout.

    sigmas/deltas: [cap] float32; counts: [n_rays] int32 samples per ray
    (layout per `packed_runs`; entries past the last run are padding and
    get w = 0).  Identical semantics to `compute_weights` on the dense
    layout; gradients flow to sigmas only.  The Triton kernel on CUDA
    devices (faster end to end on the H100, PERF.md), the plain XLA scan
    on every other platform."""
    # imported here: weights_triton imports packed_runs from this module
    from .weights_triton import compute_weights_packed_triton

    return jax.lax.platform_dependent(
        sigmas, deltas, counts,
        cuda=partial(compute_weights_packed_triton, threshold=threshold),
        default=partial(compute_weights_packed_xla, threshold=threshold),
    )


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def compute_weights_packed_xla(sigmas, deltas, counts, threshold=1e-4):
    """`compute_weights_packed` as plain XLA segmented scans."""
    return _packed_fwd_math(sigmas, deltas, counts, threshold)[0]


def _packed_fwd(sigmas, deltas, counts, threshold):
    w, (valid, last, c) = _packed_fwd_math(sigmas, deltas, counts, threshold)
    return w, (deltas, counts, valid, last, w, c)


def _packed_bwd(threshold, res, g):
    deltas, counts, valid, last, w, c = res
    wg = w * g
    suffix_strict = _segmented_cumsum(wg, last, reverse=True) - wg
    t_incl = jnp.exp(-c)  # transmittance AFTER sample k
    grad = jnp.where(valid, deltas * (t_incl * g - suffix_strict), 0.0)
    return grad, jnp.zeros_like(deltas), None


compute_weights_packed_xla.defvjp(_packed_fwd, _packed_bwd)

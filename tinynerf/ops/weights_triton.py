"""Packed rendering weights as a Pallas/Triton GPU kernel.

The reference's CUDA design (src/cuda.cu): one lane owns one ray and walks
that ray's contiguous run of packed samples, `w = T (1 - alpha)`,
`T *= alpha`, stopping once T <= threshold; the backward is the closed form
of ops/weights.py in two per-ray passes (the run's total of w*g, then a
forward walk).  Same interface and semantics as
`ops.weights.compute_weights_packed_xla`, the plain XLA form; on the H100
this kernel is faster end to end (PERF.md), and `compute_weights_packed`
lowers to it on CUDA devices.

`interpret=True` runs the kernel through the Pallas interpreter (CPU tests).
Lanes that are masked off point at one spare slot past the buffer's end:
the interpreter emulates a masked store as a read-modify-write, so a masked
lane must never share an address with a live one.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .weights import packed_runs

BLOCK_RAYS = 32  # rays (lanes) per program: one warp


def _ray_block(starts_ref, lens_ref, n_rays):
    base = pl.program_id(0) * BLOCK_RAYS
    live = base + jnp.arange(BLOCK_RAYS, dtype=jnp.int32) < n_rays
    blk = pl.ds(base, BLOCK_RAYS)
    start = plgpu.load(starts_ref.at[blk], mask=live, other=0)
    n = plgpu.load(lens_ref.at[blk], mask=live, other=0)
    return start, n


def _fwd_kernel(starts_ref, lens_ref, sig_ref, dlt_ref, _, w_ref, *, n_rays, cap, threshold):
    start, n = _ray_block(starts_ref, lens_ref, n_rays)
    n_max = jnp.max(n)

    def active(j, c):
        return (j < n) & (jnp.exp(-c) > threshold)

    def cond(carry):
        j, c = carry
        # any(): Triton lowers int max-reductions, not boolean ones
        return (j < n_max) & (jnp.max(active(j, c).astype(jnp.int32)) > 0)

    def body(carry):
        j, c = carry
        act = active(j, c)
        idx = jnp.where(act, start + j, cap)
        s = plgpu.load(sig_ref.at[idx], mask=act, other=0.0) * plgpu.load(
            dlt_ref.at[idx], mask=act, other=0.0
        )
        plgpu.store(w_ref.at[idx], jnp.exp(-c) * (1.0 - jnp.exp(-s)), mask=act)
        return j + 1, c + s

    jax.lax.while_loop(cond, body, (jnp.int32(0), jnp.zeros(BLOCK_RAYS, jnp.float32)))


def _bwd_kernel(starts_ref, lens_ref, sig_ref, dlt_ref, w_ref, g_ref, _, gs_ref, *, n_rays, cap):
    start, n = _ray_block(starts_ref, lens_ref, n_rays)
    n_max = jnp.max(n)

    def total_body(j, tot):
        m = j < n
        idx = jnp.where(m, start + j, cap)
        w = plgpu.load(w_ref.at[idx], mask=m, other=0.0)
        return tot + w * plgpu.load(g_ref.at[idx], mask=m, other=0.0)

    total = jax.lax.fori_loop(0, n_max, total_body, jnp.zeros(BLOCK_RAYS, jnp.float32))

    def grad_body(j, carry):
        acc, c = carry
        m = j < n
        idx = jnp.where(m, start + j, cap)
        d = plgpu.load(dlt_ref.at[idx], mask=m, other=0.0)
        c = c + plgpu.load(sig_ref.at[idx], mask=m, other=0.0) * d
        g = plgpu.load(g_ref.at[idx], mask=m, other=0.0)
        acc = acc + plgpu.load(w_ref.at[idx], mask=m, other=0.0) * g
        plgpu.store(gs_ref.at[idx], d * (acc + jnp.exp(-c) * g), mask=m)
        return acc, c

    jax.lax.fori_loop(
        0, n_max, grad_body, (-total, jnp.zeros(BLOCK_RAYS, jnp.float32))
    )


def _call(kernel, starts, lens, arrays, interpret, **kw):
    (n_rays,) = starts.shape
    cap = arrays[0].shape[0]
    zeros = jnp.zeros((cap + 1,), jnp.float32)  # + the masked lanes' slot
    n_in = 2 + len(arrays)
    out = pl.pallas_call(
        partial(kernel, n_rays=n_rays, cap=cap, **kw),
        out_shape=jax.ShapeDtypeStruct((cap + 1,), jnp.float32),
        grid=(pl.cdiv(n_rays, BLOCK_RAYS),),
        input_output_aliases={n_in: 0},
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        backend="triton",
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(starts, lens, *arrays, zeros)
    return out[:cap]


@partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def compute_weights_packed_triton(sigmas, deltas, counts, threshold=1e-4, interpret=False):
    """`ops.weights.compute_weights_packed_xla` as a per-ray-walk GPU kernel."""
    starts, lens = packed_runs(counts, sigmas.shape[0])
    return _call(
        _fwd_kernel, starts, lens, (sigmas, deltas), interpret, threshold=threshold
    )


def _fwd(sigmas, deltas, counts, threshold, interpret):
    w = compute_weights_packed_triton(sigmas, deltas, counts, threshold, interpret)
    return w, (sigmas, deltas, counts, w)


def _bwd(threshold, interpret, res, g):
    sigmas, deltas, counts, w = res
    starts, lens = packed_runs(counts, sigmas.shape[0])
    gs = _call(_bwd_kernel, starts, lens, (sigmas, deltas, w, g), interpret)
    return gs, jnp.zeros_like(deltas), None


compute_weights_packed_triton.defvjp(_fwd, _bwd)

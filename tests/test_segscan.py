"""Packed transmittance op: numeric contract vs the dense weights op (itself
property-tested against a per-ray loop in test_weights.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinynerf.ops import compute_weights, compute_weights_packed, packed_runs
from tinynerf.ops.weights import _segmented_cumsum, compute_weights_packed_xla
from tinynerf.ops.weights_triton import compute_weights_packed_triton

# jitted: eager dispatch of the scans' many small ops dominates CPU time
IMPLS = {
    "xla": jax.jit(compute_weights_packed_xla, static_argnums=3),
    "triton": jax.jit(
        lambda s, d, c, t: compute_weights_packed_triton(s, d, c, t, True),
        static_argnums=3,
    ),
}
segmented_cumsum = jax.jit(_segmented_cumsum, static_argnums=2)


def _flags(lengths, n):
    first = np.zeros(n, bool)
    last = np.zeros(n, bool)
    start = 0
    for k in lengths:
        first[start] = last[start + k - 1] = True
        start += k
    return first, last


def test_segmented_cumsum_forward_and_reverse():
    rng = np.random.default_rng(0)
    x = rng.normal(size=150).astype(np.float32)
    # irregular segment lengths incl. length-1 and long spans
    lengths = [1, 7, 130, 5, 7]
    first, last = _flags(lengths, 150)
    fwd = np.asarray(segmented_cumsum(jnp.asarray(x), jnp.asarray(first), False))
    rev = np.asarray(segmented_cumsum(jnp.asarray(x), jnp.asarray(last), True))
    start = 0
    for n in lengths:
        sl = slice(start, start + n)
        np.testing.assert_allclose(fwd[sl], np.cumsum(x[sl]), atol=1e-5)
        np.testing.assert_allclose(rev[sl], np.cumsum(x[sl][::-1])[::-1], atol=1e-5)
        start += n


def test_segmented_cumsum_multiblock():
    """A long buffer of many segments: every partial sum stays segment-local
    (no drift from the buffer's running total)."""
    rng = np.random.default_rng(1)
    n = 3 * 8192 + 1000
    x = rng.uniform(0, 1, n).astype(np.float32)
    lengths = [300] * (n // 300) + [n % 300]
    first, _ = _flags(lengths, n)
    out = np.asarray(segmented_cumsum(jnp.asarray(x), jnp.asarray(first), False))
    for s in range(0, n // 300 + 1):
        sl = slice(s * 300, min((s + 1) * 300, n))
        np.testing.assert_allclose(out[sl], np.cumsum(x[sl]), rtol=1e-5, atol=1e-4)


def _problem(seed, n_rays, n_samples, keep, cap_extra):
    """Dense problem + its packed layout; cap_extra < 0 overflows the cap."""
    rng = np.random.default_rng(seed)
    sig = rng.uniform(0, 8, (n_rays, n_samples)).astype(np.float32)
    dlt = rng.uniform(0.01, 0.1, (n_rays, n_samples)).astype(np.float32)
    msk = rng.uniform(size=(n_rays, n_samples)) < keep
    msk[min(3, n_rays - 1)] = False  # an empty ray
    msk[0] = True  # a full ray
    idx = np.nonzero(msk.reshape(-1))[0]
    cap = len(idx) + cap_extra
    n = min(cap, len(idx))
    sig_c = np.zeros(cap, np.float32)
    dlt_c = np.ones(cap, np.float32)
    sig_c[:n] = sig.reshape(-1)[idx[:n]]
    dlt_c[:n] = dlt.reshape(-1)[idx[:n]]
    # the dense twin holds exactly the packed samples (a spilled ray keeps
    # its leading samples, as in the renderer's compaction)
    sig_d = np.zeros(sig.size, np.float32)
    sig_d[idx[:n]] = sig_c[:n]
    msk_d = np.zeros(sig.size, bool)
    msk_d[idx[:n]] = True
    counts = msk.sum(-1).astype(np.int32)
    dense = (sig_d.reshape(sig.shape), dlt, msk_d.reshape(sig.shape))
    return dense, (sig_c, dlt_c, counts), idx[:n]


LAYOUTS = [
    # seed, rays, samples, keep fraction, cap - n_valid
    (0, 24, 50, 0.65, 13),
    (1, 40, 9, 0.3, 0),
    (2, 7, 300, 0.9, 5),
    (3, 33, 64, 0.5, -40),  # cap overflow: the last rays spill
]


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("thr", [0.0, 1e-4, 1e-2])
def test_packed_weights_match_dense(impl, layout, thr):
    (sig, dlt, msk), (sig_c, dlt_c, counts), idx = _problem(*layout)
    w_dense = np.asarray(
        compute_weights(
            jnp.asarray(sig), jnp.asarray(dlt), jnp.asarray(msk, jnp.float32), thr
        )
    )
    w_packed = np.asarray(
        IMPLS[impl](
            jnp.asarray(sig_c), jnp.asarray(dlt_c), jnp.asarray(counts), thr
        )
    )
    np.testing.assert_allclose(w_packed[: len(idx)], w_dense.reshape(-1)[idx], atol=1e-6)
    assert np.all(w_packed[len(idx):] == 0.0)


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_packed_weights_grads_match_dense(impl, layout):
    (sig, dlt, msk), (sig_c, dlt_c, counts), idx = _problem(*layout)
    rng = np.random.default_rng(7)
    g_c = rng.normal(size=len(sig_c)).astype(np.float32)
    g_dense = np.zeros(sig.size, np.float32)
    g_dense[idx] = g_c[: len(idx)]
    g_dense = g_dense.reshape(sig.shape)

    grad_dense = np.asarray(
        jax.grad(
            lambda s: jnp.sum(
                compute_weights(
                    s, jnp.asarray(dlt), jnp.asarray(msk, jnp.float32), 1e-4
                )
                * jnp.asarray(g_dense)
            )
        )(jnp.asarray(sig))
    )
    grad_packed = np.asarray(
        jax.grad(
            lambda s: jnp.sum(
                IMPLS[impl](s, jnp.asarray(dlt_c), jnp.asarray(counts), 1e-4)
                * jnp.asarray(g_c)
            )
        )(jnp.asarray(sig_c))
    )
    np.testing.assert_allclose(
        grad_packed[: len(idx)], grad_dense.reshape(-1)[idx], atol=1e-5
    )
    assert np.all(grad_packed[len(idx):] == 0.0)


def test_packed_runs_clip_at_cap():
    starts, lens = packed_runs(jnp.asarray([3, 0, 4, 2, 5], jnp.int32), 8)
    np.testing.assert_array_equal(np.asarray(starts), [0, 3, 3, 7, 8])
    np.testing.assert_array_equal(np.asarray(lens), [3, 0, 4, 1, 0])


def test_packed_weights_jit_all_empty():
    """No valid sample at all: every weight and gradient is zero."""
    fn = jax.jit(jax.value_and_grad(
        lambda s: jnp.sum(compute_weights_packed(
            s, jnp.ones(16), jnp.zeros(4, jnp.int32), 1e-4))
    ))
    v, g = fn(jnp.ones(16))
    assert float(v) == 0.0 and not np.any(np.asarray(g))


@pytest.mark.parametrize("platform,n_kernels", [("cuda", 2), ("cpu", 0)])
def test_packed_weights_kernel_choice(platform, n_kernels):
    """Lowered for CUDA, the op's forward and backward are the two Triton
    kernels; lowered for any other platform, plain XLA (no kernel)."""
    from jax import export

    f = jax.jit(lambda s, d, c: jax.value_and_grad(
        lambda s: jnp.sum(compute_weights_packed(s, d, c, 1e-4)))(s))
    args = (jax.ShapeDtypeStruct((4096,), jnp.float32),) * 2 + (
        jax.ShapeDtypeStruct((64,), jnp.int32),
    )
    exp = export.export(
        f, platforms=[platform],
        disabled_checks=[export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")],
    )(*args)
    assert exp.mlir_module().count("@__gpu$xla.gpu.triton(") == n_kernels

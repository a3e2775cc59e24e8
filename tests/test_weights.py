"""Numeric contract for the transmittance/weights op.

The reference never validates its CUDA kernel numerically (SURVEY.md §4); here
the custom-VJP op is property-tested against (a) a straightforward python
per-ray loop replicating the reference kernel's math (src/cuda.cu:3-58) and
(b) jax.grad through the naive jnp implementation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinynerf.ops import compute_weights, compute_weights_naive


def loop_weights(sigmas, deltas, mask, threshold):
    """Literal re-statement of the per-ray scan semantics, in python."""
    R, S = sigmas.shape
    w = np.zeros_like(sigmas)
    for r in range(R):
        T = 1.0
        for k in range(S):
            if not mask[r, k]:
                continue
            if T <= threshold:
                break
            alpha = np.exp(-sigmas[r, k] * deltas[r, k])
            w[r, k] = T * (1.0 - alpha)
            T *= alpha
    return w


def loop_grad(sigmas, deltas, mask, w, g):
    """Closed-form backward, per-ray loop (reference src/cuda.cu:32-58)."""
    R, S = sigmas.shape
    grad = np.zeros_like(sigmas)
    for r in range(R):
        acc = -np.sum(w[r][mask[r]] * g[r][mask[r]])
        T = 1.0
        for k in range(S):
            if not mask[r, k]:
                continue
            acc += w[r, k] * g[r, k]
            T *= np.exp(-sigmas[r, k] * deltas[r, k])
            grad[r, k] = deltas[r, k] * (acc + T * g[r, k])
    return grad


@pytest.fixture
def batch():
    rng = np.random.default_rng(42)
    R, S = 16, 37
    sigmas = rng.uniform(0.0, 8.0, (R, S)).astype(np.float32)
    deltas = rng.uniform(0.01, 0.1, (R, S)).astype(np.float32)
    mask = rng.uniform(size=(R, S)) > 0.35
    mask[0] = False  # an empty ray
    mask[1] = True  # a full ray
    return sigmas, deltas, mask


def test_forward_matches_loop(batch):
    sigmas, deltas, mask = batch
    for threshold in (0.0, 1e-4, 1e-2):
        w = compute_weights(
            jnp.asarray(sigmas), jnp.asarray(deltas), jnp.asarray(mask, jnp.float32), threshold
        )
        w_ref = loop_weights(sigmas, deltas, mask, threshold)
        np.testing.assert_allclose(np.asarray(w), w_ref, atol=1e-6)


def test_weights_properties(batch):
    sigmas, deltas, mask = batch
    w = np.asarray(
        compute_weights(
            jnp.asarray(sigmas), jnp.asarray(deltas), jnp.asarray(mask, jnp.float32), 0.0
        )
    )
    assert np.all(w >= 0)
    assert np.all(w.sum(-1) <= 1.0 + 1e-6)  # weights are a sub-probability
    assert np.all(w[~mask] == 0)
    assert np.all(w[0] == 0)  # empty ray


def test_custom_vjp_matches_loop(batch):
    sigmas, deltas, mask = batch
    maskf = jnp.asarray(mask, jnp.float32)
    g = np.random.default_rng(7).normal(size=sigmas.shape).astype(np.float32)

    def f(s):
        return jnp.sum(compute_weights(s, jnp.asarray(deltas), maskf, 0.0) * g)

    grad = np.asarray(jax.grad(f)(jnp.asarray(sigmas)))
    w_ref = loop_weights(sigmas, deltas, mask, 0.0)
    grad_ref = loop_grad(sigmas, deltas, mask, w_ref, g)
    np.testing.assert_allclose(grad, grad_ref, atol=1e-5)


def test_custom_vjp_matches_autodiff(batch):
    """Without early termination, the closed form equals plain autodiff."""
    sigmas, deltas, mask = batch
    maskf = jnp.asarray(mask, jnp.float32)
    g = np.random.default_rng(3).normal(size=sigmas.shape).astype(np.float32)

    def f_custom(s):
        return jnp.sum(compute_weights(s, jnp.asarray(deltas), maskf, 0.0) * g)

    def f_naive(s):
        return jnp.sum(compute_weights_naive(s, jnp.asarray(deltas), maskf, 0.0) * g)

    g1 = jax.grad(f_custom)(jnp.asarray(sigmas))
    g2 = jax.grad(f_naive)(jnp.asarray(sigmas))
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=1e-5)


def test_jit_and_vmap():
    sigmas = jnp.ones((4, 8))
    deltas = jnp.full((4, 8), 0.1)
    maskf = jnp.ones((4, 8))
    w_jit = jax.jit(lambda s: compute_weights(s, deltas, maskf, 1e-4))(sigmas)
    assert w_jit.shape == (4, 8)
    # leading batch dims work (op is written on [..., S])
    w_b = compute_weights(sigmas[None], deltas[None], maskf[None], 1e-4)
    np.testing.assert_allclose(np.asarray(w_b[0]), np.asarray(w_jit), atol=1e-7)

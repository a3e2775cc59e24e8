"""Cell-pack (oct/quad) table builds vs the jnp semantic reference.

Every build formulation in ops/interp.py (`_OCT_BUILD_MODE` /
`_QUAD_BUILD_MODE`) must be bit-identical to `build_oct_ref` /
`build_quad_ref`, including the dtype cast.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tinynerf.ops import interp
from tinynerf.ops.interp import _build_oct, _build_quad, build_oct_ref, build_quad_ref


@pytest.mark.parametrize("mode", ["stack", "pad"])
@pytest.mark.parametrize(
    "shape", [(5, 6, 7, 3), (9, 9, 9, 4), (9, 17, 9, 4), (6, 6, 6, 8)]
)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_oct_build_matches_ref(monkeypatch, mode, shape, dtype):
    monkeypatch.setattr(interp, "_OCT_BUILD_MODE", mode)
    rng = np.random.default_rng(0)
    t = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    ref = build_oct_ref(t, dtype)
    got = _build_oct(t, dtype)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(
        np.asarray(ref, np.float32), np.asarray(got, np.float32)
    )


@pytest.mark.parametrize("mode", ["stack", "pad"])
@pytest.mark.parametrize("shape", [(5, 7, 2), (9, 6, 8), (17, 17, 6)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quad_build_matches_ref(monkeypatch, mode, shape, dtype):
    monkeypatch.setattr(interp, "_QUAD_BUILD_MODE", mode)
    rng = np.random.default_rng(1)
    t = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    ref = build_quad_ref(t, dtype)
    got = _build_quad(t, dtype)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(
        np.asarray(ref, np.float32), np.asarray(got, np.float32)
    )


def test_refs_match_shipping_interleave_formulation():
    """The *_ref stack formulation equals the default builds — corner order
    and values bit-identical."""
    rng = np.random.default_rng(2)
    t3 = jnp.asarray(rng.normal(size=(6, 7, 8, 3)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(_build_oct(t3, jnp.float32)),
        np.asarray(build_oct_ref(t3, jnp.float32)),
    )
    t2 = jnp.asarray(rng.normal(size=(7, 9, 5)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(_build_quad(t2, jnp.float32)),
        np.asarray(build_quad_ref(t2, jnp.float32)),
    )

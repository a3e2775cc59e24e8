"""Shape/dtype/invariant tests for fields, encoders, decoders (mirrors the
reference's tests/test_models.py coverage, CPU-only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinynerf.models import (
    ColorDecoder,
    CobafaFeatureField,
    KPlanesExplicitColorDecoder,
    KPlanesExplicitOpacityDecoder,
    KPlanesFeatureField,
    OpacityDecoder,
    VanillaFeatureField,
    make_model,
    posenc_dim,
    positional_encoding,
)
from tinynerf.ops import sawtooth, truncated_exp

KEY = jax.random.PRNGKey(0)
X = jax.random.uniform(jax.random.PRNGKey(1), (100, 3), minval=-1.0, maxval=1.0)
DIRS = X / jnp.linalg.norm(X, axis=-1, keepdims=True)


def _check_combo(field, n=100):
    params_f = field.init(KEY)
    feats = field.apply(params_f, X)
    assert feats.shape == (n, field.feature_dim)

    sigma_dec = OpacityDecoder(field.feature_dim)
    sigma = sigma_dec.apply(sigma_dec.init(KEY), feats)
    assert sigma.shape == (n,)
    assert bool(jnp.all(sigma >= 0))

    rgb_dec = ColorDecoder(8, field.feature_dim, 64, 3)
    rgb = rgb_dec.apply(rgb_dec.init(KEY), feats, DIRS)
    assert rgb.shape == (n, 3)
    assert bool(jnp.all((rgb >= 0) & (rgb <= 1)))


def test_vanilla_combo():
    _check_combo(VanillaFeatureField(10, 256, 8))


def test_kplanes_combo():
    _check_combo(KPlanesFeatureField(resolutions=(33, 65, 129)))


def test_cobafa_combo():
    _check_combo(make_model("cobafa", field_scale=0.25)[0])


def test_posenc_shapes():
    assert positional_encoding(X, 10).shape == (100, posenc_dim(3, 10))
    x4 = jnp.ones((2, 5, 7, 3))
    assert positional_encoding(x4, 4).shape == (2, 5, 7, 24)


def test_posenc_values():
    x = jnp.array([[0.5, 0.0, -0.25]])
    enc = positional_encoding(x, 2)
    # layout per coordinate: [sin(pi x), sin(2pi x), cos(pi x), cos(2pi x)]
    np.testing.assert_allclose(float(enc[0, 0]), np.sin(np.pi * 0.5), atol=1e-6)
    np.testing.assert_allclose(float(enc[0, 1]), np.sin(2 * np.pi * 0.5), atol=1e-6)
    np.testing.assert_allclose(float(enc[0, 2]), np.cos(np.pi * 0.5), atol=1e-6)


def test_truncated_exp_fwd_bwd():
    x = jnp.array([-20.0, 0.0, 2.0, 20.0])
    # forward and backward both clamp to [-15, 15] (saturating, finite)
    expected = np.exp(np.clip(np.asarray(x), -15, 15))
    np.testing.assert_allclose(np.asarray(truncated_exp(x)), expected, rtol=1e-6)
    grads = jax.vmap(jax.grad(truncated_exp))(x)
    np.testing.assert_allclose(np.asarray(grads), expected, rtol=1e-6)
    assert np.all(np.isfinite(np.asarray(truncated_exp(jnp.array([1000.0])))))


def test_kplanes_regularizers_nonnegative():
    field = KPlanesFeatureField(resolutions=(33, 65, 129))
    params = field.init(KEY)
    assert float(field.loss_tv(params)) >= 0
    assert float(field.loss_l1(params)) >= 0
    # L1 of U(0, 1)-init planes is ~0.5
    assert 0.4 < float(field.loss_l1(params)) < 0.6


def test_kplanes_explicit_decoders():
    field = KPlanesFeatureField(resolutions=(33, 65, 129))
    feats = field.apply(field.init(KEY), X)
    op = KPlanesExplicitOpacityDecoder(field.feature_dim)
    sigma = op.apply(op.init(KEY), feats)
    assert sigma.shape == (100,)
    assert bool(jnp.all(sigma >= 0))
    col = KPlanesExplicitColorDecoder(field.feature_dim)
    rgb = col.apply(col.init(KEY), feats, DIRS)
    assert rgb.shape == (100, 3)
    assert bool(jnp.all((rgb >= 0) & (rgb <= 1)))


def test_sawtooth_range():
    x = jnp.linspace(-2.0, 2.0, 101)
    y = sawtooth(x, 3.0)
    assert bool(jnp.all((y >= -1.0) & (y <= 1.0)))
    # periodic with period 1/f
    np.testing.assert_allclose(
        np.asarray(sawtooth(x, 3.0)), np.asarray(sawtooth(x + 1.0 / 3.0, 3.0)), atol=1e-4
    )


def test_cobafa_dropout_modes():
    field = make_model("cobafa", field_scale=0.25)[0]
    params = field.init(KEY)
    eval_out = field.apply(params, X)
    eval_out2 = field.apply(params, X)
    np.testing.assert_array_equal(np.asarray(eval_out), np.asarray(eval_out2))
    train_out = field.apply(params, X, dropout_key=jax.random.PRNGKey(5))
    assert train_out.shape == eval_out.shape


def test_registry_dims():
    for method, dim in (("vanilla", 256), ("kplanes", 96), ("cobafa", 128)):
        field, sd, rd = make_model(method)
        assert field.feature_dim == dim
        assert sd.feature_dim == dim
        assert rd.in_features == dim
    with pytest.raises(NotImplementedError):
        make_model("nope")


def test_color_decoders_per_ray_matches_apply():
    """apply_per_ray (forward-only serving variant: per-RAY direction branch
    + f32 row gather) must reproduce apply() on the equivalent gathered-dirs
    input, for both decoder families and both compute dtypes."""
    from tinynerf.models.kplanes import KPlanesExplicitColorDecoder
    from tinynerf.models.vanilla import ColorDecoder

    n_rays, cap, fdim = 13, 97, 8
    key = jax.random.PRNGKey(0)
    d_ray = jax.random.normal(key, (n_rays, 3))
    d_ray = d_ray / jnp.linalg.norm(d_ray, axis=-1, keepdims=True)
    seg = jnp.sort(jax.random.randint(jax.random.PRNGKey(1), (cap,), 0, n_rays))
    feats = jax.random.normal(jax.random.PRNGKey(2), (cap, fdim))

    for dec in (
        ColorDecoder(n_freqs=8, in_features=fdim, hidden_features=16,
                     hidden_layers=2),
        KPlanesExplicitColorDecoder(feature_dim=fdim, n_freqs=8, hidden_dim=16),
    ):
        params = dec.init(jax.random.PRNGKey(3))
        for cdt, atol in ((jnp.float32, 1e-6), (jnp.bfloat16, 5e-3)):
            ship = dec.apply(params, feats, d_ray[seg], cdt)
            ray = dec.apply_per_ray(params, feats, d_ray, seg, cdt)
            np.testing.assert_allclose(
                np.asarray(ray), np.asarray(ship), atol=atol,
                err_msg=f"{type(dec).__name__} {cdt}",
            )
        # tuple-of-pieces feed (how the renderer passes field features)
        pieces = (feats[:, :3], feats[:, 3:])
        ship = dec.apply(params, pieces, d_ray[seg], jnp.float32)
        ray = dec.apply_per_ray(params, pieces, d_ray, seg, jnp.float32)
        np.testing.assert_allclose(np.asarray(ray), np.asarray(ship), atol=1e-6)

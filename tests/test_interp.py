"""Mixed-precision lookup tests: bf16 forward gathers must approximate the
f32 path, and the custom f32 scatter backward must match plain autodiff."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinynerf.ops import (
    bilinear_lookup,
    bilinear_lookup_mixed,
    bilinear_lookup_quad,
    trilinear_lookup,
    trilinear_lookup_mixed,
    trilinear_lookup_oct,
)

KEY = jax.random.PRNGKey(0)


def test_bilinear_mixed_close_to_f32():
    table = jax.random.uniform(KEY, (32, 48, 8))
    pts = jax.random.uniform(jax.random.PRNGKey(1), (200, 2), minval=-1, maxval=1)
    ref = bilinear_lookup(table, pts)
    mixed = bilinear_lookup_mixed(table, pts, jnp.bfloat16)
    # bf16 mantissa: ~3 decimal digits relative
    np.testing.assert_allclose(np.asarray(mixed), np.asarray(ref), atol=2e-2)
    # with an f32 "gather dtype" the mixed path is exact
    exact = bilinear_lookup_mixed(table, pts, jnp.float32)
    np.testing.assert_allclose(np.asarray(exact), np.asarray(ref), atol=1e-6)


def test_bilinear_mixed_backward_matches_autodiff():
    table = jax.random.uniform(KEY, (16, 16, 4))
    pts = jax.random.uniform(jax.random.PRNGKey(2), (64, 2), minval=-1, maxval=1)
    g = jax.random.normal(jax.random.PRNGKey(3), (64, 4))

    grad_ref = jax.grad(lambda t: jnp.sum(bilinear_lookup(t, pts) * g))(table)
    grad_mixed = jax.grad(
        lambda t: jnp.sum(bilinear_lookup_mixed(t, pts, jnp.float32) * g)
    )(table)
    np.testing.assert_allclose(
        np.asarray(grad_mixed), np.asarray(grad_ref), atol=1e-5
    )
    # bf16 forward still produces the same (f32, exact-weight) scatter backward
    grad_bf = jax.grad(
        lambda t: jnp.sum(bilinear_lookup_mixed(t, pts, jnp.bfloat16) * g)
    )(table)
    np.testing.assert_allclose(np.asarray(grad_bf), np.asarray(grad_ref), atol=1e-5)


def test_trilinear_mixed_close_and_grads():
    table = jax.random.uniform(KEY, (9, 9, 9, 4))
    pts = jax.random.uniform(jax.random.PRNGKey(4), (100, 3), minval=-1, maxval=1)
    ref = trilinear_lookup(table, pts)
    mixed = trilinear_lookup_mixed(table, pts, jnp.bfloat16)
    np.testing.assert_allclose(np.asarray(mixed), np.asarray(ref), atol=2e-2)

    g = jax.random.normal(jax.random.PRNGKey(5), (100, 4))
    grad_ref = jax.grad(lambda t: jnp.sum(trilinear_lookup(t, pts) * g))(table)
    grad_bf = jax.grad(
        lambda t: jnp.sum(trilinear_lookup_mixed(t, pts, jnp.bfloat16) * g)
    )(table)
    np.testing.assert_allclose(np.asarray(grad_bf), np.asarray(grad_ref), atol=1e-5)


def test_quad_lookup_exact_vs_plain():
    """Cell-packed layout must reproduce corner-gather bilinear exactly
    (incl. boundary coords where the cell index clamps)."""
    table = jax.random.uniform(KEY, (17, 23, 4))
    pts = jax.random.uniform(jax.random.PRNGKey(7), (300, 2), minval=-1, maxval=1)
    pts = jnp.concatenate(
        [pts, jnp.array([[-1.0, -1.0], [1.0, 1.0], [1.0, -1.0], [0.0, 1.0]])]
    )
    g = jax.random.normal(jax.random.PRNGKey(8), (pts.shape[0], table.shape[-1]))

    # one value_and_grad(has_aux) compile per variant covers fwd AND bwd
    def loss_ref(t):
        out = bilinear_lookup(t, pts)
        return jnp.sum(out * g), out

    def loss_quad(t):
        out = bilinear_lookup_quad(t, pts, jnp.float32)
        return jnp.sum(out * g), out

    (_, ref), g_ref = jax.value_and_grad(loss_ref, has_aux=True)(table)
    (_, quad), g_quad = jax.value_and_grad(loss_quad, has_aux=True)(table)
    np.testing.assert_allclose(np.asarray(quad), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(np.asarray(g_quad), np.asarray(g_ref), atol=1e-5)
    # bf16 forward still close
    bf = bilinear_lookup_quad(table, pts, jnp.bfloat16)
    np.testing.assert_allclose(np.asarray(bf), np.asarray(ref), atol=2e-2)


def test_oct_lookup_exact_vs_plain():
    table = jax.random.uniform(KEY, (7, 9, 11, 3))
    pts = jax.random.uniform(jax.random.PRNGKey(9), (200, 3), minval=-1, maxval=1)
    pts = jnp.concatenate(
        [pts, jnp.array([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0]])]
    )
    g = jax.random.normal(jax.random.PRNGKey(10), (pts.shape[0], table.shape[-1]))

    # one value_and_grad(has_aux) compile per variant covers fwd AND bwd
    def loss_ref(t):
        out = trilinear_lookup(t, pts)
        return jnp.sum(out * g), out

    def loss_oct(t):
        out = trilinear_lookup_oct(t, pts, jnp.float32)
        return jnp.sum(out * g), out

    (_, ref), g_ref = jax.value_and_grad(loss_ref, has_aux=True)(table)
    (_, oct_v), g_oct = jax.value_and_grad(loss_oct, has_aux=True)(table)
    np.testing.assert_allclose(np.asarray(oct_v), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(np.asarray(g_oct), np.asarray(g_ref), atol=1e-5)


def test_occupancy_nearest_vs_trilinear_agree_deep_inside():
    """Away from voxel boundaries the two query modes agree."""
    from tinynerf.core import OccupancyGrid

    near = OccupancyGrid.cube(16, 0.1, interp="nearest")
    tri = OccupancyGrid.cube(16, 0.1, interp="trilinear")
    state = near.init_state()
    grid = state.grid.at[:8].set(0.0)
    state = state._replace(grid=grid, mean=jnp.mean(grid))
    pts = jnp.array([[0.5, 0.3, -0.2], [-0.5, -0.3, 0.2], [0.9, 0.9, 0.9]])
    np.testing.assert_array_equal(
        np.asarray(near.query(state, pts)), np.asarray(tri.query(state, pts))
    )


# -------------------------------------------------- exact upsampling / fusion

def test_upsample2x_exact_reproduces_bilinear():
    """Bilinear lookup of the 2x-upsampled table equals lookup of the
    original at arbitrary points (nested align_corners grids)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tinynerf.ops import bilinear_lookup
    from tinynerf.ops.interp import upsample2x_exact, upsample_to

    key = jax.random.PRNGKey(0)
    table = jax.random.normal(key, (9, 9, 4))
    fine = upsample2x_exact(table)
    assert fine.shape == (17, 17, 4)
    pts = jax.random.uniform(jax.random.PRNGKey(1), (200, 2), minval=-1, maxval=1)
    np.testing.assert_allclose(
        np.asarray(bilinear_lookup(table, pts)),
        np.asarray(bilinear_lookup(fine, pts)),
        atol=1e-5,
    )
    # chain 9 -> 33
    fine2 = upsample_to(table, 33, 33)
    np.testing.assert_allclose(
        np.asarray(bilinear_lookup(table, pts)),
        np.asarray(bilinear_lookup(fine2, pts)),
        atol=1e-5,
    )


def test_kplanes_fused_equals_per_scale():
    """The fused (one-lookup-per-projection) K-Planes apply matches the
    per-scale quad path, forward and backward."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from dataclasses import replace
    from tinynerf.models import KPlanesFeatureField

    field = KPlanesFeatureField(
        feature_dim_per_plane=4, resolutions=(9, 17, 33),
        lookup_mode="fused", gather_dtype="float32",
    )
    params = field.init(jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (500, 3), minval=-1, maxval=1)

    ref_field = replace(field, lookup_mode="quad")

    # one value_and_grad(has_aux) compile per variant covers fwd AND bwd —
    # separate fwd programs doubled this test's CPU compile time
    def loss_fused(p):
        feats = field.apply(p, x)
        return jnp.sum(feats**2), feats

    def loss_quad(p):
        feats = ref_field.apply(p, x)
        return jnp.sum(feats**2), feats

    (_, f_f), g_f = jax.value_and_grad(loss_fused, has_aux=True)(params)
    (_, f_q), g_q = jax.value_and_grad(loss_quad, has_aux=True)(params)
    np.testing.assert_allclose(np.asarray(f_f), np.asarray(f_q), atol=2e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g_f), jax.tree_util.tree_leaves(g_q)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("n_rows", [997, 4099])
def test_scatter_add_rows_matches_numpy(n_rows):
    """ops/interp.py scatter_add_rows equals np.add.at, with odd row counts
    and many repeated indices."""
    from tinynerf.ops import interp

    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    n, w = 5000, 16
    idx = jax.random.randint(k1, (n,), 0, n_rows)
    contrib = jax.random.normal(k2, (n, w))
    ref = np.zeros((n_rows, w), np.float32)
    np.add.at(ref, np.asarray(idx), np.asarray(contrib))
    np.testing.assert_allclose(
        np.asarray(interp.scatter_add_rows(n_rows, idx, contrib)), ref,
        atol=1e-5,
    )


def test_interleave_builds_bitexact_vs_stack():
    # the dilated-pad cell-packed builds (ops/interp.py _interleave_shifts)
    # are pure relayouts: bit-identical to the naive stack+reshape form
    from tinynerf.ops.interp import _build_oct, _build_quad

    t2 = jax.random.normal(KEY, (9, 7, 5))
    q_stack = jnp.stack(
        [t2[:-1, :-1], t2[:-1, 1:], t2[1:, :-1], t2[1:, 1:]], axis=2
    ).reshape(8 * 6, 4 * 5)
    assert jnp.array_equal(_build_quad(t2, jnp.float32), q_stack)

    t3 = jax.random.normal(KEY, (6, 5, 4, 3))
    o_stack = jnp.stack(
        [t3[:-1, :-1, :-1], t3[:-1, :-1, 1:], t3[:-1, 1:, :-1],
         t3[:-1, 1:, 1:], t3[1:, :-1, :-1], t3[1:, :-1, 1:],
         t3[1:, 1:, :-1], t3[1:, 1:, 1:]], axis=3
    ).reshape(5 * 4 * 3, 8 * 3)
    assert jnp.array_equal(_build_oct(t3, jnp.float32), o_stack)

    # bf16 path rounds then relayouts — still exact vs the bf16 stack
    o16 = jnp.stack(
        [t3[:-1, :-1, :-1], t3[:-1, :-1, 1:], t3[:-1, 1:, :-1],
         t3[:-1, 1:, 1:], t3[1:, :-1, :-1], t3[1:, :-1, 1:],
         t3[1:, 1:, :-1], t3[1:, 1:, 1:]], axis=3
    ).astype(jnp.bfloat16).reshape(5 * 4 * 3, 8 * 3)
    assert jnp.array_equal(_build_oct(t3, jnp.bfloat16), o16)

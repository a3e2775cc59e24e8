"""Table-gradient backward of the cell-packed lookups (ops/interp.py): the
custom VJPs' scatter-add backward against plain autodiff through the f32
corner-gather lookups, and the fused multiscale/multi-projection forms
against their per-scale equivalents."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinynerf.ops.interp import (
    bilinear_lookup,
    bilinear_lookup_multiscale,
    multiscale_lookup_multiproj,
    trilinear_lookup,
    trilinear_lookup_oct,
)


def _tables(seed, f, resolutions=(9, 17, 33)):
    key = jax.random.PRNGKey(seed)
    return tuple(
        jax.random.normal(jax.random.fold_in(key, i), (r, r, f))
        for i, r in enumerate(resolutions)
    )


@pytest.mark.parametrize(
    "seed,f,n", [(1, 4, 400), (2, 8, 256), (3, 8, 1500), (4, 2, 700)]
)
@pytest.mark.parametrize("fwd_impl", ["perscale", "fusedfine"])
def test_multiscale_grads_match_autodiff(seed, f, n, fwd_impl):
    """d/dtables of the fused multiscale lookup (one wide scatter into the
    upsampled fine table, pulled back per scale) equals plain autodiff of
    the per-scale f32 bilinear lookups."""
    tables = _tables(seed, f)
    coords = jax.random.uniform(
        jax.random.PRNGKey(10 + seed), (n, 2), minval=-1, maxval=1
    )
    cot = jax.random.normal(jax.random.PRNGKey(20 + seed), (n, 3 * f))

    def fused(ts):
        out = bilinear_lookup_multiscale(ts, coords, jnp.float32, fwd_impl)
        return jnp.sum(out * cot)

    def plain(ts):
        out = jnp.concatenate([bilinear_lookup(t, coords) for t in ts], axis=-1)
        return jnp.sum(out * cot)

    for a, b in zip(jax.grad(fused)(tables), jax.grad(plain)(tables)):
        scale = float(jnp.abs(b).max()) + 1e-9
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-5 * scale
        )


@pytest.mark.parametrize("seed,shape", [(5, (9, 9, 9, 4)), (6, (5, 7, 6, 8))])
def test_oct_lookup_grads_match_autodiff(seed, shape):
    """3-D cell-packed (8-corner) scatter backward vs autodiff."""
    rng = np.random.default_rng(seed)
    table = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    coords = jnp.asarray(rng.uniform(-1, 1, (900, 3)).astype(np.float32))
    cot = jnp.asarray(rng.normal(size=(900, shape[-1])).astype(np.float32))
    g_oct = jax.grad(
        lambda t: jnp.sum(trilinear_lookup_oct(t, coords, jnp.float32) * cot)
    )(table)
    g_ref = jax.grad(lambda t: jnp.sum(trilinear_lookup(t, coords) * cot))(table)
    np.testing.assert_allclose(np.asarray(g_oct), np.asarray(g_ref), atol=1e-4)


def test_multiscale_grads_single_hot_cell():
    """Every sample in one cell: the scatter accumulates all rows into one
    table row without loss."""
    tables = _tables(7, 4)
    coords = jnp.full((700, 2), 0.123, jnp.float32)
    cot = jax.random.normal(jax.random.PRNGKey(8), (700, 12))

    def fused(ts):
        return jnp.sum(bilinear_lookup_multiscale(ts, coords, jnp.float32) * cot)

    def plain(ts):
        out = jnp.concatenate([bilinear_lookup(t, coords) for t in ts], axis=-1)
        return jnp.sum(out * cot)

    for a, b in zip(jax.grad(fused)(tables), jax.grad(plain)(tables)):
        scale = float(jnp.abs(b).max()) + 1e-9
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5 * scale)


def test_multiscale_fusedfine_fwd_matches_perscale():
    """At f32 gather dtype the fused-fine forward must match the per-scale
    forward (exact-upsampling property); grads are identical by
    construction (shared backward)."""
    tables = _tables(1, 4)
    coords = jax.random.uniform(jax.random.PRNGKey(2), (300, 2), minval=-1, maxval=1)
    a = bilinear_lookup_multiscale(tables, coords, jnp.float32, "perscale")
    b = bilinear_lookup_multiscale(tables, coords, jnp.float32, "fusedfine")
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_multiproj_matches_per_projection():
    """multiscale_lookup_multiproj values and table grads == three
    independent bilinear_lookup_multiscale calls."""
    key = jax.random.PRNGKey(3)
    tables_by_proj = tuple(
        tuple(
            jax.random.normal(jax.random.fold_in(key, 10 * p + i), (r, r, 4))
            for i, r in enumerate((9, 17, 33))
        )
        for p in range(3)
    )
    coords_by_proj = tuple(
        jax.random.uniform(
            jax.random.PRNGKey(20 + p), (256, 2), minval=-1, maxval=1
        )
        for p in range(3)
    )
    cot = tuple(
        jax.random.normal(jax.random.PRNGKey(30 + p), (256, 12))
        for p in range(3)
    )

    def f_multi(ts):
        outs = multiscale_lookup_multiproj(ts, coords_by_proj, jnp.float32)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot))

    def f_single(ts):
        outs = [
            bilinear_lookup_multiscale(t, c, jnp.float32)
            for t, c in zip(ts, coords_by_proj)
        ]
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot))

    v_m, g_m = jax.value_and_grad(f_multi)(tables_by_proj)
    v_s, g_s = jax.value_and_grad(f_single)(tables_by_proj)
    np.testing.assert_allclose(float(v_m), float(v_s), rtol=1e-6)
    for gm_p, gs_p in zip(g_m, g_s):
        for a, b in zip(gm_p, gs_p):
            scale = float(jnp.abs(b).max()) + 1e-9
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=1e-4 * scale
            )


@pytest.mark.slow
def test_multiproj_sharded_pullback_partials_sum_to_full():
    """shard_axis grads (ops/interp.py _sharded_pullback): inside shard_map
    each device returns a row-band PARTIAL of every master-table gradient;
    their psum must equal the unsharded full-batch gradient — the contract
    the shard_bwd train step (train/loop.py) relies on.  Slow tier: the
    8-device shard_map grad compile is ~2 min on CPU, and the fast tier
    keeps end-to-end shard_bwd equality via test_zero's zero_bwd variant."""
    from functools import partial as fpartial

    from jax.sharding import PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    from tinynerf.ops.interp import multiscale_lookup_multiproj
    from tinynerf.parallel import DATA_AXIS, make_mesh

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs the 8-device virtual mesh")
    mesh = make_mesh(jax.devices()[:8])

    key = jax.random.PRNGKey(4)
    tables_by_proj = tuple(
        tuple(
            jax.random.normal(jax.random.fold_in(key, 10 * p + i), (r, r, 4))
            for i, r in enumerate((9, 17, 33))
        )
        for p in range(3)
    )
    n = 512
    coords_by_proj = tuple(
        jax.random.uniform(
            jax.random.PRNGKey(40 + p), (n, 2), minval=-1, maxval=1
        )
        for p in range(3)
    )
    cot = tuple(
        jax.random.normal(jax.random.PRNGKey(50 + p), (n, 12))
        for p in range(3)
    )

    def loss(ts, coords, cs, shard_axis):
        outs = multiscale_lookup_multiproj(
            ts, coords, jnp.float32, "perscale", shard_axis
        )
        return sum(jnp.sum(o * c) for o, c in zip(outs, cs))

    g_ref = jax.grad(loss)(tables_by_proj, coords_by_proj, cot, None)

    @fpartial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    def sharded_grads(ts, coords, cs):
        g = jax.grad(
            lambda t: loss(t, coords, cs, (DATA_AXIS, 8))
        )(ts)
        return jax.tree_util.tree_map(
            lambda x: jax.lax.psum(x, DATA_AXIS), g
        )

    g_sh = sharded_grads(tables_by_proj, coords_by_proj, cot)
    for gp_ref, gp_sh in zip(g_ref, g_sh):
        for a, b in zip(gp_ref, gp_sh):
            scale = float(jnp.abs(a).max()) + 1e-9
            np.testing.assert_allclose(
                np.asarray(b), np.asarray(a), atol=1e-4 * scale
            )

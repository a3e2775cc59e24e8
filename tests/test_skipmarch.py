"""Empty-space-skipping marcher: conservativeness + exact equivalence with
the dense (brute-force occupancy query) path.

The skip marcher's contract is EXACTNESS: the emitted sample set must equal
the dense path's surviving set — including jitter — because the loss and
quality parity both ride on identical sampling (reference semantics:
src/core.py:164-188)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinynerf.core import (
    ContractionAABB,
    NerfRenderer,
    OccupancyGrid,
    RayMarcherAABB,
)
from tinynerf.core.skipmarch import make_skip_grid, skip_march
from tinynerf.models import ColorDecoder, KPlanesFeatureField, OpacityDecoder

AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))


def make_renderer(res=16, n_samples=64, skip_steps=None):
    marcher = RayMarcherAABB(AABB, n_samples=n_samples, near=0.1)
    field = KPlanesFeatureField(feature_dim_per_plane=4, resolutions=(9, 17))
    return NerfRenderer(
        field=field,
        sigma_decoder=OpacityDecoder(field.feature_dim),
        rgb_decoder=ColorDecoder(2, field.feature_dim, 16, 1),
        marcher=marcher,
        contraction=ContractionAABB(AABB),
        occupancy=OccupancyGrid.cube(res, marcher.step_size),
        bg_color=(1.0, 1.0, 1.0),
        skip_steps=skip_steps or n_samples,
    )


def random_occ(renderer, res, density, seed):
    occ = renderer.occupancy.init_state()
    g = (
        jax.random.uniform(jax.random.PRNGKey(seed), (res, res, res)) < density
    ).astype(jnp.float32)
    return occ._replace(grid=g, mean=jnp.float32(g.mean()))


def random_rays(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -4.0 * d + rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    return jnp.asarray(o), jnp.asarray(d)


def test_skip_grid_conservative():
    """Cone value g at voxel v in direction (axis, sign) certifies that every
    voxel u the marcher can visit within the next g-1 axis slices — i.e.
    with lateral offset up to (axis advance + 2) — is truly unoccupied."""
    res = 12
    g_occ = (jax.random.uniform(jax.random.PRNGKey(3), (res, res, res)) < 0.08)
    grids = np.asarray(make_skip_grid(g_occ))
    occ = np.asarray(g_occ)
    assert grids.shape == (6, res, res, res)

    for gi in range(6):
        axis, neg = gi // 2, gi % 2 == 1
        grid = grids[gi]
        # occupied voxels are 0 in every direction grid
        assert (grid[occ] == 0).all()
        for v in np.argwhere(grid > 1):
            gval = int(grid[tuple(v)])
            for adv in range(0, gval):  # axis advance 0..g-1
                va = v[axis] + (-adv if neg else adv)
                if va < 0 or va >= res:
                    continue
                lo = np.maximum(v - (adv + 2), 0)
                hi = np.minimum(v + adv + 3, res)
                lo[axis] = hi[axis] = va
                sl = occ[
                    lo[0]:hi[0] + (axis == 0),
                    lo[1]:hi[1] + (axis == 1),
                    lo[2]:hi[2] + (axis == 2),
                ]
                assert not sl.any(), (
                    f"dir {gi} voxel {v} g={gval} unsafe at advance {adv}"
                )


@pytest.mark.parametrize("density,seed", [(0.05, 0), (0.3, 1), (0.01, 2)])
def test_skip_march_equals_dense_mask(density, seed):
    """Emitted sample set == dense surviving set, with and without jitter."""
    res, S = 16, 64
    renderer = make_renderer(res=res, n_samples=S)
    occ = random_occ(renderer, res, density, seed)
    o, d = random_rays(256, seed)
    sg = renderer.skip_grid(occ)
    marcher = renderer.marcher

    for key in (None, jax.random.PRNGKey(11)):
        _, _, maskf = renderer._march(o, d, occ, key)
        dense = np.asarray(maskf > 0)
        jkey = jax.random.fold_in(key, 0) if key is not None else None
        t_min, t_exit = marcher.entry_exit(o, d)
        k_idx, complete = skip_march(
            o, d, t_min, t_exit, marcher.step_size, S,
            renderer.contraction, sg, jkey, S,
        )
        assert bool(np.asarray(complete).all())  # budget = S: never truncates
        k_idx = np.asarray(k_idx)
        skip = np.zeros_like(dense)
        for r in range(k_idx.shape[0]):
            ks = k_idx[r][k_idx[r] >= 0]
            assert (np.diff(ks) > 0).all()  # ascending, no duplicates
            skip[r, ks] = True
        np.testing.assert_array_equal(dense, skip)


def test_render_packed_skip_equals_dense():
    res, S = 16, 64
    renderer = make_renderer(res=res, n_samples=S)
    params = renderer.init(jax.random.PRNGKey(0))
    occ = random_occ(renderer, res, 0.05, 4)
    o, d = random_rays(256, 5)
    sg = renderer.skip_grid(occ)
    for key in (None, jax.random.PRNGKey(7)):
        out_d = renderer.render_packed(params, occ, o, d, cap=4096, key=key)
        out_s = renderer.render_packed(
            params, occ, o, d, cap=4096, key=key, march="skip", skip_grid=sg
        )
        np.testing.assert_allclose(
            np.asarray(out_d.rgb), np.asarray(out_s.rgb), atol=1e-5
        )
        assert int(out_d.n_samples) == int(out_s.n_samples)
        np.testing.assert_array_equal(
            np.asarray(out_d.ray_valid), np.asarray(out_s.ray_valid)
        )


def test_skip_march_truncation_flags_rays_invalid():
    """With a tiny step budget, rays that cannot finish marching must be
    flagged invalid (excluded from the loss), never silently truncated."""
    res, S = 16, 64
    renderer = make_renderer(res=res, n_samples=S, skip_steps=4)
    params = renderer.init(jax.random.PRNGKey(0))
    occ = random_occ(renderer, res, 0.3, 6)  # dense occupancy: blows budget
    o, d = random_rays(64, 7)
    sg = renderer.skip_grid(occ)
    out = renderer.render_packed(
        params, occ, o, d, cap=4096, key=None, march="skip", skip_grid=sg
    )
    # most rays cross far more than 4 occupied samples here
    assert float(np.asarray(out.ray_valid).mean()) < 0.5


def test_train_step_skip_march_mode():
    """make_train_step(march='skip') runs end-to-end and produces the same
    loss as the dense step on the identical deterministic batch."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tinynerf.parallel import make_mesh
    from tinynerf.train import TrainConfig, build_renderer, make_optimizer
    from tinynerf.train.loop import make_train_step

    cfg = TrainConfig(
        method="kplanes", scene_type="aabb", batch_size=64, n_samples=16,
        occupancy_res=16, steps=2,
    )
    renderer = build_renderer(cfg, scene_scale=1.0, bg_color=np.ones(3, np.float32))
    # shrink the field: the dense-vs-skip equality under test is size-
    # agnostic, and the default 513^2 tables cost minutes of CPU compile
    # per step variant
    import dataclasses

    small = KPlanesFeatureField(feature_dim_per_plane=8, resolutions=(9, 17, 33))
    renderer = dataclasses.replace(
        renderer,
        field=small,
        sigma_decoder=OpacityDecoder(feature_dim=small.feature_dim),
        rgb_decoder=ColorDecoder(
            n_freqs=8, in_features=small.feature_dim, hidden_features=16,
            hidden_layers=2,
        ),
    )
    optimizer = make_optimizer(cfg)
    params0 = renderer.init(jax.random.PRNGKey(0))
    occ = random_occ(renderer, 16, 0.1, 8)
    o, d = random_rays(64, 9)
    rgb = jnp.asarray(np.random.default_rng(0).uniform(size=(64, 3)).astype(np.float32))

    mesh = make_mesh(jax.devices()[:2])
    sh = NamedSharding(mesh, P("data"))
    pools = tuple(jax.device_put(np.asarray(a), sh) for a in (o, d, rgb))
    sg = renderer.skip_grid(occ)

    losses = {}
    for march in ("dense", "skip"):
        step_fn = make_train_step(
            renderer, optimizer, cfg, mesh, n_cand=64,
            deterministic=True, march=march,
        )
        params = jax.tree_util.tree_map(jnp.array, params0)
        opt_state = optimizer.init(params)
        grid_args = (sg,) if march == "skip" else ()
        _, _, m = step_fn(
            params, opt_state, occ, *grid_args, *pools, jax.random.PRNGKey(1)
        )
        losses[march] = float(m["loss"])
    assert np.isfinite(losses["dense"])
    assert np.allclose(losses["dense"], losses["skip"], rtol=1e-5, atol=1e-7)


# ------------------------------------------------------- unbounded marching

def make_unbounded_renderer(res=16, n_samples=64, skip_steps=None):
    from tinynerf.core import ContractionMip360, RayMarcherUnbounded

    marcher = RayMarcherUnbounded(n_samples=n_samples, near=0.1, far=1e5,
                                  uniform_range=2.0)
    field = KPlanesFeatureField(feature_dim_per_plane=4, resolutions=(9, 17))
    return NerfRenderer(
        field=field,
        sigma_decoder=OpacityDecoder(field.feature_dim),
        rgb_decoder=ColorDecoder(2, field.feature_dim, 16, 1),
        marcher=marcher,
        contraction=ContractionMip360(),
        occupancy=OccupancyGrid.cube(res, marcher.step_size),
        bg_color=(1.0, 1.0, 1.0),
        skip_steps=skip_steps or n_samples,
    )


def test_skip_grid_iso_conservative():
    from tinynerf.core.skipmarch import make_skip_grid_iso

    res = 12
    occ_b = (jax.random.uniform(jax.random.PRNGKey(5), (res, res, res)) < 0.08)
    grid = np.asarray(make_skip_grid_iso(occ_b))
    occ = np.asarray(occ_b)
    assert (grid[occ] == 0).all()
    for v in np.argwhere(grid > 1):
        r = int(grid[tuple(v)]) - 1  # certified Chebyshev-empty radius
        lo = np.maximum(v - r, 0)
        hi = np.minimum(v + r + 1, res)
        assert not occ[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].any(), (
            f"voxel {v} radius {r} not empty"
        )


@pytest.mark.parametrize("density,seed", [(0.05, 0), (0.2, 1)])
def test_unbounded_skip_march_equals_dense(density, seed):
    """Unbounded (Mip-360) skip marching: emitted set == dense surviving set
    with and without jitter (curved contracted-space paths, isotropic
    certification)."""
    res, S = 16, 64
    renderer = make_unbounded_renderer(res=res, n_samples=S)
    occ = random_occ(renderer, res, density, seed)
    o, d = random_rays(256, seed)
    sg = renderer.skip_grid(occ)
    params = renderer.init(jax.random.PRNGKey(0))

    for key in (None, jax.random.PRNGKey(11)):
        _, _, maskf = renderer._march(o, d, occ, key)
        dense = np.asarray(maskf > 0)
        cpos, deltas, maskb, complete = renderer._march_skip(o, d, sg, key)
        assert bool(np.asarray(complete).all())
        # reconstruct the emitted sample-index set per ray
        out_d = renderer.render_packed(params, occ, o, d, cap=16384, key=key)
        out_s = renderer.render_packed(
            params, occ, o, d, cap=16384, key=key, march="skip", skip_grid=sg
        )
        assert int(out_d.n_samples) == int(out_s.n_samples), (
            f"jitter={key is not None}: {int(out_d.n_samples)} vs "
            f"{int(out_s.n_samples)}"
        )
        np.testing.assert_allclose(
            np.asarray(out_d.rgb), np.asarray(out_s.rgb), atol=2e-5
        )
        np.testing.assert_array_equal(
            np.asarray(out_d.ray_valid), np.asarray(out_s.ray_valid)
        )


def test_skip_march_equals_dense_mask_anisotropic_aabb():
    """Non-cubic AABB over a cubic grid: per-axis voxel sizes differ, so the
    dominant axis must be chosen by INDEX rate |d_a|/w_a (a world-space |d|
    pick would let a finer lateral axis outrun the cone certificate and skip
    occupied voxels)."""
    aniso = ((-1.5, -0.6, -1.5), (1.5, 0.6, 1.5))  # y voxels 2.5x finer
    res, S = 16, 64
    marcher = RayMarcherAABB(aniso, n_samples=S, near=0.1)
    field = KPlanesFeatureField(feature_dim_per_plane=4, resolutions=(9, 17))
    renderer = NerfRenderer(
        field=field,
        sigma_decoder=OpacityDecoder(field.feature_dim),
        rgb_decoder=ColorDecoder(2, field.feature_dim, 16, 1),
        marcher=marcher,
        contraction=ContractionAABB(aniso),
        occupancy=OccupancyGrid.cube(res, marcher.step_size),
        bg_color=(1.0, 1.0, 1.0),
        skip_steps=S,
    )
    for seed, density in ((0, 0.05), (1, 0.2)):
        occ = random_occ(renderer, res, density, seed)
        o, d = random_rays(256, seed + 20)
        sg = renderer.skip_grid(occ)
        for key in (None, jax.random.PRNGKey(13)):
            _, _, maskf = renderer._march(o, d, occ, key)
            dense = np.asarray(maskf > 0)
            jkey = jax.random.fold_in(key, 0) if key is not None else None
            t_min, t_exit = marcher.entry_exit(o, d)
            k_idx, complete = skip_march(
                o, d, t_min, t_exit, marcher.step_size, S,
                renderer.contraction, sg, jkey, S,
            )
            assert bool(np.asarray(complete).all())
            k_idx = np.asarray(k_idx)
            skip = np.zeros_like(dense)
            for r in range(k_idx.shape[0]):
                ks = k_idx[r][k_idx[r] >= 0]
                skip[r, ks] = True
            np.testing.assert_array_equal(dense, skip)


def test_supports_skip_march_requires_nearest_occupancy():
    """Trilinear occupancy queries change the dense path's culling
    criterion; the skip path must refuse rather than silently diverge."""
    import dataclasses

    r = make_renderer()
    assert r.supports_skip_march
    r_tri = dataclasses.replace(
        r, occupancy=dataclasses.replace(r.occupancy, interp="trilinear")
    )
    assert not r_tri.supports_skip_march


def test_unbounded_local_lipschitz_certificate_sound():
    """Property test of the LOCAL Lipschitz advance formula
    (skip_march_unbounded): for adversarial probe geometry (tangential rays
    at near-diagonal points, where the order-inf contraction's directional
    constant reaches ~sqrt(6)/n_2, NOT 1/n_2), the true contracted Chebyshev
    displacement over the certified advance must stay within the certified
    radius rho.  The pre-fix 1/n_eff formula violates this by up to 2.33x
    (measured); the F(m0) bound must not."""
    LIP = 0.5065

    def contract(x):
        n = np.max(np.abs(x), axis=-1, keepdims=True)
        safe = np.maximum(n, 1e-12)
        c = np.where(n <= 1.0, x, (2.0 - 1.0 / safe) * x / safe)
        return c / 2.0

    def l_inv_fixed(n_eff):
        # mirrors skip_march_unbounded's advance formula
        m0 = max(n_eff / np.sqrt(3.0), 1.3)
        f_m0 = np.sqrt((1 - 0.5 / m0) ** 2 + (1 - 1.0 / m0) ** 2) / m0
        if n_eff >= 2.25:
            return max(1.0 / f_m0, 1.0 / LIP)
        return 1.0 / LIP

    rng = np.random.default_rng(0)
    worst = 0.0
    for trial in range(20000):
        m = np.exp(rng.uniform(np.log(1.05), np.log(40)))
        u = rng.choice([-1, 1], 3) * (1.0 - np.abs(rng.normal(size=3)) * 0.03)
        p = u / np.max(np.abs(u)) * m
        d = rng.normal(size=3)
        if trial % 2 == 0:  # tangential = adversarial
            ph = p / np.linalg.norm(p)
            d = d - ph * (d @ ph)
        d /= np.linalg.norm(d)
        n2 = np.linalg.norm(p)
        t_rel = -(p @ d)
        n_perp = np.linalg.norm(p + d * t_rel)
        n_eff = max(1.0, n_perp if t_rel > 0 else n2)
        li = l_inv_fixed(n_eff)
        for rho in (0.02, 0.05, 0.1, 0.2):
            adv = rho * li
            ss = np.linspace(0.0, adv, 33)[1:]
            disp = np.max(
                np.abs(contract(p + d * ss[:, None]) - contract(p)), axis=-1
            )
            worst = max(worst, float(disp.max() / rho))
    assert worst <= 1.0 + 1e-6, (
        f"certified advance overshoots the empty ball: disp/rho = {worst:.3f}"
    )


def test_unbounded_skip_march_diagonal_far_field():
    """Adversarial geometry for the LOCAL Lipschitz certificate: isolated
    occupied voxels near the contracted-space cube DIAGONALS in the far
    field, probed by near-diagonal rays.  For the order-inf Mip-360
    contraction the Euclid-in/Cheb-out Jacobian norm near diagonals is
    ~sqrt(2)/||x||_inf (~sqrt(6)/||x||_2) — ~2.4x the Euclidean-contraction
    1/n bound — so an advance certified with 1/n can overjump an occupied
    voxel the dense path samples.  Exact set equality must hold anyway."""
    res, S = 32, 128
    renderer = make_unbounded_renderer(res=res, n_samples=S)

    # occupancy: single voxels along the 8 diagonal directions at several
    # far-field contracted radii (|c| in the outer shell), plus their
    # near-diagonal jitters
    g = np.zeros((res, res, res), np.float32)
    rng = np.random.default_rng(7)
    centers = (np.arange(res) + 0.5) / res * 2.0 - 1.0  # voxel centers
    for sx in (-1, 1):
        for sy in (-1, 1):
            for sz in (-1, 1):
                for c_r in (0.55, 0.7, 0.8, 0.9):
                    base = np.array([sx, sy, sz]) * c_r
                    for _ in range(4):
                        p = base + rng.normal(size=3) * 0.02
                        idx = np.clip(
                            np.round((p + 1.0) * 0.5 * (res - 1)), 0, res - 1
                        ).astype(int)
                        g[tuple(idx)] = 1.0
    occ = renderer.occupancy.init_state()
    occ = occ._replace(grid=jnp.asarray(g), mean=jnp.float32(g.mean()))
    sg = renderer.skip_grid(occ)
    params = renderer.init(jax.random.PRNGKey(0))

    # near-diagonal rays from near the origin outward (the far-field samples
    # walk the disparity tail along the diagonals)
    n = 512
    signs = rng.choice([-1.0, 1.0], size=(n, 3))
    d = signs / np.sqrt(3.0) + rng.normal(size=(n, 3)) * 0.05
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    o = jnp.asarray(o.astype(np.float32))
    d = jnp.asarray(d.astype(np.float32))

    for key in (None, jax.random.PRNGKey(23)):
        _, _, _, complete = renderer._march_skip(o, d, sg, key)
        assert bool(np.asarray(complete).all())
        out_d = renderer.render_packed(params, occ, o, d, cap=16384, key=key)
        out_s = renderer.render_packed(
            params, occ, o, d, cap=16384, key=key, march="skip", skip_grid=sg
        )
        assert int(out_d.n_samples) == int(out_s.n_samples), (
            f"jitter={key is not None}: dense {int(out_d.n_samples)} vs "
            f"skip {int(out_s.n_samples)} samples"
        )
        np.testing.assert_allclose(
            np.asarray(out_d.rgb), np.asarray(out_s.rgb), atol=2e-5
        )


@pytest.mark.parametrize("blob_r,seed", [(3, 3), (6, 4)])
def test_unbounded_skip_march_far_field_budget(blob_r, seed):
    """A REDUCED scan budget must still complete on unbounded scenes: the
    disparity tail reaches t ~ hundreds of world units, so fixed-size
    advances bounded by the global 1/2-Lipschitz certificate exhaust any
    budget < n_samples out there.  The local bound (Jacobian norm < 1/n past
    radius n, closed-form minimum radius over the remaining ray) makes far-
    field advances grow ~linearly with radius; with it a sub-S budget of 40
    completes every ray and emits the exact dense sample set (the global
    bound caps advances at ~0.9 world units/step here, needing ~73 > S
    steps to reach the t~66 tail, so NO budget <= S completes).  Occupancy
    is a central blob (the realistic converged state: scene content near
    the origin, empty far field)."""
    res, S, budget = 32, 64, 40
    renderer = make_unbounded_renderer(res=res, n_samples=S, skip_steps=budget)
    ax = np.arange(res, dtype=np.float32) - (res - 1) / 2
    rr = np.sqrt(
        ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2
    )
    g = jnp.asarray((rr <= blob_r).astype(np.float32))
    occ = renderer.occupancy.init_state()._replace(
        grid=g, mean=jnp.float32(g.mean())
    )
    o, d = random_rays(256, seed + 40)
    sg = renderer.skip_grid(occ)
    params = renderer.init(jax.random.PRNGKey(0))

    for key in (None, jax.random.PRNGKey(17)):
        cpos, deltas, maskb, complete = renderer._march_skip(o, d, sg, key)
        assert bool(np.asarray(complete).all()), (
            f"jitter={key is not None}: "
            f"{int((~np.asarray(complete)).sum())}/256 rays exhausted the "
            f"{budget}-step budget"
        )
        out_d = renderer.render_packed(params, occ, o, d, cap=16384, key=key)
        out_s = renderer.render_packed(
            params, occ, o, d, cap=16384, key=key, march="skip", skip_grid=sg
        )
        assert int(out_d.n_samples) == int(out_s.n_samples)
        np.testing.assert_allclose(
            np.asarray(out_d.rgb), np.asarray(out_s.rgb), atol=2e-5
        )

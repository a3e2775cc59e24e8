"""Core renderer tests: contraction, marching, occupancy, interpolation, and
end-to-end dense + packed rendering (mirrors + extends the reference's
tests/test_core.py; the reference's render smoke test needed CUDA — here
everything is device-agnostic)."""

import jax
import jax.numpy as jnp
import numpy as np

from tinynerf.core import (
    ContractionAABB,
    ContractionMip360,
    NerfRenderer,
    OccupancyGrid,
    RayMarcherAABB,
    RayMarcherUnbounded,
)
from tinynerf.models import make_model
from tinynerf.ops import bilinear_lookup, trilinear_lookup

KEY = jax.random.PRNGKey(0)
AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))


# ----------------------------------------------------------------- contraction

def test_contraction_mip360_range_and_identity():
    c = ContractionMip360()
    x = jax.random.normal(KEY, (1000, 3)) * 5.0
    out, mask = c(x)
    assert bool(jnp.all(jnp.abs(out) <= 1.0))
    assert bool(jnp.all(mask == 1.0))
    # inside the unit ball (inf-norm), contraction is just x/2
    x_in = jnp.array([[0.5, -0.25, 0.1]])
    out_in, _ = c(x_in)
    np.testing.assert_allclose(np.asarray(out_in), np.asarray(x_in) / 2.0, atol=1e-6)


def test_contraction_aabb():
    c = ContractionAABB(AABB)
    x = jnp.array([[0.0, 0.0, 0.0], [1.5, 1.5, 1.5], [2.0, 0.0, 0.0], [-1.5, 0.0, 0.0]])
    out, mask = c(x)
    np.testing.assert_allclose(np.asarray(out[0]), [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(out[1]), [1, 1, 1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(mask), [1, 1, 0, 1], atol=0)


# -------------------------------------------------------------------- marchers

def test_marcher_aabb_hits_box():
    m = RayMarcherAABB(AABB, n_samples=32, near=0.1)
    rays_o = jnp.array([[-3.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    rays_d = jnp.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    t, deltas = m(rays_o, rays_d)
    assert t.shape == deltas.shape == (2, 32)
    assert bool(jnp.all(deltas > 0))
    # ray starting outside enters at x=-1.5 -> t_min = 1.5 (+ the 1e-4-step
    # inward nudge that keeps the first sample off the box-surface knife edge)
    np.testing.assert_allclose(float(t[0, 0]), 1.5, atol=1e-4 * m.step_size * 1.01)
    # ray starting inside clamps to near (same nudge)
    np.testing.assert_allclose(float(t[1, 0]), 0.1, atol=1e-4 * m.step_size * 1.01)
    # uniform spacing = diag/n
    step = np.linalg.norm([3.0, 3.0, 3.0]) / 32
    np.testing.assert_allclose(np.asarray(deltas), step, rtol=1e-5)


def test_marcher_unbounded_disparity():
    m = RayMarcherUnbounded(n_samples=64, near=0.1, uniform_range=2.0)
    rays_o = jnp.zeros((3, 3))
    rays_d = jnp.eye(3)
    t, deltas = m(rays_o, rays_d)
    assert t.shape == (3, 64)
    assert bool(jnp.all(t >= 0.1))
    assert bool(jnp.all(deltas > 0))
    # t monotonic, and spacing grows toward the far half (disparity)
    assert bool(jnp.all(jnp.diff(t[0]) > 0))
    assert float(deltas[0, -1]) > float(deltas[0, 0])


# ------------------------------------------------------------------- interp

def test_bilinear_exact_at_nodes_and_center():
    table = jnp.arange(12, dtype=jnp.float32).reshape(3, 4, 1)
    # corners map exactly (align_corners)
    np.testing.assert_allclose(float(bilinear_lookup(table, jnp.array([-1.0, -1.0]))[0]), 0.0)
    np.testing.assert_allclose(float(bilinear_lookup(table, jnp.array([1.0, 1.0]))[0]), 11.0)
    # midpoint of a linear table is the mean
    mid = bilinear_lookup(table, jnp.array([0.0, 0.0]))
    np.testing.assert_allclose(float(mid[0]), table.mean(), atol=1e-5)


def test_trilinear_linear_function_reproduced():
    # a trilinear interpolant reproduces any (multi)linear function exactly
    r = 5
    g = jnp.stack(
        jnp.meshgrid(*(jnp.linspace(-1, 1, r),) * 3, indexing="ij"), axis=-1
    )
    table = (2 * g[..., :1] - 3 * g[..., 1:2] + 0.5 * g[..., 2:3])
    pts = jax.random.uniform(KEY, (50, 3), minval=-1, maxval=1)
    vals = trilinear_lookup(table, pts)
    expected = 2 * pts[:, :1] - 3 * pts[:, 1:2] + 0.5 * pts[:, 2:3]
    np.testing.assert_allclose(np.asarray(vals), np.asarray(expected), atol=1e-5)


# ------------------------------------------------------------------ occupancy

def test_occupancy_octant_semantics():
    """Hand-placed occupied/empty octants (reference tests/test_core.py:5-38)."""
    grid_cfg = OccupancyGrid.cube(16, step_size=0.1, threshold=0.01, decay=0.5)
    state = grid_cfg.init_state()
    # empty the -x half, keep +x half occupied
    grid = state.grid.at[:8].set(0.0)
    state = state._replace(grid=grid, mean=jnp.mean(grid))
    pts_occ = jnp.array([[0.5, 0.0, 0.0], [0.9, 0.5, -0.5]])
    pts_emp = jnp.array([[-0.5, 0.0, 0.0], [-0.9, -0.5, 0.5]])
    assert bool(jnp.all(grid_cfg.query(state, pts_occ) == 1.0))
    assert bool(jnp.all(grid_cfg.query(state, pts_emp) == 0.0))


def test_occupancy_update_decay_and_confirm():
    grid_cfg = OccupancyGrid.cube(8, step_size=0.5, threshold=0.01, decay=0.5)
    state = grid_cfg.init_state()

    def sigma_fn(x):  # dense only where x[...,0] > 0
        return jnp.where(x[:, 0] > 0.0, 100.0, 0.0)

    for i in range(10):
        state = grid_cfg.update(state, sigma_fn, jax.random.PRNGKey(i))
    # +x half confirmed occupied; -x half decayed to 0.5^10 < threshold
    assert float(state.grid[6, 4, 4]) == 1.0
    np.testing.assert_allclose(float(state.grid[1, 4, 4]), 0.5**10, rtol=1e-5)
    occ = float(grid_cfg.occupancy(state))
    assert 0.4 < occ < 0.6


def test_occupancy_update_jits():
    grid_cfg = OccupancyGrid.cube(8, step_size=0.5)
    state = grid_cfg.init_state()
    fn = jax.jit(lambda s, k: grid_cfg.update(s, lambda x: jnp.ones(x.shape[0]), k))
    out = fn(state, KEY)
    assert out.grid.shape == (8, 8, 8)


# ------------------------------------------------------------ end-to-end render

def _make_renderer(method="vanilla", n_samples=32, with_occupancy=True):
    # quarter-capacity fields: these tests exercise the RENDERER's semantics
    # (shapes, packing, compositing, gradients), which are field-size
    # agnostic; full-size tables cost tens of seconds of CPU compile each
    field, sigma_dec, rgb_dec = make_model(method, field_scale=0.25)
    marcher = RayMarcherAABB(AABB, n_samples=n_samples, near=0.1)
    occ = OccupancyGrid.cube(16, marcher.step_size) if with_occupancy else None
    return NerfRenderer(
        field=field,
        sigma_decoder=sigma_dec,
        rgb_decoder=rgb_dec,
        marcher=marcher,
        contraction=ContractionAABB(AABB),
        occupancy=occ,
        bg_color=(1.0, 1.0, 1.0),
    )


def test_render_dense_shapes_and_ranges():
    r = _make_renderer()
    params = r.init(KEY)
    occ_state = r.occupancy.init_state()
    rays_o = jnp.zeros((100, 3))
    rays_d = jax.random.normal(KEY, (100, 3))
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    out = r.render_dense(params, occ_state, rays_o, rays_d)
    assert out.rgb.shape == (100, 3)
    assert bool(jnp.all((out.opacity >= 0) & (out.opacity <= 1 + 1e-5)))
    assert bool(jnp.all(jnp.isfinite(out.rgb)))


def test_render_packed_matches_dense():
    """With a generous cap, the packed path must equal the dense path."""
    r = _make_renderer(n_samples=16)
    params = r.init(KEY)
    occ_state = r.occupancy.init_state()
    rays_o = jnp.zeros((32, 3))
    rays_d = jax.random.normal(jax.random.PRNGKey(3), (32, 3))
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)

    dense = r.render_dense(params, occ_state, rays_o, rays_d)
    packed = r.render_packed(params, occ_state, rays_o, rays_d, cap=32 * 16)
    assert bool(jnp.all(packed.ray_valid == 1.0))
    np.testing.assert_allclose(np.asarray(packed.rgb), np.asarray(dense.rgb), atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(packed.opacity), np.asarray(dense.opacity), atol=1e-4
    )


def test_render_packed_overflow_flags_rays():
    r = _make_renderer(n_samples=16)
    params = r.init(KEY)
    occ_state = r.occupancy.init_state()
    rays_o = jnp.zeros((32, 3))
    rays_d = jax.random.normal(jax.random.PRNGKey(3), (32, 3))
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)

    small_cap = 64  # not enough for 32 rays x ~16 valid samples
    packed = r.render_packed(params, occ_state, rays_o, rays_d, cap=small_cap)
    valid = np.asarray(packed.ray_valid)
    assert valid.sum() < 32  # some rays flagged
    assert valid.sum() >= 1  # prefix rays still fit
    # validity = ray-major prefix that fit, plus zero-sample rays (which
    # render exact bg wherever they sit)
    t, deltas = r.marcher(rays_o, rays_d)
    pos = np.asarray(rays_o)[:, None, :] + np.asarray(rays_d)[:, None, :] * np.asarray(t)[..., None]
    cpos, maskf = r.contraction(pos)
    maskf = np.asarray(maskf * r.occupancy.query(occ_state, cpos))
    counts = maskf.sum(-1)
    ends = np.cumsum(counts)
    expected = ((ends <= small_cap) | (counts == 0)).astype(np.float32)
    np.testing.assert_array_equal(valid, expected)


def test_render_gradients_flow():
    # vanilla: the renderer-level grad-flow guard is field-agnostic, and the
    # K-Planes VJP stack has its own numeric suites (test_interp,
    # test_table_grad) plus the end-to-end test_train_learns_smoke; compiling
    # grad-of-render for the multiscale lookup here cost 45 s of the fast tier
    r = _make_renderer(method="vanilla", n_samples=8)
    params = r.init(KEY)
    occ_state = r.occupancy.init_state()
    rays_o = jnp.zeros((8, 3))
    rays_d = jnp.tile(jnp.array([[1.0, 0.0, 0.0]]), (8, 1))
    target = jnp.zeros((8, 3))

    def loss_fn(p):
        out = r.render_packed(p, occ_state, rays_o, rays_d, cap=64)
        return jnp.mean((out.rgb - target) ** 2)

    grads = jax.grad(loss_fn)(params)
    gnorm = jax.tree_util.tree_reduce(
        lambda a, b: a + jnp.sum(jnp.abs(b)), grads, 0.0
    )
    assert float(gnorm) > 0.0
    assert bool(jnp.isfinite(gnorm))


def test_render_packed_cap_exceeds_grid():
    """cap larger than n_rays*n_samples pads instead of erroring."""
    r = _make_renderer(n_samples=8)
    params = r.init(KEY)
    occ_state = r.occupancy.init_state()
    rays_o = jnp.zeros((4, 3))
    rays_d = jnp.tile(jnp.array([[1.0, 0.0, 0.0]]), (4, 1))
    big = r.render_packed(params, occ_state, rays_o, rays_d, cap=4 * 8 * 3)
    exact = r.render_packed(params, occ_state, rays_o, rays_d, cap=4 * 8)
    np.testing.assert_allclose(np.asarray(big.rgb), np.asarray(exact.rgb), atol=1e-5)
    assert bool(jnp.all(big.ray_valid == 1.0))


def test_render_empty_scene_gives_bg_and_finite_grads():
    """All-empty occupancy: every ray renders the background color and the
    loss/grads stay finite (the reference's 'Empty iteration' escape hatch,
    src/core.py:235-254, as a degenerate case rather than an exception)."""
    r = _make_renderer(n_samples=8)
    params = r.init(KEY)
    occ_state = r.occupancy.init_state()
    occ_state = occ_state._replace(
        grid=jnp.zeros_like(occ_state.grid), mean=jnp.float32(0.0)
    )
    rays_o = jnp.zeros((8, 3))
    rays_d = jnp.tile(jnp.array([[1.0, 0.0, 0.0]]), (8, 1))

    out = r.render_packed(params, occ_state, rays_o, rays_d, cap=64)
    np.testing.assert_allclose(np.asarray(out.rgb), 1.0, atol=1e-6)  # bg white
    assert bool(jnp.all(out.ray_valid == 1.0))
    assert int(out.n_samples) == 0

    def loss_fn(p):
        o = r.render_packed(p, occ_state, rays_o, rays_d, cap=64)
        return jnp.mean((o.rgb - 0.5) ** 2)

    grads = jax.grad(loss_fn)(params)
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(bool(jnp.all(jnp.isfinite(g))) for g in leaves)


def test_render_unbounded_scene():
    field, sigma_dec, rgb_dec = make_model("vanilla")
    marcher = RayMarcherUnbounded(n_samples=32, near=0.1, uniform_range=2.0)
    r = NerfRenderer(
        field=field,
        sigma_decoder=sigma_dec,
        rgb_decoder=rgb_dec,
        marcher=marcher,
        contraction=ContractionMip360(),
        occupancy=OccupancyGrid.cube(16, marcher.step_size),
        bg_color=None,
    )
    params = r.init(KEY)
    occ_state = r.occupancy.init_state()
    rays_o = jnp.zeros((16, 3))
    rays_d = jax.random.normal(KEY, (16, 3))
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    out = r.render_packed(params, occ_state, rays_o, rays_d, cap=16 * 32, key=KEY)
    assert out.rgb.shape == (16, 3)
    assert bool(jnp.all(jnp.isfinite(out.rgb)))


def test_occupancy_query_trilinear_matches_reference_semantics():
    """interp="trilinear" reproduces the reference's grid_sample query
    (src/core.py:147-156): smooth interpolation of the float grid, then
    > threshold."""
    grid_cfg = OccupancyGrid.cube(8, step_size=0.1, threshold=0.5,
                                  decay=0.5, interp="trilinear")
    state = grid_cfg.init_state()
    # half-occupied grid along x with a soft boundary
    grid = jnp.where(jnp.arange(8)[:, None, None] >= 4, 1.0, 0.0)
    grid = jnp.broadcast_to(grid, (8, 8, 8))
    state = state._replace(grid=grid, mean=jnp.mean(grid))
    # at x slightly past the midpoint the interpolated value crosses 0.5
    pts = jnp.array([
        [0.2, 0.0, 0.0],   # interp ~0.85 > 0.5 -> occupied
        [-0.2, 0.0, 0.0],  # interp ~0.15 < 0.5 -> empty
        [0.9, 0.0, 0.0],   # deep inside occupied
    ])
    vals = grid_cfg.query(state, pts)
    np.testing.assert_array_equal(np.asarray(vals), [1.0, 0.0, 1.0])
    # nearest-mode on the same state agrees away from the boundary
    near = OccupancyGrid.cube(8, step_size=0.1, threshold=0.5,
                              decay=0.5, interp="nearest")
    np.testing.assert_array_equal(np.asarray(near.query(state, pts[2:])), [1.0])


def test_render_packed_per_ray_dir_branch_matches():
    """rgb_dir_branch="ray" (forward-only serving optimization) must render
    the same images as the default per-sample branch."""
    r = _make_renderer(n_samples=8)
    params = r.init(KEY)
    occ_state = r.occupancy.init_state()
    rays_o = jnp.zeros((16, 3))
    rays_d = jax.random.normal(jax.random.PRNGKey(11), (16, 3))
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    ship = r.render_packed(params, occ_state, rays_o, rays_d, cap=64)
    ray = r.render_packed(
        params, occ_state, rays_o, rays_d, cap=64, rgb_dir_branch="ray"
    )
    np.testing.assert_allclose(
        np.asarray(ray.rgb), np.asarray(ship.rgb), atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(ray.ray_valid), np.asarray(ship.ray_valid)
    )

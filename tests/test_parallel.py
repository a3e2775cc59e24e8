"""Sharding-specific equality tests: the mesh-sharded paths must produce the
same numbers as single-device execution."""

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
from tinynerf.models import make_model
from tinynerf.parallel import make_mesh
from tinynerf.train.loop import make_occupancy_update, make_render_chunk

AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
KEY = jax.random.PRNGKey(0)


def _renderer(n_samples=16):
    # quarter capacity: sharding semantics are field-size agnostic
    field, sd, rd = make_model("kplanes", field_scale=0.25)
    marcher = RayMarcherAABB(AABB, n_samples=n_samples, near=0.1)
    return NerfRenderer(
        field=field,
        sigma_decoder=sd,
        rgb_decoder=rd,
        marcher=marcher,
        contraction=ContractionAABB(AABB),
        occupancy=OccupancyGrid.cube(16, marcher.step_size),
        bg_color=(1.0, 1.0, 1.0),
    )


def test_sharded_render_chunk_matches_single():
    r = _renderer()
    params = r.init(KEY)
    occ = r.occupancy.init_state()
    rays_o = jnp.zeros((64, 3))
    d = jax.random.normal(jax.random.PRNGKey(1), (64, 3))
    rays_d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    single = make_render_chunk(r, None)(params, occ, rays_o, rays_d)
    mesh = make_mesh(jax.devices()[:8])
    sharded = make_render_chunk(r, mesh)(params, occ, rays_o, rays_d)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single), atol=1e-5)


@pytest.mark.slow
def test_sharded_occupancy_update_matches_single():
    r = _renderer()
    params = r.init(KEY)
    occ0 = r.occupancy.init_state()

    single_fn = make_occupancy_update(r, None)
    mesh = make_mesh(jax.devices()[:8])
    sharded_fn = make_occupancy_update(r, mesh)

    k = jax.random.PRNGKey(7)
    single = single_fn(params, occ0, k)
    sharded = sharded_fn(params, occ0, k)
    np.testing.assert_allclose(
        np.asarray(sharded.grid), np.asarray(single.grid), atol=1e-6
    )
    np.testing.assert_allclose(
        float(sharded.mean), float(single.mean), atol=1e-6
    )

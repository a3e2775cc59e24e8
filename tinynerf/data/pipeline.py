"""Device-facing data containers.

The reference feeds the GPU through a torch DataLoader with 8 worker processes
and pinned-memory H2D copies per step (reference src/run.py:116-122, 226-228).
Here the design is the opposite: the entire ray pool is resident in device
memory (a Blender-synthetic scene is 100 images x 640k rays x 9 floats
~= 2.3 GB at 800x800 — fits; sharded over the mesh it shrinks per device), and a
per-step batch is a pure `jax.random` gather that fuses into the train step.
No host<->device traffic in the hot loop at all.

`RayPool`   — flattened (origin, direction, rgb) rows of all training rays.
`PoseSet`   — per-image rays/labels for rendering and eval
              (reference PoseDataset, src/data.py:78-100).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .formats import Intrinsics, NerfData


class RayPool:
    """All training rays, flattened and (optionally) device-resident.

    Equivalent of the reference's RaysDataset (src/data.py:102-120), minus the
    DataLoader: batches are sampled on device with `jax.random.randint` so the
    gather lives inside the jitted train step.

    By default arrays stay host-side numpy — train() owns device placement
    (it shards the pool over the mesh); pass device_put=True for ad-hoc
    single-device use.
    """

    def __init__(self, data: NerfData, device_put: bool = False):
        assert data.imgs is not None, "a ray pool requires ground-truth images"
        rays_o, rays_d = data.generate_rays()
        self.rays_o = np.concatenate([o.reshape(-1, 3) for o in rays_o])
        self.rays_d = np.concatenate([d.reshape(-1, 3) for d in rays_d])
        self.rgbs = np.concatenate([im.reshape(-1, 3) for im in data.imgs])
        self.scene_scale = data.scene_scale()
        self.bg_color = data.bg_color
        self.n_rays = self.rays_o.shape[0]
        if device_put:
            self.rays_o = jnp.asarray(self.rays_o)
            self.rays_d = jnp.asarray(self.rays_d)
            self.rgbs = jnp.asarray(self.rgbs)

    def arrays(self):
        return self.rays_o, self.rays_d, self.rgbs


def sample_ray_batch(key: jax.Array, pool_o, pool_d, pool_rgb, n: int):
    """Uniform-with-replacement batch of `n` rays; pure, jittable, device-side.

    (The reference shuffles epochs without replacement; for SGD at these pool
    sizes the with-replacement distinction is statistically irrelevant and the
    uniform gather is collective-free under sharding.)
    """
    idx = jax.random.randint(key, (n,), 0, pool_o.shape[0])
    return pool_o[idx], pool_d[idx], pool_rgb[idx]


class PoseSet:
    """Per-image rays for rendering/eval; host-side, images fetched lazily."""

    def __init__(self, data: NerfData):
        self.rays_o, self.rays_d = data.generate_rays()  # lists of [h,w,3]
        self.rgbs: Optional[List[np.ndarray]] = data.imgs
        self.scene_scale = data.scene_scale()
        self.bg_color = data.bg_color
        self._data = data

    def __len__(self) -> int:
        return len(self.rays_o)

    def img_intrinsics(self, idx: int) -> Intrinsics:
        return self._data.img_intrinsics(idx)

    def __getitem__(self, idx: int) -> dict:
        item = {"rays_o": self.rays_o[idx], "rays_d": self.rays_d[idx]}
        if self.rgbs is not None:
            item["rgbs"] = self.rgbs[idx]
        return item

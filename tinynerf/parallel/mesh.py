"""Device mesh + sharding utilities.

The reference is strictly single-device (SURVEY.md §2/§5: no distributed code
of any kind).  This module is the framework's NEW first-class parallelism
layer: a 1-D `Mesh(('data',))` over all devices, ray batches sharded on the
ray axis, parameters and occupancy grid replicated, gradients psum'd inside
`shard_map`.  One axis is the right shape for cards joined all to all (NVLink
within a host): every device reaches every other at the same rate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (ray) axis over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_rays(mesh: Mesh, *arrays):
    """Place ray arrays with the leading axis sharded over the mesh."""
    sh = data_sharding(mesh)
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out if len(out) > 1 else out[0]

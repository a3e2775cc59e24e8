"""Test configuration: CPU backend with 8 virtual devices so the entire suite
(including the multi-device sharding tests) runs anywhere, and a tiny
Blender-synthetic-format fixture generated from scratch so the full
parse -> rays -> render -> train path is testable offline.
"""

import json
import os
from pathlib import Path

# Must happen before the jax backend initializes.  The suite runs on the CPU
# unless JAX_PLATFORMS says otherwise: `JAX_PLATFORMS=cuda pytest -m gpu`
# runs the tests that need an NVIDIA GPU on the card.
platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = flags + " --xla_force_host_platform_device_count=8"
os.environ["XLA_FLAGS"] = flags.strip()

import jax

jax.config.update("jax_platforms", platforms)

import numpy as np
import pytest

from tinynerf.utils.fixtures import make_synthetic_scene as _make_synthetic_scene


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided here, at run time, so
    every test worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda pytest -m gpu")


@pytest.fixture(scope="session")
def synthetic_scene(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("scene") / "blob"
    _make_synthetic_scene(root)
    return root


@pytest.fixture(scope="session")
def nerfstudio_scene(tmp_path_factory) -> Path:
    """A minimal nerfstudio-format scene reusing the synthetic generator."""
    root = tmp_path_factory.mktemp("ns_scene") / "capture"
    _make_synthetic_scene(root, n_train=9, n_test=0)
    # convert to nerfstudio transforms.json
    with open(root / "transforms_train.json") as f:
        meta = json.load(f)
    res = 64
    focal = res / (2.0 * np.tan(0.5 * meta["camera_angle_x"]))
    frames = [
        {
            "file_path": fr["file_path"].lstrip("./") + ".png",
            "transform_matrix": fr["transform_matrix"],
        }
        for fr in meta["frames"]
    ]
    ns = {
        "fl_x": focal,
        "fl_y": focal,
        "cx": res / 2.0,
        "cy": res / 2.0,
        "w": res,
        "h": res,
        "frames": frames,
    }
    with open(root / "transforms.json", "w") as f:
        json.dump(ns, f)
    return root

"""Synthetic scene generation for tests/benchmarks.

Produces a miniature Blender-synthetic-format dataset (transforms_*.json +
RGBA PNGs) of an analytically-rendered soft colored blob, so the full
parse -> rays -> render -> train path can be exercised with no external
data (the reference bundles a 2-frame hotdog fixture for the same purpose;
this one is generated from scratch).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .image import write_png

CAMERA_ANGLE_X = 0.6911112070083618


def look_at_matrix(eye: np.ndarray) -> np.ndarray:
    """Camera-to-world with -z looking from `eye` at the origin, z-up world."""
    eye = np.asarray(eye, dtype=np.float64)
    forward = eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    true_up = np.cross(forward, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, true_up, forward, eye
    return m


def render_blob(cam: np.ndarray, res: int) -> np.ndarray:
    """Analytic RGBA image: alpha falls off with each ray's closest distance
    to a ball at the origin; color from the hit direction."""
    focal = res / (2.0 * np.tan(0.5 * CAMERA_ANGLE_X))
    xs = (np.arange(res) - res / 2.0 + 0.5) / focal
    ys = -(np.arange(res) - res / 2.0 + 0.5) / focal
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    dirs = np.stack([gx, gy, -np.ones_like(gx)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs @ cam[:3, :3].T
    o = cam[:3, 3]
    t_close = -(dirs @ o)
    closest = o[None, None, :] + dirs * t_close[..., None]
    dist = np.linalg.norm(closest, axis=-1)
    alpha = np.clip(1.2 - dist / 0.8, 0.0, 1.0)
    rgb = 0.5 + 0.5 * dirs
    img = np.concatenate([rgb, alpha[..., None]], -1)
    return (img * 255).astype(np.uint8)


# three lambertian spheres (center, radius, base rgb) inside the [-1.5,1.5]^3 box
_SPHERES = (
    (np.array([0.0, 0.0, 0.0]), 0.55, np.array([0.85, 0.25, 0.2])),
    (np.array([0.7, 0.5, 0.3]), 0.3, np.array([0.2, 0.6, 0.85])),
    (np.array([-0.6, 0.4, -0.4]), 0.35, np.array([0.95, 0.8, 0.25])),
)
_LIGHT = np.array([0.5, -0.3, 0.8]) / np.linalg.norm([0.5, -0.3, 0.8])


def render_spheres(cam: np.ndarray, res: int) -> np.ndarray:
    """Analytic ray-traced RGBA image of three lambertian spheres — a scene a
    radiance field can fit to high PSNR (solid surfaces, simple shading), so
    time-to-PSNR curves on it are meaningful."""
    focal = res / (2.0 * np.tan(0.5 * CAMERA_ANGLE_X))
    xs = (np.arange(res) - res / 2.0 + 0.5) / focal
    ys = -(np.arange(res) - res / 2.0 + 0.5) / focal
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    d = np.stack([gx, gy, -np.ones_like(gx)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d @ cam[:3, :3].T
    o = cam[:3, 3]

    best_t = np.full(d.shape[:2], np.inf)
    rgb = np.zeros((*d.shape[:2], 3))
    for center, radius, color in _SPHERES:
        oc = o - center
        b = np.sum(d * oc, -1)
        c = float(oc @ oc) - radius * radius
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.where(hit, disc, 0.0))
        hit &= (t > 0) & (t < best_t)
        p = o + d * t[..., None]
        n = (p - center) / radius
        shade = 0.35 + 0.65 * np.clip(n @ _LIGHT, 0.0, 1.0)
        rgb = np.where(hit[..., None], color * shade[..., None], rgb)
        best_t = np.where(hit, t, best_t)

    alpha = np.isfinite(best_t).astype(np.float64)
    img = np.concatenate([rgb, alpha[..., None]], -1)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


_RENDERERS = {"blob": render_blob, "spheres": render_spheres}


def make_synthetic_scene(
    root: Path,
    n_train: int = 2,
    n_test: int = 2,
    res: int = 64,
    kind: str = "blob",
) -> Path:
    """Write a Blender-synthetic-format scene under `root`.

    kind: "blob" (soft view-dependent blob — fast default for tests) or
    "spheres" (solid lambertian spheres — fittable to high PSNR, for
    quality/time-to-PSNR measurements).
    """
    root = Path(root)
    render = _RENDERERS[kind]
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("val", n_test), ("test", n_test)):
        frames = []
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            theta = rng.uniform(0, 2 * np.pi)
            eye = 4.0 * np.array(
                [np.cos(theta), np.sin(theta), 0.5 + 0.2 * rng.uniform()]
            )
            cam = look_at_matrix(eye)
            img = render(cam, res)
            write_png(img, root / split / f"r_{i}.png")
            frames.append(
                {"file_path": f"./{split}/r_{i}", "transform_matrix": cam.tolist()}
            )
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    return root


def make_shell_occupancy(renderer, res: int):
    """Converged-like occupancy state: a thin spherical SHELL stays occupied
    — what occupancy grids actually converge to on opaque objects (interiors
    are culled once surfaces opacify; observed on trained generated scenes,
    where steady state reaches the largest ray bucket).

    Shared by bench.py and tools/profile_step.py so both measure the same
    steady-state regime.
    """
    import jax.numpy as jnp

    occ_state = renderer.occupancy.init_state()
    ax = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    rad = np.sqrt(gx**2 + gy**2 + gz**2)
    shell = (np.abs(rad - 0.35) < 0.04).astype(np.float32)
    return occ_state._replace(
        grid=jnp.asarray(shell), mean=jnp.float32(shell.mean())
    )

"""Data-layer tests: parsing, ray generation, pools (reference model:
tests/test_data.py checks counts/dtypes/[0,1] range on its fixture)."""

import jax
import numpy as np

from tinynerf.data import (
    Intrinsics,
    NerfData,
    PoseSet,
    RayPool,
    parse_nerf_synthetic,
    parse_nerfstudio,
    pinhole_rays,
    sample_ray_batch,
)


def test_parse_synthetic(synthetic_scene):
    data = parse_nerf_synthetic(synthetic_scene, "train")
    assert data.n_img == 2
    assert data.cameras.shape == (2, 4, 4)
    assert data.cameras.dtype == np.float32
    assert data.imgs is not None and len(data.imgs) == 2
    for img in data.imgs:
        assert img.shape == (64, 64, 3)
        assert img.dtype == np.float32
        assert img.min() >= 0.0 and img.max() <= 1.0
    K = data.intrinsics
    assert isinstance(K, Intrinsics)
    assert K.w == 64 and K.h == 64
    np.testing.assert_allclose(K.fx, 64 / (2 * np.tan(0.5 * 0.6911112070083618)), rtol=1e-6)


def test_ray_generation_math(synthetic_scene):
    data = parse_nerf_synthetic(synthetic_scene, "train")
    rays_o, rays_d = data.generate_rays()
    assert rays_o[0].shape == (64, 64, 3)
    # directions normalized
    np.testing.assert_allclose(
        np.linalg.norm(rays_d[0], axis=-1), 1.0, atol=1e-5
    )
    # origins equal the camera translation everywhere
    np.testing.assert_allclose(
        rays_o[0], np.broadcast_to(data.cameras[0, :3, 3], (64, 64, 3)), atol=0
    )
    # central pixel looks along the camera -z axis
    K = data.img_intrinsics(0)
    center_dir = rays_d[0][K.h // 2, K.w // 2]
    cam_forward = -data.cameras[0][:3, 2]
    cos = center_dir @ cam_forward
    assert cos > 0.999


def test_pinhole_rays_identity_cam():
    # identity camera: rays should fan around -z, y up in image
    K = Intrinsics(fx=50.0, fy=50.0, cx=2.0, cy=2.0, w=4, h=4)
    o, d = pinhole_rays(np.eye(4, dtype=np.float32), K)
    assert o.shape == d.shape == (4, 4, 3)
    assert np.all(o == 0)
    assert np.all(d[..., 2] < 0)
    # pixel right of center has +x direction; pixel below center has -y
    assert d[2, 3, 0] > 0
    assert d[3, 2, 1] < 0


def test_scene_scale_unbiased_variance():
    cams = np.tile(np.eye(4, dtype=np.float32)[None], (3, 1, 1))
    cams[:, :3, 3] = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], dtype=np.float32)
    data = NerfData(cameras=cams, intrinsics=Intrinsics(1, 1, 1, 1, 2, 2))
    # torch-style unbiased variance of [0,1,2] is 1.0
    assert abs(data.scene_scale() - 1.0) < 1e-6


def test_ray_pool_and_batch(synthetic_scene):
    pool = RayPool(parse_nerf_synthetic(synthetic_scene, "train"))
    assert pool.n_rays == 2 * 64 * 64
    o, d, rgb = sample_ray_batch(jax.random.PRNGKey(0), *pool.arrays(), 128)
    assert o.shape == d.shape == rgb.shape == (128, 3)
    assert float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0


def test_pose_set(synthetic_scene):
    ps = PoseSet(parse_nerf_synthetic(synthetic_scene, "test"))
    assert len(ps) == 2
    item = ps[0]
    assert item["rays_o"].shape == (64, 64, 3)
    assert item["rgbs"].shape == (64, 64, 3)


def test_parse_nerfstudio_filename_splits(nerfstudio_scene, tmp_path):
    """Explicit {split}_filenames lists override the every-8th convention."""
    import json
    import shutil

    scene = tmp_path / "capture"
    shutil.copytree(nerfstudio_scene, scene)
    with open(scene / "transforms.json") as f:
        meta = json.load(f)
    names = [fr["file_path"] for fr in meta["frames"]]
    meta["train_filenames"] = names[:3]
    meta["val_filenames"] = names[3:5]
    with open(scene / "transforms.json", "w") as f:
        json.dump(meta, f)

    assert parse_nerfstudio(scene, "train").n_img == 3
    assert parse_nerfstudio(scene, "val").n_img == 2


def test_parse_nerfstudio(nerfstudio_scene):
    train = parse_nerfstudio(nerfstudio_scene, "train")
    val = parse_nerfstudio(nerfstudio_scene, "val")
    # 9 frames: every 8th (indices 0, 8) held out
    assert train.n_img == 7
    assert val.n_img == 2
    assert isinstance(train.intrinsics, Intrinsics)
    rays_o, rays_d = val.generate_rays()
    np.testing.assert_allclose(np.linalg.norm(rays_d[0], axis=-1), 1.0, atol=1e-5)


def test_parses_reference_dummy_fixture():
    """Cross-check on REAL reference-format data: the reference ships a
    2-frame miniature of Blender-synthetic hotdog (reference
    tests/dummy/hotdog); our parser must load it (read-only)."""
    import pytest
    from pathlib import Path

    ref = Path("/root/reference/tests/dummy/hotdog")
    if not ref.exists():
        pytest.skip("reference fixture not available")
    data = parse_nerf_synthetic(ref, "train")
    assert len(data.imgs) == 2
    assert data.imgs[0].shape == (200, 200, 3)
    assert data.cameras.shape == (2, 4, 4)
    assert float(data.imgs[0].min()) >= 0.0 and float(data.imgs[0].max()) <= 1.0
    pool = RayPool(data)
    assert pool.n_rays == 2 * 200 * 200
    # ray directions are unit-norm
    n = np.linalg.norm(pool.rays_d, axis=-1)
    np.testing.assert_allclose(n, 1.0, atol=1e-5)

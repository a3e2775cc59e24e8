"""Native C++ loader: builds, decodes, and matches the pure-Python path
bit-for-bit; the pure-Python PNG codec round-trips and matches Pillow."""

import sys

import numpy as np
import pytest

from tinynerf import native
from tinynerf.data.parsers import _load_image_rgb
from tinynerf.utils.image import read_png, write_png


@pytest.fixture(scope="module")
def png_paths(synthetic_scene):
    return sorted((synthetic_scene / "train").glob("*.png"))


def test_native_builds_and_loads(png_paths):
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    out = native.load_images(png_paths, (1.0, 1.0, 1.0))
    assert out is not None
    assert out.shape == (len(png_paths), 64, 64, 3)
    assert out.dtype == np.float32
    assert out.min() >= 0.0 and out.max() <= 1.0


def test_native_matches_pil(png_paths):
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    out = native.load_images(png_paths, (1.0, 1.0, 1.0))
    for i, p in enumerate(png_paths):
        py = _load_image_rgb(p, (255, 255, 255))
        # native and pure-Python paths both port Pillow's integer
        # compositing exactly, so results are bit-identical
        np.testing.assert_array_equal(out[i], py)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_round_trip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    arr = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    write_png(arr, tmp_path / "x.png")
    np.testing.assert_array_equal(read_png(tmp_path / "x.png"), arr)


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L"])
def test_png_decode_matches_pillow(tmp_path, mode, monkeypatch):
    """Without Pillow, Pillow-written PNGs (its own filter choices,
    including Sub/Up/Average/Paeth) decode and composite to Pillow's own
    result."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    # smooth gradients + noise make Pillow's adaptive filtering pick every
    # filter type
    yy, xx = np.mgrid[0:31, 0:29]
    base = (xx * 7 + yy * 3)[..., None] + rng.integers(0, 9, (31, 29, 4))
    arr = (base % 256).astype(np.uint8)
    img = Image.fromarray(arr, "RGBA").convert(mode)
    img.save(tmp_path / "p.png")
    ref = img.convert("RGBA") if mode == "RGBA" else img.convert("RGB")
    if mode == "RGBA":
        bg = Image.new("RGBA", img.size, (255, 255, 255))
        ref = Image.alpha_composite(bg, ref).convert("RGB")
    want = np.asarray(ref, np.float32) / np.float32(255.0)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL -> ImportError
    got = _load_image_rgb(tmp_path / "p.png", (255, 255, 255))
    np.testing.assert_array_equal(got, want)


def test_native_nonexistent_file():
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    from pathlib import Path

    assert native.load_images([Path("/nonexistent/x.png")], (1, 1, 1)) is None


def test_parser_uses_native_or_falls_back(synthetic_scene):
    """parse_nerf_synthetic must give identical results either way."""
    from tinynerf.data import parse_nerf_synthetic

    data = parse_nerf_synthetic(synthetic_scene, "train")
    assert len(data.imgs) == 2
    assert data.imgs[0].shape == (64, 64, 3)

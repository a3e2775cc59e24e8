"""Dataset parsers: Blender-synthetic and nerfstudio/COLMAP formats.

Parity targets:
  * `parse_nerf_synthetic` — reference src/data.py:123-158 (transforms_{split}.json,
    focal from camera_angle_x, RGBA alpha-composited over a bg color, [0,1] floats).
  * `parse_nerfstudio` — the reference only has a stub (src/data.py:162-167) while
    its README claims COLMAP loading; here it is implemented for real against the
    nerfstudio `transforms.json` format (per-frame or global intrinsics,
    train/val/test filename lists or the every-8th-frame eval convention).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..utils.image import read_png
from .formats import Intrinsics, NerfData


def _composite_u8(rgba: np.ndarray, bg_color: Tuple[int, int, int]) -> np.ndarray:
    """[h,w,4] uint8 over an opaque `bg_color` -> [h,w,3] uint8, in Pillow's
    AlphaComposite integer math (7 precision bits) — the same arithmetic as
    the native loader (native/loader.cpp), so every path gives equal bits."""
    a = rgba[..., 3:].astype(np.uint32)
    coef1 = a << 7  # a * 255 * 255 * 2^7 / (255 * 255)
    coef2 = (255 << 7) - coef1
    bg = np.asarray(bg_color, np.uint32)
    tmp = rgba[..., :3].astype(np.uint32) * coef1 + bg * coef2 + (0x80 << 7)
    return ((tmp + (tmp >> 8)) >> 15).astype(np.uint8)


def _read_u8(path: Path) -> np.ndarray:
    """Decode to [h,w,3|4] uint8 with Pillow when it is installed (any
    format; RGBA kept, every other mode converted to RGB), else with the
    standard-library PNG decoder."""
    try:
        from PIL import Image
    except ImportError:
        arr = read_png(path)
        if arr.shape[-1] in (1, 2):  # gray (+ alpha)
            arr = np.concatenate([arr[..., :1]] * 3 + [arr[..., 1:]], axis=-1)
        return arr
    with Image.open(path) as img:
        return np.asarray(img if img.mode in ("RGB", "RGBA") else img.convert("RGB"))


def _load_image_rgb(path: Path, bg_color: Tuple[int, int, int]) -> np.ndarray:
    """Load an image; alpha-composite RGBA over `bg_color`; return [h,w,3] float32 in [0,1]."""
    arr = _read_u8(Path(path))
    if arr.shape[-1] == 4:
        arr = _composite_u8(arr, bg_color)
    return arr.astype(np.float32) / np.float32(255.0)


def parse_nerf_synthetic(
    scene_path: Path,
    split: str = "train",
    bg_color: Tuple[int, int, int] = (255, 255, 255),
) -> NerfData:
    """Blender-synthetic (original NeRF dataset) loader.

    Reads `transforms_{split}.json`; focal length derives from `camera_angle_x`
    as w / (2 tan(angle/2)); principal point at the image center.
    """
    scene_path = Path(scene_path)
    bg = np.array(bg_color, dtype=np.float32) / np.float32(255.0)

    with open(scene_path / f"transforms_{split}.json") as f_in:
        meta = json.load(f_in)

    paths = [
        (scene_path / frame["file_path"]).with_suffix(".png")
        for frame in meta["frames"]
    ]
    cameras = [
        np.array(frame["transform_matrix"], dtype=np.float32)
        for frame in meta["frames"]
    ]

    # fast path: the native C++ thread-pool loader (tinynerf/native)
    from .. import native

    batch = native.load_images(paths, tuple(float(c) for c in bg))
    if batch is not None:
        imgs: List[np.ndarray] = list(batch)
    else:  # Pillow / pure-Python fallback
        imgs = [_load_image_rgb(p, bg_color) for p in paths]

    if not imgs:
        raise ValueError(f"empty dataset split {split!r} in {scene_path}")
    h, w = imgs[0].shape[:2]
    camera_angle_x = float(meta["camera_angle_x"])
    focal = w / (2.0 * np.tan(0.5 * camera_angle_x))
    intrinsics = Intrinsics(focal, focal, w / 2.0, h / 2.0, w, h)
    return NerfData(
        cameras=np.stack(cameras).astype(np.float32),
        intrinsics=intrinsics,
        imgs=imgs,
        bg_color=bg,
    )


def parse_nerfstudio(
    scene_path: Path,
    split: str = "train",
    bg_color: Tuple[int, int, int] = (255, 255, 255),
) -> NerfData:
    """nerfstudio data format (`ns-process-data` output: COLMAP-derived poses).

    Format: a single `transforms.json` with global and/or per-frame intrinsics
    (fl_x, fl_y, cx, cy, w, h), per-frame `file_path` + `transform_matrix`
    (camera-to-world, OpenGL convention — same as Blender synthetic).

    Splits: honors `train_filenames` / `val_filenames` / `test_filenames` when
    present; otherwise applies the nerfstudio convention of holding out every
    8th frame for val/test.  Radial/tangential distortion coefficients, if
    present, are ignored (rays are generated for the ideal pinhole model).
    """
    scene_path = Path(scene_path)
    bg = np.array(bg_color, dtype=np.float32) / np.float32(255.0)

    with open(scene_path / "transforms.json") as f_in:
        meta = json.load(f_in)

    frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])

    split_key = f"{split}_filenames"
    if split_key in meta and meta[split_key]:
        names = set(meta[split_key])
        frames = [fr for fr in frames if fr["file_path"] in names]
    else:
        # every-8th-frame holdout: frames 0, 8, 16, ... are eval
        if split == "train":
            frames = [fr for i, fr in enumerate(frames) if i % 8 != 0]
        else:  # val / test share the holdout
            frames = [fr for i, fr in enumerate(frames) if i % 8 == 0]

    def frame_intrinsics(frame: dict) -> Intrinsics:
        def get(key, default=None):
            if key in frame:
                return frame[key]
            if key in meta:
                return meta[key]
            return default

        w, h = int(get("w")), int(get("h"))
        fl_x = float(get("fl_x"))
        fl_y = float(get("fl_y", fl_x))
        cx = float(get("cx", w / 2.0))
        cy = float(get("cy", h / 2.0))
        return Intrinsics(fl_x, fl_y, cx, cy, w, h)

    imgs: List[np.ndarray] = []
    cameras: List[np.ndarray] = []
    intrinsics_list: List[Intrinsics] = []

    for frame in frames:
        image_path = scene_path / frame["file_path"]
        imgs.append(_load_image_rgb(image_path, bg_color))
        cameras.append(np.array(frame["transform_matrix"], dtype=np.float32))
        intrinsics_list.append(frame_intrinsics(frame))

    if not cameras:
        raise ValueError(f"no frames for split {split!r} in {scene_path}")

    # Collapse to a single shared Intrinsics when all frames agree.
    intrinsics: Intrinsics | List[Intrinsics]
    if all(k == intrinsics_list[0] for k in intrinsics_list):
        intrinsics = intrinsics_list[0]
    else:
        intrinsics = intrinsics_list

    return NerfData(
        cameras=np.stack(cameras).astype(np.float32),
        intrinsics=intrinsics,
        imgs=imgs,
        bg_color=bg,
    )

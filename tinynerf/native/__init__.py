"""ctypes binding for the native loader, with lazy on-demand compilation.

The shared object is built once with g++ and cached next to the source
(keyed on source mtime).  Everything degrades gracefully: if the toolchain
or libpng is missing, `load_images` returns None and callers fall back to
the pure-Python decoder (data/parsers.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "loader.cpp"
_SO = _HERE / "_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # compile to a private temp file and rename into place so concurrent
    # builders (parallel test workers, multi-host jobs on a shared FS)
    # cannot interleave writes into the cached .so
    tmp = _SO.with_suffix(f".tmp.{os.getpid()}")
    cmd = [
        "g++", "-O3", "-fPIC", "-shared", "-std=c++17",
        str(_SRC), "-lpng", "-lz", "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None:
            return _lib
        if _tried:
            return None
        _tried = True
        try:
            stale = (not _SO.exists()) or _SO.stat().st_mtime < _SRC.stat().st_mtime
        except OSError:
            # source missing (e.g. binary-only install): use the .so if we
            # have one, otherwise degrade to the pure-Python path
            stale = not _SO.exists()
        if stale and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            return None
        lib.tn_png_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.tn_png_dims.restype = ctypes.c_int
        lib.tn_load_pngs.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            ctypes.c_float,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.tn_load_pngs.restype = ctypes.c_int
        _lib = lib
        return _lib


def load_images(
    paths: List[Path], bg_color: Tuple[float, float, float], n_threads: int = 8
) -> Optional[np.ndarray]:
    """Decode same-sized PNGs into [n, h, w, 3] float32 in [0,1], RGBA
    composited over bg_color (values in [0,1]).  None if unavailable."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    if not all(str(p).lower().endswith(".png") for p in paths):
        return None

    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.tn_png_dims(str(paths[0]).encode(), ctypes.byref(w), ctypes.byref(h)):
        return None

    n = len(paths)
    out = np.empty((n, h.value, w.value, 3), dtype=np.float32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.tn_load_pngs(
        c_paths,
        n,
        w.value,
        h.value,
        float(bg_color[0]),
        float(bg_color[1]),
        float(bg_color[2]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(os.environ.get("TINYNERF_LOADER_THREADS", n_threads)),
    )
    if rc:
        return None
    return out

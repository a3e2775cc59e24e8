"""Process set-up shared by the entry points (train.py, bench.py,
chip_smoke.py): the persistent compile cache and the GPU device guard."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Mapping, Optional

REPO_ROOT = Path(__file__).resolve().parents[2]


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> Path:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<repo>/.jax_cache` — a
    fixed path, since the cache directory is part of what makes a hit."""
    environ = os.environ if environ is None else environ
    env = environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else REPO_ROOT / ".jax_cache"


def enable_compile_cache() -> Path:
    """Point JAX's persistent compile cache at `compile_cache_dir()`.  A set
    `JAX_COMPILATION_CACHE_DIR` is left for JAX to read itself."""
    import jax

    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", str(path))
    return path


def require_gpu() -> None:
    """Raise unless JAX's default backend is a GPU (no CPU fallback)."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"needs an NVIDIA GPU; JAX's backend is {backend!r}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()

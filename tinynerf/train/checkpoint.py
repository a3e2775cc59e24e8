"""Checkpoint / resume.

The reference saves a single state_dict at the very end of training and has
no load path at all; the occupancy grid used for sampling is never saved
(SURVEY.md §5, reference src/run.py:308).  Here checkpointing is a real
subsystem: {params, optimizer state, occupancy state, step} round-trips, with
periodic saves and resume-from-latest.

Format: a single pickle of the device_get'd pytree (dicts / lists / tuples /
NamedTuples of numpy arrays) written atomically.  Deliberately dependency-
light; the pytrees involved are plain containers.
"""

from __future__ import annotations

import os
import pickle
import re
from pathlib import Path
from typing import Any, Optional, Tuple

import jax

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pkl$")

# The package's top-level name.  Checkpoints written before the package took
# it record their classes (e.g. OccupancyState) under the former name, this
# one plus a "_" suffix (README.md, "Where it comes from").
_PACKAGE = __name__.split(".")[0]


class _Unpickler(pickle.Unpickler):
    """Unpickler that reads classes recorded under the former package name
    from the present package."""

    def find_class(self, module, name):
        head, dot, rest = module.partition(".")
        if head.startswith(_PACKAGE + "_"):
            module = _PACKAGE + dot + rest
        return super().find_class(module, name)


def save_checkpoint(folder: Path, step: int, state: Any) -> Path:
    """Atomically write `state` (any pytree) as ckpt_{step}.pkl."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    host_state = jax.device_get(state)
    path = folder / f"ckpt_{step}.pkl"
    tmp = folder / f".ckpt_{step}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"step": step, "state": host_state}, f)
    os.replace(tmp, path)
    return path


def latest_checkpoint(folder: Path) -> Optional[Path]:
    folder = Path(folder)
    if not folder.is_dir():
        return None
    best: Tuple[int, Optional[Path]] = (-1, None)
    for p in folder.iterdir():
        m = _CKPT_RE.search(p.name)
        if m:
            s = int(m.group(1))
            if s > best[0]:
                best = (s, p)
    return best[1]


def load_checkpoint(path: Path) -> Tuple[int, Any]:
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    return payload["step"], payload["state"]

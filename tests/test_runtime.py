"""Process set-up: compile-cache directory choice, the GPU device guard,
and the smoke script's refusal to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from tinynerf.utils.runtime import REPO_ROOT, compile_cache_dir, require_gpu


def test_compile_cache_dir_honours_env(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")}
    assert compile_cache_dir(env) == tmp_path / "cc"


def test_compile_cache_dir_default_is_fixed_in_checkout():
    a, b = compile_cache_dir({}), compile_cache_dir({"HOME": "/elsewhere"})
    assert a == b == REPO_ROOT / ".jax_cache"
    assert (REPO_ROOT / "pyproject.toml").exists()


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="GPU"):
        require_gpu()


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(REPO_ROOT / "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the repository, the script cannot import it."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO_ROOT / "chip_smoke.py").read_text()
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        env=env, cwd=tmp_path, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_packed_weights_on_card(gpu):
    """The packed transmittance at the flagship 819,200-sample budget
    against the dense float32 reference, compiled for the card."""
    sys.path.insert(0, str(REPO_ROOT))
    import chip_smoke

    chip_smoke.check_packed_weights(1, 2048, 400, 819_200, 0.013)
    chip_smoke.check_packed_weights(2, 16_384, 100, 819_200, 0.013)

"""The program runs where only JAX and its core dependencies exist, and
its on-card entry points refuse to run without a GPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(code, env=None, **kw):
    full_env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=full_env, capture_output=True, text=True,
                          timeout=300, **kw)


def test_imports_without_pil_and_yaml():
    """The in-memory pipelines need neither PIL nor yaml: only the file
    loaders import them, when called."""
    out = _run(
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['yaml'] = None\n"
        "import tadataka_tpu.apps, tadataka_tpu.dataset\n"
        "from tadataka_tpu.dataset.image_io import rgb2gray\n"
        "import numpy as np\n"
        "print(rgb2gray(np.ones((2, 2, 3), np.uint8)).shape)\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(2, 2)"


def test_chip_smoke_refuses_cpu():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_location(tmp_path, env_dir):
    """``JAX_COMPILATION_CACHE_DIR`` wins and nothing else is set;
    without it the cache goes to the repository's ``.jax_cache``."""
    env = {}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    else:
        env["JAX_COMPILATION_CACHE_DIR"] = ""
    out = _run(
        "import jax\n"
        "from tadataka_tpu.utils.compile_cache import "
        "enable_compilation_cache\n"
        "print(enable_compilation_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n", env=env)
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()
    expected = (str(tmp_path / env_dir) if env_dir is not None
                else str(REPO / ".jax_cache"))
    assert returned == configured == expected
    if env_dir is not None:
        assert not (tmp_path / env_dir).exists()   # set, not created


@pytest.mark.parametrize("pattern", [
    r"pallas\.tpu|pallas import tpu",
    r"pltpu",
    r"default_backend\(\)\s*[!=]=\s*[\"']tpu[\"']",
])
def test_no_tpu_only_code(pattern):
    hits = [f"{path.relative_to(REPO)}:{i}"
            for path in sorted((REPO / "tadataka_tpu").rglob("*.py"))
            for i, line in enumerate(path.read_text().splitlines(), 1)
            if re.search(pattern, line)]
    assert not hits, hits

"""The port stands alone: importing every module of ``xalm_tpu_torch`` (and
``chip_smoke.py``) pulls in neither JAX nor anything of ``xalm_tpu``, and
no source file of the package imports them."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "xalm_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+ml_dtypes\b|from\s+ml_dtypes\b"
    r"|import\s+xxhash\b|from\s+xxhash\b"
    r"|import\s+xalm_tpu\b(?!_torch)|from\s+xalm_tpu\b(?!_torch))",
    re.MULTILINE,
)


def _modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ml_dtypes' or m == 'xxhash' or m == 'xalm_tpu' or m.startswith('xalm_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_source_has_no_forbidden_import(path):
    src = (ROOT / path).read_text()
    assert not FORBIDDEN.search(src), f"{path} imports jax/ml_dtypes/xxhash/xalm_tpu"

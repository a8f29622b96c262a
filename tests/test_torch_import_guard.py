"""The port imports neither JAX nor the JAX package.

* A subprocess blocks ``jax`` (``sys.modules["jax"] = None``), imports
  every module of ``repro_torch`` and serves through the CLI on the CPU.
* An AST walk of ``src/repro_torch`` and ``chip_smoke.py`` finds no
  ``import jax`` and no import of ``repro`` (``repro_torch`` is fine).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

GUARDED = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.launch.serve import main
done = main(["--arch", "qwen2-7b", "--reduced", "--paged", "--device", "cpu",
             "--requests", "2", "--max-new", "3", "--attn-backend",
             "pallas_int8"])
assert len(done) == 2
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "repro" or m.startswith("repro.") or m.startswith("jax")))
assert not bad, bad
print("GUARD-OK")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", GUARDED], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "GUARD-OK" in res.stdout


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"

"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

An AST scan of every module under src/repro_torch/ and of chip_smoke.py
shows that none imports `jax` or `repro`; a fresh interpreter imports the
whole port with both blocked.  Entry points with ``device=None`` raise
without a CUDA card and name ``device="cpu"``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import graphs, laplacian as lap, solvers
from repro_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _port_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = _imports(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_port_imports_with_jax_and_repro_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    __import__(m)\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_default_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", [
    lambda: graphs.ring_of_cliques(3, 4),
    lambda: graphs.clique_graph(20, 2),
    lambda: lap.make_edge_list(np.array([[0, 1]]), 2),
    lambda: convert.edge_list_from_numpy([0], [1], [1.0], 2),
    lambda: convert.solver_state_from_numpy(np.ones((3, 1)), 0),
    lambda: solvers.run_solver(lambda v: v, 4, solvers.SolverConfig(k=1, steps=1)),
], ids=["ring_of_cliques", "clique_graph", "make_edge_list", "edge_list_from_numpy",
        "solver_state_from_numpy", "run_solver"])
def test_entry_points_default_to_the_card(no_card, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_no_backend_environment_override(monkeypatch):
    from repro_torch.core import backend
    monkeypatch.setenv("REPRO_BACKEND", "kernel")
    assert backend.resolve_backend("auto", "cpu") == "segment"
    sources = "".join(p.read_text() for p in PORT.rglob("*.py"))
    assert "os.environ" not in sources and "getenv" not in sources

"""Boundaries of the port: what it imports, where it runs, what it rejects.

* no module under ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of ``repro`` (checked on the source and by importing
  every module in a fresh interpreter);
* every entry point runs on the CUDA card unless ``device="cpu"`` is
  passed, and raises without a card;
* knobs the port does not have yet raise ``NotImplementedError`` naming
  the ROADMAP item; ``backend="pallas"`` points to ``"cuda"``;
* the CPU path launches no kernel.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import BlockJacobi, Jacobi, Solver, solve
from repro_torch.core.plcg_scan import plcg_solve
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import solve as launch_solve
from repro_torch.operators import poisson2d

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _absolute_imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    bad = [m for m in _absolute_imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    modules = sorted("repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
                     .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    """Alone in a directory, chip_smoke.py exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_chip_smoke_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.main() != 0


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _problem():
    A = poisson2d(6, 5)
    return A, A @ torch.ones(A.n, dtype=torch.float64)


@pytest.mark.parametrize("entry", ["solve", "Solver", "plcg_solve", "launcher"])
def test_entry_points_default_to_the_card(no_card, entry):
    A, b = _problem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "solve":
            solve(A, b, l=1)
        elif entry == "Solver":
            Solver(A, l=1)
        elif entry == "plcg_solve":
            plcg_solve(A.matvec, b, l=1, sigma=[4.0])
        else:
            launch_solve.main(["--nx", "6"])


@pytest.mark.parametrize("knob, item", [
    (dict(M="for_mesh"), "A.9"),
    (dict(precision="bf16"), "A.7"),
    (dict(restart=3), "A.8"),
    (dict(residual_replacement=10), "A.8"),
    (dict(mesh=object()), "A.9"),
    (dict(comm="overlap"), "A.9"),
    (dict(l="auto"), "A.10"),
    (dict(b2d=True), "A.5"),
], ids=["M", "precision", "restart", "residual_replacement", "mesh", "comm", "l_auto",
        "batched_rhs"])
def test_unported_knobs_raise(knob, item):
    """``M=`` itself is ported; its mesh-only constructions are not."""
    A, b = _problem()
    if knob.pop("b2d", False):
        b = torch.stack([b, b])
    with pytest.raises(NotImplementedError, match=item):
        if knob.get("M") == "for_mesh":
            knob["M"] = BlockJacobi.for_mesh(A, mesh=object())
        solve(A, b, device="cpu", **{"l": 1, **knob})


@pytest.mark.parametrize("M", [Jacobi(4.0), BlockJacobi((6, 5))], ids=["jacobi", "blockjacobi"])
def test_mesh_local_apply_raises(M):
    with pytest.raises(NotImplementedError, match="A.9"):
        M.local_apply(object())


def test_pallas_backend_points_to_cuda():
    A, b = _problem()
    with pytest.raises(ValueError, match="backend='cuda'"):
        solve(A, b, l=1, backend="pallas", device="cpu")


def test_unknown_option_is_rejected():
    A, b = _problem()
    with pytest.raises(ValueError, match="does not accept options"):
        solve(A, b, l=1, device="cpu", unroll=2)


@pytest.mark.parametrize("backend", [None, "ref", "cuda", "fused", "auto"])
def test_cpu_path_launches_no_kernel(backend):
    A, b = _problem()
    reset_launch_counts()
    r = solve(A, b, l=2, tol=1e-10, maxiter=100, backend=backend, device="cpu")
    assert r.converged and r.x.device.type == "cpu"
    assert set(launch_counts().values()) == {0}
    assert np.linalg.norm((b - A @ r.x).numpy()) <= 1e-9 * np.linalg.norm(b.numpy())

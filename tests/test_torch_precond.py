"""Parity of the port's preconditioning layer with ``repro.core.precond``
and of the preconditioned front end (``solve``, ``Solver``, the launcher)
with ``repro.core`` at x64.

Preconditioners: ``Jacobi`` (scalar, from the Poisson operator's diagonal,
and a non-constant ``(n,)`` vector), ``BlockJacobi`` with blocks (1, 1) and
(2, 2), and ``Chebyshev``; their applies and ``precond_spectrum`` agree
within 1e-12 relative.

The solves run ``poisson2d(32, 32)``, b = A 1, through ``solve`` and a
prepared ``Solver`` with the same preconditioner on both sides; the
preconditioned sweeps themselves are compared in
``tests/test_torch_precond_scan.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import BlockJacobi as JBlockJacobi
from repro.core import Chebyshev as JChebyshev
from repro.core import Jacobi as JJacobi
from repro.core import residual_gap as jax_residual_gap
from repro.core import solve as jax_solve
from repro.operators import jacobi as jax_jacobi
from repro.operators import poisson2d as jax_poisson2d
from repro_torch.core import (BlockJacobi, Chebyshev, Identity, Jacobi, Preconditioner,
                              as_preconditioner, dense_operator, residual_gap, solve)
from repro_torch.core.linop import Preconditioner as LegacyPreconditioner
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.operators import jacobi, poisson2d

NX = 32
BOUND = 1e-10
#: the preconditioners held against the reference
NAMES = ("jacobi", "jacobi_vector", "blockjacobi_1x1", "blockjacobi_2x2", "chebyshev")


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(autouse=True)
def no_launches():
    """The CPU route never launches a CUDA kernel."""
    reset_launch_counts()
    yield
    assert set(launch_counts().values()) == {0}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _diag(n):
    return 4.0 + np.random.default_rng(1).uniform(0.0, 2.0, n)


@functools.lru_cache(maxsize=None)
def _pair(name, nx=NX, ny=NX):
    """The same preconditioner built on both sides: (reference, port); built
    once, so a BlockJacobi's power iteration runs once per side."""
    JA, TA = jax_poisson2d(nx, ny), poisson2d(nx, ny)
    if name == "jacobi":
        return jax_jacobi(JA), jacobi(TA)
    if name == "jacobi_vector":
        return JJacobi(_diag(nx * ny)), Jacobi(_diag(nx * ny))
    if name.startswith("blockjacobi"):
        blocks = (1, 1) if name.endswith("1x1") else (2, 2)
        return JBlockJacobi((nx, ny), blocks=blocks), BlockJacobi((nx, ny), blocks=blocks)
    assert name == "chebyshev"
    return (JChebyshev(JA, spectrum=(0.5, 8.0), degree=3),
            Chebyshev(TA, spectrum=(0.5, 8.0), degree=3))


# ---------------------------- the operators -----------------------------------

def test_poisson2d_carries_its_diagonal():
    """The port's operator has the reference's diagonal (4 everywhere), so
    Jacobi.from_operator collapses it to the scalar inverse 0.25."""
    JA, TA = jax_poisson2d(8), poisson2d(8)
    np.testing.assert_array_equal(np.asarray(TA.diag), np.asarray(JA.diag))
    assert jacobi(TA).inv_diag == jax_jacobi(JA).inv_diag == 0.25
    assert jacobi(TA).name == jax_jacobi(JA).name


@pytest.mark.parametrize("name", NAMES)
def test_apply_and_spectrum_match_reference(name):
    J, T = _pair(name, 12, 10)
    v = np.random.default_rng(5).standard_normal(120)
    assert _rel(T.apply(torch.from_numpy(v)), J.apply(v)) <= 1e-12
    np.testing.assert_allclose(T.precond_spectrum((0.0, 8.0)), J.precond_spectrum((0.0, 8.0)),
                               rtol=1e-12, atol=0)
    assert T.name == J.name
    if J.inv_diag is None:
        assert T.inv_diag is None
    else:
        np.testing.assert_array_equal(np.asarray(T.inv_diag), np.asarray(J.inv_diag))


def test_analytic_blockjacobi_bound_and_dense_jacobi():
    """power_iters=0 takes the analytic split bound; a dense operator's
    tensor diagonal feeds Jacobi.from_operator."""
    J = JBlockJacobi((12, 10), blocks=(2, 2), power_iters=0)
    T = BlockJacobi((12, 10), blocks=(2, 2), power_iters=0)
    assert T.precond_spectrum() == pytest.approx(J.precond_spectrum(), rel=1e-12, abs=0)
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((6, 6))
    dense = Q @ Q.T + 6 * np.eye(6)
    np.testing.assert_allclose(Jacobi.from_operator(dense_operator(dense, device="cpu")).inv_diag,
                               1.0 / np.diag(dense), rtol=1e-15)


# ------------------------------ promotion -------------------------------------

def test_identity_collapse_and_promotion():
    """M=None, M=Identity() and a bare callable, as in tests/test_precond.py:
    the identity collapses into the unpreconditioned pipeline."""
    assert as_preconditioner(None).is_identity
    assert as_preconditioner(None).runtime() is None
    assert as_preconditioner(Identity()).runtime() is None
    M = as_preconditioner(lambda v: v * 1.0)
    assert isinstance(M, Preconditioner) and not M.is_identity
    A = poisson2d(NX)
    b = A @ torch.ones(A.n, dtype=torch.float64)
    kw = dict(method="plcg_scan", l=2, tol=1e-10, maxiter=200, spectrum=(0.0, 8.0),
              device="cpu")
    r0 = solve(A, b, **kw)
    r1 = solve(A, b, M=Identity(), **kw)
    assert r0.iters == r1.iters and torch.equal(r0.x, r1.x)
    assert r1.info["prec"] is None
    with pytest.raises(TypeError, match="preconditioner"):
        as_preconditioner(42)


def test_legacy_dataclass_preconditioner_still_dispatches():
    """The legacy linop.Preconditioner dataclass promotes through
    as_preconditioner and solves as the reference's does."""
    from repro.core.linop import Preconditioner as JLegacy
    JA, TA = jax_poisson2d(NX), poisson2d(NX)
    b = np.asarray(JA @ np.ones(JA.n))
    kw = dict(method="plcg_scan", l=2, tol=1e-8, maxiter=400, spectrum=(0.0, 2.0))
    want = jax_solve(JA, b, M=JLegacy(apply=lambda v: v / 4.0, name="legacy"), **kw)
    got = solve(TA, torch.from_numpy(b), M=LegacyPreconditioner(apply=lambda v: v / 4.0,
                                                                 name="legacy"),
                device="cpu", **kw)
    assert got.converged and got.iters == want.iters
    assert got.info["prec"] == want.info["prec"] == "legacy"
    assert _rel(got.x, want.x) <= BOUND


# ------------------------------ the engine ------------------------------------

def _b():
    return np.asarray(jax_poisson2d(NX) @ np.ones(NX * NX))


@pytest.mark.parametrize("backend", [None, "ref", "fused"])
@pytest.mark.parametrize("name", ["jacobi", "chebyshev"])
def test_preconditioned_solve_matches_reference(name, backend):
    """solve() with a preconditioner that commutes with A, to convergence:
    the shifts come from M.precond_spectrum on both sides."""
    J, T = _pair(name)
    b = _b()
    kw = dict(method="plcg_scan", l=2, tol=1e-6, maxiter=400, backend=backend)
    want = jax_solve(jax_poisson2d(NX), b, M=J, **kw)
    got = solve(poisson2d(NX), torch.from_numpy(b), M=T, device="cpu", **kw)
    assert got.converged and want.converged
    for key in ("iters", "converged", "breakdowns", "restarts"):
        assert getattr(got, key) == getattr(want, key), key
    for key in ("sigma", "prec", "l", "backend"):
        assert got.info[key] == want.info[key], key
    assert _rel(got.resnorms, want.resnorms) <= BOUND
    assert _rel(got.x, want.x) <= BOUND


def test_prepared_solver_with_preconditioner_matches_reference():
    """A Solver prepared once with M answers several right-hand sides as
    the reference's Solver does (shifts from M.precond_spectrum)."""
    from repro.core import Solver as JaxSolver
    from repro_torch.core import Solver
    J, T = _pair("chebyshev")
    JA = jax_poisson2d(NX)
    rng = np.random.default_rng(0)
    rhs = [_b()] + [np.asarray(JA @ rng.standard_normal(JA.n)) for _ in range(2)]
    kw = dict(l=2, tol=1e-6, maxiter=400, backend="fused")
    jsolver = JaxSolver(JA, "plcg_scan", M=J, **kw)
    tsolver = Solver(poisson2d(NX), "plcg_scan", M=T, device="cpu", **kw)
    for b in rhs:
        want, got = jsolver.solve(b), tsolver.solve(torch.from_numpy(b))
        assert got.converged and (got.iters, got.restarts) == (want.iters, want.restarts)
        assert got.info["sigma"] == want.info["sigma"] and got.info["prec"] == "chebyshev-3"
        assert _rel(got.x, want.x) <= BOUND


@pytest.mark.parametrize("name, bench_iters", [
    ("none", 51), ("jacobi", 51), ("blockjacobi_2x2", 34), ("chebyshev", 22)])
def test_prec_ladder_iteration_counts(name, bench_iters):
    """``benchmarks/prec_bench.py::prec_ladder`` (32x32, l = 2, tol 1e-6,
    float32): the committed counts of ``BENCH_393279c.json`` (taken with an
    older jax) are within 2 updates of the reference run here (backend
    None) and of the port's fused tier.  Both converge."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        JA, TA = jax_poisson2d(NX), poisson2d(NX)
        b = np.asarray(JA @ np.ones(JA.n))
        # built here, not cached: the reference's power iteration runs in
        # float32 without x64, as it did for the bench row
        J, T = (None, None) if name == "none" else _pair.__wrapped__(name)
        kw = dict(method="plcg_scan", l=2, tol=1e-6, maxiter=400)
        if J is None:
            kw["spectrum"] = (0.0, 8.0)
        want = jax_solve(JA, b, M=J, **kw)
        got = solve(TA, torch.from_numpy(b.astype(np.float32)), M=T, backend="fused",
                    device="cpu", **kw)
    finally:
        jax.config.update("jax_enable_x64", old)
    assert got.x.dtype == torch.float32 and np.asarray(want.x).dtype == np.float32
    assert got.converged and want.converged
    assert abs(got.iters - bench_iters) <= 2 and abs(want.iters - bench_iters) <= 2


def test_blockjacobi_solve_converges_on_every_tier():
    """BlockJacobi to convergence: the update count is a roundoff branch
    (``test_blockjacobi_outcome_is_a_roundoff_branch``), so each tier is
    held to converging with a true residual at tolerance, not to the
    reference's count."""
    J, T = _pair("blockjacobi_2x2")
    A = poisson2d(NX)
    b = torch.from_numpy(_b())
    for backend in (None, "ref", "cuda", "fused"):
        r = solve(A, b, method="plcg_scan", l=2, tol=1e-8, maxiter=400, M=T,
                  backend=backend, device="cpu")
        assert r.converged, backend
        assert float(torch.linalg.norm(b - A @ r.x) / torch.linalg.norm(b)) <= 1e-7, backend


#: relative size of the seeded perturbations of b, well above roundoff
BRANCH_EPS = 1e-12


def test_blockjacobi_outcome_is_a_roundoff_branch():
    """BlockJacobi 2x2 at l = 2, tol 1e-6 (the prec ladder's setting, x64):
    the reference converges on b = A 1 in 20 updates with no restart,
    while the port breaks down once and restarts.  That is a branch, not a
    fault of the port: b multiplied by 1 + 1e-12 N(0, 1) (numpy seeds
    1-8) sends the reference, and the port on None and "fused", each onto
    both branches -- 20 updates and no restart, or a breakdown, one
    restart and more updates -- and every run converges."""
    J, T = _pair("blockjacobi_2x2")
    JA, TA = jax_poisson2d(NX), poisson2d(NX)
    kw = dict(method="plcg_scan", l=2, tol=1e-6, maxiter=400)
    b0 = _b()
    unperturbed = jax_solve(JA, b0, M=J, **kw)
    assert (unperturbed.iters, unperturbed.restarts, unperturbed.converged) == (20, 0, True)
    outcomes = {"jax": [], None: [], "fused": []}
    for seed in range(1, 9):
        b = b0 * (1.0 + BRANCH_EPS * np.random.default_rng(seed).standard_normal(b0.size))
        runs = {"jax": jax_solve(JA, b, M=J, **kw)}
        for backend in (None, "fused"):
            runs[backend] = solve(TA, torch.from_numpy(b), M=T, backend=backend,
                                  device="cpu", **kw)
        for side, r in runs.items():
            assert r.converged, (side, seed)
            outcomes[side].append((r.iters, r.restarts))
    for side, got in outcomes.items():
        assert {restarts > 0 for _, restarts in got} == {False, True}, (side, got)
        assert {iters for iters, restarts in got if restarts == 0} == {20}, (side, got)
    port = solve(TA, torch.from_numpy(b0), M=T, device="cpu", **kw)
    assert port.converged


def test_residual_gap_matches_reference():
    J, T = _pair("chebyshev")
    b = _b()
    kw = dict(method="plcg_scan", l=2, tol=1e-6, maxiter=400)
    want_r = jax_solve(jax_poisson2d(NX), b, M=J, **kw)
    got_r = solve(poisson2d(NX), torch.from_numpy(b), M=T, device="cpu", **kw)
    want = jax_residual_gap(jax_poisson2d(NX), b, want_r)
    got = residual_gap(poisson2d(NX), torch.from_numpy(b), got_r)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-8, abs=1e-12), key


@pytest.mark.parametrize("prec", ["jacobi", "blockjacobi", "chebyshev"])
def test_launcher_prec_matches_reference(prec, capsys):
    """``--prec`` through the port's CLI on 24x20 (b = A 1, l = 3, tol 1e-5),
    built as ``repro.launch.solve`` builds it on one device."""
    from repro_torch.launch import solve as launch_solve
    got = launch_solve.main(["--nx", "24", "--ny", "20", "--device", "cpu", "--backend", "fused",
                             "--prec", prec])
    assert f"prec={prec}" in capsys.readouterr().out
    JA = jax_poisson2d(24, 20)
    M = {"jacobi": lambda: jax_jacobi(JA), "blockjacobi": lambda: JBlockJacobi((24, 20)),
         "chebyshev": lambda: JChebyshev(JA, spectrum=(0.5, 8.0), degree=3)}[prec]()
    want = jax_solve(JA, JA @ np.ones(JA.n), method="plcg_scan", l=3, tol=1e-5, maxiter=2000,
                     M=M, backend="fused")
    assert got.converged and want.converged
    assert got.info["sigma"] == pytest.approx(want.info["sigma"], rel=1e-12)
    assert got.info["prec"] == want.info["prec"]
    assert abs(got.iters - want.iters) <= 2

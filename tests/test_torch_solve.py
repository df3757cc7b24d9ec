"""Parity of the port's front end (``solve``, ``Solver``) and host restart
loop with ``repro.core`` at x64.

The Poisson cases compare ``SolveResult`` field by field.  The restart
cases use ``repro.operators.spd_with_spectrum(linspace(1e-2, 1, 24))`` at
l = 1, tol 1e-10, maxiter 144, the right-hand sides of ROADMAP C.2.  On
that 24-dimensional system the first breakdown test falls at update 23,
where the Krylov space is exhausted and the tested quantity is exactly 0
in exact arithmetic: whether a run breaks down there (then restarts and
converges at 31 or 42 updates) or converges at 25 is set by the sign of a
roundoff.  The reference itself flips between the two when b is perturbed
by 2e-16 relative (``test_lane_outcome_is_a_roundoff_branch``), so the
port is held to the shared trace before that
update and to the converged solution, not to the branch.  The host loop's
bookkeeping is compared exactly on scripted sweeps and on a zero
right-hand side, whose sweeps break down deterministically.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import Solver as JaxSolver
from repro.core import solve as jax_solve
from repro.configs.poisson2d import SolverConfig as JaxSolverConfig
from repro.core.plcg_scan import run_restart_driver as jax_driver
from repro.operators import poisson2d as jax_poisson2d
from repro.operators import spd_with_spectrum
from repro_torch.convert import from_reference
from repro_torch.core import Solver, solve
from repro_torch.core.plcg_scan import PLCGOut
from repro_torch.core.plcg_scan import run_restart_driver as torch_driver

BOUND = 1e-10
FIELDS = ("iters", "converged", "breakdowns", "restarts", "replacements")


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _same_result(got, want):
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert len(got.resnorms) == len(want.resnorms)
    assert _rel(got.resnorms, want.resnorms) <= BOUND
    assert _rel(got.x, want.x) <= BOUND
    for key in ("method", "l", "sigma", "backend"):
        assert got.info[key] == want.info[key], key


@pytest.mark.parametrize("backend", [None, "fused"])
def test_solve_matches_reference(backend):
    """The reference's SolverConfig (cut to 20x20) carried across as a dict."""
    cfg = JaxSolverConfig(nx=20, ny=20, l=2, tol=1e-10, maxiter=200)
    A = jax_poisson2d(cfg.nx, cfg.ny)
    b = A @ np.ones(A.n)
    prob = from_reference(grid=(cfg.nx, cfg.ny), b=b, config=dataclasses.asdict(cfg),
                          device="cpu")
    assert dataclasses.asdict(prob.config) == dataclasses.asdict(cfg)
    c = prob.config
    kw = dict(method="plcg_scan", l=c.l, tol=c.tol, maxiter=c.maxiter,
              spectrum=(c.lmin, c.lmax), backend=backend)
    want = jax_solve(A, b, **kw)
    got = solve(prob.A, prob.b, device="cpu", **kw)
    assert got.converged and got.x.device.type == "cpu"
    _same_result(got, want)


def test_returned_x_matches_last_residual():
    """x_k and zeta_k share their index: on the launcher's problem (b = A 1,
    l = 3, tol 1e-5) the returned x's true residual equals the last
    recursive residual, in the reference and in the port, with the same
    number of updates."""
    A = jax_poisson2d(64, 64)
    b = A @ np.ones(A.n)
    kw = dict(method="plcg_scan", l=3, tol=1e-5, maxiter=2000, spectrum=(0.0, 8.0))
    want = jax_solve(A, b, **kw)
    prob = from_reference(grid=(64, 64), b=b, device="cpu")
    got = solve(prob.A, prob.b, device="cpu", **kw)
    assert got.iters == want.iters and got.converged and want.converged
    for r in (want, got):
        true = np.linalg.norm(b - A @ np.asarray(r.x))
        assert abs(true - r.resnorms[-1]) <= 1e-3 * r.resnorms[-1]
        assert true <= 1e-5 * np.linalg.norm(b)


def test_prepared_solver_matches_reference():
    """One Solver, prepared once, answers several right-hand sides exactly
    as the reference's Solver does."""
    A = jax_poisson2d(20, 20)
    rng = np.random.default_rng(0)
    rhs = [A @ np.ones(A.n)] + [A @ rng.standard_normal(A.n) for _ in range(2)]
    kw = dict(l=2, tol=1e-10, maxiter=200, spectrum=(0.0, 8.0), backend="fused")
    jsolver = JaxSolver(A, "plcg_scan", **kw)
    tsolver = Solver(from_reference(grid=(20, 20), device="cpu").A, "plcg_scan",
                     device="cpu", **kw)
    for b in rhs:
        prob = from_reference(grid=(20, 20), b=b, device="cpu")
        _same_result(tsolver.solve(prob.b), jsolver.solve(b))
    assert tsolver.stats == {"calls": 3}


@pytest.mark.parametrize("backend", ["fused", "ref"])
def test_launcher_matches_reference(backend, capsys):
    """The CLI on the CPU: the paper's problem cut to 24x20 (b = A 1, l = 3,
    tol 1e-5, Chebyshev shifts on (0, 8)) gives the reference's result."""
    from repro_torch.launch import solve as launch_solve
    got = launch_solve.main(["--nx", "24", "--ny", "20", "--device", "cpu",
                             "--backend", backend])
    A = jax_poisson2d(24, 20)
    want = jax_solve(A, A @ np.ones(A.n), method="plcg_scan", l=3, tol=1e-5, maxiter=2000,
                     spectrum=(0.0, 8.0), backend=backend)
    assert got.converged and "converged=True" in capsys.readouterr().out
    _same_result(got, want)


def test_launcher_profile_needs_the_card():
    from repro_torch.launch import solve as launch_solve
    with pytest.raises(SystemExit, match="--device cuda"):
        launch_solve.main(["--nx", "6", "--device", "cpu", "--profile"])


def _scripted(outcomes, n=4):
    """A sweep replaying (k_done, converged, breakdown, last resnorm)
    records; returns the JAX-style tuple or the port's PLCGOut."""
    def make(as_torch):
        queue = list(outcomes)

        def sweep(b, x, budget):
            k, conv, brk, last = queue.pop(0)
            k = min(k, budget - 1)
            res = np.zeros(k + 8)
            res[1:k + 2] = np.geomspace(1.0, last, k + 1)
            x = np.full(n, float(len(queue)))
            if as_torch:
                return PLCGOut(x=torch.from_numpy(x), resnorms=torch.from_numpy(res),
                               k_done=torch.tensor(k), converged=torch.tensor(conv),
                               breakdown=torch.tensor(brk), committed=torch.from_numpy(res > 0),
                               bodies=k + 3)
            return x, res, conv, brk, k
        return sweep
    return make(False), make(True)


@pytest.mark.parametrize("outcomes", [
    [(20, True, False, 1e-11)],                                # converges
    [(9, False, True, 1e-3), (15, True, False, 1e-11)],        # restart, converge
    [(12, False, True, 3e-10)],                                # happy breakdown
    [(3, False, True, 1e-2)] * 7,                              # restart cap
    [(40, False, True, 1e-3), (40, False, False, 1e-4)],       # budget spent
], ids=["converge", "restart", "happy", "cap", "budget"])
def test_restart_driver_matches_reference(outcomes):
    jsweep, tsweep = _scripted(outcomes)
    b = np.zeros(4)
    kw = dict(tol=1e-10, maxiter=50, max_restarts=5, bnorm=1.0)
    jx, jres, jinfo = jax_driver(jsweep, b, b, **kw)
    tx, tres, tinfo = torch_driver(tsweep, torch.from_numpy(b), torch.from_numpy(b), **kw)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert tres == jres
    assert {k: tinfo[k] for k in jinfo} == jinfo


@pytest.mark.parametrize("backend", [None, "fused"])
def test_zero_rhs_breakdown_loop_matches_reference(backend):
    """b = 0 makes v0 = 0/0, so every sweep breaks down at its first steady
    body: the host loop restarts up to its cap on both sides."""
    A = spd_with_spectrum(np.linspace(1e-2, 1, 24), seed=0)
    kw = dict(method="plcg_scan", l=1, tol=1e-10, maxiter=144, spectrum=(0.009, 1.1),
              backend=backend)
    want = jax_solve(A, np.zeros(24), **kw)
    prob = from_reference(dense=A, b=np.zeros(24), device="cpu")
    got = solve(prob.A, prob.b, device="cpu", **kw)
    assert (got.restarts, got.breakdowns, got.iters) == (want.restarts, want.breakdowns,
                                                         want.iters) == (5, 6, 6)
    assert not got.converged and not want.converged
    assert got.resnorms == want.resnorms == []
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))


def _lane(lane):
    A = spd_with_spectrum(np.linspace(1e-2, 1, 24), seed=0)
    rng = np.random.default_rng(0)
    return A, [A @ rng.standard_normal(24) for _ in range(2)][lane]


@pytest.mark.parametrize("backend", [None, "fused"])
@pytest.mark.parametrize("lane", [0, 1])
def test_lane_outcome_is_a_roundoff_branch(lane, backend):
    """Why test_host_restart_lanes accepts either branch: perturbing b by
    2e-16 relative (eight seeded directions) moves the reference itself,
    and the port, between "restart once, converge at 31 (lane 0) / 42
    (lane 1)" and "converge at 25, no restart"."""
    A, b = _lane(lane)
    kw = dict(method="plcg_scan", l=1, tol=1e-10, maxiter=144, spectrum=(0.009, 1.1),
              backend=backend)
    seen = {"reference": set(), "port": set()}
    for seed in range(8):
        e = np.random.default_rng(100 + seed).standard_normal(24)
        bp = b + 2e-16 * np.linalg.norm(b) * e / np.linalg.norm(e)
        prob = from_reference(dense=A, b=bp, device="cpu")
        for side, r in (("reference", jax_solve(A, bp, **kw)),
                        ("port", solve(prob.A, prob.b, device="cpu", **kw))):
            assert r.converged
            seen[side].add((r.iters, r.restarts))
    branches = {(25, 0), (31 + 11 * lane, 1)}
    assert seen == {"reference": branches, "port": branches}


@pytest.mark.parametrize("backend", [None, "fused"])
@pytest.mark.parametrize("lane", [0, 1])
def test_host_restart_lanes(lane, backend):
    """The ROADMAP C.2 lanes: both sides converge, share the residual trace
    up to the Krylov-exhaustion update, and reach the same solution within
    what tol 1e-10 on a condition-100 system allows (100 * tol)."""
    A, b = _lane(lane)
    kw = dict(method="plcg_scan", l=1, tol=1e-10, maxiter=144, spectrum=(0.009, 1.1),
              backend=backend)
    want = jax_solve(A, b, **kw)
    prob = from_reference(dense=A, b=b, device="cpu")
    got = solve(prob.A, prob.b, device="cpu", **kw)
    assert got.converged and want.converged
    assert (got.iters, got.restarts) in {(25, 0), (31 + 11 * lane, 1)}
    assert _rel(got.resnorms[:23], want.resnorms[:23]) <= BOUND
    assert _rel(got.x, want.x) <= 100 * 1e-10
    assert np.linalg.norm(b - A @ got.x.numpy()) <= 1e-10 * np.linalg.norm(b) * 10

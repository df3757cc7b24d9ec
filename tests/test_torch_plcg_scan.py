"""Parity of the port's scan engine with ``repro.core.plcg_scan`` at x64.

Both sides run the tier-1 system of ``tests/test_backend_parity.py``
(``poisson2d(20, 20)``, b = A 1, Chebyshev shifts on (0, 8), tol 1e-10) on
the same backend: None, "ref" and "fused" on both sides, and the port's
per-kernel "cuda" tier (which takes the plain versions on the CPU) against
the reference's "pallas" tier (Pallas interpret mode).

At l = 1, 2 the sweep converges and everything is compared.  At l = 3, 4 the
deep pipeline ends in a square-root breakdown (paper Sec. 4) whose update is
set by roundoff: the reference's own None and "ref" tiers break down at
updates 38 and 36 at l = 3 (39 and 32 at l = 4; asserted by
``test_reference_tiers_break_down_apart_at_depth``), so no implementation
that sums in another order can match that update.  There the sweep runs a 24-update budget, before any
tier breaks down, on which the reference's own tiers agree to ~3e-11.
Bounds: equal ``k_done`` / ``converged`` / ``breakdown`` and committed
mask; ``x`` and the committed ``resnorms`` within 1e-10 (norm-wise
relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jax_precision
from repro.core import shifts as jax_shifts
from repro.core.plcg_scan import plcg_scan as jax_scan
from repro.core.plcg_scan import stab_iter_slack as jax_slack
from repro.core.shifts import chebyshev_shifts
from repro.operators import poisson2d as jax_poisson2d
import repro_torch.core.plcg_scan as tscan_mod
from repro_torch.core import precision as torch_precision
from repro_torch.core import shifts as torch_shifts
from repro_torch.convert import from_reference
from repro_torch.core.plcg_scan import plcg_scan as torch_scan
from repro_torch.core.plcg_scan import stab_iter_slack as torch_slack
from repro_torch.kernels import launch_counts, reset_launch_counts

NX = 20
BOUND = 1e-10
#: bodies per sweep: converge at l = 1, 2; a 24-update budget at l = 3, 4
ITERS = {1: 100, 2: 100, 3: 24 + 3 + 1, 4: 24 + 4 + 1}
TIERS = [(None, None), ("ref", "ref"), ("fused", "fused"), ("cuda", "pallas")]


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def b():
    return jax_poisson2d(NX, NX) @ np.ones(NX * NX)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _torch_run(b, l, backend, iters, stencil=True, **kw):
    prob = from_reference(grid=(NX, NX), b=b, sigma=chebyshev_shifts(0, 8, l), device="cpu")
    return torch_scan(prob.A.matvec, prob.b, l=l, iters=iters, sigma=prob.sigma, tol=1e-10,
                      backend=backend, stencil_hw=prob.A.stencil2d if stencil else None,
                      device="cpu", **kw)


@pytest.mark.parametrize("tier", TIERS, ids=["none", "ref", "fused", "cuda-vs-pallas"])
@pytest.mark.parametrize("l", [1, 2, 3, 4])
def test_scan_matches_reference(b, l, tier):
    port_backend, jax_backend = tier
    A = jax_poisson2d(NX, NX)
    want = jax_scan(A.matvec, jnp.asarray(b), l=l, iters=ITERS[l],
                    sigma=tuple(chebyshev_shifts(0, 8, l)), tol=1e-10,
                    backend=jax_backend, stencil_hw=A.stencil2d)
    reset_launch_counts()
    got = _torch_run(b, l, port_backend, ITERS[l])
    assert set(launch_counts().values()) == {0}          # CPU: plain versions only
    assert int(got.k_done) == int(want.k_done)
    assert bool(got.converged) == bool(want.converged) == (l <= 2)
    assert bool(got.breakdown) == bool(want.breakdown) is False
    mask = np.asarray(want.committed)
    np.testing.assert_array_equal(got.committed.numpy(), mask)
    assert got.resnorms.shape == (ITERS[l],)
    assert _rel(got.x, want.x) <= BOUND
    assert _rel(got.resnorms.numpy()[mask], np.asarray(want.resnorms)[mask]) <= BOUND


@pytest.mark.parametrize("l, updates", [(3, (38, 36)), (4, (39, 32))])
def test_reference_tiers_break_down_apart_at_depth(b, l, updates):
    """Why l = 3, 4 are compared on a 24-update budget: run to the end, the
    reference's own None and "ref" tiers break down at different updates,
    though they agree within BOUND on the committed residuals of that
    budget."""
    A = jax_poisson2d(NX, NX)
    runs = [jax_scan(A.matvec, jnp.asarray(b), l=l, iters=100,
                     sigma=tuple(chebyshev_shifts(0, 8, l)), tol=1e-10, backend=backend,
                     stencil_hw=A.stencil2d) for backend in (None, "ref")]
    assert tuple(int(r.k_done) for r in runs) == updates
    assert all(bool(r.breakdown) and not bool(r.converged) for r in runs)
    head = np.asarray(runs[0].committed)[:ITERS[l]]       # r_0 and 24 updates
    res = [np.asarray(r.resnorms)[:ITERS[l]][head] for r in runs]
    assert head.sum() == 25 and _rel(res[1], res[0]) <= BOUND


def test_fused_stencil_matches_streamed_t(b):
    """The in-kernel stencil and a streamed t = A z give the same sweep."""
    fused = _torch_run(b, 2, "fused", 100)
    streamed = _torch_run(b, 2, "fused", 100, stencil=False)
    assert int(fused.k_done) == int(streamed.k_done)
    assert _rel(streamed.x, fused.x) <= 1e-13


@pytest.mark.parametrize("backend", [None, "fused"])
def test_early_stop_returns_the_full_sweep(b, backend, monkeypatch):
    """Stopping at the first host check after ``done`` returns exactly what
    running every body returns."""
    early = _torch_run(b, 2, backend, 200)
    monkeypatch.setattr(tscan_mod, "CHECK_EVERY", 10**9)
    full = _torch_run(b, 2, backend, 200)
    assert early.bodies < full.bodies == 200
    for name in ("x", "resnorms", "k_done", "converged", "breakdown", "committed"):
        assert torch.equal(getattr(early, name), getattr(full, name)), name


def test_budget_freezes_without_converging(b):
    out = _torch_run(b, 2, "ref", 100, k_budget=10)
    assert int(out.k_done) == 9
    assert not bool(out.converged) and not bool(out.breakdown)
    assert int(out.committed.sum()) == 10


def test_cuda_device_is_the_default(b, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = from_reference(grid=(NX, NX), b=b, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_scan(prob.A.matvec, prob.b, l=1, iters=4, sigma=[4.0])


@pytest.mark.parametrize("knobs", [(None, None, 0), (3, None, 100), (None, 7, 100),
                                   (2, 10, 55), (0, None, 100)])
@pytest.mark.parametrize("l", [1, 3])
def test_stab_iter_slack_matches_reference(l, knobs):
    assert torch_slack(l, *knobs) == jax_slack(l, *knobs)


@pytest.mark.parametrize("l", [1, 3, 5])
def test_shifts_match_reference(l):
    """The engine's inputs: Chebyshev, monomial and Ritz (Leja-ordered) shifts."""
    assert torch_shifts.chebyshev_shifts(0.0, 8.0, l) == jax_shifts.chebyshev_shifts(0.0, 8.0, l)
    assert torch_shifts.monomial_shifts(l) == jax_shifts.monomial_shifts(l)
    vals = list(np.random.default_rng(l).uniform(0.01, 8.0, 2 * l + 3))
    assert torch_shifts.ritz_shifts(vals, l) == jax_shifts.ritz_shifts(vals, l)
    np.testing.assert_allclose(torch_shifts.leja_order(vals, l),
                               np.asarray(jax_shifts.leja_order(jnp.asarray(vals), l)),
                               rtol=1e-15)


@pytest.mark.parametrize("policy", [None, "bf16", "f32", "bf16x64", "f32x64"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_precision_policy_resolves_like_reference(policy, dtype):
    jpol = jax_precision.as_precision_policy(policy)
    tpol = torch_precision.as_precision_policy(policy)
    assert (tpol.storage, tpol.compute, tpol.is_default) == (jpol.storage, jpol.compute,
                                                              jpol.is_default)
    got = [str(d).removeprefix("torch.") for d in tpol.resolve(getattr(torch, dtype))]
    assert got == [str(d) for d in jpol.resolve(dtype)]

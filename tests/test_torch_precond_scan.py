"""Parity of the preconditioned scan engine of the port with
``repro.core.plcg_scan`` at x64, and the fused tier's dispatch on the
preconditioner's structure.

The preconditioned sweeps run ``poisson2d(32, 32)``, b = A 1, l = 3,
tol 1e-10, on both sides with the same preconditioner and backend.  They
part by summation order within a few updates: the reference's own None
and "ref" tiers first differ by more than 1e-10 in a committed residual
at updates 45 (scalar Jacobi), 9 (vector Jacobi), 14 (BlockJacobi 1x1), 6
(BlockJacobi 2x2) and 17 (Chebyshev), and some of them later break down
at different updates (the parting is asserted by
``test_reference_tiers_part_under_preconditioning``).  So each sweep runs
a budget of updates before that point (``BUDGET``), and there ``x``, the
committed ``resnorms``, ``k_done`` and the flags are held to the bounds of
``tests/test_torch_plcg_scan.py`` (1e-10).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockJacobi as JBlockJacobi
from repro.core import Chebyshev as JChebyshev
from repro.core import Jacobi as JJacobi
from repro.core.plcg_scan import plcg_scan as jax_scan
from repro.core.shifts import chebyshev_shifts
from repro.operators import jacobi as jax_jacobi
from repro.operators import poisson2d as jax_poisson2d
from repro_torch.core import BlockJacobi, Chebyshev, Jacobi
from repro_torch.core.plcg_scan import plcg_scan as torch_scan
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.operators import jacobi, poisson2d

NX = 32
BOUND = 1e-10
L = 3
#: updates each sweep commits: before the reference's own tiers part
BUDGET = {"jacobi": 40, "jacobi_vector": 8, "blockjacobi_1x1": 12, "blockjacobi_2x2": 4,
          "chebyshev": 15}
TIERS = {"none": (None, None), "ref": ("ref", "ref"), "fused": ("fused", "fused"),
         "cuda-vs-pallas": ("cuda", "pallas")}
#: each preconditioner on None, "ref" and "fused"; the per-kernel tier on
#: the two that exercise its zhat-dotted payload hardest
CASES = [(name, tier) for name in BUDGET for tier in ("none", "ref", "fused")] + [
    ("jacobi_vector", "cuda-vs-pallas"), ("blockjacobi_2x2", "cuda-vs-pallas")]


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


# ------------------------------ the engine ------------------------------------

def _b():
    return np.asarray(jax_poisson2d(NX) @ np.ones(NX * NX))


@pytest.mark.parametrize("name, tier", CASES, ids=[f"{n}-{t}" for n, t in CASES])
def test_preconditioned_scan_matches_reference(name, tier):
    """Each preconditioner on each tier, on the budget before the
    reference's own tiers part.  On "fused" the stencil hint is set, so the
    scalar Jacobi runs the diag-fused single launch and the others the
    stencil2d + fused_body split (their plain versions on the CPU)."""
    port_backend, jax_backend = TIERS[tier]
    J, T = _pair(name)
    b = _b()
    sig = chebyshev_shifts(*J.precond_spectrum(), L)
    iters = BUDGET[name] + L + 1
    JA = jax_poisson2d(NX)
    want = jax_scan(JA.matvec, jnp.asarray(b), l=L, iters=iters, sigma=tuple(sig), tol=1e-10,
                    prec=J, prec_diag=J.inv_diag, backend=jax_backend,
                    stencil_hw=JA.stencil2d)
    TA = poisson2d(NX)
    got = torch_scan(TA.matvec, torch.from_numpy(b), l=L, iters=iters, sigma=sig, tol=1e-10,
                     prec=T, prec_diag=T.inv_diag, backend=port_backend,
                     stencil_hw=TA.stencil2d, device="cpu")
    assert int(got.k_done) == int(want.k_done) == BUDGET[name]
    assert bool(got.converged) == bool(want.converged) is False
    assert bool(got.breakdown) == bool(want.breakdown) is False
    mask = np.asarray(want.committed)
    np.testing.assert_array_equal(got.committed.numpy(), mask)
    assert _rel(got.x, want.x) <= BOUND
    assert _rel(got.resnorms.numpy()[mask], np.asarray(want.resnorms)[mask]) <= BOUND


@pytest.mark.parametrize("name, parted_at", [("jacobi_vector", 9), ("blockjacobi_2x2", 6)])
def test_reference_tiers_part_under_preconditioning(name, parted_at):
    """Why BUDGET is short: run on, the reference's own None and "ref"
    tiers differ by more than 1e-10 in the committed residual of update
    ``parted_at``."""
    J, _ = _pair(name)
    JA = jax_poisson2d(NX)
    sig = tuple(chebyshev_shifts(*J.precond_spectrum(), L))
    runs = [jax_scan(JA.matvec, jnp.asarray(_b()), l=L, iters=40, sigma=sig, tol=1e-10, prec=J,
                     backend=backend) for backend in (None, "ref")]
    res = [np.asarray(r.resnorms)[np.asarray(r.committed)][:parted_at + 1] for r in runs]
    rel = np.abs(res[1] - res[0]) / np.abs(res[0])
    assert np.all(rel[:parted_at] <= BOUND) and rel[parted_at] > BOUND


@pytest.mark.parametrize("name, stencil_calls, streams_t", [
    ("jacobi", 0, False), ("blockjacobi_2x2", 1, True), ("chebyshev", 1, True)])
def test_fused_dispatch_per_preconditioner(name, stencil_calls, streams_t, monkeypatch):
    """The fused tier's dispatch, counted at the kernel entry points on the
    CPU: a diagonal preconditioner folds into the one fused_body call
    (stencil and diag apply inside it); a general one calls stencil2d once
    a body and streams t and t_hat into fused_body."""
    from repro_torch.kernels import ops as kops
    calls = {"stencil2d": 0, "fused_body": 0, "streamed_t": 0}
    real_stencil, real_fused = kops.stencil2d_apply, kops.fused_body_apply

    def stencil(*a, **k):
        calls["stencil2d"] += 1
        return real_stencil(*a, **k)

    def fused(Vw, Zw, Zhw, t, t_hat, **k):
        calls["fused_body"] += 1
        calls["streamed_t"] += t is not None
        assert Zhw is not None and Zhw.shape == (Vw.shape[0], 3)
        return real_fused(Vw, Zw, Zhw, t, t_hat, **k)

    monkeypatch.setattr(kops, "stencil2d_apply", stencil)
    monkeypatch.setattr(kops, "fused_body_apply", fused)
    _, T = _pair(name)
    A = poisson2d(NX)
    b = A @ torch.ones(A.n, dtype=torch.float64)
    out = torch_scan(A.matvec, b, l=2, iters=12, sigma=[1.5, 0.5], tol=0.0, prec=T,
                     prec_diag=T.inv_diag, backend="fused", stencil_hw=A.stencil2d,
                     device="cpu")
    assert out.bodies == 12
    assert calls == {"stencil2d": 12 * stencil_calls, "fused_body": 12,
                     "streamed_t": 12 * streams_t}


@pytest.mark.parametrize("prec_diag", [np.full(NX * NX + 1, 0.25), np.full((NX * NX, 1), 0.25)],
                         ids=["wrong_length", "two_dims"])
def test_prec_diag_must_be_scalar_or_n(prec_diag):
    A = poisson2d(NX)
    b = A @ torch.ones(A.n, dtype=torch.float64)
    with pytest.raises(ValueError, match="prec_diag must be a scalar"):
        torch_scan(A.matvec, b, l=2, iters=4, sigma=[1.5, 0.5], prec=lambda v: v / 4.0,
                   prec_diag=prec_diag, backend="fused", stencil_hw=A.stencil2d, device="cpu")

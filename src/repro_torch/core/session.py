"""Prepared-solver sessions (port of ``repro.core.session``, single device,
single right-hand side).

``Solver(A, l=3, backend="fused")`` runs every per-problem step once --
method lookup, option and knob validation, device resolution, operator
promotion, preconditioner promotion, shift defaulting (including a
preconditioner's spectrum estimate) -- and ``solver.solve(b, x0=...,
tol=..., maxiter=...)`` then runs with no re-setup.  There is no compiled program
to hold yet (CUDA graph capture is ROADMAP A.4); the micro-batching
``submit``/``SolverPool`` layer and the batched sweeps wait for A.4 / A.5.
"""
from __future__ import annotations

from typing import Optional

from ..device import resolve_device
from . import engine
from .linop import LinearOperator
from .plcg_scan import resolve_backend
from .results import SolveResult

__all__ = ["Solver"]


class Solver:
    """A prepared solver session: prepare once, solve many.

    Constructor keywords mean what they mean in :func:`repro_torch.core.solve`;
    ``tol``/``maxiter`` become session defaults that a :meth:`solve` call
    may override.  ``n=`` gives the dimension when ``A`` is a bare matvec
    callable; without it, promotion waits for the first right-hand side.
    """

    def __init__(self, A, method: str = "plcg_scan", *, tol: float = 1e-8,
                 maxiter: int = 1000, M=None, l=1, sigma=None, spectrum=None,
                 backend: Optional[str] = None, mesh=None, comm=None, restart="auto",
                 residual_replacement: Optional[int] = None, precision=None,
                 device="cuda", n: Optional[int] = None, **options):
        spec = engine.get_method(method)
        engine._prepare_options(spec, options)
        engine._prepare_knobs(mesh=mesh, comm=comm, precision=precision)
        self.M = engine._prepare_preconditioner(M)
        self.l = engine._prepare_depth(l)
        engine._prepare_restart(restart, residual_replacement)
        self.device = resolve_device(device)
        resolve_backend(backend, self.device)          # validate once, up front
        self.method = method
        self.spec = spec
        self.tol = tol
        self.maxiter = maxiter
        self.backend = backend
        spectrum = engine._prepare_spectrum(self.M, sigma, spectrum, self.device)
        self.sigma = engine._resolve_sigma(sigma, spectrum, self.l)
        self.options = dict(options)
        self.stats = {"calls": 0}
        if isinstance(A, LinearOperator) or getattr(A, "ndim", None) == 2:
            self._op = engine.as_operator(A, device=self.device)
        elif callable(A):
            self._op = LinearOperator(matvec=A, n=int(n), name="matvec") if n else None
            self._A_raw = A
        else:
            raise TypeError(f"cannot interpret {type(A).__name__} as a linear operator")

    def _ensure_op(self, b) -> LinearOperator:
        if self._op is None:
            self._op = engine.as_operator(self._A_raw, b, device=self.device)
        return self._op

    def solve(self, b, x0=None, *, tol: Optional[float] = None,
              maxiter: Optional[int] = None) -> SolveResult:
        """Solve ``A x = b`` with the prepared session."""
        tol = self.tol if tol is None else tol
        maxiter = self.maxiter if maxiter is None else maxiter
        self.stats["calls"] += 1
        b = engine._as_rhs(b, self.device)
        op = self._ensure_op(b)
        return self.spec.fn(op, b, x0, tol=tol, maxiter=maxiter, M=self.M, l=self.l,
                            sigma=self.sigma, backend=self.backend, device=self.device,
                            **self.options)

    __call__ = solve

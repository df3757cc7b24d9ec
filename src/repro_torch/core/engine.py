"""Solver front end of the port (port of ``repro.core.engine``).

``solve(A, b, method="plcg_scan", l=..., backend=...)`` dispatches through
a method registry with the common :class:`SolveResult` contract.  This
slice registers the production engine ``plcg_scan`` (paper Alg. 3); the
other methods of the JAX registry (cg, pcg, plcg, dlanczos, plminres) are
ROADMAP A.4.  Because ``plcg_scan`` is the only method, it is also the
default ``method`` here (the JAX front end defaults to ``plcg``).

``backend`` ("fused" | "cuda" | "ref" | "auto" | None) selects the kernel
tier of the engine (see ``repro_torch.core.plcg_scan``): ``"cuda"`` is the
counterpart of the JAX package's ``"pallas"`` per-kernel tier, and
``"pallas"`` is rejected with a pointer to it.  The default stays
``None``, as in JAX.

Every entry point runs on the CUDA card unless ``device="cpu"`` is passed;
inputs are moved to the device, and asking for CUDA without a card raises.

``M=`` takes a structured ``repro_torch.core.precond.Preconditioner``
(``Jacobi`` folds into the fused kernel through its ``inv_diag`` hint;
``BlockJacobi`` and ``Chebyshev`` take the 2-launch split) or a bare
callable applying ``M^{-1} v``; ``Identity`` collapses to the
unpreconditioned pipeline, and without ``sigma``/``spectrum`` the shifts
come from ``M.precond_spectrum``.

Knobs this slice does not port raise ``NotImplementedError`` naming the
ROADMAP item, never silently ignored: a non-default ``precision=`` (A.7),
``restart=<int>`` / ``residual_replacement=`` (A.8), ``mesh=`` / ``comm=``
and the mesh forms of the preconditioners (A.9), ``l="auto"`` (A.10) and
a batched ``(nrhs, n)`` right-hand side (A.5).  ``restart="auto"`` resolves to
``None`` as in ``engine._prepare_restart``, so the default path is the
host restart loop with ``max_restarts=5``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from .linop import LinearOperator, dense_operator
from .plcg_scan import plcg_solve
from .precision import as_precision_policy
from .precond import as_preconditioner
from .results import SolveResult
from .shifts import chebyshev_shifts

_REGISTRY: dict[str, "MethodSpec"] = {}


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """Registry entry: ``fn(A, b, x0, *, tol, maxiter, M, l, sigma, spectrum,
    backend, device, **options)`` returns a :class:`SolveResult`;
    ``options`` is the closed set of method-specific option keys."""

    name: str
    fn: Callable[..., SolveResult]
    description: str = ""
    options: frozenset = frozenset()


def register(name: str, *, description: str = "", options: Sequence[str] = ()):
    """Decorator registering a solver adapter under ``name``."""

    def deco(fn):
        _REGISTRY[name] = MethodSpec(name=name, fn=fn, description=description,
                                     options=frozenset(options))
        return fn

    return deco


def methods() -> tuple[str, ...]:
    """Registered method names, sorted."""
    return tuple(sorted(_REGISTRY))


def get_method(name: str) -> MethodSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown method {name!r}; registered methods: "
                         f"{', '.join(methods())}") from None


def as_operator(A, b=None, *, device="cuda") -> LinearOperator:
    """Coerce ``A`` (LinearOperator | dense square array or tensor | matvec
    callable) into an operator; a dense matrix is placed on ``device``."""
    if isinstance(A, LinearOperator):
        return A
    if getattr(A, "ndim", None) == 2:
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"dense operator must be square, got {tuple(A.shape)}")
        return dense_operator(A, device=device)
    if callable(A):
        if b is None:
            raise ValueError("a matvec callable needs b to infer the problem dimension")
        return LinearOperator(matvec=A, n=b.shape[-1], name="matvec")
    raise TypeError(f"cannot interpret {type(A).__name__} as a linear operator")


def _resolve_sigma(sigma, spectrum, l: int) -> list[float]:
    if sigma is not None:
        sig = [float(s) for s in sigma]
        if len(sig) != l:
            raise ValueError(f"need exactly l={l} shifts, got {len(sig)}")
        return sig
    lmin, lmax = spectrum if spectrum is not None else (0.0, 8.0)
    return chebyshev_shifts(lmin, lmax, l)


# --------------------------------------------------------------------------
# one-time preparation helpers (shared by solve() and session.Solver)
# --------------------------------------------------------------------------

def _prepare_options(spec: MethodSpec, options: dict) -> None:
    """Reject ``**options`` keys outside the method's declared set."""
    unknown = set(options) - spec.options
    if unknown:
        accepted = ", ".join(sorted(spec.options)) if spec.options else "none"
        raise ValueError(f"method {spec.name!r} does not accept options {sorted(unknown)}; "
                         f"accepted options for {spec.name!r}: {accepted}")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def _prepare_knobs(*, mesh, comm, precision):
    """The cross-cutting knobs this slice does not port raise up front;
    returns the (default) precision policy."""
    if mesh is not None or comm is not None:
        raise _not_ported("the mesh execution path (mesh= / comm=)", "A.9")
    policy = as_precision_policy(precision)
    if not policy.is_default:
        raise _not_ported("a non-default precision policy (precision=)", "A.7")
    return policy


def _prepare_preconditioner(M):
    """Normalize ``M`` once: bare callables promote to the Preconditioner
    protocol and Identity collapses to None (the unpreconditioned
    pipeline)."""
    return as_preconditioner(M).runtime()


def _prepare_spectrum(M, sigma, spectrum, device):
    """Default the shift interval from the preconditioned spectrum when the
    preconditioner knows it and neither ``sigma`` nor ``spectrum`` is
    given (BlockJacobi's estimate runs its power iteration here, once, on
    the solve's device)."""
    if M is not None and sigma is None and spectrum is None:
        return M.precond_spectrum((0.0, 8.0), device=device)
    return spectrum


def _prepare_depth(l) -> int:
    if l == "auto":
        raise _not_ported("calibrated pipeline depth (l='auto')", "A.10")
    l = int(l)
    if l < 1:
        raise ValueError(f"pipeline depth l must be >= 1, got {l}")
    return l


def _prepare_restart(restart, residual_replacement):
    """``restart="auto"`` resolves to None (no in-scan recovery, as in the
    JAX engine without ``residual_replacement``); an int cap or a
    replacement period selects the in-scan stability path, not ported."""
    if restart == "auto":
        restart = None
    if restart is not None or residual_replacement is not None:
        raise _not_ported("in-scan restart / residual replacement "
                          "(restart=<int> / residual_replacement=)", "A.8")
    return None


def _as_rhs(b, device) -> torch.Tensor:
    b = torch.as_tensor(b, device=device)
    if b.dim() == 2:
        raise _not_ported("a batched (nrhs, n) right-hand side", "A.5")
    if b.dim() != 1:
        raise ValueError(f"b must be (n,), got {tuple(b.shape)}")
    return b


# --------------------------------------------------------------------------
# the front end
# --------------------------------------------------------------------------

def solve(A, b, method: str = "plcg_scan", *, x0=None, tol: float = 1e-8,
          maxiter: int = 1000, M=None, l=1, sigma: Optional[Sequence[float]] = None,
          spectrum: Optional[tuple] = None, backend: Optional[str] = None, mesh=None,
          comm=None, restart="auto", residual_replacement: Optional[int] = None,
          precision=None, device="cuda", **options) -> SolveResult:
    """Solve ``A x = b`` on ``device`` (default the CUDA card).

    Arguments mean what they mean in ``repro.core.solve``; see the module
    docstring for what this slice accepts.  This is the one-shot wrapper
    around :class:`repro_torch.core.session.Solver`.
    """
    from .session import Solver
    return Solver(A, method=method, tol=tol, maxiter=maxiter, M=M, l=l, sigma=sigma,
                  spectrum=spectrum, backend=backend, mesh=mesh, comm=comm,
                  restart=restart, residual_replacement=residual_replacement,
                  precision=precision, device=device, **options).solve(b, x0=x0)


@register("plcg_scan", options=("exploit_symmetry", "max_restarts"),
          description="p(l)-CG production engine (Alg. 3), PyTorch / CUDA")
def _method_plcg_scan(A, b, x0=None, *, tol=1e-8, maxiter=1000, M=None, l=1, sigma=None,
                      spectrum=None, backend=None, device="cuda", **kw):
    sig = _resolve_sigma(sigma, spectrum, l)
    x, resnorms, info = plcg_solve(A.matvec, b, x0, l=l, sigma=sig, tol=tol,
                                   maxiter=maxiter, prec=M, backend=backend,
                                   stencil_hw=A.stencil2d, device=device, **kw)
    return SolveResult(
        x=x, resnorms=resnorms, iters=info["iterations"], converged=info["converged"],
        breakdowns=info["breakdowns"], restarts=info["restarts"],
        replacements=info["replacements"],
        info={"method": f"p({l})-CG[scan]", "l": l, "sigma": sig, "backend": backend,
              "restart": None, "residual_replacement": None, "precision": None,
              "prec": getattr(M, "name", None) if M is not None else None,
              "bodies": info["bodies"], "device": str(device)})

"""Core solver library of the port: ``solve`` / ``Solver`` over the p(l)-CG
scan engine, with the operator, result, shift and precision types they
use (see ``repro_torch.core.engine`` for what this slice covers)."""
from .engine import as_operator, get_method, methods, register, solve
from .linop import LinearOperator, dense_operator
from .precision import PRECISION_MODES, PrecisionPolicy, as_precision_policy
from .results import SolveResult
from .session import Solver
from .shifts import chebyshev_shifts, leja_order, monomial_shifts, ritz_shifts

__all__ = [
    "LinearOperator",
    "PRECISION_MODES",
    "PrecisionPolicy",
    "SolveResult",
    "Solver",
    "as_operator",
    "as_precision_policy",
    "chebyshev_shifts",
    "dense_operator",
    "get_method",
    "leja_order",
    "methods",
    "monomial_shifts",
    "register",
    "ritz_shifts",
    "solve",
]

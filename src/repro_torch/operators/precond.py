"""Preconditioners built from an operator (port of ``repro.operators.precond``).

``block_jacobi_ssor`` / ``block_jacobi_for`` (host scipy triangular solves
reached only by the numpy oracle solvers) are not ported yet (ROADMAP A.6).
"""
from __future__ import annotations

from ..core.linop import LinearOperator
from ..core.precond import Jacobi


def jacobi(A: LinearOperator) -> Jacobi:
    """Diagonal (Jacobi) preconditioner M = diag(A), with the ``inv_diag``
    hint that keeps ``backend="fused"`` at one launch per body."""
    return Jacobi.from_operator(A)

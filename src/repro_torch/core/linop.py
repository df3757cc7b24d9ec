"""Linear operator abstraction (port of ``repro.core.linop``).

A :class:`LinearOperator` wraps a ``matvec`` callable on torch tensors; the
solvers only ever call ``A @ v`` / ``A.matvec(v)``.  :class:`Preconditioner`
is the legacy dataclass form of ``M^{-1}``, which
``core.precond.as_preconditioner`` promotes.  ``BindableOperator``
(rebindable operator data for Newton-CG training) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class LinearOperator:
    """Matrix-free symmetric linear operator ``v -> A v``.

    Attributes:
      matvec: the operator application on a 1-D tensor.
      n: problem dimension (vectors have shape ``(n,)``).
      diag: optional diagonal of A (for Jacobi-type preconditioners).
      name: human-readable tag.
      stencil2d: optional (H, W) grid shape when the operator IS the
        unscaled 5-point Dirichlet Poisson stencil on that grid -- the
        structural hint that lets ``backend="fused"`` run the SPMV inside
        its one kernel launch per body.
    """

    matvec: Callable[[torch.Tensor], torch.Tensor]
    n: int
    diag: Optional[torch.Tensor] = None
    name: str = "A"
    stencil2d: Optional[tuple] = None

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        return self.matvec(v)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.matvec(v)


@dataclasses.dataclass(frozen=True)
class Preconditioner:
    """SPD preconditioner; ``apply`` computes ``M^{-1} v``."""

    apply: Callable[[torch.Tensor], torch.Tensor]
    name: str = "M"

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.apply(v)


def dense_operator(A, name: str = "dense", device="cuda") -> LinearOperator:
    """Wrap a dense (n, n) symmetric matrix (numpy array or tensor) as a
    LinearOperator whose matrix lives on ``device``."""
    At = torch.as_tensor(A, device=resolve_device(device))
    n = At.shape[0]
    if At.shape != (n, n):
        raise ValueError(f"dense_operator expects a square matrix, got {tuple(At.shape)}")
    return LinearOperator(matvec=lambda v: At @ v, n=n, diag=At.diagonal(), name=name)

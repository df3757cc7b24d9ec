"""Matrix-free Poisson stencil operator (port of ``repro.operators.poisson``).

The paper's benchmark problem: the unscaled 5-point stencil (diagonal 4,
neighbors -1) with homogeneous Dirichlet boundaries on an ``nx x ny`` grid,
vectors flattened row-major through ``reshape(nx, ny)``.  Its spectrum lies
in (0, 8), the paper's Chebyshev shift interval (Sec. 5, test setup 1).
"""
from __future__ import annotations

import torch

from ..core.linop import LinearOperator


def _stencil2d_apply(u: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    g = u.reshape(nx, ny)
    out = 4.0 * g
    # the same subtraction order as repro.operators.poisson
    out[1:, :] -= g[:-1, :]
    out[:-1, :] -= g[1:, :]
    out[:, 1:] -= g[:, :-1]
    out[:, :-1] -= g[:, 1:]
    return out.reshape(-1)


def poisson2d(nx: int, ny: int | None = None) -> LinearOperator:
    """Unscaled 5-point stencil 2D Poisson operator on an nx x ny grid.

    The matvec runs on whatever device its input lives on; the operator
    carries the ``stencil2d=(nx, ny)`` hint for the fused kernel tier."""
    ny = nx if ny is None else ny
    return LinearOperator(matvec=lambda u: _stencil2d_apply(u, nx, ny),
                          n=nx * ny, name=f"poisson2d-{nx}x{ny}",
                          stencil2d=(nx, ny))


def poisson_eig_interval(dim: int = 2) -> tuple:
    """Spectral inclusion interval for the Chebyshev shifts (paper: [0,8])."""
    return (0.0, 4.0 * dim)

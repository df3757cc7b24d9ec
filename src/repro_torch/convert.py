"""Carries a problem described on the JAX side across to the port.

The JAX package describes a problem with numpy arrays and plain values: a
Poisson grid or a dense matrix, the right-hand side, the initial guess,
the shifts and a ``SolverConfig``.  :func:`from_reference` turns that
description into the port's objects on a given device -- the counterpart
of carrying weights across.  The parity tests build both sides from the
same seeded numpy data through it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .configs.poisson2d import SolverConfig
from .core.linop import LinearOperator, dense_operator
from .device import resolve_device
from .operators.poisson import poisson2d


@dataclasses.dataclass(frozen=True)
class Problem:
    A: LinearOperator
    b: Optional[torch.Tensor]
    x0: Optional[torch.Tensor]
    sigma: Optional[list]
    config: Optional[SolverConfig]


def from_reference(*, grid: Optional[tuple] = None, dense=None, b=None, x0=None,
                   sigma=None, config: Optional[dict] = None, device="cuda") -> Problem:
    """Build the port's problem on ``device`` from the JAX side's description.

    Args:
      grid: ``(nx, ny)`` of the 5-point Poisson operator (``poisson2d``).
      dense: a dense (n, n) numpy matrix (``dense_operator``).  Exactly one
        of ``grid`` and ``dense`` is given.
      b, x0: numpy vectors (dtype kept).
      sigma: the l shifts, as numbers.
      config: a ``SolverConfig`` given as a dict.
    """
    if (grid is None) == (dense is None):
        raise ValueError("give exactly one of grid=(nx, ny) and dense=<matrix>")
    dev = resolve_device(device)
    A = poisson2d(*grid) if grid is not None else dense_operator(np.asarray(dense), device=dev)

    def vec(v):
        return None if v is None else torch.as_tensor(np.asarray(v), device=dev)

    return Problem(A=A, b=vec(b), x0=vec(x0),
                   sigma=None if sigma is None else [float(s) for s in sigma],
                   config=None if config is None else SolverConfig(**config))

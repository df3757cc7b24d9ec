"""Shift choices for the auxiliary Krylov basis Z (port of
``repro.core.shifts``; paper Remark 3, eq. (8)).

Pure Python math.  The traced Ritz refresh of the in-scan restart path
(``ritz_values_from_tridiag``) waits for the stability port (ROADMAP A.8).
"""
from __future__ import annotations

import math
from typing import Sequence


def chebyshev_shifts(lmin: float, lmax: float, l: int) -> list[float]:
    """Roots of the degree-l Chebyshev polynomial on [lmin, lmax] (eq. (8)).

    sigma_i = (lmax+lmin)/2 + (lmax-lmin)/2 * cos((2i+1) pi / (2 l)).
    """
    if l < 1:
        raise ValueError("pipeline depth l must be >= 1")
    mid = 0.5 * (lmax + lmin)
    rad = 0.5 * (lmax - lmin)
    return [mid + rad * math.cos((2 * i + 1) * math.pi / (2 * l)) for i in range(l)]


def monomial_shifts(l: int) -> list[float]:
    """All-zero shifts => monomial basis [v0, A v0, ...] (Remark 3)."""
    return [0.0] * l


def leja_order(vals: Sequence[float], l: int) -> list[float]:
    """The ``l`` extremal-spread values of ``vals`` in Leja order: start at
    the largest magnitude, then greedily maximize the product of distances
    to the values already chosen (Hoemmen 2010)."""
    vals = sorted(float(v) for v in vals)
    if len(vals) < l:
        raise ValueError(f"need at least l={l} values, got {len(vals)}")
    chosen: list[float] = [max(vals, key=abs)]
    remaining = list(vals)
    remaining.remove(chosen[0])
    while len(chosen) < l:
        nxt = max(remaining, key=lambda v: math.prod(abs(v - c) for c in chosen))
        chosen.append(nxt)
        remaining.remove(nxt)
    return chosen


def ritz_shifts(ritz_values: Sequence[float], l: int) -> list[float]:
    """Use (a subset of) precomputed Ritz values of A as shifts (Remark 3):
    the ``l`` Leja-ordered values."""
    return leja_order(ritz_values, l)

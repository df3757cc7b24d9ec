"""Common result record for the solvers (port of ``repro.core.results``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class SolveResult:
    x: Any                        # final iterate (torch tensor on the solve's device)
    resnorms: list                # recursive residual norm history
    iters: int                    # number of solution updates performed
    converged: bool
    breakdowns: int = 0           # square-root breakdowns encountered
    restarts: int = 0             # explicit restarts performed after breakdowns
    replacements: int = 0         # periodic true-residual replacements
    true_resnorms: Optional[list] = None
    info: dict = dataclasses.field(default_factory=dict)

    @property
    def final_resnorm(self):
        return self.resnorms[-1] if self.resnorms else None

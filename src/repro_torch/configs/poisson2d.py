"""The paper's own workload: 2D Poisson systems solved with p(l)-CG
(port of ``repro.configs.poisson2d``, same values).

1000x1000 is the paper's Sec. 5 test setup 1; l=3, tol 1e-5, maxiter 2000
and float64 are the repository's configuration of it.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    arch_id: str = "poisson2d"
    nx: int = 1000
    ny: int = 1000
    l: int = 3
    tol: float = 1e-5
    maxiter: int = 2000
    lmin: float = 0.0
    lmax: float = 8.0
    dtype: str = "float64"


CONFIG = SolverConfig()

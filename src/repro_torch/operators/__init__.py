from .poisson import poisson2d, poisson_eig_interval
from .precond import jacobi

__all__ = ["jacobi", "poisson2d", "poisson_eig_interval"]

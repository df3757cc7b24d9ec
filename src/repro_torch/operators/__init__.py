from .poisson import poisson2d, poisson_eig_interval

__all__ = ["poisson2d", "poisson_eig_interval"]

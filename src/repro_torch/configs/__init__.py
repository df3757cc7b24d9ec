"""Configurations of the port (the paper's Poisson workload)."""
from .poisson2d import CONFIG, SolverConfig

__all__ = ["CONFIG", "SolverConfig"]

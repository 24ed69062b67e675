"""Numerical operators: periodic stencils, spectral and multigrid solves, and
the CUDA kernels (step_kernel: K1, K8, K9, K15, K17; dft_kernels: K2-K5,
K16; mg_kernels: K10, K11) with their plain versions."""

from .stencils import arakawa_J, centered_diff_x, laplace_5p  # noqa: F401
from .spectral import HelmholtzSolver, solve_helmholtz, solve_poisson  # noqa: F401

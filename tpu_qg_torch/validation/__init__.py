"""Validation against the reference algorithm: the float64 NumPy twin
(``twin``), the discrete linear theory (``linear_theory``) and the allclose
command line (``allclose``)."""

from .twin import ReferenceTwin  # noqa: F401

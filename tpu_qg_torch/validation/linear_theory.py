"""Discrete linear stability theory of the Phillips two-layer model.

Counterpart of ``tpu_qg.validation.linear_theory``, a copy of that NumPy
module that takes the port's ``ModelConfig``.

Independent cross-check of the entire numerical pipeline: linearize the
*discrete* equations (the exact symbols of the 5-point Laplacian, centred
difference, and modal inversion — including the reference's P(H_1, H_1)
back-projection quirk when enabled) about the sheared base state, and compute
per-wavenumber complex growth rates from the 2x2 eigenproblem. The nonlinear
model initialized with a small unstable eigenmode must grow at this rate —
validating tendencies, inversion, and stepping against closed-form theory the
reference never had (its validation was visual, SURVEY.md section 4).

For mode exp(i 2 pi (kappa x_i / M + ell y_j / P)) the discrete symbols are
    lam  = (2 cos(2 pi kappa / M) - 2 + 2 cos(2 pi ell / P) - 2) / dx^2
    ikx  = i sin(2 pi kappa / M) / dx          (centred difference)
and the linearized system (J is quadratic about rest, so it drops) is
    d(zeta_1)/dt = -ikx U zeta_1 + (visc lam^2 - ikx beta_1) psi_1
    d(zeta_2)/dt = (visc lam^2 - ikx beta_2 - r lam) psi_2
with psi = G zeta via the modal inversion map
    G = P_back @ diag(1/lam, 1/(lam + S_eig)) @ P_inv.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import ModelConfig


def inversion_map(cfg: ModelConfig, lam: float) -> np.ndarray:
    """The 2x2 zeta_hat -> psi_hat map of the model's modal inversion at
    Laplacian eigenvalue ``lam`` (honors compat_reference_P)."""
    P_inv = np.array(cfg.P_inv_matrix())
    P_back = np.array(cfg.back_projection_matrix())
    return P_back @ np.diag([1.0 / lam, 1.0 / (lam + cfg.S_eig)]) @ P_inv


def linear_matrix(cfg: ModelConfig, kappa: int, ell: int) -> np.ndarray:
    """d(zeta_hat)/dt = A zeta_hat for the discrete mode (kappa, ell)."""
    dx = cfg.dx
    lam = ((2.0 * np.cos(2.0 * np.pi * kappa / cfg.M) - 2.0)
           + (2.0 * np.cos(2.0 * np.pi * ell / cfg.P) - 2.0)) / (dx * dx)
    ikx = 1j * np.sin(2.0 * np.pi * kappa / cfg.M) / dx

    G = inversion_map(cfg, lam)
    T_zeta = np.diag([-ikx * cfg.U, 0.0])
    T_psi = np.diag([
        cfg.visc * lam * lam - ikx * cfg.beta_1,
        cfg.visc * lam * lam - ikx * cfg.beta_2 - cfg.r * lam,
    ])
    return T_zeta + T_psi @ G


def growth_rate(cfg: ModelConfig, kappa: int, ell: int
                ) -> Tuple[complex, np.ndarray]:
    """(fastest eigenvalue, its zeta eigenvector) for mode (kappa, ell)."""
    A = linear_matrix(cfg, kappa, ell)
    vals, vecs = np.linalg.eig(A)
    i = int(np.argmax(vals.real))
    return vals[i], vecs[:, i]


def fastest_growing_mode(cfg: ModelConfig, max_kappa: int = None
                         ) -> Tuple[int, int, complex, np.ndarray]:
    """Scan zonal modes (ell = 0 is always fastest for pure shear) and return
    (kappa, ell, sigma, eigenvector) of the largest growth rate."""
    max_kappa = max_kappa or cfg.M // 2 - 1
    best = (1, 0, complex(-np.inf), None)
    for kappa in range(1, max_kappa + 1):
        for ell in (0, 1, 2):
            sig, vec = growth_rate(cfg, kappa, ell)
            if sig.real > best[2].real:
                best = (kappa, ell, sig, vec)
    return best


def eigenmode_fields(cfg: ModelConfig, kappa: int, ell: int,
                     vec: np.ndarray, amplitude: float) -> np.ndarray:
    """Real zeta fields (2, M, P) of the eigenmode at the given amplitude."""
    x = np.arange(cfg.M)
    y = np.arange(cfg.P)
    phase = np.exp(2j * np.pi * (kappa * x[:, None] / cfg.M
                                 + ell * y[None, :] / cfg.P))
    zeta = np.real(vec[:, None, None] * phase[None, :, :]) * amplitude
    return zeta

"""Physics diagnostics: energy, enstrophy, CFL, energy spectrum.

Counterpart of ``tpu_qg.utils.diagnostics``. The reductions run on the
field's device; ``diagnostics`` brings the scalars to the host once per call.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.stencils import centered_diff_x, centered_diff_x_generic
from ..parallel.collectives import all_gather_scalars
from ..parallel.halo import exchange_halo, make_padded_shift


def _grad_sq(psi: torch.Tensor, dx: float) -> torch.Tensor:
    """|grad psi|^2 with centred differences, per layer."""
    dpx = centered_diff_x(psi, dx)
    dpy = torch.swapaxes(centered_diff_x(torch.swapaxes(psi, -1, -2), dx),
                         -1, -2)
    return dpx * dpx + dpy * dpy


def energy(cfg: ModelConfig, psi: torch.Tensor) -> torch.Tensor:
    """Kinetic energy per layer: 0.5 * mean(|grad psi|^2), shape (L,)."""
    return 0.5 * torch.mean(_grad_sq(psi, cfg.dx), dim=(-2, -1))


def enstrophy(zeta: torch.Tensor) -> torch.Tensor:
    """Potential enstrophy per layer: 0.5 * mean(zeta^2), shape (L,)."""
    return 0.5 * torch.mean(zeta * zeta, dim=(-2, -1))


def cfl_number(cfg: ModelConfig, psi: torch.Tensor) -> torch.Tensor:
    """Advective CFL: max(|u|) * dt / dx with u = |grad psi| (plus the mean
    flow U on layer 1)."""
    speed = torch.sqrt(torch.max(_grad_sq(psi, cfg.dx)))
    return (speed + abs(cfg.U)) * cfg.dt / cfg.dx


def energy_spectrum(cfg: ModelConfig, psi):
    """Isotropic kinetic-energy spectrum per layer, summed over circular
    wavenumber-magnitude bins with the discrete Laplacian symbol so that
    sum(E) equals the discrete KE. Returns (k_bins [1/m], E [L, n_bins]).
    Host-side analysis helper (numpy)."""
    from ..ops.spectral import periodic_laplacian_eigenvalues

    if isinstance(psi, torch.Tensor):
        psi = psi.detach().cpu().numpy()
    psi = np.asarray(psi)
    L_ax, M, P = psi.shape
    psi_hat = np.fft.rfft2(psi, axes=(-2, -1)) / (M * P)
    lam = -periodic_laplacian_eigenvalues(M, P, cfg.dx)  # >= 0
    # rfft double-counts interior columns once unfolded; weight them x2.
    w = np.full(lam.shape, 2.0)
    w[:, 0] = 1.0
    if P % 2 == 0:
        w[:, -1] = 1.0
    E2d = 0.5 * lam[None] * np.abs(psi_hat) ** 2 * w[None]

    kx = np.fft.fftfreq(M, d=cfg.dx) * 2.0 * np.pi
    ky = np.fft.rfftfreq(P, d=cfg.dx) * 2.0 * np.pi
    kmag = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
    dk = 2.0 * np.pi / max(cfg.Lx, cfg.Ly)
    n_bins = int(kmag.max() / dk) + 1
    idx = np.minimum((kmag / dk).astype(int), n_bins - 1)
    E = np.zeros((L_ax, n_bins))
    for layer in range(L_ax):
        np.add.at(E[layer], idx.ravel(), E2d[layer].ravel())
    k_bins = (np.arange(n_bins) + 0.5) * dk
    return k_bins, E


def diagnostics(cfg: ModelConfig, state) -> Dict[str, float]:
    """Scalar diagnostic dict for logging (one device-to-host copy)."""
    ke = energy(cfg, state.psi)
    ens = enstrophy(state.zeta)
    vals = torch.cat([ke, ens, cfl_number(cfg, state.psi).reshape(1),
                      torch.max(torch.abs(state.zeta)).reshape(1)])
    host = vals.double().cpu().tolist()
    L = ke.shape[0]
    out = {"step": int(state.step), "cfl": host[2 * L],
           "max_abs_zeta": host[2 * L + 1]}
    for i in range(L):
        out[f"ke_{i + 1}"] = host[i]
        out[f"enstrophy_{i + 1}"] = host[L + i]
    return out


def sharded_diagnostics(cfg: ModelConfig, state, mesh) -> Dict[str, float]:
    """``diagnostics`` of a state held as a mesh's blocks (a collective: call
    on every rank): the gradients on each block padded with a halo of 1,
    the sums and maxima exchanged between the ranks."""
    shift = make_padded_shift(1)
    pad = exchange_halo(state.psi, 1, mesh)
    dpx = centered_diff_x_generic(shift, pad, cfg.dx)
    dpy = torch.swapaxes(centered_diff_x_generic(
        shift, torch.swapaxes(pad, -1, -2), cfg.dx), -1, -2)
    g2 = dpx * dpx + dpy * dpy
    local = torch.cat([g2.sum(dim=(-2, -1)),
                       (state.zeta * state.zeta).sum(dim=(-2, -1)),
                       g2.max().reshape(1),
                       state.zeta.abs().max().reshape(1)]).double()
    every = all_gather_scalars(local, mesh)
    L = state.psi.shape[0]
    n = float(cfg.M * cfg.P)
    sums = every[:, :2 * L].sum(dim=0)
    speed = float(torch.sqrt(every[:, 2 * L].max()))
    host = sums.cpu().tolist()
    out = {"step": int(state.step),
           "cfl": (speed + abs(cfg.U)) * cfg.dt / cfg.dx,
           "max_abs_zeta": float(every[:, 2 * L + 1].max())}
    for i in range(L):
        out[f"ke_{i + 1}"] = 0.5 * host[i] / n
        out[f"enstrophy_{i + 1}"] = 0.5 * host[L + i] / n
    return out

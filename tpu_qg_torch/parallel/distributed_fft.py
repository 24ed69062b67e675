"""Distributed spectral Helmholtz/Poisson solve by transposed FFTs.

Counterpart of ``tpu_qg.parallel.distributed_fft`` on ``torch.fft``: on an
(nx, ny) mesh holding (m, p) tiles of the global (M, P) grid, the solve is

  1. all-to-all over the y-ring        -> tiles become (m/ny, P) row strips
  2. local rfft along y, the frequency axis zero-padded to a multiple of
     n = nx * ny
  3. all-to-all over the whole mesh    -> (M, Pk_pad/n) column strips
  4. local FFT along x, multiply by the inverse discrete symbol, local IFFT
  5. the inverse transposes of (3) and (1), local irfft along y

(the reference's sparse Cholesky backsolves solve the same matrix,
reference: src/schemes/laplacian.jl:60-75). The flattened (x, y) rank order
is the mesh rank, so step 3 runs over the whole mesh's group.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .collectives import all_to_all
from .mesh import Mesh


class DistributedHelmholtzSolver:
    """Batched multi-mode solve (lap + alpha_k) u_k = f_k for local tiles f
    of shape (K, m, p), K = len(alphas). alpha_k == 0 selects the zero-mean
    Poisson gauge for that mode (its global (0, 0) coefficient is zeroed)."""

    def __init__(self, M: int, P: int, dx: float, alphas: Sequence[float],
                 mesh: Mesh):
        self.M, self.P, self.dx = M, P, dx
        self.alphas = tuple(alphas)
        self.mesh = mesh
        k = np.arange(M)
        l = np.arange(P)
        self.lam_x = (2.0 * np.cos(2.0 * np.pi * k / M) - 2.0) / (dx * dx)
        self.lam_y = (2.0 * np.cos(2.0 * np.pi * l / P) - 2.0) / (dx * dx)
        self._inv = {}

    def _inv_symbol(self, col_offset: int, width: int, dtype,
                    device) -> torch.Tensor:
        """(K, M, width) inverse symbol for the column strip at
        ``col_offset`` (rfft frequency indexing; columns past P//2 are zero
        padding, whose symbol value does not matter)."""
        key = (col_offset, width, dtype, device)
        if key not in self._inv:
            lam_y = np.concatenate([self.lam_y, np.ones(self.P)])
            lam_y = lam_y[col_offset:col_offset + width]

            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=device)

            alphas = t(self.alphas)[:, None, None]
            denom = t(self.lam_x)[None, :, None] + t(lam_y)[None, None, :] \
                + alphas
            rows0 = (torch.arange(self.M, device=device) == 0)[None, :, None]
            cols0 = (col_offset + torch.arange(width, device=device)
                     == 0)[None, None, :]
            singular = (alphas == 0.0) & rows0 & cols0
            denom = torch.where(singular, 1.0, denom)
            self._inv[key] = torch.where(singular, 0.0, 1.0 / denom)
        return self._inv[key]

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        nx, ny = mesh.shape
        n = nx * ny
        K, m, p = f.shape
        if K != len(self.alphas) or m * nx != self.M or p * ny != self.P:
            raise ValueError(f"tile {tuple(f.shape)} does not fit ({self.M}, "
                             f"{self.P}) on mesh {mesh.shape} with "
                             f"{len(self.alphas)} modes")
        if m % ny or self.P % n:
            raise ValueError("tile rows must divide by ny and P by nx * ny "
                             "for the transposes")
        # (1) y-transpose: (K, m, p) -> (K, m/ny, P).
        g = all_to_all(f, mesh.y_group, ny, 1, 2)
        # (2) rfft along y, frequencies padded to a multiple of n.
        gh = torch.fft.rfft(g, dim=2)
        Pk = self.P // 2 + 1
        Pk_pad = -(-Pk // n) * n if n > 1 else Pk
        if Pk_pad != Pk:
            gh = torch.nn.functional.pad(gh, (0, Pk_pad - Pk))
        # (3) xy-transpose: (K, m/ny, Pk_pad) -> (K, M, Pk_pad/n).
        gh = all_to_all(gh, mesh.group, n, 2, 1)
        # (4) FFT along x, inverse symbol, IFFT along x.
        w = Pk_pad // n
        uh = torch.fft.fft(gh, dim=1)
        uh = uh * self._inv_symbol(mesh.rank * w, w, f.dtype, f.device)
        u = torch.fft.ifft(uh, dim=1)
        # (5) inverse transposes, drop the padding, irfft along y.
        u = all_to_all(u, mesh.group, n, 1, 2)
        u = torch.fft.irfft(u[:, :, :Pk], n=self.P, dim=2)
        u = all_to_all(u, mesh.y_group, ny, 2, 1)
        return u.to(f.dtype)

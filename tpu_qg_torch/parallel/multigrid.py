"""Distributed geometric multigrid: the elliptic solve whose traffic is
O(halo).

Counterpart of ``tpu_qg.parallel.multigrid`` on ``torch.distributed``: the
V-cycle of ``ops/multigrid.py`` run on each rank's (K, M/nx, P/ny) tile, with
a 1-cell halo exchange (``halo.exchange_halo``) before every stencil at
every level, and a small coarse grid gathered onto every rank and solved
there spectrally (every rank computes the same coarse answer, so nothing is
broadcast). It takes any (nx, ny) mesh: only the evenness of the local
tiles gates coarsening, and the gather absorbs the rest.

As in ``tpu_qg``, the local tiles run the level ops (``jacobi_smooth``,
``apply_helmholtz``, ``restrict_full_weighting_padded``,
``prolong_bilinear`` with the padded shift), not the K10/K11 kernels
(``tpu_qg/parallel/multigrid.py:33-36`` imports the level ops alone).

Reference counterpart: the per-step elliptic solve
(src/schemes/laplacian.jl:60-75 via src/model.jl:184-192): the same 5-point
system, a communication-avoiding algorithm.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.multigrid import (apply_helmholtz, jacobi_smooth,
                             prolong_bilinear,
                             restrict_full_weighting_padded)
from ..ops.spectral import BatchedModalSolver, _SymbolCache
from .collectives import all_gather_blocks, all_reduce_sum
from .halo import exchange_halo, make_padded_shift
from .mesh import Mesh

_shift1 = make_padded_shift(1)


def distributed_levels(M: int, P: int, dx: float, nx: int, ny: int,
                       gather_cutoff: int = 64):
    """(levels, coarse, coarse_loc) of the distributed V-cycle
    (``tpu_qg/parallel/multigrid.py:73-80``): level (m, p, h) in global
    extents, coarsened while both local extents are even and min(m, p) >
    ``gather_cutoff``; ``coarse`` is the first level that fails, the one
    gathered, and ``coarse_loc`` its local extents."""
    levels = []
    m, p, h = M, P, dx
    mloc, ploc = M // nx, P // ny
    while mloc % 2 == 0 and ploc % 2 == 0 and min(m, p) > gather_cutoff:
        levels.append((m, p, h))
        m, p, h = m // 2, p // 2, h * 2.0
        mloc, ploc = mloc // 2, ploc // 2
    return levels, (m, p, h), (mloc, ploc)


class DistributedMultigridSolver:
    """Solves (lap_5p + alpha_k) u_k = f_k on this rank's (K, M/nx, P/ny)
    tiles of ``mesh``: ``n_cycles`` V(nu1, nu2)-cycles from ``x0`` (or zero),
    the zero-mean gauge on the singular (alpha == 0) modes of the right-hand
    side and of the answer. A collective: every rank calls it in turn."""

    def __init__(self, M: int, P: int, dx: float, alphas: Sequence[float],
                 mesh: Mesh, n_cycles: int = 8, nu1: int = 2, nu2: int = 2,
                 omega: float = 0.8, gather_cutoff: int = 64):
        nx, ny = mesh.shape
        if M % nx or P % ny:
            raise ValueError(f"grid ({M}, {P}) not divisible by mesh "
                             f"({nx}, {ny})")
        self.M, self.P, self.dx = M, P, dx
        self.alphas = tuple(float(a) for a in alphas)
        self.mesh = mesh
        self.n_cycles, self.nu1, self.nu2 = n_cycles, nu1, nu2
        self.omega = omega
        self.levels, self.coarse, self.coarse_loc = distributed_levels(
            M, P, dx, nx, ny, gather_cutoff)
        # The port's _coarse_spectral_solve builds this solver each call;
        # here it is built once, as ops.multigrid.MultigridSolver does.
        self._coarse_solver = BatchedModalSolver(*self.coarse, self.alphas)
        self._alpha = _SymbolCache(lambda dtype, device: torch.tensor(
            self.alphas, dtype=dtype, device=device).reshape(-1, 1, 1))
        self._singular = _SymbolCache(lambda dtype, device: torch.tensor(
            [a == 0.0 for a in self.alphas], dtype=dtype,
            device=device).reshape(-1, 1, 1))

    def _pad1(self, u: torch.Tensor) -> torch.Tensor:
        return exchange_halo(u, 1, self.mesh)

    def _mean(self, f: torch.Tensor) -> torch.Tensor:
        """The global per-mode mean of an interior (K, m, p) block, the same
        on every rank."""
        s = torch.sum(f, dim=(-2, -1), keepdim=True)
        return all_reduce_sum(s, self.mesh) / (self.M * self.P)

    def _coarse_solve(self, f_loc: torch.Tensor) -> torch.Tensor:
        """Gather the coarse grid onto every rank, solve it there, and take
        back this rank's tile."""
        mloc, ploc = self.coarse_loc
        g = all_gather_blocks(f_loc.contiguous(), self.mesh)
        u = self._coarse_solver(g)
        ix, iy = self.mesh.ix, self.mesh.iy
        return u[:, ix * mloc:(ix + 1) * mloc, iy * ploc:(iy + 1) * ploc]

    def _vcycle(self, lvl: int, u: torch.Tensor,
                f: torch.Tensor) -> torch.Tensor:
        if lvl == len(self.levels):
            return self._coarse_solve(f)
        _, _, h = self.levels[lvl]
        a = self._alpha.get(u.dtype, u.device)
        for _ in range(self.nu1):
            u = jacobi_smooth(self._pad1(u), f, h, a, self.omega,
                              shift=_shift1)
        r = f - apply_helmholtz(self._pad1(u), h, a, shift=_shift1)
        rc = restrict_full_weighting_padded(self._pad1(r))
        ec = self._vcycle(lvl + 1, torch.zeros_like(rc), rc)
        u = u + prolong_bilinear(self._pad1(ec), shift=_shift1)
        for _ in range(self.nu2):
            u = jacobi_smooth(self._pad1(u), f, h, a, self.omega,
                              shift=_shift1)
        return u

    def __call__(self, f: torch.Tensor,
                 x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        singular = self._singular.get(f.dtype, f.device)
        f = f - singular * self._mean(f)
        u = torch.zeros_like(f) if x0 is None else x0
        for _ in range(self.n_cycles):
            u = self._vcycle(0, u, f)
        return u - singular * self._mean(u)


class DistributedMultigridInverter:
    """The two-layer modal inversion zeta -> psi on this rank's tiles: the
    local projection P^-1, the distributed batched V-cycles (the Poisson
    and Helmholtz modes share every halo exchange), the local
    back-projection. The distributed counterpart of
    ``ops.multigrid.MultigridModalInverter`` on any (nx, ny) mesh.

    ``psi_prev`` seeds the V-cycles with P_back^-1 psi_prev (psi = P_back
    modes; P_inv differs from P_back^-1 under ``compat_reference_P``)."""

    def __init__(self, M: int, P: int, dx: float, alpha2: float,
                 P_inv, P_back, mesh: Mesh, n_cycles: int = 8, nu1: int = 2,
                 nu2: int = 2):
        self.solver = DistributedMultigridSolver(
            M, P, dx, (0.0, float(alpha2)), mesh, n_cycles=n_cycles,
            nu1=nu1, nu2=nu2)
        self.P_inv = np.asarray(P_inv, dtype=np.float64)
        self.P_back = np.asarray(P_back, dtype=np.float64)
        self.P_back_inv = np.linalg.inv(self.P_back)
        self._mats = _SymbolCache(lambda dtype, device: [
            torch.as_tensor(m, dtype=dtype, device=device)
            for m in (self.P_inv, self.P_back, self.P_back_inv)])

    def __call__(self, zeta: torch.Tensor,
                 psi_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, b, bi = self._mats.get(zeta.dtype, zeta.device)
        modes_rhs = torch.einsum("ab,bmp->amp", q, zeta)
        x0 = (None if psi_prev is None
              else torch.einsum("ab,bmp->amp", bi, psi_prev))
        modes = self.solver(modes_rhs, x0=x0)
        return torch.einsum("ab,bmp->amp", b, modes)

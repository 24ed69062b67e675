"""Geometric multigrid for the doubly-periodic 5-point Poisson/Helmholtz.

Counterpart of ``tpu_qg.ops.multigrid``: the same level ops, levels, V(nu1,
nu2)-cycle, coarse spectral solve and zero-mean gauge, in the reference's
arithmetic and grouping, on torch tensors. Multigrid solves the same
discrete system as the spectral inverters (``ops/spectral.py``) with a
different algorithm: its distributed form communicates O(halo) per sweep
instead of the whole field.

Components (shift-generic over ``stencils.roll_shift``, as in the
reference):

  * damped-Jacobi smoother (omega = 4/5) in residual-correction form, with
    the Helmholtz operator in DIFFERENCE form (in float32 the sum-minus-4c
    form stalls the V-cycle near 3e-4 relative);
  * full-weighting restriction, separable [1, 2, 1]/4 filters then the
    even-index subsample ``[..., ::2, ::2]``;
  * bilinear prolongation, columns then rows, as a plain interleave;
  * a coarse solve by the discrete-eigenvalue inverse symbol
    (``BatchedModalSolver``).

The reference's subsample and interleave are factored selector matmuls, a
TPU lane-layout device with exact values; the slices here give the same
values and, unlike the reference (``tpu_qg/ops/multigrid.py:100-127``), take
extents that are not multiples of 128 (a 192^2 solve works).

Kernel levels: ``MultigridSolver`` routes every level of extent >= 512
through K10/K11 (``ops/mg_kernels.py``) under ``use_pallas="on"``, under
``"auto"`` in float32 only (the kernels take float32; a float64 solve takes
the level-op chain, as the reference's "auto" does off its TPU), and none
under ``"off"`` (the level-op chain). The reference also
caps its kernels at the top 3 levels (``tpu_qg/ops/multigrid.py:287-296``):
on a TPU each kernel level cost a Mosaic compile. On the card a level's
cost is its launches, one kernel against the chain's dozens of ops, so the
port drops the cap (``_kernel_level``; 5 kernel levels at 8192^2). It keeps
the extent: with the kernels on every level, the 2048^2 MG path's psi on
an H100 moved 1.3e-5 of max|psi| from the level-op route's, above
``chip_smoke.py``'s 1e-5 gate, where two float32 routes that round their
coarse levels differently differ by the float32 floor of the inversion
(PERF.md).
A pre-smoother whose restricted halo exceeds the kernels' (nu1 + 2 > 8)
takes K10's residual form and the restriction op. The wrappers launch the
CUDA kernels on CUDA tensors (float32 only) and run their plain versions
on CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import mg_kernels
from .mg_kernels import interleave
from .spectral import BatchedModalSolver, _SymbolCache
from .stencils import roll_shift


# ---------------------------------------------------------------------------
# Shift-generic level ops


def apply_helmholtz(u: torch.Tensor, dx: float, alpha,
                    shift=roll_shift) -> torch.Tensor:
    """(lap_5p + alpha) u at spacing dx in difference form (sum of
    neighbour - centre); ``alpha`` is a scalar or a (K, 1, 1) tensor."""
    inv_dx2 = 1.0 / (dx * dx)
    c = shift(u, 0, 0)
    lap = (((shift(u, 1, 0) - c) + (shift(u, -1, 0) - c))
           + ((shift(u, 0, 1) - c) + (shift(u, 0, -1) - c))) * inv_dx2
    return lap + alpha * c


def jacobi_smooth(u: torch.Tensor, f: torch.Tensor, dx: float, alpha,
                  omega: float = 0.8, shift=roll_shift) -> torch.Tensor:
    """One damped-Jacobi sweep on (lap + alpha) u = f, in residual-correction
    form u' = u + omega (f - A u) / diag."""
    inv_dx2 = 1.0 / (dx * dx)
    diag = -4.0 * inv_dx2 + alpha
    c = shift(u, 0, 0)
    return c + omega * (f - apply_helmholtz(u, dx, alpha, shift)) / diag


def restrict_full_weighting(r: torch.Tensor,
                            shift=roll_shift) -> torch.Tensor:
    """Full-weighting restriction to the half-resolution grid (coarse (i, j)
    sits at fine (2i, 2j); periodic): the separable [1, 2, 1]/4 filters,
    rows then columns, then the even-index subsample. Any other shift takes
    the reference's 9-point form."""
    if shift is roll_shift:
        wx = 0.25 * (shift(r, 1, 0) + shift(r, -1, 0)) + 0.5 * r
        w = 0.25 * (shift(wx, 0, 1) + shift(wx, 0, -1)) + 0.5 * wx
        return w[..., ::2, ::2]
    w = (4.0 * shift(r, 0, 0)
         + 2.0 * (shift(r, 1, 0) + shift(r, -1, 0)
                  + shift(r, 0, 1) + shift(r, 0, -1))
         + shift(r, 1, 1) + shift(r, 1, -1)
         + shift(r, -1, 1) + shift(r, -1, -1)) * (1.0 / 16.0)
    return w[..., ::2, ::2]


def restrict_full_weighting_padded(r_pad: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction of a 1-halo-padded (..., m+2, p+2) block
    (the sharded form, ``tpu_qg/ops/multigrid.py:155-164``): the row filter
    over the whole padded column extent, so that the column filter sees its
    y-halo, then the column filter, then the even-index subsample."""
    cy = r_pad[..., 1:-1, :]
    wxy = 0.25 * (r_pad[..., 2:, :] + r_pad[..., :-2, :]) + 0.5 * cy
    w = 0.25 * (wxy[..., 2:] + wxy[..., :-2]) + 0.5 * wxy[..., 1:-1]
    return w[..., ::2, ::2]


def prolong_bilinear(uc: torch.Tensor, shift=roll_shift) -> torch.Tensor:
    """Bilinear prolongation to the double-resolution grid (the transpose of
    full weighting up to the standard factor): columns (centre, average
    with the right neighbour), then rows the same way. Any other shift takes
    the reference's four-point form."""
    if shift is roll_shift:
        right = shift(uc, 0, 1)
        wide = interleave(uc, 0.5 * (uc + right), -1)     # (..., mc, 2pc)
        down = shift(wide, 1, 0)                           # row i+1
        return interleave(wide, 0.5 * (wide + down), -2)
    ctr = shift(uc, 0, 0)
    up = shift(uc, 1, 0)
    right = shift(uc, 0, 1)
    diag = shift(uc, 1, 1)
    row_even = interleave(ctr, 0.5 * (ctr + right), -1)
    row_odd = interleave(0.5 * (ctr + up), 0.25 * (ctr + up + right + diag),
                          -1)
    return interleave(row_even, row_odd, -2)


# ---------------------------------------------------------------------------
# Coarse solve (spectral, discrete eigenvalues: small grids only)


def _coarse_spectral_solve(f: torch.Tensor, M: int, P: int, dx: float,
                           alphas: Sequence[float]) -> torch.Tensor:
    """Direct solve of (lap_5p + alpha_k) u_k = f_k on the (K, M, P) coarse
    grid by the inverse symbol (zero-mean gauge for alpha == 0): one rfft2,
    the symbol multiply and one irfft2, as the reference."""
    return BatchedModalSolver(M, P, dx, alphas)(f)


# ---------------------------------------------------------------------------
# Single-device V-cycle solver


class MultigridSolver:
    """Batched V-cycle solver for (lap_5p + alpha_k) u_k = f_k, k stacked on
    the leading axis (K, M, P): both QG modal solves (Poisson alpha = 0 and
    modified Helmholtz alpha = S_eig) ride one cycle.

    ``n_cycles`` V(nu1, nu2)-cycles from ``x0`` (or zero). ``use_pallas``
    ("auto", "on" or "off") routes the kernel levels (module docstring).
    """

    def __init__(self, M: int, P: int, dx: float, alphas: Sequence[float],
                 n_cycles: int = 8, nu1: int = 2, nu2: int = 2,
                 omega: float = 0.8, coarse_cutoff: int = 32,
                 use_pallas: str = "auto"):
        if use_pallas not in ("auto", "on", "off"):
            raise ValueError(f"use_pallas={use_pallas!r}")
        self.M, self.P, self.dx = M, P, dx
        self.alphas = tuple(float(a) for a in alphas)
        self.n_cycles, self.nu1, self.nu2 = n_cycles, nu1, nu2
        self.omega = omega
        self.use_pallas = use_pallas
        # Level l has spacing dx * 2^l and extents (M >> l, P >> l); coarsen
        # while both extents are even and above the cutoff.
        levels = []
        m, p, h = M, P, dx
        while m % 2 == 0 and p % 2 == 0 and min(m, p) > coarse_cutoff:
            levels.append((m, p, h))
            m, p, h = m // 2, p // 2, h * 2.0
        self.levels = levels            # fine -> next-to-coarsest
        self.coarse = (m, p, h)
        self._coarse_solve = BatchedModalSolver(m, p, h, self.alphas)
        self._alpha = _SymbolCache(lambda dtype, device: torch.tensor(
            self.alphas, dtype=dtype, device=device).reshape(-1, 1, 1))
        self._singular = _SymbolCache(lambda dtype, device: torch.tensor(
            [a == 0.0 for a in self.alphas], dtype=dtype,
            device=device).reshape(-1, 1, 1))

    # The port's kernel-level gate (module docstring): every level of
    # extent >= 512, with no cap on their number.
    _KERNEL_MIN_EXTENT = 512

    def _kernel_level(self, lvl: int,
                      dtype: torch.dtype = torch.float32) -> bool:
        """Whether level ``lvl`` runs K10/K11 on fields of ``dtype``: every
        level of extent >= 512, where the kernels' halo holds nu1 + 1 and
        nu2, under "on", and under "auto" only in float32 (the kernels take
        float32 alone; the reference's "auto" likewise keeps its kernels
        off where they cannot run, ``tpu_qg/ops/multigrid.py:299-304``);
        none under "off". A float64 solve under "on" reaches the kernels,
        which refuse it on a CUDA device."""
        m, p, _ = self.levels[lvl]
        return (self.use_pallas != "off"
                and (self.use_pallas == "on" or dtype == torch.float32)
                and min(m, p) >= self._KERNEL_MIN_EXTENT
                and max(self.nu1 + 1, self.nu2) <= mg_kernels.MG_MAX_HALO)

    def _smooth_block(self, lvl: int, u: torch.Tensor, f: torch.Tensor,
                      nu: int, residual: bool):
        """nu Jacobi sweeps (+ optional residual) at a level: one K10 launch
        on a kernel level, the level-op chain elsewhere."""
        _, _, h = self.levels[lvl]
        if self._kernel_level(lvl, u.dtype):
            return mg_kernels.mg_smooth(u, f, h, self.alphas, nu, residual,
                                        self.omega)
        a = self._alpha.get(u.dtype, u.device)
        for _ in range(nu):
            u = jacobi_smooth(u, f, h, a, self.omega)
        r = f - apply_helmholtz(u, h, a) if residual else None
        return u, r

    def _smooth_restrict(self, lvl: int, u: torch.Tensor, f: torch.Tensor):
        """Pre-smooth + residual + restriction: one K10 launch (restrict
        form) on a kernel level where the kernels' halo holds nu1 + 2."""
        _, _, h = self.levels[lvl]
        if (self._kernel_level(lvl, u.dtype)
                and self.nu1 + 2 <= mg_kernels.MG_MAX_HALO):
            return mg_kernels.mg_smooth(u, f, h, self.alphas, self.nu1, True,
                                        self.omega, restrict=True)
        u, r = self._smooth_block(lvl, u, f, self.nu1, True)
        return u, restrict_full_weighting(r)

    def _vcycle(self, lvl: int, u: torch.Tensor,
                f: torch.Tensor) -> torch.Tensor:
        if lvl == len(self.levels):
            return self._coarse_solve(f)
        u, rc = self._smooth_restrict(lvl, u, f)
        ec = self._vcycle(lvl + 1, torch.zeros_like(rc), rc)
        _, _, h = self.levels[lvl]
        if self._kernel_level(lvl, u.dtype):
            # Coarse correction + post-smooth in one K11 launch.
            return mg_kernels.mg_prolong_smooth(u, ec, f, h, self.alphas,
                                                self.nu2, self.omega)
        u = u + prolong_bilinear(ec)
        u, _ = self._smooth_block(lvl, u, f, self.nu2, False)
        return u

    def __call__(self, f: torch.Tensor,
                 x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Solve to ``n_cycles`` V-cycles; the zero-mean gauge applies to the
        singular (alpha == 0) components of both the right-hand side
        (compatibility) and the solution."""
        singular = self._singular.get(f.dtype, f.device)
        f = f - singular * torch.mean(f, dim=(-2, -1), keepdim=True)
        u = torch.zeros_like(f) if x0 is None else x0
        for _ in range(self.n_cycles):
            u = self._vcycle(0, u, f)
        return u - singular * torch.mean(u, dim=(-2, -1), keepdim=True)

    def residual_norm(self, u: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """RMS of f - A u per mode."""
        r = f - apply_helmholtz(u, self.dx, self._alpha.get(u.dtype, u.device))
        return torch.sqrt(torch.mean(r * r, dim=(-2, -1)))


class MultigridModalInverter:
    """Two-layer inversion zeta -> psi by multigrid: the modal projection
    P^-1, batched V-cycles on (Poisson, Helmholtz), the back-projection P.
    The same operator and zero-mean gauge as the spectral inverters
    (reference chain: src/model.jl:172-199).

    ``psi_prev`` (the previous step's psi) seeds the V-cycles with its modes
    P_back^-1 psi_prev: psi = P_back modes, so the seed inverts P_back, which
    differs from P_inv under the reference's back-projection quirk
    (``compat_reference_P``).
    """

    def __init__(self, M: int, P: int, dx: float, alpha2: float,
                 P_inv, P_back, n_cycles: int = 8, nu1: int = 2,
                 nu2: int = 2, use_pallas: str = "auto"):
        self.solver = MultigridSolver(M, P, dx, (0.0, float(alpha2)),
                                      n_cycles=n_cycles, nu1=nu1, nu2=nu2,
                                      use_pallas=use_pallas)
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

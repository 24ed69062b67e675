"""Spectral elliptic inversion with the *discrete* 5-point eigenvalues.

Counterpart of ``tpu_qg.ops.spectral`` on ``torch.fft``. The doubly-periodic
5-point Laplacian is diagonal in the DFT basis, so Poisson and
modified-Helmholtz solves are one rfft2, a pointwise multiply by the inverse
of the discrete eigenvalues

    lambda[k, l] = (2 cos(2 pi k / M) - 2 + 2 cos(2 pi l / P) - 2) / dx^2,

and one irfft2 (the reference's sparse Cholesky backsolves solve the same
matrix). Gauge: zero-mean by default (the (0, 0) mode is zeroed);
``gauge="pin"`` subtracts u[0, 0] to emulate the reference's pinned point.

``PackedModalInverterKernels`` runs the two-layer packed inversion on the
DFT kernels of ``ops/dft_kernels.py`` by the route ``tpu_qg``'s
``PackedModalInverterPallasFFT`` takes for the shape (``inversion_route``):
three passes (K2, K3, K2^-1) up to M = 2432, else four (K2, K4, K5, K2^-1),
with the symbol stage in torch ops between K4 and K4^-1 where the
reference's fused symbol kernel does not fit (4224 <= M <= 4480); or, with
``fft_mono="on"`` where the reference's one-launch inversion engages, one
launch of K16. The reference's shape gates of its one-launch forms
(``reference_mono``, ``reference_fullstep``, ``reference_yfused``) are
copied here.

``PackedModalInverterMXU`` runs the same inversion on the matmul-factorized
DFT of ``ops/matmul_fft.py`` (``fft_impl="matmul"``).

Symbol tables are built on the host once per solver and moved to a field's
device and dtype at first use there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from .dft_kernels import (mono_invert, pair_x_symbols, stream_pair_symbols,
                          x_dft, x_symbols_inverse, y_dft)
from .matmul_fft import (MatmulFFT2, freq_order, negate_spectrum,
                         split_factor)


@dataclasses.dataclass(frozen=True)
class RectangularDomain:
    """Domain bounding box (reference: src/schemes/laplacian.jl:6-11)."""

    x1: float
    x2: float
    y1: float
    y2: float


def periodic_laplacian_eigenvalues(M: int, P: int, dx: float) -> np.ndarray:
    """Eigenvalues of the doubly-periodic discrete 5-point Laplacian on the
    rfft2 grid: shape (M, P // 2 + 1)."""
    lam_x, lam_y = _eig_factors(M, P, dx)
    return lam_x[:, None] + lam_y[None, :]


def _eig_factors(M: int, P: int, dx: float):
    """1-D eigenvalue factors lam_x (M,), lam_y (P//2+1,) on the rfft grid."""
    k = np.arange(M)
    l = np.arange(P // 2 + 1)
    lam_x = (2.0 * np.cos(2.0 * np.pi * k / M) - 2.0) / (dx * dx)
    lam_y = (2.0 * np.cos(2.0 * np.pi * l / P) - 2.0) / (dx * dx)
    return lam_x, lam_y


def _inv_symbol_2d(lam_x, lam_y, alpha: float, dtype, device) -> torch.Tensor:
    """(M, P//2+1) inverse symbol 1/(lam + alpha), formed in ``dtype``; for
    the singular alpha == 0 case the (0, 0) entry is 0 (zero-mean gauge)."""
    lam = (torch.as_tensor(lam_x, dtype=dtype, device=device)[:, None]
           + torch.as_tensor(lam_y, dtype=dtype, device=device)[None, :]
           + torch.tensor(alpha, dtype=dtype, device=device))
    if alpha == 0.0:
        lam[0, 0] = 1.0
        inv = 1.0 / lam
        inv[0, 0] = 0.0
        return inv
    return 1.0 / lam


class _SymbolCache:
    """Per-(device, dtype) cache of a solver's symbol tensors."""

    def __init__(self, build):
        self._build = build
        self._cache = {}

    def get(self, dtype: torch.dtype, device: torch.device):
        key = (dtype, device)
        if key not in self._cache:
            self._cache[key] = self._build(dtype, device)
        return self._cache[key]


class HelmholtzSolver:
    """Cached inverse-symbol solver for (laplacian + alpha) u = f.
    ``alpha=0`` gives the (gauge-fixed) Poisson solve."""

    def __init__(self, M: int, P: int, dx: float, alpha: float,
                 gauge: str = "zero_mean"):
        self.M, self.P, self.dx, self.alpha = M, P, dx, alpha
        self.gauge = gauge
        self.lam_x, self.lam_y = _eig_factors(M, P, dx)
        self._inv = _SymbolCache(lambda dtype, device: _inv_symbol_2d(
            self.lam_x, self.lam_y, self.alpha, dtype, device))

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        """Solve (lap + alpha) u = f on an interior-only (..., M, P) tensor."""
        f_hat = torch.fft.rfft2(f, dim=(-2, -1))
        u_hat = f_hat * self._inv.get(f_hat.real.dtype, f.device)
        u = torch.fft.irfft2(u_hat, s=(self.M, self.P), dim=(-2, -1))
        u = u.to(f.dtype)
        if self.alpha == 0.0 and self.gauge == "pin":
            # Emulate the reference's pinned-point gauge (psi[0, 0] == 0).
            u = u - u[..., 0:1, 0:1]
        return u


class BatchedModalSolver:
    """K independent (lap + alpha_k) u_k = f_k solves in ONE rfft2/irfft2
    pair over a stacked (K, M, P) input."""

    def __init__(self, M: int, P: int, dx: float, alphas,
                 gauge: str = "zero_mean"):
        self.M, self.P = M, P
        self.gauge = gauge
        self.alphas = tuple(alphas)
        self.lam_x, self.lam_y = _eig_factors(M, P, dx)
        self._inv = _SymbolCache(lambda dtype, device: torch.stack([
            _inv_symbol_2d(self.lam_x, self.lam_y, a, dtype, device)
            for a in self.alphas]))

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        f_hat = torch.fft.rfft2(f, dim=(-2, -1))
        u_hat = f_hat * self._inv.get(f_hat.real.dtype, f.device)
        u = torch.fft.irfft2(u_hat, s=(self.M, self.P), dim=(-2, -1))
        u = u.to(f.dtype)
        if self.gauge == "pin":
            pins = [i for i, a in enumerate(self.alphas) if a == 0.0]
            if pins:
                u = u.clone()
                for i in pins:
                    u[i] = u[i] - u[i, 0, 0]
        return u


def packed_coefficients(P_inv, P_back) -> tuple[complex, ...]:
    """(a1, a2, b1, b2): A = a1 inv1 + a2 inv2 and B = b1 inv1 + b2 inv2
    (see PackedModalInverter)."""
    (q11, q12), (q21, q22) = P_inv
    (p11, p12), (p21, p22) = P_back
    u = p11 + 1j * p21
    v = p12 + 1j * p22
    return (complex(u * (q11 - 1j * q12) / 2.0),
            complex(v * (q21 - 1j * q22) / 2.0),
            complex(u * (q11 + 1j * q12) / 2.0),
            complex(v * (q21 + 1j * q22) / 2.0))


def symbol_consts(M: int, P: int, dx: float, alpha2: float, P_inv,
                  P_back) -> tuple:
    """The scalar constants from which K3, K5, K16 and K17 rebuild the packed
    symbols, built in float64 on the host (tpu_qg/ops/spectral.py:283-287):
    (n2x, n2y, 1/dx^2, alpha2, a1, a2, b1, b2)."""
    return (split_factor(M)[1], split_factor(P)[1], 1.0 / (dx * dx),
            float(alpha2), *packed_coefficients(P_inv, P_back))


class PackedModalInverter:
    """Full two-layer inversion (zeta -> psi) in ONE complex fft2/ifft2 pair.

    The modal projection P^-1, the Poisson and modified-Helmholtz solves and
    the back-projection P are linear, so with w = zeta_1 + i zeta_2 the
    whole chain is

        W  = fft2(w),  V = A(k) W + B(k) conj(W(-k)),  psi_1 + i psi_2 = ifft2(V)

    with A = u(q11 - i q12)/2 inv1 + v(q21 - i q22)/2 inv2 and
    B = u(q11 + i q12)/2 inv1 + v(q21 + i q22)/2 inv2, u = p11 + i p21,
    v = p12 + i p22 (derivation in tpu_qg/ops/spectral.py:138-169).
    Zero-mean gauge only (inv1[0, 0] = 0).
    """

    def __init__(self, M: int, P: int, dx: float, alpha2: float,
                 P_inv, P_back):
        self.M, self.P = M, P
        self.alpha2 = alpha2
        k = np.arange(M)
        l = np.arange(P)
        self.lam_x = (2.0 * np.cos(2.0 * np.pi * k / M) - 2.0) / (dx * dx)
        self.lam_y = (2.0 * np.cos(2.0 * np.pi * l / P) - 2.0) / (dx * dx)
        self.a1, self.a2, self.b1, self.b2 = packed_coefficients(P_inv,
                                                                 P_back)
        self._sym = _SymbolCache(self._symbols)

    def _symbols(self, real_dtype: torch.dtype, device: torch.device):
        cdtype = (torch.complex128 if real_dtype == torch.float64
                  else torch.complex64)
        lam = (torch.as_tensor(self.lam_x, dtype=real_dtype, device=device)[:, None]
               + torch.as_tensor(self.lam_y, dtype=real_dtype, device=device)[None, :])
        zero = lam == 0.0
        inv1 = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, lam))
        inv2 = 1.0 / (lam + torch.tensor(self.alpha2, dtype=real_dtype,
                                         device=device))

        def c(x):
            return torch.tensor(x, dtype=cdtype, device=device)

        A = c(self.a1) * inv1 + c(self.a2) * inv2
        B = c(self.b1) * inv1 + c(self.b2) * inv2
        return A, B

    def __call__(self, zeta: torch.Tensor) -> torch.Tensor:
        """(2, M, P) real zeta -> (2, M, P) real psi."""
        W = torch.fft.fft2(torch.complex(zeta[0], zeta[1]), dim=(-2, -1))
        A, B = self._sym.get(zeta.dtype, zeta.device)
        # conj(W(-k)): reverse both axes then roll by one (index 0 fixed).
        W_rev = torch.roll(torch.flip(torch.conj(W), dims=(-2, -1)), (1, 1),
                           dims=(-2, -1))
        v = torch.fft.ifft2(A * W + B * W_rev, dim=(-2, -1))
        return torch.stack([v.real, v.imag]).to(zeta.dtype)


class PackedModalInverterMXU(PackedModalInverter):
    """PackedModalInverter with the fft2/ifft2 pair replaced by the
    matmul-factorized DFT (``ops.matmul_fft``), the counterpart of
    ``tpu_qg``'s ``PackedModalInverterMXU`` (tpu_qg/ops/spectral.py:214-237):
    the transforms become batched GEMMs and twiddles, and the spectral order
    stays permuted end to end — the symbols A, B are evaluated at the
    permuted frequencies, and conj(W(-k)) is the permuted negation. Same
    math and gauge as the parent (``fft_impl="matmul"``)."""

    def __init__(self, M: int, P: int, dx: float, alpha2: float,
                 P_inv, P_back):
        super().__init__(M, P, dx, alpha2, P_inv, P_back)
        self._fft2 = MatmulFFT2(M, P)
        # Permute the 1-D eigenvalue factors into the transform's slot order.
        self.lam_x = self.lam_x[freq_order(M)]
        self.lam_y = self.lam_y[freq_order(P)]

    def __call__(self, zeta: torch.Tensor) -> torch.Tensor:
        """(2, M, P) real zeta -> (2, M, P) real psi."""
        W = self._fft2.forward(torch.complex(zeta[0], zeta[1]))
        A, B = self._sym.get(zeta.dtype, zeta.device)
        W_rev = torch.conj(self._fft2.negate_spectrum(W))
        v = self._fft2.inverse(A * W + B * W_rev)
        return torch.stack([v.real, v.imag]).to(zeta.dtype)


# The reference runs its DFT kernels where both extents are 128 * n with
# n <= 64 (pallas_fft.planar_fft2_fits). Its pair-x kernel fits a TPU core's
# VMEM only up to M = 2432 (pallas_fft.pair_x_fits), and its fused
# symbol + inverse-x kernel not for 4224 <= M <= 4480
# (pallas_fft.symbol_inverse_fits: the BlockSpec form runs out at 4224 and
# the streaming form takes over at 4608). Each bound depends on M alone.
_REF_MAX_N2 = 64
_REF_PAIR_X_MAX_M = 2432
_REF_UNFUSED_M = (4224, 4480)


def reference_dft_kernels(M: int, P: int) -> bool:
    """Shapes on which the reference runs its Pallas DFT kernels."""
    return all(n % 128 == 0 and 1 <= n // 128 <= _REF_MAX_N2 for n in (M, P))


def reference_pair_x(M: int, P: int) -> bool:
    """Shapes on which the reference's inversion takes the pair-x route."""
    return reference_dft_kernels(M, P) and M <= _REF_PAIR_X_MAX_M


def reference_symbol_inverse(M: int, P: int) -> bool:
    """Shapes on which the reference fuses the symbol stage into its
    inverse-x kernel."""
    lo, hi = _REF_UNFUSED_M
    return reference_dft_kernels(M, P) and not lo <= M <= hi


def inversion_route(M: int, P: int, pair_x: bool) -> str:
    """The reference's kernel route for the (M, P) packed inversion
    (tpu_qg/ops/spectral.py:263-266, 289-315): "pair-x" (K2, K3, K2^-1),
    "four-pass" (K2, K4, K5, K2^-1) or "four-pass-unfused" (K2, K4, torch
    symbol stage, K4^-1, K2^-1). ``pair_x=False`` is fft_pairx="off"."""
    if not reference_dft_kernels(M, P):
        raise ValueError(f"no kernel route for ({M}, {P}): each extent must "
                         "be 128 * n with n <= 64")
    if pair_x and reference_pair_x(M, P):
        return "pair-x"
    return ("four-pass" if reference_symbol_inverse(M, P)
            else "four-pass-unfused")


# The reference's shape gates of its one-launch forms, copied from its VMEM
# models (tpu_qg/ops/pallas_fft.py:61-134, 595-617, 1038-1046;
# pallas_fullstep.py:56-112; pallas_tendency.py:674-835). They size a TPU
# core's VMEM, not the card's shared memory: the port runs a form exactly
# where the reference does, and its kernels take every shape these admit.
_MIB = 1024 * 1024
_N1 = 128
_VMEM_TARGET = int(0.70 * 64 * _MIB)
_VMEM_TARGET_STREAM = int(0.70 * 96 * _MIB)
_VMEM_TARGET_FULL = int(0.80 * 112 * _MIB)
_VMEM_TARGET_YF = int(0.70 * 96 * _MIB)
_H = 8          # the reference step kernels' row halo


def _footprint(block_bytes: int, n2: int) -> int:
    return 8 * block_bytes + 4 * n2 * _N1 * _N1 * 4


def _x_blockspec_fits(M: int) -> bool:
    return _footprint(8 * M * _N1, M // _N1) <= _VMEM_TARGET


def _pick_rows(M: int, P: int) -> int:
    r = 8
    for cand in range(8, min(M, 256) + 1, 8):
        if M % cand == 0 and _footprint(8 * cand * P, P // _N1) <= _VMEM_TARGET:
            r = cand
    return r


def reference_mono(M: int, P: int) -> bool:
    """The reference's mono_fits: shapes on which its one-launch inversion
    fits (it engages where its fused symbol stage fits too)."""
    if not (reference_dft_kernels(M, P) and _x_blockspec_fits(M)):
        return False
    field = 2 * M * P * 4
    g_ops = 2 * ((M // _N1) + (P // _N1)) * 2 * _N1 * _N1 * 4
    strip = 2 * M * _N1 * 4
    ytile = 8 * _pick_rows(M, P) * P * 4
    return field + g_ops + max(8 * strip, ytile) <= _VMEM_TARGET_STREAM


def _footprint_full(M: int, P: int, T: int) -> int:
    field = 2 * M * P * 4
    in_bufs = 2 * 2 * (2 * (T + 2 * _H) + 2 * T) * P * 4
    out_bufs = 2 * 2 * 2 * T * P * 4
    g = 2 * 2 * ((M // _N1) + (P // _N1)) * _N1 * _N1 * 4
    strip = 2 * M * _N1 * 4
    ylive = 8 * max(_pick_rows(M, P), T) * P * 4
    stencil_tmp = 16 * T * P * 4
    return (field + in_bufs + out_bufs + g + max(8 * strip, ylive)
            + stencil_tmp)


def _pick_tile_full(M: int, P: int) -> int:
    T = M // 2
    while T > 8:
        if _footprint_full(M, P, T) <= _VMEM_TARGET_FULL and M % T == 0:
            return T
        T //= 2
    return T


def reference_fullstep(M: int, P: int) -> bool:
    """The reference's fullstep_fits: shapes of its one-launch step."""
    if not reference_dft_kernels(M, P) or P % _N1 != 0 or M % 8 != 0:
        return False
    T = _pick_tile_full(M, P)
    return (T >= 8 and M // T >= 2
            and _footprint_full(M, P, T) <= _VMEM_TARGET_FULL)


def _pick_tile_yfused(M: int, P: int) -> int:
    budget = _VMEM_TARGET_YF - 4 * (P // _N1) * _N1 * _N1 * 4
    T = M
    while T > 8:
        rows = (2 * (4 * (T + 2 * _H) + 4 * T + 6 * T)
                + 16 * T + 8 * (T + 2 * _H) + 8 * T)
        if P * 4 * rows <= budget and M % T == 0 and M // T >= 2:
            return T
        T //= 2
    return T


def reference_yfused(M: int, P: int) -> bool:
    """The reference's yfused_supported for two float32 layers: shapes of
    its y-fused step kernel."""
    if P % _N1 != 0 or M % 8 != 0 or not 1 <= P // _N1 <= 64:
        return False
    T = _pick_tile_yfused(M, P)
    return T >= 8 and M // T >= 2


# The reference's gates of its sharded kernels (the sharded step kernels,
# tpu_qg/ops/pallas_tendency.py:541-553, 600-605, 902-909; the x-stage
# kernels, tpu_qg/ops/pallas_fft.py:95-134, 796-817). As above, they size a
# TPU core's VMEM: the sharded stepper (tpu_qg_torch.parallel) copies them
# to choose the reference's route, and the port's kernels take every shape
# they admit.
_VMEM_BUDGET_STEP = int(0.70 * 64 * _MIB)
_VMEM_TARGET_STREAM_PAIR = int(0.80 * 124 * _MIB)


def _stream_x_footprint(M: int) -> int:
    strip = 2 * M * _N1 * 4
    return 7 * strip + 2 * (M // _N1) * _N1 * _N1 * 4


def reference_planar_fft2(M: int, P: int) -> bool:
    """The reference's planar_fft2_fits: its DFT kernels take both extents,
    the y-kernel at its smallest row tile and the x-kernel in its BlockSpec
    or streaming form."""
    return (reference_dft_kernels(M, P)
            and _footprint(8 * 8 * P, P // _N1) <= _VMEM_TARGET
            and (_x_blockspec_fits(M)
                 or _stream_x_footprint(M) <= _VMEM_TARGET_STREAM))


def reference_symbol_inverse_fits(M: int) -> bool:
    """The reference's symbol_inverse_fits (its fused symbol + inverse-x
    kernel, BlockSpec or streaming)."""
    if _x_blockspec_fits(M):
        return (18 * M * _N1 * 4 + 4 * (M // _N1) * _N1 * _N1 * 4
                <= _VMEM_TARGET)
    return _stream_x_footprint(M) <= _VMEM_TARGET_STREAM


def reference_x_blockspec(M: int) -> bool:
    """The reference's _x_blockspec_fits: (2, M, 128) x-blocks fit its
    BlockSpec pipeline (else its x-kernels stream, M >= 4608)."""
    return _x_blockspec_fits(M)


def reference_stream_pair(M: int) -> bool:
    """The reference's streaming pair x-kernel (K7, K13's streaming form)
    fits: stream_pair_x_footprint(M) within its budget."""
    strip = 2 * M * _N1 * 4
    g = 2 * 2 * (M // _N1) * _N1 * _N1 * 4
    return 7 * strip + g <= _VMEM_TARGET_STREAM_PAIR


def _pick_tile_step(m: int, P: int, L: int) -> int:
    T = m
    while T > 8:
        foot = P * 4 * (L * (4 * (T + 2 * _H) + 4 * T + 4 * T) + 16 * T)
        if foot <= _VMEM_BUDGET_STEP and m % T == 0:
            return T
        T //= 2
    return T


def reference_sharded_step(L: int, m: int, P: int, itemsize: int) -> bool:
    """The reference's sharded_pallas_supported: its sharded step kernel
    (K12) takes an (L, m, P) row block."""
    return (P % 128 == 0 and m % 8 == 0 and itemsize == 4
            and _pick_tile_step(m, P, L) >= 8)


def reference_sharded_yfused(L: int, m: int, P: int, itemsize: int) -> bool:
    """The reference's sharded_yfused_supported: its sharded y-fused step
    kernel (K15's sharded form) takes an (L, m, P) row block."""
    return (L == 2 and itemsize == 4 and P % 128 == 0 and m % 8 == 0
            and 1 <= P // _N1 <= _REF_MAX_N2
            and _pick_tile_yfused(m, P) >= 8)


def fft2_forward(z: torch.Tensor) -> torch.Tensor:
    """Planar (2, M, P) natural order -> planar spectrum, permuted on both
    axes: K2 then K4 (PlanarFFT2.forward)."""
    return x_dft(y_dft(z, False), False)


def fft2_inverse(Z: torch.Tensor) -> torch.Tensor:
    """Planar spectrum, permuted on both axes -> natural order, scaled
    1/(M P): K4^-1 then K2^-1 (PlanarFFT2.inverse)."""
    return y_dft(x_dft(Z, True), True)


class PackedModalInverterKernels(PackedModalInverter):
    """The packed inversion as kernel passes on a planar field, by the route
    chosen once here: the counterpart of ``tpu_qg``'s
    ``PackedModalInverterPallasFFT`` (tpu_qg/ops/spectral.py:240-315). The
    packed (zeta_1, zeta_2) stack IS the planar field, so no complex dtype
    appears on the kernel routes. On CPU tensors the kernels' plain versions
    run in the same structure.

    ``route`` is "mono" (K16, one launch) where ``mono`` is asked for and
    the reference's one-launch inversion engages (its fused symbol stage
    and ``reference_mono``), else ``x_route = inversion_route(M, P,
    pair_x)``. ``x_stage`` runs the x-stage of ``x_route`` alone: the
    y-fused chain's step takes it, never the mono form.

    As in the reference's matmul-DFT parent, the symbols of the unfused
    route's torch symbol stage are evaluated at the permuted frequencies.

    ``pair_stream`` (off, as the reference's ``_pair_stream``,
    tpu_qg/ops/spectral.py:276) pins the inversion to K2, K7, K2^-1 on any
    route but the one-launch one: the reference keeps that kernel for the
    sharded x-stage and its tests force it on one device."""

    def __init__(self, M: int, P: int, dx: float, alpha2: float,
                 P_inv, P_back, pair_x: bool = True, mono: bool = False):
        super().__init__(M, P, dx, alpha2, P_inv, P_back)
        self.x_route = inversion_route(M, P, pair_x)
        self.route = ("mono" if mono and reference_symbol_inverse(M, P)
                      and reference_mono(M, P) else self.x_route)
        self.lam_x = self.lam_x[freq_order(M)]
        self.lam_y = self.lam_y[freq_order(P)]
        self._sym_consts = symbol_consts(M, P, dx, alpha2, P_inv, P_back)
        self.pair_stream = False

    def __call__(self, zeta: torch.Tensor) -> torch.Tensor:
        if self.route == "mono":
            return mono_invert(zeta, self._sym_consts)
        if self.pair_stream:
            return y_dft(stream_pair_symbols(y_dft(zeta, False),
                                             self._sym_consts), True)
        if self.route == "four-pass-unfused":
            return fft2_inverse(self._symbol_stage(fft2_forward(zeta)))
        return y_dft(self.x_stage(y_dft(zeta, False)), True)

    def x_stage(self, Zy: torch.Tensor) -> torch.Tensor:
        """A y-spectrum's inversion up to its final inverse-y: K3 on the
        pair-x route, K4 then K5 on the four-pass one."""
        if self.x_route == "pair-x":
            return pair_x_symbols(Zy, self._sym_consts)
        if self.x_route == "four-pass":
            return x_symbols_inverse(x_dft(Zy, False), self._sym_consts)
        raise ValueError("the unfused four-pass route has no fused x-stage")

    def _symbol_stage(self, W: torch.Tensor) -> torch.Tensor:
        """V = A W + B conj(W(-k)) expanded on the planes of a spectrum in
        permuted order, in torch ops (tpu_qg/ops/spectral.py:307-313)."""
        A, B = self._sym.get(W.dtype, W.device)
        Wn = negate_spectrum(negate_spectrum(W, 1), 2)     # W(-k), per plane
        Wr, Wi, Wr2, Wi2 = W[0], W[1], Wn[0], Wn[1]
        Vr = A.real * Wr - A.imag * Wi + B.real * Wr2 + B.imag * Wi2
        Vi = A.imag * Wr + A.real * Wi + B.imag * Wr2 - B.real * Wi2
        return torch.stack([Vr, Vi])


def solve_helmholtz(f: torch.Tensor, dx: float, alpha: float) -> torch.Tensor:
    """One-shot modified-Helmholtz solve (lap + alpha) u = f, doubly periodic
    (reference: src/schemes/laplacian.jl:78-86)."""
    M, P = f.shape[-2], f.shape[-1]
    return HelmholtzSolver(M, P, float(dx), float(alpha))(f)


def solve_poisson(f: torch.Tensor, dx: float,
                  gauge: str = "zero_mean") -> torch.Tensor:
    """One-shot Poisson solve lap u = f, doubly periodic
    (reference: src/schemes/laplacian.jl:100-111)."""
    M, P = f.shape[-2], f.shape[-1]
    return HelmholtzSolver(M, P, float(dx), 0.0, gauge=gauge)(f)


def solve_helmholtz_fn(M: int, P: int, dx: float,
                       f_rhs: Callable[[float, float], float], alpha: float,
                       domain: RectangularDomain,
                       device: torch.device | str = "cuda") -> torch.Tensor:
    """Function-RHS modified-Helmholtz solve: sample f(x, y) at the periodic
    interior points x_i = x1 + i*dx, y_j = y1 + j*dx, then solve on
    ``device`` (the GPU unless the CPU is asked for) (reference:
    src/schemes/laplacian.jl:89-98)."""
    device = resolve_device(device)
    xs = domain.x1 + dx * np.arange(M)
    ys = domain.y1 + dx * np.arange(P)
    b = np.asarray([[f_rhs(x, y) for y in ys] for x in xs])
    return solve_helmholtz(torch.as_tensor(b, device=device), dx, alpha)

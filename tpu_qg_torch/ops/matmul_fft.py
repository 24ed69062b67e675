"""Matmul-factorized DFT, and the permuted spectral order it shares with the
DFT kernels.

Counterpart of ``tpu_qg.ops.matmul_fft`` on ``torch.matmul``. A radix-(N1,
N2) Cooley-Tukey factorization N = N1 * N2 (N1 the largest divisor <= 128,
decimation n = n1 + N1*n2) expresses the N-point DFT as two batched small
matrix products plus a twiddle multiply:

    X[k2 + N2 k1] = sum_{n1} W_N^{n1 k2} W_{N1}^{n1 k1}
                    [ sum_{n2} x[n1 + N1 n2] W_{N2}^{n2 k2} ]

The output stays in PERMUTED order — slot j = k2*N1 + k1 holds frequency
k2 + N2*k1 (``freq_order``) — so no digit-reversal pass is ever paid: the
inverse consumes the same order and the symbols are evaluated at the
permuted frequencies. The y-DFT kernel (K2) writes this order too, and the
mirror-pair x-kernel (K3) reads and writes it.

Layout: the transformed axis reshapes to (n2, n1) in place. Contracting n2
is one batched GEMM of the stationary (N2, N2) matrix against each
contiguous (N2, N1 [* P]) slab (a stride-0 batch, no copy); contracting n1
along the last axis folds every row into one GEMM, and along axis -2 is a
batched GEMM over the (N1, P) slabs. No operand is transposed
(``tpu_qg``'s docstring records that an einsum/moveaxis form spent 3.6x the
FFT's time in relayouts).

The constants are built in complex64, as the reference builds them
(``MatmulFFT2``'s default dtype, even for a float64 field, where its einsum
promotes), and cast to the input's complex dtype once per (dtype, device).
The products run at full float32 whatever the process sets for TF32
(``torch.backends.cuda.matmul.allow_tf32``,
``torch.set_float32_matmul_precision`` or the cuda matmul
``fp32_precision``): the reference's ``TPU_QG_MXU_PREC`` bf16x3 mode is not
ported.

``fft_impl="matmul"`` runs this tier (``spectral.PackedModalInverterMXU``);
its products are library GEMMs, as the reference's are XLA einsums outside
any Pallas kernel.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


def split_factor(N: int) -> tuple[int, int]:
    """N = N1 * N2 with N1 the largest divisor <= 128."""
    best = 1
    for f in range(1, min(128, N) + 1):
        if N % f == 0:
            best = f
    return best, N // best


def freq_order(N: int) -> np.ndarray:
    """freq_order(N)[j] = the frequency held in permuted slot j = k2*N1 + k1."""
    N1, N2 = split_factor(N)
    k2 = np.arange(N2)[:, None]
    k1 = np.arange(N1)[None, :]
    return (k2 + N2 * k1).reshape(N1 * N2)


def _dft(N: int, sign: int, dtype) -> np.ndarray:
    k = np.arange(N)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / N).astype(dtype)


def _twiddle(N2: int, N1: int, sign: int, dtype) -> np.ndarray:
    """tw[k2, n1] = W_N^{sign * n1 k2}, N = N1 * N2."""
    k2 = np.arange(N2)[:, None]
    n1 = np.arange(N1)[None, :]
    return np.exp(sign * 2j * np.pi * k2 * n1 / (N1 * N2)).astype(dtype)


def negate_index(N: int) -> np.ndarray:
    """negate_index(N)[j] = the permuted slot holding frequency -f(j) mod N,
    where f(j) = freq_order(N)[j]. An involution; its fixed points hold the
    frequencies 0 and N/2."""
    order = freq_order(N)
    slot_of = np.empty(N, dtype=np.int64)
    slot_of[order] = np.arange(N)
    return slot_of[(-order) % N]


def negate_spectrum(X: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """X(k) -> X(-k mod N) along ``dim`` in the permuted order: the same map
    as ``tpu_qg.ops.matmul_fft.FactoredFFT.negate_spectrum`` (structured
    flips on the (k2, k1) view), taken here as one gather."""
    N = X.shape[dim]
    idx = torch.as_tensor(negate_index(N), device=X.device)
    return torch.index_select(X, dim, idx)


@contextlib.contextmanager
def full_float32_matmul():
    """Run the enclosed products at full float32 precision (no TF32 in
    cuBLAS), then restore the process's setting, through whichever of
    torch's two TF32 interfaces the process uses (reading the legacy flag
    raises once the per-backend ``fp32_precision`` has been set)."""
    flags = torch.backends.cuda.matmul
    try:
        legacy = flags.allow_tf32
    except RuntimeError:
        prev = flags.fp32_precision
        flags.fp32_precision = "ieee"
        try:
            yield
        finally:
            flags.fp32_precision = prev
        return
    if not legacy:
        yield
        return
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = True


def _complex_of(x: torch.Tensor) -> torch.Tensor:
    """``x`` as complex (a real field is promoted, as the einsum does)."""
    if x.is_complex():
        return x
    return x.to(torch.complex128 if x.dtype == torch.float64
                else torch.complex64)


class FactoredFFT:
    """Forward/inverse N-point DFT along the last or second-to-last dim,
    permuted spectral order (slot k2*N1 + k1 holds frequency k2 + N2*k1).

    forward: natural-order samples -> permuted-order spectrum (sign -1).
    inverse: permuted-order spectrum -> natural-order samples (sign +1, 1/N).
    """

    def __init__(self, N: int, dtype=np.complex64):
        self.N = N
        self.N1, self.N2 = split_factor(N)
        self._host = {
            "F1f": _dft(self.N1, -1, dtype),               # (k1, n1)
            "F2f": _dft(self.N2, -1, dtype),               # (k2, n2)
            "twf": _twiddle(self.N2, self.N1, -1, dtype),  # (k2, n1)
            "F1i": _dft(self.N1, +1, dtype) / self.N1,     # (n1, k1)
            "F2i": _dft(self.N2, +1, dtype) / self.N2,     # (n2, k2)
            "twi": _twiddle(self.N2, self.N1, +1, dtype),  # (k2, n1)
        }
        self._consts = {}
        self._negate = {}

    def _get(self, x: torch.Tensor) -> dict:
        """The constants in ``x``'s complex dtype on its device."""
        key = (x.dtype, x.device)
        if key not in self._consts:
            self._consts[key] = {
                k: torch.as_tensor(v).to(device=x.device, dtype=x.dtype)
                for k, v in self._host.items()}
        return self._consts[key]

    def _split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Dim ``dim`` of length N -> (N2, N1) at (dim, dim+1)."""
        shape = list(x.shape)
        shape[dim:dim + 1] = [self.N2, self.N1]
        return x.reshape(shape)

    def _merge(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(y.shape)
        shape[dim:dim + 2] = [self.N]
        return y.reshape(shape)

    def _dim(self, x: torch.Tensor, dim: int) -> int:
        dim = dim % x.ndim
        if dim not in (x.ndim - 1, x.ndim - 2):
            raise ValueError("dim must be -1 or -2")
        return dim

    def forward(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """``x`` natural order along ``dim`` (-1 or -2) -> permuted
        spectrum."""
        x = _complex_of(x).contiguous()
        dim = self._dim(x, dim)
        c = self._get(x)
        y = self._split(x, dim)                          # (..., n2, n1[, P])
        with full_float32_matmul():
            if dim == x.ndim - 1:
                y = torch.matmul(c["F2f"], y)                # (..., k2, n1)
                y = torch.matmul(y * c["twf"], c["F1f"].mT)  # (..., k2, k1)
            else:
                P = y.shape[-1]
                y = torch.matmul(c["F2f"], y.reshape(
                    *y.shape[:-3], self.N2, self.N1 * P))    # (..., k2, n1 P)
                y = y.reshape(*y.shape[:-1], self.N1, P) * c["twf"][..., None]
                y = torch.matmul(c["F1f"], y)                # (..., k2, k1, P)
        return self._merge(y, dim)

    def inverse(self, X: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Permuted-order spectrum along ``dim`` (-1 or -2) -> natural
        order."""
        X = _complex_of(X).contiguous()
        dim = self._dim(X, dim)
        c = self._get(X)
        y = self._split(X, dim)                          # (..., k2, k1[, P])
        with full_float32_matmul():
            if dim == X.ndim - 1:
                y = torch.matmul(y, c["F1i"].mT) * c["twi"]  # (..., k2, n1)
                y = torch.matmul(c["F2i"], y)                # (..., n2, n1)
            else:
                P = y.shape[-1]
                y = torch.matmul(c["F1i"], y)                # (..., k2, n1, P)
                y = y * c["twi"][..., None]
                y = torch.matmul(c["F2i"], y.reshape(
                    *y.shape[:-3], self.N2, self.N1 * P))    # (..., n2, n1 P)
                y = y.reshape(*y.shape[:-1], self.N1, P)
        return self._merge(y, dim)

    def negate_spectrum(self, X: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """X(k) -> X(-k mod N) in the permuted order along ``dim`` (-1 or
        -2): one gather (``negate_index``, kept on each device), the same
        values as the reference's structured flips."""
        dim = self._dim(X, dim)
        if X.device not in self._negate:
            self._negate[X.device] = torch.as_tensor(negate_index(self.N),
                                                     device=X.device)
        return torch.index_select(X, dim, self._negate[X.device])


class MatmulFFT2:
    """2-D DFT over the last two dims with permuted spectral order on both."""

    def __init__(self, M: int, P: int, dtype=np.complex64):
        self.fx = FactoredFFT(M, dtype)
        self.fy = FactoredFFT(P, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fx.forward(self.fy.forward(x, dim=-1), dim=-2)

    def inverse(self, X: torch.Tensor) -> torch.Tensor:
        return self.fx.inverse(self.fy.inverse(X, dim=-1), dim=-2)

    def negate_spectrum(self, X: torch.Tensor) -> torch.Tensor:
        return self.fx.negate_spectrum(
            self.fy.negate_spectrum(X, dim=-1), dim=-2)


@functools.lru_cache(maxsize=None)
def _cached_fft2(M: int, P: int) -> MatmulFFT2:
    return MatmulFFT2(M, P)

"""K2 (the y-DFT), K3 (the mirror-pair x-kernel), K4 (the x-DFT) and K5
(symbols + inverse x-DFT) of the packed inversion, K16 (the whole
inversion in one launch), and the x-stages of the sharded inversions: K13
(a column block and its mirror companion at a global strip offset), K7
(K13's self-mirror instance on the whole field) and K14 (local mirror-pair
groups).

Replace ``tpu_qg/ops/pallas_fft.py`` ``PlanarFFT2._call_y``,
``PlanarFFT2.pair_x_symbols``, ``PlanarFFT2._call_x`` and
``PlanarFFT2._call_x_symbols`` — and the streaming ``_call_x_stream``, which
computes what the last two compute where a TPU core's VMEM runs short — with
hand-written CUDA kernels, ``csrc/dft_kernels.cu`` (design and bounds in its
comments: all are bandwidth-bound passes that keep each transform in shared
memory). ``PlanarFFT2.mono_invert`` becomes the cooperative kernel K16:
K2, K3 and K2^-1 as stages of one launch, the persistent kernel of
``csrc/coop_rows.cuh`` (``mono_invert_rows``) where K2's factored and K3's
cluster kernels take the shape, its first form of ``csrc/fused_kernels.cu``
(``mono_invert_coop``) on the rest.
``PlanarFFT2._call_x_fwd_symbols_offset`` (K13), ``stream_pair_symbols``
(K7) and ``tpu_qg.parallel.paired``'s ``_call_paired_kernel`` (K14) compute
K3's function on local columns: on power-of-two extents K13 and K14 run
K3's cluster design on a block (``pair_cols_cluster_kernel``) and K7 runs
K3's cluster kernel itself; elsewhere all three run ``pair_cols_kernel``,
K3's whole-column task, on task tables built here.

The y-spectrum is cut into 128-slot strips (``STRIP``): slot j * 128 + l
holds frequency j + (P/128) l, so the mirror (negated frequency) of strip j
is strip (P/128 - j) mod P/128, lane by lane through ``mirror_lanes``.

Fields are planar: ``(2, rows, N)`` float, plane 0 = real, plane 1 = imag.
Spectra are in the permuted order of ``matmul_fft.freq_order``: the
y-spectrum everywhere, the x-spectrum between K4 and K5.

Each wrapper launches its kernel for CUDA tensors and uses its ``*_plain``
version only for CPU tensors. The plain versions are ``torch.fft`` along one
axis plus ``freq_order``/``negate_index`` indexing, with the symbols built
in float64 and cast, and return exactly the permuted-order arrays the JAX
kernels return.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .matmul_fft import freq_order, negate_index, split_factor

# Each extent is N = R * m, R a power of two >= 2 and m odd (radix_split);
# the kernels join m radix-2 sub-transforms with an m-point DFT, so m is
# bounded (the reference's extents are 128 * n with n <= 64, so m <= 63).
# Whatever a kernel holds in shared memory must fit one block's limit.
MAX_ODD = 63
SMEM_LIMIT = 227 * 1024          # bytes of dynamic shared memory per block
SM_SMEM = 228 * 1024             # bytes of shared memory per SM
SMEM_RESERVED = 1024             # bytes the runtime reserves per block
_PAIR_X_SMEM_TARGET = 160 * 1024  # K3 takes the most columns that fit this


def radix_split(N: int) -> tuple[int, int]:
    """N = R * m with R the largest power-of-two divisor, m odd."""
    R = N & -N
    return R, N // R


def _pad(n: int) -> int:
    """Padded length of n shared-memory slots (csrc pad())."""
    return n + n // 32


def _radix_ok(N: int) -> bool:
    R, m = radix_split(N)
    return R >= 2 and m <= MAX_ODD


def y_dft_smem(P: int) -> int:
    """Bytes of shared memory K2 takes per row (csrc qg_y_dft_launch)."""
    R, m = radix_split(P)
    return 4 * (2 * m * _pad(R) + R + (2 * _pad(P) if m > 1 else 0))


def y_dft_threads(P: int) -> int:
    """K2's block size: ~one 16-value group a thread, at most 128 (which
    with 128 registers a thread lets four blocks share an SM); 256 where a
    row's shared memory leaves room for fewer than four blocks an SM, so
    that an SM still holds ~512 threads (P = 8192: 1.28 ms against 1.81 ms
    a forward pass on an H100, PERF.md)."""
    if 4 * (y_dft_smem(P) + SMEM_RESERVED) > SM_SMEM:
        return 256
    return min(128, max(32, P // 16))


def kernels_take(M: int, P: int) -> bool:
    """True iff K2 and K3 take an (M, P) field: each extent R * m with
    m <= MAX_ODD, and K2's row and K3's two columns fit in shared memory."""
    return (_radix_ok(M) and _radix_ok(P) and y_dft_smem(P) <= SMEM_LIMIT
            and pair_x_layout(M)[3] <= SMEM_LIMIT)


def x_kernels_take(M: int, P: int) -> bool:
    """True iff K2, K4 (both directions) and K5 take an (M, P) field: the
    kernels of the four-pass inversion."""
    return (_radix_ok(M) and _radix_ok(P) and y_dft_smem(P) <= SMEM_LIMIT
            and max(x_dft_layout(M, False)[3], x_dft_layout(M, True)[3],
                    x_symbols_layout(M)[3]) <= SMEM_LIMIT)


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def y_dft_plain(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Planar (2, rows, P): forward natural -> permuted spectrum; inverse
    permuted -> natural, scaled 1/P."""
    P = z.shape[-1]
    order = _index(freq_order, P, z.device)
    c = torch.complex(z[0], z[1])
    if not inverse:
        out = torch.fft.fft(c, dim=-1)[..., order]
    else:
        natural = torch.empty_like(c)
        natural[..., order] = c
        out = torch.fft.ifft(natural, dim=-1)
    return torch.stack([out.real, out.imag]).to(z.dtype)


def y_dft_factored_plain(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """y_dft_plain's function in the factored form K2's factored kernel
    computes (csrc y_dft_factored_kernel; x_dft_plain's with the axes
    swapped): P = N1 N2 (split_factor), y = N1 n2 + n1, row (n2, n1).
    Forward: the N2-point DFT along n2, times W_P^(n1 k2), then the N1-point
    DFT along n1, whose (k2, k1) entries are the permuted slots k2 N1 + k1
    (no index array). Inverse: the inverse N1-point DFT along k1, times
    conj(W_P^(n1 k2)), then the inverse N2-point DFT along k2, scaled 1/P."""
    _, rows, P = z.shape
    N1, N2 = split_factor(P)
    c = torch.complex(z[0], z[1]).reshape(rows, N2, N1)
    tw = _stage_twiddle(P, z.dtype, z.device)[..., 0]          # (N2, N1)
    if not inverse:
        out = torch.fft.fft(torch.fft.fft(c, dim=1) * tw, dim=2)
    else:
        y = torch.fft.ifft(c, dim=2, norm="forward") * tw.conj()
        out = torch.fft.ifft(y, dim=1, norm="forward") / P
    return _planar(out.reshape(rows, P), z.dtype)


@functools.lru_cache(maxsize=16)
def _index(fn, N: int, device: torch.device) -> torch.Tensor:
    """An index map of ``matmul_fft`` (freq_order, negate_index) on device."""
    return torch.as_tensor(fn(N), device=device)


@functools.lru_cache(maxsize=2)
def _symbols(M: int, P: int, consts, x_permuted: bool, dtype: torch.dtype,
             device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed-inversion symbols A, B on the (natural or permuted x,
    permuted y) grid, in the cancellation-free eigenvalue form
    lambda = -4/dx^2 (sin^2(pi kx/M) + sin^2(pi ky/P)): the 1-D factors in
    float64 numpy, the (M, P) tables in float64 on ``device``, then cast to
    the complex type of ``dtype``."""
    fx = freq_order(M) if x_permuted else np.arange(M)
    return _symbol_tables(M, P, consts, fx, freq_order(P), dtype, device)


@functools.lru_cache(maxsize=2)
def _strip_symbols(M: int, P: int, consts, strips: tuple, dtype: torch.dtype,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``_symbols`` (natural x) on the columns of the given global y strips,
    in that order: the symbols of a sharded block."""
    slots = (STRIP * np.asarray(strips)[:, None]
             + np.arange(STRIP)[None, :]).reshape(-1)
    return _symbol_tables(M, P, consts, np.arange(M), freq_order(P)[slots],
                          dtype, device)


def _symbol_tables(M: int, P: int, consts, fx, fy, dtype: torch.dtype,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A, B at x-frequencies ``fx`` and y-frequencies ``fy``."""
    _, _, inv_dx2, alpha2, a1, a2, b1, b2 = consts

    def on_device(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    sx2 = on_device(np.sin(np.pi * np.minimum(fx, M - fx) / M) ** 2)
    sy2 = on_device(np.sin(np.pi * np.minimum(fy, P - fy) / P) ** 2)
    lam = (-4.0 * inv_dx2) * (sx2[:, None] + sy2[None, :])
    is_zero = (on_device(fx)[:, None] + on_device(fy)[None, :]) == 0
    inv1 = torch.where(is_zero, 0.0, 1.0 / torch.where(is_zero, 1.0, lam))
    inv2 = 1.0 / (lam + alpha2)
    cdtype = _complex_dtype(dtype)

    def table(c1: complex, c2: complex) -> torch.Tensor:
        return torch.complex(c1.real * inv1 + c2.real * inv2,
                             c1.imag * inv1 + c2.imag * inv2).to(cdtype)

    return table(a1, a2), table(b1, b2)


def _negate_natural(N: int) -> np.ndarray:
    """Index of frequency -k mod N in natural order."""
    return (-np.arange(N)) % N


def pair_x_symbols_plain(Zy: torch.Tensor, consts) -> torch.Tensor:
    """y-spectral planar field -> ifft_x(A W + B conj(W(-k))), W = fft_x(Zy).
    ``consts`` = (n2x, n2y, inv_dx2, alpha2, a1, a2, b1, b2) as built by
    spectral.PackedModalInverterKernels."""
    _, M, P = Zy.shape
    A, B = _symbols(M, P, consts, False, Zy.dtype, Zy.device)
    W = torch.fft.fft(torch.complex(Zy[0], Zy[1]), dim=0)
    neg_x = _index(_negate_natural, M, Zy.device)
    neg_y = _index(negate_index, P, Zy.device)
    Wn = W[neg_x][:, neg_y]
    v = torch.fft.ifft(A * W + B * torch.conj(Wn), dim=0)
    return torch.stack([v.real, v.imag]).to(Zy.dtype)


STRIP = 128      # slots of a y strip (the TPU kernels' lane width)


def mirror_lanes(strip: int) -> np.ndarray:
    """Lane l of strip ``strip`` mirrors lane mirror_lanes(strip)[l] of the
    mirror strip: a roll for strip 0, a flip for the others."""
    lanes = np.arange(STRIP)
    return (-lanes) % STRIP if strip == 0 else STRIP - 1 - lanes


def companion_columns(strips) -> np.ndarray:
    """For a block of the given global strips, the column of each slot's
    mirror in the block's companion (strip s of the companion holding the
    mirror strip of strip s)."""
    return np.concatenate([s_local * STRIP + mirror_lanes(int(g))
                           for s_local, g in enumerate(strips)])


def pair_columns(groups_idx, n2y: int) -> np.ndarray:
    """For a block of strips in mirror-pair order (``groups_idx``: the
    global index of each local strip, group g at strips 2g and 2g + 1, of
    n2y strips in all), the local column of each slot's mirror. A group
    whose first strip is its own mirror (group 0: strips 0 and n2y/2) pairs
    each strip with itself (tpu_qg/parallel/paired.py:89-110, ``is_self``);
    any other group must hold a strip and its mirror."""
    idx = [int(i) for i in np.asarray(groups_idx)]
    if len(idx) % 2:
        raise ValueError(f"groups_idx has an odd length {len(idx)}")
    cols = []
    for g in range(0, len(idx), 2):
        a, b = idx[g], idx[g + 1]
        is_self = (n2y - a) % n2y == a
        if not is_self and b != (n2y - a) % n2y:
            raise ValueError(f"strips {a} and {b} are not mirrors of each "
                             f"other in {n2y} strips")
        for s_local, strip in ((g, a), (g + 1, b)):
            partner = s_local if is_self else s_local ^ 1
            cols.append(partner * STRIP + mirror_lanes(strip))
    return np.concatenate(cols)


def _pair_cols_plain(X: torch.Tensor, Xm: torch.Tensor, mirror_cols,
                     strips, consts) -> torch.Tensor:
    """ifft_x(A W + B conj(Wm(-k))) on the columns of a block of the given
    global strips, W = fft_x(X) and Wm = fft_x(Xm) read at ``mirror_cols``
    (the global y extent is 128 * consts[1])."""
    _, M, _ = X.shape
    P = STRIP * consts[1]
    A, B = _strip_symbols(M, P, consts, tuple(int(s) for s in strips),
                          X.dtype, X.device)
    W = torch.fft.fft(torch.complex(X[0], X[1]), dim=0)
    Wm = W if Xm is X else torch.fft.fft(torch.complex(Xm[0], Xm[1]), dim=0)
    neg_x = _index(_negate_natural, M, X.device)
    cols = torch.as_tensor(np.asarray(mirror_cols), device=X.device)
    v = torch.fft.ifft(A * W + B * torch.conj(Wm[neg_x][:, cols]), dim=0)
    return torch.stack([v.real, v.imag]).to(X.dtype)


def block_strips(width: int, strip_offset: int) -> range:
    """Global strips of a block of ``width`` columns at ``strip_offset``."""
    return range(strip_offset, strip_offset + width // STRIP)


def x_fwd_symbols_offset_plain(Zy: torch.Tensor, Zm: torch.Tensor, consts,
                               strip_offset: int) -> torch.Tensor:
    """Plain K13: the x-stage of a (2, M, w) column block of the y-spectrum
    holding global strips strip_offset .. strip_offset + w/128 - 1, with
    its mirror companion Zm (strip s of Zm = the mirror strip of strip s)."""
    strips = block_strips(Zy.shape[2], strip_offset)
    return _pair_cols_plain(Zy, Zm, companion_columns(strips), strips, consts)


def mirror_companion(Zy: torch.Tensor) -> torch.Tensor:
    """The companion of a whole y-spectrum: strip j holds strip
    (n2y - j) mod n2y (the mirror at strip granularity)."""
    n2y = Zy.shape[-1] // STRIP
    perm = torch.as_tensor((-np.arange(n2y)) % n2y, device=Zy.device)
    return Zy.unflatten(-1, (n2y, STRIP))[..., perm, :].flatten(-2)


def stream_pair_symbols_plain(Zy: torch.Tensor, consts) -> torch.Tensor:
    """Plain K7: K13 at offset 0 on the whole field with its companion (the
    same function as ``pair_x_symbols_plain``)."""
    return x_fwd_symbols_offset_plain(Zy, mirror_companion(Zy), consts, 0)


def paired_x_symbols_plain(X: torch.Tensor, groups_idx, consts
                           ) -> torch.Tensor:
    """Plain K14: the x-stage of a (2, M, w) block of strips in mirror-pair
    order, ``groups_idx`` their global indices."""
    return _pair_cols_plain(X, X, pair_columns(groups_idx, consts[1]),
                            groups_idx, consts)


@functools.lru_cache(maxsize=8)
def _stage_twiddle(M: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """(N2, N1, 1) table of W_M^(n1 k2), M = N1 N2 (split_factor), built in
    float64 and cast to the complex type of ``dtype``."""
    N1, N2 = split_factor(M)
    w = np.exp(-2j * np.pi * np.outer(np.arange(N2), np.arange(N1)) / M)
    return torch.as_tensor(w, device=device).to(_complex_dtype(dtype))[..., None]


def _x_stage_a(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """x_dft_stage_a_plain as a complex (N2, N1, cols) tensor."""
    _, M, cols = z.shape
    N1, N2 = split_factor(M)
    c = torch.complex(z[0], z[1]).reshape(N2, N1, cols)
    tw = _stage_twiddle(M, z.dtype, z.device)
    if not inverse:
        return torch.fft.fft(c, dim=0) * tw
    return torch.fft.ifft(c, dim=1, norm="forward") * tw.conj()


def _planar(c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.stack([c.real, c.imag]).to(dtype)


def x_dft_stage_a_plain(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The first half of K4's factored x-DFT (matmul_fft.FactoredFFT's
    factoring, M = N1 N2 with N1 = split_factor(M)[0]) on a planar (2, M,
    cols) field, row k2 N1 + n1 of the result holding
    forward  Y[k2, n1] = W_M^(n1 k2) sum_n2 W_N2^(n2 k2) x[N1 n2 + n1];
    inverse  Y[k2, n1] = conj(W_M^(n1 k2)) sum_k1 W_N1^(-n1 k1)
             X[k2 N1 + k1], unscaled.
    What the cluster kernel writes with ``stage_a`` (csrc
    x_dft_cluster_kernel)."""
    _, M, cols = z.shape
    return _planar(_x_stage_a(z, inverse).reshape(M, cols), z.dtype)


def x_dft_plain(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Planar (2, M, cols), DFT along x (dim 1): forward natural -> permuted
    x-spectrum; inverse permuted -> natural, scaled 1/M. The factored form
    K4's cluster kernel computes: stage A (x_dft_stage_a_plain), then
    forward the N1-point DFT along n1, whose (k2, k1) rows are the permuted
    slots k2 N1 + k1 (no index array); inverse the N2-point inverse DFT
    along k2 into rows N1 n2 + n1."""
    _, M, cols = z.shape
    y = _x_stage_a(z, inverse)
    if not inverse:
        out = torch.fft.fft(y, dim=1)
    else:
        out = torch.fft.ifft(y, dim=0, norm="forward") / M
    return _planar(out.reshape(M, cols), z.dtype)


def x_symbols_inverse_plain(W: torch.Tensor, consts) -> torch.Tensor:
    """Spectrum W, permuted on both axes -> ifft_x(A W + B conj(W(-k))) in
    natural x order, the y-spectrum still permuted. ``consts`` as for
    ``pair_x_symbols_plain``."""
    _, M, P = W.shape
    A, B = _symbols(M, P, consts, True, W.dtype, W.device)
    Wc = torch.complex(W[0], W[1])
    neg_x = _index(negate_index, M, W.device)
    neg_y = _index(negate_index, P, W.device)
    V = A * Wc + B * torch.conj(Wc[neg_x][:, neg_y])
    natural = torch.empty_like(V)
    natural[_index(freq_order, M, W.device)] = V
    v = torch.fft.ifft(natural, dim=0)
    return torch.stack([v.real, v.imag]).to(W.dtype)


def mono_invert_plain(z: torch.Tensor, consts) -> torch.Tensor:
    """Packed natural-order (2, M, P) field -> psi: the plain versions of K2,
    K3 and K2^-1 in turn. ``consts`` as for ``pair_x_symbols_plain``."""
    return y_dft_plain(pair_x_symbols_plain(y_dft_plain(z, False), consts),
                       True)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load()
    if lib.qg_y_dft_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _build.declare(lib.qg_y_dft_launch,
                       [p, p, i, i, i, i, i, i, p, p, i, p])
        _build.declare(lib.qg_pair_x_launch,
                       [p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, i, p])
        _build.declare(lib.qg_x_dft_launch,
                       [p, p, i, i, i, i, i, i, i, i, i, p, p, i, p])
        _build.declare(lib.qg_x_symbols_launch,
                       [p, p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p, i,
                        p])
        _build.declare(lib.qg_mono_launch,
                       [p, p, p, p, p, p, p, p, p, p, i, p, p])
        _build.declare(lib.qg_mono_rows_launch, [p] * 8 + [i, p, p])
        _build.declare(lib.qg_pair_cols_launch,
                       [p] * 6 + [i] * 11 + [p] * 3 + [i, p])
        _build.declare(lib.qg_x_dft_cluster_launch,
                       [p, p, i, i, i, i, i, i, p, p])
        _build.declare(lib.qg_x_dft_cluster_occupancy,
                       [i, i, i, ctypes.POINTER(ctypes.c_int)])
        _build.declare(lib.qg_x_dft_cluster_mixed_launch,
                       [p, p, i, i, i, i, i, i, i, p, p])
        _build.declare(lib.qg_x_dft_cluster_mixed_occupancy,
                       [i, i, i, ctypes.POINTER(ctypes.c_int)])
        _build.declare(lib.qg_y_dft_factored_launch,
                       [p, p, i, i, i, i, i, p, p])
        _build.declare(lib.qg_y_dft_factored_occupancy,
                       [i, i, i, i, ctypes.POINTER(ctypes.c_int)])
        _build.declare(lib.qg_y_dft_mixed_launch,
                       [p, p, i, i, i, i, i, i, p, p])
        _build.declare(lib.qg_y_dft_mixed_occupancy,
                       [i, i, i, i, ctypes.POINTER(ctypes.c_int)])
        _build.declare(lib.qg_x_symbols_cluster_launch,
                       [p] * 4 + [i] * 6 + [p, p, p])
        _build.declare(lib.qg_x_symbols_cluster_occupancy,
                       [i, i, i, ctypes.POINTER(ctypes.c_int)])
        _build.declare(lib.qg_x_symbols_cluster_mixed_launch,
                       [p] * 4 + [i] * 6 + [p, i, p, p])
        _build.declare(lib.qg_x_symbols_cluster_mixed_occupancy,
                       [i, i, i, ctypes.POINTER(ctypes.c_int)])
        _build.declare(lib.qg_pair_x_cluster_launch,
                       [p] * 4 + [i] * 6 + [p, p, p])
        _build.declare(lib.qg_pair_x_cluster_occupancy,
                       [i, i, i, ctypes.POINTER(ctypes.c_int)])
        _build.declare(lib.qg_pair_x_cluster_mixed_launch,
                       [p] * 4 + [i] * 6 + [p, i, p, p])
        _build.declare(lib.qg_pair_x_cluster_mixed_occupancy,
                       [i, i, i, ctypes.POINTER(ctypes.c_int)])
        _build.declare(lib.qg_pair_cols_cluster_launch,
                       [p] * 6 + [i] * 8 + [p, p, p])
        _build.declare(lib.qg_pair_cols_cluster_occupancy,
                       [i, i, i, i, ctypes.POINTER(ctypes.c_int)])
        _build.declare(lib.qg_pair_cols_cluster_mixed_launch,
                       [p] * 6 + [i] * 8 + [p, i, p, p])
        _build.declare(lib.qg_pair_cols_cluster_mixed_occupancy,
                       [i, i, i, i, ctypes.POINTER(ctypes.c_int)])
        lib.qg_pair_x_num_consts.restype = ctypes.c_int
        lib.qg_coop_plan_size.restype = ctypes.c_int
        lib.qg_coop_rows_plan_size.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _twiddles(N: int, count: int, device: torch.device) -> torch.Tensor:
    """(count, 2) float32 table of exp(-2 pi i k / N), built in float64."""
    w = np.exp(-2j * np.pi * np.arange(count) / N)
    table = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
    return torch.as_tensor(table, device=device)


def _tables(N: int, device: torch.device) -> tuple[int, int, int, int]:
    """(log2 R, m, radix-2 table pointer, m-point join table pointer or
    None) for an extent N = R * m."""
    R, m = radix_split(N)
    twn = _twiddles(N, N, device).data_ptr() if m > 1 else None
    return R.bit_length() - 1, m, _twiddles(R, R // 2, device).data_ptr(), twn


def pair_tasks(P: int, C: int) -> tuple[np.ndarray, np.ndarray]:
    """K3's task table: every unordered pair {a, sigma(a)} of permuted y
    slots (sigma = negate_index(P)) exactly once, in ascending order of the
    smaller slot, cut into tasks of C pairs; -1 pads the last task.
    Returns (own, mirror), each (n_tasks, C) int32."""
    neg = negate_index(P)
    canon = np.flatnonzero(np.arange(P) <= neg)
    n = -(-len(canon) // C) * C
    own = np.full(n, -1, np.int64)
    own[:len(canon)] = canon
    mirror = np.where(own >= 0, neg[np.maximum(own, 0)], -1)
    return (own.reshape(-1, C).astype(np.int32),
            mirror.reshape(-1, C).astype(np.int32))


@functools.lru_cache(maxsize=8)
def _device_tasks(P: int, C: int, device: torch.device):
    own, mirror = pair_tasks(P, C)
    return (torch.as_tensor(own, device=device),
            torch.as_tensor(mirror, device=device))


def _check_field(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if t.dim() != 3 or t.shape[0] != 2:
        raise ValueError(f"{name}: expected a planar (2, rows, N) field, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: field must be contiguous")


# K2's factored kernel (csrc y_dft_factored_kernel) on P = 128 * 2^b, 1 <= b
# <= 6, in a layout (Rb, threads): a block of `threads` threads takes Rb
# rows, each as N2 = P / 128 p-rows of 128 float2 at a stride of
# Y_ROW_STRIDE (csrc kYRowStride). y_dft launches it at the extents of
# Y_FACTORED_RB_BY_P, in the layout given there: at each, the layout of
# chip_smoke.py's k2_sweep with the least device time both ways (graph_ms),
# which was also less than y_dft_kernel's both ways in the same run
# (PERF.md). Its mixed-radix form (csrc y_dft_mixed_kernel) takes the other
# P = 128 * N2, 3 <= N2 <= 63, in the same layouts: y_dft launches Rb the
# least power of two with Rb N2 >= Y_MIXED_PROWS, 256 threads. 32 p-rows
# give stage B's warps a whole row of lanes (the source note's bank argument
# needs 16), and were the fastest of chip_smoke.py's k2_mixed layouts at
# N2 = 12, 19 and 24 (Rb = 4, 2, 2; PERF.md).
Y_FACTORED_THREADS = (256, 512)
Y_ROW_STRIDE = 135
Y_FACTORED_RB_BY_P = {256: (1, 256), 512: (2, 256), 1024: (4, 256),
                      2048: (2, 256), 4096: (2, 256), 8192: (1, 256)}
Y_MIXED_PROWS = 32
Y_REG_RADICES = (2, 3, 4, 5, 7, 8, 16)   # csrc reg_radix


def _is_pow2(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


@functools.lru_cache(maxsize=128)
def y_dft_mixed_plan(n: int) -> tuple[int, ...]:
    """The radices of the factored K2's stage A, the N2 = n point DFT, in
    DIF order (csrc y_dft_mixed_kernel): for n = 2^c m, m odd > 1, 2^c as
    one radix-2^c register pass (c <= 4 for n <= 64), then the factors 3,
    5 and 7 of m, then what is left of m (1 or a prime >= 11 for n < 121).
    For a power of two, log2 n radix-2 stages (the power-of-two kernel's
    il_pass groups them, which changes no index)."""
    if _is_pow2(n):
        return (2,) * (n.bit_length() - 1)
    c = (n & -n).bit_length() - 1
    m = n >> c
    plan = [1 << c] if c else []
    for r in (3, 5, 7):
        while m % r == 0:
            plan.append(r)
            m //= r
    if m > 1:
        plan.append(m)
    return tuple(plan)


def y_dft_mixed_rho(plan) -> np.ndarray:
    """rho[p] = the frequency k2 that position p holds after stage A's
    passes over ``plan`` (DIF order): with spans L_t = n / (r_0 ... r_t)
    and p = sum_t b_t L_t (b_t < r_t), k2 = sum_t b_t r_0 ... r_(t-1), the
    digit reversal (csrc y_dft_mixed_kernel; bitrev when every radix is
    2)."""
    n = int(np.prod(plan, dtype=np.int64))
    p = np.arange(n)
    rho = np.zeros(n, np.int64)
    span, mul = n, 1
    for r in plan:
        span //= r
        rho += (p // span % r) * mul
        mul *= r
    return rho


def _y_mixed_prime(n: int) -> int:
    """The prime >= 11 of y_dft_mixed_plan(n), or 0 (csrc y_mixed_prime)."""
    last = y_dft_mixed_plan(n)[-1] if n > 1 else 1
    return last if last not in Y_REG_RADICES and last > 1 else 0


@functools.lru_cache(maxsize=128)
def _packed_plan(n: int) -> int:
    """y_dft_mixed_plan(n) as the kernel takes it: one byte a radix, the
    first lowest."""
    return sum(r << (8 * t) for t, r in enumerate(y_dft_mixed_plan(n)))


def _mixed(N: int) -> bool:
    """True iff N = 128 * N2 with 3 <= N2 <= 63 not a power of two: an
    extent of the mixed-radix factored kernels (K2's along y, K4's along
    x)."""
    n2 = N // _N1
    return N == _N1 * n2 and 3 <= n2 <= 63 and not _is_pow2(n2)


@functools.lru_cache(maxsize=128)
def y_dft_factored_launched(P: int) -> tuple[int, int]:
    """The layout (Rb, threads) y_dft launches at extent P: power-of-two
    extents from Y_FACTORED_RB_BY_P (else (1, 256)), mixed ones the least
    power-of-two Rb with Rb N2 >= Y_MIXED_PROWS that fits, 256 threads."""
    if not _mixed(P):
        return Y_FACTORED_RB_BY_P.get(P, (1, 256))
    rb = 1
    while (rb * (P // _N1) < Y_MIXED_PROWS and y_dft_factored_layout(
            P, 2 * rb).smem <= SMEM_LIMIT):
        rb *= 2
    return rb, 256


class YFactoredLayout(NamedTuple):
    """The factored K2's block (csrc y_factored_smem, y_mixed_smem): N2, Rb
    rows, threads, and bytes of shared memory: Rb N2 p-rows of
    Y_ROW_STRIDE float2, the stage-A table (N2/2 float2 for a power of
    two, N2 for a mixed N2), the 64- and 64-entry tables, the 2 N2-entry
    one and, for a mixed N2, the two N2-entry int maps of the digit
    reversal and the prime pass's (p-1)/2 x (p+1)/2 float2 weights."""
    n2: int
    rb: int
    threads: int
    smem: int


def y_dft_factored_layout(P: int, rb: int,
                          threads: int = 256) -> YFactoredLayout:
    n2 = P // _N1
    if _mixed(P):
        h = _y_mixed_prime(n2) // 2
        smem = (8 * (rb * n2 * Y_ROW_STRIDE + 3 * n2 + 2 * 64 + h * (h + 1))
                + 4 * 2 * n2)
    else:
        smem = 8 * (rb * n2 * Y_ROW_STRIDE + n2 // 2 + 2 * 64 + 2 * n2)
    return YFactoredLayout(n2, rb, threads, smem)


@functools.lru_cache(maxsize=256)
def y_dft_factored_takes(P: int, layout: tuple | None = None) -> bool:
    """True iff the factored kernel takes extent P at ``layout`` = (Rb,
    threads) (by default the launched one, y_dft_factored_launched): P =
    128 * N2 with 2 <= N2 <= 64 (a power of two: y_dft_factored_kernel;
    else its mixed-radix form), Rb a power of two, within one block's
    shared memory."""
    n2 = P // _N1
    if P != _N1 * n2 or not 2 <= n2 <= 64:
        return False
    rb, threads = layout or y_dft_factored_launched(P)
    return (rb >= 1 and _is_pow2(rb) and threads in Y_FACTORED_THREADS
            and y_dft_factored_layout(P, rb, threads).smem <= SMEM_LIMIT)


@functools.lru_cache(maxsize=64)
def y_dft_factored_occupancy(P: int, layout: tuple, device: int) -> int:
    """The most blocks of ``layout`` = (Rb, threads) at extent P that one
    SM of card ``device`` holds, in both directions
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); 0: the layout cannot
    run."""
    rb, threads = layout
    n2 = P // _N1
    counts = []
    with torch.cuda.device(device):
        for inverse in (0, 1):
            count = ctypes.c_int(0)
            if _mixed(P):
                code = _lib().qg_y_dft_mixed_occupancy(
                    n2, rb.bit_length() - 1, threads, inverse,
                    ctypes.byref(count))
            else:
                code = _lib().qg_y_dft_factored_occupancy(
                    n2.bit_length() - 1, rb.bit_length() - 1, threads,
                    inverse, ctypes.byref(count))
            _build.check(code, f"y_dft factored occupancy {layout} at P = {P}")
            counts.append(count.value)
    return min(counts)


def y_dft_factored(z: torch.Tensor, inverse: bool,
                   layout: tuple | None = None) -> torch.Tensor:
    """One launch of K2's factored kernel on a CUDA (2, rows, P) float32
    field, P = 128 * N2 (2 <= N2 <= 64): y_dft_factored_kernel for a power
    of two, y_dft_mixed_kernel (stage A over y_dft_mixed_plan(N2)) for the
    rest, with ``layout`` = (Rb rows a block, threads), by default
    y_dft_factored_launched(P): y_dft's result. Raises on a shape or layout
    the kernel does not take, a layout the card cannot schedule and a
    launch error. Counts nothing: the counting wrapper is y_dft.

    Replaces, as y_dft_kernel does, tpu_qg/ops/pallas_fft.py
    PlanarFFT2._call_y (:1100). Bound: one read and one write of the field
    (1074 MB at 8192^2, 0.321 ms at 3.35 TB/s; 94.6 MB at 2432^2, 0.0282
    ms). Why factored: y_dft_kernel holds a row and its own copy of the
    twiddle table (98 KB a block at P = 8192, 16 warps an SM) and loads,
    transforms in four barrier-separated passes and gathers one after
    another; on a mixed extent it joins its sub-transforms with an m-term
    sum per element. This kernel runs matmul_fft.FactoredFFT's factoring
    (y_dft_factored_plain; y_dft_factored_emulated runs the mixed form's
    index maps): stage A's first pass reads the row straight into
    registers, stage B leaves whole 128-slot runs of the permuted spectrum,
    its tables are a few KB a block, and a mixed N2 pays about the sum of
    its prime factors per element (design in the source)."""
    _, rows, P = z.shape
    layout = tuple(layout or y_dft_factored_launched(P))
    if z.device.type != "cuda":
        raise ValueError(f"y_dft_factored: unsupported device {z.device}")
    _check_field("y_dft_factored", z)
    if not y_dft_factored_takes(P, layout):
        raise ValueError(f"y_dft_factored: P = {P} must be 128 * N2 "
                         f"(2 <= N2 <= 64) and the layout {layout} (Rb, "
                         f"threads) fit shared memory")
    rb, threads = layout
    device = z.device.index if z.device.index is not None else \
        torch.cuda.current_device()
    if y_dft_factored_occupancy(P, layout, device) == 0:
        raise RuntimeError(f"y_dft_factored: the card cannot schedule "
                           f"layout {layout} at P = {P}")
    out = torch.empty_like(z)
    wm = _twiddles(P, P, z.device).data_ptr()
    stream = torch.cuda.current_stream(z.device).cuda_stream
    n2 = P // _N1
    if _mixed(P):
        code = _lib().qg_y_dft_mixed_launch(
            z.data_ptr(), out.data_ptr(), rows, n2, rb.bit_length() - 1,
            threads, int(inverse), _packed_plan(n2), wm, stream)
    else:
        code = _lib().qg_y_dft_factored_launch(
            z.data_ptr(), out.data_ptr(), rows, n2.bit_length() - 1,
            rb.bit_length() - 1, threads, int(inverse), wm, stream)
    _build.check(code, f"y_dft_factored (K2) {layout}")
    return out


def y_dft_factored_emulated(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """What the factored kernel does on a (2, rows, P) field, P = 128 *
    N2, with the CUDA source's index maps (y_dft_mixed_kernel's; for a
    power of two y_dft_factored_kernel's, whose radix-2 stages are the
    plan (2, ..., 2)), in plain torch: stage A as the passes of
    y_dft_mixed_plan(N2), each butterfly's r-point DFT on the weights
    W_r^(ab) and the twiddles W_(rL)^(jk) read from the kernel's N2-entry
    table; p-row p then holds k2 = rho[p] (y_dft_mixed_rho), times
    W_P^(n1 k2) from the thi/tlo split; stage B along n1 (torch.fft); the
    sweep reads slot k2 N1 + k1 from p-row pos[k2]. The inverse mirrors
    it: the sweep by rho, the inverse 128-point DFT times conj(W_P^(n1
    k2)), the passes in reverse order as DIT passes, scaled 1/P. Returns
    the planar result, y_dft_plain's."""
    _, rows, P = z.shape
    n2 = P // _N1
    if P != _N1 * n2 or not 2 <= n2 <= 64:
        raise ValueError(f"the factored kernel does not take P = {P}")
    plan = y_dft_mixed_plan(n2)
    rho = torch.as_tensor(y_dft_mixed_rho(plan), device=z.device)
    cdt = _complex_dtype(z.dtype)
    wm = torch.as_tensor(np.exp(-2j * np.pi * np.arange(P) / P),
                         device=z.device).to(cdt)
    twa = wm[::_N1]                                  # W_N2^k, k < N2
    n1 = torch.arange(_N1, device=z.device)
    j = n1[None, :] * rho[:, None]                   # (p, n1): n1 k2
    twiddle = wm[(j >> 6) << 6] * wm[j & 63]         # thi[j >> 6] tlo[j & 63]
    c = torch.complex(z[0], z[1])
    if not inverse:
        y = _plan_passes_emulated(c.reshape(rows, n2, _N1), twa, False)
        y = torch.fft.fft(y * twiddle, dim=2)      # (p, k1): k2 = rho[p]
        out = torch.empty_like(y)
        out[:, rho, :] = y
        out = out.reshape(rows, P)
    else:
        y = c.reshape(rows, n2, _N1)[:, rho, :]     # p-row p <- slot k2 = rho[p]
        y = torch.fft.ifft(y, dim=2, norm="forward") * twiddle.conj()
        y = _plan_passes_emulated(y, twa, True)
        out = y.reshape(rows, P) * (1.0 / P)
    return _planar(out, z.dtype)


def _plan_passes_emulated(y: torch.Tensor, twa: torch.Tensor,
                          inverse: bool) -> torch.Tensor:
    """The factored kernels' mixed-radix stage A (csrc mixed_fft_at) along
    dim 1 of a complex (batch, N2, cols) tensor, with the CUDA source's
    index maps: the passes of y_dft_mixed_plan(N2), each butterfly's r-point
    DFT on the weights W_r^(ab) and output k of offset j times W_(rL)^(jk)
    (span L), both read from ``twa``, the kernel's table of W_N2^k (k <
    N2). Forward (DIF, the plan's order): natural order in, p-row p holding
    k2 = y_dft_mixed_rho(plan)[p] out; inverse (DIT, the passes in reverse
    order with conjugate weights, unscaled): the mirror image."""
    batch, n2, cols = y.shape
    passes, span = [], n2
    for r in y_dft_mixed_plan(n2):
        span //= r
        passes.append((r, span))

    def dft_weights(r: int, conj: bool) -> torch.Tensor:
        e = (np.outer(np.arange(r), np.arange(r)) % r) * (n2 // r)
        w = twa[torch.as_tensor(e, device=y.device)]
        return w.conj() if conj else w

    def stage_twiddles(r: int, L: int, conj: bool) -> torch.Tensor:
        # (r, L): W_(rL)^(j k) = twa[j k N2 / (r L)], output k, offset j.
        e = np.outer(np.arange(r), np.arange(L)) * (n2 // (r * L))
        w = twa[torch.as_tensor(e, device=y.device)]
        return w.conj() if conj else w

    for r, L in (reversed(passes) if inverse else passes):
        y = y.reshape(batch, n2 // (r * L), r, L, cols)   # blk r L + a L + j
        if not inverse:
            y = torch.einsum("xbajc,ak->xbkjc", y, dft_weights(r, False))
            y = y * stage_twiddles(r, L, False)[None, None, :, :, None]
        else:
            y = y * stage_twiddles(r, L, True)[None, None, :, :, None]
            y = torch.einsum("xbkjc,ka->xbajc", y, dft_weights(r, True))
        y = y.reshape(batch, n2, cols)
    return y


def y_dft_whole_row(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """One launch of y_dft_kernel (a block a whole row) on a CUDA (2, rows,
    P) float32 field at any extent P = R * m it takes: y_dft's result.
    Raises on a shape it does not take and a launch error. Counts nothing:
    the counting wrapper is y_dft."""
    if z.device.type != "cuda":
        raise ValueError(f"y_dft: unsupported device {z.device}")
    _check_field("y_dft", z)
    rows, P = z.shape[1], z.shape[2]
    if not (_radix_ok(P) and y_dft_smem(P) <= SMEM_LIMIT):
        raise ValueError(f"y_dft: P = {P} must be R * m (R a power of two, "
                         f"m odd <= {MAX_ODD}) within shared memory")
    out = torch.empty_like(z)
    logr, m, tw, twn = _tables(P, z.device)
    code = _lib().qg_y_dft_launch(
        z.data_ptr(), out.data_ptr(), rows, P, logr, m, split_factor(P)[0],
        int(inverse), tw, twn, y_dft_threads(P),
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(code, "y_dft (K2)")
    return out


def y_dft(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """K2 on CUDA tensors (one launch), the plain version on CPU tensors.
    Hand-written kernels chosen by shape, all counted in ``y_dft.launches``:
    on P = 128 * N2, 2 <= N2 <= 64, the factored kernel (y_dft_factored):
    y_dft_factored_kernel for a power of two, counted also in
    ``y_dft.factored_launches``, y_dft_mixed_kernel for the rest, counted
    also in ``y_dft.mixed_launches``; y_dft_kernel (y_dft_whole_row) on
    every other extent it takes (P <= 128, P not a multiple of 128)."""
    if z.device.type == "cpu":
        return y_dft_plain(z, inverse)
    P = z.shape[-1]
    if y_dft_factored_takes(P):
        out = y_dft_factored(z, inverse)
        if _mixed(P):
            y_dft.mixed_launches += 1
        else:
            y_dft.factored_launches += 1
    else:
        out = y_dft_whole_row(z, inverse)
    y_dft.launches += 1
    return out


y_dft.launches = 0
y_dft.factored_launches = 0
y_dft.mixed_launches = 0


def pair_x_stride(n: int) -> int:
    """Floats between K3's shared-memory columns of n values: the padded
    length (one pad word per 32, csrc pad()) rounded up to 32, plus 8, so
    that a warp loading 8 rows of 4 adjacent columns hits 32 distinct
    banks."""
    return -(-_pad(n) // 32) * 32 + 8


def _columns_layout(M: int, columns, target: int = _PAIR_X_SMEM_TARGET
                    ) -> tuple[int, int, int, int]:
    """(C, sub-column stride, spectrum stride, bytes) of an x-kernel whose
    shared memory holds ``columns(C, m * sub, bstride)`` floats beside the
    radix-2 table: C the most (a power of two <= 8, at least 1) that fit
    ``target``. bstride is the stride of a natural-order spectrum of a mixed
    extent (0 for m = 1)."""
    R, m = radix_split(M)
    sub = pair_x_stride(R)
    bstride = pair_x_stride(M) if m > 1 else 0
    C = 8
    while True:
        smem = 4 * (columns(C, m * sub, bstride) + R)
        if C == 1 or smem <= target:
            return C, sub, bstride, smem
        C //= 2


def pair_x_layout(M: int) -> tuple[int, int, int, int]:
    """K3's shared-memory layout for columns of M = R * m values:
    (C slot pairs per block, sub-column stride, joined-spectrum stride or 0,
    bytes): 2C columns and, for m > 1, 2C joined spectra (csrc
    qg_pair_x_launch)."""
    return _columns_layout(M, lambda C, cs, b: 4 * C * (cs + b))


# K4's and K5's whole-column kernels take the most columns that fit one
# block: at 128 registers a thread, one 512-thread block fills an SM's
# registers anyway, and more columns per block mean longer runs per row (K4
# forward at 8192^2: 2.77 ms with C = 2 against 3.57 ms with C = 1 on an
# H100, PERF.md).
def x_dft_layout(M: int, inverse: bool) -> tuple[int, int, int, int]:
    """K4's layout: C adjacent y slots per block; C columns and, for the
    inverse of m > 1, C natural-order spectra (csrc qg_x_dft_launch)."""
    return _columns_layout(
        M, lambda C, cs, b: 2 * C * (cs + (b if inverse else 0)), SMEM_LIMIT)


# K4's cluster kernels on M = 128 * N2 with N2 >= G (csrc
# x_dft_cluster_kernel for N2 = 2^a, x_dft_cluster_mixed_kernel for the other
# N2 <= 63): a cluster of G blocks takes Cw adjacent y slots, block r stage A
# of n1 in [r L1, (r+1) L1), L1 = 128 / G, then stage B of the p-rows
# [floor(r N2 / G), floor((r+1) N2 / G)) (p-row p holding k2 = rho(p): the
# bit reversal for a power of two, else the digit reversal of
# y_dft_mixed_plan(N2)). The layout x_dft launches, (G, Cw), is at each
# extent of X_CLUSTER_BY_M the one with the least device time both ways in
# chip_smoke.py's k4_sweep (powers of two) or k4_mixed (mixed extents)
# (PERF.md), else X_CLUSTER, which fits shared memory at every N2 <= 63.
CLUSTER_SIZES = (8, 16)
CLUSTER_WIDTHS = (8, 16)
X_CLUSTER = (8, 8)
X_CLUSTER_BY_M = {2560: (8, 16), 3072: (8, 16), 6144: (16, 16),
                  7808: (16, 8), 8192: (16, 8)}
_N1 = 128        # N1 of the factored kernels (split_factor on 128 * n)


def x_dft_cluster_launched(M: int) -> tuple[int, int]:
    """The layout (G, Cw) x_dft launches at extent M."""
    return X_CLUSTER_BY_M.get(M, X_CLUSTER)


class ClusterLayout(NamedTuple):
    """The cluster kernel's shared memory for M = 128 * N2 (csrc
    cluster_smem, cluster_mixed_smem): buffer A (N2 rows of L1 Cw float2, a
    tile of M Cw / G), buffer B (128 rows of L2 Cw float2, L2 = ceil(N2 /
    G), the most p-rows a block owns), then the tables: for a power of two
    the N2/2- and 64-entry radix-2 ones; for a mixed N2 the N2- and
    64-entry ones, the prime pass's (p-1)/2 x (p+1)/2 float2 weights and
    two N2-entry int maps (rho, and p-row -> block and row)."""
    n2: int
    l1: int
    l2: int
    tile: int
    smem: int


def x_dft_cluster_layout(M: int, G: int, Cw: int) -> ClusterLayout:
    n2 = M // _N1
    l2 = -(-n2 // G)
    tile = M * Cw // G
    if _mixed(M):
        h = _y_mixed_prime(n2) // 2
        smem = (8 * (tile + _N1 * l2 * Cw + n2 + _N1 // 2 + h * (h + 1))
                + 4 * 2 * n2)
    else:
        smem = 8 * (2 * tile + n2 // 2 + _N1 // 2)
    return ClusterLayout(n2, _N1 // G, l2, tile, smem)


def x_dft_cluster_takes(M: int, G: int | None = None,
                        Cw: int | None = None) -> bool:
    """True iff a cluster kernel takes extent M at (G, Cw) (by default the
    launched layout's): M = 128 * N2 with N2 >= G, N2 a power of two
    (x_dft_cluster_kernel) or 3 <= N2 <= 63 (x_dft_cluster_mixed_kernel),
    within one block's shared memory."""
    if G is None or Cw is None:
        G, Cw = x_dft_cluster_launched(M)
    n2 = M // _N1
    return (G in CLUSTER_SIZES and Cw in CLUSTER_WIDTHS
            and M == _N1 * n2 and n2 >= G and (_is_pow2(n2) or _mixed(M))
            and x_dft_cluster_layout(M, G, Cw).smem <= SMEM_LIMIT)


def x_dft_cluster_split(M: int, G: int) -> np.ndarray:
    """Stage B's split of the N2 p-rows (csrc x_cluster_tile): block r owns
    p-rows [s[r], s[r + 1]), s[r] = floor(r N2 / G)."""
    return np.arange(G + 1) * (M // _N1) // G


def _bitrev(bits: int) -> torch.Tensor:
    """bitrev(i, bits) for i < 2^bits (csrc bitrev)."""
    i = np.arange(1 << bits)
    r = np.zeros_like(i)
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return torch.as_tensor(r)


def x_dft_cluster_emulated(z: torch.Tensor, inverse: bool, G: int, Cw: int,
                           stage_a: bool = False):
    """What a cluster kernel does at (G, Cw), tile by tile and block by
    block, in plain torch: each block's loads into its first-stage buffer,
    its stage along n2 (the passes of y_dft_mixed_plan(N2) with the
    kernel's weights and twiddles, _plan_passes_emulated: p-row p then
    holds k2 = rho[p]) or along n1 (torch.fft, then rows in the DIF
    output's bit-reversed order, or from the DIT input's), stage B's split
    of the p-rows (x_dft_cluster_split) and the owner of each p-row, its
    pulls from every block's buffer with the inter-stage twiddle and its
    stores, with the CUDA source's index arithmetic. A power of two runs
    the same maps (its plan is radix 2 throughout, rho the bit reversal).
    Returns (out, loads, stores): the planar result (x_dft_plain's, or with
    ``stage_a`` x_dft_stage_a_plain's) and how many times each (row, slot)
    of the input was loaded and of the output stored."""
    _, M, P = z.shape
    if not x_dft_cluster_takes(M, G, Cw):
        raise ValueError(f"the cluster kernel does not take M = {M} at "
                         f"G = {G}, Cw = {Cw}")
    n2, l1, l2, _, _ = x_dft_cluster_layout(M, G, Cw)
    na = l1 * Cw
    c = torch.complex(z[0], z[1])
    wm = torch.as_tensor(np.exp(-2j * np.pi * np.arange(M) / M)).to(c.dtype)
    twa = wm[::_N1]                                  # W_N2^k, k < N2
    rho = torch.as_tensor(y_dft_mixed_rho(y_dft_mixed_plan(n2)))
    brb = _bitrev(7)
    s = x_dft_cluster_split(M, G)
    owner = torch.as_tensor(np.repeat(np.arange(G), np.diff(s)))
    start = torch.as_tensor(s)
    out = torch.zeros_like(c)
    loads = torch.zeros((M, P), dtype=torch.int64)
    stores = torch.zeros((M, P), dtype=torch.int64)
    ia = torch.arange(n2 * na)

    def load(buf, brow, bcol, grow, col, c0):
        ok = c0 + col < P
        buf[brow[ok], bcol[ok]] = c[grow[ok], c0 + col[ok]]
        loads.index_put_((grow[ok], c0 + col[ok]),
                         torch.ones(int(ok.sum()), dtype=torch.int64),
                         accumulate=True)

    def store(v, grow, col, c0):
        ok = c0 + col < P
        out[grow[ok], c0 + col[ok]] = v[ok]
        stores.index_put_((grow[ok], c0 + col[ok]),
                          torch.ones(int(ok.sum()), dtype=torch.int64),
                          accumulate=True)

    def block_b(r):                # stage B's elements (row, column) of block r
        cnt = int(s[r + 1] - s[r]) * Cw
        e = torch.arange(_N1 * cnt)
        return e // cnt, e % cnt

    for c0 in range(0, P, Cw):
        first = []
        for r in range(G):
            r1, s0 = r * l1, int(s[r])
            if not inverse:
                buf = torch.zeros((n2, na), dtype=c.dtype)
                p, a = ia // na, ia % na
                load(buf, p, a, _N1 * p + r1 + a // Cw, a % Cw, c0)
                buf = _plan_passes_emulated(buf[None], twa, False)[0]
                if stage_a:
                    n1, k2 = r1 + a // Cw, rho[p]
                    store(buf[p, a] * wm[n1 * k2], _N1 * k2 + n1,
                          a % Cw, c0)
            else:
                buf = torch.zeros((_N1, l2 * Cw), dtype=c.dtype)
                pp, b = block_b(r)
                k2 = rho[s0 + b // Cw]
                load(buf, pp, b, _N1 * k2 + brb[pp], b % Cw, c0)
                buf = torch.fft.ifft(buf[brb], dim=0, norm="forward")
                if stage_a:
                    store(buf[pp, b] * wm[pp * k2].conj(),
                          _N1 * k2 + pp, b % Cw, c0)
            first.append(buf)
        if stage_a:
            continue
        first = torch.stack(first)
        for r in range(G):
            r1, s0 = r * l1, int(s[r])
            if not inverse:
                n1, b = block_b(r)     # the pull, then DIF along n1
                p = s0 + b // Cw
                v = first[n1 // l1, p, (n1 % l1) * Cw + b % Cw] * wm[
                    n1 * rho[p]]
                buf = torch.zeros((_N1, l2 * Cw), dtype=c.dtype)
                buf[n1, b] = v
                buf = torch.fft.fft(buf, dim=0)[brb]
                store(buf[n1, b], _N1 * rho[p] + brb[n1], b % Cw, c0)
            else:
                p, a = ia // na, ia % na   # the pull from p-row p's owner
                n1 = r1 + a // Cw
                rank = owner[p]
                v = first[rank, n1, (p - start[rank]) * Cw + a % Cw] * wm[
                    n1 * rho[p]].conj()
                buf = torch.zeros((n2, na), dtype=c.dtype)
                buf[p, a] = v
                buf = _plan_passes_emulated(buf[None], twa, True)[0]
                store(buf[p, a] / M, _N1 * p + r1 + a // Cw, a % Cw, c0)
    return _planar(out, z.dtype), loads, stores


def x_symbols_layout(M: int) -> tuple[int, int, int, int]:
    """The layout of K5's whole-column kernel (x_symbols_inverse_kernel): C
    slot pairs per block; 2C columns for m = 1, else 2C natural-order
    spectra and C columns of sub-columns (csrc qg_x_symbols_launch)."""
    return _columns_layout(
        M, lambda C, cs, b: 2 * (2 * C * b + C * cs) if b else 4 * C * cs,
        SMEM_LIMIT)


def _threads(C: int, M: int) -> int:
    """Block size of K3/K4/K5: a multiple of C, 512 for long columns."""
    return 512 if C * M >= 1024 else 128


def check_consts(what: str, consts, M: int, P: int) -> ctypes.Array:
    """The symbol constants as the kernels' SymConsts float table."""
    n2x, n2y, inv_dx2, alpha2, a1, a2, b1, b2 = consts
    if (n2x, n2y) != (split_factor(M)[1], split_factor(P)[1]):
        raise ValueError(f"{what}: consts were built for another shape than "
                         f"({M}, {P})")
    vals = [inv_dx2, alpha2, a1.real, a1.imag, a2.real, a2.imag,
            b1.real, b1.imag, b2.real, b2.imag]
    if len(vals) != _lib().qg_pair_x_num_consts():
        raise RuntimeError(f"{what}: constant table does not match the "
                           "compiled kernel")
    return (ctypes.c_float * len(vals))(*vals)


def _cuda_field(what: str, z: torch.Tensor, takes, M: int, P: int) -> None:
    if z.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {z.device}")
    _check_field(what, z)
    if not takes(M, P):
        raise ValueError(f"{what}: ({M}, {P}) must each be R * m (R a power "
                         f"of two, m odd <= {MAX_ODD}) within shared memory")


def pair_x_whole_columns(Zy: torch.Tensor, consts) -> torch.Tensor:
    """One launch of pair_x_kernel (a block whole columns of C slot pairs)
    on a CUDA (2, M, P) float32 y-spectral field at any extent it takes:
    pair_x_symbols's result. Raises on a shape it does not take and a
    launch error. Counts nothing: the counting wrapper is pair_x_symbols."""
    _, M, P = Zy.shape
    _cuda_field("pair_x_symbols", Zy, kernels_take, M, P)
    vals = check_consts("pair_x_symbols", consts, M, P)
    C, sub, bstride, _ = pair_x_layout(M)
    own, mirror = _device_tasks(P, C, Zy.device)
    out = torch.empty_like(Zy)
    logr, m, tw, twn = _tables(M, Zy.device)
    code = _lib().qg_pair_x_launch(
        Zy.data_ptr(), out.data_ptr(), own.data_ptr(), mirror.data_ptr(),
        own.shape[0], M, P, logr, m, split_factor(P)[0], C, sub, bstride,
        vals, tw, twn, _threads(C, M),
        torch.cuda.current_stream(Zy.device).cuda_stream)
    _build.check(code, "pair_x_symbols (K3)")
    return out


@functools.lru_cache(maxsize=32)
def x_dft_cluster_occupancy(M: int, layout: tuple, device: int) -> int:
    """The most clusters of ``layout`` = (G, Cw) at extent M that card
    ``device`` holds at once (cudaOccupancyMaxActiveClusters, the power-of-
    two or the mixed instance); 0: the layout cannot be scheduled."""
    G, Cw = layout
    n2 = M // _N1
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        if _mixed(M):
            code = _lib().qg_x_dft_cluster_mixed_occupancy(
                n2, G.bit_length() - 1, Cw.bit_length() - 1,
                ctypes.byref(count))
        else:
            code = _lib().qg_x_dft_cluster_occupancy(
                n2.bit_length() - 1, G.bit_length() - 1,
                Cw.bit_length() - 1, ctypes.byref(count))
    _build.check(code, f"x_dft cluster occupancy {layout} at M = {M}")
    return count.value


def x_dft_cluster(z: torch.Tensor, inverse: bool, layout: tuple | None = None,
                  stage_a: bool = False) -> torch.Tensor:
    """One launch of K4's cluster kernel on a CUDA (2, M, P) float32 field,
    M = 128 * N2 (csrc x_dft_cluster_kernel for N2 = 2^a,
    x_dft_cluster_mixed_kernel, stage A over y_dft_mixed_plan(N2), for the
    other N2 <= 63), with ``layout`` = (G, Cw), by default
    x_dft_cluster_launched(M): x_dft's result, or with ``stage_a``
    x_dft_stage_a_plain's.
    Raises on a shape or layout the kernel does not take, a layout the card
    cannot schedule and a launch error. Counts nothing: the counting
    wrappers are x_dft and x_dft_stage_a.

    Replaces, as x_dft_kernel does, tpu_qg/ops/pallas_fft.py
    PlanarFFT2._call_x (:1153) and _call_x_stream(z, inverse) without
    consts (:1122). Bound: one read and one write of the field (1074 MB at
    8192^2, 0.321 ms at 3.35 TB/s; 151 MB at 3072^2, 0.045 ms). Why a
    cluster: x_dft_kernel's blocks hold whole columns (64 KB each at M =
    8192), so two fit and a warp moves 8-byte runs a row, a quarter of a
    sector, and on a mixed extent it joins its sub-transforms with an
    m-term sum per element; a tile of whole columns wide enough for full
    sectors (8) would need 512 KB. The cluster's G blocks share it: each
    runs 1/G of stage A, then pulls its part of stage B from its peers'
    shared memory (design in the source)."""
    _, M, P = z.shape
    G, Cw = layout or x_dft_cluster_launched(M)
    _cuda_field("x_dft_cluster", z,
                lambda m, p: x_dft_cluster_takes(m, G, Cw), M, P)
    device = z.device.index if z.device.index is not None else \
        torch.cuda.current_device()
    if x_dft_cluster_occupancy(M, (G, Cw), device) == 0:
        raise RuntimeError(f"x_dft_cluster: the card cannot schedule a "
                           f"cluster of layout {(G, Cw)} at M = {M}")
    out = torch.empty_like(z)
    n2 = M // _N1
    args = (G.bit_length() - 1, Cw.bit_length() - 1, int(inverse),
            int(stage_a))
    wm = _twiddles(M, M, z.device).data_ptr()
    stream = torch.cuda.current_stream(z.device).cuda_stream
    if _mixed(M):
        code = _lib().qg_x_dft_cluster_mixed_launch(
            z.data_ptr(), out.data_ptr(), P, n2, *args, _packed_plan(n2), wm,
            stream)
    else:
        code = _lib().qg_x_dft_cluster_launch(
            z.data_ptr(), out.data_ptr(), P, n2.bit_length() - 1, *args, wm,
            stream)
    _build.check(code, f"x_dft_cluster (K4) {(G, Cw)}")
    return out


def x_dft_whole_columns(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """One launch of x_dft_kernel (a block whole columns of C y slots) on a
    CUDA (2, M, P) float32 field at any extent the four-pass kernels take:
    x_dft's result. Raises on a shape it does not take and a launch error.
    Counts nothing: the counting wrapper is x_dft."""
    _, M, P = z.shape
    _cuda_field("x_dft", z, x_kernels_take, M, P)
    C, sub, bstride, _ = x_dft_layout(M, inverse)
    out = torch.empty_like(z)
    logr, m, tw, twn = _tables(M, z.device)
    code = _lib().qg_x_dft_launch(
        z.data_ptr(), out.data_ptr(), M, P, logr, m, split_factor(M)[0],
        int(inverse), C, sub, bstride, tw, twn, _threads(C, M),
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(code, "x_dft (K4)")
    return out


def x_dft(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """K4 on CUDA tensors (one launch), the plain version on CPU tensors.
    Hand-written kernels chosen by shape, all counted in ``x_dft.launches``:
    on M = 128 * N2 with N2 >= G of the launched layout
    (x_dft_cluster_launched(M)) a cluster kernel (x_dft_cluster):
    x_dft_cluster_kernel for a power of two, counted also in
    ``x_dft.cluster_launches``, x_dft_cluster_mixed_kernel for the other N2
    <= 63, counted also in ``x_dft.mixed_launches``; x_dft_kernel
    (x_dft_whole_columns) on the rest (M < 128 G)."""
    if z.device.type == "cpu":
        return x_dft_plain(z, inverse)
    _, M, P = z.shape
    _cuda_field("x_dft", z, x_kernels_take, M, P)
    if x_dft_cluster_takes(M):
        out = x_dft_cluster(z, inverse)
        if _mixed(M):
            x_dft.mixed_launches += 1
        else:
            x_dft.cluster_launches += 1
    else:
        out = x_dft_whole_columns(z, inverse)
    x_dft.launches += 1
    return out


x_dft.launches = 0
x_dft.cluster_launches = 0
x_dft.mixed_launches = 0


def x_dft_stage_a(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """A cluster kernel's first half alone (one launch with ``stage_a``, at
    every extent x_dft_cluster takes) on CUDA tensors, x_dft_stage_a_plain
    on CPU tensors: for checking stage A against its plain version on the
    card."""
    if z.device.type == "cpu":
        return x_dft_stage_a_plain(z, inverse)
    out = x_dft_cluster(z, inverse, stage_a=True)
    x_dft_stage_a.launches += 1
    return out


x_dft_stage_a.launches = 0


# K5's cluster kernels on M = 128 * N2 with U = ceil(N2 / 2) >= G (csrc
# x_symbols_cluster_kernel for N2 = 2^a, x_symbols_cluster_mixed_kernel for
# the other N2 <= 63): a cluster of G blocks takes an own tile of Cw y slots
# and its mirror tile (x_symbols_cluster_tiles), block r the k2 rows of
# both tiles of its units of an ordering that keeps each k2 row beside its
# mirror row (x_symbols_cluster_rows: for a power of two the rows [r L2,
# (r+1) L2), L2 = N2 / G). The layout x_symbols_inverse launches, (G, Cw),
# is at each extent of X_SYMBOLS_CLUSTER_BY_M the one of chip_smoke.py's
# k5_sweep (powers of two) or k5_mixed (mixed extents) with the least
# device time (PERF.md), else X_SYMBOLS_CLUSTER (4096's).
X_SYMBOLS_CLUSTER_SIZES = (4, 8, 16)
X_SYMBOLS_CLUSTER_WIDTHS = (4, 8, 16)
X_SYMBOLS_CLUSTER = (8, 8)
X_SYMBOLS_CLUSTER_BY_M = {4096: (8, 8), 6144: (16, 8), 7808: (16, 8),
                          8192: (16, 8)}


class SymbolsClusterLayout(NamedTuple):
    """K5's cluster kernel's shared memory for M = 128 * N2 (csrc
    x_symbols_cluster_smem, x_symbols_cluster_mixed_smem): buffer B (128
    rows of 2 L2 Cw float2: both tiles, L2 = 2 ceil(U / G) the most rows a
    block owns, N2 / G for a power of two) and buffer A (N2 rows of L1 Cw:
    one tile, M Cw / G float2), then for a power of two the N2/2- and
    64-entry radix-2 tables and the tile's 2 Cw int slots; for a mixed N2
    the N2- and 64-entry tables, the prime pass's (p-1)/2 x (p+1)/2 float2
    weights, the 2 Cw slots and three N2-entry int maps (k2 of a row, rho
    and the owner map)."""
    n2: int
    l1: int
    l2: int
    tile: int
    smem: int


def x_symbols_cluster_layout(M: int, G: int, Cw: int) -> SymbolsClusterLayout:
    n2 = M // _N1
    l2 = 2 * -(-((n2 + 1) // 2) // G)
    tile = M * Cw // G
    if _mixed(M):
        h = _y_mixed_prime(n2) // 2
        smem = (8 * (2 * _N1 * l2 * Cw + tile + n2 + _N1 // 2 + h * (h + 1))
                + 4 * (2 * Cw + 3 * n2))
    else:
        smem = 8 * (3 * tile + n2 // 2 + _N1 // 2) + 4 * 2 * Cw
    return SymbolsClusterLayout(n2, _N1 // G, l2, tile, smem)


def x_symbols_cluster_launched(M: int) -> tuple[int, int]:
    """The layout (G, Cw) x_symbols_inverse launches at extent M."""
    return X_SYMBOLS_CLUSTER_BY_M.get(M, X_SYMBOLS_CLUSTER)


def x_symbols_cluster_takes(M: int, layout: tuple | None = None) -> bool:
    """True iff a K5 cluster kernel takes extent M at ``layout`` = (G, Cw)
    (by default the launched one): M = 128 * N2, N2 a power of two
    (x_symbols_cluster_kernel) or 3 <= N2 <= 63 (x_symbols_cluster_mixed_
    kernel), with U = ceil(N2 / 2) >= G (every block owns a unit: whole
    pairs of k2 rows; N2 >= 2 G for a power of two), within one block's
    shared memory. The y extent does not matter: the tile table takes
    any."""
    G, Cw = layout or x_symbols_cluster_launched(M)
    n2 = M // _N1
    return (G in X_SYMBOLS_CLUSTER_SIZES and Cw in X_SYMBOLS_CLUSTER_WIDTHS
            and M == _N1 * n2 and (_is_pow2(n2) or _mixed(M))
            and (n2 + 1) // 2 >= G
            and x_symbols_cluster_layout(M, G, Cw).smem <= SMEM_LIMIT)


def x_symbols_cluster_tiles(P: int, Cw: int) -> tuple[np.ndarray, np.ndarray]:
    """K5's cluster tile table for a y extent P = N1y N2y (split_factor):
    every unordered pair {a, sigma(a)} of permuted y slots (sigma =
    negate_index(P)) once, strip by strip (strip j: slots j N1y .. j N1y +
    N1y - 1, its mirror strip (N2y - j) mod N2y), the canonical slots of
    each strip (a <= sigma(a): all of strip j < its mirror, the lower half of
    a strip that is its own mirror) cut into tiles of Cw adjacent slots, -1
    padding a strip's last tile. Returns (own, mirror), each (tiles, Cw)
    int32, mirror = sigma(own): Cw adjacent slots in reverse, or, in strip 0
    (lanes l <-> (N1y - l) mod N1y), off by one slot. A self-mirror slot
    (y-frequency 0 or P/2) is its own mirror."""
    n1y, n2y = split_factor(P)
    neg = negate_index(P)
    tiles = []
    for j in range(n2y):
        if j > (n2y - j) % n2y:
            continue
        slots = j * n1y + np.arange(n1y)
        slots = slots[slots <= neg[slots]]
        for k in range(0, len(slots), Cw):
            t = np.full(Cw, -1, np.int64)
            t[:len(slots[k:k + Cw])] = slots[k:k + Cw]
            tiles.append(t)
    own = np.stack(tiles)
    mirror = np.where(own >= 0, neg[np.maximum(own, 0)], -1)
    return own.astype(np.int32), mirror.astype(np.int32)


@functools.lru_cache(maxsize=8)
def _device_cluster_tiles(P: int, Cw: int, device: torch.device):
    return tuple(torch.as_tensor(t, device=device)
                 for t in x_symbols_cluster_tiles(P, Cw))


def x_symbols_cluster_rows(n2: int, G: int) -> tuple[np.ndarray, np.ndarray]:
    """K5's cluster ordering of the N2 k2 rows and its split over G blocks
    (csrc sym_k2_any and sym_unit_row; sym_k2 for a power of two): (k2 of
    each row i, each block's first row, G + 1 entries, the last N2). Row 0
    holds k2 = 0, for even N2 row 1 holds N2/2, then each pair m, N2 - m
    (m = 1, 2, ...) takes two rows side by side. The units, the rows {0, 1}
    (even N2) or {0} (odd N2) and each pair, U = ceil(N2 / 2) of them, split
    as block r owning units [floor(r U / G), floor((r + 1) U / G)), so that
    no pair straddles two blocks (x_dft_cluster_split's rule, on units): for
    a power of two block r owns the rows [r L2, (r + 1) L2), L2 = N2 / G."""
    odd = n2 & 1
    i = np.arange(n2)
    j = i + odd
    k2 = np.where(i == 0, 0, np.where(j == 1, n2 // 2,
                                      np.where(j & 1, n2 - (j >> 1), j >> 1)))
    u = np.arange(G + 1) * ((n2 + 1) // 2) // G
    return k2, np.where(u == 0, 0, 2 * u - odd)


def x_symbols_cluster_owner(n2: int, G: int) -> tuple[np.ndarray, ...]:
    """The mixed kernel's N2-entry owner map for stage A^-1's pull, by the
    CUDA source's formula (csrc x_symbols_tile): DIT position p holds k2 =
    rho[p] (y_dft_mixed_rho of y_dft_mixed_plan(N2); bitrev for a power of
    two), the row i of k2 in the ordering (x_symbols_cluster_rows) is in
    unit u = (i + N2 mod 2) // 2, which block b = ((u + 1) G - 1) // U owns.
    Returns (b, i's row in b's own tile, its row in b's mirror tile: the
    own-tile row plus b's row count), N2 entries each."""
    k2_of, start = x_symbols_cluster_rows(n2, G)
    row_of = np.empty(n2, np.int64)
    row_of[k2_of] = np.arange(n2)
    i = row_of[y_dft_mixed_rho(y_dft_mixed_plan(n2))]
    b = (((i + (n2 & 1)) // 2 + 1) * G - 1) // ((n2 + 1) // 2)
    local = i - start[b]
    return b, local, local + start[b + 1] - start[b]


def _sym_stage_emulated(M: int, P: int, consts, G: int, Cw: int, own, mir,
                        real: torch.dtype, read, buf: torch.Tensor,
                        gsl=None, companion: bool = False) -> torch.Tensor:
    """The symbol stage of K5's, K3's, K13's and K14's cluster kernels, for
    all tiles (dim 0) and blocks (dim 1) at once: item e of block r is
    column cc, row i of the ordering (block r's rows x_symbols_cluster_rows,
    at most L2 of them, items past its count skipped), k1; its partner row
    ip (k2 -> (N2 - k2) mod N2), k1p in the mirror tile, or in the own
    column for a self-mirror slot (or padding), whose lower row's item (s
    <= sp) takes both. ``read(s, sp, a, b, own_pos, mir_pos, self_, skip)``
    gives each item's (w, wn); V = A w + B conj(wn) goes to own_pos and Vn
    = A wn + B conj(w) to mir_pos of ``buf`` ((T, G, 128 bs), bs = 2 L2
    Cw, k1 at row bitrev7(k1), block r's own-tile rows in its first nr Cw
    columns, its mirror-tile rows in the next nr Cw), with symbol_stage's
    symbols in ``real`` precision at the y slots ``gsl`` (T, Cw) of the own
    columns (default: ``own``). A self-mirror slot's mirror column must
    hold zeros in ``buf`` (K5's kernel writes them there, K3's loads them).
    ``companion`` (K13): no column is its own mirror and only V is
    written."""
    gsl = own if gsl is None else gsl
    n2, l2 = M // _N1, x_symbols_cluster_layout(M, G, Cw).l2
    T, nb = own.shape[0], 2 * l2 * Cw
    n1y, n2y = split_factor(P)
    k2_of, start = (torch.as_tensor(t) for t in x_symbols_cluster_rows(n2, G))
    brb = _bitrev(7)
    _, _, inv_dx2, alpha2, a1, a2, b1, b2 = consts
    e = torch.arange(_N1 * l2 * Cw)
    cc, il, k1 = e % Cw, (e // Cw) % l2, e // (Cw * l2)
    r2, nr = start[:-1, None], (start[1:] - start[:-1])[:, None]   # (G, 1)
    valid = il < nr
    i = torch.clamp(r2 + il, max=n2 - 1)
    odd = n2 & 1
    ip = torch.where(i + odd < 2, i + odd, (i + odd) ^ 1) - odd
    k2, k2p = k2_of[i], k2_of[ip]
    k1p = torch.where(k2 == 0, (_N1 - k1) % _N1, _N1 - 1 - k1)
    s, sp = _N1 * k2 + k1, _N1 * k2p + k1p                   # (G, E)
    a, b = own[:, None, cc], mir[:, None, cc]                # (T, 1, E)
    self_ = (a == b) & (not companion)
    skip = (self_ & (s > sp)) | ~valid
    own_pos = torch.where(valid, brb[k1] * nb + il * Cw + cc, 0)
    mir_pos = torch.where(valid, brb[k1p] * nb + torch.where(self_, 0, nr * Cw)
                          + (ip - r2) * Cw + cc, 0)
    w, wn = read(s, sp, a, b, own_pos, mir_pos, self_, skip)
    kx = k2 + n2 * k1
    gs = gsl[:, None, cc]
    fy = torch.where(a >= 0, gs // n1y + n2y * (gs % n1y), 0)
    sx = torch.sin(np.pi * torch.minimum(kx, M - kx).to(real) / M)
    sy = torch.sin(np.pi * torch.minimum(fy, P - fy).to(real) / P)
    lam = (-4.0 * inv_dx2) * (sx * sx + sy * sy)
    at_zero = (kx == 0) & (fy == 0)
    inv1 = torch.where(at_zero, 0.0, 1.0 / torch.where(at_zero, 1.0, lam))
    inv2 = 1.0 / (lam + alpha2)

    def symbol(c1: complex, c2: complex) -> torch.Tensor:
        return torch.complex(c1.real * inv1 + c2.real * inv2,
                             c1.imag * inv1 + c2.imag * inv2)

    sa, sb = symbol(a1, a2), symbol(b1, b2)
    v = sa * w + sb * wn.conj()
    vn = sa * wn + sb * w.conj()
    tt, r = torch.arange(T)[:, None, None], torch.arange(G)[:, None]

    def put(mask, pos, val):
        mask = torch.broadcast_to(mask, (T, G, len(e)))
        idx = [torch.broadcast_to(x, mask.shape)[mask] for x in (tt, r, pos)]
        buf[idx[0], idx[1], idx[2]] = torch.broadcast_to(val, mask.shape)[mask]

    put(~skip, own_pos, v)
    if not companion:
        put(~skip, mir_pos, vn)
    return buf


def _sym_inverse_emulated(buf: torch.Tensor, own, mir, M: int, W: int,
                          G: int, Cw: int, own_only: bool = False):
    """K5's steps 2 and 3 (csrc sym_inverse_half, sym_inverse_mixed) on
    ``buf`` ((T, G, 128 bs), _sym_stage_emulated's) for all tiles and
    blocks at once: the 128-point inverse DIT (torch.fft from the
    bit-reversed rows), the pull of each block's n1 rows from every block's
    B through the owner map (x_symbols_cluster_owner) with conj(W_M^(n1
    k2)), the N2-point inverse DIT as the passes of y_dft_mixed_plan(N2)
    (_plan_passes_emulated; radix 2 throughout for a power of two) and the
    stores into W columns (``own_only``: of the own tile alone). Returns
    (out, stores): the complex (M, W) result and how many times each (row,
    column) was stored by an own tile (stores[0]) and by a mirror tile
    (stores[1])."""
    n2, l1 = M // _N1, _N1 // G
    T, nb = own.shape[0], 2 * x_symbols_cluster_layout(M, G, Cw).l2 * Cw
    wm = torch.as_tensor(np.exp(-2j * np.pi * np.arange(M) / M)).to(buf.dtype)
    brb = _bitrev(7)
    rho = torch.as_tensor(y_dft_mixed_rho(y_dft_mixed_plan(n2)))
    owner, own_row, mir_row = (torch.as_tensor(t)
                               for t in x_symbols_cluster_owner(n2, G))
    r = torch.arange(G)[:, None]
    # 2. Stage B^-1: row p holds k1 = bitrev7(p) in, row n1 natural out.
    buf = buf.reshape(T, G, _N1, nb)
    first = torch.fft.ifft(buf[:, :, brb], dim=2, norm="forward")
    # 3. Stage A^-1: block r's column a (tile g, n1, column col) at DIT
    # position p (k2 = rho[p]) from its owner's row of tile g.
    pa = torch.arange(n2)[:, None]
    fa = torch.arange(2 * l1 * Cw)[None, :]
    g, col = fa // (l1 * Cw), fa % Cw
    n1 = r[:, :, None] * l1 + (fa // Cw) % l1                # (G, 1, NA)
    kk = rho[pa]                                             # (n2, 1)
    bcol = torch.where(g == 0, own_row[pa], mir_row[pa]) * Cw + col
    pulled = first[:, owner[pa], n1, bcol] * wm[n1 * kk].conj()
    nat = _plan_passes_emulated(pulled.reshape(T * G, n2, -1), wm[::_N1],
                                True).reshape(pulled.shape) / M
    # nat[t, r, n2, a]: x row N1 n2 + n1, the slot of tile g's column col.
    slot = torch.where(g == 0, own[:, None, None, col[0]],
                       mir[:, None, None, col[0]])          # (T, 1, 1, NA)
    dup = (g == 1) & (slot == own[:, None, None, col[0]])
    ok = (slot >= 0) & ~dup & ((g == 0) | (not own_only))
    xrow = _N1 * torch.arange(n2)[None, None, :, None] + n1[None]
    ok, xrow, slot, g = (torch.broadcast_to(x, nat.shape)
                         for x in (ok, xrow, slot, g))
    out = torch.zeros((M, W), dtype=buf.dtype)
    out[xrow[ok], slot[ok]] = nat[ok]
    stores = torch.zeros((2, M, W), dtype=torch.int64)
    for h in (0, 1):
        _count(stores[h], ok & (g == h), xrow, slot)
    return out, stores


def _count(counter: torch.Tensor, mask, row, col) -> None:
    """Adds 1 to counter[row, col] wherever ``mask`` holds (broadcast)."""
    shape = np.broadcast_shapes(mask.shape, row.shape, col.shape)
    mask = torch.broadcast_to(mask, shape)
    row, col = (torch.broadcast_to(x, shape)[mask] for x in (row, col))
    counter.index_put_((row, col), torch.ones_like(row), accumulate=True)


def _cluster_tiles(P: int, Cw: int) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(t, dtype=torch.int64)
                 for t in x_symbols_cluster_tiles(P, Cw))


def x_symbols_cluster_emulated(W: torch.Tensor, consts, G: int, Cw: int):
    """What a K5 cluster kernel does at (G, Cw), for all tiles and blocks at
    once, in plain torch: each block's loads of its k2 rows (the ordering
    and split of x_symbols_cluster_rows) and their mirror rows with the
    symbol stage into buffer B (k1 at row bitrev7(k1); a self-mirror slot's
    lower rows load and write both rows of a pair), the 128-point inverse
    DIT (torch.fft from the bit-reversed rows), the pull of its n1 rows from
    every block's B through the owner map (x_symbols_cluster_owner) with
    conj(W_M^(n1 k2)), the N2-point inverse DIT as the passes of
    y_dft_mixed_plan(N2) with the kernel's weights and twiddles
    (_plan_passes_emulated) and the stores, with the CUDA source's index
    arithmetic; a power of two runs the same maps (radix 2 throughout, rho
    the bit reversal, an even split). The symbols are symbol_stage's formula
    in W's precision. Returns (out, loads, stores): x_symbols_inverse_plain's
    result and how many times each (row, slot) of the input was loaded and
    of the output stored."""
    _, M, P = W.shape
    if not x_symbols_cluster_takes(M, (G, Cw)):
        raise ValueError(f"K5's cluster kernels do not take M = {M} at "
                         f"G = {G}, Cw = {Cw}")
    c = torch.complex(W[0], W[1])
    own, mir = _cluster_tiles(P, Cw)
    loads = torch.zeros((M, P), dtype=torch.int64)

    def read(s, sp, a, b, own_pos, mir_pos, self_, skip):
        load_w = (a >= 0) & ~skip
        load_wn = (b >= 0) & ~skip & ~(self_ & (s == sp))
        zero = torch.zeros((), dtype=c.dtype)
        w = torch.where(load_w, c[s, a.clamp(min=0)], zero)
        wn = torch.where(load_wn, c[sp, b.clamp(min=0)],
                         torch.where(self_ & (s == sp), w, zero))
        _count(loads, load_w, s, a)
        _count(loads, load_wn, sp, b)
        return w, wn

    l2 = x_symbols_cluster_layout(M, G, Cw).l2
    buf = torch.zeros((own.shape[0], G, _N1 * 2 * l2 * Cw), dtype=c.dtype)
    buf = _sym_stage_emulated(M, P, consts, G, Cw, own, mir, W.dtype, read,
                              buf)
    out, stores = _sym_inverse_emulated(buf, own, mir, M, P, G, Cw)
    return _planar(out, W.dtype), loads, stores.sum(0)


@functools.lru_cache(maxsize=32)
def x_symbols_cluster_occupancy(M: int, layout: tuple, device: int) -> int:
    """The most clusters of K5's cluster layout = (G, Cw) at extent M that
    card ``device`` holds at once (cudaOccupancyMaxActiveClusters, the
    power-of-two or the mixed instance); 0: the layout cannot be
    scheduled."""
    G, Cw = layout
    n2 = M // _N1
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        fn = (_lib().qg_x_symbols_cluster_mixed_occupancy if _mixed(M) else
              _lib().qg_x_symbols_cluster_occupancy)
        code = fn(n2 if _mixed(M) else n2.bit_length() - 1,
                  G.bit_length() - 1, Cw.bit_length() - 1,
                  ctypes.byref(count))
    _build.check(code, f"x_symbols cluster occupancy {layout} at M = {M}")
    return count.value


def x_symbols_cluster(W: torch.Tensor, consts,
                      layout: tuple | None = None) -> torch.Tensor:
    """One launch of a K5 cluster kernel on a CUDA (2, M, P) float32
    spectrum, M = 128 * N2 (csrc x_symbols_cluster_kernel for N2 = 2^a,
    x_symbols_cluster_mixed_kernel, stage A^-1 over y_dft_mixed_plan(N2),
    for the other N2 <= 63), with ``layout`` = (G, Cw), by default
    x_symbols_cluster_launched(M): x_symbols_inverse's result. Raises on a
    shape or layout the kernel does not take, a layout the card cannot
    schedule and a launch error. Counts nothing: the counting wrapper is
    x_symbols_inverse.

    Replaces, as x_symbols_inverse_kernel does, tpu_qg/ops/pallas_fft.py
    PlanarFFT2._call_x_symbols (:1176) and _call_x_stream(Z, True, consts)
    (:1122). Bound: one read and one write of the field (1074 MB at
    8192^2, 0.321 ms at 3.35 TB/s; 151 MB at 3072^2, 0.045 ms). Why a
    cluster: x_symbols_inverse_kernel holds whole columns (64 KB each at M
    = 8192), so one slot pair fits a block and a warp moves 4-byte runs a
    row. Here the G blocks of a cluster share an own tile of Cw slots and
    its mirror tile, each block the symbol stage and stage B^-1 on its k2
    rows (each beside its mirror row), then its part of stage A^-1 pulled
    from its peers' shared memory (design in the source)."""
    _, M, P = W.shape
    layout = tuple(layout or x_symbols_cluster_launched(M))
    _cuda_field("x_symbols_cluster", W, x_kernels_take, M, P)
    if not x_symbols_cluster_takes(M, layout):
        raise ValueError(f"x_symbols_cluster: M = {M} must be 128 * N2 (N2 "
                         f"a power of two or 3 <= N2 <= 63) with ceil(N2 / "
                         f"2) >= G and the layout {layout} (G, Cw) fit "
                         f"shared memory")
    vals = check_consts("x_symbols_cluster", consts, M, P)
    G, Cw = layout
    device = W.device.index if W.device.index is not None else \
        torch.cuda.current_device()
    if x_symbols_cluster_occupancy(M, layout, device) == 0:
        raise RuntimeError(f"x_symbols_cluster: the card cannot schedule a "
                           f"cluster of layout {layout} at M = {M}")
    own, mirror = _device_cluster_tiles(P, Cw, W.device)
    out = torch.empty_like(W)
    n2 = M // _N1
    args = (W.data_ptr(), out.data_ptr(), own.data_ptr(), mirror.data_ptr(),
            own.shape[0], P)
    layout_args = (G.bit_length() - 1, Cw.bit_length() - 1,
                   split_factor(P)[0], vals)
    wm = _twiddles(M, M, W.device).data_ptr()
    stream = torch.cuda.current_stream(W.device).cuda_stream
    if _mixed(M):
        code = _lib().qg_x_symbols_cluster_mixed_launch(
            *args, n2, *layout_args, _packed_plan(n2), wm, stream)
    else:
        code = _lib().qg_x_symbols_cluster_launch(
            *args, n2.bit_length() - 1, *layout_args, wm, stream)
    _build.check(code, f"x_symbols_cluster (K5) {layout}")
    return out


def x_symbols_whole_columns(W: torch.Tensor, consts) -> torch.Tensor:
    """One launch of x_symbols_inverse_kernel (a block whole columns of C
    slot pairs) on a CUDA (2, M, P) float32 spectrum at any extent it takes:
    x_symbols_inverse's result. Raises on a shape it does not take and a
    launch error. Counts nothing: the counting wrapper is
    x_symbols_inverse."""
    _, M, P = W.shape
    _cuda_field("x_symbols_inverse", W, x_kernels_take, M, P)
    vals = check_consts("x_symbols_inverse", consts, M, P)
    C, sub, bstride, _ = x_symbols_layout(M)
    own, mirror = _device_tasks(P, C, W.device)
    out = torch.empty_like(W)
    logr, m, tw, twn = _tables(M, W.device)
    code = _lib().qg_x_symbols_launch(
        W.data_ptr(), out.data_ptr(), own.data_ptr(), mirror.data_ptr(),
        own.shape[0], M, P, logr, m, split_factor(M)[0], split_factor(P)[0],
        C, sub, bstride, vals, tw, twn, _threads(C, M),
        torch.cuda.current_stream(W.device).cuda_stream)
    _build.check(code, "x_symbols_inverse (K5)")
    return out


def x_symbols_inverse(W: torch.Tensor, consts) -> torch.Tensor:
    """K5 on CUDA tensors (one launch), the plain version on CPU tensors.
    Hand-written kernels chosen by shape, all counted in
    ``x_symbols_inverse.launches``: where x_symbols_cluster_takes(M) (M =
    128 * N2, ceil(N2 / 2) >= G of the launched layout
    x_symbols_cluster_launched(M)) a cluster kernel (x_symbols_cluster):
    x_symbols_cluster_kernel for a power of two, counted also in
    ``x_symbols_inverse.cluster_launches``, x_symbols_cluster_mixed_kernel
    for the other N2 <= 63, counted also in
    ``x_symbols_inverse.mixed_launches``; x_symbols_inverse_kernel
    (x_symbols_whole_columns) on the rest (smaller M)."""
    if W.device.type == "cpu":
        return x_symbols_inverse_plain(W, consts)
    M = W.shape[1]
    if x_symbols_cluster_takes(M):
        out = x_symbols_cluster(W, consts)
        if _mixed(M):
            x_symbols_inverse.mixed_launches += 1
        else:
            x_symbols_inverse.cluster_launches += 1
    else:
        out = x_symbols_whole_columns(W, consts)
    x_symbols_inverse.launches += 1
    return out


x_symbols_inverse.launches = 0
x_symbols_inverse.cluster_launches = 0
x_symbols_inverse.mixed_launches = 0


# K3's cluster kernels on M = 128 * N2 with U = ceil(N2 / 2) >= G (csrc
# pair_x_cluster_kernel for N2 = 2^a, pair_x_cluster_mixed_kernel for the
# other N2 <= 63): K4's cluster forward half (K4 mixed's for a mixed N2) in
# front of K5's cluster kernel (K5 mixed's), on K5's tile table
# (x_symbols_cluster_tiles), K5's k2 rows a block (x_symbols_cluster_rows)
# and K5's buffers, the spectrum kept in shared memory between them. The
# layout pair_x_symbols (and K7, stream_pair_symbols, at 4096 and 8192)
# launches, (G, Cw), is at each extent of PAIR_X_CLUSTER_BY_M the one of
# chip_smoke.py's k3_sweep (powers of two) or k3_mixed (mixed extents) with
# the least device time (PERF.md); else PAIR_X_CLUSTER, or
# PAIR_X_CLUSTER_SMALL at a mixed extent with U < 8 (G = 4 takes 896 ...
# 1792, G = 8 from 1920 on).
PAIR_X_CLUSTER_SIZES = X_SYMBOLS_CLUSTER_SIZES
PAIR_X_CLUSTER_WIDTHS = X_SYMBOLS_CLUSTER_WIDTHS
PAIR_X_CLUSTER = (8, 8)
PAIR_X_CLUSTER_SMALL = (4, 8)
PAIR_X_CLUSTER_BY_M = {1024: (4, 16), 1536: (4, 8), 1920: (4, 8),
                       2048: (8, 16), 2432: (4, 4), 4096: (8, 8),
                       8192: (16, 8)}


def pair_x_cluster_layout(M: int, G: int, Cw: int) -> SymbolsClusterLayout:
    """K3's cluster kernel's shared memory: K5's (x_symbols_cluster_layout),
    buffer B holding both tiles, buffer A one; a mixed N2 adds the
    N2-entry int map of stage B's pull (pair_x_cluster_pull)."""
    lay = x_symbols_cluster_layout(M, G, Cw)
    return lay._replace(smem=lay.smem + 4 * lay.n2) if _mixed(M) else lay


def pair_x_cluster_launched(M: int) -> tuple[int, int]:
    """The layout (G, Cw) pair_x_symbols launches at extent M."""
    if M in PAIR_X_CLUSTER_BY_M:
        return PAIR_X_CLUSTER_BY_M[M]
    if _mixed(M) and not pair_x_cluster_takes(M, PAIR_X_CLUSTER):
        return PAIR_X_CLUSTER_SMALL
    return PAIR_X_CLUSTER


def pair_x_cluster_takes(M: int, layout: tuple | None = None) -> bool:
    """True iff a K3 cluster kernel takes extent M at ``layout`` = (G, Cw)
    (by default the launched one): where K5's cluster kernels take it
    (x_symbols_cluster_takes: M = 128 * N2, N2 a power of two or 3 <= N2 <=
    63, with U = ceil(N2 / 2) >= G; N2 >= 2 G for a power of two), within
    one block's shared memory (pair_x_cluster_layout). So the mixed
    extents from 896 = 128 * 7 on are taken, and 384, 640 and 768 (U < 4)
    and the powers of two M < 256 G are not. The y extent does not matter:
    the tile table takes any."""
    G, Cw = layout or pair_x_cluster_launched(M)
    return (x_symbols_cluster_takes(M, (G, Cw))
            and pair_x_cluster_layout(M, G, Cw).smem <= SMEM_LIMIT)


def pair_x_cluster_pull(n2: int) -> np.ndarray:
    """The mixed kernel's N2-entry map k2 -> p of stage B's pull, by the
    CUDA source's formula (csrc pair_cluster_tile's kinv, kinv[rho[p]] =
    p): the row p of a peer's buffer A that holds k2 after stage A, rho =
    y_dft_mixed_rho(y_dft_mixed_plan(N2)) (the bit reversal for a power of
    two)."""
    kinv = np.empty(n2, np.int64)
    kinv[y_dft_mixed_rho(y_dft_mixed_plan(n2))] = np.arange(n2)
    return kinv


def pair_x_cluster_emulated(Zy: torch.Tensor, consts, G: int, Cw: int):
    """What a K3 cluster kernel does at (G, Cw), for all tiles and blocks at
    once, in plain torch (pair_cluster_emulated on the whole field with
    K5's tile table). Returns (out, loads, stores): pair_x_symbols_plain's
    result and how many times each (row, slot) of the input was loaded and
    of the output stored."""
    _, M, P = Zy.shape
    if not pair_x_cluster_takes(M, (G, Cw)):
        raise ValueError(f"K3's cluster kernels do not take M = {M} at "
                         f"G = {G}, Cw = {Cw}")
    own, mir = _cluster_tiles(P, Cw)
    out, loads, stores = pair_cluster_emulated(Zy, Zy, own, mir, own, P,
                                               consts, G, Cw, False)
    return out, loads[0], stores.sum(0)


def pair_cluster_emulated(X: torch.Tensor, Xm: torch.Tensor, own, mir, gsl,
                          P: int, consts, G: int, Cw: int, companion: bool):
    """What K3's cluster tile (csrc pair_cluster_tile) does at (G, Cw) on a
    (2, M, W) block of a y extent P, for all tiles and blocks at once, in
    plain torch, on the tile table ``own``, ``mir`` (local columns, -1
    padding) and ``gsl`` (each own column's global y slot): K4's cluster
    forward half on K5's rows (each block's loads of rows N1 n2 + n1 of its
    n1 into buffer A, a padding slot and, unless ``companion``, a
    self-mirror slot's mirror column reading zeros; the N2-point DIF as the
    passes of y_dft_mixed_plan(N2), _plan_passes_emulated, after which row
    p holds k2 = rho[p]; the pull of the k2 of its rows of the ordering
    (x_symbols_cluster_rows: its units' rows for a mixed N2) from every
    block's A at row pair_x_cluster_pull(N2)[k2] times W_M^(n1 k2); the
    128-point DIF into buffer B at K5's row stride 2 L2 Cw, k1 at row
    bitrev7(k1), the own tile's rows in the block's first nr Cw columns and
    the mirror tile's in the next nr Cw), then K5's symbol stage in place on
    B and K5's steps 2 and 3, with the CUDA source's index arithmetic; a
    power of two runs the same maps (radix 2 throughout, rho the bit
    reversal, an even split). The mirror tile is read from Xm with
    ``companion`` (K13: only the own tile stored), else from X. Returns
    (out, loads, stores): the planar result, how many times each (row,
    column) of X (loads[0]) and of Xm (loads[1]) was loaded, and how many
    times each of the output was stored by an own tile (stores[0]) and by a
    mirror tile (stores[1])."""
    _, M, W = X.shape
    n2, l1 = M // _N1, _N1 // G
    l2 = x_symbols_cluster_layout(M, G, Cw).l2      # the most rows a block owns
    na = l1 * Cw
    srcs = [torch.complex(X[0], X[1]), torch.complex(Xm[0], Xm[1])]
    wm = torch.as_tensor(np.exp(-2j * np.pi * np.arange(M) / M)).to(
        srcs[0].dtype)
    brb = _bitrev(7)
    k2_of, start = (torch.as_tensor(t) for t in x_symbols_cluster_rows(n2, G))
    nr = start[1:] - start[:-1]                                  # (G,)
    kinv = torch.as_tensor(pair_x_cluster_pull(n2))
    # Column b of a block's tile half: row start[r] + b // Cw, if it owns it.
    b = torch.arange(l2 * Cw)
    valid = (b // Cw)[None, :] < nr[:, None]                     # (G, l2 Cw)
    k2 = k2_of[torch.clamp(start[:-1, None] + b // Cw, max=n2 - 1)]
    rr, bb = valid.nonzero(as_tuple=True)
    T = own.shape[0]
    loads = torch.zeros((2, M, W), dtype=torch.int64)
    fwd = torch.zeros((T, G, _N1, 2 * l2 * Cw), dtype=srcs[0].dtype)
    for g, slots in enumerate((own, mir)):
        src = 1 if companion and g == 1 else 0
        c = srcs[src]
        # 1. Stage A: block r's A row n2, column a = (n1 - r1) Cw + col.
        col = torch.arange(na) % Cw
        n1 = torch.arange(G)[:, None] * l1 + torch.arange(na) // Cw  # (G, na)
        s = slots[:, col]                                            # (T, na)
        ok = s >= 0
        if g == 1 and not companion:
            ok &= s != own[:, col]
        rows = _N1 * torch.arange(n2)[:, None, None] + n1            # (n2, G, na)
        A = torch.where(ok[:, None, None, :],
                        c[rows[None], s.clamp(min=0)[:, None, None, :]],
                        torch.zeros((), dtype=c.dtype))              # (T, n2, G, na)
        _count(loads[src], ok[:, None, None, :], rows[None],
               s[:, None, None, :])
        A = _plan_passes_emulated(A.reshape(T, n2, G * na), wm[::_N1],
                                  False).reshape(T, n2, G, na)   # k2 = rho[p]
        # 2. Stage B: block r's B column b of this tile, row n1.
        n1 = torch.arange(_N1)[:, None, None]                        # (128, 1, 1)
        v = A[:, kinv[k2], n1 // l1, (n1 % l1) * Cw + b % Cw] * wm[n1 * k2]
        v = torch.fft.fft(v.permute(0, 2, 1, 3), dim=2)[:, :, brb]   # row p': bitrev7
        fwd[:, rr, :, g * nr[rr] * Cw + bb] = v[:, rr, :, bb]
    fwd = fwd.reshape(T, G, -1)

    # 3. The symbol stage in place: each item reads and writes its own two
    # words of B.
    def read(s, sp, a, b, own_pos, mir_pos, self_, skip):
        tt, rr = torch.arange(T)[:, None, None], torch.arange(G)[:, None]
        return fwd[tt, rr, own_pos], fwd[tt, rr, mir_pos]

    buf = _sym_stage_emulated(M, P, consts, G, Cw, own, mir, X.dtype, read,
                              fwd.clone(), gsl, companion)
    out, stores = _sym_inverse_emulated(buf, own, mir, M, W, G, Cw, companion)
    return _planar(out, X.dtype), loads, stores


@functools.lru_cache(maxsize=32)
def pair_x_cluster_occupancy(M: int, layout: tuple, device: int) -> int:
    """The most clusters of K3's cluster layout = (G, Cw) at extent M that
    card ``device`` holds at once (cudaOccupancyMaxActiveClusters, the
    power-of-two or the mixed instance); 0: the layout cannot be
    scheduled."""
    G, Cw = layout
    n2 = M // _N1
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        fn = (_lib().qg_pair_x_cluster_mixed_occupancy if _mixed(M) else
              _lib().qg_pair_x_cluster_occupancy)
        code = fn(n2 if _mixed(M) else n2.bit_length() - 1,
                  G.bit_length() - 1, Cw.bit_length() - 1,
                  ctypes.byref(count))
    _build.check(code, f"pair_x cluster occupancy {layout} at M = {M}")
    return count.value


def pair_x_cluster(Zy: torch.Tensor, consts,
                   layout: tuple | None = None) -> torch.Tensor:
    """One launch of a K3 cluster kernel on a CUDA (2, M, P) float32
    y-spectral field, M = 128 * N2 (csrc pair_x_cluster_kernel for N2 =
    2^a, pair_x_cluster_mixed_kernel, stages A and A^-1 over
    y_dft_mixed_plan(N2), for the other N2 <= 63), with ``layout`` = (G,
    Cw), by default pair_x_cluster_launched(M): pair_x_symbols's result.
    Raises on a shape or layout the kernel does not take, a layout the card
    cannot schedule and a launch error. Counts nothing: the counting
    wrapper is pair_x_symbols.

    Replaces, as pair_x_kernel does, tpu_qg/ops/pallas_fft.py
    PlanarFFT2.pair_x_symbols (:1270). Bound: one read and one write of the
    field (67 MB at 2048^2, 0.020 ms at 3.35 TB/s; 37.7 MB at 1536^2,
    0.0113 ms). Why a cluster: pair_x_kernel holds whole columns of C slot
    pairs (C = 4 at M = 2048), so a warp moves 16-byte runs a row, half a
    sector. Here the G blocks of a cluster share an own tile of Cw slots
    and its mirror tile: K4's cluster forward half into shared memory, K5's
    symbol stage there, and K5's cluster inverse half (design in the
    source)."""
    _, M, P = Zy.shape
    layout = tuple(layout or pair_x_cluster_launched(M))
    _cuda_field("pair_x_cluster", Zy, kernels_take, M, P)
    if not pair_x_cluster_takes(M, layout):
        raise ValueError(f"pair_x_cluster: M = {M} must be 128 * N2 (N2 a "
                         f"power of two or 3 <= N2 <= 63) with ceil(N2 / 2) "
                         f">= G and the layout {layout} (G, Cw) fit shared "
                         f"memory")
    vals = check_consts("pair_x_cluster", consts, M, P)
    G, Cw = layout
    device = Zy.device.index if Zy.device.index is not None else \
        torch.cuda.current_device()
    if pair_x_cluster_occupancy(M, layout, device) == 0:
        raise RuntimeError(f"pair_x_cluster: the card cannot schedule a "
                           f"cluster of layout {layout} at M = {M}")
    own, mirror = _device_cluster_tiles(P, Cw, Zy.device)
    out = torch.empty_like(Zy)
    n2 = M // _N1
    args = (Zy.data_ptr(), out.data_ptr(), own.data_ptr(), mirror.data_ptr(),
            own.shape[0], P)
    layout_args = (G.bit_length() - 1, Cw.bit_length() - 1,
                   split_factor(P)[0], vals)
    wm = _twiddles(M, M, Zy.device).data_ptr()
    stream = torch.cuda.current_stream(Zy.device).cuda_stream
    if _mixed(M):
        code = _lib().qg_pair_x_cluster_mixed_launch(
            *args, n2, *layout_args, _packed_plan(n2), wm, stream)
    else:
        code = _lib().qg_pair_x_cluster_launch(
            *args, n2.bit_length() - 1, *layout_args, wm, stream)
    _build.check(code, f"pair_x_cluster (K3) {layout}")
    return out


def pair_x_symbols(Zy: torch.Tensor, consts) -> torch.Tensor:
    """K3 on CUDA tensors (one launch), the plain version on CPU tensors.
    Hand-written kernels chosen by shape, all counted in
    ``pair_x_symbols.launches``: where pair_x_cluster_takes(M) (M = 128 *
    N2, ceil(N2 / 2) >= G of the launched layout pair_x_cluster_launched(M))
    a cluster kernel (pair_x_cluster): pair_x_cluster_kernel for a power of
    two, counted also in ``pair_x_symbols.cluster_launches``,
    pair_x_cluster_mixed_kernel for the other N2 <= 63, counted also in
    ``pair_x_symbols.mixed_launches``; pair_x_kernel (pair_x_whole_columns)
    on the rest (384, 640, 768 and M < 256 G)."""
    if Zy.device.type == "cpu":
        return pair_x_symbols_plain(Zy, consts)
    M = Zy.shape[1]
    if pair_x_cluster_takes(M):
        out = pair_x_cluster(Zy, consts)
        if _mixed(M):
            pair_x_symbols.mixed_launches += 1
        else:
            pair_x_symbols.cluster_launches += 1
    else:
        out = pair_x_whole_columns(Zy, consts)
    pair_x_symbols.launches += 1
    return out


pair_x_symbols.launches = 0
pair_x_symbols.cluster_launches = 0
pair_x_symbols.mixed_launches = 0


# ---------------------------------------------------------------------------
# K13, K7 and K14, the x-stages of the sharded inversions: K3's function on
# the columns of a (2, M, W) block. Kernels chosen by shape, as K3's: the
# block kernel (K13 and K14; csrc pair_cols_cluster_kernel on M = 128 *
# 2^a, pair_cols_cluster_mixed_kernel on the other M = 128 * N2, N2 <= 63)
# where K3's cluster kernels take M and W is whole 128-column strips, with
# K7 on K3's cluster kernels there; and pair_cols_kernel (K3's whole-column
# task on a table of (own column, its mirror's column, own column's global
# slot), C pairs a task, -1 padding) on the rest (384, 640, 768, M < 256
# G).
# ---------------------------------------------------------------------------

def _chunk_tasks(own, mirror, slots, C: int) -> tuple[np.ndarray, ...]:
    n = -(-len(own) // C) * C
    out = []
    for a in (own, mirror, slots):
        t = np.full(n, -1, np.int32)
        t[:len(a)] = a
        out.append(t.reshape(-1, C))
    return tuple(out)


def offset_tasks(width: int, strip_offset: int, C: int):
    """K13's table: every column of a block at ``strip_offset``, its mirror
    in the companion."""
    cols = np.arange(width)
    return _chunk_tasks(cols, companion_columns(block_strips(width,
                                                             strip_offset)),
                        STRIP * strip_offset + cols, C)


def self_tasks(P: int, C: int):
    """K7's table: every slot of the whole field, its mirror in the same
    field."""
    cols = np.arange(P)
    return _chunk_tasks(cols, negate_index(P), cols, C)


def paired_tasks(groups_idx, n2y: int, C: int):
    """K14's table: every unordered pair {c, mirror(c)} of the block's
    columns once, in ascending order of the smaller column (as K3's)."""
    idx = np.asarray(groups_idx)
    mirror = pair_columns(idx, n2y)
    cols = np.arange(len(mirror))
    own = cols[cols <= mirror]
    slots = STRIP * idx[own // STRIP] + own % STRIP
    return _chunk_tasks(own, mirror[own], slots, C)


def offset_cluster_tiles(width: int, strip_offset: int, Cw: int):
    """K13's cluster tile table: every column of a block of ``width``
    columns at global ``strip_offset`` in tiles of Cw adjacent columns, the
    mirror tile their companion columns (companion_columns: Cw adjacent
    columns in reverse, or in strip 0 off by one with lane 0 its own lane),
    and each own column's global y slot. Returns (own, mirror, slots), each
    (width / Cw, Cw) int32; no padding."""
    cols = np.arange(width)
    mirror = companion_columns(block_strips(width, strip_offset))
    return tuple(a.reshape(-1, Cw).astype(np.int32)
                 for a in (cols, mirror, STRIP * strip_offset + cols))


def paired_cluster_tiles(groups_idx, n2y: int, Cw: int):
    """K14's cluster tile table, as K3's x_symbols_cluster_tiles on the
    block's local columns: every unordered pair {c, mirror(c)}
    (pair_columns) once, strip by strip, the canonical columns of each strip
    (c <= mirror(c): all of the first strip of a mirror pair, the lower half
    of a strip that is its own mirror) cut into tiles of Cw adjacent
    columns, -1 padding a strip's last tile. Returns (own, mirror, slots),
    each (tiles, Cw) int32: mirror = mirror(own), slots each own column's
    global y slot. A self-mirror slot (lanes 0 and 64 of global strip 0) is
    its own mirror."""
    idx = np.asarray(groups_idx)
    mirror = pair_columns(idx, n2y)
    tiles = []
    for j in range(len(idx)):
        cols = j * STRIP + np.arange(STRIP)
        cols = cols[cols <= mirror[cols]]
        for k in range(0, len(cols), Cw):
            t = np.full(Cw, -1, np.int64)
            t[:len(cols[k:k + Cw])] = cols[k:k + Cw]
            tiles.append(t)
    own = np.stack(tiles)
    ok = own >= 0
    safe = np.maximum(own, 0)
    mir = np.where(ok, mirror[safe], -1)
    slots = np.where(ok, STRIP * idx[safe // STRIP] + safe % STRIP, -1)
    return tuple(a.astype(np.int32) for a in (own, mir, slots))


_COL_KERNELS = {"offset": "x_fwd_symbols_offset (K13)",
                "self": "stream_pair_symbols (K7)",
                "paired": "paired_x_symbols (K14)"}


@functools.lru_cache(maxsize=16)
def _device_col_tasks(kind: str, key: tuple, C: int, device: torch.device):
    build = {"offset": offset_tasks, "self": self_tasks,
             "paired": paired_tasks}[kind]
    return tuple(torch.as_tensor(t, device=device) for t in build(*key, C))


@functools.lru_cache(maxsize=16)
def _device_col_tiles(kind: str, key: tuple, Cw: int, device: torch.device):
    build = {"offset": offset_cluster_tiles,
             "paired": paired_cluster_tiles}[kind]
    return tuple(torch.as_tensor(t, device=device) for t in build(*key, Cw))


def _check_block(what: str, X: torch.Tensor, Xm: torch.Tensor, consts,
                 kind: str, key: tuple) -> tuple[int, int, int]:
    """(M, W, P) of a CUDA (2, M, W) block and its mirror operand; raises
    unless both are float32 planar fields of one shape on one card, W whole
    128-column strips of the y extent P = 128 consts[1], and an offset
    block within P."""
    if X.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {X.device}")
    _check_field(what, X)
    _check_field(what, Xm)
    _, M, W = X.shape
    P = STRIP * consts[1]
    if Xm.shape != X.shape or Xm.device != X.device:
        raise ValueError(f"{what}: the mirror operand has shape "
                         f"{tuple(Xm.shape)} on {Xm.device}, the block "
                         f"{tuple(X.shape)} on {X.device}")
    if W % STRIP or not 0 < W <= P:
        raise ValueError(f"{what}: the width {W} must be whole 128-column "
                         f"strips of P = {P}")
    if kind == "offset" and (key[0] != W or key[1] < 0
                             or STRIP * key[1] + W > P):
        raise ValueError(f"{what}: a block of {W} columns at strip offset "
                         f"{key[1]} does not lie within P = {P}")
    return M, W, P


def pair_cols_whole_columns(X: torch.Tensor, Xm: torch.Tensor, kind: str,
                            key: tuple, consts) -> torch.Tensor:
    """One launch of pair_cols_kernel (a block whole columns of C pairs) on
    the CUDA (2, M, W) block X, mirrors read from Xm, with the task table
    ``kind``/``key`` ("offset": K13, (W, strip_offset); "self": K7, (P,);
    "paired": K14, (groups_idx, n2y)), at any extent it takes: the result
    of the wrapper of ``kind``. Raises on a shape it does not take and a
    launch error. Counts nothing: the counting wrappers are
    x_fwd_symbols_offset, stream_pair_symbols and paired_x_symbols."""
    what = _COL_KERNELS[kind]
    M, W, P = _check_block(what, X, Xm, consts, kind, key)
    if not (_radix_ok(M) and pair_x_layout(M)[3] <= SMEM_LIMIT):
        raise ValueError(f"{what}: M = {M} must be R * m (R a power of two, "
                         f"m odd <= {MAX_ODD}) within shared memory")
    vals = check_consts(what, consts, M, P)
    C, sub, bstride, _ = pair_x_layout(M)
    own, mirror, slots = _device_col_tasks(kind, key, C, X.device)
    out = torch.empty_like(X)
    logr, m, tw, twn = _tables(M, X.device)
    code = _lib().qg_pair_cols_launch(
        X.data_ptr(), Xm.data_ptr(), out.data_ptr(), own.data_ptr(),
        mirror.data_ptr(), slots.data_ptr(), own.shape[0], M, W, P, logr, m,
        split_factor(P)[0], C, sub, bstride, int(kind != "paired"), vals, tw,
        twn, _threads(C, M), torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(code, what)
    return out


# K13's and K14's cluster kernel (csrc pair_cols_cluster_kernel, and its
# mixed instance pair_cols_cluster_mixed_kernel for a mixed N2): K3's
# cluster kernel on a tile table of the block's local columns
# (offset_cluster_tiles, paired_cluster_tiles), K3's layouts (G, Cw) and
# buffers beside the tile's Cw global slots. The layout K13 and K14 launch
# on a block (M, W) is, at the blocks of PAIR_COLS_CLUSTER_BY_MW (the
# four-rank slices'), the one of chip_smoke.py's k13_sweep with the least
# device time for the kernels swept there (PERF.md), else K3's launched
# layout at M
# (pair_x_cluster_launched).
PAIR_COLS_CLUSTER_BY_MW = {(2048, 512): (8, 16), (8192, 2048): (16, 8),
                           (3072, 768): (8, 8), (1536, 512): (4, 8)}


def pair_cols_cluster_layout(M: int, G: int, Cw: int) -> SymbolsClusterLayout:
    """The block kernel's shared memory: K3's (pair_x_cluster_layout; a
    mixed N2 adds K3 mixed's maps) and the tile's Cw int global slots."""
    lay = pair_x_cluster_layout(M, G, Cw)
    return lay._replace(smem=lay.smem + 4 * Cw)


def pair_cols_cluster_launched(M: int, W: int) -> tuple[int, int]:
    """The layout (G, Cw) that K13 and K14 launch on a (2, M, W) block."""
    return PAIR_COLS_CLUSTER_BY_MW.get((M, W), pair_x_cluster_launched(M))


@functools.lru_cache(maxsize=64)
def pair_cols_cluster_takes(M: int, W: int,
                            layout: tuple | None = None) -> bool:
    """True iff the block kernel takes a (2, M, W) block at ``layout`` = (G,
    Cw) (by default the launched one): where K3's cluster kernels take M
    (pair_x_cluster_takes: M = 128 * N2, N2 a power of two or 3 <= N2 <= 63,
    ceil(N2 / 2) >= G; so not 384, 640, 768 nor the powers of two M < 256
    G), W whole 128-column strips, within one block's shared memory.
    Cached: K13 and K14 ask twice a launch (see _cols_cluster_launch)."""
    G, Cw = layout or pair_cols_cluster_launched(M, W)
    return (pair_x_cluster_takes(M, (G, Cw))
            and W > 0 and W % STRIP == 0
            and pair_cols_cluster_layout(M, G, Cw).smem <= SMEM_LIMIT)


def pair_cols_cluster_emulated(kind: str, X: torch.Tensor, Xm: torch.Tensor,
                               key: tuple, consts, G: int, Cw: int):
    """What the block kernel does at (G, Cw) on the tile table of ``kind``
    ("offset": K13, key (W, strip_offset), the mirror tile from Xm, the own
    tile alone stored; "paired": K14, key (groups_idx, n2y), Xm = X), for
    all tiles and blocks at once, in plain torch (pair_cluster_emulated).
    Returns (out, loads, stores): x_fwd_symbols_offset_plain's or
    paired_x_symbols_plain's result, how many times each (row, column) of X
    and of Xm was loaded (2, M, W), and how many times each of the output
    was stored by an own tile and by a mirror tile (2, M, W)."""
    _, M, W = X.shape
    if not pair_cols_cluster_takes(M, W, (G, Cw)):
        raise ValueError(f"the block kernel does not take ({M}, {W}) at "
                         f"G = {G}, Cw = {Cw}")
    build = {"offset": offset_cluster_tiles,
             "paired": paired_cluster_tiles}[kind]
    own, mir, gsl = (torch.as_tensor(t, dtype=torch.int64)
                     for t in build(*key, Cw))
    return pair_cluster_emulated(X, Xm, own, mir, gsl, STRIP * consts[1],
                                 consts, G, Cw, kind == "offset")


@functools.lru_cache(maxsize=32)
def pair_cols_cluster_occupancy(M: int, layout: tuple, own_only: bool,
                                device: int) -> int:
    """The most clusters of the block kernel's K13 (``own_only``) or K14
    instance in ``layout`` = (G, Cw) at extent M (the power-of-two or the
    mixed instance) that card ``device`` holds at once
    (cudaOccupancyMaxActiveClusters); 0: the layout cannot be scheduled."""
    G, Cw = layout
    n2 = M // _N1
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        fn = (_lib().qg_pair_cols_cluster_mixed_occupancy if _mixed(M) else
              _lib().qg_pair_cols_cluster_occupancy)
        code = fn(n2 if _mixed(M) else n2.bit_length() - 1,
                  G.bit_length() - 1, Cw.bit_length() - 1, int(own_only),
                  ctypes.byref(count))
    _build.check(code, f"pair_cols cluster occupancy {layout} at M = {M}")
    return count.value


def pair_cols_cluster(X: torch.Tensor, Xm: torch.Tensor, kind: str,
                      key: tuple, consts,
                      layout: tuple | None = None) -> torch.Tensor:
    """One launch of the block kernel (csrc pair_cols_cluster_kernel for M
    = 128 * 2^a, pair_cols_cluster_mixed_kernel, stages A and A^-1 over
    y_dft_mixed_plan(N2), for the other M = 128 * N2, N2 <= 63) on the CUDA
    (2, M, W) float32 block X, with the tile table of
    ``kind`` ("offset": K13, key (W, strip_offset), mirrors from the
    companion Xm, own columns written; "paired": K14, key (groups_idx,
    n2y), Xm = X) and ``layout`` = (G, Cw), by default
    pair_cols_cluster_launched(M, W): the result of the wrapper of
    ``kind``. Raises on a shape or layout the kernel does not take, a layout
    the card cannot schedule and a launch error. Counts nothing: the
    counting wrappers are x_fwd_symbols_offset and paired_x_symbols.

    Replaces, as pair_cols_kernel does, tpu_qg/ops/pallas_fft.py
    PlanarFFT2._call_x_fwd_symbols_offset (:1204) and tpu_qg/parallel/
    paired.py PairedDistributedInverter._call_paired_kernel (:226). Bound:
    K13 reads two blocks and writes one (403 MB at (2, 8192, 2048), 0.120
    ms at 3.35 TB/s; 56.6 MB at (2, 3072, 768), 0.0169 ms), K14 reads one
    and writes one (12.6 MB at (2, 1536, 512), 0.0038 ms). Why a cluster:
    pair_cols_kernel holds whole columns (one slot pair a block at M =
    8192, a warp reading one scattered word a row) and transforms K13's
    mirror columns once per own column; here K3's cluster kernel runs on
    tiles of Cw adjacent local columns (design in the source)."""
    what = f"pair_cols_cluster ({_COL_KERNELS[kind]})"
    M, W, P = _check_block(what, X, Xm, consts, kind, key)
    layout = tuple(layout or pair_cols_cluster_launched(M, W))
    if not pair_cols_cluster_takes(M, W, layout):
        raise ValueError(f"{what}: M = {M} must be 128 * N2 (N2 a power of "
                         f"two or 3 <= N2 <= 63) with ceil(N2 / 2) >= G and "
                         f"the layout {layout} (G, Cw) fit shared memory")
    if kind == "paired" and Xm.data_ptr() != X.data_ptr():
        raise ValueError(f"{what}: the paired table reads mirrors from X")
    *_, args = _cols_cluster_launch(kind, key, M, W, P, layout, consts,
                                    X.device)
    out = torch.empty_like(X)
    fn = (_lib().qg_pair_cols_cluster_mixed_launch if _mixed(M) else
          _lib().qg_pair_cols_cluster_launch)
    code = fn(X.data_ptr(), Xm.data_ptr(), out.data_ptr(), *args,
              torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(code, f"{what} {layout}")
    return out


@functools.lru_cache(maxsize=16)
def _cols_cluster_launch(kind: str, key: tuple, M: int, W: int, P: int,
                         layout: tuple, consts, device: torch.device):
    """What a launch of the block kernel takes besides its operands and
    stream, built once a table, shape and layout: (the tile tables and
    the twiddle table on ``device``, held here so that their pointers stay
    valid; the launch's arguments from the tables' pointers on). Raises
    where consts were built for another shape or the card cannot schedule
    the layout. At (2, 2048, 512) the kernel takes ~0.04 ms on the card,
    about what a launch costs the host, so the host's work a launch is
    kept short."""
    what = f"pair_cols_cluster ({_COL_KERNELS[kind]})"
    vals = check_consts(what, consts, M, P)
    G, Cw = layout
    own_only = kind == "offset"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if pair_cols_cluster_occupancy(M, layout, own_only, index) == 0:
        raise RuntimeError(f"{what}: the card cannot schedule a cluster of "
                           f"layout {layout} at M = {M}")
    tables = _device_col_tiles(kind, key, Cw, device)
    wm = _twiddles(M, M, device)
    n2 = M // _N1
    mixed = _mixed(M)
    args = (*(t.data_ptr() for t in tables), tables[0].shape[0], W, P,
            n2 if mixed else n2.bit_length() - 1, G.bit_length() - 1,
            Cw.bit_length() - 1, split_factor(P)[0], int(own_only), vals,
            *((_packed_plan(n2),) if mixed else ()), wm.data_ptr())
    return tables, wm, args


def x_fwd_symbols_offset(Zy: torch.Tensor, Zm: torch.Tensor, consts,
                         strip_offset: int) -> torch.Tensor:
    """K13 on CUDA tensors (one launch), the plain version on CPU tensors:
    the sharded inversion's x-stage on a (2, M, w) column block of the
    y-spectrum at global ``strip_offset`` and its mirror companion Zm.
    Hand-written kernels chosen by shape: the block kernel
    (pair_cols_cluster, K3's cluster design, layout
    pair_cols_cluster_launched(M, w)) where pair_cols_cluster_takes(M, w),
    counted also in ``x_fwd_symbols_offset.cluster_launches`` and, its
    mixed instance (M = 128 * N2, N2 not a power of two), in
    ``x_fwd_symbols_offset.mixed_launches``; pair_cols_kernel
    (pair_cols_whole_columns) on the rest (384, 640, 768 and M < 256 G).
    All replace tpu_qg/ops/pallas_fft.py
    PlanarFFT2._call_x_fwd_symbols_offset (:1204)."""
    if Zy.device.type == "cpu":
        return x_fwd_symbols_offset_plain(Zy, Zm, consts, strip_offset)
    _, M, W = Zy.shape
    key = (W, int(strip_offset))
    if pair_cols_cluster_takes(M, W):
        out = pair_cols_cluster(Zy, Zm, "offset", key, consts)
        x_fwd_symbols_offset.cluster_launches += 1
        x_fwd_symbols_offset.mixed_launches += _mixed(M)
    else:
        out = pair_cols_whole_columns(Zy, Zm, "offset", key, consts)
    x_fwd_symbols_offset.launches += 1
    return out


x_fwd_symbols_offset.launches = 0
x_fwd_symbols_offset.cluster_launches = 0
x_fwd_symbols_offset.mixed_launches = 0


def stream_pair_cluster_takes(M: int) -> bool:
    """True iff K7 launches one of K3's cluster kernels at extent M
    (pair_x_cluster_takes(M): the powers of two M >= 256 G and the mixed
    extents 128 * N2 with ceil(N2 / 2) >= G); 384, 640, 768 and the smaller
    powers of two keep pair_cols_kernel."""
    return pair_x_cluster_takes(M)


def stream_pair_symbols(Zy: torch.Tensor, consts) -> torch.Tensor:
    """K7 on CUDA tensors (one launch), the plain version on CPU tensors.
    K7 computes K3's function on the whole field, so hand-written kernels
    chosen by shape: K3's cluster kernels (pair_x_cluster, layout
    pair_x_cluster_launched(M), K3's canonical tiles: each column read and
    written once) where stream_pair_cluster_takes(M), counted also in
    ``stream_pair_symbols.cluster_launches`` and, K3's mixed cluster kernel
    (M = 128 * N2, N2 not a power of two), in
    ``stream_pair_symbols.mixed_launches`` (not in pair_x_symbols's
    counts); pair_cols_kernel on the "self" table (pair_cols_whole_columns,
    the mirror read from the same field) on the rest (384, 640, 768 and M <
    256 G). All replace tpu_qg/ops/pallas_fft.py
    PlanarFFT2.stream_pair_symbols (:1304)."""
    if Zy.device.type == "cpu":
        return stream_pair_symbols_plain(Zy, consts)
    M = Zy.shape[1]
    if stream_pair_cluster_takes(M):
        out = pair_x_cluster(Zy, consts)
        stream_pair_symbols.cluster_launches += 1
        stream_pair_symbols.mixed_launches += _mixed(M)
    else:
        out = pair_cols_whole_columns(Zy, Zy, "self", (Zy.shape[2],), consts)
    stream_pair_symbols.launches += 1
    return out


stream_pair_symbols.launches = 0
stream_pair_symbols.cluster_launches = 0
stream_pair_symbols.mixed_launches = 0


def paired_x_symbols(X: torch.Tensor, groups_idx, consts) -> torch.Tensor:
    """K14 on CUDA tensors (one launch), the plain version on CPU tensors:
    the x-stage of a (2, M, w) block of strips in mirror-pair order whose
    global indices are ``groups_idx``. Hand-written kernels chosen by
    shape: the block kernel (pair_cols_cluster, layout
    pair_cols_cluster_launched(M, w)) where pair_cols_cluster_takes(M, w),
    counted also in ``paired_x_symbols.cluster_launches`` and, its mixed
    instance (M = 128 * N2, N2 not a power of two), in
    ``paired_x_symbols.mixed_launches``; pair_cols_kernel
    (pair_cols_whole_columns) on the rest (384, 640, 768 and M < 256 G).
    All replace tpu_qg/parallel/paired.py
    PairedDistributedInverter._call_paired_kernel (:226)."""
    if X.device.type == "cpu":
        return paired_x_symbols_plain(X, groups_idx, consts)
    key = (tuple(int(i) for i in np.asarray(groups_idx)), consts[1])
    if len(key[0]) * STRIP != X.shape[2]:
        raise ValueError(f"paired_x_symbols: {len(key[0])} strip indices "
                         f"for a block of {X.shape[2]} columns")
    if pair_cols_cluster_takes(X.shape[1], X.shape[2]):
        out = pair_cols_cluster(X, X, "paired", key, consts)
        paired_x_symbols.cluster_launches += 1
        paired_x_symbols.mixed_launches += _mixed(X.shape[1])
    else:
        out = pair_cols_whole_columns(X, X, "paired", key, consts)
    paired_x_symbols.launches += 1
    return out


paired_x_symbols.launches = 0
paired_x_symbols.cluster_launches = 0
paired_x_symbols.mixed_launches = 0


# ---------------------------------------------------------------------------
# The transform stages of the persistent one-launch kernels
# (csrc/coop_rows.cuh): K2's factored row groups and K3's cluster tile pairs
# in their separate kernels' launched layouts, 256-thread blocks. K16 runs
# them alone (mono_rows_plan); K15, K17 and K15's sharded form add K1's step
# units (step_kernel.coop_rows_plan).
# ---------------------------------------------------------------------------

COOP_ROWS_THREADS = 256      # csrc kRowsThreads


class RowsTransforms(NamedTuple):
    """The transform stages' part of a persistent kernel's plan (csrc
    RowsPlan): ``y`` its fields (N2, log2 Rb, the packed mixed plan or 0),
    ``x`` its x fields (N2, log2 G, log2 Cw, tile pairs, packed plan or 0;
    zeros without the x stage), ``n1y`` the y-spectrum's N1, the layouts
    ``y_layout`` K2's (Rb, threads) and ``x_layout`` K3's (G, Cw) or None,
    and ``smem`` the larger stage's bytes of shared memory."""
    y: tuple
    x: tuple
    n1y: int
    y_layout: tuple
    x_layout: tuple | None
    smem: int


@functools.lru_cache(maxsize=1024)
def coop_rows_transforms_shape(M: int, P: int, x_stage: bool) -> bool:
    """True iff K2's factored or mixed-radix kernel takes P in its
    256-thread layout and, with the x stage, K3's cluster or mixed cluster
    kernel takes M (each rule includes its block's shared memory)."""
    return (y_dft_factored_takes(P)
            and y_dft_factored_launched(P)[1] == COOP_ROWS_THREADS
            and (not x_stage or pair_x_cluster_takes(M)))


@functools.lru_cache(maxsize=256)
def coop_rows_transforms(M: int, P: int, x_stage: bool) -> RowsTransforms:
    """The transform stages at (M, P): K2's layout y_dft_factored_launched
    and, with the x stage, K3's pair_x_cluster_launched. Raises where
    coop_rows_transforms_shape refuses the shape."""
    if not coop_rows_transforms_shape(M, P, x_stage):
        raise ValueError(f"the persistent kernels' transform stages do not "
                         f"take ({M}, {P}) (x stage: {x_stage})")
    rb, threads = y_dft_factored_launched(P)
    n2y = P // _N1
    smem = y_dft_factored_layout(P, rb, threads).smem
    y = (n2y, rb.bit_length() - 1, _packed_plan(n2y) if _mixed(P) else 0)
    x, x_layout = (0, 0, 0, 0, 0), None
    if x_stage:
        G, Cw = pair_x_cluster_launched(M)
        n2x = M // _N1
        tiles = x_symbols_cluster_tiles(P, Cw)[0].shape[0]
        smem = max(smem, pair_x_cluster_layout(M, G, Cw).smem)
        x = (n2x, G.bit_length() - 1, Cw.bit_length() - 1, tiles,
             _packed_plan(n2x) if _mixed(M) else 0)
        x_layout = (G, Cw)
    return RowsTransforms(y, x, split_factor(P)[0], (rb, threads), x_layout,
                          smem)


def coop_rows_transforms_schedule(M: int, P: int, x_stage: bool,
                                  blocks: int, slab_rows: int = 0) -> dict:
    """The units the transform stages' loops run on ``blocks`` blocks, as
    csrc coop_rows.cuh's loops take them: "y" maps a block to its K2 row
    groups (group g by block g mod blocks); with ``slab_rows`` = H > 0,
    "y_slabs" maps a block to the units of K15's sharded first stage, the
    block's groups ("block", g), then each slab's as an H-row field ("top",
    k) and ("bot", k), unit u of that list by block u mod blocks; with the
    x stage, "x" maps a cluster (blocks // G of them) to its K3 tile pairs.
    Each "<stage>_units" lists the stage's units in launch order."""
    t = coop_rows_transforms(M, P, x_stage)
    rb = t.y_layout[0]
    units = list(range(-(-M // rb)))
    out = {"y": {b: units[b::blocks] for b in range(blocks)},
           "y_units": units}
    if slab_rows:
        slab = range(-(-slab_rows // rb))
        units = ([("block", g) for g in units] + [("top", k) for k in slab]
                 + [("bot", k) for k in slab])
        out["y_slabs"] = {b: units[b::blocks] for b in range(blocks)}
        out["y_slabs_units"] = units
    if x_stage:
        clusters = blocks // t.x_layout[0]
        tiles = list(range(t.x[3]))
        out["x"] = {k: tiles[k::clusters] for k in range(clusters)}
        out["x_units"] = tiles
    return out


def _rows_plan_array(lib, what: str, plan, stages: int | None
                     ) -> ctypes.Array:
    """``plan.ints`` (a RowsPlan) as the kernel's int table, its stage
    count replaced by ``stages`` where given."""
    if len(plan.ints) != lib.qg_coop_rows_plan_size():
        raise RuntimeError(f"{what}: plan does not match the compiled kernel")
    ints = plan.ints if stages is None else plan.ints[:-1] + (stages,)
    return (ctypes.c_int * len(ints))(*ints)


class MonoRowsPlan(NamedTuple):
    """K16's persistent plan: ``ints`` in RowsPlan order (R = 0: no step
    stage; 3 stages), K2's layout ``y`` (Rb, threads), K3's ``x`` (G, Cw)
    and bytes of shared memory for the larger stage."""
    ints: tuple
    y: tuple
    x: tuple
    smem: int


@functools.lru_cache(maxsize=256)
def mono_rows_plan(M: int, P: int) -> MonoRowsPlan:
    """K16's persistent plan at (M, P): K17's transform stages
    (coop_rows_transforms with the x stage), no step's rings. Raises where
    mono_rows_takes refuses the shape."""
    t = coop_rows_transforms(M, P, True)
    return MonoRowsPlan((M, P, 0, *t.y, *t.x, t.n1y, 3), t.y_layout,
                        t.x_layout, t.smem)


def mono_rows_takes(M: int, P: int, *tensors: torch.Tensor) -> bool:
    """True iff K16's persistent kernel takes (M, P) with these operands:
    K2's factored or mixed kernel at 256 threads and K3's cluster or mixed
    cluster kernel take the shape (coop_rows_shape(M, P, True) without the
    step's terms; of the mono route's squares, 128 .. 2176, it takes 896 ..
    2176), and every operand is 16-byte aligned; the first form keeps the
    rest."""
    return (coop_rows_transforms_shape(M, P, True)
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def mono_rows_emulated(z: torch.Tensor, consts) -> torch.Tensor:
    """What K16's persistent kernel computes, stage by stage, in plain
    torch with each stage's index maps: y_dft_factored_emulated forward,
    K3's cluster emulation in the x stage's layout (G, Cw), and
    y_dft_factored_emulated inverse."""
    _, M, P = z.shape
    x, _, _ = pair_x_cluster_emulated(y_dft_factored_emulated(z, False),
                                      consts, *mono_rows_plan(M, P).x)
    return y_dft_factored_emulated(x, True)


def mono_invert_rows(z: torch.Tensor, consts,
                     stages: int | None = None) -> torch.Tensor:
    """One launch of the persistent K16 (csrc coop_mono_rows_kernel) on a
    CUDA tensor, clustered by K3's G: forward-y by K2's factored body, the
    x stage by K3's cluster tile pairs in place, inverse-y in place, grid
    barriers between them. Returns psi: mono_invert's result. Raises on a
    shape or operand the kernel does not take (mono_rows_takes), on a layout
    with no resident cluster and on a launch the card refuses; counts
    nothing, records (blocks, clusters, blocks an SM) in
    ``mono_invert.rows_grid``. ``stages`` < 3 stops after that many stages
    (the y-spectrum of z (1) or the x stage's output (2)), to check a stage
    alone.

    Replaces ``tpu_qg/ops/pallas_fft.py:1342`` PlanarFFT2.mono_invert.
    Bound: two (2, M, P) fields (67 MB at 2048^2, 0.020 ms). Why: the first
    form runs the first stage bodies in 512-thread blocks and loses to the
    redesigned kernels it fuses (PERF.md)."""
    what = "mono_invert_rows (K16)"
    if z.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {z.device}")
    _check_field(what, z)
    _, M, P = z.shape
    if not mono_rows_takes(M, P, z):
        raise ValueError(f"{what}: ({M}, {P}) or its operand is not taken "
                         f"(mono_rows_takes)")
    lib = _lib()
    vals = check_consts(what, consts, M, P)
    plan = mono_rows_plan(M, P)
    own, mirror = _device_cluster_tiles(P, plan.x[1], z.device)
    out = torch.empty_like(z)
    info = (ctypes.c_int * 3)()
    code = lib.qg_mono_rows_launch(
        z.data_ptr(), out.data_ptr(),
        _rows_plan_array(lib, what, plan, stages), vals,
        _twiddles(P, P, z.device).data_ptr(),
        _twiddles(M, M, z.device).data_ptr(), own.data_ptr(),
        mirror.data_ptr(), plan.smem, info,
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(code, what)
    mono_invert.rows_grid = tuple(info)
    return out


# ---------------------------------------------------------------------------
# The first forms of the one-launch kernels K15-K17 and K15's sharded form
# (csrc/fused_kernels.cu): cooperative launches of 512-thread blocks whose
# stages reuse K2's row task, K3's mirror-pair task and K1's tile. Each runs
# only where its persistent kernel (csrc/coop_rows.cuh) does not take the
# shape or operands.
# ---------------------------------------------------------------------------

# Floats of step_tile's buffers (csrc kStepTileFloats) in K15 and K17: psi
# with a halo of 2, zeta and lap(psi) with a halo of 1 on a 32 x 64 tile,
# and a tile of layer-0 zeta_new.
STEP_TILE_FLOATS = (32 + 4) * (64 + 4) + 2 * (32 + 2) * (64 + 2) + 32 * 64
# A y task takes the most rows (a power of two <= 8) whose buffers fit the
# larger of this and the x-stage's buffers: 8 rows of 2048 points (135 KB).
_COOP_Y_TARGET = 136 * 1024


def y_rows_floats(P: int) -> int:
    """Floats of shared memory a row takes in a y task (csrc y_rows)."""
    R, m = radix_split(P)
    return 2 * m * _pad(R) + (2 * _pad(P) if m > 1 else 0)


def coop_plan(M: int, P: int, x_stage: bool) -> tuple[tuple[int, ...], int]:
    """A one-launch kernel's CoopPlan (csrc/fused_kernels.cu) and its bytes
    of dynamic shared memory: one buffer for the largest of a y task's rows,
    an x-stage task's columns (K3's layout) and the step's tiles, then the
    larger radix-2 table."""
    Ry, my = radix_split(P)
    Rx, mx = radix_split(M) if x_stage else (2, 1)
    row = y_rows_floats(P)
    table = max(Ry, Rx)                  # R/2 float2 of the larger table
    C, sub, bstride, seq, xdata, xtasks = 1, 0, 0, 0, 0, 0
    if x_stage:
        C, sub, bstride, _ = pair_x_layout(M)
        xdata = 4 * C * mx * sub + (4 * C * bstride if mx > 1 else 0)
        if mx > 1 and 4 * (xdata + table) > SMEM_LIMIT:
            # K5's layout: the own and the mirror group in turn.
            C, sub, bstride, _ = x_symbols_layout(M)
            seq, xdata = 1, 2 * C * mx * sub + 4 * C * bstride
        xtasks = pair_tasks(P, C)[0].shape[0]

    def data(rows: int) -> int:
        d = max(rows * row, xdata, STEP_TILE_FLOATS)
        return d + d % 2                  # the table is float2-aligned

    yrows = 8
    while yrows > 1 and (
            4 * yrows * row > max(4 * xdata, _COOP_Y_TARGET)
            or 4 * (data(yrows) + table) > SMEM_LIMIT):
        yrows //= 2
    plan = (M, P, Ry.bit_length() - 1, my, split_factor(P)[0], yrows,
            Rx.bit_length() - 1, mx, C, sub, bstride, seq, xtasks,
            data(yrows))
    return plan, 4 * (data(yrows) + table)


def coop_takes(M: int, P: int, x_stage: bool) -> bool:
    """True iff the one-launch kernels take an (M, P) field: P (and, with
    the x-stage, M) R * m with m <= MAX_ODD, and every stage's shared memory
    within one block's limit."""
    if not _radix_ok(P) or (x_stage and not _radix_ok(M)):
        return False
    return coop_plan(M, P, x_stage)[1] <= SMEM_LIMIT


def coop_launch_args(what: str, M: int, P: int, x_stage: bool,
                     device: torch.device) -> tuple:
    """(plan, smem, twiddle pointers y/y-join/x/x-join, task tensors own and
    mirror or None, info) for a one-launch kernel on ``device``; raises on
    a shape the kernels do not take."""
    if not coop_takes(M, P, x_stage):
        raise ValueError(f"{what}: ({M}, {P}) must each be R * m (R a power "
                         f"of two, m odd <= {MAX_ODD}) within shared memory")
    lib = _lib()
    plan, smem = coop_plan(M, P, x_stage)
    if len(plan) != lib.qg_coop_plan_size():
        raise RuntimeError(f"{what}: plan does not match the compiled kernel")
    _, _, twy, twny = _tables(P, device)
    twx = twnx = None
    tasks = (None, None)
    if x_stage:
        _, _, twx, twnx = _tables(M, device)
        tasks = _device_tasks(P, plan[8], device)
    return ((ctypes.c_int * len(plan))(*plan), smem, (twy, twny, twx, twnx),
            tasks, (ctypes.c_int * 2)())


def mono_invert_coop(z: torch.Tensor, consts) -> torch.Tensor:
    """One launch of K16's first form (csrc/fused_kernels.cu
    coop_mono_kernel: the first stage bodies in 512-thread blocks) on a
    CUDA tensor: mono_invert's kernel on the shapes and operands
    mono_rows_takes refuses. Counts nothing, records (blocks, blocks an SM)
    in ``mono_invert.grid``."""
    _, M, P = z.shape
    _cuda_field("mono_invert", z, lambda m, p: coop_takes(m, p, True), M, P)
    vals = check_consts("mono_invert", consts, M, P)
    plan, smem, tw, (own, mirror), info = coop_launch_args(
        "mono_invert", M, P, True, z.device)
    out = torch.empty_like(z)
    code = _lib().qg_mono_launch(
        z.data_ptr(), out.data_ptr(), plan, vals, *tw, own.data_ptr(),
        mirror.data_ptr(), smem, info,
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(code, "mono_invert (K16)")
    mono_invert.grid = tuple(info)
    return out


def mono_invert(z: torch.Tensor, consts) -> torch.Tensor:
    """K16 on CUDA tensors (one cooperative launch), the plain version on
    CPU tensors: packed natural-order (2, M, P) field -> psi. Two
    hand-written kernels chosen by shape and operand: the persistent
    cluster kernel on the redesigned stages (mono_invert_rows) where
    mono_rows_takes, counted also in ``mono_invert.rows_launches``; the
    first form (mono_invert_coop) on the rest."""
    if z.device.type == "cpu":
        return mono_invert_plain(z, consts)
    if (z.device.type == "cuda" and z.dim() == 3
            and mono_rows_takes(z.shape[1], z.shape[2], z)):
        out = mono_invert_rows(z, consts)
        mono_invert.rows_launches += 1
    else:
        out = mono_invert_coop(z, consts)
    mono_invert.launches += 1
    return out


mono_invert.launches = 0
mono_invert.rows_launches = 0
mono_invert.grid = None
mono_invert.rows_grid = None

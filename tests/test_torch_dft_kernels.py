"""K2, K3, K4 and K5 plain versions (tpu_qg_torch.ops.dft_kernels) against
the Pallas DFT kernels of tpu_qg in interpret mode, and against an
independent float64 numpy reference.

Shapes (256, 384) and (256, 512) for K2/K3, (256, 384) and (384, 512) for
K4/K5: at P = 256 every 128-slot strip is its own y-mirror, so only P > 256
exercises a real mirror pair of strips, and M = 384 a mixed x extent.
K4/K5 are held against both of the reference's x-kernel forms: the
BlockSpec one and the streaming one (K6) that it takes at M >= 4608.
Tolerances, relative to max|ref|: K2 and K4 1e-5 (float32 transforms of
length <= 512); K3 and K5 1e-4, the psi gate of the dryrun tolerances
(commit 26d1ffc) — the 1/lambda symbol amplifies low-k rounding; float64
reference 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops.pallas_fft import PlanarFFT2
from tpu_qg.ops.spectral import PackedModalInverterPallasFFT
from tpu_qg_torch.ops.dft_kernels import (pair_tasks, pair_x_symbols,
                                          pair_x_symbols_plain, x_dft,
                                          x_dft_plain, x_symbols_inverse,
                                          x_symbols_inverse_plain, y_dft,
                                          y_dft_plain)
from tpu_qg_torch.ops.matmul_fft import freq_order, negate_index
from tpu_qg_torch.ops.spectral import PackedModalInverterKernels

SHAPES = [(256, 384), (256, 512)]
X_SHAPES = [(256, 384), (384, 512)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _planar(M, P, seed):
    return np.random.default_rng(seed).standard_normal((2, M, P))


def _consts(M, P):
    cfg = tpu_qg.preset("turbulence-2048").replace(M=M, P=P)
    args = (M, P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())
    ours = PackedModalInverterKernels(*args)._sym_consts
    ref = PackedModalInverterPallasFFT(*args, interpret=True,
                                       pair_x=True)._sym_consts
    return ours, ref


@pytest.mark.parametrize("M,P", SHAPES)
@pytest.mark.parametrize("inverse", [False, True])
def test_y_dft_plain_matches_pallas(M, P, inverse):
    x = _planar(M, P, 0).astype(np.float32)
    want = PlanarFFT2(M, P, interpret=True)._call_y(jnp.asarray(x), inverse)
    _close(y_dft_plain(torch.from_numpy(x), inverse), want, 1e-5)


@pytest.mark.parametrize("M,P", SHAPES)
def test_pair_x_plain_matches_pallas(M, P):
    ours, ref = _consts(M, P)
    assert ours == ref
    x = _planar(M, P, 1).astype(np.float32)
    want = PlanarFFT2(M, P, interpret=True).pair_x_symbols(jnp.asarray(x), ref)
    _close(pair_x_symbols_plain(torch.from_numpy(x), ours), want, 1e-4)


@pytest.mark.parametrize("M,P", X_SHAPES)
@pytest.mark.parametrize("stream_x", [False, True], ids=["blockspec", "stream"])
def test_x_dft_plain_matches_pallas(M, P, stream_x):
    x = _planar(M, P, 4).astype(np.float32)
    pfft = PlanarFFT2(M, P, interpret=True, stream_x=stream_x)
    for inverse in (False, True):
        want = pfft._call_x(jnp.asarray(x), inverse)
        _close(x_dft_plain(torch.from_numpy(x), inverse), want, 1e-5)


@pytest.mark.parametrize("M,P", X_SHAPES)
@pytest.mark.parametrize("stream_x", [False, True], ids=["blockspec", "stream"])
def test_x_symbols_inverse_plain_matches_pallas(M, P, stream_x):
    ours, ref = _consts(M, P)
    x = _planar(M, P, 5).astype(np.float32)
    pfft = PlanarFFT2(M, P, interpret=True, stream_x=stream_x)
    want = pfft._call_x_symbols(jnp.asarray(x), ref)
    _close(x_symbols_inverse_plain(torch.from_numpy(x), ours), want, 1e-4)


@pytest.mark.parametrize("M,P", X_SHAPES)
@pytest.mark.parametrize("fused", [True, False],
                         ids=["four-pass", "four-pass-unfused"])
def test_four_pass_inverter_plain_matches_pallas(M, P, fused):
    """Both four-pass routes against the reference's PackedModalInverter-
    PallasFFT with pair_x=False; the unfused one (which the reference takes
    at 4224 <= M <= 4480) forced at a small M on both sides."""
    cfg = tpu_qg.preset("turbulence-2048").replace(M=M, P=P)
    args = (M, P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())
    zeta = _planar(M, P, 6).astype(np.float32)
    want = PackedModalInverterPallasFFT(
        *args, interpret=True, pair_x=False,
        fuse_symbols=fused)(jnp.asarray(zeta))
    inv = PackedModalInverterKernels(*args, pair_x=False)
    assert inv.route == "four-pass"
    if not fused:
        inv.route = "four-pass-unfused"
    _close(inv(torch.from_numpy(zeta)), want, 1e-4)


def _y_dft_numpy(x, inverse):
    P = x.shape[-1]
    c = x[0] + 1j * x[1]
    order = freq_order(P)
    if inverse:
        nat = np.empty_like(c)
        nat[:, order] = c
        out = np.fft.ifft(nat, axis=-1)
    else:
        out = np.fft.fft(c, axis=-1)[:, order]
    return np.stack([out.real, out.imag])


def _pair_x_numpy(Zy, consts):
    """ifft_x(A W + B conj(W(-k))) with the slot mirror found by search
    and the symbols in the subtractive float64 form 2cos - 2."""
    _, M, P = Zy.shape
    _, _, inv_dx2, alpha2, a1, a2, b1, b2 = consts
    W = np.fft.fft(Zy[0] + 1j * Zy[1], axis=0)
    fy = freq_order(P)
    slot_of = {f: s for s, f in enumerate(fy)}
    mirror = np.array([slot_of[(-f) % P] for f in fy])
    kx = np.arange(M)
    lam = inv_dx2 * ((2 * np.cos(2 * np.pi * kx / M) - 2)[:, None]
                     + (2 * np.cos(2 * np.pi * fy / P) - 2)[None, :])
    with np.errstate(divide="ignore"):
        inv1 = np.where(lam == 0, 0.0, 1.0 / lam)
    inv2 = 1.0 / (lam + alpha2)
    A, B = a1 * inv1 + a2 * inv2, b1 * inv1 + b2 * inv2
    Wn = W[(-kx) % M][:, mirror]
    v = np.fft.ifft(A * W + B * np.conj(Wn), axis=0)
    return np.stack([v.real, v.imag])


def _x_dft_numpy(x, inverse):
    return np.swapaxes(_y_dft_numpy(np.swapaxes(x, 1, 2), inverse), 1, 2)


def _x_symbols_numpy(W, consts):
    """ifft_x(A W + B conj(W(-k))) of a spectrum permuted on both axes,
    through natural order: the slot mirrors found by search, the symbols in
    the subtractive float64 form 2cos - 2."""
    nat = np.empty_like(W)
    nat[:, freq_order(W.shape[1])] = W
    # The pair-x reference takes the y-spectrum in natural x order, whose
    # forward x-transform is W in natural order.
    zy = np.fft.ifft(nat[0] + 1j * nat[1], axis=0)
    return _pair_x_numpy(np.stack([zy.real, zy.imag]), consts)


@pytest.mark.parametrize("M,P", X_SHAPES)
def test_x_plain_versions_match_float64_numpy(M, P):
    x = _planar(M, P, 7)
    for inverse in (False, True):
        _close(x_dft_plain(torch.from_numpy(x), inverse).numpy(),
               _x_dft_numpy(x, inverse), 1e-12)
    consts, _ = _consts(M, P)
    _close(x_symbols_inverse_plain(torch.from_numpy(x), consts).numpy(),
           _x_symbols_numpy(x, consts), 1e-12)


@pytest.mark.parametrize("M,P", SHAPES)
def test_plain_versions_match_float64_numpy(M, P):
    x = _planar(M, P, 2)
    for inverse in (False, True):
        _close(y_dft_plain(torch.from_numpy(x), inverse).numpy(),
               _y_dft_numpy(x, inverse), 1e-12)
    consts, _ = _consts(M, P)
    _close(pair_x_symbols_plain(torch.from_numpy(x), consts).numpy(),
           _pair_x_numpy(x, consts), 1e-12)


@pytest.mark.parametrize("P", [2, 8, 128, 256, 384, 512, 2048])
@pytest.mark.parametrize("C", [1, 4])
def test_pair_tasks_write_every_slot_once(P, C):
    own, mirror = pair_tasks(P, C)
    neg = negate_index(P)
    written = np.concatenate([own.ravel(), mirror[mirror != own].ravel()])
    written = written[written >= 0]
    assert sorted(written) == list(range(P))
    valid = own >= 0
    np.testing.assert_array_equal(mirror[valid], neg[own[valid]])
    np.testing.assert_array_equal(mirror[~valid], -1)


def test_wrappers_run_plain_on_cpu_without_counting():
    M, P = 256, 384
    x = torch.from_numpy(_planar(M, P, 3).astype(np.float32))
    consts, _ = _consts(M, P)
    wrappers = (y_dft, pair_x_symbols, x_dft, x_symbols_inverse)
    before = [w.launches for w in wrappers]
    for inverse in (False, True):
        torch.testing.assert_close(y_dft(x, inverse), y_dft_plain(x, inverse),
                                   rtol=0, atol=0)
        torch.testing.assert_close(x_dft(x, inverse), x_dft_plain(x, inverse),
                                   rtol=0, atol=0)
    torch.testing.assert_close(pair_x_symbols(x, consts),
                               pair_x_symbols_plain(x, consts), rtol=0, atol=0)
    torch.testing.assert_close(x_symbols_inverse(x, consts),
                               x_symbols_inverse_plain(x, consts),
                               rtol=0, atol=0)
    assert [w.launches for w in wrappers] == before

"""tpu_qg_torch.ops.spectral and matmul_fft conventions against tpu_qg in
float64 (<= 1e-12 relative to max|ref|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_qg.config import ModelConfig as JCfg
from tpu_qg.constants import KM
from tpu_qg.ops import matmul_fft as ref_mf
from tpu_qg.ops import spectral as ref
from tpu_qg_torch.ops import matmul_fft as ours_mf
from tpu_qg_torch.ops import spectral as ours

TOL = 1e-12
DX = 15625.0
S_EIG = -1.0 / (40.0 * KM) ** 2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _rhs(shape, seed=0):
    f = np.random.default_rng(seed).standard_normal(shape)
    return f - f.mean(axis=(-2, -1), keepdims=True)


@pytest.mark.parametrize("M,P", [(32, 48), (64, 64)])
@pytest.mark.parametrize("alpha,gauge", [(0.0, "zero_mean"), (0.0, "pin"),
                                         (S_EIG, "zero_mean")])
def test_helmholtz_solver_matches(M, P, alpha, gauge):
    f = _rhs((M, P))
    got = ours.HelmholtzSolver(M, P, DX, alpha, gauge=gauge)(torch.from_numpy(f))
    want = ref.HelmholtzSolver(M, P, DX, alpha, gauge=gauge)(jnp.asarray(f))
    _close(got, want)


@pytest.mark.parametrize("alphas", [(0.0,), (0.0, S_EIG)])
@pytest.mark.parametrize("gauge", ["zero_mean", "pin"])
def test_batched_modal_solver_matches(alphas, gauge):
    M, P = 32, 48
    f = _rhs((len(alphas), M, P), seed=1)
    got = ours.BatchedModalSolver(M, P, DX, alphas, gauge=gauge)(
        torch.from_numpy(f))
    want = ref.BatchedModalSolver(M, P, DX, alphas, gauge=gauge)(
        jnp.asarray(f))
    _close(got, want)


@pytest.mark.parametrize("M,P", [(32, 48), (64, 64)])
@pytest.mark.parametrize("compat", [True, False])
def test_packed_modal_inverter_matches(M, P, compat):
    cfg = JCfg(M=M, P=P, compat_reference_P=compat)
    z = np.random.default_rng(2).standard_normal((2, M, P))
    args = (M, P, DX, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())
    _close(ours.PackedModalInverter(*args)(torch.from_numpy(z)),
           ref.PackedModalInverter(*args)(jnp.asarray(z)))


def test_eigenvalues_and_one_shot_solves_match():
    M, P = 24, 40
    np.testing.assert_array_equal(
        ours.periodic_laplacian_eigenvalues(M, P, DX),
        ref.periodic_laplacian_eigenvalues(M, P, DX))
    f = _rhs((M, P), seed=3)
    _close(ours.solve_poisson(torch.from_numpy(f), DX, gauge="pin"),
           ref.solve_poisson(jnp.asarray(f), DX, gauge="pin"))
    _close(ours.solve_helmholtz(torch.from_numpy(f), DX, S_EIG),
           ref.solve_helmholtz(jnp.asarray(f), DX, S_EIG))


def test_solve_helmholtz_fn_matches():
    M, P = 16, 24
    L = M * DX

    def rhs(x, y):
        return np.sin(2 * np.pi * x / L) * np.cos(4 * np.pi * y / (P * DX))

    got = ours.solve_helmholtz_fn(M, P, DX, rhs, S_EIG,
                                  ours.RectangularDomain(0.0, L, 0.0, P * DX),
                                  device="cpu")
    want = ref.solve_helmholtz_fn(M, P, DX, rhs, S_EIG,
                                  ref.RectangularDomain(0.0, L, 0.0, P * DX))
    _close(got, want)


@pytest.mark.parametrize("N", [8, 96, 128, 256, 384, 512, 2048])
def test_permuted_order_conventions_match(N):
    assert ours_mf.split_factor(N) == ref_mf.split_factor(N)
    np.testing.assert_array_equal(ours_mf.freq_order(N), ref_mf.freq_order(N))
    for sign in (-1, 1):
        n2, n1 = ref_mf.split_factor(N)[1], ref_mf.split_factor(N)[0]
        np.testing.assert_array_equal(
            ours_mf._twiddle(n2, n1, sign, np.complex128),
            ref_mf._twiddle(n2, n1, sign, np.complex128))
        np.testing.assert_array_equal(ours_mf._dft(n2, sign, np.complex128),
                                      ref_mf._dft(n2, sign, np.complex128))
    x = np.random.default_rng(N).standard_normal((3, N))
    np.testing.assert_array_equal(
        ours_mf.negate_spectrum(torch.from_numpy(x)).numpy(),
        np.asarray(ref_mf.FactoredFFT(N).negate_spectrum(jnp.asarray(x))))

"""tpu_qg_torch's matmul-DFT tier (ops.matmul_fft's FactoredFFT and
MatmulFFT2, spectral.PackedModalInverterMXU, fft_impl="matmul" in QGModel)
against tpu_qg's on the same seeded numpy inputs: complex64 / float32
within 2e-5 of the largest value (tpu_qg's own tolerance,
tests/test_matmul_fft.py:94), complex128 / float64 within 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_qg.config import ModelConfig as JCfg
from tpu_qg.models.core import QGModel as JModel
from tpu_qg.ops import matmul_fft as ref_mf
from tpu_qg.ops import spectral as ref_spectral
import tpu_qg_torch
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.models import core
from tpu_qg_torch.ops import matmul_fft as ours_mf
from tpu_qg_torch.ops import spectral as ours_spectral

TOL = {np.complex64: 2e-5, np.complex128: 1e-12}
REAL = {np.complex64: np.float32, np.complex128: np.float64}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _randc(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("dim", [-1, -2])
@pytest.mark.parametrize("N", [16, 96, 128, 256])
def test_factored_fft_matches(N, dim, dtype):
    """forward, inverse and negate_spectrum along dim -1 or -2 on a batched
    field, the constants built in ``dtype`` on both sides."""
    shape = (2, 3, N) if dim == -1 else (2, N, 24)
    x = _randc(shape, dtype, seed=N - dim)
    ref, ours = ref_mf.FactoredFFT(N, dtype), ours_mf.FactoredFFT(N, dtype)
    X = ours.forward(torch.from_numpy(x), dim=dim)
    X_ref = ref.forward(jnp.asarray(x), axis=dim)
    _close(X, X_ref, TOL[dtype])
    _close(ours.inverse(X, dim=dim),
           ref.inverse(jnp.asarray(X.numpy()), axis=dim), TOL[dtype])
    np.testing.assert_array_equal(
        ours.negate_spectrum(X, dim=dim).numpy(),
        np.asarray(ref.negate_spectrum(jnp.asarray(X.numpy()), axis=dim)))


def test_factored_fft_is_the_permuted_dft():
    """The forward transform is numpy's DFT in freq_order's slots, and the
    inverse undoes it (complex128, 1e-12)."""
    N = 384
    x = _randc((N, 5), np.complex128, seed=1)
    f = ours_mf.FactoredFFT(N, np.complex128)
    X = f.forward(torch.from_numpy(x), dim=-2).numpy()
    _close(X, np.fft.fft(x, axis=0)[ours_mf.freq_order(N)], 1e-12)
    _close(f.inverse(torch.from_numpy(X), dim=-2).numpy(), x, 1e-12)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_matmul_fft2_matches(dtype):
    M, P = 256, 128
    x = _randc((M, P), dtype, seed=11)
    ref, ours = ref_mf.MatmulFFT2(M, P, dtype), ours_mf.MatmulFFT2(M, P,
                                                                   dtype)
    X = ours.forward(torch.from_numpy(x))
    _close(X, ref.forward(jnp.asarray(x)), TOL[dtype])
    _close(ours.inverse(X), ref.inverse(jnp.asarray(X.numpy())), TOL[dtype])
    np.testing.assert_array_equal(
        ours.negate_spectrum(X).numpy(),
        np.asarray(ref.negate_spectrum(jnp.asarray(X.numpy()))))
    assert ours_mf._cached_fft2(M, P) is ours_mf._cached_fft2(M, P)


def test_real_input_promotes_to_complex():
    """A real field is transformed as its complex promotion, as the
    reference's einsum promotes it."""
    x = np.random.default_rng(2).standard_normal((4, 256))
    f = ours_mf.FactoredFFT(256, np.complex128)
    np.testing.assert_array_equal(
        f.forward(torch.from_numpy(x)).numpy(),
        f.forward(torch.from_numpy(x.astype(np.complex128))).numpy())


@pytest.mark.parametrize("cdtype", [np.complex64, np.complex128])
def test_packed_inverter_mxu_matches(cdtype):
    """PackedModalInverterMXU at (2, 256, 128) against tpu_qg's, whose DFT
    constants are complex64 at either precision: the port casts them to the
    field's dtype, so float64 agrees to 1e-12."""
    dtype = REAL[cdtype]
    cfg = JCfg(M=256, P=128)
    args = (cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())
    zeta = np.random.default_rng(3).standard_normal((2, 256, 128)).astype(
        dtype)
    got = ours_spectral.PackedModalInverterMXU(*args)(torch.from_numpy(zeta))
    want = ref_spectral.PackedModalInverterMXU(*args)(jnp.asarray(zeta))
    _close(got, want, TOL[cdtype])


@pytest.mark.parametrize("setting", ["allow_tf32", "precision_high",
                                     "fp32_precision"])
def test_full_float32_matmul_restores_the_setting(setting):
    """The products run with TF32 off in cuBLAS, through either of torch's
    interfaces; the process's setting comes back and the result is the
    one without TF32."""
    flags = torch.backends.cuda.matmul
    x = torch.from_numpy(_randc((8, 512), np.complex64, seed=4))
    f = ours_mf.FactoredFFT(512)
    want = f.forward(x)
    try:
        if setting == "allow_tf32":
            flags.allow_tf32 = True
        elif setting == "precision_high":
            torch.set_float32_matmul_precision("high")
        else:
            flags.fp32_precision = "tf32"
        with ours_mf.full_float32_matmul():
            assert flags.fp32_precision == "ieee"
        assert flags.fp32_precision == "tf32"
        assert torch.equal(f.forward(x), want)
    finally:
        if setting == "fp32_precision":
            flags.fp32_precision = "ieee"
        else:
            torch.set_float32_matmul_precision("highest")
    assert not flags.allow_tf32


def _psi0(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return cfg.initial_kick * cfg.U * cfg.Ly * rng.random((2, cfg.M, cfg.P))


def test_model_matmul_tier_matches_tpu_qg_float64():
    """QGModel with fft_impl="matmul", float64 at 64^2, 20 steps, against
    tpu_qg's matmul tier: zeta within 1e-12."""
    jcfg = JCfg(M=64, P=64, dtype="float64", fft_impl="matmul")
    psi0 = _psi0(jcfg)
    jmodel = JModel(jcfg)
    want = jmodel.run(jmodel.init_state(psi_init=jnp.asarray(psi0)), 20)
    model = core.QGModel(config_from_jax(jcfg), device="cpu")
    got = model.run(model.init_state(psi_init=psi0), 20)
    _close(got.zeta.numpy(), np.asarray(want.zeta), 1e-12)
    _close(got.psi.numpy(), np.asarray(want.psi), 1e-12)


def test_matmul_tier_routing():
    """A pinned "matmul" builds PackedModalInverterMXU behind the step
    kernel's route (K1, then the matmul inversion, for float32 with
    use_pallas); "auto" never picks it; fft_mxu keeps no bearing on it."""
    cfg = tpu_qg_torch.preset("turbulence-2048").replace(M=256, P=256)
    for c in (cfg, cfg.replace(fft_impl="xla"), cfg.replace(use_pallas=False),
              cfg.replace(dtype="float64")):
        assert core.resolve_fft_impl(c) != "matmul"
    mm = cfg.replace(fft_impl="matmul")
    assert core.resolve_fft_impl(mm) == "matmul"
    assert core.use_step_kernel(mm)
    inv = core._build_solvers(mm)
    assert type(inv) is ours_spectral.PackedModalInverterMXU
    assert core.make_step_fn(mm).route == "default"
    assert core.make_chain_fns(mm.replace(step_chain="on")) is None
    assert core.resolve_fft_impl(mm.replace(fft_mxu="bf16x3")) == "matmul"


def test_model_matmul_tier_float32_step_kernel_route():
    """The float32 kernel route of the tier (K1's plain version on the CPU,
    then the matmul inversion) at 256^2 against tpu_qg's matmul tier after
    3 steps, within 2e-5 of max|zeta|."""
    jcfg = JCfg(M=256, P=256, dtype="float32", fft_impl="matmul",
                use_pallas=True)
    psi0 = _psi0(jcfg, seed=1).astype(np.float32)
    jmodel = JModel(jcfg)
    want = jmodel.run(jmodel.init_state(psi_init=jnp.asarray(psi0)), 3)
    model = core.QGModel(config_from_jax(jcfg), device="cpu")
    got = model.run(model.init_state(psi_init=psi0), 3)
    _close(got.zeta.numpy(), np.asarray(want.zeta), 2e-5)

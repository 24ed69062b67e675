"""K1's, K8's and K9's plain versions (tpu_qg_torch.ops.step_kernel
fused_step_plain, fused_pre_inversion_plain, fused_tendency_plain) against
the Pallas step kernels of tpu_qg in interpret mode, float32 at (256, 256)
(K9 also float64 at (128, 128)).

Tolerance 1e-6 relative to max|ref| in float32: the Pallas body groups the
stencil terms differently from the plain stencils (~5e-8 reassociation,
tpu_qg/ops/pallas_tendency.py:276-279), on top of float32 rounding; 1e-12
in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops.pallas_tendency import (_wind_rows, fused_pre_inversion,
                                        fused_step_pre_fft,
                                        fused_step_streamed)
from tpu_qg.ops.pallas_tendency import fused_tendency as j_fused_tendency
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.models.core import _tendencies, _wind_forcing
from tpu_qg_torch.ops import step_kernel
from tpu_qg_torch.ops.step_kernel import (fused_pre_inversion_plain, fused_step,
                                          fused_step_plain, fused_tendency,
                                          fused_tendency_plain)

TOL = 1e-6
M = P = 256


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(jcfg, seed=0):
    """zeta from a random psi (the model's own definition), history fields
    near the tendency's scale; float32 numpy."""
    rng = np.random.default_rng(seed)
    amp = jcfg.initial_kick * jcfg.U * jcfg.Ly
    psi = amp * rng.random((jcfg.n_layers, M, P))
    zeta = np.array(tpu_qg.init_state(jcfg, psi_init=psi).zeta)
    tend = _tendencies(config_from_jax(jcfg), torch.from_numpy(zeta),
                       torch.from_numpy(psi))
    scale = float(tend.abs().max())
    f1 = tend.numpy() + 0.1 * scale * rng.standard_normal(psi.shape)
    f2 = tend.numpy() + 0.1 * scale * rng.standard_normal(psi.shape)
    return [a.astype(np.float32) for a in (zeta, psi, f1, f2)]


CASES = [("euler_ab3", 0.0, 0), ("euler_ab3", 0.0, 5),
         ("leapfrog_ra", 0.1, 0), ("leapfrog_ra", 0.1, 3)]


def _compare(jax_fn, scheme, tau0, step, **kw):
    jcfg = tpu_qg.preset("turbulence-2048").replace(
        M=M, P=P, time_scheme=scheme, wind_tau0=tau0, dtype="float32")
    arrays = _inputs(jcfg)
    want = jax_fn(jcfg, *(jnp.asarray(a) for a in arrays), jnp.int32(step),
                  True, **kw)
    got = fused_step_plain(config_from_jax(jcfg),
                           *(torch.from_numpy(a) for a in arrays), step)
    for name, g, w in zip(("zeta_new", "carry"), got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("scheme,tau0,step", CASES)
def test_plain_matches_streamed_kernel_v4(scheme, tau0, step):
    # tile=128 gives a grid of 2: the double-buffered v4 path.
    _compare(lambda *a: fused_step_streamed(*a, 128), scheme, tau0, step)


@pytest.mark.parametrize("scheme,tau0,step", CASES[1:3])
def test_plain_matches_pre_fft_kernel_v3(scheme, tau0, step):
    _compare(lambda *a: fused_step_pre_fft(*a, 0), scheme, tau0, step)


@pytest.mark.parametrize("layers,gauge", [(1, "zero_mean"), (2, "pin")])
@pytest.mark.parametrize("scheme,tau0,step", CASES)
def test_pre_inversion_plain_matches_kernel_v2(layers, gauge, scheme, tau0,
                                               step):
    """(zeta_new, carry, modes); tile=128 gives a grid of 2."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(
        M=M, P=P, n_layers=layers, poisson_gauge=gauge, time_scheme=scheme,
        wind_tau0=tau0, dtype="float32")
    arrays = _inputs(jcfg, seed=layers)
    want = fused_pre_inversion(jcfg, *(jnp.asarray(a) for a in arrays),
                               jnp.int32(step), True, 128)
    got = fused_pre_inversion_plain(config_from_jax(jcfg),
                                    *(torch.from_numpy(a) for a in arrays),
                                    step)
    for name, g, w in zip(("zeta_new", "carry", "modes"), got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("layers,tau0", [(2, 0.0), (1, 0.1)])
def test_tendency_plain_matches_kernel_v1(dtype, layers, tau0):
    """K9 at (L, 128, 128): two layers, and one layer with the wind.
    tpu_qg's kernel builds the wind row in float32 whatever the field type
    (``_wind_rows``: f32 sin of the lane index, ~1e-7 relative to the row),
    so in float64 its row is swapped for the float64 one the plain version
    adds before the 1e-12 comparison."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(
        M=128, P=128, n_layers=layers, wind_tau0=tau0, dtype=dtype)
    rng = np.random.default_rng(layers)
    psi = (jcfg.initial_kick * jcfg.U * jcfg.Ly
           * rng.random((layers, 128, 128))).astype(dtype)
    zeta = np.array(tpu_qg.init_state(jcfg, psi_init=psi).zeta)
    want = np.asarray(j_fused_tendency(jcfg, jnp.asarray(zeta),
                                       jnp.asarray(psi), True))
    got = fused_tendency_plain(config_from_jax(jcfg), torch.from_numpy(zeta),
                               torch.from_numpy(psi))
    assert got.dtype == torch.from_numpy(psi).dtype
    if dtype == "float64" and tau0:
        want = (want - np.asarray(_wind_rows(jcfg, 128, 128))
                + _wind_forcing(config_from_jax(jcfg), torch.float64,
                                "cpu").numpy())
    tol = 1e-12 if dtype == "float64" else TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_tendency_wrapper_runs_plain_on_cpu_without_counting():
    jcfg = tpu_qg.preset("turbulence-2048").replace(M=M, P=P,
                                                    dtype="float32")
    cfg = config_from_jax(jcfg)
    z, p, _, _ = (torch.from_numpy(a) for a in _inputs(jcfg))
    before = fused_tendency.launches
    got = fused_tendency(cfg, z, p)
    assert fused_tendency.launches == before
    torch.testing.assert_close(got, _tendencies(cfg, z, p), rtol=0, atol=0)


def test_pre_inversion_wrapper_runs_plain_on_cpu_without_counting():
    jcfg = tpu_qg.preset("turbulence-2048").replace(
        M=M, P=P, poisson_gauge="pin", dtype="float32")
    cfg = config_from_jax(jcfg)
    z, p, f1, f2 = (torch.from_numpy(a) for a in _inputs(jcfg))
    before = step_kernel.fused_pre_inversion.launches
    got = step_kernel.fused_pre_inversion(cfg, z, p, f1, f2, 4)
    want = fused_pre_inversion_plain(cfg, z, p, f1, f2, 4)
    assert step_kernel.fused_pre_inversion.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_wrapper_runs_plain_on_cpu_without_counting():
    cfg = config_from_jax(tpu_qg.preset("two-layer-256").replace(
        dtype="float32"))
    z, p, f1, f2 = (torch.from_numpy(a) for a in _inputs(
        tpu_qg.preset("two-layer-256").replace(dtype="float32")))
    before = fused_step.launches
    got = fused_step(cfg, z, p, f1, f2, 4)
    want = fused_step_plain(cfg, z, p, f1, f2, 4)
    assert fused_step.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_kernel_constants_round_once_from_float64():
    cfg = config_from_jax(tpu_qg.preset("turbulence-2048"))
    consts = list(step_kernel._consts(cfg))
    assert consts[0] == np.float32(1.0 / cfg.dx ** 2)
    assert consts[4:6] == [np.float32(cfg.beta_1), np.float32(cfg.beta_2)]
    assert len(consts) == 14


def test_pre_inversion_constants_are_the_layers_own():
    """One layer steps with beta itself; P^-1 rounds once per entry."""
    cfg = config_from_jax(tpu_qg.preset("turbulence-2048"))
    one = list(step_kernel._consts(cfg.replace(n_layers=1)))
    assert one[4:6] == [np.float32(cfg.beta), 0.0]
    (q11, q12), (q21, q22) = cfg.P_inv_matrix()
    assert list(step_kernel._modal_consts(cfg)) == [
        np.float32(v) for v in (q11, q12, q21, q22)]

"""The one-launch forms against tpu_qg on the CPU: K16 (the inversion in one
launch), K17 (the step in one launch) and K15 (the y-fused chain's step),
each plain version fed the same numpy inputs as tpu_qg's Pallas kernel in
interpret mode; the chain end to end; the port's copies of the reference's
shape gates; and the one-launch kernels' shared-memory plans on every shape
those gates admit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.models import core as jcore
from tpu_qg.ops.pallas_fft import PlanarFFT2, mono_fits, symbol_inverse_fits
from tpu_qg.ops.pallas_fullstep import fullstep_fits, fullstep_supported
from tpu_qg.ops.pallas_fullstep import fused_step_full as j_fused_step_full
from tpu_qg.ops.pallas_tendency import (fused_step_streamed_yspec,
                                        yfused_supported)
import tpu_qg_torch
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.models import core
from tpu_qg_torch.ops import spectral
from tpu_qg_torch.ops.dft_kernels import (coop_takes, mono_invert_plain,
                                          y_dft_plain)
from tpu_qg_torch.ops.step_kernel import (fused_step_full_plain,
                                          fused_step_yspec_plain,
                                          packed_symbol_consts)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jcfg(M, P, **kw):
    return tpu_qg.preset("turbulence-2048").replace(M=M, P=P, **kw)


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def _close_inversion(got, want, f64, what=""):
    """A float32 inversion held against tpu_qg's kernel and against float64.
    The plain version (torch.fft) and tpu_qg's matmul DFT in interpret mode
    are two float32 algorithms whose rounding 1/lambda amplifies at low k,
    and the interpret-mode kernel is the less accurate of the two against
    float64. So the plain version must agree with tpu_qg to 1e-5 and with
    float64 to 1e-6."""
    _close(got, want, 1e-5, what + " vs tpu_qg")
    _close(got, f64, 1e-6, what + " vs float64")


def _step_inputs(jcfg, seed):
    """float32 (zeta, psi, f1, f2) of a grid-noise psi, with histories near
    the tendency's scale, as numpy arrays."""
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((2, jcfg.M, jcfg.P)) * 1e-4
    s = tpu_qg.init_state(jcfg, psi_init=psi.astype(np.float32))
    zeta = np.asarray(s.zeta, np.float32)
    scale = np.abs(zeta).max() / jcfg.dt * 1e-3
    f1, f2 = (scale * rng.standard_normal(zeta.shape) for _ in range(2))
    return (zeta, np.asarray(s.psi, np.float32), f1.astype(np.float32),
            f2.astype(np.float32))


@pytest.mark.parametrize("M,P", [(256, 256), (256, 384), (128, 512)])
def test_mono_invert_plain_matches_pallas(M, P):
    """K16's plain version (K2 -> K3 -> K2^-1 plain) against tpu_qg's
    one-launch inversion kernel, including an odd strip count (P = 384) and
    M != P (tolerances in _close_inversion)."""
    jcfg = _jcfg(M, P)
    consts = packed_symbol_consts(config_from_jax(jcfg))
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, M, P)).astype(np.float32))
    want = PlanarFFT2(M, P, interpret=True).mono_invert(jnp.asarray(z.numpy()),
                                                        consts)
    _close_inversion(mono_invert_plain(z, consts), want,
                     mono_invert_plain(z.double(), consts))


@pytest.mark.parametrize("M,P,scheme", [
    (256, 256, "euler_ab3"), (256, 256, "leapfrog_ra"),
    (384, 256, "euler_ab3")])
def test_fused_step_full_plain_matches_pallas(M, P, scheme):
    """K17's plain version against tpu_qg's one-launch step kernel over 3
    steps (the Euler start, then AB3 or leapfrog), with wind, both advanced
    from tpu_qg's outputs: zeta_new and carry to 2e-6 of their max
    (tests/test_fullstep.py), psi_new as an inversion (_close_inversion)."""
    jcfg = _jcfg(M, P, time_scheme=scheme, wind_tau0=0.05)
    cfg = config_from_jax(jcfg)
    zeta, psi, f1, f2 = _step_inputs(jcfg, seed=1)
    for step in range(3):
        want = j_fused_step_full(jcfg, jnp.asarray(zeta), jnp.asarray(psi),
                                 jnp.asarray(f1), jnp.asarray(f2), step,
                                 "highest", True)
        ins = [torch.from_numpy(a.copy()) for a in (zeta, psi, f1, f2)]
        got = fused_step_full_plain(cfg, *ins, step)
        for name, g, w in zip(("zeta_new", "carry"), got, want):
            _close(g, w, 2e-6, f"{name} step {step}")
        f64 = fused_step_full_plain(cfg, *(t.double() for t in ins), step)
        _close_inversion(got[2], want[2], f64[2], f"psi_new step {step}")
        zeta, carry, psi = (np.asarray(w) for w in want)
        f1, f2 = (carry, f2) if scheme == "leapfrog_ra" else (carry, f1)


@pytest.mark.parametrize("M,P", [(256, 256), (256, 384)])
@pytest.mark.parametrize("scheme", ["euler_ab3", "leapfrog_ra"])
def test_fused_step_yspec_plain_matches_pallas(M, P, scheme):
    """K15's plain version against tpu_qg's y-fused step kernel, with wind,
    at the Euler start and past it: zeta_new and carry 2e-6, zeta_ys 1e-5 of
    their max (the y-DFT's float32 rounding, as K2's gate)."""
    jcfg = _jcfg(M, P, time_scheme=scheme, wind_tau0=0.1)
    cfg = config_from_jax(jcfg)
    zeta, psi, f1, f2 = _step_inputs(jcfg, seed=2)
    psi_ys = y_dft_plain(torch.from_numpy(psi.copy()), False).numpy()
    for step in (0, 5):
        want = fused_step_streamed_yspec(
            jcfg, jnp.asarray(zeta), jnp.asarray(psi_ys), jnp.asarray(f1),
            jnp.asarray(f2), step, "highest", True)
        got = fused_step_yspec_plain(cfg, *(torch.from_numpy(a.copy()) for a
                                            in (zeta, psi_ys, f1, f2)), step)
        for name, g, w, tol in zip(("zeta_new", "carry", "zeta_ys"), got,
                                   want, (2e-6, 2e-6, 1e-5)):
            _close(g, w, tol, f"{name} step {step}")


def test_chain_matches_tpu_qg_chain():
    """QGModel(step_chain="on") on the CPU (K15 -> K3 plain, psi y-spectral
    between steps, one K2 at each end) against tpu_qg's make_chain_fns in
    interpret mode, 10 steps: zeta 1e-5, psi 2e-4; run_trajectory samples
    natural psi and ends where run does."""
    jcfg = _jcfg(256, 256, step_chain="on")
    psi0 = np.random.default_rng(3).random((2, 256, 256)) * (
        jcfg.initial_kick * jcfg.U * jcfg.Ly)
    ti, st, te = jcore.make_chain_fns(jcfg, interpret=True)
    js = ti(tpu_qg.init_state(jcfg, psi_init=psi0))
    for _ in range(10):
        js = st(js)
    want = te(js)
    model = tpu_qg_torch.QGModel(config_from_jax(jcfg), device="cpu")
    assert model.route == "chain"
    state0 = model.init_state(psi_init=psi0)
    got = model.run(state0, 10)
    assert got.step == 10
    _close(got.zeta, want.zeta, 1e-5, "zeta")
    _close(got.psi, want.psi, 2e-4, "psi")
    final, zs, ps = model.run_trajectory(state0, 10, 5)
    assert zs.shape == (2, 2, 256, 256) and final.step == 10
    torch.testing.assert_close(final.psi, got.psi, rtol=0, atol=0)
    torch.testing.assert_close(ps[-1], got.psi, rtol=0, atol=0)


def test_chain_internal_form_round_trip():
    """to_external(to_internal(state)) is the identity up to float32
    transform rounding, and the internal psi is the permuted y-spectrum of
    the packed psi_1 + i psi_2, as tpu_qg's (tests/test_chain.py:69-88)."""
    jcfg = _jcfg(256, 256, step_chain="on")
    cfg = config_from_jax(jcfg)
    state0 = core.init_state(cfg, "cpu")
    ti, _, te = core.make_chain_fns(cfg)
    internal = ti(state0)
    psi0 = state0.psi.numpy()
    _close(te(internal).psi, psi0, 1e-6)
    from tpu_qg_torch.ops.matmul_fft import freq_order
    want = np.fft.fft(psi0[0] + 1j * psi0[1], axis=1)[:, freq_order(cfg.P)]
    _close(internal.psi[0].numpy() + 1j * internal.psi[1].numpy(), want, 3e-5)
    jti, _, _ = jcore.make_chain_fns(jcfg, interpret=True)
    jint = jti(tpu_qg.init_state(jcfg, psi_init=psi0))
    _close(internal.psi, jint.psi, 3e-5)


SIZES = [128 * n for n in (1, 2, 3, 8, 16, 17, 19, 20, 24, 32, 33, 35, 43,
                           45, 53, 59, 63, 64)]


@pytest.mark.parametrize("gate", ["mono", "fullstep", "yfused"])
def test_gates_match_the_reference(gate):
    """The port's copies of tpu_qg's shape gates equal tpu_qg's over every
    128 * n pair of a sample up to 8192 on both axes."""
    f32 = jnp.float32
    for M in SIZES:
        for P in SIZES:
            cfg = _jcfg(M, P)
            if gate == "mono":
                got, want = spectral.reference_mono(M, P), mono_fits(M, P)
            elif gate == "fullstep":
                got, want = spectral.reference_fullstep(M, P), fullstep_fits(
                    M, P)
                assert core.fullstep_supported(config_from_jax(cfg)) == (
                    fullstep_supported(cfg, f32)), (M, P)
            else:
                got = core.yfused_supported(config_from_jax(cfg))
                want = yfused_supported(cfg, f32)
            assert got == want, (gate, M, P)


def test_one_launch_kernels_take_every_shape_the_gates_admit():
    """K16 and K17 (with the x-stage) and K15 (without) have a shared-memory
    plan within one block's limit on every 128 * n square up to 8192 and
    every sampled rectangle that the reference's gates admit."""
    sizes = range(128, 128 * 64 + 1, 128)
    shapes = [(n, n) for n in sizes] + [(M, P) for M in SIZES for P in SIZES]
    for M, P in shapes:
        if spectral.reference_mono(M, P) and symbol_inverse_fits(M, P):
            assert coop_takes(M, P, True), ("mono", M, P)
        if spectral.reference_fullstep(M, P):
            assert coop_takes(M, P, True), ("fullstep", M, P)
        if spectral.reference_yfused(M, P):
            assert coop_takes(M, P, False), ("yfused", M, P)

"""The counterpart of tpu_qg's multi-chip dry run (__graft_entry__.py
dryrun_multichip(8)) for tpu_qg_torch.parallel: eight gloo ranks of the CPU
in one spawn, each sharded route held against tpu_qg's single-device
per-mode float32 trajectory with the dry run's gates, and the distributed
inverters against tpu_qg's single-device fused inversion.

  * the default mesh of 8 ranks, (2, 4), the generic route: zeta 1e-6,
    psi 1e-4;
  * the gspmd step (DTensor, parallel.gspmd) on the same config and mesh:
    zeta 1e-6, psi 1e-4 (__graft_entry__.py:82-88);
  * the fused (8, 1) step (companion inverter, K13): zeta 1e-5, psi 1e-4;
  * the sharded chain on (8, 1): zeta 1e-5, psi 2e-4;
  * the companion and the paired (K14) inversions of a grid-noise zeta
    against the single-device inversion on the same kernels (the port's,
    plain versions), 1e-6 as the dry run holds tpu_qg's; and against
    tpu_qg's single-device fused inversion by the float64 rule: the port's
    error against a float64 inversion no more than twice tpu_qg's (two
    float32 algorithms, torch.fft and tpu_qg's matmul DFT, differ there by
    the rounding 1/lambda lifts at low k, ~5e-5 of max|psi|);
  * the fused 2-D step on (4, 2): zeta 1e-5, psi 5e-5;
  * the distributed multigrid inversion of the (2, 4) config's initial
    zeta, 10 cycles on (2, 4), against tpu_qg's single-device spectral
    inversion: psi 1e-5."""

import jax
import numpy as np
import pytest
import torch

from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM, MINUTES
from tpu_qg.models.core import (_build_solvers, _invert_psi, init_state,
                                make_step_fn)
from tpu_qg.ops.spectral import PackedModalInverterPallasFFT
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.ops.spectral import (PackedModalInverter,
                                       PackedModalInverterKernels)

import torch_parallel_ranks as ranks

N = 8


def _cfg(M, P):
    return ModelConfig(M=M, P=P, Lx=4000.0 * KM, Ly=4000.0 * KM,
                       dt=15.0 * MINUTES, T=15.0 * MINUTES, dtype="float32")


GENERIC = _cfg(32 * 2 * 4, 32 * 4)          # the dry run's (2, 4) config
FUSED = _cfg(32 * N, 128 * N)
PAIRED = _cfg(32 * N, 256 * N)
FUSED_2D = _cfg(256, 128 * N)
STEPS = 2


def _psi0(cfg):
    return np.asarray(init_state(cfg, key=jax.random.PRNGKey(0)).psi)


def _reference(cfg):
    step = jax.jit(make_step_fn(cfg, batched_fft=False))
    s = init_state(cfg, key=jax.random.PRNGKey(0))
    for _ in range(STEPS):
        s = step(s)
    return np.asarray(s.zeta), np.asarray(s.psi)


def _zeta_in():
    """The dry run's input to the inversions: the zeta of the chain's
    second step, here tpu_qg's single-device one."""
    return _reference(FUSED)[0]


def _generic_zeta():
    return np.asarray(init_state(GENERIC, key=jax.random.PRNGKey(0)).zeta)


STEP_CASES = {
    "default mesh (2, 4) generic": (GENERIC, None, {}, "generic",
                                    {"zeta": 1e-6, "psi": 1e-4}),
    "gspmd (2, 4)": (GENERIC, (2, 4), dict(gspmd=True), "gspmd",
                     {"zeta": 1e-6, "psi": 1e-4}),
    "fused (8, 1)": (FUSED, (N, 1), dict(fused=True), "fused",
                     {"zeta": 1e-5, "psi": 1e-4}),
    "chain (8, 1)": (FUSED, (N, 1), dict(fused=True, chain=True), "chain",
                     {"zeta": 1e-5, "psi": 2e-4}),
    "fused 2-D (4, 2)": (FUSED_2D, (4, 2), dict(fused=True), "fused-2d",
                         {"zeta": 1e-5, "psi": 5e-5}),
}


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases = [dict(name=name, kind="run", cfg=config_from_jax(cfg),
                  shape=shape, psi0=_psi0(cfg), steps=STEPS, opts=opts)
             for name, (cfg, shape, opts, _, _) in STEP_CASES.items()]
    zeta = _zeta_in()
    paired_zeta = np.asarray(init_state(
        PAIRED, key=jax.random.PRNGKey(0)).zeta)
    cases += [
        dict(name="companion inversion", kind="inverter", cls="packed",
             shape=(N, 1), cfg=config_from_jax(FUSED), zeta=zeta),
        dict(name="paired inversion", kind="inverter", cls="paired",
             shape=(N, 1), cfg=config_from_jax(PAIRED), zeta=paired_zeta),
        dict(name="multigrid inversion", kind="mg_inverter", shape=(2, 4),
             cfg=config_from_jax(GENERIC), zeta=_generic_zeta(), cycles=10),
    ]
    return ranks.spawn(N, tmp_path_factory.mktemp("dryrun8"), cases)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_dryrun_step_routes(results, name):
    cfg, _, _, route, gates = STEP_CASES[name]
    got = results[name]
    assert got["route"] == route and got["step"] == STEPS
    zeta, psi = _reference(cfg)
    _close(got["zeta"], zeta, gates["zeta"], f"{name} zeta")
    _close(got["psi"], psi, gates["psi"], f"{name} psi")


@pytest.mark.parametrize("name,cfg,zeta", [
    ("companion inversion", FUSED, _zeta_in),
    ("paired inversion", PAIRED,
     lambda: np.asarray(init_state(PAIRED, key=jax.random.PRNGKey(0)).zeta))])
def test_dryrun_inversions(results, name, cfg, zeta):
    z = torch.from_numpy(np.array(zeta()))
    args = (cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())
    got = results[name]
    _close(got, PackedModalInverterKernels(*args)(z), 1e-6,
           f"{name} vs one device")
    psi64 = PackedModalInverter(*args)(z.double()).numpy()
    tpu = np.asarray(PackedModalInverterPallasFFT(*args, interpret=True)(
        z.numpy()))
    scale = np.abs(psi64).max()
    err, err_tpu = (np.abs(a - psi64).max() / scale for a in (got, tpu))
    assert err <= 2.0 * err_tpu, (name, err, err_tpu)


def test_dryrun_multigrid_inversion(results):
    """The dry run's multigrid check (__graft_entry__.py:196-210)."""
    zeta = jax.numpy.asarray(_generic_zeta())
    want = _invert_psi(GENERIC, _build_solvers(GENERIC), zeta)
    _close(results["multigrid inversion"], want, 1e-5, "multigrid psi")

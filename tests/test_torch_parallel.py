"""tpu_qg_torch.parallel's generic route on gloo ranks of the CPU against
tpu_qg's single-device trajectory in float64 (1e-12 of the largest value,
as tests/test_parallel.py holds tpu_qg's halo stepper): the blocking and
overlapped steps on (2, 2), (4, 1) and (1, 4) meshes with wind, one layer,
leapfrog; the halo exchange; DistributedHelmholtzSolver; run_model on a
mesh with gathered checkpoints and resume; sharded_diagnostics on each
mesh at 128^2 against diagnostics and tpu_qg's. Then, with no process group:
the copied shape gates against tpu_qg's, and NCCL's shared-device check.

All mesh cases run in one spawn of four ranks (tests/torch_parallel_ranks.py)."""

import jax
import numpy as np
import pytest

import tpu_qg
from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM, MINUTES, YEAR
from tpu_qg.models.core import init_state as j_init_state
from tpu_qg.models.core import make_step_fn
from tpu_qg.ops import pallas_tendency as j_tendency
from tpu_qg.ops.spectral import HelmholtzSolver
from tpu_qg.parallel import packed as j_packed
from tpu_qg.parallel import paired as j_paired
from tpu_qg.parallel import stepper as j_stepper
from tpu_qg.utils.diagnostics import diagnostics as j_diagnostics
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.models.core import init_state as t_init_state
from tpu_qg_torch.ops import spectral as t_spectral
from tpu_qg_torch.parallel import mesh as t_mesh
from tpu_qg_torch.parallel import packed as t_packed
from tpu_qg_torch.parallel import paired as t_paired
from tpu_qg_torch.parallel import stepper as t_stepper
from tpu_qg_torch.utils.diagnostics import diagnostics as t_diagnostics

import torch_parallel_ranks as ranks

TOL = 1e-12
MESHES = [(2, 2), (4, 1), (1, 4)]


def small_cfg(**kw):
    base = dict(H_1=1.0 * KM, H_2=2.0 * KM, beta=2e-11, Lx=4000.0 * KM,
                Ly=4000.0 * KM, dt=60.0 * MINUTES, T=1.0 * YEAR, U=0.1,
                M=64, P=64, visc=100.0, r=1e-7, R_d=40.0 * KM,
                initial_kick=1e-6, dtype="float64")
    base.update(kw)
    return ModelConfig(**base)


def _psi0(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    amp = jcfg.initial_kick * (jcfg.U or 1.0) * jcfg.Ly
    return amp * rng.random((jcfg.n_layers, jcfg.M, jcfg.P))


def _reference(jcfg, psi0, steps):
    """tpu_qg's single-device trajectory with per-mode solvers (the
    algorithm of the distributed solve), as numpy."""
    step = jax.jit(make_step_fn(jcfg, batched_fft=False))
    s = j_init_state(jcfg, psi_init=psi0)
    for _ in range(steps):
        s = step(s)
    return {f: np.asarray(getattr(s, f)) for f in ("zeta", "psi", "f1")}


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


WIND = small_cfg(wind_tau0=0.1)
ONE_LAYER = small_cfg(n_layers=1, U=0.0, r=0.0)
LEAPFROG = small_cfg(time_scheme="leapfrog_ra", wind_tau0=0.1)
STEP_CASES = {
    **{f"{nx}x{ny} {form}": (WIND, (nx, ny), 5, form == "overlapped")
       for nx, ny in MESHES for form in ("blocking", "overlapped")},
    "2x2 one layer": (ONE_LAYER, (2, 2), 3, True),
    "1x4 leapfrog": (LEAPFROG, (1, 4), 5, True),
}
HALO_FIELD = np.random.default_rng(0).standard_normal((16, 16))
SOLVER_RHS = np.random.default_rng(1).standard_normal((2, 64, 64))
RUN_STEPS = 4
DIAG = small_cfg(M=128, P=128)
DIAG_STEP = 7


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases = [dict(name=name, kind="run", cfg=config_from_jax(jcfg),
                  shape=shape, psi0=_psi0(jcfg), steps=steps,
                  opts=dict(overlap=overlap))
             for name, (jcfg, shape, steps, overlap) in STEP_CASES.items()]
    cases += [
        dict(name="halo", kind="halo", shape=(2, 2), field=HALO_FIELD, h=2),
        dict(name="solver", kind="solver", shape=(2, 2), rhs=SOLVER_RHS,
             dx=WIND.dx, alphas=(0.0, WIND.S_eig)),
        dict(name="run_model", kind="run_model", shape=(2, 2),
             cfg=config_from_jax(WIND), psi0=_psi0(WIND), steps=RUN_STEPS),
    ]
    cases += [dict(name=f"diagnostics {nx}x{ny}", kind="sharded_diagnostics",
                   shape=(nx, ny), cfg=config_from_jax(DIAG),
                   psi0=_psi0(DIAG, seed=3), step=DIAG_STEP)
              for nx, ny in MESHES]
    return ranks.spawn(4, tmp_path_factory.mktemp("mesh4"), cases)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_generic_step_matches_tpu_qg(results, name):
    """The generic route (route "generic": torch stencils on halo-padded
    tiles, DistributedHelmholtzSolver) against tpu_qg's single-device
    per-mode trajectory, float64, 1e-12."""
    jcfg, shape, steps, _ = STEP_CASES[name]
    got = results[name]
    assert got["route"] == "generic" and got["step"] == steps
    want = _reference(jcfg, _psi0(jcfg), steps)
    for f in ("zeta", "psi", "f1"):
        _close(got[f], want[f], TOL, f"{name} {f}")


def test_exchange_halo_unit(results):
    """Each rank's padded block equals the wrapped global field's window
    (tests/test_parallel.py:132)."""
    h = 2
    want = np.pad(HALO_FIELD, h, mode="wrap")
    got = results["halo"]
    m = p = 8
    for ix in range(2):
        for iy in range(2):
            blk = got[ix * (m + 2 * h):(ix + 1) * (m + 2 * h),
                      iy * (p + 2 * h):(iy + 1) * (p + 2 * h)]
            np.testing.assert_array_equal(
                blk, want[ix * m:ix * m + m + 2 * h,
                          iy * p:iy * p + p + 2 * h])


def test_distributed_helmholtz_solver(results):
    """The transposed-FFT solve on a (2, 2) mesh against tpu_qg's
    single-device solver for each mode (zero-mean Poisson and the
    modified Helmholtz), float64, 1e-12."""
    for k, alpha in enumerate((0.0, WIND.S_eig)):
        want = HelmholtzSolver(64, 64, WIND.dx, alpha)(SOLVER_RHS[k])
        _close(results["solver"][k], want, TOL, f"alpha={alpha}")


def test_run_model_on_mesh_gathered_io(results):
    """run_model on a (2, 2) mesh: gathered snapshots and checkpoints from
    rank 0 every step and every 2 steps, a resume 2 steps further, and the
    final state against tpu_qg's trajectory (1e-12)."""
    got = results["run_model"]
    steps = RUN_STEPS + 2
    assert got["step"] == steps
    assert got["checkpoints"] == [2, 4, 6]
    assert got["snapshots"] == list(range(1, steps + 1))
    want = _reference(WIND, _psi0(WIND), steps)
    for f in ("zeta", "psi", "f1"):
        _close(got[f], want[f], TOL, f)


@pytest.mark.parametrize("nx,ny", MESHES)
def test_sharded_diagnostics_matches(results, nx, ny):
    """sharded_diagnostics (what run_model logs at every sample on a mesh)
    on each mesh's blocks against diagnostics of the whole state and
    against tpu_qg's, 128^2 float64, 1e-12."""
    got = results[f"diagnostics {nx}x{ny}"]
    psi0 = _psi0(DIAG, seed=3)
    whole = t_init_state(config_from_jax(DIAG), "cpu", psi_init=psi0)
    ours = t_diagnostics(config_from_jax(DIAG),
                         whole._replace(step=DIAG_STEP))
    ref = j_diagnostics(
        DIAG, j_init_state(DIAG, psi_init=psi0)._replace(step=DIAG_STEP))
    assert set(got) == set(ours) == set(ref)
    assert got["step"] == ours["step"] == ref["step"] == DIAG_STEP
    for key in ref:
        for want in (ours[key], ref[key]):
            np.testing.assert_allclose(got[key], want, rtol=TOL, atol=0,
                                       err_msg=f"{nx}x{ny} {key}")


GATE_SHAPES = [(M, P) for M in (128, 256, 2048, 4096, 4352, 8192)
               for P in (128, 256, 512, 1024, 2048, 8192)]


@pytest.mark.parametrize("nx,ny", [(1, 1), (2, 1), (4, 1), (8, 1), (2, 2),
                                   (4, 2), (1, 4)])
def test_gates_match_tpu_qg(nx, ny):
    """The copied gates choose tpu_qg's route on every shape of the table:
    the fused (N, 1) and 2-D steps, the paired and the packed inverters,
    and the sharded step kernels' own gates (the chain's among them) (plain
    Python, no process group)."""
    for M, P in GATE_SHAPES:
        for kw in ({}, dict(wind_tau0=0.1), dict(dtype="float64"),
                   dict(n_layers=1), dict(poisson_gauge="pin")):
            jcfg = tpu_qg.preset("turbulence-2048").replace(M=M, P=P, **kw)
            cfg = config_from_jax(jcfg)
            what = (M, P, nx, ny, kw)
            assert (t_stepper.fused_shape_supported(cfg, nx, ny)
                    == j_stepper.fused_shape_supported(jcfg, nx, ny)), what
            assert (t_stepper.fused_2d_shape_supported(cfg, nx, ny)
                    == j_stepper.fused_2d_shape_supported(jcfg, nx, ny)), what
        assert (t_paired.paired_supported(M, P, nx)
                == j_paired.paired_supported(M, P, nx)), (M, P, nx)
        assert (t_packed.distributed_packed_supported(M, P, nx)
                == j_packed.distributed_packed_supported(M, P, nx)), (M, P)
        assert (t_packed.distributed_packed_2d_supported(M, P, nx, ny)
                == j_packed.distributed_packed_2d_supported(M, P, nx, ny))
        m = M // nx
        assert (t_spectral.reference_sharded_yfused(2, m, P, 4)
                == j_tendency.sharded_yfused_supported(2, m, P, 4)), (m, P)
        assert (t_spectral.reference_sharded_step(2, m, P // ny, 4)
                == j_tendency.sharded_pallas_supported(2, m, P // ny, 4))


def test_nccl_shared_device_check():
    """make_mesh's check: NCCL refuses two ranks on one device; gloo takes
    them; distinct devices pass either way."""
    shared = ["h:cuda:0", "h:cuda:1", "h:cuda:0"]
    with pytest.raises(ValueError, match="one device per rank"):
        t_mesh.check_nccl_devices("nccl", shared)
    t_mesh.check_nccl_devices("gloo", shared)
    t_mesh.check_nccl_devices("nccl", ["h:cuda:0", "h:cuda:1", "g:cuda:0"])
    with pytest.raises(ValueError, match="h:cuda:0"):
        t_mesh.check_nccl_devices("nccl", shared)

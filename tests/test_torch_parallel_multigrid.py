"""tpu_qg_torch.parallel.multigrid and the halo stepper's multigrid route on
eight gloo ranks of the CPU (one spawn, tests/torch_parallel_ranks.py)
against tpu_qg on conftest's eight virtual CPU devices, in float64, as
tests/test_multigrid.py:216-345 holds tpu_qg's distributed multigrid.

Tolerances, relative to max|reference|:
  * the solver on (8, 1), (4, 2) and (2, 4) at 256^2, 12 cycles: 1e-12
    against tpu_qg's distributed solver on the same mesh shape (the same
    levels and arithmetic; the gauge means sum in another order), 1e-9
    against the spectral solve (the converged V-cycle);
  * the inverter on (2, 4) at 128 x 256 against tpu_qg's spectral
    inversion, cold at 12 cycles and warm from the answer at 3: 1e-9;
  * the halo step's 10 steps at mg_cycles=10 against tpu_qg's
    single-device spectral trajectory: 1e-7 (the V-cycles' lag);
  * the extrapolated run of 20 steps in one call at mg_cycles=2 against
    tpu_qg's make_halo_run_fn on (2, 4): 1e-12; the same 20 steps in two
    calls bit for bit (the port carries psi_{n-1} across calls; tpu_qg
    restarts the extrapolation at every call);
  * pod-8192-mg's configuration at its grid spacing on a 128^2 grid: the
    same run against tpu_qg's at 1e-12, and both more than 1e-4 from the
    spectral trajectory, the same distance to 1e-9: two V-cycles a step
    lag the exact inversion there, in float64, in both packages.
The level lists against tpu_qg's need no ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as Pspec

import tpu_qg
from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM, MINUTES, YEAR
from tpu_qg.models.core import QGModel, _build_solvers, _invert_psi
from tpu_qg.models.core import init_state as j_init_state
from tpu_qg.ops.spectral import BatchedModalSolver
from tpu_qg.parallel import make_mesh, shard_state
from tpu_qg.parallel import multigrid as j_pmg
from tpu_qg.parallel.stepper import make_halo_run_fn
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.parallel import multigrid as t_pmg
from tpu_qg_torch.parallel.mesh import Mesh

import torch_parallel_ranks as ranks

N = 8
SOLVER_MESHES = [(8, 1), (4, 2), (2, 4)]


def qg_cfg(**kw):
    """tests/test_multigrid.py's configuration."""
    base = dict(H_1=1.0 * KM, H_2=2.0 * KM, beta=2e-11, Lx=4000.0 * KM,
                Ly=4000.0 * KM, dt=60.0 * MINUTES, T=1.0 * YEAR, U=0.1,
                M=128, P=128, visc=100.0, r=1e-7, R_d=40.0 * KM,
                initial_kick=1e-6, dtype="float64")
    base.update(kw)
    return ModelConfig(**base)


SOLVER = qg_cfg(M=256, P=256)
SOLVER_RHS = 1e-5 * np.random.default_rng(5).standard_normal((2, 256, 256))
INVERTER = qg_cfg(M=128, P=256)
STEP = qg_cfg(M=256, P=256, elliptic_impl="multigrid", mg_cycles=10)
EXTRAP = qg_cfg(elliptic_impl="multigrid", mg_cycles=2, mg_extrapolate=True)
EXTRAP_STEPS, EXTRAP_SPLIT = 20, 7
_POD = tpu_qg.preset("pod-8192-mg")
POD_SPACING = _POD.replace(M=128, P=128, Lx=128 * _POD.Lx / _POD.M,
                           Ly=128 * _POD.Ly / _POD.P, dtype="float64")


def _psi0(cfg, seed):
    rng = np.random.default_rng(seed)
    return cfg.initial_kick * cfg.U * cfg.Ly * rng.random((2, cfg.M, cfg.P))


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    assert np.asarray(got).shape == want.shape, what
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _inverter_zeta():
    return np.asarray(j_init_state(INVERTER, key=jax.random.PRNGKey(1)).zeta)


def _spectral_psi(cfg, zeta):
    return np.asarray(_invert_psi(cfg, _build_solvers(cfg),
                                  jnp.asarray(zeta)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    zeta = _inverter_zeta()
    cases = [dict(name=f"solver {shape}", kind="mg_solver", shape=shape,
                  rhs=SOLVER_RHS, dx=SOLVER.dx, alphas=(0.0, SOLVER.S_eig),
                  cycles=12)
             for shape in SOLVER_MESHES]
    cases += [
        dict(name="inverter cold", kind="mg_inverter", shape=(2, 4),
             cfg=config_from_jax(INVERTER), zeta=zeta, cycles=12),
        dict(name="inverter warm", kind="mg_inverter", shape=(2, 4),
             cfg=config_from_jax(INVERTER), zeta=zeta, cycles=3,
             psi_prev=_spectral_psi(INVERTER, zeta)),
        dict(name="halo step", kind="run", shape=(2, 4),
             cfg=config_from_jax(STEP), psi0=_psi0(STEP, 11), steps=10),
        dict(name="extrapolated", kind="mg_extrapolated", shape=(2, 4),
             cfg=config_from_jax(EXTRAP), psi0=_psi0(EXTRAP, 13),
             steps=EXTRAP_STEPS, split=EXTRAP_SPLIT),
        dict(name="pod spacing", kind="mg_extrapolated", shape=(2, 4),
             cfg=config_from_jax(POD_SPACING), psi0=_psi0(POD_SPACING, 0),
             steps=EXTRAP_STEPS, split=EXTRAP_SPLIT),
    ]
    return ranks.spawn(N, tmp_path_factory.mktemp("mg8"), cases)


@pytest.mark.parametrize("shape", SOLVER_MESHES)
def test_solver_matches_tpu_qg_distributed_and_spectral(results, shape):
    nx, ny = shape
    alphas = (0.0, SOLVER.S_eig)
    f = jnp.asarray(SOLVER_RHS)
    solve = jax.jit(jax.shard_map(
        j_pmg.DistributedMultigridSolver(SOLVER.M, SOLVER.P, SOLVER.dx,
                                         alphas, nx, ny, n_cycles=12),
        mesh=make_mesh(shape), in_specs=(Pspec(None, "x", "y"),),
        out_specs=Pspec(None, "x", "y"), check_vma=False))
    got = results[f"solver {shape}"]
    _close(got, solve(f), 1e-12, f"{shape} vs tpu_qg's distributed solver")
    spectral = BatchedModalSolver(SOLVER.M, SOLVER.P, SOLVER.dx, alphas)(f)
    _close(got, spectral, 1e-9, f"{shape} vs the spectral solve")


@pytest.mark.parametrize("name", ["inverter cold", "inverter warm"])
def test_inverter_matches_spectral_inversion(results, name):
    want = _spectral_psi(INVERTER, _inverter_zeta())
    _close(results[name], want, 1e-9, name)


def test_halo_step_trajectory_matches_spectral(results):
    got = results["halo step"]
    assert got["route"] == "generic-mg" and got["step"] == 10
    model = QGModel(STEP.replace(elliptic_impl="spectral"))
    ref = model.run(model.init_state(psi_init=_psi0(STEP, 11)), 10)
    for name in ("zeta", "psi"):
        _close(got[name], getattr(ref, name), 1e-7, name)


def _tpu_qg_extrapolated(cfg, seed):
    mesh = make_mesh((2, 4))
    state = shard_state(QGModel(cfg).init_state(psi_init=_psi0(cfg, seed)),
                        mesh)
    return make_halo_run_fn(cfg, mesh)(state, EXTRAP_STEPS)


def test_extrapolated_run_matches_tpu_qg_in_one_call(results):
    got = results["extrapolated"]
    assert got["route"] == "generic-mg"
    ref = _tpu_qg_extrapolated(EXTRAP, 13)
    assert got["whole"]["step"] == EXTRAP_STEPS
    for name in ("zeta", "psi", "f1"):
        _close(got["whole"][name], getattr(ref, name), 1e-12, name)


def test_two_cycles_lag_the_spectral_route_at_the_pod_spacing(results):
    """At pod-8192-mg's grid spacing the grid-noise start decays fast, and
    two V-cycles a step lag the exact inversion: after 20 steps zeta sits
    more than 1e-4 from the spectral trajectory, in float64, in the port
    and in tpu_qg alike."""
    got = results["pod spacing"]["whole"]
    ref = _tpu_qg_extrapolated(POD_SPACING, 0)
    for name in ("zeta", "psi", "f1"):
        _close(got[name], getattr(ref, name), 1e-12, name)
    model = QGModel(POD_SPACING.replace(elliptic_impl="spectral"))
    spec = np.asarray(model.run(model.init_state(
        psi_init=_psi0(POD_SPACING, 0)), EXTRAP_STEPS).zeta)
    scale = np.abs(spec).max()
    lag_port = np.abs(got["zeta"] - spec).max() / scale
    lag_ref = np.abs(np.asarray(ref.zeta) - spec).max() / scale
    assert lag_port > 1e-4 and lag_ref > 1e-4, (lag_port, lag_ref)
    assert abs(lag_port - lag_ref) < 1e-9, (lag_port, lag_ref)


def test_extrapolated_run_does_not_depend_on_how_it_is_cut(results):
    """run(s, 20) equals run(run(s, 7), 13) bit for bit; the second call
    from a copy of the state (the plain seed, tpu_qg's every call) does
    not, so the carried psi_{n-1} is what makes them equal."""
    got = results["extrapolated"]
    for name in ("zeta", "psi", "f1"):
        np.testing.assert_array_equal(got["split"][name],
                                      got["whole"][name], err_msg=name)
    assert got["restarted"]["step"] == EXTRAP_STEPS
    assert not np.array_equal(got["restarted"]["psi"], got["whole"]["psi"])


@pytest.mark.parametrize("M,P,nx,ny", [
    (256, 256, 8, 1), (256, 256, 2, 4), (128, 256, 2, 4), (2048, 2048, 2, 2),
    (8192, 8192, 1, 1), (8192, 8192, 4, 2), (192, 320, 2, 2), (96, 96, 3, 1),
    (1536, 1024, 3, 2), (512, 128, 8, 1)])
def test_levels_match_tpu_qg(M, P, nx, ny):
    """The level list, the gathered level and its local extents, with no
    process group (the solver's constructor does not communicate)."""
    mesh = Mesh((nx, ny), 0, 0, None, None, None, torch.device("cpu"),
                "gloo")
    want = j_pmg.DistributedMultigridSolver(M, P, 1.5, (0.0,), nx, ny)
    for cutoff in (64, 32):
        got = t_pmg.DistributedMultigridSolver(M, P, 1.5, (0.0,), mesh,
                                               gather_cutoff=cutoff)
        ref = j_pmg.DistributedMultigridSolver(M, P, 1.5, (0.0,), nx, ny,
                                               gather_cutoff=cutoff)
        assert got.levels == ref.levels
        assert got.coarse == ref.coarse
        assert got.coarse_loc == ref.coarse_loc
    assert t_pmg.distributed_levels(M, P, 1.5, nx, ny) == (
        want.levels, want.coarse, want.coarse_loc)

"""tpu_qg_torch.parallel.gspmd (the single-device step on DTensors) against
tpu_qg.parallel.gspmd: one spawn of 8 gloo CPU ranks
(``torch_parallel_ranks``), the JAX references on the test process's 8
virtual CPU devices (conftest).

  * make_sharded_run_fn, 10 float64 steps at 32^2, on (2, 4), (4, 2),
    (1, 8) and (8, 1), against tpu_qg's make_sharded_run_fn on the same
    mesh shape at tests/test_parallel.py's gates (zeta rtol 1e-12 atol
    1e-20; psi rtol 1e-12 atol 1e-16 against the port's single-device
    per-mode step, and 1e-12 of max|psi| against tpu_qg: see ``_check``);
    the pin gauge on (2, 4) and (8, 1) likewise;
  * make_sharded_step_fn: the counter after one step, and every field's
    layout after 4 steps (spatial axes over the DeviceMesh's ("x", "y") in
    the Mesh's rank order, the layer axis replicated);
  * CommDebugMode: no all-gather in the tendencies on (2, 4) (each roll
    moves a slab; the result bitwise the single-device tendencies), none
    for plain tensors inside the mode, and one whole step's collectives
    pinned by type and count, with the bytes a rank sends; a grid that
    does not divide over the mesh raises;
  * run_model(parallel_impl="gspmd"): gathered checkpoints and a resume,
    shard-file checkpoints and a resume bit for bit, and debug_nans."""

import numpy as np
import pytest

from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM, MINUTES, YEAR
from tpu_qg.models import init_state
from tpu_qg.parallel import make_mesh
from tpu_qg.parallel.gspmd import make_sharded_run_fn, shard_state
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.models.core import init_state as torch_init_state
from tpu_qg_torch.models.core import make_step_fn

import torch_parallel_ranks as ranks

N = 8
STEPS = 10
MESHES = [(2, 4), (4, 2), (1, 8), (8, 1)]
PIN_MESHES = [(2, 4), (8, 1)]


def _cfg(**kw):
    """tests/test_parallel.py's small_cfg."""
    base = dict(H_1=1.0 * KM, H_2=2.0 * KM, beta=2e-11, Lx=4000.0 * KM,
                Ly=4000.0 * KM, dt=60.0 * MINUTES, T=1.0 * YEAR, U=0.1,
                M=32, P=32, visc=100.0, r=1e-7, R_d=40.0 * KM,
                initial_kick=1e-6, dtype="float64")
    base.update(kw)
    return ModelConfig(**base)


CFG = _cfg()
PIN = _cfg(poisson_gauge="pin")


def _psi0(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return cfg.initial_kick * cfg.U * cfg.Ly * rng.random((2, cfg.M, cfg.P))


def _jax_run(cfg, shape, steps):
    """tpu_qg's make_sharded_run_fn on the mesh ``shape``."""
    mesh = make_mesh(shape)
    out = make_sharded_run_fn(cfg, mesh)(
        shard_state(init_state(cfg, psi_init=_psi0(cfg)), mesh), steps)
    return {f: np.asarray(getattr(out, f)) for f in ("zeta", "psi", "f1")}


def _case(name, kind, cfg, shape, **kw):
    return dict(name=name, kind=kind, cfg=config_from_jax(cfg), shape=shape,
                psi0=_psi0(cfg), **kw)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    gspmd = {"parallel_impl": "gspmd"}
    cases = [_case(f"run {s}", "gspmd_run", CFG, s, steps=STEPS)
             for s in MESHES]
    cases += [_case(f"pin {s}", "gspmd_run", PIN, s, steps=STEPS)
              for s in PIN_MESHES]
    cases += [
        _case("steps", "gspmd_run", CFG, (2, 4), steps=4, one_step=True),
        _case("comms", "gspmd_comms", CFG, (2, 4)),
        _case("run_model", "run_model", CFG, (2, 4), steps=4,
              run_opts=gspmd),
        _case("io_resume", "io_resume", CFG, (4, 2), steps=4,
              run_opts=gspmd),
        _case("debug_nans", "debug_nans", CFG, (2, 4), steps=3,
              field="f1", nan_at=(1, 20, 5), run_opts=gspmd),
    ]
    return ranks.spawn(N, tmp_path_factory.mktemp("gspmd8"), cases)


def _port_run(cfg, steps):
    """The port's single-device per-mode step (the algorithm the sharded
    step runs), ``steps`` steps."""
    tcfg = config_from_jax(cfg)
    step = make_step_fn(tcfg, batched_fft=False)
    state = torch_init_state(tcfg, "cpu", psi_init=_psi0(cfg))
    for _ in range(steps):
        state = step(state)
    return {f: getattr(state, f).numpy() for f in ("zeta", "psi")}


def _check(got, cfg, shape, steps):
    """zeta against tpu_qg's sharded run at tests/test_parallel.py's gate;
    psi at that gate against the port's single-device per-mode step, and
    within 1e-12 of max|psi| of tpu_qg's sharded run: torch.fft and XLA's
    FFT round differently (the two packages' single-device per-mode steps
    differ by ~3e-15 of max|psi| after 10 steps, a few ulps at the
    smallest elements), as the port's other float64 checks against tpu_qg
    hold it (tests/test_torch_model.py)."""
    want = _jax_run(cfg, shape, steps)
    np.testing.assert_allclose(got["zeta"], want["zeta"], rtol=1e-12,
                               atol=1e-20)
    np.testing.assert_allclose(got["psi"], _port_run(cfg, steps)["psi"],
                               rtol=1e-12, atol=1e-16)
    err = np.abs(got["psi"] - want["psi"]).max() / np.abs(want["psi"]).max()
    assert err <= 1e-12, err


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_run_matches_tpu_qg(results, shape):
    got = results[f"run {shape}"]
    assert got["route"] == "gspmd" and got["step"] == STEPS
    _check(got, CFG, shape, STEPS)


@pytest.mark.parametrize("shape", PIN_MESHES)
def test_pin_gauge_runs_and_matches(results, shape):
    """The pin gauge's u - u[..., 0:1, 0:1] runs on the gathered solve's
    replicated output: no error, and tpu_qg's trajectory."""
    got = results[f"pin {shape}"]
    _check(got, PIN, shape, STEPS)


def test_sharded_step_fn_single_step_and_layout(results):
    got = results["steps"]
    assert got["first_step"] == 1 and got["step"] == 4
    assert got["route"] == "gspmd"
    for field, layout in got["layout"].items():
        assert layout["placements"] == [("Shard", 1), ("Shard", 2)], field
        assert layout["mesh_dims"] == ("x", "y")
        assert layout["mesh_shape"] == (2, 4)
        # rank = ix * ny + iy, the Mesh's order.
        assert layout["mesh_ranks"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert layout["local_shape"] == (2, 16, 8)


def test_tendencies_gather_nothing(results):
    """Each of the tendencies' rolls along a sharded axis is one ring shift
    (an all_to_all_single with one non-empty chunk); nothing all-gathers."""
    tend = results["comms"]["tendencies"]
    assert not [k for k in tend if "gather" in k], tend
    assert tend == {"c10d.alltoall_base_": 36}


def test_sharded_tendencies_are_the_plain_ones(results):
    """The slab ring shifts rebuild each rolled block exactly: the sharded
    tendencies, gathered, are bitwise the single-device ones."""
    got = results["comms"]
    np.testing.assert_array_equal(got["tendencies_sharded"],
                                  got["tendencies_reference"])


def test_plain_tensors_pass_through_the_mode(results):
    """Inside sharded_ops, plain tensors run as they are: no collective, a
    plain result, the same bits."""
    got = results["comms"]
    assert got["plain_comms"] == {} and got["plain_type"] == "Tensor"
    np.testing.assert_array_equal(got["tendencies_plain"],
                                  got["tendencies_reference"])


def test_grid_must_divide_over_the_mesh(results):
    assert "(32, 34) does not divide over mesh (2, 4)" in \
        results["comms"]["bad_grid"]


def test_step_collectives_pinned(results):
    """One step: the tendencies' 36 ring shifts and 2 gathers of the modal
    fields for the per-mode solve, all on all_to_all_single. A rank sends
    one-cell slabs of its (2, 16, 8) blocks (18 rows along x, 16 columns
    along y, and 2 rows of layer 1 alone for U d(zeta)/dx) and 7/8 of each
    (32, 32) float64 modal field."""
    comms = results["comms"]
    assert comms["step"] == {"c10d.alltoall_base_": 38}
    sent = comms["bytes_sent"]
    assert sent["slabs"] == {"(2, 1, 8)": 18, "(2, 16, 1)": 16, "(1, 8)": 2}
    assert sent["ring_shift"] == (18 * 16 + 16 * 32 + 2 * 8) * 8
    assert sent["all_gather_blocks"] == 2 * 7 * 16 * 8 * 8


def test_run_model_gspmd_checkpoints_and_resume(results):
    """Gathered checkpoints every 2 steps to 4, a resume to 6: tpu_qg's
    6-step sharded run."""
    got = results["run_model"]
    assert got["checkpoints"] == [2, 4, 6] and got["step"] == 6
    _check(got, CFG, (2, 4), 6)


def test_run_model_gspmd_shard_files_resume_bitwise(results):
    got = results["io_resume"]
    for f in ("zeta", "psi", "f1"):
        np.testing.assert_array_equal(got["resumed"][f], got["whole"][f])
    assert got["resumed"]["step"] == 6
    assert "checkpoint_000000004-shard00007.npz" in got["files"]
    _check(got["whole"], CFG, (4, 2), 6)


def test_run_model_gspmd_debug_nans(results):
    """A NaN in f1 moves to f2 after the first euler step and stops the
    run there, every rank naming it."""
    msg = results["debug_nans"]
    assert msg is not None and "non-finite f2 at step 1" in msg, msg


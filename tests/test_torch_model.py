"""The slice end to end: tpu_qg_torch's model, routing, I/O, interop and
command line against tpu_qg on the CPU."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
import tpu_qg.io as jio
import tpu_qg_torch
from tpu_qg.ops.pallas_fft import pair_x_fits, planar_fft2_fits, symbol_inverse_fits
from tpu_qg.ops.spectral import PackedModalInverterPallasFFT
from tpu_qg_torch import io as tio
from tpu_qg_torch import run as trun
from tpu_qg_torch.interop import config_from_jax, state_from_numpy, state_to_numpy
from tpu_qg_torch.models import core
from tpu_qg_torch.ops.dft_kernels import (kernels_take, mono_invert,
                                          pair_x_symbols, x_dft,
                                          x_kernels_take, x_symbols_inverse,
                                          y_dft)
from tpu_qg_torch.ops import spectral
from tpu_qg_torch.ops.spectral import (PackedModalInverter,
                                       PackedModalInverterKernels)
from tpu_qg_torch.ops.step_kernel import (fused_pre_inversion, fused_step,
                                          fused_step_full, fused_step_yspec)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _psi_init(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    amp = jcfg.initial_kick * jcfg.U * jcfg.Ly
    return amp * rng.random((jcfg.n_layers, jcfg.M, jcfg.P))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("M,P,scheme,tau0", [
    (128, 128, "euler_ab3", 0.0), (256, 384, "euler_ab3", 0.0),
    (128, 128, "leapfrog_ra", 0.1)])
def test_model_matches_tpu_qg_float64(M, P, scheme, tau0):
    """20 steps from one psi_init, turbulence-2048 physics, float64: the
    Euler start, AB3 (or leapfrog-RA with wind) and the packed inversion."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(
        M=M, P=P, dtype="float64", time_scheme=scheme, wind_tau0=tau0)
    psi0 = _psi_init(jcfg)
    want = tpu_qg.QGModel(jcfg).run(
        tpu_qg.QGModel(jcfg).init_state(psi_init=psi0), 20)
    model = tpu_qg_torch.QGModel(config_from_jax(jcfg), device="cpu")
    got = model.run(model.init_state(psi_init=psi0), 20)
    assert got.step == 20 and got.zeta.dtype == torch.float64
    assert _rel(got.zeta, want.zeta) <= 1e-12
    assert _rel(got.psi, want.psi) <= 1e-12
    assert _rel(got.f1, want.f1) <= 1e-12


def test_pin_gauge_and_per_mode_solvers_match_tpu_qg():
    jcfg = tpu_qg.preset("turbulence-2048").replace(
        M=64, P=64, dtype="float64", poisson_gauge="pin")
    psi0 = _psi_init(jcfg, seed=1)
    for batched in (True, False):
        jstep = tpu_qg.make_step_fn(jcfg, batched_fft=batched)
        js = tpu_qg.init_state(jcfg, psi_init=psi0)
        tstep = core.make_step_fn(config_from_jax(jcfg), batched_fft=batched)
        ts = core.init_state(config_from_jax(jcfg), "cpu", psi_init=psi0)
        for _ in range(5):
            js, ts = jstep(js), tstep(ts)
        assert _rel(ts.psi, js.psi) <= 1e-12
        assert _rel(ts.zeta, js.zeta) <= 1e-12


def test_kernel_structure_on_cpu_float32():
    """turbulence-2048 physics at 256^2 float32 takes the kernel route
    (K1 -> K2 -> K3 -> K2^-1); on CPU tensors the wrappers run their plain
    versions and count no launches. Held against tpu_qg's float32 XLA route
    with the dryrun gates' loose pair: zeta 1e-5, psi 2e-4."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(M=256, P=256)
    cfg = config_from_jax(jcfg)
    assert core.use_step_kernel(cfg) and core.resolve_fft_impl(cfg) == "kernels"
    assert isinstance(core._build_solvers(cfg), PackedModalInverterKernels)
    psi0 = _psi_init(jcfg, seed=2)
    before = (fused_step.launches, y_dft.launches, pair_x_symbols.launches)
    model = tpu_qg_torch.QGModel(cfg, device="cpu")
    got = model.run(model.init_state(psi_init=psi0), 10)
    assert (fused_step.launches, y_dft.launches,
            pair_x_symbols.launches) == before
    want = tpu_qg.QGModel(jcfg).run(
        tpu_qg.QGModel(jcfg).init_state(psi_init=psi0), 10)
    assert _rel(got.zeta, want.zeta) <= 1e-5
    assert _rel(got.psi, want.psi) <= 2e-4


@pytest.mark.parametrize("overrides,P,route", [
    (dict(fft_pairx="off"), 384, "default"),
    (dict(poisson_gauge="pin"), 256, "default"),
    (dict(n_layers=1), 256, "default"), (dict(fft_mono="on"), 256, "mono"),
    (dict(step_full="on"), 256, "fullstep"),
    (dict(step_chain="on"), 256, "chain")],
    ids=["four-pass", "pin", "single-layer", "mono", "fullstep", "chain"])
def test_kernel_routes_on_cpu_match_tpu_qg_pallas_float32(overrides, P,
                                                          route):
    """10 float32 steps on the four-pass route (K1 -> K2 -> K4 -> K5 ->
    K2^-1), the K8 route (K8 -> BatchedModalSolver) and the one-launch
    routes (K1 -> K16; K17; the chain of K15 and K3) against tpu_qg.QGModel
    with fft_impl="pallas" (its Pallas inversion in interpret mode) and the
    same overrides: zeta 1e-5, psi 2e-4, the pin gauge's psi compared as
    is. Off the TPU, tpu_qg engages only the mono form; for step_full and
    step_chain it runs its default route, the same mathematics (the forms
    themselves are held against tpu_qg's kernels in
    test_torch_fused_forms.py). On CPU tensors the kernels' plain versions
    run and no launch is counted."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(
        M=256, P=P, fft_impl="pallas", **overrides)
    cfg = config_from_jax(jcfg)
    assert core.use_step_kernel(cfg)
    psi0 = _psi_init(jcfg, seed=7)
    counters = (fused_step, y_dft, pair_x_symbols, x_dft, x_symbols_inverse,
                fused_pre_inversion, mono_invert, fused_step_full,
                fused_step_yspec)
    before = [c.launches for c in counters]
    model = tpu_qg_torch.QGModel(cfg, device="cpu")
    assert model.route == route
    got = model.run(model.init_state(psi_init=psi0), 10)
    assert [c.launches for c in counters] == before
    want = tpu_qg.QGModel(jcfg).run(
        tpu_qg.QGModel(jcfg).init_state(psi_init=psi0), 10)
    assert got.zeta.dtype == torch.float32
    assert _rel(got.zeta, want.zeta) <= 1e-5
    assert _rel(got.psi, want.psi) <= 2e-4


def test_kernel_inverter_plain_matches_pallas_pair_x():
    M, P = 256, 512
    jcfg = tpu_qg.preset("turbulence-2048").replace(M=M, P=P)
    args = (M, P, jcfg.dx, jcfg.S_eig, jcfg.P_inv_matrix(),
            jcfg.back_projection_matrix())
    zeta = np.array(tpu_qg.init_state(
        jcfg, psi_init=_psi_init(jcfg, seed=3)).zeta, np.float32)
    want = PackedModalInverterPallasFFT(*args, interpret=True,
                                        pair_x=True)(jnp.asarray(zeta))
    got = PackedModalInverterKernels(*args)(torch.from_numpy(zeta))
    assert _rel(got, want) <= 1e-4


def test_interop_round_trip_is_bit_exact():
    jcfg = tpu_qg.preset("two-layer-256").replace(M=32, P=32, dtype="float64")
    js = tpu_qg.QGModel(jcfg).run(tpu_qg.init_state(
        jcfg, psi_init=_psi_init(jcfg, seed=4)), 3)
    arrays = [np.asarray(a) for a in js[:4]] + [int(js.step)]
    ts = state_from_numpy(*arrays, device="cpu")
    assert ts.step == 3
    back = state_to_numpy(ts)
    for a, b in zip(arrays[:4], back[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert back[4] == 3


def _continue_jax(jcfg, state, n):
    return tpu_qg.QGModel(jcfg).run(state, n)


def test_tpu_qg_checkpoint_resumes_in_torch_and_back(tmp_path):
    jcfg = tpu_qg.preset("turbulence-2048").replace(M=64, P=64,
                                                    dtype="float64")
    cfg = config_from_jax(jcfg)
    js = _continue_jax(jcfg, tpu_qg.init_state(
        jcfg, psi_init=_psi_init(jcfg, seed=5)), 4)
    jio.RunWriter(tmp_path / "a", jcfg).write_checkpoint(js)
    reader = tio.RunReader(tmp_path / "a")
    assert reader.config() == cfg
    ts = reader.load_checkpoint(device="cpu")
    assert ts.step == 4
    model = tpu_qg_torch.QGModel(cfg, device="cpu")
    ts = model.run(ts, 3)
    want = _continue_jax(jcfg, js, 3)
    assert _rel(ts.zeta, want.zeta) <= 1e-12
    # ... and the torch checkpoint resumes in tpu_qg.
    tio.RunWriter(tmp_path / "b", cfg).write_checkpoint(ts)
    jreader = jio.RunReader(tmp_path / "b")
    assert jreader.config() == jcfg
    js2 = jreader.load_checkpoint()
    assert int(js2.step) == 7
    got = _continue_jax(jcfg, js2, 2)
    ref = model.run(ts, 2)
    assert _rel(got.zeta, ref.zeta) <= 1e-12
    assert not [p for p in os.listdir(tmp_path / "b") if p.endswith(".tmp")]


def test_cli_runs_on_cpu_with_checkpoints_and_resume(tmp_path, capsys):
    run_dir = str(tmp_path / "run")
    args = ["--device", "cpu", "--preset", "two-layer-256", "--run-dir",
            run_dir, "--set", "M=32", "P=32", "dt=3600.0"]
    trun.main(args + ["--steps", "30", "--checkpoint-every", "24"])
    assert "step 24/30" in capsys.readouterr().out
    reader = tio.RunReader(run_dir)
    assert reader.checkpoint_steps() == [24, 30]
    assert reader.snapshot_steps() == [0, 24]
    trun.main(args + ["--steps", "36", "--resume"])
    assert "Resumed from step 30" in capsys.readouterr().out
    assert tio.RunReader(run_dir).checkpoint_steps() == [24, 30, 36]
    z, p = jio.RunReader(run_dir).load_snapshot(24)
    assert z.shape == (2, 32, 32) and np.isfinite(p).all()


def test_cli_no_save_and_sharded_flags(monkeypatch, capsys, tmp_path):
    """--no-save on one device; then the sharded flags in a one-rank gloo
    group from torchrun's environment (a free port): --mesh 1,1 runs the
    halo stepper, --checkpoint-mode sharded writes the rank's shard files,
    and --parallel gspmd runs with shard-file checkpoints and resumes from
    them, on the single-device per-mode step's trajectory."""
    import socket
    trun.main(["--device", "cpu", "--preset", "turbulence-2048", "--steps",
               "2", "--no-save", "--set", "M=64", "P=64"])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                     WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    small = ["--device", "cpu", "--preset", "turbulence-2048", "--steps", "2",
             "--set", "M=64", "P=64"]
    trun.main(small + ["--no-save", "--mesh", "1,1"])
    assert "step 2/2" in capsys.readouterr().out
    run_dir = tmp_path / "sharded"
    trun.main(small + ["--run-dir", str(run_dir), "--distributed",
                       "--checkpoint-mode", "sharded"])
    assert "step 2/2" in capsys.readouterr().out
    assert sorted(p.name for p in run_dir.glob("checkpoint_*")) == [
        "checkpoint_000000002-shard00000.index.json",
        "checkpoint_000000002-shard00000.npz"]
    assert jio.RunReader(run_dir).load_checkpoint().zeta.shape == (2, 64, 64)
    gspmd_dir = tmp_path / "gspmd"
    gspmd = ["--run-dir", str(gspmd_dir), "--mesh", "1,1", "--parallel",
             "gspmd", "--checkpoint-mode", "sharded", "--checkpoint-every",
             "1"]
    trun.main(small + gspmd)
    assert "step 2/2" in capsys.readouterr().out
    trun.main(small + gspmd + ["--steps", "3", "--resume"])
    out = capsys.readouterr().out
    assert "Resumed from step 2" in out and "step 3/3" in out
    assert "gspmd" in out
    reader = tio.RunReader(gspmd_dir)
    assert reader.checkpoint_steps() == [2, 3]
    assert reader.shard_files("checkpoint", 3)
    cfg = tpu_qg_torch.preset("turbulence-2048").replace(M=64, P=64)
    step = core.make_step_fn(cfg, batched_fft=False)
    want = core.init_state(cfg, "cpu")
    for _ in range(3):
        want = step(want)
    got = reader.load_checkpoint(device="cpu")
    for f in ("zeta", "psi", "f1", "f2"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("preset,sets", [
    ("pod-8192", ["fft_pairx=off"]), ("pod-8192-mg", ["fft_pairx=off"]),
    ("turbulence-2048", ["poisson_gauge=pin"]),
    ("turbulence-2048", ["fft_mono=on"]), ("turbulence-2048", ["step_full=on"]),
    ("turbulence-2048", ["step_chain=on"])])
def test_cli_runs_the_large_grid_and_pin_routes_on_cpu(preset, sets, capsys):
    """The presets of the four-pass, K8 and one-launch routes, cut to 256^2,
    run through the CLI on the CPU (the kernels' plain versions, same
    routing)."""
    trun.main(["--device", "cpu", "--preset", preset, "--steps", "3",
               "--no-save", "--set", "M=256", "P=256", *sets])
    assert "step 3/3" in capsys.readouterr().out


def _default_device_calls(tmp_path):
    """Each entry point called with its default device."""
    cfg = tpu_qg_torch.preset("turbulence-2048").replace(M=64, P=64)
    tio.RunWriter(tmp_path, cfg).write_checkpoint(core.init_state(cfg, "cpu"))
    domain = spectral.RectangularDomain(0.0, 1.0, 0.0, 1.0)
    return {
        "run_model": lambda: trun.run_model(cfg, save_results=False,
                                            n_steps=1, verbose=False),
        "cli": lambda: trun.main(["--preset", "turbulence-2048", "--steps",
                                  "1", "--no-save"]),
        "QGModel": lambda: tpu_qg_torch.QGModel(cfg),
        "load_checkpoint": lambda: tio.RunReader(tmp_path).load_checkpoint(),
        "solve_helmholtz_fn": lambda: spectral.solve_helmholtz_fn(
            8, 8, 0.125, lambda x, y: x * y, 1.0, domain),
    }


@pytest.mark.parametrize("entry", ["run_model", "cli", "QGModel",
                                   "load_checkpoint", "solve_helmholtz_fn"])
def test_default_device_raises_without_gpu(entry, tmp_path):
    """Every entry point runs on the card unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no GPU"):
        _default_device_calls(tmp_path)[entry]()


def test_nan_state_raises_and_writes_emergency_checkpoint(tmp_path):
    cfg = tpu_qg_torch.preset("two-layer-256").replace(M=32, P=32)
    state = core.init_state(cfg, "cpu")
    state = state._replace(zeta=state.zeta.clone())
    state.zeta[0, 3, 3] = float("nan")
    with pytest.raises(FloatingPointError, match="emergency checkpoint"):
        trun.run_model(cfg, run_dir=str(tmp_path), n_steps=3, verbose=False,
                       state=state, sample_interval=cfg.dt, device="cpu")
    assert tio.RunReader(tmp_path).checkpoint_steps() == [1]


def test_import_pulls_in_no_jax():
    code = ("import sys, tpu_qg_torch, tpu_qg_torch.run, tpu_qg_torch.io, "
            "tpu_qg_torch.interop, tpu_qg_torch.utils.diagnostics, "
            "tpu_qg_torch.ops.multigrid, tpu_qg_torch.ops.mg_kernels, "
            "tpu_qg_torch.parallel, tpu_qg_torch.parallel.stepper, "
            "tpu_qg_torch.ops._stencil_lab, "
            "tpu_qg_torch.scripts.stencil_lab, "
            "tpu_qg_torch.ops.operators, tpu_qg_torch.ops.boundary, "
            "tpu_qg_torch.ops.matmul_fft, tpu_qg_torch.validation, "
            "tpu_qg_torch.validation.twin, "
            "tpu_qg_torch.validation.linear_theory, "
            "tpu_qg_torch.validation.allclose, "
            "tpu_qg_torch.scripts.inv_f64_check, "
            "tpu_qg_torch.scripts.step_f64_check, "
            "tpu_qg_torch.scripts.accuracy_drift, "
            "tpu_qg_torch.parallel.gspmd, tpu_qg_torch.utils.profiling, "
            "tpu_qg_torch.plotting; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'tpu_qg.')) or m == 'tpu_qg']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("overrides,match", [
    (dict(fft_mxu="bf16x3"), "bf16x3"),
])
def test_unported_kernels_raise(overrides, match):
    cfg = tpu_qg_torch.preset("turbulence-2048").replace(M=256, P=256)
    with pytest.raises(NotImplementedError, match=match):
        core.make_step_fn(cfg.replace(**overrides))


def test_pinned_pair_x_that_cannot_engage_raises():
    """fft_pairx="on" where the pair-x route does not engage fails, as in
    the reference (tpu_qg/models/core.py:367-372)."""
    cfg = tpu_qg_torch.preset("turbulence-2048").replace(
        M=4096, P=4096, fft_pairx="on")
    with pytest.raises(ValueError, match="mirror-pair kernel cannot engage"):
        core.make_step_fn(cfg)
    core.make_step_fn(cfg.replace(M=2432, P=256))


@pytest.mark.parametrize("overrides,match", [
    (dict(fft_mono="on"), "monolithic kernel cannot engage"),
    (dict(step_full="on"), "one-launch kernel cannot engage")],
    ids=["fft_mono=on", "step_full=on"])
def test_pinned_one_launch_form_that_cannot_engage_raises(overrides, match):
    """A one-launch form pinned "on" where the reference's gate rejects the
    shape fails with the reference's wording (tpu_qg/models/core.py:362-366,
    558-563)."""
    cfg = tpu_qg_torch.preset("turbulence-2048").replace(M=4096, P=4096,
                                                         **overrides)
    with pytest.raises(ValueError, match=match):
        core.make_step_fn(cfg)


K8 = "K8 + BatchedModalSolver"


def _route(cfg) -> str:
    """The route label: the one-launch step or the chain where they engage,
    else the step's inversion route ("mono" for K16)."""
    route = tpu_qg_torch.QGModel(cfg, device="cpu").route
    if route in ("fullstep", "chain"):
        return route
    solver = core._build_solvers(cfg)
    if isinstance(solver, PackedModalInverterKernels):
        return solver.route
    if isinstance(solver, PackedModalInverter):
        return "torch.fft"
    return K8 if core.use_step_kernel(cfg) else "BatchedModalSolver"


@pytest.mark.parametrize("overrides,step_kernel,fft,route", [
    (dict(), True, "kernels", "pair-x"),
    (dict(M=128, P=128), False, "kernels", "pair-x"),   # below the step floor
    (dict(dtype="float64"), False, "xla", "torch.fft"),
    (dict(use_pallas=False), False, "xla", "torch.fft"),
    (dict(fft_impl="xla"), True, "xla", "torch.fft"),
    (dict(M=256, P=384), True, "kernels", "pair-x"),   # 128 * 3: mixed radix
    (dict(M=64, P=64), False, "xla", "torch.fft"),     # below 128 * n
    pytest.param(dict(n_layers=1), True, "kernels", K8, id="n_layers=1"),
    pytest.param(dict(poisson_gauge="pin"), True, "kernels", K8, id="pin"),
    pytest.param(dict(fft_pairx="off"), True, "kernels", "four-pass",
                 id="fft_pairx=off"),
    pytest.param(dict(M=4096, P=4096), True, "kernels", "four-pass",
                 id="4096"),
    pytest.param(dict(M=4224), True, "kernels", "four-pass-unfused",
                 id="4224"),
    pytest.param(dict(M=8192, P=8192), True, "kernels", "four-pass",
                 id="8192"),
    pytest.param(dict(M=128, P=128, poisson_gauge="pin"), False, "kernels",
                 "BatchedModalSolver", id="pin-below-floor"),
    pytest.param(dict(fft_mono="on"), True, "kernels", "mono", id="K16"),
    pytest.param(dict(step_full="on"), True, "kernels", "fullstep",
                 id="K17"),
    pytest.param(dict(step_chain="on"), True, "kernels", "chain", id="K15"),
    pytest.param(dict(M=128, P=128, step_full="on"), False, "kernels",
                 "pair-x", id="K17-below-floor"),
    pytest.param(dict(step_chain="on", poisson_gauge="pin"), True, "kernels",
                 K8, id="K15-not-pin"),
    pytest.param(dict(step_chain="on", n_layers=1), True, "kernels", K8,
                 id="K15-not-one-layer"),
    pytest.param(dict(step_chain="on", M=4224), True, "kernels",
                 "four-pass-unfused", id="K15-not-4224"),
    pytest.param(dict(step_chain="on", step_full="on"), True, "kernels",
                 "fullstep", id="K17-over-K15"),
])
def test_routing(overrides, step_kernel, fft, route):
    cfg = tpu_qg_torch.preset("turbulence-2048").replace(
        **{"M": 256, "P": 256, **overrides})
    assert core.use_step_kernel(cfg) == step_kernel
    assert core.resolve_fft_impl(cfg) == fft
    assert _route(cfg) == route


def test_pair_x_route_matches_the_reference_bounds():
    sizes = [128 * n for n in (1, 2, 3, 8, 16, 19, 20, 24, 32, 33, 35, 36,
                               64)]
    for M in sizes:
        for P in sizes:
            ref_pair = (planar_fft2_fits(M, P) and symbol_inverse_fits(M, P)
                        and pair_x_fits(M, P))
            assert spectral.reference_pair_x(M, P) == ref_pair, (M, P)
            assert spectral.reference_dft_kernels(M, P) == planar_fft2_fits(
                M, P)
            assert spectral.reference_symbol_inverse(M, P) == (
                planar_fft2_fits(M, P) and symbol_inverse_fits(M, P)), (M, P)


def test_kernels_take_every_shape_of_the_pair_x_route():
    """K2 and K3 cover every extent on which the reference runs its pair-x
    inversion, and K2, K4 and K5 every extent of its four-pass inversion
    (all its DFT-kernel shapes, fft_pairx="off" included), so the kernel
    routes never need to give way to torch.fft."""
    sizes = range(128, 128 * 64 + 1, 128)
    for M in sizes:
        for P in sizes:
            if spectral.reference_pair_x(M, P):
                assert kernels_take(M, P), (M, P)
            if spectral.reference_dft_kernels(M, P):
                assert x_kernels_take(M, P), (M, P)


def test_random_initial_condition_is_seeded():
    cfg = tpu_qg_torch.preset("turbulence-2048").replace(M=32, P=32)
    a = core.init_state(cfg, "cpu")
    b = core.init_state(cfg, "cpu")
    c = core.init_state(cfg, "cpu", seed=1)
    torch.testing.assert_close(a.psi, b.psi, rtol=0, atol=0)
    assert not torch.equal(a.psi, c.psi)
    amp = cfg.initial_kick * cfg.U * cfg.Ly
    assert 0.0 <= float(a.psi.min()) and float(a.psi.max()) < amp
    assert dataclasses.asdict(cfg)["seed"] == 0


def test_diagnostics_match_tpu_qg():
    from tpu_qg.utils.diagnostics import diagnostics as jdiag
    from tpu_qg.utils.diagnostics import energy_spectrum as jspec
    from tpu_qg_torch.utils.diagnostics import diagnostics, energy_spectrum
    jcfg = tpu_qg.preset("turbulence-2048").replace(M=32, P=48,
                                                    dtype="float64")
    js = tpu_qg.init_state(jcfg, psi_init=_psi_init(jcfg, seed=6))
    ts = state_from_numpy(*(np.asarray(a) for a in js[:4]), 0, "cpu")
    want, got = jdiag(jcfg, js), diagnostics(config_from_jax(jcfg), ts)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    kb, E = energy_spectrum(config_from_jax(jcfg), ts.psi)
    jkb, jE = jspec(jcfg, js.psi)
    np.testing.assert_allclose(kb, jkb, rtol=1e-12)
    np.testing.assert_allclose(E, jE, rtol=1e-12)

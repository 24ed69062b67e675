"""tpu_qg_torch's validation modules against tpu_qg's on the same seeded
numpy inputs, and the port's model against them: ops.operators and
ops.boundary (equal), ReferenceTwin (20 steps, 1e-14), linear_theory
(1e-12); the port's QGModel against the port's twin (500 steps, rtol 1e-5;
the pin gauge 100 steps, rtol 1e-6, tests/test_model.py:27-65) and against
the discrete linear theory's growth rate (1e-4,
tests/test_linear_theory.py:39-44); the allclose command line; run_model's
debug_nans; the three float64 check scripts' records."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_qg.config import ModelConfig as JCfg
from tpu_qg.constants import KM, MINUTES, YEAR
from tpu_qg.ops import boundary as ref_boundary
from tpu_qg.ops import operators as ref_op
from tpu_qg.validation import ReferenceTwin as RefTwin
from tpu_qg.validation import linear_theory as ref_lt
import tpu_qg_torch
from tpu_qg_torch import io as tio
from tpu_qg_torch import run as trun
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.models import core
from tpu_qg_torch.ops import boundary as ours_boundary
from tpu_qg_torch.ops import operators as ours_op
from tpu_qg_torch.scripts import accuracy_drift, inv_f64_check, step_f64_check
from tpu_qg_torch.validation import ReferenceTwin, allclose
from tpu_qg_torch.validation import linear_theory as ours_lt


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def small_cfg(**kw):
    """tests/test_model.py:14-23's configuration, for both packages."""
    base = dict(H_1=1.0 * KM, H_2=2.0 * KM, beta=2e-11, Lx=4000.0 * KM,
                Ly=4000.0 * KM, dt=60.0 * MINUTES, T=1.0 * YEAR, U=0.1,
                M=32, P=32, visc=100.0, r=1e-7, R_d=40.0 * KM,
                initial_kick=1e-6, dtype="float64")
    base.update(kw)
    jcfg = JCfg(**base)
    return jcfg, config_from_jax(jcfg)


def _psi_init(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return cfg.initial_kick * cfg.U * cfg.Ly * rng.random((2, cfg.M, cfg.P))


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


# --- ops.operators and ops.boundary ------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("laplacian_1d", (5,)), ("laplacian_2d", (4, 3)),
    ("laplacian_1d_periodic", (6,)), ("laplacian_2d_doubly_periodic", (4, 5)),
    ("construct_spA", (4, 5, 0.7, -2.0)),
    ("gauge_fixed_poisson_matrix", (5, 4, 0.5))])
def test_operator_matrices_equal(name, args):
    got, want = getattr(ours_op, name)(*args), getattr(ref_op, name)(*args)
    assert got.format == want.format == "csc"
    np.testing.assert_array_equal(got.toarray(), want.toarray())


@pytest.mark.parametrize("alpha", [0.0, -1.0 / (40.0 * KM) ** 2])
def test_factorized_solver_equal(alpha):
    """FactorizedSolver.solve, with the column-major vec and the pinned
    b[0] = 0 of the Poisson case, and the one-shot solves."""
    M, P, dx = 12, 10, 15625.0
    f = np.random.default_rng(0).standard_normal((M, P))
    got = ours_op.FactorizedSolver(M, P, dx, alpha)
    want = ref_op.FactorizedSolver(M, P, dx, alpha)
    assert got.pin == want.pin == (alpha == 0.0)
    np.testing.assert_array_equal(got.solve(f), want.solve(f))
    if alpha == 0.0:
        np.testing.assert_array_equal(ours_op.sp_solve_poisson(f, dx),
                                      ref_op.sp_solve_poisson(f, dx))
    else:
        np.testing.assert_array_equal(
            ours_op.sp_solve_modified_helmholtz(f, dx, alpha),
            ref_op.sp_solve_modified_helmholtz(f, dx, alpha))


@pytest.mark.parametrize("shape", [(5, 7), (2, 6, 4)])
def test_boundary_equal(shape):
    u = np.random.default_rng(1).standard_normal(shape)
    ring = ours_boundary.add_ghost_ring(torch.from_numpy(u))
    np.testing.assert_array_equal(
        ring.numpy(), np.asarray(ref_boundary.add_ghost_ring(jnp.asarray(u))))
    np.testing.assert_array_equal(ours_boundary.strip_ghost_ring(ring).numpy(),
                                  u)
    stale = ring.clone()
    stale[..., 0, :] = 0.0
    np.testing.assert_array_equal(
        ours_boundary.update_ghost_ring(stale).numpy(),
        np.asarray(ref_boundary.update_ghost_ring(jnp.asarray(stale.numpy()))))


# --- The twin -----------------------------------------------------------------

def test_twin_matches_tpu_qg_twin():
    """20 steps of the port's twin on the port's config against tpu_qg's
    twin, 1e-14 (the Euler start and AB3 both)."""
    jcfg, cfg = small_cfg()
    psi0 = _psi_init(jcfg, seed=4)
    zeta, psi, samples = ReferenceTwin(cfg).run(psi0, 20, sample_every=10)
    z_ref, p_ref, s_ref = RefTwin(jcfg).run(psi0, 20, sample_every=10)
    for got, want in [(zeta, z_ref), (psi, p_ref), *zip(samples[0], s_ref[0])]:
        _close(got, want, 1e-14)


def test_twin_refuses_one_layer():
    _, cfg = small_cfg(n_layers=1, U=0.0)
    with pytest.raises(ValueError, match="two-layer"):
        ReferenceTwin(cfg)


def test_model_matches_twin_500_steps():
    """The port's spectral path (float64, CPU) against the port's twin after
    500 AB3 steps from identical ICs (tests/test_model.py:27-50)."""
    _, cfg = small_cfg()
    psi0 = _psi_init(cfg)
    z_ref, p_ref = ReferenceTwin(cfg).run(psi0, 500)
    model = core.QGModel(cfg, device="cpu")
    out = model.run(model.init_state(psi_init=psi0), 500)
    np.testing.assert_allclose(out.zeta.numpy(), z_ref, rtol=1e-5,
                               atol=1e-18)
    # psi differs by the Poisson gauge constant per layer: mean-removed.
    p_ours = out.psi.numpy()
    p_ours = p_ours - p_ours.mean(axis=(1, 2), keepdims=True)
    p_ref = p_ref - p_ref.mean(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(p_ours, p_ref, rtol=1e-5, atol=1e-12)


def test_pin_gauge_matches_twin_psi_pointwise():
    """With poisson_gauge='pin', psi matches the twin pointwise
    (tests/test_model.py:55-65)."""
    _, cfg = small_cfg(poisson_gauge="pin")
    psi0 = _psi_init(cfg, seed=1)
    z_ref, p_ref = ReferenceTwin(cfg).run(psi0, 100)
    model = core.QGModel(cfg, device="cpu")
    out = model.run(model.init_state(psi_init=psi0), 100)
    np.testing.assert_allclose(out.psi.numpy(), p_ref, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(out.zeta.numpy(), z_ref, rtol=1e-6,
                               atol=1e-18)


# --- linear_theory -------------------------------------------------------------

def _lt_cfg(**kw):
    base = dict(M=64, P=64, Lx=4000.0 * KM, Ly=4000.0 * KM,
                dt=15.0 * MINUTES, T=1.0, U=0.5, visc=100.0, r=1e-8,
                R_d=40.0 * KM, dtype="float64")
    base.update(kw)
    jcfg = JCfg(**base)
    return jcfg, config_from_jax(jcfg)


@pytest.mark.parametrize("quirk", [True, False])
def test_linear_theory_matches(quirk):
    jcfg, cfg = _lt_cfg(compat_reference_P=quirk)
    lam = -3.0 / cfg.dx ** 2
    _close(ours_lt.inversion_map(cfg, lam), ref_lt.inversion_map(jcfg, lam),
           1e-12)
    for kappa, ell in [(5, 3), (1, 0), (31, 2)]:
        _close(ours_lt.linear_matrix(cfg, kappa, ell),
               ref_lt.linear_matrix(jcfg, kappa, ell), 1e-12)
        sig, vec = ours_lt.growth_rate(cfg, kappa, ell)
        sig_ref, vec_ref = ref_lt.growth_rate(jcfg, kappa, ell)
        _close(sig, sig_ref, 1e-12)
        _close(vec, vec_ref, 1e-12)
    got = ours_lt.fastest_growing_mode(cfg, max_kappa=12)
    want = ref_lt.fastest_growing_mode(jcfg, max_kappa=12)
    assert got[:2] == want[:2]
    _close(got[2], want[2], 1e-12)
    _close(got[3], want[3], 1e-12)
    _close(ours_lt.eigenmode_fields(cfg, *got[:2], got[3], 1e-8),
           ref_lt.eigenmode_fields(jcfg, *want[:2], want[3], 1e-8), 1e-12)


def test_growth_rate_matches_linear_theory():
    """The port's model initialized with the fastest-growing discrete
    eigenmode grows at the theory's rate (1e-4), as
    tests/test_linear_theory.py:39-44 holds tpu_qg's."""
    _, cfg = _lt_cfg()
    kappa, ell, sigma, vec = ours_lt.fastest_growing_mode(cfg, max_kappa=20)
    assert sigma.real > 0, "config must be baroclinically unstable"
    zeta0 = torch.from_numpy(ours_lt.eigenmode_fields(cfg, kappa, ell, vec,
                                                      1e-8))
    psi0 = core._invert_psi(cfg, core._build_solvers(cfg), zeta0)
    model = core.QGModel(cfg, device="cpu")
    zero = torch.zeros_like(zeta0)
    s = core.State(zeta0, psi0, zero, zero.clone(), 0)
    amps = []
    for i in range(150):
        s = model.step(s)
        if i >= 50:
            amps.append(float(torch.sqrt(torch.mean(s.zeta[0] ** 2))))
    measured = np.polyfit(np.arange(len(amps)) * cfg.dt, np.log(amps), 1)[0]
    assert abs(measured - sigma.real) / sigma.real < 1e-4


# --- The command lines ---------------------------------------------------------

def test_allclose_cli_passes_on_cpu(tmp_path, capsys):
    out = tmp_path / "verdict.json"
    assert allclose.main(["--device", "cpu", "--M", "32", "--steps", "50",
                          "--check-every", "25", "--out", str(out)]) == 0
    verdict = json.loads(out.read_text())
    assert verdict["passed"] and verdict["rel_err_zeta"] < 1e-5
    assert [h["step"] for h in verdict["history"]] == [25, 50]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["target_rtol"] == 1e-5 and "history" not in last


@pytest.mark.parametrize("field,seen", [("zeta", "zeta"), ("f1", "f2")])
def test_debug_nans_names_step_and_field(field, seen, tmp_path):
    """With debug_nans a state seeded with a NaN stops after the first step
    at the first non-finite field (a NaN in f1 moves to f2 under
    euler_ab3), after the emergency checkpoint."""
    cfg = tpu_qg_torch.preset("two-layer-256").replace(
        M=32, P=32, time_scheme="euler_ab3")
    state = core.init_state(cfg, "cpu")
    seeded = getattr(state, field).clone()
    seeded[0, 3, 3] = float("nan")
    state = state._replace(**{field: seeded})
    with pytest.raises(FloatingPointError,
                       match=f"non-finite {seen} at step 1 .*emergency"):
        trun.run_model(cfg, run_dir=str(tmp_path), n_steps=5, verbose=False,
                       state=state, device="cpu", debug_nans=True)
    assert tio.RunReader(tmp_path).checkpoint_steps() == [1]


def test_debug_nans_cli(capsys):
    trun.main(["--device", "cpu", "--preset", "turbulence-2048", "--steps",
               "2", "--no-save", "--set", "M=64", "P=64", "--debug-nans"])
    assert "step 2/2" in capsys.readouterr().out


def test_inv_f64_check_record(tmp_path):
    out = tmp_path / "inv.json"
    rec = inv_f64_check.main(["--device", "cpu", "--M", "128", "--out",
                              str(out)])
    assert json.loads(out.read_text()) == rec
    assert rec["device"] == "cpu" and (rec["M"], rec["P"]) == (128, 128)
    for tier in ("torch_fft", "matmul", "kernels"):
        assert 0.0 < rec[f"{tier}_f32_vs_f64"] < 1e-4


def test_step_f64_check_record(tmp_path):
    out = tmp_path / "step.json"
    assert step_f64_check.main(["--device", "cpu", "--M", "128", "--steps",
                                "3", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert set(rec["err_vs_f64"]) == set(rec["tier_passed"]) == {
        "torch_fft", "matmul", "kernels"}
    assert rec["steps"] == 3 and rec["passed"]
    assert rec["limit"] == 2.0 * rec["err_vs_f64"]["torch_fft"]
    assert step_f64_check.tiers_for(64, 64).keys() == {"torch_fft", "matmul"}


def test_accuracy_drift_record(tmp_path):
    out = tmp_path / "drift.json"
    rec = accuracy_drift.main(["--device", "cpu", "--M", "128", "--steps",
                               "4", "--chunk", "2", "--out", str(out)])
    assert json.loads(out.read_text()) == rec
    assert [r["tier"] for r in rec["records"]] == ["torch_fft", "kernels"]
    series = rec["records"][1]["series"]
    assert series["step"] == [2, 4] and len(series["energy"]) == 2
    assert len(rec["records"][0]["spectrum"]) == 2
    assert set(rec["vs_torch_fft"]["kernels"]) == {
        "max_rel_energy_diff", "max_rel_enstrophy_diff"}

"""K18's plain versions (tpu_qg_torch.ops._stencil_lab) against tpu_qg's
stencil-lab step in interpret mode, the CPU wrapper, and the port's lab
command line (tpu_qg_torch.scripts.stencil_lab), float32 at 128^2.

Tolerance 1e-5 of max|ref| (PERF.md section 2: plain versions against
tpu_qg's kernels in float32): the kernel builds its wind row from a float32
sin where the port rounds a float64 one. norot's tendency is zero apart from
the wind, so its carry under euler_ab3 is held against the tendency's scale.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops._stencil_lab import lab_step as j_lab_step
from tpu_qg_torch.interop import state_from_numpy
from tpu_qg_torch.models.core import _tendencies
from tpu_qg_torch.ops import _stencil_lab
from tpu_qg_torch.ops._stencil_lab import BODIES, lab_step, lab_step_plain
from tpu_qg_torch.scripts import stencil_lab

TOL = 1e-5
M = 128
VARIANTS = ("base", "legacy", "aligned", "norot", "noslice", "nojac")
# case: (config overrides, layers, step)
CASES = {"euler_ab3 step 0": ({}, 2, 0), "euler_ab3 step 2": ({}, 2, 2),
         "leapfrog_ra step 1": (dict(time_scheme="leapfrog_ra"), 2, 1),
         "wind": (dict(wind_tau0=0.1), 2, 2),
         "one layer": (dict(n_layers=1), 1, 2)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(**over):
    """The lab's configuration at M^2 in the port and in tpu_qg."""
    cfg = stencil_lab.lab_config(M).replace(**over)
    return cfg, tpu_qg.ModelConfig(**dataclasses.asdict(cfg))


def _inputs(jcfg, layers, seed=0):
    """zeta from a random psi (the model's definition), random f1/f2 at the
    tendency's scale; float32 numpy, and that scale."""
    rng = np.random.default_rng(seed)
    psi = jcfg.initial_kick * jcfg.U * jcfg.Ly * rng.random((layers, M, M))
    zeta = np.array(tpu_qg.init_state(jcfg, psi_init=psi).zeta)
    scale = float(_tendencies(stencil_lab.lab_config(M).replace(
        n_layers=layers), torch.from_numpy(zeta),
        torch.from_numpy(psi)).abs().max())
    f1, f2 = (scale * rng.standard_normal(psi.shape) for _ in range(2))
    return [a.astype(np.float32) for a in (zeta, psi, f1, f2)], scale


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_tpu_qg_lab_step(variant, case):
    over, layers, step = CASES[case]
    cfg, jcfg = _configs(**over)
    arrays, scale = _inputs(jcfg, layers)
    want = j_lab_step(jcfg, *(jnp.asarray(a) for a in arrays),
                      jnp.int32(step), variant, True, 32)
    st = state_from_numpy(*arrays, step, "cpu")
    got = lab_step_plain(cfg, st.zeta, st.psi, st.f1, st.f2, st.step, variant)
    for part, g, w in zip(("zeta_new", "carry"), got, want):
        w = np.asarray(w)
        floor = scale if (variant, part) == ("norot", "carry") else 0.0
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=TOL * max(np.abs(w).max(), floor),
            err_msg=part)


def test_variants_are_tpu_qg_s():
    from tpu_qg.ops._stencil_lab import BODIES as j_bodies
    assert set(BODIES) == set(j_bodies) == set(_stencil_lab.KERNEL_BODY)


def test_cpu_wrapper_runs_plain_without_counting():
    cfg, jcfg = _configs(time_scheme="leapfrog_ra")
    st = state_from_numpy(*_inputs(jcfg, 2)[0], 3, "cpu")
    before = lab_step.launches
    for variant in VARIANTS:
        got = lab_step(cfg, st.zeta, st.psi, st.f1, st.f2, st.step, variant)
        want = lab_step_plain(cfg, st.zeta, st.psi, st.f1, st.f2, st.step,
                              variant)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert lab_step.launches == before
    with pytest.raises(KeyError):
        lab_step(cfg, st.zeta, st.psi, st.f1, st.f2, st.step, "nosuch")


def test_cli_records_each_variant(tmp_path, capsys):
    out = tmp_path / "lab.json"
    stencil_lab.main(["--device", "cpu", "--M", "128", "--chunk", "2",
                      "--reps", "1", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert list(rec["jobs"]) == stencil_lab.DEFAULT_VARIANTS.split(",")
    assert (rec["M"], rec["chunk"], rec["reps"]) == (128, 2, 1)
    for job in rec["jobs"].values():
        assert job["ms_per_iter"] > 0 and job["first_call_s"] > 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["variant"] for ln in lines] == list(rec["jobs"])


def test_cli_refuses_to_write_under_results():
    with pytest.raises(SystemExit):
        stencil_lab.main(["--device", "cpu", "--M", "128", "--out",
                          str(stencil_lab._RESULTS / "stencil_lab_128.json")])


@pytest.mark.parametrize("variant", ["base", "nojac"])
def test_lab_run_is_a_loop_of_the_plain_step(variant):
    """1 + reps chunks, psi fixed, the history shifted each step."""
    _, finals = stencil_lab.run_lab(128, 2, 1, [variant], "cpu")
    cfg = stencil_lab.lab_config(128)
    st = stencil_lab.init_state(cfg, "cpu", seed=stencil_lab.SEED)
    for _ in range(4):
        zn, carry = lab_step_plain(cfg, st.zeta, st.psi, st.f1, st.f2,
                                   st.step, variant)
        st = st._replace(zeta=zn, f1=carry, f2=st.f1, step=st.step + 1)
    got = finals[variant]
    assert got.step == 4
    for name in ("zeta", "psi", "f1", "f2"):
        assert torch.equal(getattr(got, name), getattr(st, name)), name

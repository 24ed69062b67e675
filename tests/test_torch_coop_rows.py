"""The persistent one-launch kernels K15 and K17 on the redesigned stages
(csrc/coop_rows.cuh), on the CPU: their host plan over every 128 * n square
up to 8192 and tests/test_torch_fused_forms.py's rectangles (each stage's
loop covers every unit of its separate kernel once, shared memory fits,
the take rule is the conjunction of the stage kernels' own); the
composition of the stage emulations (K1's row kernel, K2's factored
kernels, K3's cluster kernel) against tpu_qg's one-launch kernels in
interpret mode, at the smallest shapes at which every stage's redesigned
layout takes (float32 1e-5 of max, psi_new also held against float64);
and the wrappers on CPU tensors (the plain versions, no launch counted)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops.pallas_fullstep import fused_step_full as j_fused_step_full
from tpu_qg.ops.pallas_tendency import fused_step_streamed_yspec
from tpu_qg_torch import preset
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.models import core
from tpu_qg_torch.ops import dft_kernels, spectral, step_kernel
from tpu_qg_torch.ops.step_kernel import (
    coop_rows_plan, coop_rows_schedule, coop_rows_shape, coop_rows_takes,
    coop_rows_unit_rows,
    fused_step_full, fused_step_full_plain, fused_step_full_rows,
    fused_step_full_rows_emulated, fused_step_rows_emulated,
    fused_step_yspec, fused_step_yspec_plain, fused_step_yspec_rows,
    fused_step_yspec_rows_emulated, step_rows_layout)

SQUARES = [(n, n) for n in range(128, 8192 + 1, 128)]
# tests/test_torch_fused_forms.py's sample of 128 n extents.
SIZES = [128 * n for n in (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 15, 16, 19, 20, 24,
                           31, 32, 45, 53, 59, 63, 64)]
RECTANGLES = [(M, P) for M in SIZES for P in SIZES if M != P]


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


def _stage_takes(M, P, x_stage):
    """K1's row kernel, K2's factored or mixed kernel and (x_stage) K3's
    cluster or mixed cluster kernel all take (M, P)."""
    return (P % 4 == 0 and dft_kernels.y_dft_factored_takes(P)
            and (not x_stage or dft_kernels.pair_x_cluster_takes(M)))


# --- (a) the host plan ------------------------------------------------------

@pytest.mark.parametrize("shapes", ["squares", "rectangles"])
@pytest.mark.parametrize("x_stage", [False, True], ids=["K15", "K17"])
def test_take_rule_is_the_stage_kernels(shapes, x_stage):
    """The persistent kernel takes a shape exactly where every stage's
    redesigned kernel takes it, and there its plan's shared memory holds
    each stage and fits one block; the first forms keep the rest."""
    taken = 0
    for M, P in SQUARES if shapes == "squares" else RECTANGLES:
        want = _stage_takes(M, P, x_stage)
        assert coop_rows_shape(M, P, x_stage) == want, (M, P)
        if not want:
            continue
        taken += 1
        plan = coop_rows_plan(M, P, x_stage)
        assert plan.smem <= dft_kernels.SMEM_LIMIT
        assert plan.smem >= 2 * step_rows_layout(plan.step).smem
        assert plan.smem >= dft_kernels.y_dft_factored_layout(
            P, *plan.y).smem
        assert plan.y == dft_kernels.y_dft_factored_launched(P)
        assert plan.step[1] == step_kernel.step_rows_launched(M)[1]
        if x_stage:
            assert plan.x == dft_kernels.pair_x_cluster_launched(M)
            assert plan.smem >= dft_kernels.pair_x_cluster_layout(
                M, *plan.x).smem
    assert taken > 0


def test_every_shape_the_gates_admit_at_2048():
    """The shapes of chip_smoke.py's slices and sweeps: 2048^2 takes both
    persistent kernels in the separate kernels' launched layouts; 8192^2
    and 3072^2 take K15; 256^2 takes K15 only (K3's cluster kernel needs
    M >= 256 G), 128^2 neither."""
    p17 = coop_rows_plan(2048, 2048, True)
    assert (p17.step, p17.y, p17.x) == ((256, 64, 8, 128), (2, 256), (8, 16))
    assert coop_rows_plan(8192, 8192, False).step == (256, 32, 8, 128)
    for M in (1536, 2560):
        assert coop_rows_shape(M, M, True)
    assert coop_rows_shape(3072, 3072, False)
    assert coop_rows_shape(256, 256, False)
    assert not coop_rows_shape(256, 256, True)
    assert not coop_rows_shape(128, 128, False)


def _check_cover(assigned, units):
    """Every unit of ``units`` in exactly one list of ``assigned``."""
    seen = [u for lst in assigned.values() for u in lst]
    assert sorted(seen) == sorted(units)
    assert len(seen) == len(set(seen))


@pytest.mark.parametrize("x_stage", [False, True], ids=["K15", "K17"])
@pytest.mark.parametrize("blocks", [1, 3, 240, 396])
def test_stage_loops_cover_every_unit_once(x_stage, blocks):
    """On every square the persistent kernel takes (and the rectangles),
    with ``blocks`` blocks (K17: rounded down to whole clusters of G), each
    stage's loop runs each unit of its separate kernel exactly once: K1's
    (strip, run, layer) blocks (their runs lengthened where the grid would
    otherwise need a second round), K2's row groups, K3's tile pairs."""
    checked = 0
    for M, P in SQUARES[::5] + SQUARES[-1:] + RECTANGLES[::7]:
        if not coop_rows_shape(M, P, x_stage):
            continue
        plan = coop_rows_plan(M, P, x_stage)
        n = blocks
        if x_stage:
            n = max(plan.x[0], blocks // plan.x[0] * plan.x[0])
        sched = coop_rows_schedule(M, P, x_stage, n)
        W = plan.step[0]
        R = coop_rows_unit_rows(plan, n)
        assert R >= plan.step[1]
        assert len(sched["step_units"]) == 2 * -(-P // W) * -(-M // R)
        _check_cover(sched["step"], sched["step_units"])
        # One round wherever the grid holds a run of every strip and
        # layer: no half runs a second unit.
        if 2 * n >= 2 * -(-P // W):
            assert max(map(len, sched["step"].values())) == 1
        assert len(sched["y_units"]) == -(-M // plan.y[0])
        _check_cover(sched["y"], sched["y_units"])
        if x_stage:
            own, _ = dft_kernels.x_symbols_cluster_tiles(P, plan.x[1])
            assert len(sched["x_units"]) == own.shape[0]
            assert len(sched["x"]) == n // plan.x[0]
            _check_cover(sched["x"], sched["x_units"])
        checked += 1
    assert checked > 0


# --- (b) the stages' composition against tpu_qg --------------------------------

def _step_inputs(jcfg, seed):
    """float32 (zeta, psi, f1, f2) of a grid-noise psi, histories near the
    tendency's scale (tests/test_torch_fused_forms.py's)."""
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((2, jcfg.M, jcfg.P)) * 1e-4
    s = tpu_qg.init_state(jcfg, psi_init=psi.astype(np.float32))
    zeta = np.asarray(s.zeta, np.float32)
    scale = np.abs(zeta).max() / jcfg.dt * 1e-3
    f1, f2 = (scale * rng.standard_normal(zeta.shape) for _ in range(2))
    return (zeta, np.asarray(s.psi, np.float32), f1.astype(np.float32),
            f2.astype(np.float32))


# K3's cluster kernel at its smallest M: 1024 = 128 * 2^3 (G = 4, the
# power-of-two instance) and 896 = 128 * 7 (U = 4 = G, the mixed one), on
# K2's smallest factored extent, P = 256.
@pytest.mark.parametrize("M,P,scheme,step", [(1024, 256, "euler_ab3", 5),
                                              (896, 256, "leapfrog_ra", 3)])
def test_fullstep_stages_match_pallas(M, P, scheme, step):
    """K17's stages (the row kernel's emulation in the step layout, K2's
    factored emulation both ways, K3's cluster emulation in its launched
    (G, Cw)) against tpu_qg's one-launch step in interpret mode, past the
    scheme's start, with wind: zeta_new and carry 1e-5 of their max,
    psi_new 1e-5 of tpu_qg's and 1e-6 of the float64 plain version (the
    1/lambda symbol lifts float32 rounding of weak low-k modes)."""
    jcfg = _jcfg(M, P, time_scheme=scheme, wind_tau0=0.05)
    cfg = config_from_jax(jcfg)
    zeta, psi, f1, f2 = _step_inputs(jcfg, seed=3)
    want = j_fused_step_full(jcfg, jnp.asarray(zeta), jnp.asarray(psi),
                             jnp.asarray(f1), jnp.asarray(f2), step,
                             "highest", True)
    ins = [torch.from_numpy(a.copy()) for a in (zeta, psi, f1, f2)]
    *got, bad = fused_step_full_rows_emulated(cfg, *ins, step)
    assert bad == 0
    for name, g, w in zip(("zeta_new", "carry"), got, want):
        _close(g, w, 1e-5, f"{name} {scheme}")
    f64 = fused_step_full_plain(cfg, *(t.double() for t in ins), step)
    _close(got[2], want[2], 1e-5, f"psi_new {scheme} vs tpu_qg")
    _close(got[2], f64[2], 1e-6, f"psi_new {scheme} vs float64")


# K2's factored kernel at P = 256 (N2 = 2) and its mixed form at P = 384
# (N2 = 3); K1's row kernel takes any P % 4 == 0.
@pytest.mark.parametrize("M,P,scheme,step", [(256, 256, "euler_ab3", 5),
                                              (256, 384, "leapfrog_ra", 0)])
def test_yspec_stages_match_pallas(M, P, scheme, step):
    """K15's stages (K2's factored emulation inverse, the row kernel's
    emulation, K2's factored emulation forward) against tpu_qg's y-fused
    step kernel in interpret mode, with wind: zeta_new, carry and zeta_ys
    1e-5 of their max."""
    jcfg = _jcfg(M, P, time_scheme=scheme, wind_tau0=0.1)
    cfg = config_from_jax(jcfg)
    zeta, psi, f1, f2 = _step_inputs(jcfg, seed=4)
    psi_ys = dft_kernels.y_dft_plain(torch.from_numpy(psi.copy()),
                                     False).numpy()
    want = fused_step_streamed_yspec(
        jcfg, jnp.asarray(zeta), jnp.asarray(psi_ys), jnp.asarray(f1),
        jnp.asarray(f2), step, "highest", True)
    *got, bad = fused_step_yspec_rows_emulated(
        cfg, *(torch.from_numpy(a.copy())
               for a in (zeta, psi_ys, f1, f2)), step)
    assert bad == 0
    for name, g, w in zip(("zeta_new", "carry", "zeta_ys"), got, want):
        _close(g, w, 1e-5, f"{name} {scheme}")


def test_stage_layouts_are_the_separate_kernels():
    """The step stage's layout differs from K1's launched one in D, and at
    launch in a longer R where the grid would otherwise run the units in
    two rounds (coop_rows_unit_rows), neither of which changes a point's
    bits: the row kernel's emulation gives the same zeta_new and carry in
    K1's layout, the stage's and the stage's with one run of every row
    (float64)."""
    cfg = preset("turbulence-2048").replace(M=256, P=384, dtype="float64")
    g = np.random.default_rng(5)
    z, p, f1, f2 = (torch.as_tensor(s * g.standard_normal((2, 256, 384)))
                    for s in (1e-5, 1e3, 1e-9, 1e-9))
    plan = coop_rows_plan(256, 384, False)
    assert coop_rows_unit_rows(plan, 1) == 256
    want = fused_step_rows_emulated(cfg, z, p, f1, f2, 5,
                                    step_kernel.step_rows_launched(256))
    for layout in (plan.step, plan.step[:1] + (256,) + plan.step[2:]):
        got = fused_step_rows_emulated(cfg, z, p, f1, f2, 5, layout)
        assert got[3] == want[3] == 0
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --- (c) the wrappers on CPU tensors -------------------------------------------

def _counts():
    return (fused_step_full.launches, fused_step_full.rows_launches,
            fused_step_yspec.launches, fused_step_yspec.rows_launches)


def test_wrappers_take_the_plain_versions_on_cpu():
    """fused_step_full and fused_step_yspec on CPU tensors return their
    plain versions' results and count no launch; the launchers of the
    persistent kernels refuse CPU tensors."""
    cfg = preset("turbulence-2048").replace(M=256, P=256)
    g = np.random.default_rng(6)
    z, p, f1, f2 = (torch.as_tensor(s * g.standard_normal((2, 256, 256)),
                                    dtype=torch.float32)
                    for s in (1e-5, 1e3, 1e-9, 1e-9))
    n = _counts()
    for got, want in (
            (fused_step_full(cfg, z, p, f1, f2, 5),
             fused_step_full_plain(cfg, z, p, f1, f2, 5)),
            (fused_step_yspec(cfg, z, p, f1, f2, 5),
             fused_step_yspec_plain(cfg, z, p, f1, f2, 5))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _counts() == n
    for fn in (fused_step_full_rows, fused_step_yspec_rows):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(cfg, z, p, f1, f2, 5)


def test_misaligned_operand_takes_the_first_form():
    """The take rule includes K1's operand rule: a view that starts part way
    into a 16-byte piece is not taken (the first form runs it)."""
    big = torch.zeros(2 * 2048 * 2048 + 1)
    view = big[1:].view(2, 2048, 2048)
    full = torch.zeros(2, 2048, 2048)
    assert coop_rows_takes(2048, 2048, True, full, full, full, full)
    assert not coop_rows_takes(2048, 2048, True, full, view, full, full)
    assert not coop_rows_takes(128, 128, False, full)


def test_route_gates_unchanged():
    """The one-launch routes' gates are the reference's (the persistent
    kernels change which kernel runs a route, never which route runs):
    fullstep up to 2560^2, y-fused up to 8192^2, and every one-launch form
    off under "auto"."""
    for n, full, yfused in ((2048, True, True), (2560, True, True),
                            (2688, False, True), (8192, False, True)):
        cfg = preset("turbulence-2048").replace(M=n, P=n)
        assert core.fullstep_supported(cfg) == full, n
        assert core.yfused_supported(cfg) == yfused, n
        assert spectral.reference_fullstep(n, n) == full
    cfg = preset("turbulence-2048")
    assert (cfg.step_full, cfg.step_chain, cfg.fft_mono) == ("auto",) * 3

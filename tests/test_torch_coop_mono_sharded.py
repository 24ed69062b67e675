"""K16 and K15's sharded form as persistent kernels on the redesigned
stages (csrc/coop_rows.cuh), on the CPU: their take rules as the
conjunction of their stage kernels' own, over every 128 * n square the
mono route's gate admits and tests/test_torch_fused_forms.py's rectangles;
each stage loop covering every unit of its separate kernel once (with the
two slab groups of the sharded form's first stage); the stage emulations
composed (K2's factored kernels, K3's cluster kernel, K12's row kernel)
against tpu_qg's one-launch kernels in interpret mode (float32 1e-5 of
max, K16's psi also 1e-6 of the float64 plain version); and the wrappers
on CPU tensors (the plain versions, no launch counted; the persistent
launchers refuse CPU tensors; a misaligned slab view is not taken)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops.pallas_fft import PlanarFFT2
from tpu_qg.ops.pallas_tendency import fused_step_streamed_yspec_sharded
from tpu_qg_torch import preset
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.ops import dft_kernels, spectral
from tpu_qg_torch.ops.dft_kernels import (
    coop_rows_transforms_schedule, mono_invert, mono_invert_plain,
    mono_invert_rows, mono_rows_emulated, mono_rows_plan, mono_rows_takes)
from tpu_qg_torch.ops.step_kernel import (
    coop_rows_plan, coop_rows_schedule, coop_rows_shape, coop_rows_takes,
    coop_rows_unit_rows, fused_step_yspec_sharded,
    fused_step_yspec_sharded_plain, fused_step_yspec_sharded_rows,
    fused_step_yspec_sharded_rows_emulated, packed_symbol_consts)

SQUARES = [(n, n) for n in range(128, 8192 + 1, 128)]
MONO_SQUARES = [(M, P) for M, P in SQUARES if spectral.reference_mono(M, P)]
# tests/test_torch_fused_forms.py's sample of 128 n extents.
SIZES = [128 * n for n in (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 15, 16, 19, 20, 24,
                           31, 32, 45, 53, 59, 63, 64)]
RECTANGLES = [(M, P) for M in SIZES for P in SIZES if M != P]
H = 8           # tpu_qg's slab rows


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def _y_takes(P):
    """K2's factored or mixed kernel takes P in its 256-thread layout."""
    return (dft_kernels.y_dft_factored_takes(P)
            and dft_kernels.y_dft_factored_launched(P)[1] == 256)


# --- (a) the take rules and plans -------------------------------------------

@pytest.mark.parametrize("shapes", ["mono squares", "rectangles"])
def test_mono_take_rule_is_the_stage_kernels(shapes):
    """K16's persistent kernel takes a shape exactly where K2's and K3's
    redesigned kernels take it, and there its plan holds each stage in the
    separate kernel's launched layout within one block, with no step
    stage; of the mono gate's squares it takes 896 .. 2176 (1536 and 1920
    mixed) and leaves 128 .. 768 to the first form."""
    taken = []
    for M, P in MONO_SQUARES if shapes == "mono squares" else RECTANGLES:
        want = _y_takes(P) and dft_kernels.pair_x_cluster_takes(M)
        assert mono_rows_takes(M, P) == want, (M, P)
        if not want:
            continue
        taken.append(M)
        plan = mono_rows_plan(M, P)
        assert plan.y == dft_kernels.y_dft_factored_launched(P)
        assert plan.x == dft_kernels.pair_x_cluster_launched(M)
        assert plan.smem == max(
            dft_kernels.y_dft_factored_layout(P, *plan.y).smem,
            dft_kernels.pair_x_cluster_layout(M, *plan.x).smem)
        assert plan.smem <= dft_kernels.SMEM_LIMIT
        assert plan.ints[2] == 0 and plan.ints[-1] == 3
        # The transform fields are K17's at the same shape where K17 runs.
        if coop_rows_shape(M, P, True):
            assert plan.ints[3:-1] == coop_rows_plan(M, P, True).ints[3:-1]
    if shapes == "mono squares":
        assert [M for M, _ in MONO_SQUARES] == list(range(128, 2176 + 1, 128))
        assert taken == list(range(896, 2176 + 1, 128))
    else:
        assert taken


@pytest.mark.parametrize("shapes", ["squares", "rectangles"])
def test_sharded_take_rule_is_the_stage_kernels(shapes):
    """K15's sharded form on an (m, P) block takes it where K1's row kernel
    and K2's factored kernel take it (K15's rule, coop_rows_shape with no x
    stage), with every operand and slab 16-byte aligned."""
    for m, P in SQUARES if shapes == "squares" else RECTANGLES:
        want = P % 4 == 0 and _y_takes(P)
        assert coop_rows_shape(m, P, False) == want, (m, P)
    block = torch.zeros(2, 512, 2048)
    slab = torch.zeros(2, 2, 2048)
    assert coop_rows_takes(512, 2048, False, *[block] * 4, *[slab] * 4)
    assert not coop_rows_takes(512, 128, False, *[block] * 4, *[slab] * 4)


def _check_cover(assigned, units):
    """Every unit of ``units`` in exactly one list of ``assigned``."""
    seen = [u for lst in assigned.values() for u in lst]
    assert sorted(seen) == sorted(units)
    assert len(seen) == len(set(seen))


@pytest.mark.parametrize("blocks", [1, 3, 240, 396])
def test_mono_stage_loops_cover_every_unit_once(blocks):
    """On the mono squares the persistent kernel takes and on the
    rectangles, with ``blocks`` blocks rounded down to whole clusters of
    G, the y stages run each of K2's row groups once and the x stage each
    of K3's tile pairs once."""
    checked = 0
    for M, P in MONO_SQUARES + RECTANGLES[::7]:
        if not mono_rows_takes(M, P):
            continue
        plan = mono_rows_plan(M, P)
        G = plan.x[0]
        n = max(G, blocks // G * G)
        sched = coop_rows_transforms_schedule(M, P, True, n)
        assert len(sched["y_units"]) == -(-M // plan.y[0])
        _check_cover(sched["y"], sched["y_units"])
        own, _ = dft_kernels.x_symbols_cluster_tiles(P, plan.x[1])
        assert len(sched["x_units"]) == own.shape[0] == plan.ints[9]
        assert len(sched["x"]) == n // G
        _check_cover(sched["x"], sched["x_units"])
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("slab_rows", [2, H])
@pytest.mark.parametrize("blocks", [1, 3, 240, 396])
def test_sharded_stage_loops_cover_every_unit_once(slab_rows, blocks):
    """On row blocks the sharded form takes, the first stage runs each of
    K2's row groups of the block and of each H-row slab once (the slabs'
    after the block's), the step stage each of K12's units once, in one
    round where the grid holds a run of every strip and layer, and the
    last stage each of the block's row groups once."""
    checked = 0
    for m, P in [(512, 2048), (2048, 2048), (256, 384), (96, 256),
                 (2048, 8192)] + RECTANGLES[::9]:
        if not coop_rows_shape(m, P, False):
            continue
        plan = coop_rows_plan(m, P, False)
        sched = coop_rows_schedule(m, P, False, blocks, slab_rows=slab_rows)
        rb = plan.y[0]
        units = sched["y_slabs_units"]
        assert len(units) == -(-m // rb) + 2 * -(-slab_rows // rb)
        assert units[:-(-m // rb)] == [("block", g) for g in sched["y_units"]]
        _check_cover(sched["y_slabs"], units)
        _check_cover(sched["y"], sched["y_units"])
        W = plan.step[0]
        R = coop_rows_unit_rows(plan, blocks)
        assert len(sched["step_units"]) == 2 * -(-P // W) * -(-m // R)
        _check_cover(sched["step"], sched["step_units"])
        if 2 * blocks >= 2 * -(-P // W):
            assert max(map(len, sched["step"].values())) == 1
        checked += 1
    assert checked > 0


# --- (b) the stages' composition against tpu_qg --------------------------------

# K3's cluster kernel at its smallest M: 1024 = 128 * 2^3 (its power-of-two
# instance, G = 4) and 896 = 128 * 7 (the mixed one), on K2's smallest
# factored extent, P = 256.
@pytest.mark.parametrize("M,P", [(1024, 256), (896, 256)])
def test_mono_stages_match_pallas(M, P):
    """K16's stages (K2's factored emulation forward, K3's cluster
    emulation in its launched (G, Cw), K2's factored emulation inverse)
    against tpu_qg's one-launch inversion in interpret mode: 1e-5 of its
    max, and 1e-6 of the float64 plain version's."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(M=M, P=P)
    consts = packed_symbol_consts(config_from_jax(jcfg))
    z = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, M, P)).astype(np.float32))
    want = PlanarFFT2(M, P, interpret=True).mono_invert(jnp.asarray(z.numpy()),
                                                        consts)
    got = mono_rows_emulated(z, consts)
    _close(got, want, 1e-5, "psi vs tpu_qg")
    _close(got, mono_invert_plain(z.double(), consts), 1e-6,
           "psi vs float64")


def _block_inputs(jcfg, m, seed):
    """Rank 1's (2, m, P) row block of float32 (zeta, psi, f1, f2) of a
    grid-noise psi, and its 8-row slabs, from the global fields
    (tests/test_torch_parallel_kernels.py's)."""
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((2, jcfg.M, jcfg.P)) * 1e-4
    s = tpu_qg.init_state(jcfg, psi_init=psi.astype(np.float32))
    zeta = np.asarray(s.zeta, np.float32)
    scale = np.abs(zeta).max() / jcfg.dt * 1e-3
    f1, f2 = (scale * rng.standard_normal(zeta.shape) for _ in range(2))
    fields = [zeta, np.asarray(s.psi, np.float32), f1.astype(np.float32),
              f2.astype(np.float32)]
    r0 = m
    block = [np.array(a[:, r0:r0 + m]) for a in fields]
    slabs = [(np.array(a[:, r0 - H:r0]), np.array(a[:, r0 + m:r0 + m + H]))
             for a in fields[:2]]
    return block, slabs


# K2's factored kernel at P = 256 (N2 = 2) and its mixed form at P = 384
# (N2 = 3, Rb = 16: one group wider than the 8-row slabs).
@pytest.mark.parametrize("P,scheme,step", [(256, "euler_ab3", 5),
                                           (384, "leapfrog_ra", 3)])
def test_sharded_stages_match_pallas(P, scheme, step):
    """K15's sharded form's stages (K2's factored emulation inverse on the
    block and on each whole psi slab, K12's row emulation, K2's factored
    emulation forward) against tpu_qg's sharded y-fused step in interpret
    mode on a (2, 256, P) block with 8-row slabs, past the scheme's start,
    with wind: zeta_new, carry and zeta_ys 1e-5 of their max."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(
        M=1024, P=P, time_scheme=scheme, wind_tau0=0.05)
    (z, p, f1, f2), ((zt, zb), (pt, pb)) = _block_inputs(jcfg, 256, 12)

    def ys(a):
        return dft_kernels.y_dft_plain(torch.from_numpy(a), False).numpy()

    p_ys, pt_ys, pb_ys = ys(p), ys(pt), ys(pb)
    want = fused_step_streamed_yspec_sharded(
        jcfg, *(jnp.asarray(a) for a in (z, p_ys, f1, f2)), jnp.int32(step),
        *(jnp.asarray(a) for a in (zt, zb, pt_ys, pb_ys)), "highest", True)
    *got, bad = fused_step_yspec_sharded_rows_emulated(
        config_from_jax(jcfg), *(torch.from_numpy(a)
                                 for a in (z, p_ys, f1, f2)), step,
        *(torch.from_numpy(a) for a in (zt, zb, pt_ys, pb_ys)))
    assert bad == 0
    for part, g, w in zip(("zeta_new", "carry", "zeta_ys"), got, want):
        _close(g, w, 1e-5, f"{part} {scheme}")


# --- (c) the wrappers on CPU tensors -------------------------------------------

def _counts():
    return (mono_invert.launches, mono_invert.rows_launches,
            fused_step_yspec_sharded.launches,
            fused_step_yspec_sharded.rows_launches)


def test_wrappers_take_the_plain_versions_on_cpu():
    """mono_invert and fused_step_yspec_sharded on CPU tensors return their
    plain versions' results and count no launch; the persistent launchers
    refuse CPU tensors."""
    cfg = preset("turbulence-2048").replace(M=1024, P=256)
    consts = packed_symbol_consts(cfg)
    g = np.random.default_rng(13)
    z, p, f1, f2 = (torch.as_tensor(s * g.standard_normal((2, 256, 256)),
                                    dtype=torch.float32)
                    for s in (1e-5, 1e3, 1e-9, 1e-9))
    slabs = [torch.as_tensor(s * g.standard_normal((2, 2, 256)),
                             dtype=torch.float32)
             for s in (1e-5, 1e-5, 1e3, 1e3)]
    x = torch.as_tensor(g.standard_normal((2, 1024, 256)),
                        dtype=torch.float32)
    n = _counts()
    assert torch.equal(mono_invert(x, consts), mono_invert_plain(x, consts))
    got = fused_step_yspec_sharded(cfg, z, p, f1, f2, 5, *slabs)
    want = fused_step_yspec_sharded_plain(cfg, z, p, f1, f2, 5, *slabs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _counts() == n
    with pytest.raises(ValueError, match="unsupported device"):
        mono_invert_rows(x, consts)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_step_yspec_sharded_rows(cfg, z, p, f1, f2, 5, *slabs)


def test_misaligned_views_take_the_first_forms():
    """The take rules include the operands' alignment: a slab (K15's
    sharded form) or a field (K16) that starts part way into a 16-byte
    piece is not taken, so the first form runs it."""
    block = torch.zeros(2, 512, 2048)
    slab = torch.zeros(2, 2, 2048)
    shifted = torch.zeros(slab.numel() + 1)[1:].view_as(slab)
    assert coop_rows_takes(512, 2048, False, *[block] * 4, *[slab] * 4)
    assert not coop_rows_takes(512, 2048, False, *[block] * 4, slab, slab,
                               shifted, slab)
    field = torch.zeros(2, 1024, 1024)
    view = torch.zeros(field.numel() + 1)[1:].view_as(field)
    assert mono_rows_takes(1024, 1024, field)
    assert not mono_rows_takes(1024, 1024, view)
    assert not mono_rows_takes(768, 768, torch.zeros(2, 768, 768))

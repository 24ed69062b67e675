"""K1 and K12 in the row-streaming design (csrc step_rows_kernel,
step_rows_sharded_kernel) through their CPU emulation,
``fused_step_rows_emulated``: the CUDA source's blocks, rings, per-row x
wrap, y halo pieces and K12's slab rows in plain torch.

- Every layout (W, R, D, NT) of the sweep, on a ragged shape (100 x 196:
  a ragged last run for every R, a ragged last strip for W = 128, one
  strip narrower than W = 256), against fused_step_plain (K1)
  and fused_step_sharded_plain (K12, a 48-row block with 3-row slabs) in
  float64 at 1e-12 of max|plain|; every output element stored exactly once
  and every ring read finding its row filled and waited on.
- A ring one slot short is caught.
- float32 against tpu_qg's fused_step_streamed and
  fused_step_streamed_sharded (8-row slabs, as
  tests/test_torch_parallel_kernels.py feeds them) in interpret mode at
  1e-6 of max|ref|, the K1 gate of tests/test_torch_step_kernel.py.
- The routing rule (step_rows_takes), the launched layouts and the
  layouts the CUDA source dispatches.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops.pallas_tendency import (fused_step_streamed,
                                        fused_step_streamed_sharded)
from tpu_qg_torch import preset
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.ops import step_kernel
from tpu_qg_torch.ops.step_kernel import (fused_step_plain,
                                          fused_step_rows_emulated,
                                          fused_step_sharded_plain,
                                          step_rows_layout, step_rows_layouts,
                                          step_rows_launched, step_rows_takes)

M, P = 100, 196
BLOCK0, BLOCK = 24, 48          # K12's block: rows [24, 72) of the grid
H = 3                           # its slabs' rows
CASES = [("euler_ab3", 0.0, 0), ("euler_ab3", 0.0, 5),
         ("leapfrog_ra", 0.1, 0), ("leapfrog_ra", 0.1, 3)]
LAYOUTS = step_rows_layouts()
IDS = ["W{}-R{}-D{}-NT{}".format(*lay) for lay in LAYOUTS]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(case, dtype="float64", M=M, P=P):
    scheme, tau0, _ = case
    return preset("turbulence-2048").replace(M=M, P=P, time_scheme=scheme,
                                             wind_tau0=tau0, dtype=dtype)


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(s * rng.standard_normal((2, M, P)))
            for s in (1e-5, 1e3, 1e-9, 1e-9)]


def _check(got, want, stores, bad):
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())
    assert bad == 0
    assert bool((stores == 1).all())


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_emulated_k1_matches_plain(layout):
    case = CASES[LAYOUTS.index(layout) % len(CASES)]
    cfg = _cfg(case)
    fields = _fields()
    want = fused_step_plain(cfg, *fields, case[2])
    *got, stores, bad = fused_step_rows_emulated(cfg, *fields, case[2],
                                                 layout)
    _check(got, want, stores, bad)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_emulated_k12_matches_plain(layout):
    case = CASES[(LAYOUTS.index(layout) + 1) % len(CASES)]
    cfg = _cfg(case)
    z, p, f1, f2 = _fields(1)
    rows = slice(BLOCK0, BLOCK0 + BLOCK)
    block = [a[:, rows].contiguous() for a in (z, p, f1, f2)]
    slabs = [a[:, r].contiguous() for a in (z, p)
             for r in (slice(BLOCK0 - H, BLOCK0),
                       slice(BLOCK0 + BLOCK, BLOCK0 + BLOCK + H))]
    want = fused_step_sharded_plain(cfg, *block, case[2], *slabs)
    *got, stores, bad = fused_step_rows_emulated(cfg, *block, case[2],
                                                 layout, slabs=slabs)
    _check(got, want, stores, bad)
    # The block's rows of the whole grid's step: the slabs are its rows.
    whole = fused_step_plain(cfg, z, p, f1, f2, case[2])
    for g, w in zip(got, whole):
        assert float((g - w[:, rows]).abs().max()) <= 1e-12 * float(
            w.abs().max())


@pytest.mark.parametrize("layout", [(128, 32, 2, 128), (256, 128, 8, 128)],
                         ids=["W128-R32-D2-NT128", "W256-R128-D8-NT128"])
def test_emulation_catches_a_short_ring(layout):
    """With one ring slot fewer than G + 3 + D, a slot is refilled while a
    group still reads it: the emulation counts the bad reads."""
    cfg = _cfg(CASES[1])
    *_, bad = fused_step_rows_emulated(cfg, *_fields(), 5, layout,
                                       slots=step_rows_layout(layout).S - 1)
    assert bad > 0


def _ref_inputs(jcfg, seed):
    """float32 numpy (zeta, psi, f1, f2) of a grid-noise psi, history
    fields near the tendency's scale (as tests/test_torch_parallel_kernels.py
    makes them)."""
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((2, jcfg.M, jcfg.P)) * 1e-4
    s = tpu_qg.init_state(jcfg, psi_init=psi.astype(np.float32))
    zeta = np.array(s.zeta, np.float32)
    scale = np.abs(zeta).max() / jcfg.dt * 1e-3
    f1, f2 = (scale * rng.standard_normal(zeta.shape) for _ in range(2))
    return [zeta, np.array(s.psi, np.float32), f1.astype(np.float32),
            f2.astype(np.float32)]


def _close32(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


def test_emulated_k1_matches_streamed_kernel_float32():
    """K1's launched layout at 128 x 128 (two runs of 64 rows, one strip)
    against fused_step_streamed (tile 64: its double-buffered path)."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(
        M=128, P=128, time_scheme="leapfrog_ra", wind_tau0=0.1,
        dtype="float32")
    arrays = _ref_inputs(jcfg, 3)
    want = fused_step_streamed(jcfg, *(jnp.asarray(a) for a in arrays),
                               jnp.int32(3), True, 64)
    *got, stores, bad = fused_step_rows_emulated(
        config_from_jax(jcfg), *(torch.from_numpy(a) for a in arrays), 3,
        step_rows_launched(128))
    _close32(got, want)
    assert bad == 0 and bool((stores == 1).all())


def test_emulated_k12_matches_streamed_sharded_kernel_float32():
    """K12's launched layout on rank 1's (2, 64, 128) block of a 256-row
    grid with 8-row slabs against fused_step_streamed_sharded."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(M=256, P=128,
                                                    dtype="float32")
    fields = _ref_inputs(jcfg, 4)
    m = 64
    block = [np.array(a[:, m:2 * m]) for a in fields]
    slabs = [np.array(a[:, r]) for a in fields[:2]
             for r in (slice(m - 8, m), slice(2 * m, 2 * m + 8))]
    want = fused_step_streamed_sharded(
        jcfg, *(jnp.asarray(a) for a in block), jnp.int32(5),
        *(jnp.asarray(a) for a in slabs), True)
    *got, stores, bad = fused_step_rows_emulated(
        config_from_jax(jcfg), *(torch.from_numpy(a) for a in block), 5,
        step_rows_launched(m), slabs=[torch.from_numpy(a) for a in slabs])
    _close32(got, want)
    assert bad == 0 and bool((stores == 1).all())


def test_rows_takes_by_width_and_alignment():
    whole = torch.zeros(2 * 8 * 132 + 1)
    field = whole[:2 * 8 * 132].view(2, 8, 132)
    assert step_rows_takes(132, field, field)
    assert not step_rows_takes(130)
    assert not step_rows_takes(2)
    # A contiguous view 4 bytes past an aligned start is not 16-byte aligned.
    shifted = whole[1:].view(2, 8, 132)
    assert shifted.is_contiguous()
    assert not step_rows_takes(132, field, shifted)


def test_launched_layouts_are_instantiated_and_fit_static_smem():
    """Every launched layout is one of the instantiated ones, and every
    instantiated layout's block fits the 48 KB a launch takes without
    raising its shared-memory limit (the source raises none)."""
    for M_ in (*step_kernel.STEP_ROWS_BY_M, 4096, 256):
        assert step_rows_launched(M_) in LAYOUTS
    for lay in LAYOUTS:
        assert step_rows_layout(lay).smem <= 48 * 1024, lay


def test_cuda_source_dispatches_every_layout():
    """csrc rows_dispatch instantiates the (W, NT) pairs and D values of
    step_rows_layouts, so every layout the wrappers pass has a kernel."""
    src = (pathlib.Path(step_kernel.__file__).parent.parent / "csrc"
           / "step_kernel.cu").read_text()
    pairs = set(re.findall(r"QG_ROWS_D\((\d+), (\d+)\)", src))
    ahead = set(re.findall(r"QG_ROWS_CASE\(w, nt, (\d+)\)", src))
    assert {(int(w), int(nt)) for w, nt in pairs} == {
        (w, nt) for w in step_kernel.STEP_ROWS_WIDTHS
        for nt in step_kernel.STEP_ROWS_THREADS}
    assert {int(d) for d in ahead} == set(step_kernel.STEP_ROWS_AHEAD)

"""K10 and K11 in the row-streaming design (csrc mg_rows_kernel) through
their CPU emulation, ``mg_rows_emulated``: the CUDA source's strips of 120
columns, runs of R rows, rings of S slots filled D rows ahead, the stages'
one-row lags, the restriction on odd rows 2X + 1 and K11's coarse rows, in
plain torch.

- All four forms (K10 smooth only, residual, restrict; K11) in every
  launched layout on (2, 64, 64), (2, 96, 128) (one ragged run for R =
  128) and (2, 128, 48) (a strip narrower than 120 columns), and (1, 48,
  248) (a ragged last strip) with nu = 1, bitwise equal to the plain
  versions (mg_smooth_plain, mg_prolong_smooth_plain) in float32 and
  float64; every output element stored exactly once and every slot read
  finding its row filled and waited on. An unfilled ring entry, a stage
  row never formed and a neighbour past the ring row are NaN in the
  emulation, so a halo one row or column short shows as NaN.
- A ring one slot short is caught.
- The routing rule (mg_rows_takes), the launched layouts and the instances
  and limits of the CUDA source, and each layout's shared memory.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from tpu_qg_torch.ops import mg_kernels
from tpu_qg_torch.ops.mg_kernels import (MG_FORMS, mg_prolong_smooth,
                                         mg_prolong_smooth_plain,
                                         mg_rows_emulated, mg_rows_launched,
                                         mg_rows_layout, mg_rows_layouts,
                                         mg_rows_takes, mg_smooth,
                                         mg_smooth_plain)

DX, ALPHAS, OMEGA = 1.0e4, (0.0, -3.7e-9), 0.8
SHAPES = [(2, 64, 64), (2, 96, 128), (2, 128, 48)]
LAUNCHED = sorted({*mg_kernels.MG_ROWS_BY_M.values(), mg_kernels.MG_ROWS})
SRC = (pathlib.Path(mg_kernels.__file__).parent.parent / "csrc"
       / "mg_kernels.cu").read_text()


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fields(shape, dtype, seed=0):
    """u, f and ec at a solution's, a right-hand side's and a coarse
    correction's scale."""
    K, M, P = shape
    g = np.random.default_rng(seed)
    return [torch.as_tensor(s * g.standard_normal(sh), dtype=dtype)
            for s, sh in ((1e-2, (K, M, P)), (1e-5, (K, M, P)),
                          (1e-3, (K, M // 2, P // 2)))]


def _plain(form, u, f, ec, alphas, nu):
    if form == "prolong":
        return mg_prolong_smooth_plain(u, ec, f, DX, alphas, nu, OMEGA), None
    return mg_smooth_plain(u, f, DX, alphas, nu, form != "smooth", OMEGA,
                           form == "restrict")


def _check_emulated(form, shape, dtype, layout, nu=2):
    u, f, ec = _fields(shape, dtype)
    alphas = ALPHAS[:shape[0]]
    got_u, got_r, stores, bad = mg_rows_emulated(
        form, u, f, ec if form == "prolong" else None, DX, alphas, nu, OMEGA,
        layout)
    want_u, want_r = _plain(form, u, f, ec, alphas, nu)
    assert torch.equal(got_u, want_u), (form, layout)
    if want_r is None:
        assert got_r is None
    else:
        assert torch.equal(got_r, want_r), (form, layout)
    assert bad == 0 and all(bool((s == 1).all()) for s in stores)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s))
                                               for s in SHAPES])
@pytest.mark.parametrize("form", MG_FORMS)
def test_emulated_rows_match_plain_bitwise(form, shape, dtype):
    for layout in LAUNCHED:
        _check_emulated(form, shape, dtype, layout)


@pytest.mark.parametrize("form", MG_FORMS)
def test_emulated_rows_one_sweep_ragged_strip(form):
    """nu = 1 (the other instantiated count) on P = 248: two whole strips
    and one of 8 columns."""
    _check_emulated(form, (1, 48, 248), torch.float64, (16, 1, 64), nu=1)


@pytest.mark.parametrize("form", MG_FORMS)
def test_emulation_catches_a_short_ring(form):
    """A run longer than the ring (R = 64 rows, D = 2), one slot short."""
    layout = (64, 2, 128)
    u, f, ec = _fields((2, 64, 64), torch.float64, seed=1)
    S = mg_rows_layout(form, 2, layout).S
    *_, bad = mg_rows_emulated(form, u, f, ec if form == "prolong" else None,
                               DX, ALPHAS, 2, OMEGA, layout, slots=S - 1)
    assert bad > 0


def test_rows_takes_by_width_nu_and_alignment():
    whole = torch.zeros(2 * 8 * 136 + 1)
    field = whole[:2 * 8 * 136].view(2, 8, 136)
    for form in MG_FORMS:
        assert mg_rows_takes(form, 136, 2, field, field)
        assert mg_rows_takes(form, 136, 1)
        assert not mg_rows_takes(form, 136, 3)      # not instantiated
        assert not mg_rows_takes(form, 130, 2)
    # The coarse rows go by 16-byte pieces: P % 8 for restrict and prolong.
    assert mg_rows_takes("residual", 132, 2)
    assert mg_rows_takes("smooth", 132, 2)
    assert not mg_rows_takes("restrict", 132, 2)
    assert not mg_rows_takes("prolong", 132, 2)
    # A contiguous view 4 bytes past an aligned start is not 16-byte aligned.
    shifted = whole[1:].view(2, 8, 136)
    assert shifted.is_contiguous()
    assert not mg_rows_takes("restrict", 136, 2, field, shifted)


def test_launched_layouts_fit_the_card():
    """Every launched layout is a sweep layout the kernel takes (R even, D
    and NT within the source's limits), and every sweep layout's block fits
    the 227 KB of shared memory a block may use on the H100."""
    layouts = mg_rows_layouts()
    for M in (*mg_kernels.MG_ROWS_BY_M, 8192, 48, 64, 100):
        assert mg_rows_launched(M) in layouts
    for R, D, NT in layouts:
        assert R % 2 == 0 and 1 <= D <= mg_kernels.MG_ROWS_MAX_AHEAD
        assert NT % 32 == 0 and NT <= mg_kernels.MG_ROWS_MAX_THREADS
        for form in MG_FORMS:
            for nu in mg_kernels.MG_ROWS_NUS:
                assert mg_rows_layout(form, nu, (R, D, NT)).smem <= 232448


def test_cuda_source_instantiates_every_form_and_limit():
    """csrc mg_rows_dispatch instantiates every form at every nu of
    MG_ROWS_NUS, and the source's strip width, halo and launch limits are
    the wrappers'."""
    cases = set(re.findall(r"QG_MG_ROWS_CASE\((kForm\w+), (\d)\)", SRC))
    names = {"smooth": "kFormSmooth", "residual": "kFormResidual",
             "restrict": "kFormRestrict", "prolong": "kFormProlong"}
    assert cases == {(names[f], str(nu)) for f in MG_FORMS
                     for nu in mg_kernels.MG_ROWS_NUS}

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", SRC)[1])

    assert const("kRowsW") == mg_kernels.MG_ROWS_WIDTH
    assert const("kRowsHalo") == mg_kernels.MG_ROWS_HALO
    assert const("kRowsMaxAhead") == mg_kernels.MG_ROWS_MAX_AHEAD
    assert const("kRowsMaxThreads") == mg_kernels.MG_ROWS_MAX_THREADS
    assert const("kMaxHalo") == mg_kernels.MG_MAX_HALO
    # The form codes the launch passes are the enum's.
    for code, form in enumerate(MG_FORMS):
        assert re.search(rf"{names[form]} = {code}", SRC)


def test_cpu_wrappers_count_no_row_launches():
    u, f, ec = _fields((2, 64, 64), torch.float32, seed=2)
    counts = (mg_smooth.rows_launches, mg_prolong_smooth.rows_launches)
    got = mg_smooth(u, f, DX, ALPHAS, 2, True, OMEGA, True)
    assert all(torch.equal(g, w) for g, w in zip(
        got, mg_smooth_plain(u, f, DX, ALPHAS, 2, True, OMEGA, True)))
    mg_prolong_smooth(u, ec, f, DX, ALPHAS)
    assert (mg_smooth.rows_launches, mg_prolong_smooth.rows_launches) == counts


def test_kernel_constants_are_built_once():
    """The ctypes table is cached per (dx, alphas, omega): a launch with the
    same constants reuses it."""

    class Lib:
        @staticmethod
        def qg_mg_max_modes():
            return 4

        @staticmethod
        def qg_mg_num_consts():
            return 9

    a = mg_kernels._kernel_consts(Lib, "t", DX, ALPHAS, OMEGA)
    assert mg_kernels._kernel_consts(Lib, "t", DX, list(ALPHAS), OMEGA) is a
    assert mg_kernels._kernel_consts(Lib, "t", 2 * DX, ALPHAS, OMEGA) is not a

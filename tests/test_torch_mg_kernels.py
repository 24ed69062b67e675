"""K10's and K11's plain versions (tpu_qg_torch.ops.mg_kernels
mg_smooth_plain, mg_prolong_smooth_plain) against tpu_qg's Pallas
multigrid kernels in interpret mode at (2, 128, 256), where the reference's
gate admits every form (tile T = 64, so the restriction too); the port's
copies of the reference's gates; the wrappers on the CPU.

Tolerances relative to max|reference|: 1e-12 in float64, 1e-6 in float32.
The plain versions repeat the Pallas kernels' grouping term for term, but
in interpret mode XLA on the CPU fuses the update w + (omega/diag) r into a
fused multiply-add where the plain version (and the CUDA kernel) rounds the
product first: ~1e-7 relative in u and up to ~5e-7 in the residual, which
subtracts nearly equal terms, in float32.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops import pallas_mg as jk
from tpu_qg_torch.ops import mg_kernels
from tpu_qg_torch.ops.mg_kernels import (mg_prolong_smooth,
                                         mg_prolong_smooth_plain, mg_smooth,
                                         mg_smooth_plain)

M, P = 128, 256
CFG = tpu_qg.preset("bench-ref").replace(M=M, P=P)
ALPHAS = (0.0, CFG.S_eig)
TOL = {np.float64: 1e-12, np.float32: 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fields(dtype, seed=0):
    """u near a solution's scale, f a white right-hand side, ec a coarse
    correction; numpy, ``dtype``."""
    g = np.random.default_rng(seed)
    return [(s * g.standard_normal(shape)).astype(dtype)
            for s, shape in ((1e-2, (2, M, P)), (1e-5, (2, M, P)),
                             (1e-3, (2, M // 2, P // 2)))]


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


FORMS = [("residual", True, False), ("restrict", True, True),
         ("smooth only", False, False)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("form,residual,restrict", FORMS)
def test_smooth_plain_matches_kernel(dtype, form, residual, restrict):
    assert jk.mg_smooth_supported(2, M, P, 2, residual, restrict)
    u, f, _ = _fields(dtype)
    ju, jr = jk.mg_smooth(jnp.asarray(u), jnp.asarray(f), CFG.dx, ALPHAS, 2,
                          residual, 0.8, True, restrict)
    tu, tr = mg_smooth_plain(torch.from_numpy(u), torch.from_numpy(f),
                             CFG.dx, ALPHAS, 2, residual, 0.8, restrict)
    assert tu.dtype == torch.from_numpy(u).dtype
    _close(tu, ju, TOL[dtype], "u")
    if residual:
        _close(tr, jr, TOL[dtype], form)
    else:
        assert tr is None and jr is None


@pytest.mark.parametrize("nu,residual", [(1, True), (6, True), (7, False)])
def test_smooth_plain_matches_kernel_sweep_counts(nu, residual):
    """Other sweep counts up to the gate's limit (nu + residual <= 7)."""
    u, f, _ = _fields(np.float64, seed=nu)
    ju, jr = jk.mg_smooth(jnp.asarray(u), jnp.asarray(f), CFG.dx, ALPHAS, nu,
                          residual, 0.8, True)
    tu, tr = mg_smooth_plain(torch.from_numpy(u), torch.from_numpy(f),
                             CFG.dx, ALPHAS, nu, residual)
    _close(tu, ju, 1e-12, "u")
    if residual:
        _close(tr, jr, 1e-12, "r")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_prolong_plain_matches_kernel(dtype):
    assert jk.mg_prolong_supported(2, M, P, 2)
    u, f, ec = _fields(dtype, seed=1)
    want = jk.mg_prolong_smooth(jnp.asarray(u), jnp.asarray(ec),
                                jnp.asarray(f), CFG.dx, ALPHAS, 2, 0.8, True)
    got = mg_prolong_smooth_plain(torch.from_numpy(u), torch.from_numpy(ec),
                                  torch.from_numpy(f), CFG.dx, ALPHAS, 2, 0.8)
    _close(got, want, TOL[dtype])


def test_prolong_plain_with_no_sweeps_is_the_prolongation():
    """nu = 0: u2 + the bilinear prolongation alone, against tpu_qg's level
    op (rows-first and columns-first differ only by rounding)."""
    from tpu_qg.ops.multigrid import prolong_bilinear
    u, f, ec = _fields(np.float64, seed=2)
    got = mg_prolong_smooth_plain(torch.from_numpy(u), torch.from_numpy(ec),
                                  torch.from_numpy(f), CFG.dx, ALPHAS, 0)
    _close(got, u + np.asarray(prolong_bilinear(jnp.asarray(ec))), 1e-12)


GATE_SHAPES = [(K, m, p) for K in (1, 2) for m in (64, 120, 128, 256, 512,
                                                    2048, 8192)
               for p in (128, 256, 384, 1152, 8192)]


@pytest.mark.parametrize("nu", [1, 2, 6, 7])
def test_gates_match_tpu_qg(nu):
    for K, m, p in GATE_SHAPES:
        assert (mg_kernels._pick_tile_mg(m, p, K)
                == jk._pick_tile_mg(m, p, K)), (K, m, p)
        for residual in (True, False):
            for restrict in (False, True):
                assert (mg_kernels.mg_smooth_supported(K, m, p, nu, residual,
                                                       restrict)
                        == jk.mg_smooth_supported(K, m, p, nu, residual,
                                                  restrict)), (K, m, p)
        assert (mg_kernels.mg_prolong_supported(K, m, p, nu)
                == jk.mg_prolong_supported(K, m, p, nu)), (K, m, p)


def test_wrappers_run_plain_on_cpu_without_counting():
    u, f, ec = (torch.from_numpy(a) for a in _fields(np.float32, seed=3))
    counts = (mg_smooth.launches, mg_prolong_smooth.launches)
    for residual, restrict in ((True, False), (True, True), (False, False)):
        got = mg_smooth(u, f, CFG.dx, ALPHAS, 2, residual, 0.8, restrict)
        want = mg_smooth_plain(u, f, CFG.dx, ALPHAS, 2, residual, 0.8,
                               restrict)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        if residual:
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(
        mg_prolong_smooth(u, ec, f, CFG.dx, ALPHAS),
        mg_prolong_smooth_plain(u, ec, f, CFG.dx, ALPHAS), rtol=0, atol=0)
    assert (mg_smooth.launches, mg_prolong_smooth.launches) == counts


def test_restrict_needs_residual():
    u, f, _ = (torch.from_numpy(a) for a in _fields(np.float32))
    with pytest.raises(ValueError, match="restrict needs residual"):
        mg_smooth(u, f, CFG.dx, ALPHAS, 2, False, 0.8, True)


class _FakeLib:
    """The compiled library's table sizes, for the constant layout."""

    @staticmethod
    def qg_mg_max_modes():
        return 4

    @staticmethod
    def qg_mg_num_consts():
        return 9


def test_kernel_constants_round_once_from_float64():
    consts = list(mg_kernels._kernel_consts(_FakeLib, "t", CFG.dx, ALPHAS,
                                            0.8))
    inv_dx2 = 1.0 / CFG.dx ** 2
    assert consts[0] == np.float32(inv_dx2)
    assert consts[1:5] == [0.0, np.float32(CFG.S_eig), 0.0, 0.0]
    assert consts[5:9] == [np.float32(0.8 / (a - 4.0 * inv_dx2))
                           for a in ALPHAS] + [0.0, 0.0]
    assert isinstance(mg_kernels._kernel_consts(_FakeLib, "t", 1.0, (0.0,),
                                                0.8), ctypes.Array)
    with pytest.raises(ValueError, match="at most 4 modes"):
        mg_kernels._kernel_consts(_FakeLib, "t", 1.0, (0.0,) * 5, 0.8)

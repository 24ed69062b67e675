"""K4's cluster kernel on the mixed extents M = 128 * N2 (N2 not a power of
two, G <= N2 <= 63): its emulation (tpu_qg_torch.ops.dft_kernels.
x_dft_cluster_emulated, which runs csrc x_dft_cluster_mixed_kernel's index
maps block by block: stage A as the passes of y_dft_mixed_plan(N2) with the
kernel's weights and twiddles, rho, stage B's split of the N2 p-rows over
the G blocks and the owner of each p-row in the inverse's pull) against
K4's plain version and against tpu_qg's Pallas x-DFT in interpret mode; the
shape rule and the launched layouts; the wrapper on CPU tensors.

Tolerances, relative to max|ref|: float64 against x_dft_plain 1e-12 (the
same transform, factored); float32 against PlanarFFT2._call_x 1e-5 (K4's
gate; the kernel's 1/M is a float32 product, not exact for a mixed M, and
its rounding is far inside it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_qg.ops.pallas_fft import PlanarFFT2
from tpu_qg_torch.ops.dft_kernels import (CLUSTER_SIZES, CLUSTER_WIDTHS,
                                          SMEM_LIMIT, X_CLUSTER,
                                          X_CLUSTER_BY_M, x_dft,
                                          x_dft_cluster_emulated,
                                          x_dft_cluster_launched,
                                          x_dft_cluster_layout,
                                          x_dft_cluster_split,
                                          x_dft_cluster_takes, x_dft_plain,
                                          x_dft_stage_a, x_dft_stage_a_plain,
                                          x_kernels_take, y_dft_mixed_plan)

# N2 with radix 2^c and 3 or 5 plans (20, 24, 35), a prime pass last (22 =
# 2 * 11, 33 = 3 * 11, 34 = 2 * 17: the inverse pulls before its first
# pass), one prime pass (23, 61: the forward loads before it) and the
# largest N2 (63 = 3 * 3 * 7).
MIXED_N2 = (20, 22, 23, 24, 33, 34, 35, 61, 63)
LAYOUTS = [(n2, G, Cw) for n2 in MIXED_N2 for G in CLUSTER_SIZES
           for Cw in CLUSTER_WIDTHS if x_dft_cluster_takes(128 * n2, G, Cw)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _field(M, P, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((2, M, P)).astype(
        dtype)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("stage_a", [False, True], ids=["whole", "stage_a"])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n2,G,Cw", LAYOUTS)
def test_emulated_mixed_cluster_kernel_matches_plain(n2, G, Cw, inverse,
                                                     stage_a):
    """Both ways, whole and its first half alone, on P = 2 Cw + 5 (a ragged
    third tile): each input element loaded and each output element stored
    exactly once."""
    M, P = 128 * n2, 2 * Cw + 5
    z = torch.from_numpy(_field(M, P, 1000 * n2 + 10 * G + Cw + inverse))
    got, loads, stores = x_dft_cluster_emulated(z, inverse, G, Cw,
                                                stage_a=stage_a)
    plain = x_dft_stage_a_plain if stage_a else x_dft_plain
    _close(got, plain(z, inverse), 1e-12)
    assert bool((loads == 1).all()), "an element loaded other than once"
    assert bool((stores == 1).all()), "an element stored other than once"


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("M", [3072, 2816])
def test_emulation_matches_pallas(M, inverse):
    """float32 at the 3072^2 path's extent (N2 = 24 = 8 * 3) and at 2816
    (N2 = 22 = 2 * 11, a prime pass), in the launched layout."""
    P = 128
    x = _field(M, P, M + inverse, np.float32)
    want = PlanarFFT2(M, P, interpret=True)._call_x(jnp.asarray(x), inverse)
    got, _, _ = x_dft_cluster_emulated(torch.from_numpy(x), inverse,
                                       *x_dft_cluster_launched(M))
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_launched_layouts_take_every_mixed_extent():
    """The launched layout takes every M = 128 n, G <= n <= 63 not a power
    of two, within one block's shared memory; x_dft_kernel keeps n < G; each
    layout of X_CLUSTER_BY_M is one the cluster kernels take at its M."""
    for n2 in range(3, 64):
        M = 128 * n2
        if n2 & (n2 - 1) == 0:
            continue
        G, Cw = x_dft_cluster_launched(M)
        assert x_dft_cluster_takes(M) == (n2 >= G), n2
        if n2 >= G:
            assert x_dft_cluster_layout(M, G, Cw).smem <= SMEM_LIMIT
            assert x_dft_cluster_takes(M, *X_CLUSTER), n2   # the default fits
    for M, layout in X_CLUSTER_BY_M.items():
        assert x_dft_cluster_takes(M, *layout)
        assert x_kernels_take(M, 256)
    assert not x_dft_cluster_takes(128 * 65)        # N2 past 63
    assert not x_dft_cluster_takes(128 * 6)         # N2 below G
    assert not x_dft_cluster_takes(3072 + 64)       # not a multiple of 128


@pytest.mark.parametrize("n2", MIXED_N2)
def test_stage_b_split_and_layout(n2):
    """Stage B's split gives every block floor(n2 / G) or ceil(n2 / G)
    p-rows, all of them once, and buffer B room for the most; the shared
    memory is the kernel's (csrc cluster_mixed_smem)."""
    M = 128 * n2
    for G in CLUSTER_SIZES:
        if n2 < G:
            continue
        s = x_dft_cluster_split(M, G)
        rows = np.diff(s)
        assert s[0] == 0 and s[-1] == n2
        assert set(rows.tolist()) <= {n2 // G, -(-n2 // G)}
        assert rows.min() >= 1
        for Cw in CLUSTER_WIDTHS:
            lay = x_dft_cluster_layout(M, G, Cw)
            assert (lay.n2, lay.l1, lay.l2, lay.tile) == (
                n2, 128 // G, rows.max(), M * Cw // G)
            plan = y_dft_mixed_plan(n2)
            h = (plan[-1] // 2 if plan[-1] >= 11 else 0)
            assert lay.smem == 8 * (lay.tile + 128 * lay.l2 * Cw + n2 + 64
                                    + h * (h + 1)) + 8 * n2


def test_layout_at_3072():
    """(8, 8) at M = 3072: buffers A and B of 24 KB each and the tables,
    the figure the kernel's source note gives (48.9 KB)."""
    lay = x_dft_cluster_layout(3072, 8, 8)
    assert (lay.n2, lay.l1, lay.l2, lay.tile) == (24, 16, 3, 3072)
    assert lay.smem == 8 * (2 * 3072 + 24 + 64) + 8 * 24 == 50048


def test_x_dft_counts_no_mixed_launch_on_cpu():
    z = torch.from_numpy(_field(3072, 9, 3, np.float32))
    n = (x_dft.launches, x_dft.mixed_launches, x_dft.cluster_launches,
         x_dft_stage_a.launches)
    for inverse in (False, True):
        torch.testing.assert_close(x_dft(z, inverse), x_dft_plain(z, inverse),
                                   rtol=0, atol=0)
        torch.testing.assert_close(x_dft_stage_a(z, inverse),
                                   x_dft_stage_a_plain(z, inverse),
                                   rtol=0, atol=0)
    assert (x_dft.launches, x_dft.mixed_launches, x_dft.cluster_launches,
            x_dft_stage_a.launches) == n

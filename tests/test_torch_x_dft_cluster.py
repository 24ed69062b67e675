"""K4's cluster kernel (csrc x_dft_cluster_kernel) emulated block by block on
the CPU (tpu_qg_torch.ops.dft_kernels.x_dft_cluster_emulated, the CUDA
source's index maps in plain torch), against the factored plain version.

Every layout (G blocks a cluster, Cw y slots a cluster) at M = 1024, 2048
and 4096 where N2 = M / 128 >= G, in float64 at 1e-12 of max|plain|, both
directions and the first half alone (stage A), on P values with a ragged
last tile. Each element of the input must be loaded by exactly one block
and each of the output stored by exactly one.
"""

import numpy as np
import pytest
import torch

from tpu_qg_torch.ops.dft_kernels import (CLUSTER_SIZES, CLUSTER_WIDTHS,
                                          SMEM_LIMIT,
                                          X_CLUSTER, x_dft,
                                          x_dft_cluster_emulated,
                                          x_dft_cluster_launched,
                                          x_dft_cluster_layout,
                                          x_dft_cluster_takes, x_dft_plain,
                                          x_dft_stage_a, x_dft_stage_a_plain,
                                          x_kernels_take)

LAYOUTS = [(M, G, Cw) for M in (1024, 2048, 4096) for G in CLUSTER_SIZES
           for Cw in CLUSTER_WIDTHS if M // 128 >= G]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _field(M, P, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((2, M, P)))


def _close(got, want, tol):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def _once(loads, stores):
    assert bool((loads == 1).all()), "an element loaded other than once"
    assert bool((stores == 1).all()), "an element stored other than once"


@pytest.mark.parametrize("M,G,Cw", LAYOUTS)
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_emulated_cluster_kernel_matches_plain(M, G, Cw, inverse):
    P = 2 * Cw + 5                                   # a ragged third tile
    z = _field(M, P, M + G + Cw)
    got, loads, stores = x_dft_cluster_emulated(z, inverse, G, Cw)
    _close(got, x_dft_plain(z, inverse), 1e-12)
    _once(loads, stores)


@pytest.mark.parametrize("M,G,Cw", LAYOUTS)
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_emulated_stage_a_matches_plain(M, G, Cw, inverse):
    P = Cw + 3
    z = _field(M, P, 7 * M + G)
    got, loads, stores = x_dft_cluster_emulated(z, inverse, G, Cw,
                                                stage_a=True)
    _close(got, x_dft_stage_a_plain(z, inverse), 1e-12)
    _once(loads, stores)


@pytest.mark.parametrize("M", [256, 384, 4096])
def test_stage_a_then_stage_b_is_the_dft(M):
    """x_dft_plain is stage A then stage B, and is the DFT along x in the
    permuted order (float64 numpy, 1e-12)."""
    from tpu_qg_torch.ops.matmul_fft import freq_order, split_factor
    z = _field(M, 6, M)
    c = z[0].numpy() + 1j * z[1].numpy()
    want = np.fft.fft(c, axis=0)[freq_order(M)]
    got = x_dft_plain(z, False).numpy()
    _close(torch.from_numpy(got[0] + 1j * got[1]), torch.from_numpy(want),
           1e-12)
    N1, N2 = split_factor(M)
    ya = x_dft_stage_a_plain(z, False)
    y = (ya[0] + 1j * ya[1]).reshape(N2, N1, 6)
    _close(torch.fft.fft(y, dim=1).reshape(M, 6),
           torch.from_numpy(got[0] + 1j * got[1]), 1e-12)


def test_cluster_layouts_fit_shared_memory():
    """Every layout the cluster kernel takes, at every power-of-two extent
    the four-pass kernels take, fits one block's shared memory; the
    launched layouts take the powers of two from 128 G."""
    taken = 0
    for a in range(3, 8):
        M = 128 << a
        if not x_kernels_take(M, 256):               # x_dft refuses it first
            continue
        for G in CLUSTER_SIZES:
            for Cw in CLUSTER_WIDTHS:
                if x_dft_cluster_takes(M, G, Cw):
                    taken += 1
                    assert x_dft_cluster_layout(M, G, Cw).smem <= SMEM_LIMIT
    assert taken == 13
    for M in (1024, 2048, 4096, 8192):              # the launched layouts
        assert x_dft_cluster_takes(M, *x_dft_cluster_launched(M))
        assert x_dft_cluster_takes(M)
    assert not x_dft_cluster_takes(128 * X_CLUSTER[0] // 2)   # below 128 G
    assert x_dft_cluster_takes(6144)                 # mixed: its mixed form
    assert not x_dft_cluster_takes(128 * 7)          # mixed below 128 G


def test_layout_matches_the_kernel_at_8192():
    """The layout at M = 8192, G = 16, Cw = 8: two 32 KB tiles and the
    tables, 64.75 KB, the figure the kernel's source note gives."""
    lay = x_dft_cluster_layout(8192, 16, 8)
    assert (lay.n2, lay.l1, lay.l2, lay.tile) == (64, 8, 4, 4096)
    assert lay.smem == 8 * (2 * 4096 + 32 + 64) == 66304


def test_wrappers_take_the_plain_version_on_cpu():
    z = _field(1024, 9, 3).float()
    n = (x_dft.launches, x_dft.cluster_launches, x_dft_stage_a.launches)
    for inverse in (False, True):
        torch.testing.assert_close(x_dft(z, inverse), x_dft_plain(z, inverse),
                                   rtol=0, atol=0)
        torch.testing.assert_close(x_dft_stage_a(z, inverse),
                                   x_dft_stage_a_plain(z, inverse),
                                   rtol=0, atol=0)
    assert (x_dft.launches, x_dft.cluster_launches,
            x_dft_stage_a.launches) == n

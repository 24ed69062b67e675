"""K3's cluster kernel (csrc pair_x_cluster_kernel) emulated on the CPU
(tpu_qg_torch.ops.dft_kernels.pair_x_cluster_emulated, the CUDA source's
index maps in plain torch, all tiles and blocks at once), against the plain
version and against tpu_qg's Pallas K3 in interpret mode.

Every layout (G blocks a cluster, Cw y slots a tile) that the kernel takes
at M = 1024 and 2048, in float64 at 1e-12 of max|plain|, on each of P =
256, 384 and 512: P = 256 has strips 0 and 1, each its own mirror; 384 an
odd strip count (strip 0 alone, 1 and 2 a pair); 512 strip 0, the pair 1
and 3, and strip 2 = N2y/2, its own mirror; strip 0's last tile is ragged
for every Cw. Each element of the input must be loaded by exactly one block
and each of the output stored by exactly one. One float32 case against
tpu_qg's PlanarFFT2.pair_x_symbols (interpret=True) at 1e-4, the K3 gate of
tests/test_torch_dft_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops.pallas_fft import PlanarFFT2
from tpu_qg.ops.spectral import PackedModalInverterPallasFFT
from tpu_qg_torch.ops.dft_kernels import (PAIR_X_CLUSTER,
                                          PAIR_X_CLUSTER_BY_M,
                                          PAIR_X_CLUSTER_SIZES,
                                          PAIR_X_CLUSTER_WIDTHS, SMEM_LIMIT,
                                          kernels_take, pair_x_cluster,
                                          pair_x_cluster_emulated,
                                          pair_x_cluster_launched,
                                          pair_x_cluster_layout,
                                          pair_x_cluster_takes,
                                          pair_x_symbols,
                                          pair_x_symbols_plain)
from tpu_qg_torch.ops.spectral import PackedModalInverterKernels

PS = (256, 384, 512)


def _layouts():
    return [(M, G, Cw) for M in (1024, 2048)
            for G in PAIR_X_CLUSTER_SIZES for Cw in PAIR_X_CLUSTER_WIDTHS
            if pair_x_cluster_takes(M, (G, Cw))]


LAYOUTS = _layouts()


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _consts(M, P):
    cfg = tpu_qg.preset("turbulence-2048").replace(M=M, P=P)
    return (M, P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())


def _ours(M, P):
    return PackedModalInverterKernels(*_consts(M, P))._sym_consts


def _field(M, P, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((2, M, P)))


def _close(got, want, tol):
    got, want = (torch.as_tensor(np.array(x)) for x in (got, want))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_the_layouts_at_1024_and_2048():
    """G = 4 at M = 1024 (N2 = 8); G = 4 and 8 at 2048 (N2 = 16); every
    width at each."""
    assert len(LAYOUTS) == 9
    assert {G for M, G, _ in LAYOUTS if M == 1024} == {4}
    assert {G for M, G, _ in LAYOUTS if M == 2048} == {4, 8}


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("M,G,Cw", LAYOUTS)
def test_emulated_cluster_kernel_matches_plain(M, G, Cw, P):
    consts = _ours(M, P)
    Zy = _field(M, P, M + P + G + Cw)
    got, loads, stores = pair_x_cluster_emulated(Zy, consts, G, Cw)
    _close(got, pair_x_symbols_plain(Zy, consts), 1e-12)
    assert bool((loads == 1).all()), "an element loaded other than once"
    assert bool((stores == 1).all()), "an element stored other than once"


def test_emulated_float32_matches_pallas():
    """The emulated kernel in float32 at (1024, 256), G = 4, Cw = 8,
    against tpu_qg's Pallas K3 in interpret mode (1e-4 of max|ref|)."""
    M, P = 1024, 256
    ref = PackedModalInverterPallasFFT(*_consts(M, P), interpret=True,
                                       pair_x=True)._sym_consts
    ours = _ours(M, P)
    assert ours == ref
    x = np.random.default_rng(6).standard_normal((2, M, P)).astype(np.float32)
    want = PlanarFFT2(M, P, interpret=True).pair_x_symbols(jnp.asarray(x),
                                                           ref)
    got, _, _ = pair_x_cluster_emulated(torch.from_numpy(x), ours, 4, 8)
    assert got.dtype == torch.float32
    _close(got, want, 1e-4)


def test_layouts_fit_shared_memory_and_the_table_is_taken():
    """Every layout the kernel takes fits one block's shared memory; the
    launched layouts are taken; the mixed extents 1536 and 2432 are taken
    at their launched layouts (the mixed instance,
    tests/test_torch_pair_x_mixed.py); below M = 256 G, at 384 (U < G)
    and past the shared-memory limit the kernel is not taken."""
    for a in range(1, 7):
        M = 128 << a
        for G in PAIR_X_CLUSTER_SIZES:
            for Cw in PAIR_X_CLUSTER_WIDTHS:
                if pair_x_cluster_takes(M, (G, Cw)):
                    assert pair_x_cluster_layout(M, G, Cw).smem <= SMEM_LIMIT
                    assert M // 128 >= 2 * G
    for M, layout in PAIR_X_CLUSTER_BY_M.items():
        assert pair_x_cluster_launched(M) == layout
        assert pair_x_cluster_takes(M) and kernels_take(M, M)
    assert pair_x_cluster_launched(4096) == PAIR_X_CLUSTER
    for M in (1536, 2432):                     # mixed extents
        assert pair_x_cluster_launched(M) == PAIR_X_CLUSTER_BY_M[M]
        assert pair_x_cluster_takes(M)
    for M in (256, 512, 384):                  # M < 256 G, U = 2 < G
        assert not pair_x_cluster_takes(M)
    assert not pair_x_cluster_takes(1024, (8, 8))        # N2 = 8 < 2 G
    assert not pair_x_cluster_takes(8192, (4, 16))       # 769 KB


def test_layout_at_2048():
    """The launched layout at M = 2048 is (8, 16): K5's buffers, B 64 KB
    (both tiles), A 32 KB (one tile), the 0.56 KB of radix-2 tables and 32
    slots; two blocks fit an SM."""
    assert pair_x_cluster_launched(2048) == (8, 16)
    lay = pair_x_cluster_layout(2048, 8, 16)
    assert (lay.n2, lay.l1, lay.l2, lay.tile) == (16, 16, 2, 4096)
    assert lay.smem == 8 * (3 * 4096 + 8 + 64) + 4 * 32 == 99008
    assert 2 * (lay.smem + 1024) <= 228 * 1024


def test_wrapper_takes_the_plain_version_on_cpu():
    M, P = 1024, 384
    consts = _ours(M, P)
    Zy = _field(M, P, 3).float()
    n = (pair_x_symbols.launches, pair_x_symbols.cluster_launches)
    torch.testing.assert_close(pair_x_symbols(Zy, consts),
                               pair_x_symbols_plain(Zy, consts),
                               rtol=0, atol=0)
    assert (pair_x_symbols.launches, pair_x_symbols.cluster_launches) == n
    with pytest.raises(ValueError):       # the launch wrapper: CUDA only
        pair_x_cluster(Zy, consts)

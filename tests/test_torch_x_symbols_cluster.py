"""K5's cluster kernel (csrc x_symbols_cluster_kernel) emulated on the CPU
(tpu_qg_torch.ops.dft_kernels.x_symbols_cluster_emulated, the CUDA
source's index maps in plain torch, all tiles and blocks at once), against
the plain version and against tpu_qg's Pallas K5 in interpret mode.

Every layout (G blocks a cluster, Cw y slots a tile) that the kernel takes
at M = 1024, 2048 and 4096, in float64 at 1e-12 of max|plain|, each on one
of P = 256, 384 and 512 in turn, so that every P occurs at every M: P = 256
has strips 0 and 1, each its own mirror; 384 an odd strip count (strip 0
alone, 1 and 2 a pair); 512 strip 0, the pair 1 and 3, and strip 2 = N2y/2,
its own mirror; strip 0's last tile is ragged for every Cw. (The full cross
product takes ~1 s a case at M = 4096 on the CPU.) Each element of the
input must be loaded by exactly one block and each of the output stored by
exactly one. One float32 case against tpu_qg's PlanarFFT2._call_x_symbols
(interpret=True) at 1e-4, the K5 gate of tests/test_torch_dft_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops.pallas_fft import PlanarFFT2
from tpu_qg.ops.spectral import PackedModalInverterPallasFFT
from tpu_qg_torch.ops.dft_kernels import (SMEM_LIMIT, X_SYMBOLS_CLUSTER,
                                          X_SYMBOLS_CLUSTER_BY_M,
                                          X_SYMBOLS_CLUSTER_SIZES,
                                          X_SYMBOLS_CLUSTER_WIDTHS,
                                          x_kernels_take, x_symbols_cluster,
                                          x_symbols_cluster_emulated,
                                          x_symbols_cluster_launched,
                                          x_symbols_cluster_layout,
                                          x_symbols_cluster_takes,
                                          x_symbols_cluster_tiles,
                                          x_symbols_inverse,
                                          x_symbols_inverse_plain)
from tpu_qg_torch.ops.matmul_fft import negate_index, split_factor
from tpu_qg_torch.ops.spectral import PackedModalInverterKernels

PS = (256, 384, 512)


def _layouts():
    out = []
    for M in (1024, 2048, 4096):
        taken = [(G, Cw) for G in X_SYMBOLS_CLUSTER_SIZES
                 for Cw in X_SYMBOLS_CLUSTER_WIDTHS
                 if x_symbols_cluster_takes(M, (G, Cw))]
        out += [(M, PS[k % len(PS)], G, Cw)
                for k, (G, Cw) in enumerate(taken)]
    return out


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


def test_every_p_occurs_at_every_m():
    for M in (1024, 2048, 4096):
        assert {P for m, P, _, _ in LAYOUTS if m == M} == set(PS)
    assert len(LAYOUTS) == 17


@pytest.mark.parametrize("M,P,G,Cw", LAYOUTS)
def test_emulated_cluster_kernel_matches_plain(M, P, G, Cw):
    consts = _ours(M, P)
    W = _field(M, P, M + P + G + Cw)
    got, loads, stores = x_symbols_cluster_emulated(W, consts, G, Cw)
    _close(got, x_symbols_inverse_plain(W, consts), 1e-12)
    assert bool((loads == 1).all()), "an element loaded other than once"
    assert bool((stores == 1).all()), "an element stored other than once"


def test_emulated_float32_matches_pallas():
    """The emulated kernel in float32 at (1024, 384), G = 4, Cw = 8,
    against tpu_qg's Pallas K5 in interpret mode (1e-4 of max|ref|)."""
    M, P = 1024, 384
    ref = PackedModalInverterPallasFFT(*_consts(M, P), interpret=True,
                                       pair_x=True)._sym_consts
    ours = _ours(M, P)
    assert ours == ref
    x = np.random.default_rng(5).standard_normal((2, M, P)).astype(np.float32)
    want = PlanarFFT2(M, P, interpret=True)._call_x_symbols(jnp.asarray(x),
                                                             ref)
    got, _, _ = x_symbols_cluster_emulated(torch.from_numpy(x), ours, 4, 8)
    assert got.dtype == torch.float32
    _close(got, want, 1e-4)


@pytest.mark.parametrize("P", [100, 256, 384, 512, 2432, 8192])
@pytest.mark.parametrize("Cw", X_SYMBOLS_CLUSTER_WIDTHS)
def test_tiles_cover_every_pair_once(P, Cw):
    """Every unordered pair {a, sigma(a)} is in exactly one tile column;
    mirror = sigma(own); a tile's own slots lie in one strip; off strip 0
    (and at P = 100, a single strip) the own slots are adjacent and
    ascending, the mirror slots adjacent and descending."""
    own, mirror = x_symbols_cluster_tiles(P, Cw)
    neg = negate_index(P)
    assert own.shape == mirror.shape and own.shape[1] == Cw
    ok = own >= 0
    assert (mirror[~ok] == -1).all()
    assert (mirror[ok] == neg[own[ok]]).all()
    assert (own[ok] <= mirror[ok]).all()
    seen = np.zeros(P, np.int64)
    np.add.at(seen, own[ok], 1)
    np.add.at(seen, mirror[ok & (mirror != own)], 1)
    assert (seen == 1).all()
    n1y = split_factor(P)[0]
    for t_own, t_ok in zip(own, ok):
        o = t_own[t_ok]
        assert len(set(o // n1y)) == 1
        if o[0] >= n1y:
            assert (np.diff(o) == 1).all()
            assert (np.diff(neg[o]) == -1).all()


def test_layouts_fit_shared_memory_and_the_table_is_taken():
    """Every layout the kernel takes fits one block's shared memory; the
    launched layouts are taken; below M = 256 G and past the shared-memory
    limit the kernel is not taken; a mixed extent goes to the mixed
    instance where ceil(N2 / 2) >= G (tests/test_torch_x_symbols_mixed.py),
    not below."""
    for a in range(3, 7):
        M = 128 << a
        for G in X_SYMBOLS_CLUSTER_SIZES:
            for Cw in X_SYMBOLS_CLUSTER_WIDTHS:
                if x_symbols_cluster_takes(M, (G, Cw)):
                    assert x_symbols_cluster_layout(M, G, Cw).smem <= SMEM_LIMIT
                    assert M // 128 >= 2 * G
    for M, layout in X_SYMBOLS_CLUSTER_BY_M.items():
        assert x_symbols_cluster_launched(M) == layout
        assert x_symbols_cluster_takes(M) and x_kernels_take(M, M)
    assert x_symbols_cluster_launched(2048) == X_SYMBOLS_CLUSTER
    assert x_symbols_cluster_takes(6144)               # mixed: 2048 * 3
    assert not x_symbols_cluster_takes(1536)           # mixed, U = 6 < G = 8
    assert not x_symbols_cluster_takes(1024, (8, 8))      # N2 = 8 < 2 G
    assert not x_symbols_cluster_takes(8192, (4, 8))      # 385 KB


def test_layout_at_8192():
    """The launched layout at M = 8192 is (16, 8): B 64 KB (both tiles), A
    32 KB (one tile), the 0.75 KB of radix-2 tables and 16 slots; two
    blocks fit an SM."""
    assert x_symbols_cluster_launched(8192) == (16, 8)
    lay = x_symbols_cluster_layout(8192, 16, 8)
    assert (lay.n2, lay.l1, lay.l2, lay.tile) == (64, 8, 4, 4096)
    assert lay.smem == 8 * (3 * 4096 + 32 + 64) + 4 * 16 == 99136
    assert 2 * (lay.smem + 1024) <= 228 * 1024


def test_wrapper_takes_the_plain_version_on_cpu():
    M, P = 1024, 384
    consts = _ours(M, P)
    W = _field(M, P, 3).float()
    n = (x_symbols_inverse.launches, x_symbols_inverse.cluster_launches)
    torch.testing.assert_close(x_symbols_inverse(W, consts),
                               x_symbols_inverse_plain(W, consts),
                               rtol=0, atol=0)
    assert (x_symbols_inverse.launches,
            x_symbols_inverse.cluster_launches) == n
    with pytest.raises(ValueError):       # the launch wrapper: CUDA only
        x_symbols_cluster(W, consts)

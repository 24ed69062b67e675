"""K13's and K14's cluster kernel (csrc pair_cols_cluster_kernel) emulated
on the CPU (tpu_qg_torch.ops.dft_kernels.pair_cols_cluster_emulated, the
CUDA source's index maps in plain torch, all tiles and blocks at once),
against the plain versions and against tpu_qg's Pallas K13 and K14 in
interpret mode; the tile tables; which shapes the kernel takes; K7's route
onto K3's cluster kernel.

The kernel takes M = 128 * 2^a with M / 128 >= 2 G, G in {4, 8, 16}, so
the emulation runs at M = 1024 (G = 4) and 2048 (G = 8), in float64 at
1e-12 of max|plain|: K13 at strip offset 0 and at the last offset, on
blocks of one and of several strips, with an odd strip count (P = 384) and
the self-mirror strips 0 and N2y/2 in the block; K14 on the ranks holding
the self-mirror group 0 (strips 0 and N2y/2, whose last tile is ragged) and
on others. Each own (row, column) is stored exactly once; K13 stores no
column from a mirror tile; X (and K13's companion) is loaded once. One
float32 case each against tpu_qg's _call_x_fwd_symbols_offset and
_call_paired_kernel (interpret=True) at 1e-4, the K13/K14 gate of
chip_smoke.py. The kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops.pallas_fft import PlanarFFT2
from tpu_qg.parallel.paired import PairedDistributedInverter
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.ops import dft_kernels as dk
from tpu_qg_torch.ops.dft_kernels import (
    PAIR_COLS_CLUSTER_BY_MW, PAIR_X_CLUSTER_SIZES, PAIR_X_CLUSTER_WIDTHS,
    SMEM_LIMIT, companion_columns, mirror_companion, offset_cluster_tiles,
    pair_columns, pair_cols_cluster, pair_cols_cluster_emulated,
    pair_cols_cluster_launched, pair_cols_cluster_layout,
    pair_cols_cluster_takes, pair_x_cluster_launched, pair_x_cluster_takes,
    paired_cluster_tiles, paired_x_symbols, paired_x_symbols_plain,
    stream_pair_cluster_takes, stream_pair_symbols, stream_pair_symbols_plain,
    x_fwd_symbols_offset, x_fwd_symbols_offset_plain)
from tpu_qg_torch.ops.step_kernel import packed_symbol_consts
from tpu_qg_torch.parallel.paired import strip_pair_order


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jcfg(M, P):
    return tpu_qg.preset("turbulence-2048").replace(M=M, P=P)


def _consts(M, P):
    return packed_symbol_consts(config_from_jax(_jcfg(M, P)))


def _field(shape, seed, dtype=np.float64):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(dtype))


def _close(got, want, tol):
    got, want = (torch.as_tensor(np.array(x)) for x in (got, want))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def _offset_block(M, P, W, off, seed, dtype=np.float64):
    """A (2, M, W) block of a y-spectrum at global strip ``off`` and the
    same columns of its companion."""
    Zy = _field((2, M, P), seed, dtype)
    Zm = mirror_companion(Zy)
    cols = slice(128 * off, 128 * off + W)
    return Zy[..., cols].contiguous(), Zm[..., cols].contiguous()


def _paired_block(M, P, W, rank, seed, dtype=np.float64):
    """Rank ``rank``'s (2, M, W) block of strips in mirror-pair order and
    its global strip indices."""
    order = strip_pair_order(P // 128)
    s = W // 128
    return _field((2, M, W), seed, dtype), order[rank * s:(rank + 1) * s]


# (M, P, W, strip offset): offset 0 and the last offset; one strip and
# several; P = 384 an odd strip count (strip 0 alone, 1 and 2 a pair), the
# whole of it at offset 0; strips 0 and N2y/2 in the (512, 256, 0) block.
K13_CASES = [(1024, 512, 256, 0), (1024, 512, 256, 2), (1024, 384, 128, 0),
             (1024, 384, 384, 0), (1024, 1024, 128, 7)]


@pytest.mark.parametrize("Cw", PAIR_X_CLUSTER_WIDTHS)
@pytest.mark.parametrize("M,P,W,off", K13_CASES)
def test_emulated_k13_matches_plain(M, P, W, off, Cw):
    consts = _consts(M, P)
    X, Xm = _offset_block(M, P, W, off, M + P + W + off + Cw)
    got, loads, stores = pair_cols_cluster_emulated(
        "offset", X, Xm, (W, off), consts, 4, Cw)
    _close(got, x_fwd_symbols_offset_plain(X, Xm, consts, off), 1e-12)
    assert bool((loads == 1).all()), "an input value loaded other than once"
    assert bool((stores[0] == 1).all()), "an own column stored other than once"
    assert int(stores[1].sum()) == 0, "a mirror tile stored a column"


# (M, P, W, rank): rank 0 holds the self-mirror group 0 (strips 0 and
# N2y/2); P = 1536 has 12 strips, 4 a rank of 3.
K14_CASES = [(1024, 1024, 256, 0), (1024, 1024, 256, 3), (1024, 512, 256, 0),
             (1024, 1536, 512, 0), (1024, 1536, 512, 2)]


@pytest.mark.parametrize("Cw", PAIR_X_CLUSTER_WIDTHS)
@pytest.mark.parametrize("M,P,W,rank", K14_CASES)
def test_emulated_k14_matches_plain(M, P, W, rank, Cw):
    consts = _consts(M, P)
    X, idx = _paired_block(M, P, W, rank, M + P + W + rank + Cw)
    key = (tuple(int(i) for i in idx), P // 128)
    got, loads, stores = pair_cols_cluster_emulated(
        "paired", X, X, key, consts, 4, Cw)
    _close(got, paired_x_symbols_plain(X, idx, consts), 1e-12)
    assert bool((loads[0] == 1).all()), "an input value loaded other than once"
    assert int(loads[1].sum()) == 0
    assert bool((stores.sum(0) == 1).all()), "a column stored other than once"


@pytest.mark.parametrize("kind", ["offset", "paired"])
def test_emulated_at_2048_with_clusters_of_8(kind):
    """(2, 2048, 512) of a 2048-wide y extent, the path's block shape, at
    G = 8: K13 at strip offset 12 (the last of four ranks), K14 on rank 0
    (the self-mirror group)."""
    M, P, W = 2048, 2048, 512
    consts = _consts(M, P)
    if kind == "offset":
        X, Xm = _offset_block(M, P, W, 12, 21)
        key, want = (W, 12), x_fwd_symbols_offset_plain(X, Xm, consts, 12)
    else:
        X, idx = _paired_block(M, P, W, 0, 22)
        Xm = X
        key = (tuple(int(i) for i in idx), P // 128)
        want = paired_x_symbols_plain(X, idx, consts)
    got, loads, stores = pair_cols_cluster_emulated(kind, X, Xm, key, consts,
                                                    8, 16)
    _close(got, want, 1e-12)
    assert bool((stores.sum(0) == 1).all())


def test_emulated_k13_float32_matches_pallas():
    """The emulated K13 in float32 at (1024, 512), a (2, 1024, 256) block
    at strip offset 2, G = 4, Cw = 8, against tpu_qg's
    _call_x_fwd_symbols_offset in interpret mode (1e-4 of max|ref|)."""
    M, P, W, off = 1024, 512, 256, 2
    consts = _consts(M, P)
    X, Xm = _offset_block(M, P, W, off, 31, np.float32)
    want = PlanarFFT2(M, P, interpret=True)._call_x_fwd_symbols_offset(
        jnp.asarray(X.numpy()), jnp.asarray(Xm.numpy()), consts, off)
    got, _, _ = pair_cols_cluster_emulated("offset", X, Xm, (W, off), consts,
                                           4, 8)
    assert got.dtype == torch.float32
    _close(got, want, 1e-4)


def test_emulated_k14_float32_matches_pallas():
    """The emulated K14 in float32 on rank 0 (the self-mirror group) of
    (1024, 1024) over 4 ranks, G = 4, Cw = 8, against tpu_qg's
    _call_paired_kernel in interpret mode (1e-4 of max|ref|)."""
    M, P, W = 1024, 1024, 256
    jcfg = _jcfg(M, P)
    consts = _consts(M, P)
    X, idx = _paired_block(M, P, W, 0, 32, np.float32)
    inv = PairedDistributedInverter(M, P, jcfg.dx, jcfg.S_eig,
                                    jcfg.P_inv_matrix(),
                                    jcfg.back_projection_matrix(),
                                    interpret=True)
    want = inv._call_paired_kernel(jnp.asarray(X.numpy()),
                                   jnp.asarray(idx, jnp.int32))
    got, _, _ = pair_cols_cluster_emulated(
        "paired", X, X, (tuple(int(i) for i in idx), P // 128), consts, 4, 8)
    _close(got, want, 1e-4)


def test_offset_tiles_are_adjacent_columns_and_their_companions():
    """K13's table at strip offset 0 (global strip 0) and 5: own tiles are
    Cw adjacent columns, every column once; mirror tiles the companion
    columns (reversed runs; in global strip 0 lane 0 is its own lane);
    slots the global y slots."""
    for off in (0, 5):
        own, mir, slots = offset_cluster_tiles(256, off, 8)
        assert own.shape == mir.shape == slots.shape == (32, 8)
        np.testing.assert_array_equal(own.reshape(-1), np.arange(256))
        np.testing.assert_array_equal(
            mir.reshape(-1), companion_columns(range(off, off + 2)))
        np.testing.assert_array_equal(slots, 128 * off + own)
    own, mir, _ = offset_cluster_tiles(256, 0, 8)
    np.testing.assert_array_equal(mir[0], [0, 127, 126, 125, 124, 123, 122,
                                           121])
    np.testing.assert_array_equal(mir[16], np.arange(255, 247, -1))


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_paired_tiles_hold_every_pair_once(rank):
    """K14's table on a rank of (1024, 1024) over 4: every unordered pair
    {c, mirror(c)} of local columns once (pair_columns), -1 padding only
    at the end of a strip's tiles; rank 0's global strip 0 has the 65
    canonical lanes 0..64 (lanes 0 and 64 their own mirrors), strip 4 = N2y/2
    the 64 lanes 0..63."""
    P, W, Cw = 1024, 256, 16
    idx = strip_pair_order(P // 128)[2 * rank:2 * rank + 2]
    own, mir, slots = paired_cluster_tiles(idx, P // 128, Cw)
    mirror = pair_columns(idx, P // 128)
    ok = own >= 0
    np.testing.assert_array_equal(mir[ok], mirror[own[ok]])
    np.testing.assert_array_equal(slots[ok], 128 * idx[own[ok] // 128]
                                  + own[ok] % 128)
    pairs = {frozenset((int(a), int(b))) for a, b in zip(own[ok], mir[ok])}
    assert len(pairs) == ok.sum()
    assert pairs == {frozenset((c, int(mirror[c]))) for c in range(W)}
    for t in own:                    # a tile's columns lie in one strip
        assert len({int(c) // 128 for c in t[t >= 0]}) == 1
    if rank == 0:
        assert ok.sum() == 65 + 64
        assert own.shape[0] == 5 + 4
    else:
        assert ok.sum() == 128 and own.shape[0] == 8


def test_the_layout_gate():
    """The block kernel takes M = 128 * 2^a with M / 128 >= 2 G, and the
    mixed extents M = 128 * n with ceil(n / 2) >= G, whole 128-column
    strips, within shared memory: the launched layouts at the path shapes,
    K3's launched layout elsewhere; 384, 640, 768, M < 256 G and ragged
    widths go to pair_cols_kernel."""
    for (M, W), layout in PAIR_COLS_CLUSTER_BY_MW.items():
        assert pair_cols_cluster_launched(M, W) == layout
        assert pair_cols_cluster_takes(M, W)
    assert pair_cols_cluster_launched(1024, 256) == \
        pair_x_cluster_launched(1024)
    assert pair_cols_cluster_takes(1024, 256)
    assert pair_cols_cluster_takes(8192, 4096)
    assert pair_cols_cluster_takes(2432, 512)
    assert pair_cols_cluster_takes(1536, 512)
    for M, W in ((256, 256), (512, 128), (384, 256), (768, 512),
                 (640, 512), (1024, 200), (1024, 0)):
        assert not pair_cols_cluster_takes(M, W), (M, W)
    assert not pair_cols_cluster_takes(1024, 256, (8, 8))     # N2 < 2 G
    assert not pair_cols_cluster_takes(8192, 2048, (4, 16))   # 769 KB
    for a in range(1, 7):
        M = 128 << a
        for G in PAIR_X_CLUSTER_SIZES:
            for Cw in PAIR_X_CLUSTER_WIDTHS:
                if pair_cols_cluster_takes(M, 512, (G, Cw)):
                    assert pair_cols_cluster_layout(M, G, Cw).smem \
                        <= SMEM_LIMIT
                    assert M // 128 >= 2 * G
    lay = pair_cols_cluster_layout(8192, 16, 8)
    assert lay.smem == 8 * (3 * 4096 + 32 + 64) + 4 * 16 + 4 * 8


def test_k7_takes_k3s_cluster_kernel_by_shape():
    """K7 computes K3's function: where K3's cluster kernels take M (the
    powers of two M >= 256 G, 4096 and 8192 among them, and the mixed
    extents with ceil(n / 2) >= G, 2432, 3072 and 6144 among them)
    stream_pair_symbols launches them; small M and 384, 640 and 768, which
    no cluster kernel takes, keep pair_cols_kernel."""
    for M in (1024, 2048, 4096, 8192):
        assert pair_x_cluster_takes(M) and stream_pair_cluster_takes(M)
    for M in (256, 384):
        assert not pair_x_cluster_takes(M)
    for M in (256, 384, 640, 768):
        assert not stream_pair_cluster_takes(M)
    for M in (2432, 3072, 6144):
        assert pair_x_cluster_takes(M) and stream_pair_cluster_takes(M)


def test_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors K13, K14 and K7 run their plain versions and count
    nothing; the block kernel's launch wrapper refuses a CPU tensor."""
    M, P, W = 1024, 512, 256
    consts = _consts(M, P)
    X, Xm = _offset_block(M, P, W, 2, 41, np.float32)
    Y, idx = _paired_block(M, P, W, 0, 42, np.float32)
    Z = _field((2, M, P), 43, np.float32)
    counts = [(f.launches, f.cluster_launches)
              for f in (x_fwd_symbols_offset, paired_x_symbols,
                        stream_pair_symbols)]
    for got, want in (
            (x_fwd_symbols_offset(X, Xm, consts, 2),
             x_fwd_symbols_offset_plain(X, Xm, consts, 2)),
            (paired_x_symbols(Y, idx, consts),
             paired_x_symbols_plain(Y, idx, consts)),
            (stream_pair_symbols(Z, consts),
             stream_pair_symbols_plain(Z, consts))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert counts == [(f.launches, f.cluster_launches)
                      for f in (x_fwd_symbols_offset, paired_x_symbols,
                                stream_pair_symbols)]
    with pytest.raises(ValueError):
        pair_cols_cluster(X, Xm, "offset", (W, 2), consts)
    with pytest.raises(ValueError):
        dk.pair_cols_whole_columns(X, Xm, "offset", (W, 2), consts)

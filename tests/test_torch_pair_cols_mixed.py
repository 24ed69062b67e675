"""K13's and K14's block kernel on the mixed extents M = 128 * N2 (N2 not a
power of two, ceil(N2 / 2) >= G): its emulation (tpu_qg_torch.ops.
dft_kernels.pair_cols_cluster_emulated, which runs csrc
pair_cols_cluster_mixed_kernel's index maps for all tiles and blocks at
once: K3 mixed's stage A over y_dft_mixed_plan(N2), the pull through
rho^-1, K5 mixed's symbol stage and inverse half, on the tile tables of
the block's local columns at row stride W) against the plain versions and
against tpu_qg's Pallas K13 and K14 in interpret mode; the shape rule; K7's
route onto K3's mixed cluster kernel; the wrappers on CPU tensors.

N2 = 7 (one radix-7 pass, U = G = 4), 12 (the 1536 x 2048 mesh's K14
block, plan (4, 3)), 15 (G = 8 takes it too) and 19 (one prime pass, which
the forward runs first from A). Every layout (G, Cw) the kernel takes at
each, in float64 at 1e-12 of max|plain|: K13 on (2, M, 256) blocks of a
512-wide y extent at strip offset 0 (global strip 0, whose lane 0 is its
own companion) and at the odd offset 1 (strips 1 and 2 = N2y/2), K14 on
rank 0 (the self-mirror group: strips 0 and 2, whose last tiles are
ragged) and rank 1 (the pair 1, 3) of two, the offset and the rank turn by
turn over the layouts. Each input element is loaded by exactly one block;
each output element is stored exactly once (K13: by an own tile alone).
One float32 case each at M = 1536 in the launched layout against tpu_qg's
_call_x_fwd_symbols_offset and _call_paired_kernel (interpret=True) at
1e-4 of max|ref|, the K13/K14 gate of chip_smoke.py. The kernel itself
runs only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops.pallas_fft import PlanarFFT2
from tpu_qg.parallel.paired import PairedDistributedInverter
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.ops.dft_kernels import (
    PAIR_X_CLUSTER_SIZES, PAIR_X_CLUSTER_WIDTHS, SMEM_LIMIT,
    mirror_companion, pair_cols_cluster, pair_cols_cluster_emulated,
    pair_cols_cluster_launched, pair_cols_cluster_layout,
    pair_cols_cluster_takes, pair_x_cluster_layout, pair_x_cluster_takes,
    paired_x_symbols, paired_x_symbols_plain, stream_pair_cluster_takes,
    stream_pair_symbols, stream_pair_symbols_plain, x_fwd_symbols_offset,
    x_fwd_symbols_offset_plain)
from tpu_qg_torch.ops.step_kernel import packed_symbol_consts
from tpu_qg_torch.parallel.paired import strip_pair_order

MIXED_N2 = (7, 12, 15, 19)
P, W = 512, 256                  # a 4-strip y extent, 2-strip blocks
K13_OFFSETS = (0, 1)
K14_RANKS = (0, 1)


def _layouts():
    out = []
    for n2 in MIXED_N2:
        taken = [(G, Cw) for G in PAIR_X_CLUSTER_SIZES
                 for Cw in PAIR_X_CLUSTER_WIDTHS
                 if pair_cols_cluster_takes(128 * n2, W, (G, Cw))]
        out += [(n2, k % 2, G, Cw) for k, (G, Cw) in enumerate(taken)]
    return out


LAYOUTS = _layouts()


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
    s = W // 128
    return (_field((2, M, W), seed, dtype),
            strip_pair_order(P // 128)[rank * s:(rank + 1) * s])


def test_every_case_occurs_at_every_n2():
    """G = 4 at every N2 here, G = 8 from N2 = 15 on (U = 8); both K13
    offsets and both K14 ranks at each N2."""
    for n2 in MIXED_N2:
        assert {k for m, k, _, _ in LAYOUTS if m == n2} == {0, 1}
        assert {G for m, _, G, _ in LAYOUTS if m == n2} == (
            {4} if n2 < 15 else {4, 8})
    assert len(LAYOUTS) == 17


@pytest.mark.parametrize("n2,k,G,Cw", LAYOUTS)
def test_emulated_mixed_k13_matches_plain(n2, k, G, Cw):
    M, off = 128 * n2, K13_OFFSETS[k]
    consts = _consts(M, P)
    X, Xm = _offset_block(M, P, W, off, n2 + off + G + Cw)
    got, loads, stores = pair_cols_cluster_emulated(
        "offset", X, Xm, (W, off), consts, G, Cw)
    _close(got, x_fwd_symbols_offset_plain(X, Xm, consts, off), 1e-12)
    assert bool((loads == 1).all()), "an input value loaded other than once"
    assert bool((stores[0] == 1).all()), "an own column stored other than once"
    assert int(stores[1].sum()) == 0, "a mirror tile stored a column"


@pytest.mark.parametrize("n2,k,G,Cw", LAYOUTS)
def test_emulated_mixed_k14_matches_plain(n2, k, G, Cw):
    M, rank = 128 * n2, K14_RANKS[k]
    consts = _consts(M, P)
    X, idx = _paired_block(M, P, W, rank, 100 + n2 + rank + G + Cw)
    key = (tuple(int(i) for i in idx), P // 128)
    got, loads, stores = pair_cols_cluster_emulated(
        "paired", X, X, key, consts, G, Cw)
    _close(got, paired_x_symbols_plain(X, idx, consts), 1e-12)
    assert bool((loads[0] == 1).all()), "an input value loaded other than once"
    assert int(loads[1].sum()) == 0
    assert bool((stores.sum(0) == 1).all()), "a column stored other than once"


def test_emulated_mixed_k13_float32_matches_pallas():
    """The emulated K13 in float32 at (1536, 512), a (2, 1536, 256) block at
    strip offset 1, in the launched layout, against tpu_qg's
    _call_x_fwd_symbols_offset in interpret mode (1e-4 of max|ref|)."""
    M, off = 1536, 1
    consts = _consts(M, P)
    X, Xm = _offset_block(M, P, W, off, 31, np.float32)
    want = PlanarFFT2(M, P, interpret=True)._call_x_fwd_symbols_offset(
        jnp.asarray(X.numpy()), jnp.asarray(Xm.numpy()), consts, off)
    got, _, _ = pair_cols_cluster_emulated(
        "offset", X, Xm, (W, off), consts, *pair_cols_cluster_launched(M, W))
    assert got.dtype == torch.float32
    _close(got, want, 1e-4)


def test_emulated_mixed_k14_float32_matches_pallas():
    """The emulated K14 in float32 on rank 0 (the self-mirror group) of
    (1536, 512) over 2 ranks, in the launched layout, against tpu_qg's
    _call_paired_kernel in interpret mode (1e-4 of max|ref|)."""
    M = 1536
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
        "paired", X, X, (tuple(int(i) for i in idx), P // 128), consts,
        *pair_cols_cluster_launched(M, W))
    _close(got, want, 1e-4)


def test_the_mixed_shape_rule():
    """The block kernel takes a mixed extent wherever K3's cluster kernels
    take it, W whole 128-column strips: the four-rank slices' blocks (3072,
    768) and (1536, 512), and (2432, 512); not 384, 640 and 768 (U < 4).
    Every taken layout fits one block's shared memory, K3 mixed's and 4 Cw
    bytes of global slots; K7 takes K3's cluster kernels at the same M."""
    for M, W_ in ((3072, 768), (1536, 512), (2432, 512), (1920, 128)):
        assert pair_cols_cluster_takes(M, W_) and stream_pair_cluster_takes(M)
    for M in (384, 640, 768):
        assert not pair_cols_cluster_takes(M, 256)
        assert not stream_pair_cluster_takes(M)
    assert not pair_cols_cluster_takes(1536, 200)
    for n2 in range(3, 64):
        M = 128 * n2
        if n2 & (n2 - 1) == 0:
            continue
        for G in PAIR_X_CLUSTER_SIZES:
            for Cw in PAIR_X_CLUSTER_WIDTHS:
                takes = pair_cols_cluster_takes(M, 512, (G, Cw))
                lay = pair_cols_cluster_layout(M, G, Cw)
                assert lay.smem == pair_x_cluster_layout(M, G, Cw).smem \
                    + 4 * Cw
                assert takes == (pair_x_cluster_takes(M, (G, Cw))
                                 and lay.smem <= SMEM_LIMIT)
                if takes:
                    assert (n2 + 1) // 2 >= G
    assert pair_cols_cluster_launched(3072, 768) in (
        (G, Cw) for G in PAIR_X_CLUSTER_SIZES for Cw in PAIR_X_CLUSTER_WIDTHS
        if pair_cols_cluster_takes(3072, 768, (G, Cw)))


def test_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors K13, K14 and K7 at a mixed extent run their plain
    versions and count nothing; the launch wrapper refuses a CPU tensor."""
    M = 1536
    consts = _consts(M, P)
    X, Xm = _offset_block(M, P, W, 1, 41, np.float32)
    Y, idx = _paired_block(M, P, W, 0, 42, np.float32)
    Z = _field((2, M, P), 43, np.float32)
    wrappers = (x_fwd_symbols_offset, paired_x_symbols, stream_pair_symbols)
    counts = [(f.launches, f.cluster_launches, f.mixed_launches)
              for f in wrappers]
    for got, want in (
            (x_fwd_symbols_offset(X, Xm, consts, 1),
             x_fwd_symbols_offset_plain(X, Xm, consts, 1)),
            (paired_x_symbols(Y, idx, consts),
             paired_x_symbols_plain(Y, idx, consts)),
            (stream_pair_symbols(Z, consts),
             stream_pair_symbols_plain(Z, consts))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert counts == [(f.launches, f.cluster_launches, f.mixed_launches)
                      for f in wrappers]
    with pytest.raises(ValueError):
        pair_cols_cluster(X, Xm, "offset", (W, 1), consts)

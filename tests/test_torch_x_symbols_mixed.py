"""K5's cluster kernel on the mixed extents M = 128 * N2 (N2 not a power of
two, ceil(N2 / 2) >= G): its emulation (tpu_qg_torch.ops.dft_kernels.
x_symbols_cluster_emulated, which runs csrc x_symbols_cluster_mixed_kernel's
index maps for all tiles and blocks at once: the ordering that keeps k2
beside N2 - k2, its units split over the G blocks, the owner map of stage
A^-1's pull and stage A^-1 as the passes of y_dft_mixed_plan(N2)) against
K5's plain version and against tpu_qg's Pallas K5 in interpret mode; the
ordering, the split and the owner map; the shape rule; the wrapper on CPU
tensors.

N2 = 20 (radix 4 and 5), 22 (2 * 11: a prime pass last, which the inverse
runs first), 23 (one prime pass), 24 (the 3072^2 path's), 48 (16 * 3) and
61 (the largest prime pass, odd N2 with blocks of unequal row counts).
Every layout (G, Cw) that the kernel takes at each, in float64 at 1e-12 of
max|plain|, each on one of P = 256 (strips 0 and 1, each its own mirror)
and 384 (an odd strip count) in turn, so that both occur at every N2;
strip 0's last tile is ragged for every Cw. Each element of the input must
be loaded by exactly one block and each of the output stored by exactly
one. One float32 case against tpu_qg's PlanarFFT2._call_x_symbols
(interpret=True) at (3072, 128) at 1e-4, the K5 gate of
tests/test_torch_dft_kernels.py (the kernel's 1/M is a float32 product,
not exact for a mixed M; its rounding is far inside the gate).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops.pallas_fft import PlanarFFT2
from tpu_qg.ops.spectral import PackedModalInverterPallasFFT
from tpu_qg_torch.ops.dft_kernels import (SMEM_LIMIT, X_SYMBOLS_CLUSTER_BY_M,
                                          X_SYMBOLS_CLUSTER_SIZES,
                                          X_SYMBOLS_CLUSTER_WIDTHS,
                                          x_kernels_take, x_symbols_cluster,
                                          x_symbols_cluster_emulated,
                                          x_symbols_cluster_launched,
                                          x_symbols_cluster_layout,
                                          x_symbols_cluster_owner,
                                          x_symbols_cluster_rows,
                                          x_symbols_cluster_takes,
                                          x_symbols_inverse,
                                          x_symbols_inverse_plain,
                                          y_dft_mixed_plan, y_dft_mixed_rho)
from tpu_qg_torch.ops.spectral import PackedModalInverterKernels

MIXED_N2 = (20, 22, 23, 24, 48, 61)
PS = (256, 384)


def _layouts():
    out = []
    for n2 in MIXED_N2:
        taken = [(G, Cw) for G in X_SYMBOLS_CLUSTER_SIZES
                 for Cw in X_SYMBOLS_CLUSTER_WIDTHS
                 if x_symbols_cluster_takes(128 * n2, (G, Cw))]
        out += [(n2, PS[k % len(PS)], G, Cw)
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


def _close(got, want, tol):
    got, want = (torch.as_tensor(np.array(x)) for x in (got, want))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_every_p_occurs_at_every_n2():
    for n2 in MIXED_N2:
        assert {P for m, P, _, _ in LAYOUTS if m == n2} == set(PS)
    assert len(LAYOUTS) == 32


@pytest.mark.parametrize("n2,P,G,Cw", LAYOUTS)
def test_emulated_mixed_cluster_kernel_matches_plain(n2, P, G, Cw):
    M = 128 * n2
    consts = _ours(M, P)
    W = torch.from_numpy(np.random.default_rng(n2 + P + G + Cw)
                         .standard_normal((2, M, P)))
    got, loads, stores = x_symbols_cluster_emulated(W, consts, G, Cw)
    _close(got, x_symbols_inverse_plain(W, consts), 1e-12)
    assert bool((loads == 1).all()), "an element loaded other than once"
    assert bool((stores == 1).all()), "an element stored other than once"


def test_emulated_float32_matches_pallas():
    """The emulated kernel in float32 at (3072, 128), the 3072^2 path's
    N2 = 24 in its launched layout, against tpu_qg's Pallas K5 in
    interpret mode (1e-4 of max|ref|)."""
    M, P = 3072, 128
    ref = PackedModalInverterPallasFFT(*_consts(M, P), interpret=True,
                                       pair_x=True)._sym_consts
    ours = _ours(M, P)
    assert ours == ref
    x = np.random.default_rng(7).standard_normal((2, M, P)).astype(np.float32)
    want = PlanarFFT2(M, P, interpret=True)._call_x_symbols(jnp.asarray(x),
                                                             ref)
    got, _, _ = x_symbols_cluster_emulated(torch.from_numpy(x), ours,
                                           *x_symbols_cluster_launched(M))
    assert got.dtype == torch.float32
    _close(got, want, 1e-4)


@pytest.mark.parametrize("n2", [20, 21, 23, 24, 33, 48, 61, 63, 64])
@pytest.mark.parametrize("G", X_SYMBOLS_CLUSTER_SIZES)
def test_ordering_split_and_owner_map(n2, G):
    """The ordering holds every k2 once, k2 = 0 first, for even N2 then
    N2/2, then each pair m, N2 - m side by side; the split gives every block
    at least one unit and cuts no pair; the owner map sends each DIT
    position p to the block, own-tile row and mirror-tile row of k2 =
    rho[p]."""
    units = (n2 + 1) // 2
    if units < G:
        return
    k2, start = x_symbols_cluster_rows(n2, G)
    assert sorted(k2) == list(range(n2))
    odd = n2 % 2
    assert k2[0] == 0 and (odd or k2[1] == n2 // 2)
    for i in range(2 - odd, n2, 2):
        assert k2[i] + k2[i + 1] == n2 and k2[i] < k2[i + 1]
    assert start[0] == 0 and start[-1] == n2
    counts = np.diff(start)
    assert counts.min() >= 1 and counts.max() <= x_symbols_cluster_layout(
        128 * n2, G, 8).l2
    # A block's first row is a unit's first row: rows 0 and (for pairs)
    # 2 - odd + 2j.
    assert all(s == 0 or (s - (2 - odd)) % 2 == 0 for s in start)
    if n2 & (n2 - 1) == 0:                   # a power of two: even split
        assert list(start) == [r * n2 // G for r in range(G + 1)]
    owner, own_row, mir_row = x_symbols_cluster_owner(n2, G)
    rho = y_dft_mixed_rho(y_dft_mixed_plan(n2))
    row_of = np.argsort(k2)
    for p in range(n2):
        i = row_of[rho[p]]
        b = owner[p]
        assert start[b] <= i < start[b + 1]
        assert own_row[p] == i - start[b]
        assert mir_row[p] == own_row[p] + counts[b]


def test_layouts_fit_shared_memory_and_the_table_is_taken():
    """Every mixed layout the kernel takes fits one block's shared memory
    and has ceil(N2 / 2) >= G; the launched layouts are taken; the 3072^2
    path's extent is taken in the launched layout; U < G and extents past
    63 * 128 are not."""
    for n2 in range(3, 64):
        if n2 & (n2 - 1) == 0:
            continue
        for G in X_SYMBOLS_CLUSTER_SIZES:
            for Cw in X_SYMBOLS_CLUSTER_WIDTHS:
                if x_symbols_cluster_takes(128 * n2, (G, Cw)):
                    assert x_symbols_cluster_layout(
                        128 * n2, G, Cw).smem <= SMEM_LIMIT
                    assert (n2 + 1) // 2 >= G
    for M, layout in X_SYMBOLS_CLUSTER_BY_M.items():
        assert x_symbols_cluster_launched(M) == layout
        assert x_symbols_cluster_takes(M) and x_kernels_take(M, M)
    assert x_symbols_cluster_takes(3072)
    assert not x_symbols_cluster_takes(1536)       # U = 6 < G = 8
    assert not x_symbols_cluster_takes(1536, (8, 8))
    assert x_symbols_cluster_takes(1536, (4, 8))
    assert not x_symbols_cluster_takes(128 * 65, (16, 8))
    lay = x_symbols_cluster_layout(3072, 8, 8)
    assert (lay.n2, lay.l1, lay.l2, lay.tile) == (24, 16, 4, 3072)
    assert lay.smem == 8 * (2 * 128 * 4 * 8 + 3072 + 24 + 64) + 4 * (16 + 72)


def test_wrapper_takes_the_plain_version_on_cpu():
    M, P = 3072, 128
    consts = _ours(M, P)
    W = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, M, P))).float()
    n = (x_symbols_inverse.launches, x_symbols_inverse.cluster_launches,
         x_symbols_inverse.mixed_launches)
    torch.testing.assert_close(x_symbols_inverse(W, consts),
                               x_symbols_inverse_plain(W, consts),
                               rtol=0, atol=0)
    assert (x_symbols_inverse.launches, x_symbols_inverse.cluster_launches,
            x_symbols_inverse.mixed_launches) == n
    with pytest.raises(ValueError):       # the launch wrapper: CUDA only
        x_symbols_cluster(W, consts)

"""K3's cluster kernel on the mixed extents M = 128 * N2 (N2 not a power of
two, ceil(N2 / 2) >= G): its emulation (tpu_qg_torch.ops.dft_kernels.
pair_x_cluster_emulated, which runs csrc pair_x_cluster_mixed_kernel's
index maps for all tiles and blocks at once: stage A as the passes of
y_dft_mixed_plan(N2), the pull of each block's rows of the k2-beside-N2-k2
ordering through the map k2 -> rho^-1(k2), stage B into buffer B at K5
mixed's row stride, K5 mixed's symbol stage and inverse half) against K3's
plain version and against tpu_qg's Pallas K3 in interpret mode; the pull
map; the shape rule; the wrapper on CPU tensors.

N2 = 7 (one radix-7 pass; U = G = 4, the smallest N2 taken), 12 (the
1536^2 path's, plan (4, 3)), 15 (G = 8 takes it too), 18 (plan (2, 3, 3))
and 19 (one prime pass, which the forward runs first from A; 2432, the
largest extent of the pair-x route). Every layout
(G, Cw) that the kernel takes at each, in float64 at 1e-12 of max|plain|,
on P = 256 (strips 0 and 1, each its own mirror) and 384 (an odd strip
count) in turn, so that both occur at every N2; strip 0's last tile is
ragged for every Cw. Each element of the input must be loaded by exactly
one block and each of the output stored by exactly one. One float32 case
against tpu_qg's PlanarFFT2.pair_x_symbols (interpret=True) at (1536, 128)
in the launched layout at 1e-4, the K3 gate of
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
from tpu_qg_torch.ops.dft_kernels import (PAIR_X_CLUSTER,
                                          PAIR_X_CLUSTER_BY_M,
                                          PAIR_X_CLUSTER_SIZES,
                                          PAIR_X_CLUSTER_SMALL,
                                          PAIR_X_CLUSTER_WIDTHS, SMEM_LIMIT,
                                          kernels_take, pair_x_cluster,
                                          pair_x_cluster_emulated,
                                          pair_x_cluster_launched,
                                          pair_x_cluster_layout,
                                          pair_x_cluster_pull,
                                          pair_x_cluster_takes,
                                          pair_x_symbols,
                                          pair_x_symbols_plain,
                                          x_symbols_cluster_layout,
                                          x_symbols_cluster_takes,
                                          y_dft_mixed_plan, y_dft_mixed_rho)
from tpu_qg_torch.ops.spectral import PackedModalInverterKernels

MIXED_N2 = (7, 12, 15, 18, 19)
PS = (256, 384)


def _layouts():
    out = []
    for n2 in MIXED_N2:
        taken = [(G, Cw) for G in PAIR_X_CLUSTER_SIZES
                 for Cw in PAIR_X_CLUSTER_WIDTHS
                 if pair_x_cluster_takes(128 * n2, (G, Cw))]
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
    """G = 4 at every N2 here, G = 8 from N2 = 15 on (U = 8); both P at
    each."""
    for n2 in MIXED_N2:
        assert {P for m, P, _, _ in LAYOUTS if m == n2} == set(PS)
        assert {G for m, _, G, _ in LAYOUTS if m == n2} == (
            {4} if n2 < 15 else {4, 8})
    assert len(LAYOUTS) == 22


@pytest.mark.parametrize("n2,P,G,Cw", LAYOUTS)
def test_emulated_mixed_cluster_kernel_matches_plain(n2, P, G, Cw):
    M = 128 * n2
    consts = _ours(M, P)
    Zy = torch.from_numpy(np.random.default_rng(n2 + P + G + Cw)
                          .standard_normal((2, M, P)))
    got, loads, stores = pair_x_cluster_emulated(Zy, consts, G, Cw)
    _close(got, pair_x_symbols_plain(Zy, consts), 1e-12)
    assert bool((loads == 1).all()), "an element loaded other than once"
    assert bool((stores == 1).all()), "an element stored other than once"


def test_emulated_float32_matches_pallas():
    """The emulated kernel in float32 at (1536, 128), the 1536^2 path's N2 =
    12 in its launched layout, against tpu_qg's Pallas K3 in interpret mode
    (1e-4 of max|ref|)."""
    M, P = 1536, 128
    ref = PackedModalInverterPallasFFT(*_consts(M, P), interpret=True,
                                       pair_x=True)._sym_consts
    ours = _ours(M, P)
    assert ours == ref
    x = np.random.default_rng(8).standard_normal((2, M, P)).astype(np.float32)
    want = PlanarFFT2(M, P, interpret=True).pair_x_symbols(jnp.asarray(x),
                                                           ref)
    got, _, _ = pair_x_cluster_emulated(torch.from_numpy(x), ours,
                                        *pair_x_cluster_launched(M))
    assert got.dtype == torch.float32
    _close(got, want, 1e-4)


@pytest.mark.parametrize("n2", [7, 12, 15, 16, 18, 19, 22, 24, 61])
def test_pull_map_inverts_rho(n2):
    """Stage B's pull finds k2 at A row pair_x_cluster_pull(N2)[k2]: the
    inverse of the digit reversal rho of y_dft_mixed_plan(N2) (the bit
    reversal for a power of two)."""
    rho = y_dft_mixed_rho(y_dft_mixed_plan(n2))
    kinv = pair_x_cluster_pull(n2)
    assert sorted(kinv) == list(range(n2))
    assert (rho[kinv] == np.arange(n2)).all()
    assert (kinv[rho] == np.arange(n2)).all()


def test_the_shape_rule():
    """The mixed extents are taken wherever K5's cluster kernels take them
    and the pull's map fits: G = 4 at 896 ... 1792, G = 8 also at 1920,
    2176, 2304 and 2432; 384, 640 and 768 (U < 4) are not, nor are the
    powers of two below 256 G. The launched layouts are taken (off the
    table, (8, 8) where it fits, else (4, 8)); every taken layout fits one
    block's shared memory, K5 mixed's and 4 N2 bytes."""
    for M in (384, 640, 768, 256, 512):
        assert not pair_x_cluster_takes(M)
        assert not any(pair_x_cluster_takes(M, (G, Cw))
                       for G in PAIR_X_CLUSTER_SIZES
                       for Cw in PAIR_X_CLUSTER_WIDTHS)
    for n2 in range(7, 20):
        M = 128 * n2
        if n2 & (n2 - 1) == 0:
            continue
        assert pair_x_cluster_takes(M) and kernels_take(M, M)
        if M not in PAIR_X_CLUSTER_BY_M:
            assert pair_x_cluster_launched(M) == (
                PAIR_X_CLUSTER if n2 >= 15 else PAIR_X_CLUSTER_SMALL)
        assert pair_x_cluster_takes(M, (4, 8))
        assert pair_x_cluster_takes(M, (8, 8)) == (n2 >= 15)
        for G in PAIR_X_CLUSTER_SIZES:
            for Cw in PAIR_X_CLUSTER_WIDTHS:
                if pair_x_cluster_takes(M, (G, Cw)):
                    lay = pair_x_cluster_layout(M, G, Cw)
                    assert lay.smem <= SMEM_LIMIT
                    assert lay.smem == x_symbols_cluster_layout(
                        M, G, Cw).smem + 4 * n2
                    assert x_symbols_cluster_takes(M, (G, Cw))
                    assert (n2 + 1) // 2 >= G
    for M, layout in PAIR_X_CLUSTER_BY_M.items():
        assert pair_x_cluster_launched(M) == layout
        assert pair_x_cluster_takes(M)
    lay = pair_x_cluster_layout(1536, 4, 8)
    assert (lay.n2, lay.l1, lay.l2, lay.tile) == (12, 32, 4, 3072)
    assert lay.smem == 8 * (2 * 128 * 4 * 8 + 3072 + 12 + 64) + 4 * (16 + 48)
    assert 2 * (lay.smem + 1024) <= 228 * 1024       # two blocks an SM


def test_wrapper_takes_the_plain_version_on_cpu():
    M, P = 1536, 128
    consts = _ours(M, P)
    Zy = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, M, P))).float()
    n = (pair_x_symbols.launches, pair_x_symbols.cluster_launches,
         pair_x_symbols.mixed_launches)
    torch.testing.assert_close(pair_x_symbols(Zy, consts),
                               pair_x_symbols_plain(Zy, consts),
                               rtol=0, atol=0)
    assert (pair_x_symbols.launches, pair_x_symbols.cluster_launches,
            pair_x_symbols.mixed_launches) == n
    with pytest.raises(ValueError):       # the launch wrapper: CUDA only
        pair_x_cluster(Zy, consts)

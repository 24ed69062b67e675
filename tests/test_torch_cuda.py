"""The CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``; without a card every test skips. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances relative to max|plain|: K1 and K8 1e-6, K2 and K4 1e-5 (K2's
factored kernel in every layout, K4's cluster kernel's first half, stage
A, too), K3 and
K5 1e-4 (the 1/lambda symbol amplifies low-k float32 rounding; K3's and
K5's cluster kernels, their mixed ones too, in every layout), a four-pass inversion on a smooth
zeta no less accurate against float64 than twice the plain versions'; the
one-launch kernels as the kernels they fuse: K16 1e-4, K17 1e-6 (zeta_new,
carry) and 1e-4 (psi_new), K15 1e-6 (zeta_new, carry) and 1e-5 (zeta_ys);
their persistent kernels (K15, K16, K17 and K15's sharded form) bitwise
the separate kernels they fuse, each launch in rows_launches, and the first
forms on the shapes and operands the persistent kernels do not take;
K9 1e-6 (K1's body); K10 and K11 1e-6 (tests/test_multigrid.py's kernel
tolerance), and the multigrid solves on the card 1e-5 from the CPU's (a
float64 solve under "auto", on the level-op chain, 1e-12 from the float64
spectral inversion). The
sharded kernels as the kernels they extend: K12 1e-6, K15's sharded form
1e-6 (zeta_new, carry) and 1e-5 (zeta_ys), K13, K14 and K7 1e-4 (K13's
and K14's cluster kernel in every layout, K7 on K3's cluster kernel, with
their cluster counts; pair_cols_kernel at the other extents). K18 (the
stencil lab's step) 1e-6, its base instance bitwise K1. K1's, K9's,
K12's and K18's row-streaming kernels bitwise the tile design (step_kernel,
tendency_kernel, lab_step_kernel: every K18 body, one and two layers), K12
bitwise K1, K9's two-layer tendency bitwise K1's euler_ab3 step-0 carry,
with the rows_launches counters; their tile kernels (step_kernel,
step_sharded_kernel, tendency_kernel, lab_step_kernel) on P % 4 != 0 and
misaligned operands, 1e-6 from plain and bitwise the row kernel. K10's and K11's row-streaming
kernel (mg_rows_kernel) bitwise their tile kernels in every form, with
both rows_launches counters; the tile kernels on the shapes, sweep counts
and misaligned operands the row kernel does not take.
"""

import numpy as np
import pytest
import torch

from tpu_qg_torch import preset
from tpu_qg_torch.models.core import (QGModel, _build_solvers, _invert_psi,
                                      init_state)
from tpu_qg_torch.ops.dft_kernels import (
    mirror_companion, mono_invert, mono_invert_plain, mono_invert_rows,
    pair_cols_cluster,
    pair_cols_cluster_takes, pair_cols_whole_columns, pair_x_cluster,
    pair_x_cluster_takes, pair_x_symbols, pair_x_symbols_plain,
    paired_x_symbols, paired_x_symbols_plain, stream_pair_cluster_takes,
    stream_pair_symbols, stream_pair_symbols_plain, x_dft,
    x_dft_cluster_takes, x_dft_plain, x_dft_stage_a, x_dft_stage_a_plain,
    x_fwd_symbols_offset, x_fwd_symbols_offset_plain, x_symbols_cluster,
    x_symbols_cluster_takes, x_symbols_inverse, x_symbols_inverse_plain,
    y_dft, y_dft_factored, y_dft_factored_takes, y_dft_plain)
from tpu_qg_torch.ops import dft_kernels, mg_kernels
from tpu_qg_torch.ops._stencil_lab import (lab_step, lab_step_plain,
                                           lab_step_rows, lab_step_tile)
from tpu_qg_torch.ops.mg_kernels import (mg_prolong_smooth,
                                         mg_prolong_smooth_plain, mg_smooth,
                                         mg_smooth_plain)
from tpu_qg_torch.ops.multigrid import MultigridModalInverter
from tpu_qg_torch.ops.spectral import (PackedModalInverter,
                                       PackedModalInverterKernels)
from tpu_qg_torch.ops.step_kernel import (fused_pre_inversion,
                                          fused_pre_inversion_plain,
                                          fused_step, fused_step_full,
                                          fused_step_full_plain,
                                          fused_step_plain, fused_step_rows,
                                          fused_step_sharded,
                                          fused_step_sharded_plain,
                                          fused_step_tile,
                                          step_rows_layouts,
                                          fused_step_yspec,
                                          fused_step_yspec_plain,
                                          fused_step_yspec_sharded,
                                          fused_step_yspec_sharded_plain,
                                          fused_tendency,
                                          fused_tendency_plain,
                                          fused_tendency_rows,
                                          fused_tendency_tile,
                                          packed_symbol_consts)

pytestmark = pytest.mark.cuda
# Powers of two, and 128 * n extents that the kernels take in mixed radix.
# (2432, 8064) holds the largest odd factors of the pair-x route (19, 63).
SHAPES = [(256, 256), (256, 512), (512, 128), (256, 384), (384, 640),
          (1536, 1152), (2432, 8064)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels build and run only on one")
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _fields(M, P, dev, seed=0):
    g = np.random.default_rng(seed)
    return [torch.as_tensor(s * g.standard_normal((2, M, P)),
                            dtype=torch.float32, device=dev)
            for s in (1e-5, 1e3, 1e-9, 1e-9)]


@pytest.mark.parametrize("M,P", SHAPES)
@pytest.mark.parametrize("scheme,tau0,step", [
    ("euler_ab3", 0.0, 0), ("euler_ab3", 0.0, 5), ("leapfrog_ra", 0.1, 3)])
def test_step_kernel(dev, M, P, scheme, tau0, step):
    cfg = preset("turbulence-2048").replace(M=M, P=P, time_scheme=scheme,
                                            wind_tau0=tau0)
    z, p, f1, f2 = _fields(M, P, dev)
    n = fused_step.launches
    got = fused_step(cfg, z, p, f1, f2, step)
    want = fused_step_plain(cfg, z, p, f1, f2, step)
    torch.cuda.synchronize()
    assert fused_step.launches == n + 1
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-6


@pytest.mark.parametrize("M,P", SHAPES)
@pytest.mark.parametrize("scheme,tau0,step", [
    ("euler_ab3", 0.0, 0), ("euler_ab3", 0.0, 5), ("leapfrog_ra", 0.1, 0),
    ("leapfrog_ra", 0.1, 3)])
def test_step_rows_kernel_bitwise_tile_design(dev, M, P, scheme, tau0, step):
    """K1 by its row-streaming kernel (counted in rows_launches) gives the
    bits of the tile design (step_kernel)."""
    cfg = preset("turbulence-2048").replace(M=M, P=P, time_scheme=scheme,
                                            wind_tau0=tau0)
    z, p, f1, f2 = _fields(M, P, dev)
    n = fused_step.rows_launches
    got = fused_step(cfg, z, p, f1, f2, step)
    base = fused_step_tile(cfg, z, p, f1, f2, step)
    torch.cuda.synchronize()
    assert fused_step.rows_launches == n + 1
    assert all(torch.equal(g, b) for g, b in zip(got, base))


@pytest.mark.parametrize("M,P", [(384, 640), (2432, 8064)])
def test_step_rows_every_layout(dev, M, P):
    """Every layout the source instantiates, bitwise the tile kernel, on a
    ragged last strip (640 and 8064 for W = 256) and ragged runs."""
    cfg = preset("turbulence-2048").replace(M=M, P=P)
    z, p, f1, f2 = _fields(M, P, dev)
    tile = fused_step_tile(cfg, z, p, f1, f2, 5)
    for layout in step_rows_layouts():
        got = fused_step_rows(cfg, z, p, f1, f2, 5, layout)
        assert all(torch.equal(g, t) for g, t in zip(got, tile)), layout


def test_step_rows_routing(dev):
    """P % 4 != 0 and a misaligned operand take the tile kernel: launches
    counts them, rows_launches does not."""
    cfg = preset("turbulence-2048").replace(M=256, P=258)
    z, p, f1, f2 = _fields(256, 258, dev)
    n, n_rows = fused_step.launches, fused_step.rows_launches
    got = fused_step(cfg, z, p, f1, f2, 5)
    assert (fused_step.launches, fused_step.rows_launches) == (n + 1, n_rows)
    for g, w in zip(got, fused_step_plain(cfg, z, p, f1, f2, 5)):
        assert _rel(g, w) <= 1e-6
    cfg = preset("turbulence-2048").replace(M=256, P=256)
    z, p, f1, f2 = _fields(256, 256, dev)
    shifted = torch.empty(2 * 256 * 256 + 1, device=dev)[1:].view(2, 256, 256)
    shifted.copy_(z)
    got = fused_step(cfg, shifted, p, f1, f2, 5)
    torch.cuda.synchronize()
    assert (fused_step.launches, fused_step.rows_launches) == (n + 2, n_rows)
    assert all(torch.equal(g, t) for g, t in zip(
        got, fused_step_rows(cfg, z, p, f1, f2, 5)))


@pytest.mark.parametrize("M,P", SHAPES)
def test_dft_kernels(dev, M, P):
    x = _fields(M, P, dev, seed=1)[1]
    for inverse in (False, True):
        assert _rel(y_dft(x, inverse), y_dft_plain(x, inverse)) <= 1e-5
    cfg = preset("turbulence-2048").replace(M=M, P=P)
    consts = PackedModalInverterKernels(
        M, P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
        cfg.back_projection_matrix())._sym_consts
    assert _rel(pair_x_symbols(x, consts),
                pair_x_symbols_plain(x, consts)) <= 1e-4


# K3's cluster kernel: 1024^2 and 2048^2, and ragged P (strip 0's last
# tile, an odd strip count), every layout at each.
@pytest.mark.parametrize("M,P", [(1024, 1024), (2048, 2048), (2048, 384),
                                 (1024, 640)])
def test_pair_x_cluster_kernel(dev, M, P):
    x = _fields(M, P, dev, seed=M + P)[1]
    consts = _consts(M, P)
    want = pair_x_symbols_plain(x, consts)
    n = (pair_x_symbols.launches, pair_x_symbols.cluster_launches)
    assert _rel(pair_x_symbols(x, consts), want) <= 1e-4
    torch.cuda.synchronize()
    assert (pair_x_symbols.launches,
            pair_x_symbols.cluster_launches) == (n[0] + 1, n[1] + 1)
    for layout in ((G, Cw) for G in dft_kernels.PAIR_X_CLUSTER_SIZES
                   for Cw in dft_kernels.PAIR_X_CLUSTER_WIDTHS):
        if (pair_x_cluster_takes(M, layout) and
                dft_kernels.pair_x_cluster_occupancy(M, layout, 0)):
            assert _rel(pair_x_cluster(x, consts, layout), want) <= 1e-4
    torch.cuda.synchronize()
    assert pair_x_symbols.cluster_launches == n[1] + 1   # counts none


# K3's mixed cluster kernel (pair_x_cluster_mixed_kernel): the 1536^2
# path's extent (128 * 12, plan (4, 3)) and 2432 = 128 * 19 (one prime
# pass, the largest extent of the pair-x route) on an odd strip count, in
# the launched layout and every other that fits.
@pytest.mark.parametrize("M,P", [(1536, 256), (2432, 384)])
def test_pair_x_mixed_cluster_kernel(dev, M, P):
    x = _fields(M, P, dev, seed=M + P)[1]
    consts = _consts(M, P)
    want = pair_x_symbols_plain(x, consts)
    n = (pair_x_symbols.launches, pair_x_symbols.cluster_launches,
         pair_x_symbols.mixed_launches)
    assert _rel(pair_x_symbols(x, consts), want) <= 1e-4
    torch.cuda.synchronize()
    assert (pair_x_symbols.launches, pair_x_symbols.cluster_launches,
            pair_x_symbols.mixed_launches) == (n[0] + 1, n[1], n[2] + 1)
    for layout in ((G, Cw) for G in dft_kernels.PAIR_X_CLUSTER_SIZES
                   for Cw in dft_kernels.PAIR_X_CLUSTER_WIDTHS):
        if (pair_x_cluster_takes(M, layout) and
                dft_kernels.pair_x_cluster_occupancy(M, layout, 0)):
            assert _rel(pair_x_cluster(x, consts, layout), want) <= 1e-4
    torch.cuda.synchronize()
    assert pair_x_symbols.mixed_launches == n[2] + 1   # counts none


# pair_x_kernel keeps the mixed extents with ceil(n / 2) < 4 (768 = 128 *
# 6) and M < 256 G.
@pytest.mark.parametrize("M,P", [(768, 256), (384, 256), (512, 512)])
def test_pair_x_kernel_keeps_the_other_extents(dev, M, P):
    x = _fields(M, P, dev, seed=M + P)[1]
    consts = _consts(M, P)
    n = (pair_x_symbols.launches, pair_x_symbols.cluster_launches,
         pair_x_symbols.mixed_launches)
    assert _rel(pair_x_symbols(x, consts),
                pair_x_symbols_plain(x, consts)) <= 1e-4
    torch.cuda.synchronize()
    assert (pair_x_symbols.launches, pair_x_symbols.cluster_launches,
            pair_x_symbols.mixed_launches) == (n[0] + 1, n[1], n[2])


def test_pair_x_cluster_refuses_what_it_does_not_take(dev):
    x = torch.zeros((2, 1024, 256), device=dev)
    consts = _consts(1024, 256)
    with pytest.raises(ValueError):                 # N2 = 8 < 2 G
        pair_x_cluster(x, consts, (8, 8))
    with pytest.raises(ValueError):                 # ceil(12 / 2) < G = 8
        pair_x_cluster(torch.zeros((2, 1536, 256), device=dev),
                       _consts(1536, 256), (8, 8))
    with pytest.raises(ValueError):                 # ceil(6 / 2) < 4
        pair_x_cluster(torch.zeros((2, 768, 256), device=dev),
                       _consts(768, 256))
    with pytest.raises(TypeError):
        pair_x_cluster(x.double(), consts)


# Four-pass extents: powers of two, and the mixed radix 2560 = 512 * 5,
# 4224 = 128 * 33 (the unfused route), 6144 = 2048 * 3, 8064 = 128 * 63.
# K4's cluster kernel takes the powers of two from 128 G (ragged last tiles
# at P = 252 and 100), its mixed form the other 128 n from 128 G, the older
# kernel the rest (256).
X_SHAPES = [(256, 384), (2560, 256), (4224, 256), (6144, 384), (8064, 256),
            (8192, 128), (4096, 4096), (8192, 8192), (8192, 252),
            (2048, 100)]


def _consts(M, P):
    cfg = preset("turbulence-2048").replace(M=M, P=P)
    return PackedModalInverterKernels(
        M, P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
        cfg.back_projection_matrix())._sym_consts


@pytest.mark.parametrize("M,P", X_SHAPES)
def test_x_dft_kernels(dev, M, P):
    x = _fields(M, P, dev, seed=2)[1]
    n = (x_dft.launches, x_symbols_inverse.launches, x_dft.cluster_launches,
         x_symbols_inverse.cluster_launches, x_dft.mixed_launches,
         x_symbols_inverse.mixed_launches)
    mixed = x_dft_cluster_takes(M) and dft_kernels._mixed(M)
    cluster = x_dft_cluster_takes(M) and not mixed
    for inverse in (False, True):
        assert _rel(x_dft(x, inverse), x_dft_plain(x, inverse)) <= 1e-5
        if cluster or mixed:
            assert _rel(x_dft_stage_a(x, inverse),
                        x_dft_stage_a_plain(x, inverse)) <= 1e-5
    k5 = P % 128 == 0            # K5 (and its symbols) take P = 128 n
    k5_cluster = k5 and x_symbols_cluster_takes(M)
    k5_mixed = k5_cluster and dft_kernels._mixed(M)
    if k5:
        consts = _consts(M, P)
        assert _rel(x_symbols_inverse(x, consts),
                    x_symbols_inverse_plain(x, consts)) <= 1e-4
    torch.cuda.synchronize()
    assert (x_dft.launches, x_symbols_inverse.launches,
            x_dft.cluster_launches, x_symbols_inverse.cluster_launches,
            x_dft.mixed_launches, x_symbols_inverse.mixed_launches) == (
                n[0] + 2, n[1] + k5, n[2] + 2 * cluster,
                n[3] + (k5_cluster and not k5_mixed), n[4] + 2 * mixed,
                n[5] + k5_mixed)


# K4's mixed cluster kernel (x_dft_cluster_mixed_kernel): 2560 = 128 * 20,
# the 3072^2 path's grid (128 * 24), the unfused route's 4352 = 128 * 34
# (its plan ends in the prime 17) and 7808 = 128 * 61 (one prime pass), in
# the launched layout and every other that fits, both ways and stage A.
@pytest.mark.parametrize("M,P", [(2560, 512), (3072, 3072), (4352, 256),
                                 (7808, 384)])
def test_x_dft_mixed_cluster_kernel(dev, M, P):
    x = _fields(M, P, dev, seed=M + 3)[1]
    want = [x_dft_plain(x, inverse) for inverse in (False, True)]
    n = (x_dft.launches, x_dft.mixed_launches, x_dft.cluster_launches)
    for inverse in (False, True):
        assert _rel(x_dft(x, inverse), want[inverse]) <= 1e-5
        assert _rel(x_dft_stage_a(x, inverse),
                    x_dft_stage_a_plain(x, inverse)) <= 1e-5
    torch.cuda.synchronize()
    assert (x_dft.launches, x_dft.mixed_launches,
            x_dft.cluster_launches) == (n[0] + 2, n[1] + 2, n[2])
    for layout in ((G, Cw) for G in dft_kernels.CLUSTER_SIZES
                   for Cw in dft_kernels.CLUSTER_WIDTHS):
        if (x_dft_cluster_takes(M, *layout) and
                dft_kernels.x_dft_cluster_occupancy(M, layout, 0)):
            for inverse in (False, True):
                assert _rel(dft_kernels.x_dft_cluster(x, inverse, layout),
                            want[inverse]) <= 1e-5
    torch.cuda.synchronize()
    assert x_dft.mixed_launches == n[1] + 2     # x_dft_cluster counts none


# K5's cluster kernel: 4096^2 and 8192^2, a ragged P (strip 0's last tile,
# an odd strip count) and the smallest M of the launched default layout.
@pytest.mark.parametrize("M,P", [(4096, 4096), (8192, 8192), (8192, 384),
                                 (2048, 640)])
def test_x_symbols_cluster_kernel(dev, M, P):
    x = _fields(M, P, dev, seed=M + P)[1]
    consts = _consts(M, P)
    want = x_symbols_inverse_plain(x, consts)
    n = (x_symbols_inverse.launches, x_symbols_inverse.cluster_launches)
    assert _rel(x_symbols_inverse(x, consts), want) <= 1e-4
    torch.cuda.synchronize()
    assert (x_symbols_inverse.launches,
            x_symbols_inverse.cluster_launches) == (n[0] + 1, n[1] + 1)
    if M != 4096:
        return
    for layout in ((G, Cw) for G in dft_kernels.X_SYMBOLS_CLUSTER_SIZES
                   for Cw in dft_kernels.X_SYMBOLS_CLUSTER_WIDTHS):
        if (x_symbols_cluster_takes(M, layout) and
                dft_kernels.x_symbols_cluster_occupancy(M, layout, 0)):
            assert _rel(x_symbols_cluster(x, consts, layout), want) <= 1e-4
    torch.cuda.synchronize()
    assert x_symbols_inverse.cluster_launches == n[1] + 1   # counts none


# K5's mixed cluster kernel (x_symbols_cluster_mixed_kernel): 2560 = 128 *
# 20, 2816 = 128 * 22 (its plan ends in the prime 11, which the inverse runs
# first), the 3072^2 path's grid (128 * 24), 6144 = 128 * 48 and 7808 = 128
# * 61 (one prime pass, blocks of unequal row counts), on P with strip 0's
# ragged tile and an odd strip count, in the launched layout and every
# other that fits.
@pytest.mark.parametrize("M,P", [(2560, 512), (2816, 384), (3072, 3072),
                                 (6144, 256), (7808, 384)])
def test_x_symbols_mixed_cluster_kernel(dev, M, P):
    x = _fields(M, P, dev, seed=M + P + 1)[1]
    consts = _consts(M, P)
    want = x_symbols_inverse_plain(x, consts)
    n = (x_symbols_inverse.launches, x_symbols_inverse.mixed_launches,
         x_symbols_inverse.cluster_launches)
    assert _rel(x_symbols_inverse(x, consts), want) <= 1e-4
    torch.cuda.synchronize()
    assert (x_symbols_inverse.launches, x_symbols_inverse.mixed_launches,
            x_symbols_inverse.cluster_launches) == (n[0] + 1, n[1] + 1, n[2])
    for layout in ((G, Cw) for G in dft_kernels.X_SYMBOLS_CLUSTER_SIZES
                   for Cw in dft_kernels.X_SYMBOLS_CLUSTER_WIDTHS):
        if (x_symbols_cluster_takes(M, layout) and
                dft_kernels.x_symbols_cluster_occupancy(M, layout, 0)):
            assert _rel(x_symbols_cluster(x, consts, layout), want) <= 1e-4
    torch.cuda.synchronize()
    assert x_symbols_inverse.mixed_launches == n[1] + 1   # counts none


def test_four_pass_inversion_takes_the_cluster_k5(dev):
    """pod-8192's inversion at 4096^2 (K2, K4, K5, K2^-1): every K4 and K5
    launch by its cluster kernel; psi against float64 no worse than twice
    the plain versions' route."""
    cfg = preset("pod-8192").replace(M=4096, P=4096)
    args = (cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())
    inv = PackedModalInverterKernels(*args)
    assert inv.route == "four-pass"
    zeta = init_state(cfg, dev).zeta
    n = (x_symbols_inverse.launches, x_symbols_inverse.cluster_launches,
         x_dft.cluster_launches)
    for _ in range(3):
        psi = inv(zeta)
    torch.cuda.synchronize()
    assert (x_symbols_inverse.launches, x_symbols_inverse.cluster_launches,
            x_dft.cluster_launches) == (n[0] + 3, n[1] + 3, n[2] + 3)
    consts = inv._sym_consts
    plain = y_dft_plain(x_symbols_inverse_plain(
        x_dft_plain(y_dft_plain(zeta, False), False), consts), True)
    psi64 = PackedModalInverter(*args)(zeta.double())
    assert _rel(psi.double(), psi64) <= max(2 * _rel(plain.double(), psi64),
                                            1e-6)


def test_x_symbols_cluster_refuses_what_it_does_not_take(dev):
    x = torch.zeros((2, 8192, 256), device=dev)
    consts = _consts(8192, 256)
    with pytest.raises(ValueError):                 # 385 KB of shared memory
        x_symbols_cluster(x, consts, (4, 8))
    with pytest.raises(ValueError):                 # N2 = 8 < 2 G
        x_symbols_cluster(torch.zeros((2, 1024, 256), device=dev),
                          _consts(1024, 256), (8, 8))
    with pytest.raises(ValueError):                 # mixed, U = 6 < G = 8
        x_symbols_cluster(torch.zeros((2, 1536, 256), device=dev),
                          _consts(1536, 256), (8, 8))
    with pytest.raises(TypeError):
        x_symbols_cluster(x.double(), consts)


@pytest.mark.parametrize("layers,gauge", [(1, "zero_mean"), (2, "pin")])
@pytest.mark.parametrize("scheme,tau0,step", [
    ("euler_ab3", 0.0, 5), ("leapfrog_ra", 0.1, 3)])
def test_pre_inversion_kernel(dev, layers, gauge, scheme, tau0, step):
    cfg = preset("turbulence-2048").replace(
        M=256, P=256, n_layers=layers, poisson_gauge=gauge,
        time_scheme=scheme, wind_tau0=tau0)
    z, p, f1, f2 = (t[:layers].contiguous() for t in _fields(256, 256, dev))
    n = fused_pre_inversion.launches
    got = fused_pre_inversion(cfg, z, p, f1, f2, step)
    want = fused_pre_inversion_plain(cfg, z, p, f1, f2, step)
    torch.cuda.synchronize()
    assert fused_pre_inversion.launches == n + 1
    for g, w in zip(got, want):
        assert g.shape == (layers, 256, 256)
        assert _rel(g, w) <= 1e-6


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    with pytest.raises(TypeError):
        y_dft(torch.zeros((2, 8, 256), dtype=torch.float64, device=dev), False)
    with pytest.raises(ValueError):     # odd factor 65 > MAX_ODD
        y_dft(torch.zeros((2, 8, 130), device=dev), False)


# K2's factored kernel on P = 128 * 2^b, its mixed-radix form on 384 =
# 128 * 3, 1536 = 128 * 12, 2432 = 128 * 19 and 7808 = 128 * 61 (the
# largest prime pass), and y_dft_kernel on 96 = 32 * 3 and 128 (no factored
# form), on 37 rows (a ragged last block for every Rb > 1) and 64.
@pytest.mark.parametrize("P", [256, 512, 1024, 2048, 4096, 8192, 384, 1536,
                               2432, 7808, 96, 128])
@pytest.mark.parametrize("rows", [37, 64])
def test_y_dft_routes_and_factored_kernel(dev, P, rows):
    x = _fields(rows, P, dev, seed=P + rows)[1]
    factored = P in dft_kernels.Y_FACTORED_RB_BY_P
    mixed = not factored and y_dft_factored_takes(P)
    n = (y_dft.launches, y_dft.factored_launches, y_dft.mixed_launches)
    for inverse in (False, True):
        assert _rel(y_dft(x, inverse), y_dft_plain(x, inverse)) <= 1e-5
    torch.cuda.synchronize()
    assert (y_dft.launches, y_dft.factored_launches,
            y_dft.mixed_launches) == (n[0] + 2, n[1] + 2 * factored,
                                      n[2] + 2 * mixed)
    for layout in {(1, 256), (2, 256), (4, 256), (8, 256), (1, 512),
                   (2, 512), dft_kernels.y_dft_factored_launched(P)}:
        if y_dft_factored_takes(P, layout):
            for inverse in (False, True):
                assert _rel(y_dft_factored(x, inverse, layout),
                            y_dft_plain(x, inverse)) <= 1e-5
    torch.cuda.synchronize()
    # y_dft_factored counts none.
    assert (y_dft.factored_launches, y_dft.mixed_launches) == (
        n[1] + 2 * factored, n[2] + 2 * mixed)


def test_factored_wrapper_refuses_what_it_does_not_take(dev):
    x = torch.zeros((2, 8, 512), device=dev)
    with pytest.raises(TypeError):
        y_dft_factored(x.double(), False)
    with pytest.raises(ValueError):                 # not contiguous
        y_dft_factored(x[:, :, ::2], False)
    with pytest.raises(ValueError):
        y_dft(x[:, :, ::2], False)
    for P in (128, 128 * 65):                       # N2 outside 2 ... 64
        with pytest.raises(ValueError):
            y_dft_factored(torch.zeros((2, 8, P), device=dev), False)
    with pytest.raises(ValueError):                 # Rb not a power of two
        y_dft_factored(x, False, (3, 256))
    with pytest.raises(ValueError):                 # no such block size
        y_dft_factored(x, False, (2, 128))
    with pytest.raises(ValueError):                 # mixed: no such block size
        y_dft_factored(torch.zeros((2, 8, 384), device=dev), False, (8, 128))


COUNTED = (fused_step, y_dft, pair_x_symbols, x_dft, x_symbols_inverse,
           fused_pre_inversion)


# Launches per step of (K1, K2, K3, K4, K5, K8) on each route.
@pytest.mark.parametrize("overrides,per_step", [
    (dict(M=256, P=256), (1, 2, 1, 0, 0, 0)),
    (dict(M=256, P=384), (1, 2, 1, 0, 0, 0)),
    (dict(M=256, P=384, fft_pairx="off"), (1, 2, 0, 1, 1, 0)),
    (dict(M=4224, P=256), (1, 2, 0, 2, 0, 0)),
    (dict(M=256, P=256, poisson_gauge="pin"), (0, 0, 0, 0, 0, 1)),
    (dict(M=256, P=256, n_layers=1), (0, 0, 0, 0, 0, 1)),
])
def test_model_on_card_matches_cpu(dev, overrides, per_step):
    cfg = preset("turbulence-2048").replace(**overrides)
    psi0 = init_state(cfg, "cpu").psi
    gpu = QGModel(cfg, dev)
    cpu = QGModel(cfg, "cpu")
    counts = [f.launches for f in COUNTED]
    a = gpu.run(gpu.init_state(psi_init=psi0), 10)
    b = cpu.run(cpu.init_state(psi_init=psi0), 10)
    assert [f.launches - c for f, c in zip(COUNTED, counts)] == [
        10 * k for k in per_step]
    assert _rel(a.zeta.cpu(), b.zeta) <= 1e-5


# The one-launch kernels. K16 at a mixed-radix P, the largest M of the mono
# gate and P = 8192; K17 at the gate's squares and rectangles, including
# M = 2560 and 4096 (K3's device code past the pair-x route's 2432) and
# M = 6272 = 128 * 49 (the own and mirror groups in turn); K15 at P = 8192
# and M = 8192.
@pytest.mark.parametrize("M,P", [(256, 384), (2432, 256), (256, 8192)])
def test_mono_kernel(dev, M, P):
    x = _fields(M, P, dev, seed=3)[1]
    consts = _consts(M, P)
    n = mono_invert.launches
    got = mono_invert(x, consts)
    want = mono_invert_plain(x, consts)
    torch.cuda.synchronize()
    assert mono_invert.launches == n + 1
    assert _rel(got, want) <= 1e-4


ONE_LAUNCH_STEPS = [("euler_ab3", 0.0, 0), ("euler_ab3", 0.0, 5),
                    ("leapfrog_ra", 0.1, 3)]


@pytest.mark.parametrize("M,P", [(256, 256), (2560, 2560), (4096, 256),
                                 (6272, 128)])
@pytest.mark.parametrize("scheme,tau0,step", ONE_LAUNCH_STEPS)
def test_fullstep_kernel(dev, M, P, scheme, tau0, step):
    cfg = preset("turbulence-2048").replace(M=M, P=P, time_scheme=scheme,
                                            wind_tau0=tau0)
    z, p, f1, f2 = _fields(M, P, dev)
    n = fused_step_full.launches
    got = fused_step_full(cfg, z, p, f1, f2, step)
    want = fused_step_full_plain(cfg, z, p, f1, f2, step)
    torch.cuda.synchronize()
    assert fused_step_full.launches == n + 1
    for g, w in zip(got[:2], want[:2]):
        assert _rel(g, w) <= 1e-6
    # psi_new against the inversion of the kernel's own zeta_new, K16's
    # gate; where 1/lambda lifts float32 rounding of this white input past
    # 1e-4 (6272 x 128), both are held against float64 and the kernel may
    # err no more than twice the plain version.
    consts = _consts(M, P)
    plain_psi = mono_invert_plain(got[0], consts)
    if _rel(got[2], plain_psi) > 1e-4:
        ref = mono_invert_plain(got[0].double(), consts)
        assert _rel(got[2].double(), ref) <= 2 * _rel(plain_psi.double(), ref)


@pytest.mark.parametrize("M,P", [(256, 384), (2560, 256), (256, 8192),
                                 (8192, 256)])
@pytest.mark.parametrize("scheme,tau0,step", ONE_LAUNCH_STEPS)
def test_yspec_kernel(dev, M, P, scheme, tau0, step):
    cfg = preset("turbulence-2048").replace(M=M, P=P, time_scheme=scheme,
                                            wind_tau0=tau0)
    z, p, f1, f2 = _fields(M, P, dev)
    p_ys = y_dft_plain(p, False)
    n = fused_step_yspec.launches
    got = fused_step_yspec(cfg, z, p_ys, f1, f2, step)
    want = fused_step_yspec_plain(cfg, z, p_ys, f1, f2, step)
    torch.cuda.synchronize()
    assert fused_step_yspec.launches == n + 1
    for g, w, tol in zip(got, want, (1e-6, 1e-6, 1e-5)):
        assert _rel(g, w) <= tol


def _separate_route(k, cfg, z, p, f1, f2, step):
    """The separate redesigned kernels K17 (K1 -> K2 -> K3 -> K2^-1) or K15
    (K2^-1 -> K1 -> K2; p a y-spectrum) fuses."""
    if k == "K17":
        zn, carry = fused_step(cfg, z, p, f1, f2, step)
        return zn, carry, y_dft(pair_x_symbols(y_dft(zn, False),
                                               packed_symbol_consts(cfg)),
                                True)
    zn, carry = fused_step(cfg, z, y_dft(p, True), f1, f2, step)
    return zn, carry, y_dft(zn, False)


# The persistent K17 at the 2048^2 slices' grid, K3's mixed instance
# (1536), the smallest M K3's cluster kernels take (896 = 128 * 7, 1024)
# and a rectangle whose x and y stages take different instances; K15 at
# 2048^2, the mixed 3072^2 and 256 x 384.
@pytest.mark.parametrize("k,M,P", [
    ("K17", 2048, 2048), ("K17", 1536, 1536), ("K17", 896, 256),
    ("K17", 1024, 256), ("K17", 2048, 1536), ("K15", 2048, 2048),
    ("K15", 3072, 3072), ("K15", 256, 384)])
@pytest.mark.parametrize("scheme,tau0,step", ONE_LAUNCH_STEPS)
def test_persistent_one_launch_bitwise_separate_route(dev, k, M, P, scheme,
                                                      tau0, step):
    """K17's and K15's persistent kernels (csrc/coop_rows.cuh), each stage
    in its separate kernel's layout, give the separate route's bits, and
    each launch counts in rows_launches."""
    cfg = preset("turbulence-2048").replace(M=M, P=P, time_scheme=scheme,
                                            wind_tau0=tau0)
    z, p, f1, f2 = _fields(M, P, dev)
    if k == "K15":
        p = y_dft_plain(p, False)
    wrapper = fused_step_full if k == "K17" else fused_step_yspec
    n = (wrapper.launches, wrapper.rows_launches)
    got = wrapper(cfg, z, p, f1, f2, step)
    want = _separate_route(k, cfg, z, p, f1, f2, step)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.rows_launches) == (n[0] + 1, n[1] + 1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_persistent_one_launch_routing(dev):
    """The first forms keep what the persistent kernels do not take: P =
    128 (no factored K2), M = 256 for K17 (below K3's cluster kernels) and
    an operand view that is not 16-byte aligned; there rows_launches stays
    put."""
    cfg = preset("turbulence-2048").replace(M=256, P=128)
    z, p, f1, f2 = _fields(256, 128, dev)
    for wrapper in (fused_step_full, fused_step_yspec):
        n = (wrapper.launches, wrapper.rows_launches)
        wrapper(cfg, z, p, f1, f2, 5)
        torch.cuda.synchronize()
        assert (wrapper.launches, wrapper.rows_launches) == (n[0] + 1, n[1])
    cfg = cfg.replace(P=256)
    z, p, f1, f2 = _fields(256, 256, dev)
    n = fused_step_full.rows_launches
    fused_step_full(cfg, z, p, f1, f2, 5)
    assert fused_step_full.rows_launches == n
    big = torch.empty(2 * 256 * 256 + 1, device=dev)
    view = big[1:].view(2, 256, 256)
    view.copy_(p)
    n = fused_step_yspec.rows_launches
    got = fused_step_yspec(cfg, z, view, f1, f2, 5)
    want = fused_step_yspec_plain(cfg, z, view, f1, f2, 5)
    torch.cuda.synchronize()
    assert fused_step_yspec.rows_launches == n
    for g, w, tol in zip(got, want, (1e-6, 1e-6, 1e-5)):
        assert _rel(g, w) <= tol


ALL_COUNTED = {"K1": fused_step, "K2": y_dft, "K3": pair_x_symbols,
               "K4": x_dft, "K5": x_symbols_inverse, "K8": fused_pre_inversion,
               "K15": fused_step_yspec, "K16": mono_invert,
               "K17": fused_step_full}


# Launches of 10 steps in one QGModel.run: the chain's K2 runs once at each
# end of the run.
@pytest.mark.parametrize("overrides,launches", [
    (dict(fft_mono="on"), {"K1": 10, "K16": 10}),
    (dict(step_full="on"), {"K17": 10}),
    (dict(step_chain="on"), {"K15": 10, "K3": 10, "K2": 2}),
    (dict(step_chain="on", M=4096), {"K15": 10, "K4": 10, "K5": 10, "K2": 2}),
], ids=["mono", "fullstep", "chain", "chain-four-pass"])
def test_one_launch_routes_on_card_match_cpu(dev, overrides, launches):
    cfg = preset("turbulence-2048").replace(**{"M": 256, "P": 256,
                                               **overrides})
    psi0 = init_state(cfg, "cpu").psi
    gpu = QGModel(cfg, dev)
    cpu = QGModel(cfg, "cpu")
    assert gpu.route == cpu.route != "default"
    counts = {k: f.launches for k, f in ALL_COUNTED.items()}
    a = gpu.run(gpu.init_state(psi_init=psi0), 10)
    b = cpu.run(cpu.init_state(psi_init=psi0), 10)
    torch.cuda.synchronize()
    assert {k: f.launches - counts[k] for k, f in ALL_COUNTED.items()} == {
        k: launches.get(k, 0) for k in ALL_COUNTED}
    assert _rel(a.zeta.cpu(), b.zeta) <= 1e-5


@pytest.mark.parametrize("M,P", [(256, 384), (136, 384), (8192, 8192)])
@pytest.mark.parametrize("layers,tau0", [(2, 0.0), (2, 0.1), (1, 0.1)])
def test_tendency_kernel(dev, M, P, layers, tau0):
    cfg = preset("turbulence-2048").replace(M=M, P=P, n_layers=layers,
                                            wind_tau0=tau0)
    z, p = (t[:layers].contiguous() for t in _fields(M, P, dev)[:2])
    n = (fused_tendency.launches, fused_tendency.rows_launches)
    got = fused_tendency(cfg, z, p)
    want = fused_tendency_plain(cfg, z, p)
    torch.cuda.synchronize()
    assert (fused_tendency.launches,
            fused_tendency.rows_launches) == (n[0] + 1, n[1] + 1)
    assert got.shape == (layers, M, P)
    assert _rel(got, want) <= 1e-6


# K9's row kernel bitwise its tile kernel, one and two layers, with and
# without the wind, on a ragged last run and strip (M = 200, P = 1000).
@pytest.mark.parametrize("M,P", [(200, 1000), (2048, 2048)])
@pytest.mark.parametrize("layers,tau0", [(2, 0.0), (2, 0.1), (1, 0.1),
                                         (1, 0.0)])
def test_tendency_rows_bitwise_tile_kernel(dev, M, P, layers, tau0):
    cfg = preset("turbulence-2048").replace(M=M, P=P, n_layers=layers,
                                            wind_tau0=tau0)
    z, p = (t[:layers].contiguous() for t in _fields(M, P, dev)[:2])
    assert torch.equal(fused_tendency_rows(cfg, z, p),
                       fused_tendency_tile(cfg, z, p))


@pytest.mark.parametrize("M,P", [(200, 1000), (2048, 2048)])
@pytest.mark.parametrize("tau0", [0.0, 0.1])
def test_tendency_is_k1_carry(dev, M, P, tau0):
    """K9's two-layer tendency is bitwise K1's carry under euler_ab3 at step
    0 (the update stores the tendency as the carry), on both designs."""
    cfg = preset("turbulence-2048").replace(M=M, P=P, wind_tau0=tau0)
    z, p, f1, f2 = _fields(M, P, dev)
    assert torch.equal(fused_tendency_rows(cfg, z, p),
                       fused_step(cfg, z, p, f1, f2, 0)[1])
    assert torch.equal(fused_tendency_tile(cfg, z, p),
                       fused_step_tile(cfg, z, p, f1, f2, 0)[1])


def test_tendency_rows_routing(dev):
    """P % 4 != 0 and a misaligned operand take the tile kernel: launches
    counts them, rows_launches does not."""
    cfg = preset("turbulence-2048").replace(M=256, P=258)
    z, p = _fields(256, 258, dev)[:2]
    n, n_rows = fused_tendency.launches, fused_tendency.rows_launches
    got = fused_tendency(cfg, z, p)
    assert _rel(got, fused_tendency_plain(cfg, z, p)) <= 1e-6
    cfg = preset("turbulence-2048").replace(M=256, P=256)
    z, p = _fields(256, 256, dev)[:2]
    shifted = torch.empty(2 * 256 * 256 + 1, device=dev)[1:].view(2, 256, 256)
    shifted.copy_(z)
    got = fused_tendency(cfg, shifted, p)
    torch.cuda.synchronize()
    assert (fused_tendency.launches,
            fused_tendency.rows_launches) == (n + 2, n_rows)
    assert torch.equal(got, fused_tendency_rows(cfg, z, p))


def _mg_fields(M, P, dev, seed):
    g = np.random.default_rng(seed)
    return [torch.as_tensor(s * g.standard_normal(shape), dtype=torch.float32,
                            device=dev)
            for s, shape in ((1e-2, (2, M, P)), (1e-5, (2, M, P)),
                             (1e-3, (2, M // 2, P // 2)))]


def _mg_alphas(M):
    cfg = preset("pod-8192-mg").replace(M=M, P=M)
    return cfg.dx, (0.0, cfg.S_eig)


# Shapes the reference's gates admit: (2048, 1152) and (136, 384) only the
# residual and smooth-only forms (P % 256, tile), (136, 384) and
# (2064, 512) with a ragged last row of tiles, the rest every form.
@pytest.mark.parametrize("M,P", [(2048, 1152), (136, 384), (2064, 512),
                                 (512, 512), (8192, 8192)])
@pytest.mark.parametrize("nu", [2, 5])
def test_mg_kernels(dev, M, P, nu):
    dx, alphas = _mg_alphas(M)
    u, f, ec = _mg_fields(M, P, dev, nu)
    forms = [(True, False), (False, False)]
    if mg_kernels.mg_smooth_supported(2, M, P, nu, True, restrict=True):
        forms.append((True, True))
    n = (mg_smooth.launches, mg_prolong_smooth.launches)
    for residual, restrict in forms:
        assert mg_kernels.mg_smooth_supported(2, M, P, nu, residual)
        got = mg_smooth(u, f, dx, alphas, nu, residual, 0.8, restrict)
        want = mg_smooth_plain(u, f, dx, alphas, nu, residual, 0.8, restrict)
        assert _rel(got[0], want[0]) <= 1e-6
        if residual:
            assert got[1].shape == want[1].shape
            assert _rel(got[1], want[1]) <= 1e-6
    prolong = mg_kernels.mg_prolong_supported(2, M, P, nu)
    if prolong:
        got = mg_prolong_smooth(u, ec, f, dx, alphas, nu)
        assert _rel(got, mg_prolong_smooth_plain(u, ec, f, dx, alphas,
                                                 nu)) <= 1e-6
    torch.cuda.synchronize()
    assert (mg_smooth.launches, mg_prolong_smooth.launches) == (
        n[0] + len(forms), n[1] + int(prolong))


@pytest.mark.parametrize("M,cycles", [(512, 2), (1024, 3)])
def test_multigrid_inverter_on_card_matches_cpu(dev, M, cycles):
    """Warm-started MG inversions on the card (K10, K11 on the kernel
    levels, extent >= 512: 1 at 512^2, 2 at 1024^2, each launch by the
    row-streaming kernel) against the CPU's plain route, on the smooth
    vortex state: on grid noise two float32 routes differ by the float32
    floor of the inversion (~eps M / 5 of max|psi|, 2e-5 here)."""
    cfg = preset("pod-8192-mg").replace(M=M, P=M, ic_type="vortex")
    args = (M, M, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())
    state = init_state(cfg, "cpu")
    inv = MultigridModalInverter(*args, n_cycles=cycles)
    levels = sum(inv.solver._kernel_level(lvl)
                 for lvl in range(len(inv.solver.levels)))
    assert levels == (1 if M == 512 else 2)
    n = _mg_counts()
    got = inv(state.zeta.to(dev), psi_prev=state.psi.to(dev) * 0.99)
    want = MultigridModalInverter(*args, n_cycles=cycles, use_pallas="off")(
        state.zeta, psi_prev=state.psi * 0.99)
    torch.cuda.synchronize()
    assert _mg_counts() == tuple(c + cycles * levels for c in n)
    assert _rel(got.cpu(), want) <= 1e-5


def test_multigrid_inverter_float64_on_card_auto(dev):
    """A float64 MultigridModalInverter call on the card under "auto": the
    kernels take float32 alone, so every level takes the level-op chain
    (no K10/K11 launch) and the call matches the float64 spectral
    inversion within 1e-12 (16 V-cycles on the smooth vortex state)."""
    M = 512
    cfg = preset("pod-8192-mg").replace(M=M, P=M, ic_type="vortex",
                                        dtype="float64")
    args = (M, M, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())
    state = init_state(cfg, dev)
    assert state.zeta.dtype == torch.float64
    inv = MultigridModalInverter(*args, n_cycles=16)
    n = _mg_counts()
    got = inv(state.zeta)
    want = _invert_psi(cfg, _build_solvers(cfg), state.zeta)
    torch.cuda.synchronize()
    assert _mg_counts() == n
    assert got.dtype == torch.float64
    assert _rel(got, want) <= 1e-12


def _mg_counts():
    return (mg_smooth.launches, mg_prolong_smooth.launches,
            mg_smooth.rows_launches, mg_prolong_smooth.rows_launches)


def _mg_form_pair(form, u, f, ec, dx, alphas, nu, layout=None):
    """(row kernel's, tile kernel's) outputs of ``form``, (u, r | None)."""
    if form == "prolong":
        return (mg_kernels.mg_rows(form, u, f, ec, dx, alphas, nu, 0.8,
                                   layout)[0],
                mg_kernels.mg_prolong_tile(u, ec, f, dx, alphas, nu))
    res, rst = form != "smooth", form == "restrict"
    return (mg_kernels.mg_rows(form, u, f, None, dx, alphas, nu, 0.8,
                               layout),
            mg_kernels.mg_smooth_tile(u, f, dx, alphas, nu, res, 0.8, rst))


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


# The row-streaming kernel's shapes: whole strips and runs (512^2), a
# ragged last run for R = 64 (2064 x 512), strips narrower than 120 (48^2,
# 136 x 384's last), a ragged last strip (248^2, one mode), and 8192^2.
@pytest.mark.parametrize("K,M,P", [(2, 512, 512), (2, 2064, 512),
                                   (2, 48, 48), (2, 136, 384),
                                   (1, 248, 248), (2, 8192, 8192)])
@pytest.mark.parametrize("nu", [1, 2])
@pytest.mark.parametrize("form", mg_kernels.MG_FORMS)
def test_mg_rows_bitwise_tile(dev, form, K, M, P, nu):
    """The row-streaming kernel in its launched layout and two others gives
    the tile kernel's bits in every form."""
    dx, alphas = _mg_alphas(M)
    u, f, ec = (t[:K].contiguous() for t in _mg_fields(M, P, dev, nu))
    alphas = alphas[:K]
    for layout in (None, (8, 1, 64), (128, 4, 256)):
        got, want = _mg_form_pair(form, u, f, ec, dx, alphas, nu, layout)
        torch.cuda.synchronize()
        assert _same(got, want), layout


def test_mg_rows_routing(dev):
    """mg_smooth and mg_prolong_smooth launch the row kernel where
    mg_rows_takes (rows_launches counts it) and the tile kernel on the rest:
    P % 8 == 4 for the restrict and prolong forms, nu = 3, a misaligned
    view; the tile route within 1e-6 of plain, the row route bitwise the
    tile kernel."""
    dx, alphas = _mg_alphas(512)
    u, f, ec = _mg_fields(512, 132, dev, 7)
    n = _mg_counts()
    got = mg_smooth(u, f, dx, alphas, 2, True, 0.8)          # rows
    assert _same(got, mg_kernels.mg_smooth_tile(u, f, dx, alphas, 2))
    rc = mg_smooth(u, f, dx, alphas, 2, True, 0.8, True)     # tile: P % 8
    assert _rel(rc[1], mg_smooth_plain(u, f, dx, alphas, 2, True, 0.8,
                                       True)[1]) <= 1e-6
    mg_prolong_smooth(u, ec, f, dx, alphas, 2)               # tile: P % 8
    torch.cuda.synchronize()
    assert _mg_counts() == (n[0] + 2, n[1] + 1, n[2] + 1, n[3])
    u, f, ec = _mg_fields(512, 512, dev, 8)
    whole = torch.empty(u.numel() + 1, device=dev)
    shifted = whole[1:].view_as(u)
    shifted.copy_(u)
    n = _mg_counts()
    got = mg_smooth(shifted, f, dx, alphas, 2, True, 0.8, True)   # tile
    assert _same(got, mg_smooth(u, f, dx, alphas, 2, True, 0.8, True))
    got = mg_prolong_smooth(shifted, ec, f, dx, alphas, 3)        # tile: nu
    assert _rel(got, mg_prolong_smooth_plain(u, ec, f, dx, alphas,
                                             3)) <= 1e-6
    torch.cuda.synchronize()
    assert _mg_counts() == (n[0] + 2, n[1] + 1, n[2] + 1, n[3])


def _slabs(fields, r0, m, H):
    """(top, bottom) H-row slabs of the global fields around rows
    [r0, r0 + m), with the periodic wrap."""
    M = fields[0].shape[1]
    rows_top = [(r0 - H + i) % M for i in range(H)]
    rows_bot = [(r0 + m + i) % M for i in range(H)]
    return [(a[:, rows_top].contiguous(), a[:, rows_bot].contiguous())
            for a in fields]


@pytest.mark.parametrize("M,P,nx,H", [(512, 256, 4, 8), (384, 384, 8, 2),
                                      (2048, 2048, 4, 2)])
@pytest.mark.parametrize("scheme,tau0,step", [
    ("euler_ab3", 0.0, 5), ("leapfrog_ra", 0.1, 3)])
def test_sharded_step_kernel(dev, M, P, nx, H, scheme, tau0, step):
    """K12 on each rank's row block (48-row blocks at 384: a partial tile
    that reaches past the bottom slab) against its plain version and K1's
    rows of the whole field."""
    cfg = preset("turbulence-2048").replace(M=M, P=P, time_scheme=scheme,
                                            wind_tau0=tau0)
    z, p, f1, f2 = _fields(M, P, dev)
    whole = fused_step_plain(cfg, z, p, f1, f2, step)
    m = M // nx
    n = fused_step_sharded.launches
    for k in (0, nx - 1):
        rows = slice(k * m, (k + 1) * m)
        (zt, zb), (pt, pb) = _slabs((z, p), k * m, m, H)
        block = [a[:, rows].contiguous() for a in (z, p, f1, f2)]
        got = fused_step_sharded(cfg, *block, step, zt, zb, pt, pb)
        want = fused_step_sharded_plain(cfg, *block, step, zt, zb, pt, pb)
        for g, w, w_all in zip(got, want, whole):
            assert _rel(g, w) <= 1e-6
            assert _rel(g, w_all[:, rows]) <= 1e-6
    torch.cuda.synchronize()
    assert fused_step_sharded.launches == n + 2


@pytest.mark.parametrize("M,P", [(256, 256), (384, 640), (2048, 2048)])
@pytest.mark.parametrize("scheme,tau0,step", [
    ("euler_ab3", 0.0, 5), ("leapfrog_ra", 0.1, 3)])
def test_sharded_rows_kernel_bitwise_k1(dev, M, P, scheme, tau0, step):
    """K12 on the whole field with its wrap rows as slabs (a one-rank
    mesh's block) by its row-streaming kernel (counted in rows_launches)
    gives K1's bits."""
    cfg = preset("turbulence-2048").replace(M=M, P=P, time_scheme=scheme,
                                            wind_tau0=tau0)
    z, p, f1, f2 = _fields(M, P, dev)
    (zt, zb), (pt, pb) = _slabs((z, p), 0, M, 2)
    n = fused_step_sharded.rows_launches
    got = fused_step_sharded(cfg, z, p, f1, f2, step, zt, zb, pt, pb)
    k1 = fused_step(cfg, z, p, f1, f2, step)
    torch.cuda.synchronize()
    assert fused_step_sharded.rows_launches == n + 1
    assert all(torch.equal(g, w) for g, w in zip(got, k1))


def test_sharded_rows_routing(dev):
    """K12 on P % 4 != 0 and with a misaligned slab takes its tile kernel
    (step_sharded_kernel): launches counts it, rows_launches does not, and
    it agrees with the plain version and bitwise with the row kernel."""
    cfg = preset("turbulence-2048").replace(M=256, P=258)
    z, p, f1, f2 = _fields(256, 258, dev)
    rows = slice(64, 128)
    block = [a[:, rows].contiguous() for a in (z, p, f1, f2)]
    (zt, zb), (pt, pb) = _slabs((z, p), 64, 64, 2)
    n, n_rows = fused_step_sharded.launches, fused_step_sharded.rows_launches
    got = fused_step_sharded(cfg, *block, 5, zt, zb, pt, pb)
    assert (fused_step_sharded.launches,
            fused_step_sharded.rows_launches) == (n + 1, n_rows)
    want = fused_step_sharded_plain(cfg, *block, 5, zt, zb, pt, pb)
    k1 = fused_step(cfg, z, p, f1, f2, 5)
    for g, w, w1 in zip(got, want, k1):
        assert _rel(g, w) <= 1e-6
        assert torch.equal(g, w1[:, rows])
    cfg = preset("turbulence-2048").replace(M=256, P=256)
    z, p, f1, f2 = _fields(256, 256, dev)
    block = [a[:, rows].contiguous() for a in (z, p, f1, f2)]
    (zt, zb), (pt, pb) = _slabs((z, p), 64, 64, 2)
    shifted = torch.empty(zt.numel() + 1, device=dev)[1:].view_as(zt)
    shifted.copy_(zt)
    got = fused_step_sharded(cfg, *block, 5, shifted, zb, pt, pb)
    torch.cuda.synchronize()
    assert (fused_step_sharded.launches,
            fused_step_sharded.rows_launches) == (n + 2, n_rows)
    want = fused_step_sharded_plain(cfg, *block, 5, zt, zb, pt, pb)
    by_rows = fused_step_rows(cfg, *block, 5, slabs=(zt, zb, pt, pb))
    for g, w, r in zip(got, want, by_rows):
        assert _rel(g, w) <= 1e-6
        assert torch.equal(g, r)


@pytest.mark.parametrize("M,P,nx", [(1024, 384, 4), (2048, 2048, 4)])
def test_sharded_yspec_kernel(dev, M, P, nx):
    """K15's sharded form on two ranks' row blocks against its plain
    version."""
    cfg = preset("turbulence-2048").replace(M=M, P=P)
    z, p, f1, f2 = _fields(M, P, dev)
    p_ys = y_dft_plain(p, False)
    m = M // nx
    n = fused_step_yspec_sharded.launches
    for k in (0, nx - 1):
        rows = slice(k * m, (k + 1) * m)
        (zt, zb), (pt, pb) = _slabs((z, p_ys), k * m, m, 2)
        block = [a[:, rows].contiguous() for a in (z, p_ys, f1, f2)]
        got = fused_step_yspec_sharded(cfg, *block, 5, zt, zb, pt, pb)
        want = fused_step_yspec_sharded_plain(cfg, *block, 5, zt, zb, pt, pb)
        for part, g, w in zip(("zeta_new", "carry", "zeta_ys"), got, want):
            assert _rel(g, w) <= (1e-5 if part == "zeta_ys" else 1e-6), part
    torch.cuda.synchronize()
    assert fused_step_yspec_sharded.launches == n + 2


# K16's persistent kernel at the mono slice's 2048^2, the mixed 1536^2, the
# smallest power-of-two square it takes (1024), the largest square of the
# mono gate (2176 = 128 * 17, mixed), and rectangles whose x stage takes
# K3's (4, 4) mixed layout (2432 x 256) and its smallest mixed extent (896).
@pytest.mark.parametrize("M,P", [(1024, 1024), (1536, 1536), (2048, 2048),
                                 (2176, 2176), (2432, 256), (896, 256)])
def test_mono_rows_bitwise_separate_route(dev, M, P):
    """K16's persistent kernel (csrc coop_mono_rows_kernel) gives K2 -> K3
    -> K2^-1's bits, each launch counted in rows_launches; cut after one or
    two stages it gives K2's and K3's."""
    consts = _consts(M, P)
    x = _fields(M, P, dev, seed=7)[1]
    n = (mono_invert.launches, mono_invert.rows_launches)
    got = mono_invert(x, consts)
    ys = y_dft(x, False)
    xs = pair_x_symbols(ys, consts)
    want = y_dft(xs, True)
    torch.cuda.synchronize()
    assert (mono_invert.launches, mono_invert.rows_launches) == (n[0] + 1,
                                                                 n[1] + 1)
    assert torch.equal(got, want)
    assert torch.equal(mono_invert_rows(x, consts, stages=1), ys)
    assert torch.equal(mono_invert_rows(x, consts, stages=2), xs)


# K15's sharded form's persistent kernel on the one-rank mesh chain's block
# (2, 2048, 2048), rank 0 of the (4, 1) chain's (2, 512, 2048) and a mixed
# P = 384 block with tpu_qg's 8-row slabs.
@pytest.mark.parametrize("M,P,nx,H", [(2048, 2048, 1, 2), (2048, 2048, 4, 2),
                                      (1024, 384, 4, 8)])
@pytest.mark.parametrize("scheme,tau0,step", ONE_LAUNCH_STEPS)
def test_sharded_yspec_rows_bitwise_separate_route(dev, M, P, nx, H, scheme,
                                                   tau0, step):
    """K15's sharded form by its persistent kernel (csrc
    coop_yspec_sharded_rows_kernel) gives the bits of K2^-1 on the block and
    on each psi slab, K12 with the natural slabs, then K2 on zeta_new; each
    launch counted in rows_launches."""
    cfg = preset("turbulence-2048").replace(M=M, P=P, time_scheme=scheme,
                                            wind_tau0=tau0)
    z, p, f1, f2 = _fields(M, P, dev)
    p_ys = y_dft_plain(p, False)
    m = M // nx
    (zt, zb), (pt, pb) = _slabs((z, p_ys), 0, m, H)
    block = [a[:, :m].contiguous() for a in (z, p_ys, f1, f2)]
    n = (fused_step_yspec_sharded.launches,
         fused_step_yspec_sharded.rows_launches)
    got = fused_step_yspec_sharded(cfg, *block, step, zt, zb, pt, pb)
    zn, carry = fused_step_sharded(cfg, block[0], y_dft(block[1], True),
                                   *block[2:], step, zt, zb, y_dft(pt, True),
                                   y_dft(pb, True))
    want = (zn, carry, y_dft(zn, False))
    torch.cuda.synchronize()
    assert (fused_step_yspec_sharded.launches,
            fused_step_yspec_sharded.rows_launches) == (n[0] + 1, n[1] + 1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_mono_and_sharded_rows_routing(dev):
    """The first forms keep what the persistent kernels do not take: K16
    at 256 x 8192 (M < 256 G) and 256 x 384 and on a misaligned view of
    its field, K15's sharded form with a misaligned slab; there
    rows_launches stays put and each agrees with its plain version."""
    for M, P in ((256, 8192), (256, 384), (1024, 1024)):
        x = _fields(M, P, dev, seed=8)[1]
        if M == 1024:
            whole = torch.empty(x.numel() + 1, device=dev)
            x = whole[1:].view_as(x).copy_(x)
        consts = _consts(M, P)
        n = (mono_invert.launches, mono_invert.rows_launches)
        got = mono_invert(x, consts)
        torch.cuda.synchronize()
        assert (mono_invert.launches, mono_invert.rows_launches) == (n[0] + 1,
                                                                     n[1])
        assert _rel(got, mono_invert_plain(x, consts)) <= 1e-4
    cfg = preset("turbulence-2048").replace(M=1024, P=256)
    z, p, f1, f2 = _fields(1024, 256, dev)
    p_ys = y_dft_plain(p, False)
    (zt, zb), (pt, pb) = _slabs((z, p_ys), 256, 256, 2)
    block = [a[:, 256:512].contiguous() for a in (z, p_ys, f1, f2)]
    shifted = torch.empty(pt.numel() + 1, device=dev)[1:].view_as(pt)
    shifted.copy_(pt)
    n = (fused_step_yspec_sharded.launches,
         fused_step_yspec_sharded.rows_launches)
    got = fused_step_yspec_sharded(cfg, *block, 5, zt, zb, shifted, pb)
    want = fused_step_yspec_sharded_plain(cfg, *block, 5, zt, zb, pt, pb)
    torch.cuda.synchronize()
    assert (fused_step_yspec_sharded.launches,
            fused_step_yspec_sharded.rows_launches) == (n[0] + 1, n[1])
    for part, g, w in zip(("zeta_new", "carry", "zeta_ys"), got, want):
        assert _rel(g, w) <= (1e-5 if part == "zeta_ys" else 1e-6), part


def _spectrum(M, P, dev, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (2, M, P)), dtype=torch.float32, device=dev)


@pytest.mark.parametrize("M,P,nx", [(256, 512, 2), (384, 1024, 4),
                                    (8192, 1024, 2)])
def test_offset_x_stage_kernel(dev, M, P, nx):
    """K13 on every rank's column block and its companion."""
    consts = _consts(M, P)
    Zy = _spectrum(M, P, dev)
    Zm = mirror_companion(Zy)
    w = P // nx
    n = x_fwd_symbols_offset.launches
    for k in range(nx):
        cols = slice(k * w, (k + 1) * w)
        a, b = Zy[..., cols].contiguous(), Zm[..., cols].contiguous()
        off = k * w // 128
        assert _rel(x_fwd_symbols_offset(a, b, consts, off),
                    x_fwd_symbols_offset_plain(a, b, consts, off)) <= 1e-4
    torch.cuda.synchronize()
    assert x_fwd_symbols_offset.launches == n + nx


@pytest.mark.parametrize("M,P,nx", [(256, 1024, 4), (384, 2048, 2)])
def test_paired_x_stage_kernel(dev, M, P, nx):
    """K14 on every rank's block in mirror-pair order (the self-mirror
    group on rank 0)."""
    from tpu_qg_torch.parallel.paired import strip_pair_order
    consts = _consts(M, P)
    order = strip_pair_order(P // 128)
    X = _spectrum(M, P, dev, 1).unflatten(-1, (P // 128, 128))[..., order, :] \
        .flatten(-2)
    w, s = P // nx, P // nx // 128
    n = paired_x_symbols.launches
    for k in range(nx):
        blk = X[..., k * w:(k + 1) * w].contiguous()
        idx = order[k * s:(k + 1) * s]
        assert _rel(paired_x_symbols(blk, idx, consts),
                    paired_x_symbols_plain(blk, idx, consts)) <= 1e-4
    torch.cuda.synchronize()
    assert paired_x_symbols.launches == n + nx


@pytest.mark.parametrize("M,P", [(256, 512), (384, 256), (4096, 4096)])
def test_stream_pair_kernel(dev, M, P):
    """K7 against its plain version and K3's plain version (the same
    function), and K2, K7, K2^-1 through the inverter's pair_stream."""
    consts = _consts(M, P)
    Zy = _spectrum(M, P, dev, 2)
    n = stream_pair_symbols.launches
    got = stream_pair_symbols(Zy, consts)
    assert _rel(got, stream_pair_symbols_plain(Zy, consts)) <= 1e-4
    assert _rel(got, pair_x_symbols_plain(Zy, consts)) <= 1e-4
    cfg = preset("turbulence-2048").replace(M=M, P=P, ic_type="vortex")
    inv = PackedModalInverterKernels(M, P, cfg.dx, cfg.S_eig,
                                     cfg.P_inv_matrix(),
                                     cfg.back_projection_matrix())
    zeta = init_state(cfg, dev).zeta
    want = inv(zeta)
    inv.pair_stream = True
    assert _rel(inv(zeta), want) <= 1e-5
    torch.cuda.synchronize()
    assert stream_pair_symbols.launches == n + 2


def _column_blocks(kind, M, P, nx, dev):
    """Every rank's (block, mirror operand, table key, plain result) of K13
    ("offset": a column block and its companion) or K14 ("paired": strips
    in mirror-pair order) on a random (2, M, P) y-spectrum over nx ranks."""
    from tpu_qg_torch.parallel.paired import strip_pair_order
    consts = _consts(M, P)
    Zy = _spectrum(M, P, dev, M + P + nx)
    w, s = P // nx, P // nx // 128
    if kind == "paired":
        order = strip_pair_order(P // 128)
        Zy = Zy.unflatten(-1, (P // 128, 128))[..., order, :].flatten(-2)
    Zm = mirror_companion(Zy)
    out = []
    for k in range(nx):
        cols = slice(k * w, (k + 1) * w)
        a = Zy[..., cols].contiguous()
        if kind == "offset":
            b = Zm[..., cols].contiguous()
            key = (w, k * s)
            want = x_fwd_symbols_offset_plain(a, b, consts, k * s)
        else:
            b, idx = a, order[k * s:(k + 1) * s]
            key = (tuple(int(i) for i in idx), P // 128)
            want = paired_x_symbols_plain(a, idx, consts)
        out.append((a, b, key, want))
    return consts, out


# K13's and K14's cluster kernel on every rank: the path blocks (2048, 512)
# and (8192, 2048), and (1024, 256); K13 on (1024, 384) (P = 1536: an odd
# strip count a rank), K14 on (1024, 768) (three pair groups a rank);
# every layout on each.
@pytest.mark.parametrize("kind,M,P,nx", [
    (kind, M, P, 4) for kind in ("offset", "paired")
    for M, P in ((2048, 2048), (8192, 8192), (1024, 1024))] + [
    ("offset", 1024, 1536, 4), ("paired", 1024, 1536, 2)])
def test_pair_cols_cluster_kernel(dev, kind, M, P, nx):
    consts, blocks = _column_blocks(kind, M, P, nx, dev)
    wrapper = x_fwd_symbols_offset if kind == "offset" else paired_x_symbols
    n = (wrapper.launches, wrapper.cluster_launches)
    for a, b, key, want in blocks:
        got = (x_fwd_symbols_offset(a, b, consts, key[1]) if kind == "offset"
               else paired_x_symbols(a, key[0], consts))
        assert _rel(got, want) <= 1e-4
        for layout in ((G, Cw) for G in dft_kernels.PAIR_X_CLUSTER_SIZES
                       for Cw in dft_kernels.PAIR_X_CLUSTER_WIDTHS):
            if (pair_cols_cluster_takes(M, a.shape[2], layout) and
                    dft_kernels.pair_cols_cluster_occupancy(
                        M, layout, kind == "offset", 0)):
                assert _rel(pair_cols_cluster(a, b, kind, key, consts,
                                              layout), want) <= 1e-4
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.cluster_launches) == (
        n[0] + nx, n[1] + nx)


# The block kernel's mixed instance on every rank: the four-rank slices'
# blocks, K13 on (3072, 768) and K14 on (1536, 512), and both at 2432 x
# 2048 (N2 = 19, a prime pass); every layout on each, the mixed count
# rising with the cluster count.
@pytest.mark.parametrize("kind,M,P,nx", [
    ("offset", 3072, 3072, 4), ("paired", 1536, 2048, 4),
    ("offset", 2432, 2048, 4), ("paired", 2432, 2048, 4)])
def test_pair_cols_cluster_mixed_kernel(dev, kind, M, P, nx):
    consts, blocks = _column_blocks(kind, M, P, nx, dev)
    wrapper = x_fwd_symbols_offset if kind == "offset" else paired_x_symbols
    n = (wrapper.launches, wrapper.cluster_launches, wrapper.mixed_launches)
    for a, b, key, want in blocks:
        got = (x_fwd_symbols_offset(a, b, consts, key[1]) if kind == "offset"
               else paired_x_symbols(a, key[0], consts))
        assert _rel(got, want) <= 1e-4
        for layout in ((G, Cw) for G in dft_kernels.PAIR_X_CLUSTER_SIZES
                       for Cw in dft_kernels.PAIR_X_CLUSTER_WIDTHS):
            if (pair_cols_cluster_takes(M, a.shape[2], layout) and
                    dft_kernels.pair_cols_cluster_occupancy(
                        M, layout, kind == "offset", 0)):
                assert _rel(pair_cols_cluster(a, b, kind, key, consts,
                                              layout), want) <= 1e-4
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.cluster_launches,
            wrapper.mixed_launches) == (n[0] + nx, n[1] + nx, n[2] + nx)


# K7 at a mixed extent launches K3's mixed cluster kernel, counted by
# stream_pair_symbols alone.
@pytest.mark.parametrize("M,P", [(3072, 3072), (1536, 1536), (2432, 2048)])
def test_stream_pair_takes_k3s_mixed_cluster_kernel(dev, M, P):
    consts = _consts(M, P)
    Zy = _spectrum(M, P, dev, 4)
    k3 = (pair_x_symbols.launches, pair_x_symbols.mixed_launches)
    n = (stream_pair_symbols.launches, stream_pair_symbols.cluster_launches,
         stream_pair_symbols.mixed_launches)
    assert _rel(stream_pair_symbols(Zy, consts),
                stream_pair_symbols_plain(Zy, consts)) <= 1e-4
    torch.cuda.synchronize()
    assert (stream_pair_symbols.launches,
            stream_pair_symbols.cluster_launches,
            stream_pair_symbols.mixed_launches) == (n[0] + 1, n[1] + 1,
                                                    n[2] + 1)
    assert (pair_x_symbols.launches, pair_x_symbols.mixed_launches) == k3


# pair_cols_kernel keeps K13, K14 and K7 at the extents no cluster kernel
# takes (768 = 128 * 6 and 384: U < 4) and M < 256 G (512); on a power of
# two it computes the same.
@pytest.mark.parametrize("M,P", [(768, 1024), (384, 1024), (512, 1024),
                                 (2048, 1024)])
def test_pair_cols_kernel_keeps_the_other_extents(dev, M, P):
    routed = not pair_cols_cluster_takes(M, P // 4)
    assert routed == (not stream_pair_cluster_takes(M))
    counters = (x_fwd_symbols_offset, paired_x_symbols, stream_pair_symbols)
    n = [f.cluster_launches for f in counters]
    for kind in ("offset", "paired"):
        consts, blocks = _column_blocks(kind, M, P, 4, dev)
        for a, b, key, want in blocks[:2]:
            if routed:
                got = (x_fwd_symbols_offset(a, b, consts, key[1])
                       if kind == "offset"
                       else paired_x_symbols(a, key[0], consts))
                assert _rel(got, want) <= 1e-4
            assert _rel(pair_cols_whole_columns(a, b, kind, key, consts),
                        want) <= 1e-4
    Zy = _spectrum(M, P, dev, 5)
    want = stream_pair_symbols_plain(Zy, consts)
    if routed:
        assert _rel(stream_pair_symbols(Zy, consts), want) <= 1e-4
    assert _rel(pair_cols_whole_columns(Zy, Zy, "self", (P,), consts),
                want) <= 1e-4
    torch.cuda.synchronize()
    assert [f.cluster_launches for f in counters] == n


# K7 computes K3's function: on power-of-two extents it launches K3's
# cluster kernel, counted by stream_pair_symbols alone.
@pytest.mark.parametrize("M,P", [(1024, 1024), (4096, 4096), (2048, 384)])
def test_stream_pair_takes_k3s_cluster_kernel(dev, M, P):
    consts = _consts(M, P)
    Zy = _spectrum(M, P, dev, 3)
    k3 = (pair_x_symbols.launches, pair_x_symbols.cluster_launches)
    n = (stream_pair_symbols.launches, stream_pair_symbols.cluster_launches)
    assert _rel(stream_pair_symbols(Zy, consts),
                stream_pair_symbols_plain(Zy, consts)) <= 1e-4
    torch.cuda.synchronize()
    assert (stream_pair_symbols.launches,
            stream_pair_symbols.cluster_launches) == (n[0] + 1, n[1] + 1)
    assert (pair_x_symbols.launches, pair_x_symbols.cluster_launches) == k3


def test_pair_cols_cluster_refuses_what_it_does_not_take(dev):
    consts = _consts(1024, 1024)
    x = torch.zeros((2, 1024, 256), device=dev)
    with pytest.raises(ValueError):                 # N2 = 8 < 2 G
        pair_cols_cluster(x, x, "offset", (256, 0), consts, (8, 8))
    with pytest.raises(ValueError):                 # past the y extent
        pair_cols_cluster(x, x, "offset", (256, 7), consts)
    with pytest.raises(ValueError):                 # a ragged width
        y = torch.zeros((2, 1024, 200), device=dev)
        pair_cols_cluster(y, y, "offset", (200, 0), consts)
    with pytest.raises(ValueError):                 # K14 reads mirrors from X
        pair_cols_cluster(x, x.clone(), "paired", ((0, 4), 8), consts)
    with pytest.raises(ValueError):                 # 768: U = 3 < 4
        z = torch.zeros((2, 768, 256), device=dev)
        pair_cols_cluster(z, z, "offset", (256, 0), _consts(768, 1024))
    with pytest.raises(TypeError):
        pair_cols_cluster(x.double(), x.double(), "offset", (256, 0), consts)


LAB_VARIANTS = ("base", "legacy", "aligned", "norot", "noslice", "nojac")


# K18 at 1e-6 of max|plain|; norot's carry (its tendency) is zero apart from
# the wind, so it is held against base's carry scale instead. base, legacy
# and aligned run K1's code: bitwise K1 for two layers.
@pytest.mark.parametrize("L,M,P", [(2, 2048, 2048), (1, 256, 256)])
@pytest.mark.parametrize("scheme,tau0,step", [
    ("euler_ab3", 0.0, 0), ("euler_ab3", 0.0, 5), ("leapfrog_ra", 0.1, 3)])
def test_lab_kernel(dev, L, M, P, scheme, tau0, step):
    cfg = preset("turbulence-2048").replace(M=M, P=P, n_layers=L,
                                            time_scheme=scheme,
                                            wind_tau0=tau0)
    z, p, f1, f2 = (t[:L].contiguous() for t in _fields(M, P, dev))
    n, n_rows = lab_step.launches, lab_step.rows_launches
    scale = float(lab_step_plain(cfg, z, p, f1, f2, step)[1].abs().max())
    k1 = fused_step(cfg, z, p, f1, f2, step) if L == 2 else None
    for variant in LAB_VARIANTS:
        got = lab_step(cfg, z, p, f1, f2, step, variant)
        want = lab_step_plain(cfg, z, p, f1, f2, step, variant)
        for part, g, w in zip(("zeta_new", "carry"), got, want):
            floor = scale if (variant, part) == ("norot", "carry") else 0.0
            err = float((g - w).abs().max())
            assert err <= 1e-6 * max(float(w.abs().max()), floor), (variant,
                                                                    part)
        if k1 is not None and variant in ("base", "legacy", "aligned"):
            assert all(torch.equal(g, w) for g, w in zip(got, k1)), variant
    torch.cuda.synchronize()
    assert lab_step.launches == n + len(LAB_VARIANTS)
    assert lab_step.rows_launches == n_rows + len(LAB_VARIANTS)


# Every K18 body on the row kernel bitwise the same body on the tile
# kernel, one and two layers, every scheme case, on a ragged last run and
# strip (M = 200, P = 1000) and at the lab's 2048^2.
@pytest.mark.parametrize("L,M,P", [(2, 2048, 2048), (1, 2048, 2048),
                                   (2, 200, 1000), (1, 200, 1000)])
@pytest.mark.parametrize("scheme,tau0,step", [
    ("euler_ab3", 0.0, 0), ("euler_ab3", 0.0, 5), ("leapfrog_ra", 0.1, 0),
    ("leapfrog_ra", 0.1, 3)])
def test_lab_rows_bitwise_tile_kernel(dev, L, M, P, scheme, tau0, step):
    cfg = preset("turbulence-2048").replace(M=M, P=P, n_layers=L,
                                            time_scheme=scheme,
                                            wind_tau0=tau0)
    z, p, f1, f2 = (t[:L].contiguous() for t in _fields(M, P, dev))
    for body in ("base", "norot", "noslice", "nojac"):
        rows = lab_step_rows(cfg, z, p, f1, f2, step, body)
        tile = lab_step_tile(cfg, z, p, f1, f2, step, body)
        assert all(torch.equal(r, t) for r, t in zip(rows, tile)), body


def test_lab_rows_routing(dev):
    """P % 4 != 0 and a misaligned operand take K18's tile kernel: launches
    counts them, rows_launches does not."""
    cfg = preset("turbulence-2048").replace(M=256, P=258)
    z, p, f1, f2 = _fields(256, 258, dev)
    n, n_rows = lab_step.launches, lab_step.rows_launches
    got = lab_step(cfg, z, p, f1, f2, 5, "noslice")
    for g, w in zip(got, lab_step_plain(cfg, z, p, f1, f2, 5, "noslice")):
        assert _rel(g, w) <= 1e-6
    cfg = preset("turbulence-2048").replace(M=256, P=256)
    z, p, f1, f2 = _fields(256, 256, dev)
    shifted = torch.empty(2 * 256 * 256 + 1, device=dev)[1:].view(2, 256, 256)
    shifted.copy_(f1)
    got = lab_step(cfg, z, p, shifted, f2, 5, "nojac")
    torch.cuda.synchronize()
    assert (lab_step.launches, lab_step.rows_launches) == (n + 2, n_rows)
    assert all(torch.equal(g, t) for g, t in zip(
        got, lab_step_rows(cfg, z, p, f1, f2, 5, "nojac")))


def test_lab_wrapper_refuses_an_unknown_variant(dev):
    cfg = preset("turbulence-2048").replace(M=256, P=256)
    z, p, f1, f2 = _fields(256, 256, dev)
    with pytest.raises(KeyError):
        lab_step(cfg, z, p, f1, f2, 0, "nosuch")

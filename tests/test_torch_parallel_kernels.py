"""The sharded kernels' plain versions against tpu_qg's kernels in interpret
mode, at rank shapes, called directly with no process group: K12 (the
sharded step), K15's sharded form, K13 (the offset x-stage, both of
tpu_qg's forms), K14 (the paired x-stage) and K7 (K13's self-mirror
instance). The same seeded numpy inputs go to both; each result must agree
with tpu_qg's to 1e-5 of its largest value (float32: the plain versions
run torch.fft where tpu_qg's kernels run a matmul DFT in float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops.pallas_fft import PlanarFFT2
from tpu_qg.ops.pallas_tendency import (fused_step_streamed_sharded,
                                        fused_step_streamed_yspec_sharded)
from tpu_qg.parallel.paired import PairedDistributedInverter
from tpu_qg.parallel.paired import strip_pair_order as j_strip_pair_order
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.ops.dft_kernels import (mirror_companion,
                                          paired_x_symbols_plain,
                                          stream_pair_symbols_plain,
                                          x_fwd_symbols_offset_plain,
                                          y_dft_plain)
from tpu_qg_torch.ops.step_kernel import (fused_step_sharded_plain,
                                          fused_step_yspec_sharded_plain,
                                          packed_symbol_consts)
from tpu_qg_torch.parallel.paired import strip_pair_order

TOL = 1e-5
H = 8           # tpu_qg's slab rows


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=what)


def _block_inputs(jcfg, m, seed):
    """A (2, m, P) row block of float32 (zeta, psi, f1, f2) of a grid-noise
    psi, and its 8-row slabs, from the global (2, M, P) fields: rank 1 of
    M/m."""
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((2, jcfg.M, jcfg.P)) * 1e-4
    s = tpu_qg.init_state(jcfg, psi_init=psi.astype(np.float32))
    zeta = np.asarray(s.zeta, np.float32)
    scale = np.abs(zeta).max() / jcfg.dt * 1e-3
    f1, f2 = (scale * rng.standard_normal(zeta.shape) for _ in range(2))
    fields = [zeta, np.asarray(s.psi, np.float32), f1.astype(np.float32),
              f2.astype(np.float32)]
    r0 = m                                   # rank 1's rows [m, 2m)
    block = [np.array(a[:, r0:r0 + m]) for a in fields]
    slabs = [(np.array(a[:, r0 - H:r0]), np.array(a[:, r0 + m:r0 + m + H]))
             for a in fields[:2]]
    return block, slabs


@pytest.mark.parametrize("scheme,tau0,step", [
    ("euler_ab3", 0.0, 0), ("euler_ab3", 0.0, 5), ("leapfrog_ra", 0.1, 3)])
def test_sharded_step_plain_matches_pallas(scheme, tau0, step):
    """K12 on a (2, 128, 256) block with 8-row slabs (1e-5)."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(
        M=512, P=256, time_scheme=scheme, wind_tau0=tau0)
    (z, p, f1, f2), ((zt, zb), (pt, pb)) = _block_inputs(jcfg, 128, 0)
    want = fused_step_streamed_sharded(
        jcfg, *(jnp.asarray(a) for a in (z, p, f1, f2)), jnp.int32(step),
        *(jnp.asarray(a) for a in (zt, zb, pt, pb)), True)
    got = fused_step_sharded_plain(
        config_from_jax(jcfg), *(torch.from_numpy(a) for a in (z, p, f1, f2)),
        step, *(torch.from_numpy(a) for a in (zt, zb, pt, pb)))
    _close(got[0], want[0], "zeta_new")
    _close(got[1], want[1], "carry")


@pytest.mark.parametrize("scheme,step", [("euler_ab3", 5),
                                         ("leapfrog_ra", 3)])
def test_sharded_yspec_step_plain_matches_pallas(scheme, step):
    """K15's sharded form on a (2, 128, 256) block, psi and its slabs as
    rows of its permuted y-spectrum (1e-5)."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(
        M=512, P=256, time_scheme=scheme, wind_tau0=0.05)
    (z, p, f1, f2), ((zt, zb), (pt, pb)) = _block_inputs(jcfg, 128, 1)

    def ys(a):
        return y_dft_plain(torch.from_numpy(a), False).numpy()

    p_ys, pt_ys, pb_ys = ys(p), ys(pt), ys(pb)
    want = fused_step_streamed_yspec_sharded(
        jcfg, *(jnp.asarray(a) for a in (z, p_ys, f1, f2)), jnp.int32(step),
        *(jnp.asarray(a) for a in (zt, zb, pt_ys, pb_ys)), "highest", True)
    got = fused_step_yspec_sharded_plain(
        config_from_jax(jcfg), *(torch.from_numpy(a)
                                 for a in (z, p_ys, f1, f2)), step,
        *(torch.from_numpy(a) for a in (zt, zb, pt_ys, pb_ys)))
    for part, g, w in zip(("zeta_new", "carry", "zeta_ys"), got, want):
        _close(g, w, part)


def _consts(M, P):
    return packed_symbol_consts(config_from_jax(
        tpu_qg.preset("turbulence-2048").replace(M=M, P=P)))


def _spectrum(M, P, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, M, P)).astype(np.float32))


@pytest.mark.parametrize("stream_x", [False, True])
def test_offset_x_stage_plain_matches_pallas(stream_x):
    """K13 at (256, 512) with nx = 2: each rank's (2, 256, 256) column block
    and its companion, at strip offsets 0 and 2, against tpu_qg's BlockSpec
    and streaming forms (1e-5)."""
    M, P = 256, 512
    consts = _consts(M, P)
    Zy = _spectrum(M, P, 2)
    Zm = mirror_companion(Zy)
    pf = PlanarFFT2(M, P, interpret=True, stream_x=stream_x)
    for off in (0, 2):
        cols = slice(128 * off, 128 * off + 256)
        a, b = Zy[..., cols].contiguous(), Zm[..., cols].contiguous()
        want = pf._call_x_fwd_symbols_offset(jnp.asarray(a.numpy()),
                                             jnp.asarray(b.numpy()), consts,
                                             off)
        _close(x_fwd_symbols_offset_plain(a, b, consts, off), want,
               f"offset {off}")


@pytest.mark.parametrize("stream_x", [False, True])
def test_paired_x_stage_plain_matches_pallas(stream_x):
    """K14 on each rank's (2, 256, 256) block of (256, 1024) in mirror-pair
    order, nx = 4, group indices sliced from strip_pair_order(8), the
    self-mirror group on rank 0 (1e-5)."""
    M, P, nx = 256, 1024, 4
    jcfg = tpu_qg.preset("turbulence-2048").replace(M=M, P=P)
    consts = _consts(M, P)
    order = strip_pair_order(P // 128)
    np.testing.assert_array_equal(order, j_strip_pair_order(P // 128))
    Zp = _spectrum(M, P, 3).unflatten(-1, (P // 128, 128))[..., order, :] \
        .flatten(-2)
    inv = PairedDistributedInverter(M, P, jcfg.dx, jcfg.S_eig,
                                    jcfg.P_inv_matrix(),
                                    jcfg.back_projection_matrix(),
                                    interpret=True, stream_x=stream_x)
    w = P // nx
    for k in range(nx):
        X = Zp[..., k * w:(k + 1) * w].contiguous()
        idx = order[k * 2:(k + 1) * 2]
        want = inv._call_paired_kernel(jnp.asarray(X.numpy()),
                                       jnp.asarray(idx, jnp.int32))
        _close(paired_x_symbols_plain(X, idx, consts), want, f"rank {k}")


@pytest.mark.parametrize("M,P", [(256, 512), (384, 256)])
def test_stream_pair_plain_matches_pallas(M, P):
    """K7 (K13's self-mirror instance on the whole field) against tpu_qg's
    stream_pair_symbols, which tests/test_pallas_fft.py forces at these
    shapes (1e-5)."""
    consts = _consts(M, P)
    Zy = _spectrum(M, P, 4)
    want = PlanarFFT2(M, P, interpret=True).stream_pair_symbols(
        jnp.asarray(Zy.numpy()), consts)
    _close(stream_pair_symbols_plain(Zy, consts), want)

"""The port's multigrid (tpu_qg_torch.ops.multigrid) against tpu_qg's on the
CPU, on the same numpy inputs.

Tolerances, relative to max|reference|: the level ops, MultigridSolver and
MultigridModalInverter 1e-12 in float64 (same arithmetic and grouping; the
coarse solve's FFTs and the gauge means sum in another order), and 1e-10
against the port's spectral solvers, as tests/test_multigrid.py holds the
converged V-cycle. The kernel-routed solver in float32 1e-6 against tpu_qg's
in interpret mode: the plain K10/K11 round w + (omega/diag) r in two steps
where XLA on the CPU fuses it (tests/test_torch_mg_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.models import core as jcore
from tpu_qg.ops import multigrid as jmg
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.models import core
from tpu_qg_torch.ops import mg_kernels, multigrid
from tpu_qg_torch.ops.spectral import BatchedModalSolver
from tpu_qg_torch.ops.stencils import roll_shift

@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jcfg(M, P, dtype="float64"):
    """tests/test_multigrid.py's configuration."""
    return tpu_qg.preset("bench-ref").replace(M=M, P=P, dtype=dtype)


def _field(shape, seed, scale, dtype=np.float64):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(dtype)


def _close(got, want, rel, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


ALPHAS = (0.0, _jcfg(128, 256).S_eig)
DX = _jcfg(128, 256).dx


# --- Level ops ----------------------------------------------------------------

def _level_cases():
    """(name, port call, tpu_qg call) on (2, 128, 256) float64 inputs."""
    u = _field((2, 128, 256), 0, 1e-2)
    f = _field((2, 128, 256), 1, 1e-5)
    padded = _field((2, 130, 258), 2, 1e-2)     # a block with its 1-halo
    U, F = torch.from_numpy(u), torch.from_numpy(f)
    ju, jf = jnp.asarray(u), jnp.asarray(f)
    at = torch.tensor(ALPHAS, dtype=torch.float64).reshape(-1, 1, 1)
    aj = jnp.asarray(ALPHAS).reshape(-1, 1, 1)
    # A shift other than roll_shift itself takes the reference's 9-point
    # restriction and 4-point prolongation.
    other_t = lambda x, di, dj: roll_shift(x, di, dj)  # noqa: E731
    other_j = lambda x, di, dj: jmg.roll_shift(x, di, dj)  # noqa: E731
    return {
        "apply_helmholtz": (lambda: multigrid.apply_helmholtz(U, DX, at),
                            lambda: jmg.apply_helmholtz(ju, DX, aj)),
        "jacobi_smooth": (lambda: multigrid.jacobi_smooth(U, F, DX, at),
                          lambda: jmg.jacobi_smooth(ju, jf, DX, aj)),
        "restrict_full_weighting": (
            lambda: multigrid.restrict_full_weighting(U),
            lambda: jmg.restrict_full_weighting(ju)),
        "prolong_bilinear": (lambda: multigrid.prolong_bilinear(U),
                             lambda: jmg.prolong_bilinear(ju)),
        "restrict_full_weighting_padded": (
            lambda: multigrid.restrict_full_weighting_padded(
                torch.from_numpy(padded)),
            lambda: jmg.restrict_full_weighting_padded(jnp.asarray(padded))),
        "restrict_9_point": (
            lambda: multigrid.restrict_full_weighting(U, other_t),
            lambda: jmg.restrict_full_weighting(ju, other_j)),
        "prolong_4_point": (lambda: multigrid.prolong_bilinear(U, other_t),
                            lambda: jmg.prolong_bilinear(ju, other_j)),
        "coarse_spectral_solve": (
            lambda: multigrid._coarse_spectral_solve(F, 128, 256, DX, ALPHAS),
            lambda: jmg._coarse_spectral_solve(jf, 128, 256, DX, ALPHAS)),
    }


@pytest.mark.parametrize("name", list(_level_cases()))
def test_level_op_matches_tpu_qg_float64(name):
    port, ref = _level_cases()[name]
    _close(port(), ref(), 1e-12, name)


@pytest.mark.parametrize("name", ["restrict_full_weighting",
                                  "restrict_full_weighting_padded",
                                  "prolong_bilinear", "restrict_9_point",
                                  "prolong_4_point"])
def test_transfer_ops_are_exact(name):
    """Slices and interleaves give the reference's selector-matmul values
    bit for bit."""
    port, ref = _level_cases()[name]
    np.testing.assert_array_equal(port().numpy(), np.asarray(ref()))


# --- MultigridSolver ----------------------------------------------------------

@pytest.mark.parametrize("M,P", [(128, 128), (128, 256)])
def test_levels_match_tpu_qg(M, P):
    for cutoff in (8, 32):
        got = multigrid.MultigridSolver(M, P, 1.0, ALPHAS,
                                        coarse_cutoff=cutoff)
        want = jmg.MultigridSolver(M, P, 1.0, ALPHAS, coarse_cutoff=cutoff)
        assert got.levels == want.levels and got.coarse == want.coarse


@pytest.mark.parametrize("M,P", [(128, 128), (128, 256)])
def test_cold_solve_matches_tpu_qg_and_spectral(M, P):
    cfg = _jcfg(M, P)
    f = _field((2, M, P), 2, 1e-5)
    got = multigrid.MultigridSolver(M, P, cfg.dx, ALPHAS, n_cycles=14)(
        torch.from_numpy(f))
    want = jmg.MultigridSolver(M, P, cfg.dx, ALPHAS, n_cycles=14)(
        jnp.asarray(f))
    _close(got, want, 1e-12, "vs tpu_qg")
    spectral = BatchedModalSolver(M, P, cfg.dx, ALPHAS)(torch.from_numpy(f))
    _close(got, spectral, 1e-10, "vs BatchedModalSolver")
    # Zero-mean gauge on the singular (Poisson) mode.
    assert abs(float(got[0].mean())) <= 1e-12 * float(got[0].abs().max())


@pytest.mark.parametrize("M,P", [(128, 128), (128, 256)])
def test_warm_solve_matches_tpu_qg(M, P):
    """Warm start from the solution perturbed by 1%, a timestep's change:
    12 cycles at ~0.15 contraction bring the 1e-2 error below 1e-10."""
    cfg = _jcfg(M, P)
    f = _field((2, M, P), 3, 1e-5)
    exact = BatchedModalSolver(M, P, cfg.dx, ALPHAS)(torch.from_numpy(f))
    x0 = (exact * 1.01).numpy()
    got = multigrid.MultigridSolver(M, P, cfg.dx, ALPHAS, n_cycles=12)(
        torch.from_numpy(f), x0=torch.from_numpy(x0))
    want = jmg.MultigridSolver(M, P, cfg.dx, ALPHAS, n_cycles=12)(
        jnp.asarray(f), x0=jnp.asarray(x0))
    _close(got, want, 1e-12, "vs tpu_qg")
    _close(got, exact, 1e-10, "vs BatchedModalSolver")


def test_residual_norm_matches_tpu_qg():
    cfg = _jcfg(128, 256)
    u, f = _field((2, 128, 256), 4, 1e-2), _field((2, 128, 256), 5, 1e-5)
    got = multigrid.MultigridSolver(128, 256, cfg.dx, ALPHAS).residual_norm(
        torch.from_numpy(u), torch.from_numpy(f))
    want = jmg.MultigridSolver(128, 256, cfg.dx, ALPHAS).residual_norm(
        jnp.asarray(u), jnp.asarray(f))
    _close(got, want, 1e-12)


def test_vcycle_contraction_factor():
    """Per-cycle residual contraction at the damped-Jacobi textbook level,
    as tests/test_multigrid.py asserts for tpu_qg (~0.15)."""
    cfg = _jcfg(256, 256)
    f = torch.from_numpy(_field((2, 256, 256), 0, 1e-5))
    f = f - f.mean(dim=(-2, -1), keepdim=True)
    mg = multigrid.MultigridSolver(256, 256, cfg.dx, ALPHAS, n_cycles=1)
    u = torch.zeros_like(f)
    norms = [mg.residual_norm(u, f)]
    for _ in range(5):
        u = mg._vcycle(0, u, f)
        norms.append(mg.residual_norm(u, f))
    rates = [float((norms[i + 1] / norms[i]).max()) for i in range(1, 5)]
    assert max(rates) < 0.17, rates


def test_192_solve_takes_extents_off_128():
    """192^2 (levels 192, 96, 48): the reference's selector matmuls need
    multiples of 128 and fail there; the port's slices do not."""
    cfg = _jcfg(192, 192)
    f = torch.from_numpy(_field((2, 192, 192), 6, 1e-5))
    got = multigrid.MultigridSolver(192, 192, cfg.dx, ALPHAS, n_cycles=14)(f)
    want = BatchedModalSolver(192, 192, cfg.dx, ALPHAS)(f)
    _close(got, want, 1e-10)


# --- Kernel levels -------------------------------------------------------------

ROUTE_SHAPES = [(512, 512), (1024, 512), (512, 1024), (2048, 2048),
                (768, 768), (1024, 384), (8192, 8192), (256, 256),
                (4096, 1536)]


@pytest.mark.parametrize("M,P", ROUTE_SHAPES)
@pytest.mark.parametrize("nu1,nu2", [(2, 2), (6, 7), (7, 2)])
def test_kernel_levels_match_tpu_qg(M, P, nu1, nu2):
    """The port's own gate on tpu_qg's levels: under "auto" and "on" every
    level of extent >= 512 takes the kernels, a superset of tpu_qg's kernel
    levels (its gate also caps them at the top 3 and takes fewer sweep
    counts); under "off" none."""
    ref = jmg.MultigridSolver(M, P, 1.0, ALPHAS, nu1=nu1, nu2=nu2,
                              use_pallas="on", interpret=True)
    ref_levels = [ref._pallas_level(lvl) for lvl in range(len(ref.levels))]
    for mode in ("auto", "on"):
        mg = multigrid.MultigridSolver(M, P, 1.0, ALPHAS, nu1=nu1, nu2=nu2,
                                       use_pallas=mode)
        assert mg.levels == ref.levels and mg.coarse == ref.coarse
        got = [mg._kernel_level(lvl) for lvl in range(len(mg.levels))]
        assert got == [min(m, p) >= 512 for m, p, _ in mg.levels]
        assert all(g or not r for g, r in zip(got, ref_levels))
    off = multigrid.MultigridSolver(M, P, 1.0, ALPHAS, use_pallas="off")
    assert not any(off._kernel_level(lvl) for lvl in range(len(off.levels)))


@pytest.mark.parametrize("M,P", [(512, 512), (2048, 2048), (8192, 8192),
                                 (1024, 384)])
def test_kernel_levels_by_dtype(M, P):
    """The gate by dtype: under "auto" a float64 solve routes no level to
    K10/K11 (the kernels take float32 alone), float32 the levels of extent
    >= 512 as before; under "on" both dtypes route those levels (a float64
    CUDA solve then raises in the kernels); under "off" neither."""
    want = [min(m, p) >= 512 for m, p, _ in
            multigrid.MultigridSolver(M, P, 1.0, ALPHAS).levels]
    for mode, f32, f64 in (("auto", want, [False] * len(want)),
                           ("on", want, want),
                           ("off", [False] * len(want), [False] * len(want))):
        mg = multigrid.MultigridSolver(M, P, 1.0, ALPHAS, use_pallas=mode)
        lv = range(len(mg.levels))
        assert [mg._kernel_level(l, torch.float32) for l in lv] == f32
        assert [mg._kernel_level(l) for l in lv] == f32
        assert [mg._kernel_level(l, torch.float64) for l in lv] == f64


def test_float64_auto_solve_launches_no_kernel():
    """A float64 512^2 solve under "auto" takes the level-op chain on every
    level (no K10/K11 call, counted or plain) and stays 1e-12 from the
    reference's V-cycle."""
    cfg = _jcfg(512, 512)
    f = _field((2, 512, 512), 11, 1e-5)
    calls = []
    real = (mg_kernels.mg_smooth, mg_kernels.mg_prolong_smooth)
    try:
        mg_kernels.mg_smooth = lambda *a, **k: calls.append(1) or real[0](
            *a, **k)
        mg_kernels.mg_prolong_smooth = lambda *a, **k: calls.append(2) or \
            real[1](*a, **k)
        got = multigrid.MultigridSolver(512, 512, cfg.dx, ALPHAS,
                                        n_cycles=1)(torch.from_numpy(f))
    finally:
        mg_kernels.mg_smooth, mg_kernels.mg_prolong_smooth = real
    assert calls == [] and got.dtype == torch.float64
    want = jmg.MultigridSolver(512, 512, cfg.dx, ALPHAS, n_cycles=1)(
        jnp.asarray(f))
    _close(got, want, 1e-12)


def test_unknown_use_pallas_raises():
    with pytest.raises(ValueError, match="use_pallas"):
        multigrid.MultigridSolver(128, 128, 1.0, ALPHAS, use_pallas="yes")


def test_kernel_routed_solve_matches_tpu_qg_interpret_float32():
    """512^2, the smallest grid with a kernel level: tpu_qg's V-cycle with
    its Pallas kernels in interpret mode against the port's, whose level 0
    runs the plain K10 (restrict form) and K11 on the CPU; launch counters
    stay untouched there."""
    cfg = _jcfg(512, 512, "float32")
    f = _field((2, 512, 512), 7, 1e-5, np.float32)
    x0 = _field((2, 512, 512), 8, 1e-2, np.float32)
    counts = (mg_kernels.mg_smooth.launches,
              mg_kernels.mg_prolong_smooth.launches)
    mg = multigrid.MultigridSolver(512, 512, cfg.dx, ALPHAS, n_cycles=1)
    assert mg._kernel_level(0) and not mg._kernel_level(1)
    got = mg(torch.from_numpy(f), x0=torch.from_numpy(x0))
    want = jmg.MultigridSolver(512, 512, cfg.dx, ALPHAS, n_cycles=1,
                               use_pallas="on", interpret=True)(
        jnp.asarray(f), x0=jnp.asarray(x0))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)
    assert (mg_kernels.mg_smooth.launches,
            mg_kernels.mg_prolong_smooth.launches) == counts


# --- MultigridModalInverter -------------------------------------------------------

def _inverters(M, P, n_cycles):
    jcfg = _jcfg(M, P)
    args = (M, P, jcfg.dx, jcfg.S_eig, jcfg.P_inv_matrix(),
            jcfg.back_projection_matrix())
    return (jcfg, multigrid.MultigridModalInverter(*args, n_cycles=n_cycles),
            jmg.MultigridModalInverter(*args, n_cycles=n_cycles))


@pytest.mark.parametrize("M,P", [(128, 128), (128, 256)])
def test_modal_inverter_matches_tpu_qg_and_model(M, P):
    jcfg, inv, jinv = _inverters(M, P, 14)
    psi0 = _field((2, M, P), 9, jcfg.initial_kick * jcfg.U * jcfg.Ly)
    zeta = np.array(tpu_qg.init_state(jcfg, psi_init=psi0).zeta)
    got = inv(torch.from_numpy(zeta))
    _close(got, jinv(jnp.asarray(zeta)), 1e-12, "vs tpu_qg")
    cfg = config_from_jax(jcfg)
    model = core._invert_psi(cfg, core._build_solvers(cfg),
                             torch.from_numpy(zeta))
    _close(got, model, 1e-10, "vs the model's inversion")
    # The reference's own model inversion, for the record of the chain.
    _close(got, jcore._invert_psi(jcfg, jcore._build_solvers(jcfg),
                                  jnp.asarray(zeta)), 1e-10, "vs tpu_qg model")


@pytest.mark.parametrize("M,P", [(128, 128), (128, 256)])
def test_modal_inverter_warm_start_matches_tpu_qg(M, P):
    """psi_prev seeds through P_back^-1 (the compat_reference_P quirk makes
    it differ from P_inv)."""
    jcfg, inv, jinv = _inverters(M, P, 12)
    psi0 = _field((2, M, P), 10, jcfg.initial_kick * jcfg.U * jcfg.Ly)
    zeta = np.array(tpu_qg.init_state(jcfg, psi_init=psi0).zeta)
    cfg = config_from_jax(jcfg)
    exact = core._invert_psi(cfg, core._build_solvers(cfg),
                             torch.from_numpy(zeta))
    prev = (exact * 1.01).numpy()
    got = inv(torch.from_numpy(zeta), psi_prev=torch.from_numpy(prev))
    _close(got, jinv(jnp.asarray(zeta), psi_prev=jnp.asarray(prev)), 1e-12,
           "vs tpu_qg")
    _close(got, exact, 1e-10, "vs the model's inversion")
    assert not np.allclose(inv.P_back_inv, np.asarray(cfg.P_inv_matrix()))

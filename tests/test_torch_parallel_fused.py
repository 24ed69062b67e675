"""tpu_qg_torch.parallel's fused routes on gloo ranks of the CPU (the
kernels' plain versions) in float32: two and four ranks, the companion
(K13) and paired (K14) inverters, the 2-D mesh, leapfrog, wind, the chain,
and the packed inverter's overlap_groups = 2.

zeta and f1 are held against tpu_qg's make_halo_step_fn(fused=True) (or
make_halo_run_fn(chain=True)) on its virtual CPU mesh (interpret mode) to
1e-5 of their largest value. The whole state is held as tpu_qg's dry run
holds its own sharded routes (__graft_entry__.py:104-117, 193-194): against
tpu_qg's single-device per-mode float32 trajectory, zeta 1e-5, psi 1e-4,
the 2-D step's psi 5e-5, the chain's psi 2e-4. psi is not held against
tpu_qg's sharded route: two float32 inversions of a grid-noise state differ
by the rounding 1/lambda lifts at low k, 2e-5 to 6e-5 of max|psi| against
float64 for either package here, which straddles the 5e-5 gate.

One spawn per rank count (tests/torch_parallel_ranks.py)."""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as Pspec

from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM, MINUTES, YEAR
from tpu_qg.models.core import init_state as j_init_state
from tpu_qg.models.core import make_step_fn
from tpu_qg.ops.spectral import PackedModalInverterPallasFFT
from tpu_qg.parallel import make_mesh, shard_state
from tpu_qg.parallel.packed import DistributedPackedInverter
from tpu_qg.parallel.paired import paired_supported
from tpu_qg.parallel.stepper import make_halo_run_fn, make_halo_step_fn
from tpu_qg_torch.interop import config_from_jax

import torch_parallel_ranks as ranks

ROUTE_TOL = 1e-5          # zeta, f1 against tpu_qg's sharded route
GATES = {"zeta": 1e-5, "psi": 1e-4}
GATES_2D = {"zeta": 1e-5, "psi": 5e-5}
GATES_CHAIN = {"zeta": 1e-5, "psi": 2e-4}
STEPS = 2


def fused_cfg(**kw):
    base = dict(H_1=1.0 * KM, H_2=2.0 * KM, beta=2e-11, Lx=4000.0 * KM,
                Ly=4000.0 * KM, dt=60.0 * MINUTES, T=1.0 * YEAR, U=0.1,
                M=128, P=256, visc=100.0, r=1e-7, R_d=40.0 * KM,
                initial_kick=1e-6, dtype="float32", fft_mxu="highest")
    base.update(kw)
    return ModelConfig(**base)


def _psi0(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    amp = jcfg.initial_kick * jcfg.U * jcfg.Ly
    return (amp * rng.random((2, jcfg.M, jcfg.P))).astype(np.float32)


def _per_mode_reference(jcfg):
    """tpu_qg's single-device per-mode trajectory: STEPS steps (the dry
    run's reference)."""
    step = jax.jit(make_step_fn(jcfg, batched_fft=False))
    s = j_init_state(jcfg, psi_init=_psi0(jcfg))
    for _ in range(STEPS):
        s = step(s)
    return {f: np.asarray(getattr(s, f)) for f in ("zeta", "psi", "f1")}


def _tpu_qg_route(jcfg, shape, route):
    """tpu_qg's fused sharded route on its virtual mesh: STEPS steps."""
    nx, ny = shape
    mesh = make_mesh(shape, devices=jax.devices()[:nx * ny])
    s = shard_state(j_init_state(jcfg, psi_init=_psi0(jcfg)), mesh)
    if route == "chain":
        s = make_halo_run_fn(jcfg, mesh, fused=True, chain=True)(s, STEPS)
    else:
        step = make_halo_step_fn(jcfg, mesh, donate=False, fused=True)
        for _ in range(STEPS):
            s = step(s)
    return {f: np.asarray(getattr(s, f)) for f in ("zeta", "psi", "f1")}


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


# name: (config, mesh, route the port must take, gates)
CASES = {
    2: {"2x1 companion wind": (fused_cfg(wind_tau0=0.05), (2, 1), "fused",
                               GATES),
        "2x1 paired": (fused_cfg(P=512), (2, 1), "fused", GATES),
        "2x1 paired leapfrog": (fused_cfg(P=512, time_scheme="leapfrog_ra"),
                                (2, 1), "fused", GATES),
        "2x1 chain": (fused_cfg(wind_tau0=0.05), (2, 1), "chain",
                      GATES_CHAIN)},
    4: {"4x1 companion wind": (fused_cfg(P=512, wind_tau0=0.05), (4, 1),
                               "fused", GATES),
        "4x1 paired": (fused_cfg(P=1024), (4, 1), "fused", GATES),
        "2x2": (fused_cfg(P=512), (2, 2), "fused-2d", GATES_2D),
        "2x2 leapfrog": (fused_cfg(P=512, time_scheme="leapfrog_ra"),
                         (2, 2), "fused-2d", GATES_2D),
        "4x1 chain paired": (fused_cfg(P=1024), (4, 1), "chain",
                             GATES_CHAIN)},
}
OVERLAP_CFG = fused_cfg(P=512)
OVERLAP_ZETA = np.random.default_rng(5).standard_normal(
    (2, 128, 512)).astype(np.float32)


def _spawn(world, tmp_path):
    cases = []
    for name, (jcfg, shape, route, _) in CASES[world].items():
        opts = (dict(fused=True, chain=True) if route == "chain"
                else dict(fused=True))
        cases.append(dict(name=name, kind="run", cfg=config_from_jax(jcfg),
                          shape=shape, psi0=_psi0(jcfg), steps=STEPS,
                          opts=opts))
    if world == 2:
        cases += [dict(name=f"overlap G={g}", kind="inverter", cls="packed",
                       shape=(2, 1), cfg=config_from_jax(OVERLAP_CFG),
                       zeta=OVERLAP_ZETA, opts=dict(overlap_groups=g))
                  for g in (1, 2)]
    return ranks.spawn(world, tmp_path, cases)


def _check(results, world, name):
    jcfg, shape, route, gates = CASES[world][name]
    got = results[name]
    assert got["route"] == route and got["step"] == STEPS
    if route == "fused" and shape[0] > 1:
        # The inverter the port picked is the one tpu_qg picks.
        assert paired_supported(jcfg.M, jcfg.P, shape[0]) == (
            "paired" in name)
    want = _tpu_qg_route(jcfg, shape, "chain" if route == "chain" else "step")
    for f in ("zeta", "f1"):
        _close(got[f], want[f], ROUTE_TOL, f"{name} {f} vs tpu_qg's route")
    ref = _per_mode_reference(jcfg)
    for f, tol in gates.items():
        _close(got[f], ref[f], tol, f"{name} {f} vs one device")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("fused2"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("fused4"))


@pytest.mark.parametrize("name", list(CASES[2]))
def test_fused_two_ranks_match_tpu_qg(two_ranks, name):
    _check(two_ranks, 2, name)


@pytest.mark.parametrize("name", list(CASES[4]))
def test_fused_four_ranks_match_tpu_qg(four_ranks, name):
    _check(four_ranks, 4, name)


def test_overlap_groups_two(two_ranks):
    """The companion inverter with its columns in two chunks whose
    all-to-alls are in flight together: the same values per point as one
    chunk, and tpu_qg's DistributedPackedInverter(overlap_groups=2) on its
    virtual mesh to 1e-5 (the plain versions' torch.fft against tpu_qg's
    float32 matmul DFT)."""
    got = two_ranks["overlap G=2"]
    np.testing.assert_array_equal(got, two_ranks["overlap G=1"])
    jcfg = OVERLAP_CFG
    mesh = make_mesh((2, 1), devices=jax.devices()[:2])
    dist = DistributedPackedInverter(
        jcfg.M, jcfg.P, jcfg.dx, jcfg.S_eig, jcfg.P_inv_matrix(),
        jcfg.back_projection_matrix(), axis_x="x", interpret=True,
        overlap_groups=2)
    want = jax.jit(jax.shard_map(
        dist, mesh=mesh, in_specs=(Pspec(None, "x", None),),
        out_specs=Pspec(None, "x", None), check_vma=False))(OVERLAP_ZETA)
    _close(got, want, 1e-5, "overlap_groups=2")
    single = PackedModalInverterPallasFFT(
        jcfg.M, jcfg.P, jcfg.dx, jcfg.S_eig, jcfg.P_inv_matrix(),
        jcfg.back_projection_matrix(), interpret=True)
    _close(got, single(OVERLAP_ZETA), 1e-5, "vs one device")

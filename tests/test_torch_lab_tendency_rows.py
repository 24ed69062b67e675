"""K18 (the stencil lab's step) and K9 (the tendency alone) in K1's
row-streaming design (csrc lab_rows_kernel, tendency_rows_kernel) through
the CPU emulation of their index maps, ``fused_step_rows_emulated`` with
``body=`` and ``tend_only=`` (L from the fields' shape): the CUDA source's
blocks, rings, per-row x wrap and y halo pieces in plain torch.

- On the ragged 100 x 196 shape (a ragged last run, one strip narrower than
  W = 256) in the layouts the wrappers launch, float64 at 1e-12 of
  max|plain|: K18's four bodies x one and two layers against
  lab_step_plain (norot's carry, zero apart from the wind under euler_ab3,
  held against base's carry scale), and K9 for one and two layers, with and
  without the wind, against fused_tendency_plain; in every case each output
  element stored exactly once and every ring read finding its row filled
  and waited on.
- A ring one slot short is caught in K9's and K18's emulation.
- float32 at 1e-6 of max|ref| against tpu_qg's interpret-mode lab_step
  (noslice) and fused_tendency (one layer with the wind, whose float32 sin
  row is swapped for the float64 one the port adds, and two layers), 128^2.
- The CUDA sources instantiate every layout the wrappers can launch.
"""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qg
from tpu_qg.ops._stencil_lab import lab_step as j_lab_step
from tpu_qg.ops.pallas_tendency import _wind_rows
from tpu_qg.ops.pallas_tendency import fused_tendency as j_fused_tendency
from tpu_qg_torch import preset
from tpu_qg_torch.interop import config_from_jax
from tpu_qg_torch.models.core import _wind_forcing
from tpu_qg_torch.ops import step_kernel
from tpu_qg_torch.ops._stencil_lab import (KERNEL_BODY, lab_step,
                                           lab_step_plain)
from tpu_qg_torch.ops.step_kernel import (BODY_BASE, fused_step_plain,
                                          fused_step_rows_emulated,
                                          fused_tendency,
                                          fused_tendency_plain,
                                          step_rows_launched,
                                          step_rows_layout,
                                          tendency_rows_launched)
from tpu_qg_torch.scripts import stencil_lab

M, P = 100, 196
CASES = [("euler_ab3", 0.0, 0), ("euler_ab3", 0.0, 5),
         ("leapfrog_ra", 0.1, 0), ("leapfrog_ra", 0.1, 3)]
BODIES = ("base", "norot", "noslice", "nojac")
# The layouts the row kernels launch: K18 K1's (step_rows_launched), K9
# tendency_rows_launched, at the emulated M and at 2048 and 8192.
LAB_LAYOUTS = [step_rows_launched(m) for m in (M, 2048, 8192)]
TEND_LAYOUTS = [tendency_rows_launched(m) for m in (M, 2048, 8192)]
CSRC = pathlib.Path(step_kernel.__file__).parent.parent / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(layers, case, dtype="float64", M=M, P=P):
    scheme, tau0, _ = case
    return preset("turbulence-2048").replace(
        M=M, P=P, n_layers=layers, time_scheme=scheme, wind_tau0=tau0,
        dtype=dtype)


def _fields(layers, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(s * rng.standard_normal((layers, M, P)))
            for s in (1e-5, 1e3, 1e-9, 1e-9)]


def _close(got, want, floor=0.0):
    scale = max(float(want.abs().max()), floor)
    assert float((got - want).abs().max()) <= 1e-12 * scale


def _once(stores, bad):
    assert bad == 0
    assert bool((stores == 1).all())


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("variant", BODIES)
def test_emulated_lab_matches_plain(variant, layers):
    i = 2 * BODIES.index(variant) + layers - 1
    case, layout = CASES[i % len(CASES)], LAB_LAYOUTS[i % len(LAB_LAYOUTS)]
    cfg = _cfg(layers, case)
    fields = _fields(layers, seed=i)
    want = lab_step_plain(cfg, *fields, case[2], variant)
    scale = float(lab_step_plain(cfg, *fields, case[2])[1].abs().max())
    zn, carry, stores, bad = fused_step_rows_emulated(
        cfg, *fields, case[2], layout, body=KERNEL_BODY[variant])
    _close(zn, want[0])
    _close(carry, want[1], floor=scale if variant == "norot" else 0.0)
    _once(stores, bad)


@pytest.mark.parametrize("layout", TEND_LAYOUTS,
                         ids=["launched-at-{}".format(m)
                              for m in (M, 2048, 8192)])
@pytest.mark.parametrize("layers,tau0", [(1, 0.0), (1, 0.1), (2, 0.0),
                                         (2, 0.1)])
def test_emulated_tendency_matches_plain(layers, tau0, layout):
    cfg = _cfg(layers, ("euler_ab3", tau0, 0))
    zeta, psi, _, _ = _fields(layers, seed=layers)
    want = fused_tendency_plain(cfg, zeta, psi)
    tend, carry, stores, bad = fused_step_rows_emulated(
        cfg, zeta, psi, None, None, 0, layout, tend_only=True)
    assert carry is None
    _close(tend, want)
    _once(stores, bad)


def test_emulated_tendency_is_the_emulated_k1_carry():
    """K9's two-layer tendency is K1's carry under euler_ab3 at step 0 (the
    update stores the tendency as the carry), in the same emulation."""
    cfg = _cfg(2, ("euler_ab3", 0.1, 0), dtype="float32")
    fields = [f.float() for f in _fields(2, seed=7)]
    layout = step_rows_launched(M)
    tend, *_ = fused_step_rows_emulated(cfg, *fields[:2], None, None, 0,
                                        layout, tend_only=True)
    _, carry, *_ = fused_step_rows_emulated(cfg, *fields, 0, layout)
    assert torch.equal(tend, carry)


def test_emulated_lab_base_is_the_emulated_k1():
    cfg = _cfg(2, CASES[3])
    fields = _fields(2, seed=8)
    layout = step_rows_launched(M)
    lab = fused_step_rows_emulated(cfg, *fields, 3, layout, body=BODY_BASE)
    k1 = fused_step_rows_emulated(cfg, *fields, 3, layout)
    assert all(torch.equal(a, b) for a, b in zip(lab[:2], k1[:2]))
    _close(k1[0], fused_step_plain(cfg, *fields, 3)[0])


@pytest.mark.parametrize("variant,tend_only", [("noslice", False),
                                               ("base", True)],
                         ids=["K18-noslice", "K9"])
def test_emulation_catches_a_short_ring(variant, tend_only):
    """One ring slot fewer than G + 3 + D refills a slot a group still
    reads: the emulation counts the bad reads."""
    cfg = _cfg(2, CASES[1])
    z, p, f1, f2 = _fields(2)
    layout = (256, 32, 4, 128)
    *_, bad = fused_step_rows_emulated(
        cfg, z, p, None if tend_only else f1, None if tend_only else f2, 5,
        layout, slots=step_rows_layout(layout).S - 1,
        body=KERNEL_BODY[variant], tend_only=tend_only)
    assert bad > 0


def _close32(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_emulated_lab_noslice_matches_tpu_qg_float32():
    """noslice (the x neighbours read as the centre) at the lab's 128^2,
    two layers, euler_ab3 step 2, against tpu_qg's lab_step (tile 32)."""
    cfg = stencil_lab.lab_config(128).replace(dtype="float32")
    jcfg = tpu_qg.ModelConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(11)
    psi = (jcfg.initial_kick * jcfg.U * jcfg.Ly
           * rng.random((2, 128, 128))).astype(np.float32)
    zeta = np.array(tpu_qg.init_state(jcfg, psi_init=psi).zeta, np.float32)
    scale = np.abs(zeta).max() / jcfg.dt * 1e-3
    f1, f2 = ((scale * rng.standard_normal(zeta.shape)).astype(np.float32)
              for _ in range(2))
    arrays = [zeta, psi, f1, f2]
    want = j_lab_step(jcfg, *(jnp.asarray(a) for a in arrays), jnp.int32(2),
                      "noslice", True, 32)
    *got, stores, bad = fused_step_rows_emulated(
        cfg, *(torch.from_numpy(a) for a in arrays), 2,
        step_rows_launched(128), body=KERNEL_BODY["noslice"])
    for g, w in zip(got, want):
        _close32(g, w)
    _once(stores, bad)


@pytest.mark.parametrize("layers,tau0", [(1, 0.1), (2, 0.0)])
def test_emulated_tendency_matches_tpu_qg_float32(layers, tau0):
    """K9 at (L, 128, 128) against tpu_qg's fused_tendency; with the wind
    its float32 sin row (``_wind_rows``) is swapped for the float64 row the
    port rounds, as tests/test_torch_step_kernel.py does."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(
        M=128, P=128, n_layers=layers, wind_tau0=tau0, dtype="float32")
    rng = np.random.default_rng(layers + 20)
    psi = (jcfg.initial_kick * jcfg.U * jcfg.Ly
           * rng.random((layers, 128, 128))).astype(np.float32)
    zeta = np.array(tpu_qg.init_state(jcfg, psi_init=psi).zeta, np.float32)
    want = np.asarray(j_fused_tendency(jcfg, jnp.asarray(zeta),
                                       jnp.asarray(psi), True))
    cfg = config_from_jax(jcfg)
    if tau0:
        want = (want.astype(np.float64)
                - np.asarray(_wind_rows(jcfg, 128, 128), np.float64)
                + _wind_forcing(cfg, torch.float64, "cpu").numpy())
    tend, _, stores, bad = fused_step_rows_emulated(
        cfg, torch.from_numpy(zeta), torch.from_numpy(psi), None, None, 0,
        tendency_rows_launched(128), tend_only=True)
    _close32(tend, want)
    _once(stores, bad)


def test_cpu_wrappers_count_no_row_launch():
    """On CPU tensors lab_step and fused_tendency run their plain versions
    and count nothing, rows_launches included."""
    cfg = _cfg(2, CASES[2], dtype="float32")
    z, p, f1, f2 = (f.float() for f in _fields(2))
    before = (lab_step.launches, lab_step.rows_launches,
              fused_tendency.launches, fused_tendency.rows_launches)
    for g, w in zip(lab_step(cfg, z, p, f1, f2, 0, "nojac"),
                    lab_step_plain(cfg, z, p, f1, f2, 0, "nojac")):
        assert torch.equal(g, w)
    assert torch.equal(fused_tendency(cfg, z, p),
                       fused_tendency_plain(cfg, z, p))
    assert (lab_step.launches, lab_step.rows_launches,
            fused_tendency.launches, fused_tendency.rows_launches) == before


def _instances(source: str, pattern: str) -> set:
    return {tuple(int(v) for v in m)
            for m in re.findall(pattern, (CSRC / source).read_text())}


def test_lab_source_instantiates_every_launched_layout():
    """lab_rows_dispatch holds W = 256, NT = 128 and the D of every layout
    step_rows_launched returns, for L 1 and 2 and the four bodies."""
    src = (CSRC / "lab_kernel.cu").read_text()
    ahead = _instances("lab_kernel.cu", r"QG_LAB_CASE\(l, b, (\d+)\)")
    assert "W == 256 && NT == 128" in src
    assert re.search(r"QG_LAB_BODIES\(1\) QG_LAB_BODIES\(2\)", src)
    for name in ("kBodyBase", "kBodyNorot", "kBodyNoslice", "kBodyNojac"):
        assert f"QG_LAB_D(l, {name})" in src
    for m in (*step_kernel.STEP_ROWS_BY_M, 256, 4096, M):
        W, _, D, NT = step_rows_launched(m)
        assert (W, NT) == (256, 128) and (D,) in ahead, m


def test_tendency_source_instantiates_every_launched_layout():
    """tendency_rows_kernel runs over rows_dispatch's (W, NT) pairs and D
    values, which hold every layout tendency_rows_launched returns."""
    pairs = _instances("step_kernel.cu", r"QG_ROWS_D\((\d+), (\d+)\)")
    ahead = _instances("step_kernel.cu", r"QG_ROWS_CASE\(w, nt, (\d+)\)")
    src = (CSRC / "step_kernel.cu").read_text()
    assert "tendency_rows_kernel<2, T::kW, T::kNT, T::kD>" in src
    assert "tendency_rows_kernel<1, T::kW, T::kNT, T::kD>" in src
    for m in (*step_kernel.TENDENCY_ROWS_BY_M, 256, 4096, M):
        W, R, D, NT = tendency_rows_launched(m)
        assert (W, NT) in pairs and (D,) in ahead and R >= 1, m

"""Two-layer (and single-layer barotropic) QG model: state, tendencies, stepping.

Counterpart of ``tpu_qg.models.core`` in PyTorch. The state is interior-only
(no ghost ring) and carries exactly what the schemes need: current zeta and
psi and two history fields per layer. ``State.step`` is a host-side Python
int, so the Euler start of each scheme is a host branch and the step loop
never reads a device value.

Routing mirrors ``tpu_qg``'s ``_use_pallas``, ``_resolve_fft_impl`` and
``make_step_fn`` (tpu_qg/models/core.py:304-408, 547-608), with the
hand-written CUDA kernels in the place of its Pallas kernels. The step
kernels run under ``use_pallas``, float32, M*P >= 256^2, P % 128 == 0 and
M % 8 == 0 (``ops/step_kernel.py``):

  * two layers, zero-mean gauge: K1, then the packed inversion;
  * one layer, or the pin gauge: K8 (the step and the modes P^-1 zeta), then
    ``BatchedModalSolver`` on torch.fft and, for two layers, the
    back-projection.

The packed inversion runs its DFT kernels (``ops/dft_kernels.py``) for
float32 and ``use_pallas`` (or ``fft_impl="pallas"``) on 128 * n extents, by
the reference's route for the shape (``spectral.inversion_route``):

  * M <= 2432 (and fft_pairx != "off"): K2 -> K3 -> K2^-1;
  * otherwise K2 -> K4 -> K5 -> K2^-1 (the reference's streaming
    x-kernels K6, M >= 4608, compute what K4 and K5 compute), except
  * 4224 <= M <= 4480: K2 -> K4 -> torch symbol stage -> K4^-1 -> K2^-1.

Elsewhere the plain torch route runs, where the reference takes XLA. A
pinned ``fft_impl="matmul"`` runs the matmul-factorized DFT
(``PackedModalInverterMXU``) after K1 or the plain step; "auto" never picks
it. A configuration on which the reference would run a kernel this package
has not ported raises ``NotImplementedError`` naming it, instead of running
something else.

The opt-in one-launch forms take over where they are pinned "on" and the
reference's shape gates admit them (``QGModel.route`` names the route):

  * ``fft_mono``: the inversion is one launch of K16 ("mono");
  * ``step_full``: the whole step is one launch of K17 ("fullstep"), which
    then excludes the chain;
  * ``step_chain``: ``QGModel.run`` and ``run_trajectory`` keep psi as its
    permuted y-spectrum between steps, one step being K15 then the
    inversion's x-stage, K3 or K4 + K5 ("chain"; ``make_chain_fns``).

Under "auto" each stays off: ``tpu_qg``'s own gates rest on TPU evidence,
and no H100 measurement admits them yet. A pinned form that cannot engage
raises ``ValueError`` with the reference's wording.

The route depends on the configuration only; on CPU tensors each kernel
wrapper runs its plain version, so a CPU run has the card's structure.

Deliberate deviation from ``tpu_qg``: the random initial condition comes
from numpy's seeded generator and cannot match ``jax.random`` bit for bit
(tests inject ``psi_init``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..ops.dft_kernels import y_dft
from ..ops.spectral import (BatchedModalSolver, HelmholtzSolver,
                            PackedModalInverter, PackedModalInverterKernels,
                            PackedModalInverterMXU, reference_dft_kernels,
                            reference_fullstep, reference_yfused)
from ..ops.step_kernel import (fused_pre_inversion, fused_step,
                               fused_step_full, fused_step_plain,
                               fused_step_yspec)
from ..ops.stencils import arakawa_J, centered_diff_x, laplace_5p


class State(NamedTuple):
    """Simulation state.

    zeta: (L, M, P) potential-vorticity-like prognostic field.
    psi:  (L, M, P) streamfunction (diagnostic, from the elliptic inversion).
    f1:   (L, M, P) tendency of the previous step (euler_ab3) or the
          Robert-Asselin-filtered previous level (leapfrog_ra).
    f2:   (L, M, P) tendency two steps back (euler_ab3; unused by leapfrog).
    step: number of completed steps (host int).
    """

    zeta: torch.Tensor
    psi: torch.Tensor
    f1: torch.Tensor
    f2: torch.Tensor
    step: int


_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _tendencies(cfg: ModelConfig, zeta: torch.Tensor,
                psi: torch.Tensor) -> torch.Tensor:
    """Per-layer RHS d(zeta)/dt, fused across layers.

    Layer 1: visc*lap(lap(psi)) - J(zeta, psi) - beta_1*d(psi)/dx - U*d(zeta)/dx
    Layer 2: visc*lap(lap(psi)) - J(zeta, psi) - beta_2*d(psi)/dx - r*lap(psi)
    Single layer: the layer-1 form with beta plus bottom drag -r*lap(psi).
    """
    dx = cfg.dx
    lap_psi = laplace_5p(psi, dx)
    visc_term = cfg.visc * laplace_5p(lap_psi, dx)
    jac = arakawa_J(zeta, psi, dx)
    dpsi_dx = centered_diff_x(psi, dx)

    if cfg.n_layers == 1:
        u_term = cfg.U * centered_diff_x(zeta, dx)
        drag = cfg.r * lap_psi
        tend = visc_term - jac - cfg.beta * dpsi_dx - u_term - drag
        if cfg.wind_tau0 != 0.0:
            tend = tend + _wind_forcing(cfg, zeta.dtype, zeta.device)[None]
        return tend

    betas = torch.tensor([cfg.beta_1, cfg.beta_2], dtype=zeta.dtype,
                         device=zeta.device)[:, None, None]
    beta_term = betas * dpsi_dx
    u_term = cfg.U * centered_diff_x(zeta[0], dx)
    drag = cfg.r * lap_psi[1]
    extra = torch.stack([u_term, drag])
    tend = visc_term - jac - beta_term - extra
    if cfg.wind_tau0 != 0.0:
        wind = _wind_forcing(cfg, zeta.dtype, zeta.device)
        tend = torch.cat([tend[:1] + wind, tend[1:]])
    return tend


def _wind_forcing(cfg: ModelConfig, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """Double-gyre wind-stress-curl PV forcing on the top layer, shape (1, P):
    F(y) = -(2 pi tau_0 / (rho_0 H_1 Ly)) sin(2 pi y / Ly), built in float64."""
    y = np.arange(cfg.P) * cfg.dx
    amp = 2.0 * np.pi * cfg.wind_tau0 / (cfg.rho0 * cfg.H_1 * cfg.Ly)
    f = -amp * np.sin(2.0 * np.pi * y / cfg.Ly)
    return torch.as_tensor(f, dtype=dtype, device=device)[None, :]


def _invert_psi(cfg: ModelConfig, solvers, zeta: torch.Tensor) -> torch.Tensor:
    """Streamfunction from PV: modal projection, spectral solves,
    back-projection (reference: src/model.jl:172-199, with the
    P_matrix(H_1, H_1) quirk via cfg.back_projection_matrix())."""
    if isinstance(solvers, PackedModalInverter):
        return solvers(zeta)
    if cfg.n_layers == 1:
        if isinstance(solvers, tuple):
            return solvers[0](zeta)
        return solvers(zeta)

    (pi11, pi12), (pi21, pi22) = cfg.P_inv_matrix()
    zt1 = pi11 * zeta[0] + pi12 * zeta[1]   # barotropic mode
    zt2 = pi21 * zeta[0] + pi22 * zeta[1]   # baroclinic mode
    if isinstance(solvers, tuple):
        poisson, helmholtz = solvers
        return _back_project(cfg, poisson(zt1), helmholtz(zt2))
    pt = solvers(torch.stack([zt1, zt2]))
    return _back_project(cfg, pt[0], pt[1])


def _back_project(cfg: ModelConfig, pt0: torch.Tensor,
                  pt1: torch.Tensor) -> torch.Tensor:
    """psi from the two modal streamfunctions (back-projection P)."""
    (p11, p12), (p21, p22) = cfg.back_projection_matrix()
    return torch.stack([p11 * pt0 + p12 * pt1, p21 * pt0 + p22 * pt1])


# --- Routing -----------------------------------------------------------------

# Step-kernel size floor, the reference's (tpu_qg/models/core.py:397-408).
_KERNEL_FLOOR = 256 * 256


def fullstep_supported(cfg: ModelConfig) -> bool:
    """The reference's fullstep_supported: two float32 layers in the
    zero-mean gauge, on a shape its one-launch step takes."""
    return (cfg.n_layers == 2 and cfg.poisson_gauge == "zero_mean"
            and cfg.dtype == "float32" and reference_fullstep(cfg.M, cfg.P))


def yfused_supported(cfg: ModelConfig) -> bool:
    """The reference's yfused_supported: two float32 layers on a shape its
    y-fused step kernel takes."""
    return (cfg.n_layers == 2 and cfg.dtype == "float32"
            and reference_yfused(cfg.M, cfg.P))


def use_step_kernel(cfg: ModelConfig) -> bool:
    """The step-kernel gate (tpu_qg/models/core.py:397-408): use_pallas,
    float32, at or above the size floor, and the reference's shape rule."""
    return (cfg.use_pallas and cfg.dtype == "float32"
            and cfg.M * cfg.P >= _KERNEL_FLOOR
            and cfg.P % 128 == 0 and cfg.M % 8 == 0)


def resolve_fft_impl(cfg: ModelConfig) -> str:
    """The packed inversion's transform tier: "kernels" (the DFT kernels, by
    the route of ``spectral.inversion_route``), "matmul" (the
    matmul-factorized DFT, only where pinned: the reference picks it under
    "auto" on a TPU alone, tpu_qg/models/core.py:318-341) or "xla"
    (torch.fft, the oracle tier). Raises NotImplementedError where the
    reference would run a transform this package has not ported."""
    if cfg.fft_impl in ("xla", "matmul"):
        return cfg.fft_impl
    if cfg.fft_impl == "auto" and not (
            cfg.dtype == "float32" and cfg.use_pallas
            and reference_dft_kernels(cfg.M, cfg.P)):
        return "xla"
    if not reference_dft_kernels(cfg.M, cfg.P):
        raise ValueError(f"fft_impl='pallas' unsupported for ({cfg.M}, "
                         f"{cfg.P}): each extent must be 128 * n with n <= 64")
    if cfg.fft_mxu == "bf16x3":
        raise NotImplementedError(
            "fft_mxu='bf16x3' (reduced-precision DFT stage) is not ported "
            "yet; it waits for the float64 adjudication on the card")
    return "kernels"


def _build_packed_inverter(cfg: ModelConfig) -> PackedModalInverter:
    args = (cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())
    impl = resolve_fft_impl(cfg)
    if impl == "matmul":
        return PackedModalInverterMXU(*args)
    if impl != "kernels":
        return PackedModalInverter(*args)
    inv = PackedModalInverterKernels(
        *args, pair_x=cfg.fft_pairx != "off",
        mono=cfg.fft_mono == "on")
    # A pinned kernel form that cannot engage fails, as in the reference
    # (tpu_qg/models/core.py:362-372).
    if cfg.fft_mono == "on" and inv.route != "mono":
        raise ValueError(
            f"fft_mono='on' requested but the monolithic kernel cannot "
            f"engage at ({cfg.M}, {cfg.P}) (mono_fits/fuse rejected); "
            "use fft_mono='auto' to allow fallback")
    if cfg.fft_pairx == "on" and inv.x_route != "pair-x" and (
            inv.route != "mono"):
        raise ValueError(
            f"fft_pairx='on' requested but the mirror-pair kernel cannot "
            f"engage at ({cfg.M}, {cfg.P}) (pair_x_fits/fuse rejected); "
            "use fft_pairx='auto' to allow fallback")
    return inv


def _build_solvers(cfg: ModelConfig, batched_fft: bool = True):
    if (batched_fft and cfg.n_layers == 2
            and cfg.poisson_gauge == "zero_mean"):
        return _build_packed_inverter(cfg)
    if batched_fft:
        alphas = (0.0,) if cfg.n_layers == 1 else (0.0, cfg.S_eig)
        return BatchedModalSolver(cfg.M, cfg.P, cfg.dx, alphas,
                                  gauge=cfg.poisson_gauge)
    if cfg.n_layers == 1:
        return (HelmholtzSolver(cfg.M, cfg.P, cfg.dx, 0.0,
                                gauge=cfg.poisson_gauge),)
    return (
        HelmholtzSolver(cfg.M, cfg.P, cfg.dx, 0.0, gauge=cfg.poisson_gauge),
        HelmholtzSolver(cfg.M, cfg.P, cfg.dx, cfg.S_eig),
    )


def _next_state(cfg: ModelConfig, state: State, zeta_new, psi_new,
                carry) -> State:
    """History convention (the chain's too): euler_ab3 shifts (f1, f2) <-
    (tend, f1); leapfrog_ra keeps the filtered level in f1 and carries f2
    unchanged."""
    if cfg.time_scheme == "leapfrog_ra":
        return State(zeta_new, psi_new, carry, state.f2, state.step + 1)
    return State(zeta_new, psi_new, carry, state.f1, state.step + 1)


def make_step_fn(cfg: ModelConfig, batched_fft: bool = True):
    """Build the single-step transition ``state -> state``: evolve zeta
    (Euler for the first steps, then AB3 or leapfrog-RA), then invert for
    psi. ``batched_fft=False`` uses per-mode solvers. The function's
    ``route`` is "fullstep" (K17), "mono" (K16 inverts) or "default"."""
    solvers = _build_solvers(cfg, batched_fft)
    step_kernel = use_step_kernel(cfg) and batched_fft
    if step_kernel and not isinstance(solvers, PackedModalInverter):
        # Single layer or pin gauge: K8, the batched spectral solves of the
        # modes, then the back-projection (tpu_qg/models/core.py:592-608).
        def step(state: State) -> State:
            zeta_new, carry, modes = fused_pre_inversion(
                cfg, state.zeta, state.psi, state.f1, state.f2, state.step)
            pt = solvers(modes)
            psi_new = pt if cfg.n_layers == 1 else _back_project(cfg, pt[0],
                                                                 pt[1])
            return _next_state(cfg, state, zeta_new, psi_new, carry)

        step.route = "default"
        return step
    if (step_kernel and isinstance(solvers, PackedModalInverterKernels)
            and cfg.step_full == "on"):
        # The one-launch step (tpu_qg/models/core.py:550-573).
        if not fullstep_supported(cfg):
            raise ValueError(
                f"step_full='on' requested but the one-launch kernel "
                f"cannot engage at ({cfg.M}, {cfg.P}) "
                "(fullstep_supported rejected); use step_full='auto' "
                "to allow fallback")

        def step(state: State) -> State:
            zeta_new, carry, psi_new = fused_step_full(
                cfg, state.zeta, state.psi, state.f1, state.f2, state.step)
            return _next_state(cfg, state, zeta_new, psi_new, carry)

        step.route = "fullstep"
        return step
    advance = fused_step if step_kernel else fused_step_plain

    def step(state: State) -> State:
        zeta_new, carry = advance(cfg, state.zeta, state.psi, state.f1,
                                  state.f2, state.step)
        psi_new = _invert_psi(cfg, solvers, zeta_new)
        return _next_state(cfg, state, zeta_new, psi_new, carry)

    step.route = ("mono" if isinstance(solvers, PackedModalInverterKernels)
                  and solvers.route == "mono" else "default")
    return step


def make_chain_fns(cfg: ModelConfig):
    """The y-fused step chain (tpu_qg/models/core.py:458-516):
    ``(to_internal, step, to_external)``, or None where it does not engage.

    Inside the chain ``State.psi`` holds the permuted y-spectrum of the
    packed psi_1 + i psi_2, the inversion's x-stage output before its final
    inverse-y: one step is K15 (which inverse-transforms it, steps, and
    forward-transforms the packed zeta_new) then the x-stage, K3 or K4 + K5.
    ``to_internal`` and ``to_external`` are one K2 launch each, so states
    seen outside the chain always hold natural psi. The chain does not
    engage for one layer, the pin gauge, where the one-launch step engages,
    off the step kernels' shapes, or on the unfused four-pass route
    (4224 <= M <= 4480); the default step then runs, as in the reference."""
    if cfg.n_layers != 2 or cfg.poisson_gauge != "zero_mean":
        return None
    if cfg.step_full == "on" and fullstep_supported(cfg):
        return None
    if not yfused_supported(cfg):
        return None
    if not use_step_kernel(cfg) or resolve_fft_impl(cfg) != "kernels":
        return None
    inverter = _build_packed_inverter(cfg)
    if inverter.x_route == "four-pass-unfused":
        return None

    def to_internal(state: State) -> State:
        return state._replace(psi=y_dft(state.psi, False))

    def to_external(state: State) -> State:
        return state._replace(psi=y_dft(state.psi, True))

    def step(state: State) -> State:
        zeta_new, carry, zeta_ys = fused_step_yspec(
            cfg, state.zeta, state.psi, state.f1, state.f2, state.step)
        return _next_state(cfg, state, zeta_new, inverter.x_stage(zeta_ys),
                           carry)

    return to_internal, step, to_external


def init_state(cfg: ModelConfig, device: torch.device | str,
               psi_init=None, seed: Optional[int] = None) -> State:
    """Initial condition: a streamfunction, then zeta from its definition.

    ``psi_init`` (an (L, M, P) array or tensor) is used as given; else
    ``ic_type="vortex"`` builds the Gaussian dipole and ``"random"`` the
    reference's noise kick initial_kick * U * Ly * uniform[0, 1), drawn from
    numpy's generator seeded with ``seed`` (default cfg.seed).
    """
    if cfg.n_layers == 2:
        cfg.validate()
    dtype = torch_dtype(cfg)
    shape = (cfg.n_layers, cfg.M, cfg.P)
    if psi_init is not None:
        psi = torch.as_tensor(psi_init).to(device=device, dtype=dtype)
        psi = psi.reshape(shape).contiguous()
    elif cfg.ic_type == "vortex":
        x = (np.arange(cfg.M) + 0.5) * cfg.dx
        y = (np.arange(cfg.P) + 0.5) * cfg.dx
        X, Y = np.meshgrid(x, y, indexing="ij")
        sigma = 0.08 * min(cfg.Lx, cfg.Ly)
        amp = cfg.initial_kick * (abs(cfg.U) or 1.0) * cfg.Ly

        def bump(cx, cy, s):
            return s * np.exp(-(((X - cx) ** 2 + (Y - cy) ** 2)
                                / (2.0 * sigma ** 2)))

        field = (bump(0.35 * cfg.Lx, 0.5 * cfg.Ly, amp)
                 + bump(0.65 * cfg.Lx, 0.5 * cfg.Ly, -amp))
        psi = torch.as_tensor(np.broadcast_to(field, shape).copy(),
                              dtype=dtype, device=device)
    else:
        rng = np.random.default_rng(cfg.seed if seed is None else seed)
        amp = cfg.initial_kick * (cfg.U if cfg.U != 0.0 else 1.0) * cfg.Ly
        psi = torch.as_tensor(amp * rng.random(shape), dtype=dtype,
                              device=device)
    return _init_finish(cfg, psi)


def _init_finish(cfg: ModelConfig, psi: torch.Tensor) -> State:
    """zeta from psi (layer-coupled definition) plus zero history."""
    if cfg.n_layers == 1:
        zeta = laplace_5p(psi, cfg.dx)
    else:
        lap = laplace_5p(psi, cfg.dx)
        z1 = lap[0] + cfg.S1_plus * (psi[1] - psi[0])
        z2 = lap[1] + cfg.S2_minus * (psi[0] - psi[1])
        zeta = torch.stack([z1, z2])
    zero = torch.zeros_like(psi)
    return State(zeta, psi, zero, zero.clone(), 0)


class QGModel:
    """Config, step function and multi-step runs on one device (the GPU
    unless the CPU is asked for). ``route`` is "default", "mono",
    "fullstep" or "chain" (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step = make_step_fn(cfg)
        # Multi-step runs take the chain where it resolves on and engages; a
        # single step stays on the step function, as in the reference.
        self._chain = (make_chain_fns(cfg)
                       if cfg.step_chain == "on" else None)
        self.route = "chain" if self._chain is not None else self.step.route

    def init_state(self, psi_init=None, seed: Optional[int] = None) -> State:
        return init_state(self.cfg, self.device, psi_init=psi_init, seed=seed)

    def run(self, state: State, n_steps: int) -> State:
        """Advance ``n_steps`` steps (a host loop; each step launches its
        kernels on the current stream without synchronising)."""
        if self._chain is not None:
            to_internal, step, to_external = self._chain
            state = to_internal(state)
            for _ in range(n_steps):
                state = step(state)
            return to_external(state)
        for _ in range(n_steps):
            state = self.step(state)
        return state

    def run_trajectory(self, state: State, n_steps: int, sample_every: int
                       ) -> Tuple[State, torch.Tensor, torch.Tensor]:
        """Advance n_steps, returning (final_state, zeta_samples,
        psi_samples) sampled every ``sample_every`` steps."""
        if n_steps % sample_every != 0:
            raise ValueError(f"n_steps={n_steps} is not a multiple of "
                             f"sample_every={sample_every}")
        zs, ps = [], []
        if self._chain is not None:
            # Inside the chain between samples; each sample converted back.
            to_internal, step, to_external = self._chain
            inner = to_internal(state)
            for _ in range(n_steps // sample_every):
                for _ in range(sample_every):
                    inner = step(inner)
                state = to_external(inner)
                zs.append(state.zeta)
                ps.append(state.psi)
            return state, torch.stack(zs), torch.stack(ps)
        for _ in range(n_steps // sample_every):
            state = self.run(state, sample_every)
            zs.append(state.zeta)
            ps.append(state.psi)
        return state, torch.stack(zs), torch.stack(ps)

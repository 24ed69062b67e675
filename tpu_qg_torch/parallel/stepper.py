"""The sharded time step: halo-exchange stencils + distributed inversion.

Counterpart of ``tpu_qg.parallel.stepper`` on ``torch.distributed``: each
rank advances its (L, m, p) tile of the global grid, with halo exchanges
for the stencil radius (1 for zeta, 2 for psi: the del^4 friction,
reference: src/model.jl:140,148) and a transposed distributed FFT for the
modal inversion (reference: src/model.jl:172-199). A step function takes
and returns this rank's ``State`` (its blocks, and the host-int step);
every rank calls it in turn, since it runs collectives.

Routes (``step.route``), as ``tpu_qg`` takes them:

  * "fused": on an (nx, 1) mesh, K12 on the row block with 2-row slabs
    from its x-neighbours, then the inversion with K14
    (``PairedDistributedInverter``) where ``paired_supported`` admits the
    shape, else K13 (``DistributedPackedInverter``); one rank takes its own
    wrap rows and the single-device x-stage;
  * "fused-2d": on an (nx, ny) mesh, K12 on the tile (its y wrap local),
    the two columns at each y edge recomputed from exchanged halos, then
    ``DistributedPackedInverter2D`` (K13);
  * "generic": torch stencils on halo-padded tiles (blocking, or the
    interior overlapped with the exchanges) and ``DistributedHelmholtzSolver``;
  * "generic-mg" (``elliptic_impl="multigrid"``, which the fused gates
    refuse): the generic tendencies and the distributed multigrid
    (``parallel/multigrid.py``), warm-started from the previous psi, or
    under ``mg_extrapolate`` in ``make_halo_run_fn`` from 2 psi_n -
    psi_{n-1};
  * "chain" (``make_halo_run_fn`` with ``step_chain="on"``): psi rides as
    its y-spectrum between steps; one step is K15's sharded form, then the
    inversion's x-stage.

``fused="auto"`` takes the fused routes for CUDA state wherever the copied
gates admit the shape (``tpu_qg`` reads "on a TPU" there), the generic one
elsewhere; True forces them (the plain versions of the kernels on CPU
tensors, as in the tests).

Deliberate deviation: the TPU kernels exchange 8-row slabs (their sublane
alignment, ``_H``); the stencil reads 2 rows of psi and 1 of zeta, and this
stepper exchanges 2 rows. That changes the traffic, not the values.

Deliberate deviation: ``tpu_qg``'s extrapolated run seeds the first step of
every call with psi itself (it passes a copy of psi as psi_{n-1},
``tpu_qg/parallel/stepper.py:597-623``), so its trajectory depends on how a
run is cut into calls. The run function here carries psi_{n-1} from one
call to the next: ``run(run(s, a), b)`` equals ``run(s, a + b)``.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..models.core import State, _next_state, _wind_forcing, torch_dtype
from ..ops.dft_kernels import y_dft
from ..ops.spectral import reference_sharded_step, reference_sharded_yfused
from ..ops.stencils import (arakawa_J_generic, centered_diff_x_generic,
                            laplace_5p_generic)
from ..ops.step_kernel import (HALO_ROWS, fused_step_sharded,
                               fused_step_yspec_sharded, update_plain)
from .collectives import ring_shift
from .distributed_fft import DistributedHelmholtzSolver
from .halo import HaloExchange, exchange_halo, make_padded_shift
from .mesh import Mesh
from .multigrid import (DistributedMultigridInverter,
                        DistributedMultigridSolver)
from .packed import (DistributedPackedInverter, DistributedPackedInverter2D,
                     distributed_packed_2d_supported,
                     distributed_packed_supported)
from .paired import PairedDistributedInverter, paired_supported


def _tend_window(cfg: ModelConfig, zeta_w: torch.Tensor, psi_w: torch.Tensor,
                 wind_row):
    """Tendency over one window from halo-carrying slabs: zeta_w (L, q+2,
    r+2) with a rim of 1, psi_w (L, q+4, r+4) with a rim of 2 -> (L, q, r).
    ``wind_row`` is the window's (1, r) forcing or None. The same per-point
    arithmetic serves the blocking form (one window) and the overlapped
    form (interior and four rims) (reference: src/model.jl:139-153)."""
    dx = cfg.dx
    s1 = make_padded_shift(1)
    psi_w1 = psi_w[..., 1:-1, 1:-1]
    lap_psi_1h = laplace_5p_generic(s1, psi_w, dx)
    visc_term = cfg.visc * laplace_5p_generic(s1, lap_psi_1h, dx)
    lap_psi = lap_psi_1h[..., 1:-1, 1:-1]
    jac = arakawa_J_generic(s1, zeta_w, psi_w1, dx)
    dpsi_dx = centered_diff_x_generic(s1, psi_w1, dx)

    if cfg.n_layers == 1:
        u_term = cfg.U * centered_diff_x_generic(s1, zeta_w, dx)
        tend = visc_term - jac - cfg.beta * dpsi_dx - u_term - cfg.r * lap_psi
        if wind_row is not None:
            tend = tend + wind_row[None]
        return tend

    betas = torch.tensor([cfg.beta_1, cfg.beta_2], dtype=zeta_w.dtype,
                         device=zeta_w.device)[:, None, None]
    u_term = cfg.U * centered_diff_x_generic(s1, zeta_w[0], dx)
    drag = cfg.r * lap_psi[1]
    tend = visc_term - jac - betas * dpsi_dx - torch.stack([u_term, drag])
    if wind_row is not None:
        tend = torch.cat([tend[:1] + wind_row, tend[1:]])
    return tend


def _local_wind_forcing(cfg: ModelConfig, zeta: torch.Tensor, mesh: Mesh):
    """This rank's (1, p) columns of the double-gyre forcing, or None."""
    if cfg.wind_tau0 == 0.0:
        return None
    p = zeta.shape[-1]
    full = _wind_forcing(cfg, zeta.dtype, zeta.device)
    return full[:, mesh.iy * p:(mesh.iy + 1) * p]


def _local_tendencies(cfg: ModelConfig, zeta, psi, mesh: Mesh):
    """Per-layer RHS on local tiles with halo exchange (blocking: both
    exchanges complete before any stencil work)."""
    return _tend_window(cfg, exchange_halo(zeta, 1, mesh),
                        exchange_halo(psi, 2, mesh),
                        _local_wind_forcing(cfg, zeta, mesh))


def _local_tendencies_overlapped(cfg: ModelConfig, zeta, psi, mesh: Mesh):
    """The RHS with the exchanges in flight while the tile interior (every
    point at least 2 from the tile edge) is computed from local data; the
    four rim windows then take the exchanged halos. Same per-point
    arithmetic as ``_local_tendencies``, which it falls back to below an
    8-wide tile."""
    m, p = zeta.shape[-2], zeta.shape[-1]
    if m < 8 or p < 8:
        return _local_tendencies(cfg, zeta, psi, mesh)
    wind = _local_wind_forcing(cfg, zeta, mesh)

    def wslice(c, d):
        return None if wind is None else wind[:, c:d]

    zeta_x = HaloExchange(zeta, 1, mesh)
    psi_x = HaloExchange(psi, 2, mesh)
    tend_int = _tend_window(cfg, zeta[..., 1:-1, 1:-1], psi, wslice(2, p - 2))
    zeta_pad, psi_pad2 = zeta_x.wait(), psi_x.wait()

    def rim(a, b, c, d):
        """Tendency over tile window [a, b) x [c, d) from the padded blocks
        (tile row i at padded row i+1 for zeta, i+2 for psi)."""
        return _tend_window(cfg, zeta_pad[..., a:b + 2, c:d + 2],
                            psi_pad2[..., a:b + 4, c:d + 4], wslice(c, d))

    top = rim(0, 2, 0, p)
    bot = rim(m - 2, m, 0, p)
    left = rim(2, m - 2, 0, 2)
    right = rim(2, m - 2, p - 2, p)
    mid = torch.cat([left, tend_int, right], dim=-1)
    return torch.cat([top, mid, bot], dim=-2)


def _itemsize(cfg: ModelConfig) -> int:
    return torch.empty((), dtype=torch_dtype(cfg)).element_size()


def fused_shape_supported(cfg: ModelConfig, nx: int, ny: int) -> bool:
    """The fused (N, 1) step's gate (tpu_qg/parallel/stepper.py:133-150):
    rows sharded, y local, two float32 layers in the zero-mean gauge on the
    spectral inversion, the sharded step kernel's and the distributed
    packed inverter's shape rules."""
    if ny != 1 or cfg.n_layers != 2 or cfg.poisson_gauge != "zero_mean":
        return False
    if cfg.elliptic_impl != "spectral":
        return False
    if _itemsize(cfg) != 4 or cfg.M % nx != 0:
        return False
    return (reference_sharded_step(cfg.n_layers, cfg.M // nx, cfg.P, 4)
            and distributed_packed_supported(cfg.M, cfg.P, nx))


def fused_halo_supported(cfg: ModelConfig, mesh: Mesh) -> bool:
    """The fused sharded step's gate on this mesh."""
    return fused_shape_supported(cfg, *mesh.shape)


def fused_2d_shape_supported(cfg: ModelConfig, nx: int, ny: int) -> bool:
    """The 2-D-mesh fused step's gate (tpu_qg/parallel/stepper.py:214-231):
    two float32 layers, zero-mean, spectral, no wind (the kernel's wind
    rows assume whole rows), the sharded step kernel on the local (m, p)
    tile and the 2-D packed inverter's divisibility."""
    if cfg.n_layers != 2 or cfg.poisson_gauge != "zero_mean":
        return False
    if cfg.elliptic_impl != "spectral" or cfg.wind_tau0 != 0.0:
        return False
    if _itemsize(cfg) != 4 or cfg.M % nx or cfg.P % ny:
        return False
    return (reference_sharded_step(2, cfg.M // nx, cfg.P // ny, 4)
            and distributed_packed_2d_supported(cfg.M, cfg.P, nx, ny))


def _resolve_fused(cfg: ModelConfig, mesh: Mesh, fused) -> bool:
    """"auto": on for CUDA state where the gate admits the shape; True: on,
    or a ValueError where the gate rejects it; False: off."""
    if fused == "auto":
        return (cfg.use_pallas and mesh.device.type == "cuda"
                and fused_halo_supported(cfg, mesh))
    if fused and not fused_halo_supported(cfg, mesh):
        raise ValueError(f"fused sharded step unsupported for this "
                         f"config/mesh (M={cfg.M}, P={cfg.P}, "
                         f"mesh={mesh.shape})")
    return bool(fused)


def _exchange_slabs(fields, mesh: Mesh):
    """For each (L, m, P) block of ``fields``: (top, bottom) slabs of
    HALO_ROWS rows (the stencil's reach; the TPU kernels take 8), the
    previous x-rank's last rows and the next one's first rows (the block's
    own wrap rows on one rank)."""
    nx, h = mesh.shape[0], HALO_ROWS
    if nx == 1:
        return [(a[:, -h:].contiguous(), a[:, :h].contiguous())
                for a in fields]
    pending = [(ring_shift(a[:, -h:], mesh.x_group, mesh.ix, nx, +1, True),
                ring_shift(a[:, :h], mesh.x_group, mesh.ix, nx, -1, True))
               for a in fields]
    return [(top.wait(), bot.wait()) for top, bot in pending]


def _packed_inverter(cfg: ModelConfig, mesh: Mesh):
    """K14's paired inverter where the reference's gate admits the shape,
    else the companion scheme (K13)."""
    cls = (PairedDistributedInverter
           if paired_supported(cfg.M, cfg.P, mesh.shape[0])
           else DistributedPackedInverter)
    return cls(cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
               cfg.back_projection_matrix(), mesh)


def _make_fused_local_step(cfg: ModelConfig, mesh: Mesh):
    """The fused (N, 1) step: slabs, K12, the distributed inversion."""
    inverter = _packed_inverter(cfg, mesh)

    def step(state: State) -> State:
        (zt, zb), (pt, pb) = _exchange_slabs((state.zeta, state.psi), mesh)
        zeta_new, carry = fused_step_sharded(
            cfg, state.zeta, state.psi, state.f1, state.f2, state.step, zt,
            zb, pt, pb)
        return _next_state(cfg, state, zeta_new, inverter(zeta_new), carry)

    return step


def _make_fused_local_step_2d(cfg: ModelConfig, mesh: Mesh):
    """The fused 2-D-mesh step: K12 on the tile with x slabs, whose y wrap is
    local, so the two output columns at each y edge are recomputed from
    exchanged halos with the generic arithmetic and spliced in; then the
    2-D packed inversion."""
    inverter = DistributedPackedInverter2D(
        cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
        cfg.back_projection_matrix(), mesh)
    ny = mesh.shape[1]

    def step(state: State) -> State:
        (zt, zb), (pt, pb) = _exchange_slabs((state.zeta, state.psi), mesh)
        zeta_new, carry = fused_step_sharded(
            cfg, state.zeta, state.psi, state.f1, state.f2, state.step, zt,
            zb, pt, pb)
        if ny > 1:
            p = state.zeta.shape[-1]
            zeta_pad1 = exchange_halo(state.zeta, 1, mesh)
            psi_pad2 = exchange_halo(state.psi, 2, mesh)
            for c0 in (0, p - 2):
                cols = slice(c0, c0 + 2)
                tend = _tend_window(cfg, zeta_pad1[..., c0:c0 + 4],
                                    psi_pad2[..., c0:c0 + 6], None)
                zn, c1 = update_plain(cfg, state.step, tend,
                                      state.zeta[..., cols],
                                      state.f1[..., cols],
                                      state.f2[..., cols])
                zeta_new[..., cols] = zn
                carry[..., cols] = c1
        return _next_state(cfg, state, zeta_new, inverter(zeta_new), carry)

    return step


def _make_generic_local_step(cfg: ModelConfig, mesh: Mesh, overlap: bool):
    """Torch stencils on halo-padded tiles and the transposed-FFT solve, or
    under ``elliptic_impl="multigrid"`` the distributed multigrid: the
    solver for one layer, the inverter for two
    (tpu_qg/parallel/stepper.py:403-418), seeded with ``seed`` or else the
    state's psi. The step is ``step(state, seed=None)``."""
    tendencies = (_local_tendencies_overlapped if overlap
                  else _local_tendencies)
    mg_solver = mg_inv = solver = None
    if cfg.elliptic_impl == "multigrid":
        if cfg.n_layers == 1:
            mg_solver = DistributedMultigridSolver(
                cfg.M, cfg.P, cfg.dx, (0.0,), mesh, n_cycles=cfg.mg_cycles)
        else:
            mg_inv = DistributedMultigridInverter(
                cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
                cfg.back_projection_matrix(), mesh, n_cycles=cfg.mg_cycles)
    else:
        alphas = (0.0,) if cfg.n_layers == 1 else (0.0, cfg.S_eig)
        solver = DistributedHelmholtzSolver(cfg.M, cfg.P, cfg.dx, alphas,
                                            mesh)
    if cfg.n_layers == 2:
        (pi11, pi12), (pi21, pi22) = cfg.P_inv_matrix()
        (b11, b12), (b21, b22) = cfg.back_projection_matrix()

    def step(state: State, seed=None) -> State:
        tend = tendencies(cfg, state.zeta, state.psi, mesh)
        zeta_new, carry = update_plain(cfg, state.step, tend, state.zeta,
                                       state.f1, state.f2)
        seed = state.psi if seed is None else seed
        if mg_inv is not None:
            psi_new = mg_inv(zeta_new, psi_prev=seed)
        elif mg_solver is not None:
            psi_new = mg_solver(zeta_new, x0=seed)
        elif cfg.n_layers == 1:
            psi_new = solver(zeta_new)
        else:
            modes = torch.stack([pi11 * zeta_new[0] + pi12 * zeta_new[1],
                                 pi21 * zeta_new[0] + pi22 * zeta_new[1]])
            pt = solver(modes)
            psi_new = torch.stack([b11 * pt[0] + b12 * pt[1],
                                   b21 * pt[0] + b22 * pt[1]])
        return _next_state(cfg, state, zeta_new, psi_new, carry)

    return step


def make_halo_step_fn(cfg: ModelConfig, mesh: Mesh, overlap: bool = True,
                      fused="auto", mg_seed: bool = False):
    """The sharded step ``state -> state`` on this rank's blocks (see the
    module docstring for the routes; ``step.route`` names the one taken).
    ``overlap`` selects the generic routes' overlapped tendencies.
    ``mg_seed=True`` returns the multigrid route's two-argument form
    ``step(state, seed)``, the caller giving the V-cycles' seed
    (tpu_qg/parallel/stepper.py:474-482); it needs
    ``elliptic_impl="multigrid"``."""
    multigrid = cfg.elliptic_impl == "multigrid"
    if mg_seed and not multigrid:
        raise ValueError("mg_seed=True requires elliptic_impl='multigrid'")
    nx, ny = mesh.shape
    if cfg.M % nx or cfg.P % ny:
        raise ValueError(f"grid ({cfg.M}, {cfg.P}) does not divide over "
                         f"mesh {mesh.shape}")
    use_2d = False
    if ny > 1 and fused is not False:
        ok_2d = fused_2d_shape_supported(cfg, nx, ny)
        if fused == "auto":
            use_2d = cfg.use_pallas and ok_2d and mesh.device.type == "cuda"
        else:
            use_2d = ok_2d
    if use_2d:
        step = _make_fused_local_step_2d(cfg, mesh)
        step.route = "fused-2d"
    elif _resolve_fused(cfg, mesh, fused):
        step = _make_fused_local_step(cfg, mesh)
        step.route = "fused"
    else:
        generic = _make_generic_local_step(cfg, mesh, overlap)
        if mg_seed:
            step = generic
        else:
            def step(state: State) -> State:
                return generic(state)
        step.route = "generic-mg" if multigrid else "generic"
    return step


def make_halo_chain_fns(cfg: ModelConfig, mesh: Mesh):
    """(to_internal, step, to_external) of the sharded step chain, or None
    where it does not engage (tpu_qg/parallel/stepper.py:488-552): psi rides
    between steps as the permuted y-spectrum of its row blocks (the
    y-transform is row-local); one step is K15's sharded form (psi's slabs
    exchanged in that form), then the inversion's x-stage."""
    nx, ny = mesh.shape
    if ny != 1 or cfg.n_layers != 2 or cfg.poisson_gauge != "zero_mean":
        return None
    if cfg.M % nx or not (
            reference_sharded_yfused(2, cfg.M // nx, cfg.P, _itemsize(cfg))
            and distributed_packed_supported(cfg.M, cfg.P, nx)):
        return None
    inverter = _packed_inverter(cfg, mesh)

    def to_internal(state: State) -> State:
        return state._replace(psi=y_dft(state.psi, False))

    def to_external(state: State) -> State:
        return state._replace(psi=y_dft(state.psi, True))

    def step(state: State) -> State:
        (zt, zb), (pt, pb) = _exchange_slabs((state.zeta, state.psi), mesh)
        zeta_new, carry, zeta_ys = fused_step_yspec_sharded(
            cfg, state.zeta, state.psi, state.f1, state.f2, state.step, zt,
            zb, pt, pb)
        return _next_state(cfg, state, zeta_new, inverter.x_stage(zeta_ys),
                           carry)

    return to_internal, step, to_external


def _same_state(state: State, ref) -> bool:
    """Whether ``state`` is the State ``ref`` holds, with no field changed in
    place since (``ref``: the state and its fields' version counters)."""
    if ref is None or state is not ref[0]:
        return False
    return all(getattr(state, f)._version == v
               for f, v in zip(("zeta", "psi", "f1", "f2"), ref[1]))


def _extrapolated_run(step2):
    """``run(state, n)`` seeding each V-cycle solve with 2 psi_n - psi_{n-1}
    (tpu_qg/parallel/stepper.py:597-623): the solve's lag error follows
    the seed's, and the O(dt^2) curvature is ~10x smaller than the O(dt)
    step change. psi_{n-1} is carried across calls: a call from the state
    the previous call returned continues with it; any other state (fresh,
    resumed, replaced or changed in place) starts with the plain seed psi_n,
    as ``tpu_qg``'s first step of a call does."""
    carried = {"ref": None, "prev": None}

    def run(state: State, n: int) -> State:
        prev = (carried["prev"] if _same_state(state, carried["ref"])
                else None)
        for _ in range(n):
            seed = state.psi if prev is None else 2.0 * state.psi - prev
            prev, state = state.psi, step2(state, seed)
        carried["prev"] = prev
        carried["ref"] = (state, tuple(getattr(state, f)._version for f in
                                       ("zeta", "psi", "f1", "f2")))
        return state

    return run


def make_halo_run_fn(cfg: ModelConfig, mesh: Mesh, overlap: bool = True,
                     fused="auto", chain=None):
    """``run(state, n) -> state``: n sharded steps in a host loop.
    ``chain=None`` takes the chain where ``step_chain="on"``, the fused
    route resolves on and the chain engages; True/False force the choice.
    The chain converts psi to its internal form once per call and back at
    the end, so states outside it always hold natural psi. The multigrid
    route under ``mg_extrapolate`` seeds each solve with 2 psi_n - psi_{n-1}
    (``_extrapolated_run``). ``run.route`` names the route."""
    want_chain = cfg.step_chain == "on" if chain is None else bool(chain)
    if want_chain and _resolve_fused(cfg, mesh, fused):
        fns = make_halo_chain_fns(cfg, mesh)
        if fns is not None:
            to_internal, chain_step, to_external = fns

            def run_chain(state: State, n: int) -> State:
                state = to_internal(state)
                for _ in range(n):
                    state = chain_step(state)
                return to_external(state)

            run_chain.route = "chain"
            return run_chain
    if cfg.elliptic_impl == "multigrid" and cfg.mg_extrapolate:
        step2 = make_halo_step_fn(cfg, mesh, overlap=overlap, fused=fused,
                                  mg_seed=True)
        run = _extrapolated_run(step2)
        run.route = step2.route
        return run
    step = make_halo_step_fn(cfg, mesh, overlap=overlap, fused=fused)

    def run(state: State, n: int) -> State:
        for _ in range(n):
            state = step(state)
        return state

    run.route = step.route
    return run

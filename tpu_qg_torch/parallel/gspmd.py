"""Global-array stepping on DTensor (the "gspmd" implementation).

Counterpart of ``tpu_qg.parallel.gspmd``: the single-device step,
``models.core.make_step_fn(cfg, batched_fft=False)`` unchanged, runs on a
state whose fields are DTensors of the global (L, M, P) arrays, the spatial
axes sharded over a ``DeviceMesh`` ("x", "y") of the ``Mesh``'s ranks in
the same order (rank = ix * ny + iy), the layer axis replicated. That step
never reaches a kernel (``batched_fft=False``), as in ``tpu_qg``.

Where ``tpu_qg`` leaves the collectives to XLA's partitioner, this module
places them by hand, at the partitioner's places:

  * A ``torch.roll`` by ``s`` along a sharded spatial axis moves the
    ``|s|``-deep boundary slab to the neighbour on that mesh ring
    (``collectives.ring_shift``, the collective permute the partitioner
    emits) and rebuilds the local block; DTensor's own rule would
    all-gather the rolled axis whole. On a mesh axis of one rank the roll
    is local.
  * The FFTs of the per-mode solve (``HelmholtzSolver``'s ``rfft2`` and
    ``irfft2``) run gathered: a ``torch.fft`` function of a sharded
    DTensor gathers the field on every rank (``collectives.
    all_gather_blocks``) and transforms it whole there; its result is
    replicated, so the inverse transform, the pin gauge's
    ``u - u[..., 0:1, 0:1]`` and the back-projection run on every rank
    without communication, and the step's output psi is resharded by
    taking the local block. A step gathers the two modal fields: each rank
    receives (n - 1) / n of 2 M P elements.
  * Constants (the solvers' symbols, the betas, the wind forcing) are
    plain tensors; the sharded step runs under DTensor's
    ``implicit_replication``, which reads each as replicated.

The rolls and transforms are intercepted by a ``TorchFunctionMode``
(``_GlobalArrayMode``) that the sharded step enters around the step. That
is public API, and scoped to the sharded step; DTensor's op-handler table
(``DTensor._op_dispatcher._custom_op_handlers``) is private and global to
every DTensor of the process. The mode acts only on DTensor arguments:
plain tensors pass through it unchanged, and the single-device route never
enters it.

Every collective is ``collectives.py``'s, on ``dist.all_to_all_single``:
DTensor's own all-gather is never asked for, so ranks that share one card
on gloo run this route as they run the halo route. There is no fallback: a
collective that a backend refuses raises.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.overrides import TorchFunctionMode

from ..config import ModelConfig
from ..models.core import State, make_step_fn
from .collectives import all_gather_blocks, ring_shift
from .mesh import Mesh, shard_state as block_state

SPATIAL = (Shard(1), Shard(2))      # (L, M, P): M over "x", P over "y"
REPLICATED = (Replicate(), Replicate())
_FIELDS = ("zeta", "psi", "f1", "f2")
# The torch.fft functions (those that take no tensor never see a DTensor).
_FFT_FUNCS = frozenset(getattr(torch.fft, name) for name in torch.fft.__all__
                       if name != "Tensor")


class Sharding(NamedTuple):
    """A field's layout: the DeviceMesh and one placement a mesh dim."""

    mesh: DeviceMesh
    placements: tuple


def state_sharding(mesh: Mesh) -> State:
    """The layout of each State field: the spatial (M, P) axes over the
    mesh's ("x", "y"), the layer axis replicated; ``step`` (a host int, the
    same on every rank) replicated."""
    dm = mesh.device_mesh
    spatial = Sharding(dm, SPATIAL)
    return State(spatial, spatial, spatial, spatial, Sharding(dm, REPLICATED))


def from_blocks(blocks: State, mesh: Mesh) -> State:
    """The DTensor state whose local shards are this rank's (L, m, p)
    blocks (no communication)."""
    dm = mesh.device_mesh
    nx, ny = mesh.shape

    def wrap(b: torch.Tensor) -> DTensor:
        L, m, p = b.shape
        return DTensor.from_local(b, dm, SPATIAL, run_check=False,
                                  shape=torch.Size((L, nx * m, ny * p)),
                                  stride=(nx * m * ny * p, ny * p, 1))

    return blocks._replace(**{f: wrap(getattr(blocks, f)) for f in _FIELDS})


def to_blocks(state: State) -> State:
    """This rank's blocks of a DTensor state (no communication)."""
    return state._replace(**{f: getattr(state, f).to_local()
                             for f in _FIELDS})


def shard_state(state: State, mesh: Mesh) -> State:
    """A full state as DTensors at ``state_sharding``: each rank keeps its
    own block of the full fields it holds, on the mesh's device."""
    return from_blocks(block_state(state, mesh), mesh)


def _check_grid(cfg: ModelConfig, mesh: Mesh) -> None:
    nx, ny = mesh.shape
    if cfg.M % nx or cfg.P % ny:
        raise ValueError(f"grid ({cfg.M}, {cfg.P}) does not divide over "
                         f"mesh {mesh.shape}")


class _GlobalArrayMode(TorchFunctionMode):
    """Runs ``torch.roll`` and the ``torch.fft`` functions of DTensors the
    way the module docstring says; everything else, and every call on
    plain tensors, as it is."""

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.mesh = mesh
        # Mesh dim -> (process group, this rank's index, ring size).
        self.rings = ((mesh.x_group, mesh.ix, mesh.shape[0]),
                      (mesh.y_group, mesh.iy, mesh.shape[1]))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if args and isinstance(args[0], DTensor):
            if func is torch.roll:
                return self._roll(*args, **kwargs)
            if func in _FFT_FUNCS:
                return self._fft(func, *args, **kwargs)
        return func(*args, **kwargs)

    def _roll(self, t: DTensor, shifts, dims=None) -> DTensor:
        if dims is None:
            raise ValueError("a roll of a sharded field needs its dims")
        if isinstance(shifts, int):
            shifts, dims = (shifts,), (dims,)
        for s, d in zip(shifts, dims):
            t = self._roll_axis(t, int(s), d % t.ndim)
        return t

    def _roll_axis(self, t: DTensor, s: int, d: int) -> DTensor:
        local = t.to_local()
        rings = [self.rings[i] for i, p in enumerate(t.placements)
                 if p.is_shard(d)]
        if not rings or rings[0][2] == 1 or s == 0:
            out = torch.roll(local, s, d)
        else:
            group, index, size = rings[0]
            k = abs(s)
            if k > local.shape[d]:
                raise ValueError(f"roll by {s} along an axis sharded in "
                                 f"blocks of {local.shape[d]}")
            if s > 0:
                # The last k rows of the previous block lead this block.
                slab = ring_shift(local.narrow(d, local.shape[d] - k, k),
                                  group, index, size, 1)
                out = torch.cat([slab, local.narrow(d, 0,
                                                    local.shape[d] - k)], d)
            else:
                # The first k rows of the next block close it.
                slab = ring_shift(local.narrow(d, 0, k), group, index, size,
                                  -1)
                out = torch.cat([local.narrow(d, k, local.shape[d] - k),
                                 slab], d)
        return DTensor.from_local(out, t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    def _gather(self, t: DTensor) -> torch.Tensor:
        """The whole array of ``t`` on this rank."""
        local = t.to_local()
        if all(p.is_replicate() for p in t.placements):
            return local
        if tuple(t.placements) != (Shard(t.ndim - 2), Shard(t.ndim - 1)):
            raise ValueError(f"no gather for placements {t.placements} of "
                             f"a {t.ndim}-d field")
        m, p = local.shape[-2:]
        full = all_gather_blocks(local.reshape(-1, m, p), self.mesh)
        return full.reshape(*local.shape[:-2], *full.shape[-2:])

    def _fft(self, func, t: DTensor, *args, **kwargs) -> DTensor:
        out = func(self._gather(t), *args, **kwargs)
        return DTensor.from_local(out, t.device_mesh, REPLICATED,
                                  run_check=False)


@contextlib.contextmanager
def sharded_ops(mesh: Mesh):
    """The context the sharded step runs in (``_GlobalArrayMode`` and
    ``implicit_replication``): code of the single-device step, or a part of
    it, runs on DTensors of ``mesh`` as the module docstring says."""
    with _GlobalArrayMode(mesh), implicit_replication():
        yield


def _reshard(state: State, sharding: State) -> State:
    """``state`` at ``sharding``: a replicated field keeps its local block
    (no communication)."""
    out = {}
    for f in _FIELDS:
        t, want = getattr(state, f), getattr(sharding, f)
        if not isinstance(t, DTensor):
            raise TypeError(f"the sharded step returned a plain {f}")
        out[f] = t.redistribute(want.mesh, want.placements)
    return state._replace(**out)


def make_sharded_step_fn(cfg: ModelConfig, mesh: Mesh, donate: bool = True):
    """The single-device step on the DTensor state (``shard_state``): the
    result is at ``state_sharding``, so the state stays sharded between
    steps. ``donate`` is accepted for ``tpu_qg``'s signature and has no
    effect (torch has no buffer donation; the step's old fields are freed
    when the caller drops them). Call on every rank."""
    del donate
    _check_grid(cfg, mesh)
    step = make_step_fn(cfg, batched_fft=False)
    sharding = state_sharding(mesh)

    def sharded_step(state: State) -> State:
        with sharded_ops(mesh):
            out = step(state)
        return _reshard(out, sharding)

    sharded_step.route = "gspmd"
    return sharded_step


def make_sharded_run_fn(cfg: ModelConfig, mesh: Mesh):
    """``run(state, n) -> state``: n sharded steps of a DTensor state (a
    host loop, the counterpart of ``tpu_qg``'s scan). Call on every rank."""
    step = make_sharded_step_fn(cfg, mesh)

    def run(state: State, n: int) -> State:
        for _ in range(n):
            state = step(state)
        return state

    run.route = "gspmd"
    return run

"""The (nx, ny) process mesh for 2-D spatial domain decomposition.

Counterpart of ``tpu_qg.parallel.mesh`` on ``torch.distributed``: one
process (rank) per mesh point, rank = ix * ny + iy (the row-major order in
which ``tpu_qg``'s ``make_mesh`` reshapes its devices), axis x sharding the
M rows and axis y the P columns. A ``Mesh`` holds this rank's coordinates,
the process groups of its x-ring (the ranks that share its iy), its y-ring
(those that share its ix) and the whole mesh, and the device its tensors
live on.

NCCL takes one device per rank; several ranks that share one card run on
gloo, which the caller names (``backend="gloo"``). Nothing switches to it.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .collectives import all_gather_blocks

# A collective of a group started here that waits longer has lost a rank.
PG_TIMEOUT = datetime.timedelta(seconds=300)


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (a, b) with a * b == n, a <= b."""
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return a, n // a


def preferred_mesh_shape(cfg, n: int) -> Tuple[int, int]:
    """(n, 1) where the fused sharded step takes that shape (rows sharded, y
    local: ``stepper.fused_shape_supported``), else the most-square split
    (tpu_qg/parallel/mesh.py:21-39)."""
    from .stepper import fused_shape_supported

    if (cfg is not None and cfg.use_pallas
            and fused_shape_supported(cfg, n, 1)):
        return (n, 1)
    return _factor2(n)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an (nx, ny) mesh (see the module docstring)."""

    shape: Tuple[int, int]
    ix: int
    iy: int
    x_group: object
    y_group: object
    group: object
    device: torch.device
    backend: str

    @property
    def rank(self) -> int:
        """Rank in the whole mesh: ix * ny + iy."""
        return self.ix * self.shape[1] + self.iy

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @functools.cached_property
    def device_mesh(self):
        """The (nx, ny) ``DeviceMesh`` over these ranks in this order, dims
        ("x", "y"), for the DTensor route (``gspmd``). Made at first use,
        which creates process groups: first use it on every rank, in the
        same order."""
        from torch.distributed.device_mesh import DeviceMesh

        ranks = torch.arange(self.size).reshape(self.shape)
        return DeviceMesh(self.device.type, ranks, mesh_dim_names=("x", "y"))


def check_nccl_devices(backend: str, devices: Sequence[str]) -> None:
    """NCCL runs one rank per device: raise ValueError when ``backend`` is
    NCCL and two ranks name the same device (``devices``: one "host:device"
    per rank)."""
    dup = sorted({d for d in devices if list(devices).count(d) > 1})
    if backend == "nccl" and dup:
        raise ValueError(
            f"NCCL needs one device per rank, but ranks share {dup}; run one "
            "rank per card, or pass backend='gloo' for ranks that share one")


def _default_device(device) -> torch.device:
    """``device`` as given, with a bare "cuda" meaning cuda:LOCAL_RANK."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return resolve_device(device)


def make_mesh(shape: Optional[Tuple[int, int]] = None, cfg=None,
              device="cuda", backend: Optional[str] = None) -> Mesh:
    """Build this rank's ``Mesh`` over every rank of the default group.

    The default group is the one the caller started, or one started here
    from ``torchrun``'s environment (``backend=None``: NCCL for CUDA, gloo
    for the CPU). ``shape=None`` takes (N, 1) where ``cfg``'s fused sharded
    step takes it, else the most-square split of the world size. ``device``
    defaults to cuda:LOCAL_RANK and raises without a GPU. Call on every
    rank, in the same order (it creates process groups)."""
    device = _default_device(device)
    want = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(want, timeout=PG_TIMEOUT)
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"backend {backend!r} asked for, but the process "
                         f"group runs {dist.get_backend()!r}")
    backend = dist.get_backend()
    world, rank = dist.get_world_size(), dist.get_rank()
    if shape is None:
        shape = preferred_mesh_shape(cfg, world) if cfg is not None \
            else _factor2(world)
    nx, ny = (int(v) for v in shape)
    if nx * ny != world:
        raise ValueError(f"mesh shape {(nx, ny)} needs {nx * ny} ranks, the "
                         f"process group has {world}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world > 1:
        # The device check runs on gloo: NCCL itself may fail first on a
        # shared device.
        names = [None] * world
        dist.all_gather_object(names, f"{socket.gethostname()}:{device}",
                               group=dist.new_group(backend="gloo"))
        check_nccl_devices(backend, names)
    ix, iy = divmod(rank, ny)
    x_group = y_group = None
    for j in range(ny):              # every rank creates every group
        g = dist.new_group([i * ny + j for i in range(nx)])
        if j == iy:
            x_group = g
    for i in range(nx):
        g = dist.new_group([i * ny + j for j in range(ny)])
        if i == ix:
            y_group = g
    return Mesh((nx, ny), ix, iy, x_group, y_group, dist.group.WORLD,
                device, backend)


def shard_state(state, mesh: Mesh):
    """This rank's (L, m, p) block of every field of a full state, moved to
    the mesh's device (the rank's rows [ix m, (ix + 1) m) and columns
    [iy p, (iy + 1) p))."""
    nx, ny = mesh.shape

    def block(a: torch.Tensor) -> torch.Tensor:
        L, M, P = a.shape
        if M % nx or P % ny:
            raise ValueError(f"grid ({M}, {P}) does not divide over mesh "
                             f"{mesh.shape}")
        m, p = M // nx, P // ny
        return a[:, mesh.ix * m:(mesh.ix + 1) * m,
                 mesh.iy * p:(mesh.iy + 1) * p].to(mesh.device).contiguous()

    return state._replace(zeta=block(state.zeta), psi=block(state.psi),
                          f1=block(state.f1), f2=block(state.f2))


def gather_state(state, mesh: Mesh, fields=("zeta", "psi", "f1", "f2")):
    """The full state on every rank from each rank's block (a collective:
    call on every rank); ``fields`` names the fields gathered, the others
    are left as they are."""
    return state._replace(**{f: all_gather_blocks(getattr(state, f), mesh)
                             for f in fields})

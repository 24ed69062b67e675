"""The mesh's collectives, all on one primitive, ``dist.all_to_all_single``.

Counterparts of ``lax.ppermute`` (a ring shift), ``lax.all_to_all`` with
``tiled=True``, an all-gather of row/column blocks and ``lax.psum`` (a sum
of the gathered values); ``lax.axis_index`` and ``lax.axis_size`` are the
``Mesh``'s coordinates and shape. Both
backends take ``all_to_all_single`` for their tensors (NCCL for CUDA ones;
gloo for CPU ones, and for CUDA ones through the host), so one code path
serves a mesh of cards and ranks that share one card or the CPU:

  * a ring shift is an uneven all-to-all whose only non-empty chunk goes to
    the neighbour (split sizes 0 except at the destination, and at the
    source on the receiving side);
  * a tiled all-to-all moves the split axis to the front, exchanges equal
    chunks, and folds the received chunks into the concat axis in rank
    order;
  * complex tensors travel as their real view (gloo takes no complex type).

There is no fallback: a collective that a backend refuses raises. Each
function can return its work unfinished (``async_op=True``): a ``Pending``
whose ``wait()`` returns the result.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist


class Pending:
    """A result that is ready once its collective has finished."""

    def __init__(self, work, finish: Callable[[], torch.Tensor]):
        self._work = work
        self._finish = finish

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._finish()


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _exchange(send: torch.Tensor, recv: torch.Tensor, group,
              recv_splits: Optional[list], send_splits: Optional[list],
              finish, async_op: bool):
    work = dist.all_to_all_single(_real(recv), _real(send), recv_splits,
                                  send_splits, group=group,
                                  async_op=async_op)
    pending = Pending(work if async_op else None, finish)
    return pending if async_op else pending.wait()


def ring_shift(t: torch.Tensor, group, index: int, size: int, shift: int,
               async_op: bool = False):
    """Send ``t`` to the rank ``shift`` steps along the ring (rank index +
    shift mod size in ``group``) and receive the tensor of the rank
    ``shift`` steps back (``lax.ppermute`` with pairs (i, i + shift))."""
    if size == 1:
        out = t.clone()
        return Pending(None, lambda: out) if async_op else out
    send = t.contiguous().reshape(-1)
    recv = torch.empty_like(send)
    n = send.numel()
    send_splits = [0] * size
    recv_splits = [0] * size
    send_splits[(index + shift) % size] = n
    recv_splits[(index - shift) % size] = n
    return _exchange(send, recv, group, recv_splits, send_splits,
                     lambda: recv.reshape(t.shape), async_op)


def all_to_all(t: torch.Tensor, group, size: int, split_dim: int,
               concat_dim: int, async_op: bool = False):
    """``lax.all_to_all(t, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)`` over ``group``: chunk j of ``split_dim`` goes to rank j,
    and the chunks received are concatenated along ``concat_dim`` in rank
    order."""
    if size == 1:
        return Pending(None, lambda: t) if async_op else t
    split_dim %= t.dim()
    concat_dim %= t.dim()
    if t.shape[split_dim] % size:
        raise ValueError(f"all_to_all: dimension {split_dim} of "
                         f"{tuple(t.shape)} does not split over {size} ranks")
    send = t.unflatten(split_dim, (size, -1)).movedim(split_dim,
                                                       0).contiguous()
    recv = torch.empty_like(send)

    def finish() -> torch.Tensor:
        # recv[j] is rank j's chunk, with split_dim shrunk: fold j into
        # concat_dim (j major).
        return recv.movedim(0, concat_dim).flatten(
            concat_dim, concat_dim + 1).contiguous()

    return _exchange(send, recv, group, None, None, finish, async_op)


def all_gather_blocks(block: torch.Tensor, mesh) -> torch.Tensor:
    """The full (L, M, P) field on every rank of ``mesh`` from each rank's
    (L, m, p) block: every rank sends its block to every rank."""
    nx, ny = mesh.shape
    n = nx * ny
    if n == 1:
        return block
    send = block.unsqueeze(0).expand(n, *block.shape).contiguous()
    recv = torch.empty_like(send)
    _exchange(send, recv, mesh.group, None, None, lambda: recv, False)
    L, m, p = block.shape
    # recv[ix * ny + iy] is block (ix, iy).
    return (recv.reshape(nx, ny, L, m, p).permute(2, 0, 3, 1, 4)
            .reshape(L, nx * m, ny * p))


def all_gather_scalars(values: torch.Tensor, mesh) -> torch.Tensor:
    """(n, k): every rank's (k,) vector ``values``, by mesh rank."""
    n = mesh.size
    if n == 1:
        return values.unsqueeze(0)
    send = values.unsqueeze(0).expand(n, *values.shape).contiguous()
    recv = torch.empty_like(send)
    _exchange(send, recv, mesh.group, None, None, lambda: recv, False)
    return recv


def all_reduce_sum(values: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every rank's ``values`` over ``mesh`` (``lax.psum`` over
    both axes), the same bits on every rank: each rank gathers every rank's
    values and adds them in rank order."""
    if mesh.size == 1:
        return values
    return all_gather_scalars(values.reshape(-1), mesh).sum(0).reshape(
        values.shape)

"""Halo exchange over the process mesh.

Counterpart of ``tpu_qg.parallel.halo`` (the distributed analog of the
reference's ghost-ring refresh, reference:
src/schemes/boundary_conditions.jl:1-13): each rank owns an (m, p) tile of
the global (M, P) grid and receives h-deep halo slabs from its four
neighbours by ring shifts, x first, then y on the x-padded block, which
fills the corner halos with the diagonal neighbours' data in two hops.
"""

from __future__ import annotations

import torch

from .collectives import ring_shift
from .mesh import Mesh


def make_padded_shift(h: int):
    """Shift primitive over an h-halo-padded block: shift(u, di, dj)[i, j] =
    u_interior[i+di, j+dj] (a slice, no data movement)."""
    def shift(u: torch.Tensor, di: int, dj: int) -> torch.Tensor:
        lo_x, hi_x = h + di, -(h - di) or None
        lo_y, hi_y = h + dj, -(h - dj) or None
        return u[..., lo_x:hi_x, lo_y:hi_y]
    return shift


def _pad_pair(u: torch.Tensor, h: int, dim: int, group, index: int,
              size: int, async_op: bool):
    """(from the previous rank, from the next rank) along ``dim``: the
    previous rank's last h rows and the next rank's first h rows (the
    block's own wrap rows on a ring of one)."""
    first = u.narrow(dim, 0, h)
    last = u.narrow(dim, u.shape[dim] - h, h)
    if size == 1:
        return last, first
    return (ring_shift(last, group, index, size, +1, async_op),
            ring_shift(first, group, index, size, -1, async_op))


class HaloExchange:
    """The two-phase exchange of one (..., m, p) block, begun at
    construction (its x phase in flight); ``wait()`` completes it and
    returns the (..., m + 2h, p + 2h) padded block."""

    def __init__(self, u: torch.Tensor, h: int, mesh: Mesh):
        self.u, self.h, self.mesh = u, h, mesh
        nx = mesh.shape[0]
        self._x = _pad_pair(u, h, -2, mesh.x_group, mesh.ix, nx, True)

    def wait(self) -> torch.Tensor:
        h, mesh = self.h, self.mesh
        from_prev, from_next = (p if isinstance(p, torch.Tensor) else p.wait()
                                for p in self._x)
        u = torch.cat([from_prev, self.u, from_next], dim=-2)
        down, up = _pad_pair(u, h, -1, mesh.y_group, mesh.iy, mesh.shape[1],
                             False)
        return torch.cat([down, u, up], dim=-1)


def exchange_halo(u: torch.Tensor, h: int, mesh: Mesh) -> torch.Tensor:
    """Pad a local (..., m, p) block to (..., m + 2h, p + 2h) with its
    neighbours' halos (blocking)."""
    return HaloExchange(u, h, mesh).wait()

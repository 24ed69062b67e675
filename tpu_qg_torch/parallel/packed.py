"""Distributed packed modal inversion on the DFT kernels.

Counterpart of ``tpu_qg.parallel.packed``: the two-layer zeta -> psi
inversion of an (nx, 1) mesh's (2, m, P) row blocks (m = M/nx, y complete)
as local kernel passes and all-to-all transposes over the x-ring:

  1. forward-y locally (K2);
  2. the mirror companion, built locally while y is complete: strip j of
     it holds strip (n2y - j) mod n2y of the y-spectrum;
  3. one all-to-all of both (stacked on the plane axis) over the x-ring:
     (4, m, P) -> (4, M, P/nx) column blocks of whole 128-column strips;
  4. K13: forward-x of the block and its companion, the symbols at the
     global strip offset ix * P/(128 nx), inverse-x;
  5. the all-to-all back and inverse-y locally (K2^-1).

nx == 1 is the single-device x-stage exactly (no companion, no
transposes): K3 where the reference's pair-x route runs, else K4 + K5.
``overlap_groups`` G > 1 cuts the columns into G chunks whose all-to-alls
are all issued asynchronously before chunk 0's K13 runs, so chunk g+1's
transpose is in flight behind chunk g's kernel; same values per point.

``DistributedPackedInverter2D`` runs the same x-stage on an (nx, ny) mesh
over the flattened (x, y) ranks, bracketed by a y-gather transpose over the
y-ring so that the y-kernels see whole rows.

The shape gates are the reference's, copied to choose its route; the
kernels take every shape they admit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dft_kernels import (STRIP, pair_x_symbols, x_dft,
                               x_fwd_symbols_offset, x_symbols_inverse, y_dft)
from ..ops.spectral import (PackedModalInverter, reference_pair_x,
                            reference_planar_fft2, reference_stream_pair,
                            reference_symbol_inverse_fits,
                            reference_x_blockspec, symbol_consts)
from .collectives import all_to_all
from .mesh import Mesh


def _x_stage_fits(M: int) -> bool:
    """The reference's x-stage kernel (BlockSpec or streaming) fits."""
    if reference_x_blockspec(M):
        return reference_symbol_inverse_fits(M)
    return reference_stream_pair(M)


def distributed_packed_supported(M: int, P: int, nx: int,
                                 itemsize: int = 4) -> bool:
    """float32, extents the DFT kernels take, rows dividing into 8-aligned
    blocks, P splitting into whole 128-column strips per rank
    (tpu_qg/parallel/packed.py:56-79)."""
    if itemsize != 4 or M % nx != 0 or P % (nx * STRIP) != 0:
        return False
    if (M // nx) % 8 != 0 or not reference_planar_fft2(M, P):
        return False
    return _x_stage_fits(M)


def distributed_packed_2d_supported(M: int, P: int, nx: int, ny: int,
                                    itemsize: int = 4) -> bool:
    """The 2-D form's gate (tpu_qg/parallel/packed.py:189-211): the y-gather
    needs M % (nx ny) == 0 with 8-aligned gathered rows, the flattened
    transpose P % (nx ny 128) == 0."""
    n = nx * ny
    if itemsize != 4 or M % n != 0 or P % (n * STRIP) != 0 or P % ny != 0:
        return False
    if (M // n) % 8 != 0 or not reference_planar_fft2(M, P):
        return False
    return _x_stage_fits(M)


def single_device_x_stage(inv, Zy: torch.Tensor) -> torch.Tensor:
    """The one-rank x-stage (tpu_qg/parallel/packed.py:133-138): K3 where
    the reference's pair-x kernel runs, else K4 then K5."""
    if reference_pair_x(inv.M, inv.P):
        return pair_x_symbols(Zy, inv._sym_consts)
    return x_symbols_inverse(x_dft(Zy, False), inv._sym_consts)


class DistributedPackedInverter(PackedModalInverter):
    """Sharded zeta -> psi packed inversion (see the module docstring).
    ``__call__`` takes this rank's (2, m, P) row block of zeta and returns
    the matching block of psi. ``group``/``index``/``size`` are the ring the
    transposes run over (default: the mesh's x-ring)."""

    def __init__(self, M: int, P: int, dx: float, alpha2: float, P_inv,
                 P_back, mesh: Mesh, overlap_groups: int = 1, group=None,
                 index: int = None, size: int = None):
        super().__init__(M, P, dx, alpha2, P_inv, P_back)
        self.mesh = mesh
        self.group = mesh.x_group if group is None else group
        self.index = mesh.ix if index is None else index
        self.size = mesh.shape[0] if size is None else size
        self.overlap_groups = overlap_groups
        self._sym_consts = symbol_consts(M, P, dx, alpha2, P_inv, P_back)
        n2y = P // STRIP
        self._mirror_perm = (-np.arange(n2y)) % n2y
        self._perm = {}

    def _companion(self, Zy: torch.Tensor) -> torch.Tensor:
        """The mirror companion of a y-complete (2, rows, P) block."""
        if Zy.device not in self._perm:
            self._perm[Zy.device] = torch.as_tensor(self._mirror_perm,
                                                    device=Zy.device)
        perm = self._perm[Zy.device]
        return Zy.unflatten(2, (len(self._mirror_perm), STRIP))[:, :, perm] \
            .flatten(2)

    def x_stage(self, Zy: torch.Tensor) -> torch.Tensor:
        """y-spectral (2, m, P) row block -> the inversion up to its final
        inverse-y (the sharded chain's step consumes this directly)."""
        nx = self.size
        if nx == 1:
            return single_device_x_stage(self, Zy)
        both = torch.cat([Zy, self._companion(Zy)])          # (4, m, P)
        G = self.overlap_groups
        if G <= 1:
            both = all_to_all(both, self.group, nx, 2, 1)     # (4, M, P/nx)
            off = self.index * (both.shape[2] // STRIP)
            V = x_fwd_symbols_offset(both[:2].contiguous(),
                                     both[2:].contiguous(), self._sym_consts,
                                     off)
            return all_to_all(V, self.group, nx, 1, 2)        # (2, m, P)
        n2y = self.P // STRIP
        if n2y % (G * nx):
            raise ValueError(f"overlap_groups={G} needs P % (G * nx * 128) "
                             "== 0")
        S = n2y // G                      # global strips per chunk
        w = S * STRIP
        sent = [all_to_all(both[:, :, g * w:(g + 1) * w], self.group, nx, 2,
                           1, async_op=True) for g in range(G)]
        back = []
        for g, pending in enumerate(sent):
            chunk = pending.wait()                            # (4, M, w/nx)
            Vg = x_fwd_symbols_offset(chunk[:2].contiguous(),
                                      chunk[2:].contiguous(),
                                      self._sym_consts,
                                      g * S + self.index * (S // nx))
            back.append(all_to_all(Vg, self.group, nx, 1, 2, async_op=True))
        return torch.cat([b.wait() for b in back], dim=2)

    def __call__(self, zeta: torch.Tensor) -> torch.Tensor:
        Zy = y_dft(zeta, False)
        return y_dft(self.x_stage(Zy), True).to(zeta.dtype)


class DistributedPackedInverter2D(DistributedPackedInverter):
    """The packed inversion on an (nx, ny) mesh's (2, m, p) tiles: a y-gather
    over the y-ring, the x-stage over the flattened (x, y) ranks (the
    transposed row order is the mesh rank order), and the inverse y-gather
    (tpu_qg/parallel/packed.py:214-248)."""

    def __init__(self, M: int, P: int, dx: float, alpha2: float, P_inv,
                 P_back, mesh: Mesh):
        super().__init__(M, P, dx, alpha2, P_inv, P_back, mesh,
                         group=mesh.group, index=mesh.rank, size=mesh.size)

    def __call__(self, zeta: torch.Tensor) -> torch.Tensor:
        ny = self.mesh.shape[1]
        z = all_to_all(zeta, self.mesh.y_group, ny, 1, 2)    # (2, m/ny, P)
        u = y_dft(self.x_stage(y_dft(z, False)), True).to(zeta.dtype)
        return all_to_all(u, self.mesh.y_group, ny, 2, 1)    # (2, m, p)

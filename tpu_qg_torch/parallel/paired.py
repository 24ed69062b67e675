"""Paired-strip distributed packed inversion: no mirror companion.

Counterpart of ``tpu_qg.parallel.paired``: a local permutation of the
128-column strips orders them as mirror pairs

    [0, n2y/2 | 1, n2y-1 | 2, n2y-2 | ...]

so the all-to-all hands each rank whole pair groups, and K14 pairs the
strips locally as K3 does, with the global strip indices it needs for the
symbols: each strip is forward-transformed once, and the transposes carry
2 planes out and 2 back (the companion scheme of ``packed`` 4 and 2).
Group 0 holds the two strips that are their own mirrors (0 and n2y/2).
Needs P % (nx * 256) == 0 on top of the packed scheme's divisibility.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dft_kernels import STRIP, paired_x_symbols, y_dft
from ..ops.spectral import (_N1, _VMEM_TARGET, PackedModalInverter,
                            reference_planar_fft2, reference_x_blockspec,
                            symbol_consts)
from .collectives import all_to_all
from .mesh import Mesh
from .packed import single_device_x_stage


def strip_pair_order(n2y: int) -> np.ndarray:
    """Permuted strip order grouping mirrors: [0, n2y/2, 1, n2y-1, 2,
    n2y-2, ...] (n2y even). Positions 2g and 2g+1 hold group g's strips."""
    if n2y % 2:
        raise ValueError(f"strip_pair_order needs an even strip count, got "
                         f"{n2y}")
    order = [0, n2y // 2]
    for j in range(1, n2y // 2):
        order += [j, n2y - j]
    return np.asarray(order)


def paired_supported(M: int, P: int, nx: int, itemsize: int = 4) -> bool:
    """The reference's gate (tpu_qg/parallel/paired.py:61-80): the packed
    divisibility plus whole pairs per rank (P % (nx * 256) == 0) and its
    BlockSpec kernel form. Its streaming form (M = 8192) stays gated off on
    its TPU evidence, so 8192^2 meshes take the companion scheme."""
    if itemsize != 4 or M % nx != 0 or P % (nx * 2 * STRIP) != 0:
        return False
    if (M // nx) % 8 != 0 or not reference_planar_fft2(M, P):
        return False
    if not reference_x_blockspec(M):
        return False
    strip = 2 * M * _N1 * 4
    g_plane = (M // _N1) * _N1 * _N1 * 4
    return 16 * strip + 8 * g_plane <= _VMEM_TARGET


class PairedDistributedInverter(PackedModalInverter):
    """Sharded zeta -> psi inversion shipping mirror pairs instead of a
    companion (see the module docstring); call on an (nx, 1) mesh."""

    def __init__(self, M: int, P: int, dx: float, alpha2: float, P_inv,
                 P_back, mesh: Mesh):
        super().__init__(M, P, dx, alpha2, P_inv, P_back)
        self.mesh = mesh
        self._sym_consts = symbol_consts(M, P, dx, alpha2, P_inv, P_back)
        self._order = strip_pair_order(P // STRIP)
        self._inv_order = np.argsort(self._order)
        self._perm = {}

    def _permute(self, Z: torch.Tensor, order: np.ndarray) -> torch.Tensor:
        key = (Z.device, order is self._order)
        if key not in self._perm:
            self._perm[key] = torch.as_tensor(order, device=Z.device)
        n2y = len(order)
        return Z.unflatten(2, (n2y, STRIP))[:, :, self._perm[key]].flatten(2)

    def x_stage(self, Zy: torch.Tensor) -> torch.Tensor:
        nx, k = self.mesh.shape[0], self.mesh.ix
        if nx == 1:
            return single_device_x_stage(self, Zy)
        group = self.mesh.x_group
        X = all_to_all(self._permute(Zy, self._order), group, nx, 2, 1)
        strips = X.shape[2] // STRIP
        V = paired_x_symbols(X, self._order[k * strips:(k + 1) * strips],
                             self._sym_consts)
        V = all_to_all(V, group, nx, 1, 2)                # pair order
        return self._permute(V, self._inv_order)

    def __call__(self, zeta: torch.Tensor) -> torch.Tensor:
        return y_dft(self.x_stage(y_dft(zeta, False)), True).to(zeta.dtype)

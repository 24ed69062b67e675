"""Ghost-ring utilities for reference-format interoperability.

Counterpart of ``tpu_qg.ops.boundary`` on tensors. The compute path stores
interior-only (M, P) fields (periodicity via circular shifts and halo
exchange), so these helpers exist purely for I/O parity and for validating
against the reference's (M+2)x(P+2) ghost-ring layout
(reference: src/schemes/boundary_conditions.jl:1-22).
"""

from __future__ import annotations

import torch


def add_ghost_ring(u: torch.Tensor) -> torch.Tensor:
    """Embed an interior (..., M, P) tensor into (..., M+2, P+2) with periodic
    ghost cells (reference: src/schemes/boundary_conditions.jl:15-22,
    ``add_doubly_periodic_boundaries``)."""
    u = torch.cat([u[..., -1:, :], u, u[..., :1, :]], dim=-2)
    return torch.cat([u[..., -1:], u, u[..., :1]], dim=-1)


def strip_ghost_ring(u: torch.Tensor) -> torch.Tensor:
    """Drop the one-cell ghost ring: (..., M+2, P+2) -> (..., M, P)."""
    return u[..., 1:-1, 1:-1]


def update_ghost_ring(u: torch.Tensor) -> torch.Tensor:
    """Refresh the ghost ring of an (..., M+2, P+2) tensor from its interior
    (functional analog of the reference's in-place
    ``update_doubly_periodic_bc!``, src/schemes/boundary_conditions.jl:1-13)."""
    return add_ghost_ring(strip_ghost_ring(u))

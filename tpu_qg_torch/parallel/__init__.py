"""Parallel layer: the process mesh, sharded stepping, halo exchange.

Counterpart of ``tpu_qg.parallel`` on ``torch.distributed``: 2-D spatial
domain decomposition of the (M, P) grid over an (nx, ny) mesh of ranks, by
explicit halo exchange and the transposed distributed FFT (the "halo"
implementation; ``tpu_qg``'s "gspmd" form is not ported). One rank per
card on NCCL, or several ranks on one card or the CPU on gloo.
"""

from .mesh import Mesh, gather_state, make_mesh, shard_state  # noqa: F401
from .stepper import make_halo_run_fn, make_halo_step_fn  # noqa: F401

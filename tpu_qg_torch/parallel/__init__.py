"""Parallel layer: the process mesh, sharded stepping, halo exchange.

Counterpart of ``tpu_qg.parallel`` on ``torch.distributed``: 2-D spatial
domain decomposition of the (M, P) grid over an (nx, ny) mesh of ranks,
with two implementations:

  * ``halo``  — explicit halo exchange and the transposed distributed FFT
    (``stepper``), the kernels' route;
  * ``gspmd`` — the single-device step on DTensors of the global fields
    (``gspmd``): the stencils' rolls move boundary slabs, the per-mode
    solve gathers its fields; no kernel.

One rank per card on NCCL, or several ranks on one card or the CPU on gloo.
``shard_state`` here is the halo route's: this rank's blocks of a full
state (``gspmd.shard_state`` makes the DTensor state).
"""

from .gspmd import make_sharded_step_fn  # noqa: F401
from .mesh import Mesh, gather_state, make_mesh, shard_state  # noqa: F401
from .stepper import make_halo_run_fn, make_halo_step_fn  # noqa: F401

"""The device an entry point runs on.

Every entry point (``QGModel``, ``run_model``, ``RunReader.load_checkpoint``,
``solve_helmholtz_fn``, the command line) defaults to ``"cuda"`` and raises
when no GPU is present instead of running on the CPU; a caller that wants
the CPU passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device that is not there is an
    error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no GPU is available; "
                           "pass device='cpu' (--device cpu) to run on the CPU")
    return device

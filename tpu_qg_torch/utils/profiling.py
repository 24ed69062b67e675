"""Profiling and tracing hooks.

Counterpart of ``tpu_qg.utils.profiling``:

  * ``sync(x)``          — waits until the device that holds ``x`` is done.
  * ``trace(log_dir)``   — context manager over ``torch.profiler`` (CPU and
    CUDA activities) that writes a Chrome trace of the wrapped region into
    ``log_dir``.
  * ``Timer``            — named wall-clock sections, each ended by ``sync``
    of its result.
  * ``roofline_report``  — a step's time against the least time the card's
    memory bandwidth allows for the step's minimal traffic.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

# Peak device-memory bandwidth (bytes/s) by the exact name
# torch.cuda.get_device_name gives: the spec-sheet figure of the H100 SXM
# at 700 W. A card that is not listed has no figure.
HBM_BANDWIDTH: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def sync(x) -> None:
    """Wait for the work that produces ``x``: ``torch.cuda.synchronize`` on
    its card; a CPU tensor (or a non-tensor) is already done."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region with ``torch.profiler`` (CPU, and CUDA
    when a card is present) and write its Chrome trace (open it in
    Perfetto or chrome://tracing) to ``log_dir/trace.json``. Yields the
    profiler, whose ``key_averages()`` summarise the region."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Named wall-clock sections with forced completion."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            sync(result)
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [f"{k:>24s}: {v:.4f} s ({100 * v / total:5.1f}%)"
                 for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)


def _card_name(device) -> str:
    """The card name of a ``torch.device`` (or its string), or ``device``
    itself where it is a name."""
    if isinstance(device, str):
        try:
            device = torch.device(device)
        except RuntimeError:
            return device
    if device.type != "cuda":
        raise ValueError(f"no memory bandwidth for device {device}")
    return torch.cuda.get_device_name(device)


def roofline_report(cfg, step_seconds: float, device=None) -> Dict[str, float]:
    """How close one model step is to the device-memory light speed.

    The step's minimal traffic (tpu_qg/utils/profiling.py:72-95): read
    zeta, psi, f1 and f2 and write zeta, psi and f1 (7 arrays of L layers),
    plus ~6 array passes for the two spectral transforms. ``device`` is a
    ``torch.device`` (default: the current CUDA device) or a card name; a
    card without an entry in ``HBM_BANDWIDTH`` raises ``ValueError``."""
    name = _card_name("cuda" if device is None else device)
    if name not in HBM_BANDWIDTH:
        raise ValueError(f"no memory bandwidth for device {name!r} "
                         f"(known: {sorted(HBM_BANDWIDTH)})")
    bw = HBM_BANDWIDTH[name]
    itemsize = getattr(torch, cfg.dtype).itemsize
    array_bytes = cfg.n_layers * cfg.M * cfg.P * itemsize
    min_bytes = (7 + 6) * array_bytes
    light_speed_s = min_bytes / bw
    return {
        "step_seconds": step_seconds,
        "estimated_min_bytes": float(min_bytes),
        "hbm_bandwidth": bw,
        "light_speed_seconds": light_speed_s,
        "fraction_of_light_speed": light_speed_s / step_seconds,
    }

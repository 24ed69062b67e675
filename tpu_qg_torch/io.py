"""Snapshot / checkpoint / metadata I/O (the gathered, single-writer form).

Counterpart of ``tpu_qg.io``: a run is a directory of npz files plus
``metadata.json``. Snapshots keep the reference's ``{field}_{step}`` keys;
checkpoints hold ``zeta``, ``psi``, ``f1``, ``f2`` and ``step`` for an exact
resume. The file names and keys are ``tpu_qg``'s, so a checkpoint written
by either package resumes in the other.

Every file is written to a temporary name in the run directory and moved
into place with ``os.replace``, so a reader never sees a partial file.
The sharded forms wait for the parallel layer.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .config import ModelConfig
from .constants import DAY
from .device import resolve_device
from .models.core import State

PathLike = Union[str, pathlib.Path]


def create_metadata(cfg: ModelConfig, sample_interval: float = 1.0 * DAY) -> Dict:
    """Run metadata (reference: src/run_model.jl:6-20, ``create_metadata``)."""
    return {
        "dt": cfg.dt,
        "T": cfg.T,
        "sample_interval": sample_interval,
        "sample_timestep": int(sample_interval // cfg.dt),
        "total_steps": cfg.total_steps,
        "config": dataclasses.asdict(cfg),
    }


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _atomic_write(path: pathlib.Path, write) -> None:
    """Call ``write(file)`` on a temporary file beside ``path``, then move it
    into place."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as fh:
            write(fh)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


class RunWriter:
    """Streams snapshots and checkpoints of a run to a directory."""

    def __init__(self, run_dir: PathLike, cfg: ModelConfig,
                 sample_interval: float = 1.0 * DAY,
                 write_metadata: bool = True):
        self.dir = pathlib.Path(run_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        if write_metadata:
            text = json.dumps(create_metadata(cfg, sample_interval), indent=2)
            _atomic_write(self.dir / "metadata.json",
                          lambda fh: fh.write(text.encode()))

    def write_snapshot(self, step: int, zeta, psi) -> None:
        """Save the prognostic fields at a step under reference-parity keys
        (reference: src/run_model.jl:87-90)."""
        arrays = {f"zeta_{step}": _host(zeta), f"psi_{step}": _host(psi)}
        _atomic_write(self.dir / f"snap_{step:09d}.npz",
                      lambda fh: np.savez(fh, **arrays))

    def write_checkpoint(self, state: State) -> None:
        """Full-state checkpoint (zeta, psi, history, step) for exact resume."""
        step = int(state.step)
        arrays = {"zeta": _host(state.zeta), "psi": _host(state.psi),
                  "f1": _host(state.f1), "f2": _host(state.f2),
                  "step": np.asarray(step)}
        _atomic_write(self.dir / f"checkpoint_{step:09d}.npz",
                      lambda fh: np.savez(fh, **arrays))


class RunReader:
    """Reads a run directory written by either package."""

    def __init__(self, run_dir: PathLike):
        self.dir = pathlib.Path(run_dir)
        self.metadata = json.loads((self.dir / "metadata.json").read_text())

    def _steps(self, kind: str) -> List[int]:
        steps = set()
        for p in self.dir.glob(f"{kind}_*.npz"):
            try:
                steps.add(int(p.stem.split("_")[1]))
            except ValueError:   # a sharded file: not read by this form
                pass
        return sorted(steps)

    def snapshot_steps(self) -> List[int]:
        return self._steps("snap")

    def checkpoint_steps(self) -> List[int]:
        return self._steps("checkpoint")

    def load_snapshot(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        with np.load(self.dir / f"snap_{step:09d}.npz") as z:
            return z[f"zeta_{step}"], z[f"psi_{step}"]

    def load_checkpoint(self, step: Optional[int] = None,
                        device: torch.device | str = "cuda") -> State:
        """Load a full-state checkpoint (latest by default) onto ``device``
        (the GPU unless the CPU is asked for)."""
        device = resolve_device(device)
        steps = self.checkpoint_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = steps[-1] if step is None else step
        with np.load(self.dir / f"checkpoint_{step:09d}.npz") as z:
            fields = {k: z[k] for k in ("zeta", "psi", "f1", "f2", "step")}
        return State(*(torch.from_numpy(fields[k]).to(device)
                       for k in ("zeta", "psi", "f1", "f2")),
                     int(fields["step"]))

    def config(self) -> ModelConfig:
        return ModelConfig(**dict(self.metadata["config"]))

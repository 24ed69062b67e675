"""Snapshot / checkpoint / metadata I/O (the gathered, single-writer form).

Counterpart of ``tpu_qg.io``: a run is a directory of npz files plus
``metadata.json``. Snapshots keep the reference's ``{field}_{step}`` keys;
checkpoints hold ``zeta``, ``psi``, ``f1``, ``f2`` and ``step`` for an exact
resume. The file names and keys are ``tpu_qg``'s, so a checkpoint written
by either package resumes in the other.

Every file is written to a temporary name in the run directory and moved
into place with ``os.replace``, so a reader never sees a partial file.
``RunReader`` reads ``tpu_qg``'s shard files too, and assembles a shard set
only when it covers every field exactly once (``tpu_qg``'s reader fills what
its shards cover and leaves the rest unset); writing them is not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .config import ModelConfig
from .constants import DAY
from .device import resolve_device
from .models.core import State

PathLike = Union[str, pathlib.Path]

# tpu_qg's shard files: {kind}_{step:09d}-shard{process:05d}.npz.
_SHARD_RE = re.compile(r"^(snap|checkpoint)_(\d+)-shard(\d+)$")


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
    """Reads a run directory written by either package: monolithic files,
    and the shard sets ``tpu_qg`` writes on a mesh (one
    ``{kind}_{step:09d}-shard{process:05d}.npz`` per process, with an
    ``.index.json`` beside it that places each shard in its field)."""

    def __init__(self, run_dir: PathLike):
        self.dir = pathlib.Path(run_dir)
        self.metadata = json.loads((self.dir / "metadata.json").read_text())

    def _steps(self, kind: str) -> List[int]:
        """Every step with a monolithic file or a shard file."""
        steps = set()
        for p in self.dir.glob(f"{kind}_*.npz"):
            m = _SHARD_RE.match(p.stem)
            if m:
                steps.add(int(m.group(2)))
            else:
                try:
                    steps.add(int(p.stem.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def snapshot_steps(self) -> List[int]:
        return self._steps("snap")

    def checkpoint_steps(self) -> List[int]:
        return self._steps("checkpoint")

    def _assemble_sharded(self, kind: str, step: int,
                          names: Tuple[str, ...]) -> Dict[str, np.ndarray]:
        """The fields ``names`` of a step's shard set, each assembled from
        the shards its index files place; raises ``ValueError`` unless the
        shards cover every element of every field exactly once."""
        files = sorted(self.dir.glob(f"{kind}_{step:09d}-shard*.npz"))
        if not files:
            raise FileNotFoundError(f"no {kind} file for step {step} in "
                                    f"{self.dir}")
        def fault(name, what):
            return ValueError(f"{kind} shards of step {step} in {self.dir}: "
                              f"field {name!r} {what}")

        out: Dict[str, np.ndarray] = {}
        covered: Dict[str, np.ndarray] = {}
        for path in files:
            index = json.loads(path.with_suffix(".index.json").read_text())
            with np.load(path) as z:
                for key, meta in index["shards"].items():
                    name = meta["field"]
                    if name not in out:
                        f = index["fields"][name]
                        shape = tuple(f["shape"])
                        out[name] = np.zeros(shape, np.dtype(f["dtype"]))
                        covered[name] = np.zeros(shape, bool)
                    sl = tuple(slice(a, b) for a, b in meta["index"])
                    if z[key].shape != out[name][sl].shape:
                        raise fault(name, f"has shard {key} of shape "
                                          f"{z[key].shape} in {path.name}, "
                                          f"placed at {meta['index']}")
                    if covered[name][sl].any():
                        raise fault(name, "has elements in two shards")
                    out[name][sl] = z[key]
                    covered[name][sl] = True
        for name in names:
            if name not in covered or not covered[name].all():
                raise fault(name, "has elements in no shard")
        return {name: out[name] for name in names}

    def load_snapshot(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        mono = self.dir / f"snap_{step:09d}.npz"
        if mono.exists():
            with np.load(mono) as z:
                return z[f"zeta_{step}"], z[f"psi_{step}"]
        fields = self._assemble_sharded("snap", step, ("zeta", "psi"))
        return fields["zeta"], fields["psi"]

    def load_checkpoint(self, step: Optional[int] = None,
                        device: torch.device | str = "cuda") -> State:
        """Load a full-state checkpoint (latest by default) onto ``device``
        (the GPU unless the CPU is asked for); a shard set is assembled on
        the host first."""
        device = resolve_device(device)
        steps = self.checkpoint_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = steps[-1] if step is None else step
        names = ("zeta", "psi", "f1", "f2")
        mono = self.dir / f"checkpoint_{step:09d}.npz"
        if mono.exists():
            with np.load(mono) as z:
                fields = {k: z[k] for k in names + ("step",)}
        else:
            fields = self._assemble_sharded("checkpoint", step, names)
            fields["step"] = step
        return State(*(torch.from_numpy(fields[k]).to(device) for k in names),
                     int(fields["step"]))

    def config(self) -> ModelConfig:
        return ModelConfig(**dict(self.metadata["config"]))

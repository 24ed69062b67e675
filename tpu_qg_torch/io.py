"""Snapshot / checkpoint / metadata I/O.

Counterpart of ``tpu_qg.io``: a run is a directory of npz files plus
``metadata.json``. Snapshots keep the reference's ``{field}_{step}`` keys;
checkpoints hold ``zeta``, ``psi``, ``f1``, ``f2`` and ``step`` for an exact
resume. The file names and keys are ``tpu_qg``'s, so a checkpoint written
by either package resumes in the other.

Two forms: monolithic files of whole fields (the gathered, single-writer
form), and shard sets, in which every rank of a mesh writes its own blocks
to ``{kind}_{step:09d}-shard{rank:05d}.npz`` with an ``.index.json`` beside
it that places each block in its field (``tpu_qg``'s layout,
``tpu_qg/io.py:98-150``). Every file is written to a temporary name in the
run directory and moved into place with ``os.replace``, a shard's npz
before its index, so a reader never sees a partial file. ``RunReader``
assembles a shard set only when it covers every field exactly once
(``tpu_qg``'s reader fills what its shards cover and leaves the rest
unset).
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

    def _write_sharded(self, kind: str, step: int, fields: Dict,
                       mesh=None) -> None:
        """Write this rank's blocks of ``fields`` to its shard file and the
        index beside it. Every rank of ``mesh`` calls this (each writes only
        its own file; nothing is gathered). With no mesh the one file holds
        one whole shard of each field. Keys are ``{field}_{step}_shard0``:
        one shard a rank, as ``tpu_qg`` keys a process's one device."""
        rank = 0 if mesh is None else mesh.rank
        path = self.dir / f"{kind}_{step:09d}-shard{rank:05d}.npz"
        arrays: Dict[str, np.ndarray] = {}
        index: Dict = {"step": step, "process": rank, "fields": {},
                       "shards": {}}
        for name, block in fields.items():
            block = _host(block)
            L, m, p = block.shape
            if mesh is None:
                shape, at = block.shape, [[0, L], [0, m], [0, p]]
            else:
                nx, ny = mesh.shape
                shape = (L, nx * m, ny * p)
                at = [[0, L], [mesh.ix * m, (mesh.ix + 1) * m],
                      [mesh.iy * p, (mesh.iy + 1) * p]]
            index["fields"][name] = {"shape": list(shape),
                                     "dtype": str(block.dtype)}
            key = f"{name}_{step}_shard0"
            arrays[key] = block
            index["shards"][key] = {"field": name, "index": at}
        _atomic_write(path, lambda fh: np.savez(fh, **arrays))
        text = json.dumps(index)
        _atomic_write(path.with_suffix(".index.json"),
                      lambda fh: fh.write(text.encode()))

    def write_checkpoint_sharded(self, state: State, mesh=None) -> None:
        """This rank's shard file of a full-state checkpoint (its blocks of
        zeta, psi, f1, f2): no field is gathered. Every rank calls it."""
        self._write_sharded("checkpoint", int(state.step), {
            "zeta": state.zeta, "psi": state.psi, "f1": state.f1,
            "f2": state.f2}, mesh)

    def write_snapshot_sharded(self, step: int, zeta, psi,
                               mesh=None) -> None:
        """This rank's shard file of a snapshot of zeta and psi."""
        self._write_sharded("snap", int(step), {"zeta": zeta, "psi": psi},
                            mesh)


class RunReader:
    """Reads a run directory written by either package: monolithic files,
    and the shard sets written on a mesh (one
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

    def shard_files(self, kind: str, step: int) -> List[pathlib.Path]:
        """The shard files of a step (none for a monolithic one)."""
        return sorted(self.dir.glob(f"{kind}_{step:09d}-shard*.npz"))

    def _assemble_sharded(self, kind: str, step: int,
                          names: Tuple[str, ...]) -> Dict[str, np.ndarray]:
        """The fields ``names`` of a step's shard set, each assembled from
        the shards its index files place; raises ``ValueError`` unless the
        shards cover every element of every field exactly once."""
        files = self.shard_files(kind, step)
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

    def load_checkpoint_sharded(self, mesh, step: Optional[int] = None) -> State:
        """This rank's blocks of a checkpoint (latest by default) on the
        mesh's device, for an exact resume on ``mesh``
        (``tpu_qg/io.py:240-308``). Where a shard file's index places
        exactly this rank's block of a field (a set written on a mesh of
        the same shape), only that file is read; otherwise the field is
        assembled from the whole set (``_assemble_sharded``'s exact cover)
        and sliced. With no shard set, the monolithic checkpoint is loaded
        and sharded."""
        from .parallel.mesh import shard_state

        steps = self.checkpoint_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = steps[-1] if step is None else step
        files = self.shard_files("checkpoint", step)
        if not files:
            return shard_state(self.load_checkpoint(step, device="cpu"),
                               mesh)
        names = ("zeta", "psi", "f1", "f2")
        shapes: Dict[str, Tuple[int, ...]] = {}
        where: Dict[Tuple, Tuple[pathlib.Path, str]] = {}
        for path in files:
            index = json.loads(path.with_suffix(".index.json").read_text())
            for name, f in index["fields"].items():
                shapes[name] = tuple(f["shape"])
            for key, meta in index["shards"].items():
                at = tuple(tuple(se) for se in meta["index"])
                where[(meta["field"], at)] = (path, key)
        nx, ny = mesh.shape
        blocks: Dict[str, np.ndarray] = {}
        assembled: Dict[str, np.ndarray] = {}
        opened: Dict[pathlib.Path, np.lib.npyio.NpzFile] = {}
        try:
            for name in names:
                L, M, P = shapes[name]
                if M % nx or P % ny:
                    raise ValueError(f"grid ({M}, {P}) does not divide over "
                                     f"mesh {mesh.shape}")
                m, p = M // nx, P // ny
                at = ((0, L), (mesh.ix * m, (mesh.ix + 1) * m),
                      (mesh.iy * p, (mesh.iy + 1) * p))
                hit = where.get((name, at))
                if hit is not None:
                    if hit[0] not in opened:
                        opened[hit[0]] = np.load(hit[0])
                    blocks[name] = opened[hit[0]][hit[1]]
                    continue
                if not assembled:
                    assembled = self._assemble_sharded("checkpoint", step,
                                                       names)
                blocks[name] = assembled[name][tuple(slice(a, b)
                                                     for a, b in at)]
        finally:
            for z in opened.values():
                z.close()
        return State(*(torch.from_numpy(np.ascontiguousarray(blocks[k]))
                       .to(mesh.device) for k in names), step)

    def config(self) -> ModelConfig:
        return ModelConfig(**dict(self.metadata["config"]))

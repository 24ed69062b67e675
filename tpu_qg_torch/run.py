"""Run loop and command line.

Counterpart of ``tpu_qg.run`` (reference: src/run_model.jl:55-95): named
presets, snapshots every ``sample_interval`` of model time, checkpoints,
resume, and a NaN check that writes an emergency checkpoint before it
raises. ``--debug-nans`` (``debug_nans=True``) makes that check after every
step and names the first non-finite field, where ``tpu_qg`` turns on
``jax_debug_nans``: it waits on the device every step and is slow.

The device is explicit: ``device="cuda"`` (the default) raises when no GPU
is present instead of running on the CPU; ``--device cpu`` is the CPU route.

    python -m tpu_qg_torch.run --preset turbulence-2048 --steps 200 --no-save
    python -m tpu_qg_torch.run --preset pod-8192 --steps 50 --no-save

With ``mesh`` (``--mesh nx,ny`` under ``torchrun``, one rank per mesh
point) the grid is domain-decomposed over the ranks
(``tpu_qg_torch.parallel``); every rank runs this driver.
``parallel_impl`` (``--parallel``) picks the implementation: "halo", the
halo stepper, or "gspmd", the single-device step on DTensors of the global
fields (``parallel.gspmd``). Between chunks of steps both hold the state as
each rank's blocks, so snapshots, checkpoints, diagnostics and
``--debug-nans`` take the same path on either. Snapshots and
checkpoints are written as ``tpu_qg`` writes them (``--checkpoint-mode``):
"gathered" through rank 0 as whole fields, "sharded" as shard files, each
rank its own blocks, and "auto" sharded on a mesh at 2048^2 or more,
else gathered. A mesh resumes from a shard set by loading each rank's own
blocks.

    python3 -m torch.distributed.run --nproc-per-node 1 -m tpu_qg_torch.run \
        --preset pod-8192 --mesh 1,1 --steps 20 --no-save
    python3 -m torch.distributed.run --nproc-per-node 1 -m tpu_qg_torch.run \
        --preset pod-8192-mg --mesh 1,1 --steps 20 --run-dir RUN \
        --checkpoint-every 10      # multigrid, shard files under "auto"
    python3 -m torch.distributed.run --nproc-per-node 4 -m tpu_qg_torch.run \
        --preset turbulence-2048 --mesh 4,1 --backend gloo --device cuda:0 \
        --steps 10 --no-save     # four ranks sharing one card (gloo)
    python3 -m torch.distributed.run --nproc-per-node 4 -m tpu_qg_torch.run \
        --preset turbulence-2048 --set M=256 P=256 --mesh 2,2 --device cpu \
        --parallel gspmd --steps 10 --no-save   # DTensor, four CPU ranks

The opt-in one-launch forms run where pinned: add ``--set fft_mono=on``,
``--set step_full=on`` or ``--set step_chain=on``.

On one device ``elliptic_impl`` does not change the route (``pod-8192-mg``
runs the spectral inversion, as in ``tpu_qg``): it selects the sharded
stepper's elliptic solver, the distributed multigrid on a mesh.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Optional

import torch
import torch.distributed as dist

from .config import ModelConfig, preset
from .constants import DAY
from .device import resolve_device
from .io import RunReader, RunWriter
from .models.core import QGModel, State, init_state
from .parallel import gather_state, make_halo_run_fn, make_mesh, shard_state
from .parallel import gspmd
from .parallel.collectives import all_gather_scalars
from .utils.diagnostics import diagnostics, sharded_diagnostics

_CHECKED_FIELDS = ("zeta", "psi", "f1", "f2")


def log_model_params(cfg: ModelConfig) -> None:
    """(reference: src/run_model.jl:22-39)."""
    print("Parameters:")
    print(f"Lx = {cfg.Lx}")
    print(f"Ly = {cfg.Ly}")
    print(f"(f_0^2 / N^2): {cfg.ratio_term}")
    print(f"S1 = {cfg.S1_plus}")
    print(f"S2 = {cfg.S2_minus}")
    print(f"Beta_1 = {cfg.beta_1}")
    print(f"Beta_2 = {cfg.beta_2}")
    print(f"M = {cfg.M}")
    print(f"P = {cfg.P}")
    print(f"dt = {cfg.dt}")
    print(f"T = {cfg.T}")
    print(f"U = {cfg.U}")
    print(f"Initial kick = {cfg.initial_kick}")
    print(f"Total steps = {cfg.total_steps}\n")


def first_nonfinite(state: State, mesh=None) -> Optional[str]:
    """The first of zeta, psi, f1 and f2 that holds a non-finite value, else
    None. On a mesh each rank checks its own blocks and the ranks exchange
    their flags (a collective: call on every rank), so all agree."""
    bad = torch.stack([~torch.isfinite(getattr(state, name)).all()
                       for name in _CHECKED_FIELDS]).double()
    if mesh is not None:
        bad = all_gather_scalars(bad, mesh).amax(dim=0)
    flags = bad.cpu().tolist()
    return next((name for name, flag in zip(_CHECKED_FIELDS, flags) if flag),
                None)


def make_gspmd_blocks_run_fn(cfg: ModelConfig, mesh):
    """``gspmd.make_sharded_run_fn`` on a state held as this rank's blocks,
    the loop's form on a mesh: each call wraps the blocks as DTensors and
    returns the blocks of the result (neither moves data)."""
    run = gspmd.make_sharded_run_fn(cfg, mesh)

    def advance(state: State, n: int) -> State:
        return gspmd.to_blocks(run(gspmd.from_blocks(state, mesh), n))

    advance.route = run.route
    return advance


def run_model(
    cfg: ModelConfig,
    run_dir: Optional[str] = None,
    save_results: bool = True,
    n_steps: Optional[int] = None,
    sample_interval: float = 1.0 * DAY,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
    verbose: bool = True,
    state: Optional[State] = None,
    mesh=None,
    device: torch.device | str = "cuda",
    parallel_impl: str = "halo",
    checkpoint_mode: str = "auto",
    debug_nans: bool = False,
) -> State:
    """Run the simulation on one device, or on ``mesh`` (a
    ``parallel.Mesh``: the device is the mesh's; every rank calls this) by
    ``parallel_impl``, "halo" or "gspmd" (tpu_qg/run.py:111-119),
    optionally streaming snapshots and checkpoints to ``run_dir``.
    Snapshots go every ``sample_interval`` seconds of model time, as the
    metadata says.

    On a mesh, ``state`` (if given) is the full state, and the result is
    this rank's blocks of the final state (``parallel.gather_state`` joins
    them). ``checkpoint_mode``: "gathered" writes whole fields through
    rank 0; "sharded" writes shard files, each rank its own blocks (one
    file on one device); "auto" is sharded on a mesh at M * P >= 2048^2,
    else gathered (tpu_qg/run.py:122-124). A resume on a mesh from a shard
    set loads each rank's own blocks.

    ``debug_nans`` advances one step at a time and checks ``torch.isfinite``
    on zeta, psi, f1 and f2 after each (``first_nonfinite``); at the first
    non-finite step it writes the emergency checkpoint (when saving) and
    raises ``FloatingPointError`` naming the step and the field. It waits on
    the device every step."""
    if checkpoint_mode not in ("auto", "gathered", "sharded"):
        raise ValueError(f"unknown checkpoint_mode {checkpoint_mode!r}")
    if mesh is None:
        device = resolve_device(device)
    else:
        if parallel_impl not in ("halo", "gspmd"):
            raise ValueError(f"unknown parallel_impl {parallel_impl!r}")
        device = mesh.device
    primary = mesh is None or mesh.rank == 0
    verbose = verbose and primary
    if verbose:
        log_model_params(cfg)
    sharded_io = checkpoint_mode == "sharded" or (
        checkpoint_mode == "auto" and mesh is not None
        and cfg.M * cfg.P >= 2048 * 2048)

    total = cfg.total_steps if n_steps is None else n_steps
    sample_steps = max(int(sample_interval // cfg.dt), 1)
    if mesh is None:
        advance = QGModel(cfg, device=device).run
        where = str(device)
    else:
        advance = (make_halo_run_fn(cfg, mesh) if parallel_impl == "halo"
                   else make_gspmd_blocks_run_fn(cfg, mesh))
        where = f"mesh {mesh.shape} ({advance.route}, {mesh.backend})"

    writer = None
    sharded_state = False
    if save_results:
        if run_dir is None:
            raise ValueError("save_results=True requires run_dir")
        if resume:
            reader = RunReader(run_dir)
            steps = reader.checkpoint_steps()
            if (mesh is not None and steps
                    and reader.shard_files("checkpoint", steps[-1])):
                state = reader.load_checkpoint_sharded(mesh)
                sharded_state = True
            else:
                state = reader.load_checkpoint(device=device)
            if verbose:
                print(f"Resumed from step {state.step}")
        if primary or sharded_io:
            writer = RunWriter(run_dir, cfg, sample_interval,
                               write_metadata=primary)

    if state is None:
        state = init_state(cfg, device)
        if writer is not None and primary:
            writer.write_snapshot(0, state.zeta, state.psi)
    if mesh is not None and not sharded_state:
        state = shard_state(state, mesh)

    def barrier() -> None:
        """Every rank returns once every rank's files are in place."""
        if mesh is not None:
            all_gather_scalars(torch.zeros(1, device=device), mesh)

    def save(s: State, snapshot: bool) -> None:
        """Write a snapshot or checkpoint: each rank's shard file, or on a
        mesh the fields gathered and written through rank 0."""
        if sharded_io:
            if snapshot:
                writer.write_snapshot_sharded(s.step, s.zeta, s.psi, mesh)
            else:
                writer.write_checkpoint_sharded(s, mesh)
            barrier()
            return
        full = s
        if mesh is not None:
            full = gather_state(s, mesh, ("zeta", "psi") if snapshot
                                else ("zeta", "psi", "f1", "f2"))
        if writer is not None:
            if snapshot:
                writer.write_snapshot(s.step, full.zeta, full.psi)
            else:
                writer.write_checkpoint(full)
        barrier()

    if debug_nans:
        advance_chunk = advance

        def advance(s: State, n: int) -> State:
            for _ in range(n):
                s = advance_chunk(s, 1)
                field = first_nonfinite(s, mesh)
                if field is not None:
                    if save_results:
                        save(s, False)
                    raise FloatingPointError(
                        f"non-finite {field} at step {s.step} (debug_nans)"
                        + (" — emergency checkpoint written" if save_results
                           else ""))
            return s

    start_step = state.step
    if verbose:
        print("Running simulation... \n")
    t0 = time.perf_counter()
    done = start_step
    while done < total:
        chunk = min(sample_steps, total - done)
        state = advance(state, chunk)
        done += chunk
        if save_results and done % sample_steps == 0:
            save(state, True)
        if save_results and checkpoint_every and done % checkpoint_every == 0:
            save(state, False)
        # Copies to the host, so waits for the device (a collective on a
        # mesh).
        d = (diagnostics(cfg, state) if mesh is None
             else sharded_diagnostics(cfg, state, mesh))
        if not math.isfinite(d["max_abs_zeta"]):
            # NaN/Inf in the state: save it for post-mortem and restart.
            if save_results:
                save(state, False)
            raise FloatingPointError(
                f"non-finite state at step {done} (max|zeta|="
                f"{d['max_abs_zeta']}); diagnostics: {d}"
                + (" — emergency checkpoint written" if save_results else ""))
        if verbose:
            rate = (done - start_step) * cfg.M * cfg.P / (time.perf_counter() - t0)
            print(f"step {done}/{total}  cfl={d['cfl']:.3f}  "
                  f"ke1={d.get('ke_1', float('nan')):.3e}  "
                  f"max|zeta|={d['max_abs_zeta']:.3e}  "
                  f"[{rate:.3e} gridpoint-steps/s on {where}]")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if save_results:
        save(state, False)
    return state


def parse_overrides(cfg: ModelConfig, items) -> ModelConfig:
    """Apply ``KEY=VALUE`` config overrides (bools as JSON)."""
    overrides = {}
    for kv in items:
        k, v = kv.split("=", 1)
        field_type = type(getattr(cfg, k))
        overrides[k] = field_type(json.loads(v) if field_type is bool else v)
    return cfg.replace(**overrides) if overrides else cfg


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Two-layer QG solver (PyTorch/CUDA), on one device or a "
                    "mesh of torchrun ranks")
    parser.add_argument("--preset", default="production",
                        help="named config preset (see tpu_qg_torch.config.preset)")
    parser.add_argument("--run-dir", default=None, help="output directory")
    parser.add_argument("--steps", type=int, default=None,
                        help="override number of steps")
    parser.add_argument("--resume", action="store_true",
                        help="resume from latest checkpoint in --run-dir")
    parser.add_argument("--checkpoint-every", type=int, default=None)
    parser.add_argument("--no-save", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--set", nargs="*", default=[],
                        metavar="KEY=VALUE", help="config field overrides")
    parser.add_argument("--mesh", default=None, metavar="NX,NY",
                        help="mesh shape over the torchrun ranks (NX * NY "
                             "ranks; rank = ix * NY + iy)")
    parser.add_argument("--distributed", action="store_true",
                        help="shard over every torchrun rank, the mesh "
                             "shape from the config")
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="process-group backend (default: nccl on cuda, "
                             "gloo on cpu; gloo for ranks sharing a card)")
    parser.add_argument("--parallel", default="halo",
                        choices=["halo", "gspmd"],
                        help="sharded implementation: halo exchange, or "
                             "the single-device step on DTensors (gspmd)")
    parser.add_argument("--checkpoint-mode", default="auto",
                        choices=["auto", "gathered", "sharded"],
                        help="gathered: whole fields through rank 0; "
                             "sharded: a shard file a rank; auto: sharded "
                             "on a mesh at 2048^2 or more")
    parser.add_argument("--debug-nans", action="store_true",
                        help="check zeta, psi, f1 and f2 for NaN/Inf after "
                             "every step and stop at the first non-finite "
                             "one, naming it (waits on the device every "
                             "step; slow)")
    args = parser.parse_args(argv)

    cfg = parse_overrides(preset(args.preset), args.set)
    mesh = None
    if args.mesh is not None or args.distributed:
        shape = (tuple(int(v) for v in args.mesh.split(","))
                 if args.mesh else None)
        mesh = make_mesh(shape, cfg=cfg, device=args.device,
                         backend=args.backend)
    t0 = time.perf_counter()
    try:
        run_model(
            cfg,
            run_dir=args.run_dir,
            save_results=not args.no_save and args.run_dir is not None,
            n_steps=args.steps,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
            mesh=mesh,
            device=args.device,
            parallel_impl=args.parallel,
            checkpoint_mode=args.checkpoint_mode,
            debug_nans=args.debug_nans,
        )
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if mesh is None or mesh.rank == 0:
        print(f"\n Total runtime: {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()

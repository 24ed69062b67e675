"""Run loop and command line (single device).

Counterpart of the single-device part of ``tpu_qg.run`` (reference:
src/run_model.jl:55-95): named presets, snapshots every ``sample_interval``
of model time, checkpoints, resume, and a NaN check that writes an
emergency checkpoint before it raises.

The device is explicit: ``device="cuda"`` (the default) raises when no GPU
is present instead of running on the CPU; ``--device cpu`` is the CPU route.
The sharded paths (``--mesh``, ``--distributed``, ``--parallel``) are not
ported yet.

    python -m tpu_qg_torch.run --preset turbulence-2048 --steps 200 --no-save
    python -m tpu_qg_torch.run --preset pod-8192 --steps 50 --no-save

The opt-in one-launch forms run where pinned: add ``--set fft_mono=on``,
``--set step_full=on`` or ``--set step_chain=on``.

On one device ``elliptic_impl`` does not change the route (``pod-8192-mg``
runs the spectral inversion, as in ``tpu_qg``): it selects the sharded
stepper's elliptic solver only.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Optional

import torch

from .config import ModelConfig, preset
from .constants import DAY
from .device import resolve_device
from .io import RunReader, RunWriter
from .models.core import QGModel, State
from .utils.diagnostics import diagnostics

_SHARDED = ("the sharded paths (--mesh, --distributed, --parallel) are not "
            "ported yet (ROADMAP.md queue 1 item 14)")


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
) -> State:
    """Run the simulation on one device, optionally streaming snapshots and
    checkpoints to ``run_dir``. Snapshots go every ``sample_interval``
    seconds of model time, as the metadata says."""
    if mesh is not None:
        raise NotImplementedError(_SHARDED)
    device = resolve_device(device)
    if verbose:
        log_model_params(cfg)

    total = cfg.total_steps if n_steps is None else n_steps
    sample_steps = max(int(sample_interval // cfg.dt), 1)
    model = QGModel(cfg, device=device)

    writer = None
    if save_results:
        if run_dir is None:
            raise ValueError("save_results=True requires run_dir")
        if resume:
            state = RunReader(run_dir).load_checkpoint(device=device)
            if verbose:
                print(f"Resumed from step {state.step}")
        writer = RunWriter(run_dir, cfg, sample_interval)

    if state is None:
        state = model.init_state()
        if writer is not None:
            writer.write_snapshot(0, state.zeta, state.psi)

    start_step = state.step
    if verbose:
        print("Running simulation... \n")
    t0 = time.perf_counter()
    done = start_step
    while done < total:
        chunk = min(sample_steps, total - done)
        state = model.run(state, chunk)
        done += chunk
        if writer is not None and done % sample_steps == 0:
            writer.write_snapshot(done, state.zeta, state.psi)
        if writer is not None and checkpoint_every and done % checkpoint_every == 0:
            writer.write_checkpoint(state)
        d = diagnostics(cfg, state)      # copies to the host: waits for the device
        if not math.isfinite(d["max_abs_zeta"]):
            # NaN/Inf in the state: save it for post-mortem and restart.
            if writer is not None:
                writer.write_checkpoint(state)
            raise FloatingPointError(
                f"non-finite state at step {done} (max|zeta|="
                f"{d['max_abs_zeta']}); diagnostics: {d}"
                + (" — emergency checkpoint written" if writer else ""))
        if verbose:
            rate = (done - start_step) * cfg.M * cfg.P / (time.perf_counter() - t0)
            print(f"step {done}/{total}  cfl={d['cfl']:.3f}  "
                  f"ke1={d.get('ke_1', float('nan')):.3e}  "
                  f"max|zeta|={d['max_abs_zeta']:.3e}  "
                  f"[{rate:.3e} gridpoint-steps/s on {device}]")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if writer is not None:
        writer.write_checkpoint(state)
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
        description="Two-layer QG solver on one device (PyTorch/CUDA)")
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
    parser.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--distributed", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--parallel", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.mesh is not None or args.distributed or args.parallel is not None:
        raise NotImplementedError(_SHARDED)

    cfg = parse_overrides(preset(args.preset), args.set)
    t0 = time.perf_counter()
    run_model(
        cfg,
        run_dir=args.run_dir,
        save_results=not args.no_save and args.run_dir is not None,
        n_steps=args.steps,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        device=args.device,
    )
    print(f"\n Total runtime: {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()

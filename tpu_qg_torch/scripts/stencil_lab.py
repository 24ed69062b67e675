"""The stencil lab: K18's tendency variants timed in 50-step chunks of the
lab step with psi held fixed (see ``tpu_qg_torch/ops/_stencil_lab.py``).

Counterpart of ``scripts/stencil_lab.py``, with its flags, defaults, config
and protocol: per variant, one untimed chunk (``first_call_s``, the kernel
build included on a fresh checkout), then ``--reps`` timed chunks, each
continuing from the last and ended by ``torch.cuda.synchronize()``; the
best of them per step is ``ms_per_iter``. One JSON line per variant:

    python -m tpu_qg_torch.scripts.stencil_lab             # the card, 2048^2
    python -m tpu_qg_torch.scripts.stencil_lab --device cpu --M 128 \
        --chunk 2 --reps 1                                 # the plain versions

Differences from ``scripts/stencil_lab.py``: the initial state comes from the
port's ``init_state`` with numpy's generator seeded with ``SEED``, so it
cannot match ``jax.random.PRNGKey(0)`` bit for bit; a variant that fails
raises instead of being recorded; and a record is written only to an
explicit ``--out`` path, never under ``results/``, whose ``stencil_lab_*``
files are the TPU's records.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from ..config import ModelConfig
from ..constants import KM
from ..device import resolve_device
from ..models.core import State, init_state
from ..ops._stencil_lab import lab_step

DEFAULT_VARIANTS = "base,aligned,norot,noslice,nojac"
SEED = 0
_RESULTS = pathlib.Path(__file__).resolve().parents[2] / "results"


def lab_config(M: int) -> ModelConfig:
    """The lab's configuration on an M x M grid (``scripts/stencil_lab.py``
    :45-47)."""
    return ModelConfig(M=M, P=M, Lx=4000.0 * KM, Ly=4000.0 * KM, dt=60.0,
                       T=3600.0, dtype="float32", use_pallas=True,
                       fft_impl="pallas")


def run_chunk(cfg: ModelConfig, state: State, steps: int,
              variant: str) -> State:
    """``steps`` lab steps from ``state`` with psi held fixed."""
    for _ in range(steps):
        zeta_new, carry = lab_step(cfg, state.zeta, state.psi, state.f1,
                                   state.f2, state.step, variant)
        state = State(zeta_new, state.psi, carry, state.f1, state.step + 1)
    return state


def run_lab(M: int, chunk: int, reps: int, variants, device="cuda"):
    """Time each variant by the lab's protocol on ``device``. Returns
    ({variant: {"ms_per_iter", "first_call_s"}}, {variant: final state})."""
    device = resolve_device(device)
    cfg = lab_config(M)
    state0 = init_state(cfg, device, seed=SEED)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    jobs, finals = {}, {}
    for variant in variants:
        t0 = time.perf_counter()
        state = run_chunk(cfg, state0, chunk, variant)
        sync()
        first_call_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            state = run_chunk(cfg, state, chunk, variant)
            sync()
            best = min(best, time.perf_counter() - t0)
        jobs[variant] = {"ms_per_iter": best / chunk * 1e3,
                         "first_call_s": first_call_s}
        finals[variant] = state
    return jobs, finals


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--M", type=int, default=2048)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions)")
    ap.add_argument("--out", default=None,
                    help="write the record (JSON) to this path")
    args = ap.parse_args(argv)
    out = None if args.out is None else pathlib.Path(args.out).resolve()
    if out is not None and _RESULTS in out.parents:
        ap.error(f"--out {args.out}: results/ holds the TPU's records")
    variants = [v.strip() for v in args.variants.split(",")]
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    jobs, _ = run_lab(args.M, args.chunk, args.reps, variants, device)
    for variant, job in jobs.items():
        print(json.dumps({"variant": variant, **job, "M": args.M,
                          "chunk": args.chunk, "device": name}), flush=True)
    if out is not None:
        out.write_text(json.dumps({"M": args.M, "chunk": args.chunk,
                                   "reps": args.reps, "device": name,
                                   "jobs": jobs}, indent=1))
        print(f"[lab] wrote {out}")


if __name__ == "__main__":
    main()

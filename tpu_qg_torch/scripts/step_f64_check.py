"""Ten steps under each float32 tier, held against float64.

Counterpart of ``scripts/step_f64_check.py``. Runs the same 10-step
trajectory from one seeded state under float64 (the oracle: torch.fft and
the plain step) and under each float32 tier, all on ``--device`` (default
the card), and reports each tier's zeta error against float64,
max|zeta - zeta64| / max|zeta64|. By the reference's rule a tier passes if
its error is within 2x the torch_fft tier's (the float32 noise floor),
however far two float32 tiers sit from each other. The tiers (``TIERS``):

  torch_fft  the plain step and torch.fft (``tpu_qg``'s "plain" variant)
  matmul     K1 and the matmul-factorized DFT (``bench.py``'s matmul mode)
  kernels    K1 and the DFT kernels by the grid's route (on extents
             128 * n, n <= 64; the plain versions on the CPU)

One JSON object goes to stdout, and to ``--out`` when given; the exit code
is 1 if a tier fails the rule:

    python -m tpu_qg_torch.scripts.step_f64_check --M 8192
    python -m tpu_qg_torch.scripts.step_f64_check --device cpu --M 128

The state is the port's seeded random initial condition (numpy's
generator, ``SEED``), not the reference's ``jax.random.PRNGKey(0)``.
"""

from __future__ import annotations

import argparse
import json

from ..device import resolve_device
from ..models.core import QGModel, State, init_state
from ..ops.spectral import reference_dft_kernels
from .inv_f64_check import SEED, check_config, device_name

STEPS = 10
TIERS = {"torch_fft": dict(use_pallas=False, fft_impl="xla"),
         "matmul": dict(use_pallas=True, fft_impl="matmul"),
         "kernels": dict(use_pallas=True, fft_impl="pallas")}


def tiers_for(M: int, P: int) -> dict:
    """The tiers that run on an (M, P) grid (kernels on 128 * n extents)."""
    return {name: over for name, over in TIERS.items()
            if name != "kernels" or reference_dft_kernels(M, P)}


def step_f64_check(M: int, P: int, device="cuda", steps: int = STEPS) -> dict:
    """{"M", "P", "steps", "device", "scale", "err_vs_f64": {tier: err},
    "limit" (2x torch_fft's), "tier_passed": {tier: bool}, "passed"}."""
    device = resolve_device(device)
    cfg32 = check_config(M, P)
    state32 = init_state(cfg32, device, seed=SEED)
    cfg64 = check_config(M, P, dtype="float64", use_pallas=False,
                         fft_impl="xla")
    s64 = State(*(x.double() for x in state32[:4]), state32.step)
    ref = QGModel(cfg64, device).run(s64, steps).zeta
    del s64
    scale = ref.abs().max()
    errs = {}
    for tier, over in tiers_for(M, P).items():
        out = QGModel(cfg32.replace(**over), device).run(state32, steps)
        errs[tier] = float((out.zeta.double() - ref).abs().max() / scale)
        del out
    limit = 2.0 * errs["torch_fft"]
    passed = {tier: err <= limit for tier, err in errs.items()}
    return {"M": M, "P": P, "steps": steps, "device": device_name(device),
            "scale": float(scale), "err_vs_f64": errs, "limit": limit,
            "tier_passed": passed, "passed": all(passed.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--M", type=int, default=8192)
    ap.add_argument("--P", type=int, default=0)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    rec = step_f64_check(args.M, args.P or args.M, args.device, args.steps)
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0 if rec["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""One packed inversion under each float32 tier, held against float64.

Counterpart of ``scripts/inv_f64_check.py``. At large grids the Poisson
symbol 1/lambda_k amplifies low-k float32 transform noise like
(N dx / 2 pi)^2, so float32 tiers compared with each other measure noise,
not correctness. This script computes the SAME packed inversion of one
seeded zeta in float64 (the oracle, torch.fft) and reports each float32
tier's error against it, max|psi - psi64| / max|psi64|:

  torch_fft (torch.fft) | matmul (the matmul-factorized DFT) |
  kernels (the DFT kernels K2-K5 by the grid's route; their plain versions
  on the CPU, and only on extents 128 * n, n <= 64)

All tiers and the oracle run on ``--device`` (default the card). One JSON
object goes to stdout, and to ``--out`` when given:

    python -m tpu_qg_torch.scripts.inv_f64_check --M 8192
    python -m tpu_qg_torch.scripts.inv_f64_check --device cpu --M 128

The zeta is the port's seeded random initial condition (numpy's generator,
``SEED``), so it cannot match the reference's ``jax.random.PRNGKey(0)``.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..config import ModelConfig
from ..constants import KM
from ..device import resolve_device
from ..models.core import init_state
from ..ops.spectral import (PackedModalInverter, PackedModalInverterKernels,
                            PackedModalInverterMXU, reference_dft_kernels)

SEED = 0


def check_config(M: int, P: int, dtype: str = "float32",
                 **overrides) -> ModelConfig:
    """The checks' configuration (``scripts/inv_f64_check.py``:51-52)."""
    return ModelConfig(M=M, P=P, Lx=4000.0 * KM, Ly=4000.0 * KM, dt=60.0,
                       T=3600.0, dtype=dtype, **overrides)


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def inverters(cfg: ModelConfig) -> dict:
    """Each float32 tier's packed inverter on ``cfg``'s grid: torch_fft,
    matmul and, on the kernels' extents, kernels (the default route)."""
    args = (cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())
    tiers = {"torch_fft": PackedModalInverter(*args),
             "matmul": PackedModalInverterMXU(*args)}
    if reference_dft_kernels(cfg.M, cfg.P):
        tiers["kernels"] = PackedModalInverterKernels(*args)
    return tiers


def errors_vs_float64(tiers: dict, zeta) -> dict:
    """Each tier's max|psi - psi64| / max|psi64| on a float32 ``zeta``,
    psi64 the torch_fft tier's inversion of zeta in float64."""
    psi64 = tiers["torch_fft"](zeta.double())
    scale = psi64.abs().max()
    return {tier: float((inv(zeta).double() - psi64).abs().max() / scale)
            for tier, inv in tiers.items()}


def inv_f64_check(M: int, P: int, device="cuda") -> dict:
    """{"M", "P", "device", "<tier>_f32_vs_f64" for each tier}."""
    device = resolve_device(device)
    cfg = check_config(M, P)
    zeta = init_state(cfg, device, seed=SEED).zeta
    errs = errors_vs_float64(inverters(cfg), zeta)
    return {"M": M, "P": P, "device": device_name(device),
            **{f"{tier}_f32_vs_f64": e for tier, e in errs.items()}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--M", type=int, default=8192)
    ap.add_argument("--P", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    rec = inv_f64_check(args.M, args.P or args.M, args.device)
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()

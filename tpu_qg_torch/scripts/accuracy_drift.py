"""Transform-tier drift over a long float32 trajectory.

Counterpart of ``scripts/accuracy_drift.py``. Runs the SAME two-layer
float32 trajectory (one seeded state) under each tier of
``step_f64_check.TIERS`` named by ``--impls`` (default the torch_fft tier,
then the kernels tier) for ``--steps`` steps in ``--chunk``s on
``--device`` (default the card), recording total energy and enstrophy
after every chunk and the final isotropic KE spectrum
(``utils.diagnostics.energy_spectrum``), then each tier's largest relative
energy and enstrophy difference from the first tier. If the curves overlay
within the noise of the chaotic dynamics, the faster tier is safe for
production runs.

One JSON object goes to stdout, and to ``--out`` when given:

    python -m tpu_qg_torch.scripts.accuracy_drift --steps 10000 --chunk 500
    python -m tpu_qg_torch.scripts.accuracy_drift --device cpu --M 128 \
        --steps 20 --chunk 10

Differences from the reference's script: its "xla" tier keeps the Pallas
step where the torch_fft tier here runs the plain step; the state is the
port's seeded initial condition; no plot is drawn.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.core import QGModel, init_state
from ..utils.diagnostics import energy, energy_spectrum, enstrophy
from .inv_f64_check import SEED, check_config, device_name
from .step_f64_check import TIERS


def run_one(tier: str, M: int, steps: int, chunk: int, device) -> dict:
    """One tier's trajectory: the energy and enstrophy series and the final
    spectrum."""
    cfg = check_config(M, M, **TIERS[tier])
    model = QGModel(cfg, device)
    state = init_state(cfg, device, seed=SEED)
    series = {"step": [], "energy": [], "enstrophy": []}
    t0 = time.perf_counter()
    for k in range(steps // chunk):
        state = model.run(state, chunk)
        e, z = torch.stack([energy(cfg, state.psi).sum(),
                            enstrophy(state.zeta).sum()]).double().tolist()
        if not math.isfinite(e):
            raise FloatingPointError(
                f"{tier}: non-finite energy at step {(k + 1) * chunk}")
        series["step"].append((k + 1) * chunk)
        series["energy"].append(e)
        series["enstrophy"].append(z)
    wall = time.perf_counter() - t0
    k_centers, spec = energy_spectrum(cfg, state.psi)
    return {"tier": tier, "M": M, "steps": steps, "chunk": chunk,
            "wall_s": wall, "series": series,
            "spectrum_k": np.asarray(k_centers).tolist(),
            "spectrum": np.asarray(spec).tolist(),
            "final_zeta_absmax": float(state.zeta.abs().max())}


def drift_summary(records: list) -> dict:
    """Each later tier's largest relative energy and enstrophy difference
    from the first tier over the chunks."""
    ref = records[0]["series"]
    e0, z0 = np.asarray(ref["energy"]), np.asarray(ref["enstrophy"])
    out = {}
    for rec in records[1:]:
        e1 = np.asarray(rec["series"]["energy"])
        z1 = np.asarray(rec["series"]["enstrophy"])
        out[rec["tier"]] = {
            "max_rel_energy_diff": float(np.max(np.abs(e1 - e0) / e0)),
            "max_rel_enstrophy_diff": float(np.max(np.abs(z1 - z0) / z0))}
    return out


def accuracy_drift(M: int, steps: int, chunk: int, impls, device="cuda"
                   ) -> dict:
    device = resolve_device(device)
    records = [run_one(tier, M, steps, chunk, device) for tier in impls]
    return {"M": M, "steps": steps, "chunk": chunk,
            "device": device_name(device), "records": records,
            "vs_" + records[0]["tier"]: drift_summary(records)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--M", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--impls", nargs="*", default=["torch_fft", "kernels"],
                    choices=sorted(TIERS))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    rec = accuracy_drift(args.M, args.steps, args.chunk, args.impls,
                         args.device)
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f)
    return rec


if __name__ == "__main__":
    main()

"""Long-horizon allclose validation vs the float64 reference twin.

Counterpart of ``tpu_qg.validation.allclose``. BASELINE config 3's
acceptance check: two-layer baroclinic-instability spinup, identical random
ICs, N steps (target 10k) — the port's spectral-inversion path must match
the twin (the reference algorithm with factorized direct solves and pinned
gauge, ``ReferenceTwin``) at rtol <= 1e-5 on zeta and on gauge-normalized
psi. Same arguments, configuration, initial condition, comparison, verdict
JSON and exit code as ``tpu_qg``'s, plus ``--device``.

    python -m tpu_qg_torch.validation.allclose --M 512 --steps 10000
    python -m tpu_qg_torch.validation.allclose --device cpu --M 32 --steps 50

The model runs in float64 on ``--device`` (default the card). In float64 it
takes the torch.fft tier and the plain step: no kernel runs, as no kernel
runs in the reference's float64 oracle run (the kernels are float32 only).
The twin runs on the host.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--M", type=int, default=512)
    parser.add_argument("--P", type=int, default=None)
    parser.add_argument("--steps", type=int, default=10000)
    parser.add_argument("--check-every", type=int, default=1000)
    parser.add_argument("--out", default=None, help="write JSON result here")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model (default cuda)")
    args = parser.parse_args(argv)

    import numpy as np

    from ..config import ModelConfig
    from ..constants import KM, MINUTES
    from ..models.core import QGModel
    from .twin import ReferenceTwin

    P = args.P or args.M
    # BASELINE config 3: 512^2, beta-plane + bottom drag, dt=5 min.
    cfg = ModelConfig(
        M=args.M, P=P, Lx=4000.0 * KM, Ly=4000.0 * KM,
        dt=5.0 * MINUTES, T=args.steps * 5.0 * MINUTES,
        dtype="float64",
    )
    rng = np.random.default_rng(0)
    psi0 = cfg.initial_kick * cfg.U * cfg.Ly * rng.random((2, cfg.M, cfg.P))

    twin = ReferenceTwin(cfg)
    z_t, p_t = twin.init_state(psi0)

    model = QGModel(cfg, device=args.device)
    state = model.init_state(psi_init=psi0)

    t0 = time.perf_counter()
    results = []
    done = 0
    while done < args.steps:
        chunk = min(args.check_every, args.steps - done)
        for _ in range(chunk):
            z_t, p_t = twin.step(z_t, p_t)
        state = model.run(state, chunk)
        done += chunk

        z_j = state.zeta.cpu().numpy()
        p_j = state.psi.cpu().numpy()
        scale_z = np.abs(z_t).max()
        err_z = np.abs(z_j - z_t).max() / scale_z
        # psi compared gauge-normalized (zero-mean vs pinned-point constants).
        p_jn = p_j - p_j.mean(axis=(1, 2), keepdims=True)
        p_tn = p_t - p_t.mean(axis=(1, 2), keepdims=True)
        err_p = np.abs(p_jn - p_tn).max() / np.abs(p_tn).max()
        results.append({"step": done, "rel_err_zeta": float(err_z),
                        "rel_err_psi": float(err_p)})
        print(f"step {done:6d}:  rel_err zeta {err_z:.3e}  psi {err_p:.3e}  "
              f"max|zeta| {scale_z:.3e}  [{time.perf_counter()-t0:.0f}s]",
              flush=True)

    final = results[-1]
    passed = final["rel_err_zeta"] < 1e-5 and final["rel_err_psi"] < 1e-5
    verdict = {
        "config": f"two-layer {args.M}x{P}, dt=5min, {args.steps} steps, float64",
        "rel_err_zeta": final["rel_err_zeta"],
        "rel_err_psi": final["rel_err_psi"],
        "target_rtol": 1e-5,
        "passed": bool(passed),
        "history": results,
    }
    print(json.dumps({k: v for k, v in verdict.items() if k != "history"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=2)
    return 0 if passed else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""The default route's step on the card, alone: ms a step by CUDA events
around ``QGModel.run`` (``--runs`` runs of ``--steps`` steps from the state
three steps in), the host's time to enqueue ``--steps`` steps, and the
route's kernels (K1, K2 both ways, K3) each replayed from a CUDA graph, on
``turbulence-2048``'s configuration at each of ``--grids``. One JSON line a
grid:

    python3 -m tpu_qg_torch.scripts.step_timing               # a checkout
    python3 step_timing.py --grids 1536,2048                  # a copy at the
                                                              # root of another
                                                              # checkout

It uses only the package's entry points, so a copy at the root of an older
checkout times that checkout's package: processes of two checkouts in turns
in one call compare them on one card. The CUDA graph is a measurement only:
the package captures none. A run without a card raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from tpu_qg_torch import preset
from tpu_qg_torch.models.core import QGModel
from tpu_qg_torch.ops.dft_kernels import pair_x_symbols, y_dft
from tpu_qg_torch.ops.spectral import PackedModalInverterKernels
from tpu_qg_torch.ops.step_kernel import fused_step


def _events_ms(fn) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _graph_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    return _events_ms(graph.replay) / reps


def time_grid(n: int, steps: int, runs: int, dev: torch.device) -> dict:
    cfg = preset("turbulence-2048").replace(M=n, P=n)
    model = QGModel(cfg, dev)
    state = model.run(model.init_state(), 3)
    torch.cuda.synchronize()
    step_ms = [_events_ms(lambda: model.run(state, steps)) / steps
               for _ in range(runs)]
    t0 = time.perf_counter()
    model.run(state, steps)
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    consts = PackedModalInverterKernels(
        n, n, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
        cfg.back_projection_matrix())._sym_consts
    x = torch.randn(2, n, n, device=dev)
    kernels = {
        "K1": _graph_ms(lambda: fused_step(cfg, state.zeta, state.psi,
                                           state.f1, state.f2, 5)),
        "K2 forward": _graph_ms(lambda: y_dft(x, False)),
        "K2 inverse": _graph_ms(lambda: y_dft(x, True)),
        "K3": _graph_ms(lambda: pair_x_symbols(x, consts))}
    return {"grid": [n, n], "route": model.route, "steps_per_run": steps,
            "step_ms_runs": step_ms, "host_enqueue_ms_per_step": host_ms,
            "kernels_graph_ms": kernels}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grids", default="1536,2048")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("step_timing needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    for n in (int(g) for g in args.grids.split(",")):
        print(json.dumps({"card": card, **time_grid(n, args.steps, args.runs,
                                                    dev)}), flush=True)


if __name__ == "__main__":
    main()

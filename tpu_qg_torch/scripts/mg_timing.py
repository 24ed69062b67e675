"""The multigrid inversion call on the card: ms a warm-started
``MultigridModalInverter`` call host-launched and replayed from a CUDA
graph, the host's enqueue time, and the spectral inversion of the same
zeta, at the two MG grids of ``chip_smoke.py``: ``pod-8192-mg`` (2 V-cycles
a call) and ``turbulence-2048`` (4); and the host's time to enqueue one K10
(restrict form) and one K11 launch through their wrappers at a 64^2 level.
One JSON line each:

    python3 -m tpu_qg_torch.scripts.mg_timing           # from a checkout
    python3 mg_timing.py                                # a copy at the root
                                                        # of another checkout

It uses only the package's entry points (presets, ``QGModel``,
``MultigridModalInverter``, ``PackedModalInverterKernels``, the K10 and K11
wrappers), so a copy at the root of an older checkout times that
checkout's package in the same call. The zeta is one default-route step from the preset's initial state,
the seed that state's psi. The CUDA graph is a measurement only: the
package captures none. A run without a card raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from tpu_qg_torch import preset
from tpu_qg_torch.models.core import QGModel, init_state
from tpu_qg_torch.ops.mg_kernels import mg_prolong_smooth, mg_smooth
from tpu_qg_torch.ops.multigrid import MultigridModalInverter
from tpu_qg_torch.ops.spectral import PackedModalInverterKernels

GRIDS = (("pod-8192-mg", None, 10), ("turbulence-2048", 4, 20))


def _events_ms(fn, reps: int) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def _host_ms(fn) -> float:
    """Host ms to enqueue one call into an idle queue, best of 3."""
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return best


def time_grid(name: str, cycles, reps: int, dev) -> dict:
    cfg = preset(name)
    cycles = cycles or cfg.mg_cycles
    state = init_state(cfg, dev)
    zeta, seed = QGModel(cfg, dev).step(state).zeta, state.psi
    mg = MultigridModalInverter(cfg.M, cfg.P, cfg.dx, cfg.S_eig,
                                cfg.P_inv_matrix(),
                                cfg.back_projection_matrix(),
                                n_cycles=cycles)
    spectral = PackedModalInverterKernels(cfg.M, cfg.P, cfg.dx, cfg.S_eig,
                                          cfg.P_inv_matrix(),
                                          cfg.back_projection_matrix(),
                                          pair_x=cfg.fft_pairx != "off")
    call = lambda: mg(zeta, psi_prev=seed)                  # noqa: E731
    inv = lambda: spectral(zeta)                            # noqa: E731
    runs = {"call_ms": [], "graph_ms": [], "spectral_ms": []}
    for _ in range(2):
        runs["call_ms"].append(_events_ms(call, reps))
        runs["graph_ms"].append(_graph_ms(call, reps))
        runs["spectral_ms"].append(_events_ms(inv, 5 * reps))
    out = {k: sum(v) / len(v) for k, v in runs.items()}
    return dict(grid=[cfg.M, cfg.P], preset=name, cycles_per_call=cycles,
                **out, runs_ms=runs, host_enqueue_ms=_host_ms(call))


def wrapper_host_us(dev, calls: int = 500) -> dict:
    """Host microseconds a launch of K10 (restrict form) and of K11 through
    mg_smooth and mg_prolong_smooth at a (2, 64, 64) level, the queue
    absorbing the launches (the host clock stops before the device ends)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    u, f = (torch.randn((2, 64, 64), generator=g).to(dev) for _ in range(2))
    ec = torch.randn((2, 32, 32), generator=g).to(dev)
    cfg = preset("pod-8192-mg")
    h, alphas = cfg.dx * 128, (0.0, cfg.S_eig)
    out = {}
    for name, fn in (("K10", lambda: mg_smooth(u, f, h, alphas, 2, True,
                                                 0.8, True)),
                     ("K11", lambda: mg_prolong_smooth(u, ec, f, h, alphas,
                                                       2))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="", help="a label for the lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("mg_timing needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for name, cycles, reps in GRIDS:
        print(json.dumps({"phase": "mg_timing", "tag": args.tag, "card": card,
                          **time_grid(name, cycles, reps, dev)}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "mg_wrapper_host", "tag": args.tag,
                      "card": card, "level": [2, 64, 64],
                      "host_us_per_launch": wrapper_host_us(dev)}),
          flush=True)


if __name__ == "__main__":
    main()

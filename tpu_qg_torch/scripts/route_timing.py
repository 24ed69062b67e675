"""Every user route's step on the card, and the one-launch kernels through
their wrappers: ms a step by CUDA events around ``QGModel.run`` (or, for
the one-rank NCCL mesh, around its halo run function) from the state three
steps in, the routes in turns (in order, then in reverse, ``--runs``
times); then K16 (``mono_invert``) at 2048^2 and 1536^2 and K15's sharded
form (``fused_step_yspec_sharded``) on the one-rank block (2, 2048, 2048)
and on rank 0 of (4, 1)'s (2, 512, 2048), each replayed from a CUDA graph,
and the small block's host enqueue ms a call. One JSON line:

    python3 -m tpu_qg_torch.scripts.route_timing              # a checkout
    python3 route_timing.py                                   # a copy at the
                                                              # root of another
                                                              # checkout

It uses only the package's entry points and counting wrappers, so a copy
at the root of an older checkout times that checkout's package: processes
of two checkouts in turns in one call compare them on one card. The CUDA
graph is a measurement only: the package captures none. A run without a
card raises.
"""

from __future__ import annotations

import argparse
import datetime
import json
import socket
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

import tpu_qg_torch
from tpu_qg_torch import preset
from tpu_qg_torch.models.core import QGModel
from tpu_qg_torch.ops.dft_kernels import mono_invert, y_dft_plain
from tpu_qg_torch.ops.spectral import PackedModalInverterKernels
from tpu_qg_torch.ops.step_kernel import fused_step_yspec_sharded
from tpu_qg_torch.parallel import make_halo_run_fn, make_mesh, shard_state

# name, preset, overrides, steps a run
ROUTES = (
    ("2048^2 default", "turbulence-2048", {}, 100),
    ("2048^2 mono", "turbulence-2048", {"fft_mono": "on"}, 100),
    ("2048^2 fullstep", "turbulence-2048", {"step_full": "on"}, 100),
    ("2048^2 chain", "turbulence-2048", {"step_chain": "on"}, 100),
    ("1536^2 default", "turbulence-2048", {"M": 1536, "P": 1536}, 100),
    ("3072^2 default", "turbulence-2048", {"M": 3072, "P": 3072}, 50),
    ("8192^2 default", "pod-8192", {}, 20),
    ("8192^2 chain", "pod-8192", {"step_chain": "on"}, 20),
)
# The one-rank NCCL mesh's routes at 2048^2: name, overrides, steps a run.
MESH_ROUTES = (("2048^2 mesh (1, 1) default", {}, 100),
               ("2048^2 mesh (1, 1) chain", {"step_chain": "on"}, 20))


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


def _host_ms(fn, calls: int = 40) -> float:
    """Host ms to enqueue one call into an idle queue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def time_routes(dev: torch.device, runs: int) -> dict:
    """ms a step of ROUTES and MESH_ROUTES, in turns."""
    calls, routes = {}, {}
    for name, preset_name, over, steps in ROUTES:
        model = QGModel(preset(preset_name).replace(**over), dev)
        state = model.run(model.init_state(), 3)
        calls[name] = (lambda m=model, s=state, n=steps: m.run(s, n), steps)
        routes[name] = model.route
    mesh = make_mesh((1, 1), device=dev)
    for name, over, steps in MESH_ROUTES:
        cfg = preset("turbulence-2048").replace(**over)
        model = QGModel(cfg, dev)
        run = make_halo_run_fn(cfg, mesh)
        local = shard_state(model.run(model.init_state(), 3), mesh)
        calls[name] = (lambda r=run, s=local, n=steps: r(s, n), steps)
        routes[name] = run.route
    torch.cuda.synchronize()
    out = {k: [] for k in calls}
    order = list(calls)
    for k in range(runs):
        for name in order if k % 2 == 0 else order[::-1]:
            fn, steps = calls[name]
            out[name].append(_events_ms(fn) / steps)
    return {name: {"route": routes[name], "step_ms_runs": v,
                   "step_ms": sum(v) / len(v)} for name, v in out.items()}


def time_kernels(dev: torch.device) -> dict:
    """K16 and K15's sharded form through their wrappers, graph-replayed."""
    rng = np.random.default_rng(22)
    out = {}
    for n in (2048, 1536):
        cfg = preset("turbulence-2048").replace(M=n, P=n)
        consts = PackedModalInverterKernels(
            n, n, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())._sym_consts
        x = torch.as_tensor(rng.standard_normal((2, n, n)),
                            dtype=torch.float32, device=dev)
        out[f"K16 at {n}^2"] = {"graph_ms": _graph_ms(
            lambda: mono_invert(x, consts))}
    turb = preset("turbulence-2048")
    for m in (2048, 512):
        z, p, f1, f2 = (torch.as_tensor(s * rng.standard_normal(
            (2, m, turb.P)), dtype=torch.float32, device=dev)
            for s in (1e-5, 1e3, 1e-9, 1e-9))
        zt, zb = (1e-5 * torch.randn(2, 2, turb.P, device=dev)
                  for _ in range(2))
        pt, pb = (y_dft_plain(1e3 * torch.randn(2, 2, turb.P, device=dev),
                              False) for _ in range(2))
        p_ys = y_dft_plain(p, False)

        def call():
            fused_step_yspec_sharded(turb, z, p_ys, f1, f2, 5, zt, zb, pt,
                                     pb)
        entry = {"graph_ms": _graph_ms(call)}
        if m != turb.M:
            entry["host_enqueue_ms"] = _host_ms(call)
        out[f"K15s on (2, {m}, {turb.P})"] = entry
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("route_timing needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        routes = time_routes(dev, args.runs)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"card": card, "package": tpu_qg_torch.__file__,
                      "routes": routes, "kernels": time_kernels(dev)}),
          flush=True)


if __name__ == "__main__":
    main()

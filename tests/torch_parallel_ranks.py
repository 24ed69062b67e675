"""Rank-side code of the tpu_qg_torch mesh tests: spawned gloo ranks on the
CPU, a ``file://`` rendezvous in a test's temporary directory (no fixed
port), a bounded process-group timeout and a parent join with a deadline.

Imports neither JAX nor tpu_qg, so that each spawned rank starts quickly;
the test modules hold the JAX references. Each rank runs every case it is
given; rank 0 saves the gathered results, which the parent loads."""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

PG_TIMEOUT = datetime.timedelta(seconds=90)


def spawn(world: int, workdir, cases, timeout: float = 240.0) -> dict:
    """Run ``cases`` on ``world`` spawned gloo ranks; returns rank 0's
    results by case name. A rank that fails, or a run past ``timeout``
    seconds, fails the caller (the ranks are killed)."""
    workdir = str(workdir)
    out = os.path.join(workdir, "results.npy")
    ctx = mp.spawn(_rank_main, args=(world, workdir, cases, out),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return np.load(out, allow_pickle=True).item()


def _rank_main(rank: int, world: int, workdir: str, cases, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=world, timeout=PG_TIMEOUT)
    try:
        results = {case["name"]: RUNNERS[case["kind"]](case, workdir)
                   for case in cases}
        if rank == 0:
            np.save(out, results, allow_pickle=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _mesh(case):
    from tpu_qg_torch.parallel import make_mesh
    return make_mesh(case["shape"], device="cpu")


def _numpy(state, fields=("zeta", "psi", "f1")) -> dict:
    out = {f: getattr(state, f).numpy() for f in fields}
    out["step"] = state.step
    return out


def run_steps(case, workdir):
    """``case["steps"]`` steps of the halo stepper from ``psi0`` (one
    make_halo_step_fn call a step, or make_halo_run_fn with ``chain``), or
    of gspmd.make_sharded_step_fn with ``gspmd``; returns the gathered state
    and the route."""
    from tpu_qg_torch.models.core import init_state
    from tpu_qg_torch.parallel import (gather_state, make_halo_run_fn,
                                       make_halo_step_fn, shard_state)
    mesh = _mesh(case)
    cfg = case["cfg"]
    state = shard_state(init_state(cfg, "cpu", psi_init=case["psi0"]), mesh)
    opts = case.get("opts", {})
    if opts.get("gspmd"):
        from tpu_qg_torch.parallel import gspmd
        step = gspmd.make_sharded_step_fn(cfg, mesh)
        state = gspmd.from_blocks(state, mesh)
        for _ in range(case["steps"]):
            state = step(state)
        state, route = gspmd.to_blocks(state), step.route
    elif "chain" in opts:
        run = make_halo_run_fn(cfg, mesh, **opts)
        state, route = run(state, case["steps"]), run.route
    else:
        step = make_halo_step_fn(cfg, mesh, **opts)
        for _ in range(case["steps"]):
            state = step(state)
        route = step.route
    out = _numpy(gather_state(state, mesh))
    out["route"] = route
    return out


def halo(case, workdir):
    """exchange_halo of a (M, P) field's blocks, every rank's padded block
    gathered by mesh rank."""
    from tpu_qg_torch.parallel.collectives import all_gather_blocks
    from tpu_qg_torch.parallel.halo import exchange_halo
    mesh = _mesh(case)
    u = torch.as_tensor(case["field"])
    nx, ny = mesh.shape
    m, p = u.shape[0] // nx, u.shape[1] // ny
    block = u[mesh.ix * m:(mesh.ix + 1) * m, mesh.iy * p:(mesh.iy + 1) * p]
    padded = exchange_halo(block[None].contiguous(), case["h"], mesh)
    # Gather the padded blocks as the tiles of one (nx (m+2h), ny (p+2h))
    # field.
    return all_gather_blocks(padded, mesh)[0].numpy()


def solver(case, workdir):
    """DistributedHelmholtzSolver on a (K, M, P) right-hand side."""
    from tpu_qg_torch.parallel.collectives import all_gather_blocks
    from tpu_qg_torch.parallel.distributed_fft import \
        DistributedHelmholtzSolver
    mesh = _mesh(case)
    f = torch.as_tensor(case["rhs"])
    K, M, P = f.shape
    nx, ny = mesh.shape
    m, p = M // nx, P // ny
    solve = DistributedHelmholtzSolver(M, P, case["dx"], case["alphas"], mesh)
    u = solve(f[:, mesh.ix * m:(mesh.ix + 1) * m,
                mesh.iy * p:(mesh.iy + 1) * p].contiguous())
    return all_gather_blocks(u, mesh).numpy()


def inverter(case, workdir):
    """A distributed packed inverter (``case["cls"]``: "packed", "paired"
    or "packed2d", with ``opts``) on zeta's blocks; psi gathered."""
    from tpu_qg_torch.parallel.collectives import all_gather_blocks
    from tpu_qg_torch.parallel.packed import (DistributedPackedInverter,
                                              DistributedPackedInverter2D)
    from tpu_qg_torch.parallel.paired import PairedDistributedInverter
    mesh = _mesh(case)
    cfg = case["cfg"]
    cls = {"packed": DistributedPackedInverter,
           "paired": PairedDistributedInverter,
           "packed2d": DistributedPackedInverter2D}[case["cls"]]
    inv = cls(cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
              cfg.back_projection_matrix(), mesh, **case.get("opts", {}))
    z = torch.as_tensor(case["zeta"])
    nx, ny = mesh.shape
    m, p = cfg.M // nx, cfg.P // ny
    psi = inv(z[:, mesh.ix * m:(mesh.ix + 1) * m,
                mesh.iy * p:(mesh.iy + 1) * p].contiguous())
    return all_gather_blocks(psi, mesh).numpy()


def run_model_case(case, workdir):
    """run_model on the mesh (``run_opts``: more of its arguments) with
    gathered checkpoints every 2 steps, then a resume to ``steps + 2``;
    returns rank 0's checkpoint steps and the final
    gathered state."""
    from tpu_qg_torch.io import RunReader
    from tpu_qg_torch.models.core import init_state
    from tpu_qg_torch.parallel import gather_state
    from tpu_qg_torch.run import run_model
    mesh = _mesh(case)
    cfg = case["cfg"]
    run_dir = os.path.join(workdir, case["name"])
    state0 = init_state(cfg, "cpu", psi_init=case["psi0"])
    opts = case.get("run_opts", {})
    run_model(cfg, run_dir=run_dir, n_steps=case["steps"], checkpoint_every=2,
              verbose=False, state=state0, mesh=mesh, sample_interval=cfg.dt,
              **opts)
    out = run_model(cfg, run_dir=run_dir, n_steps=case["steps"] + 2,
                    resume=True, verbose=False, mesh=mesh,
                    sample_interval=cfg.dt, **opts)
    result = _numpy(gather_state(out, mesh))
    dist.barrier()
    reader = RunReader(run_dir)
    result["checkpoints"] = reader.checkpoint_steps()
    result["snapshots"] = reader.snapshot_steps()
    return result


def sharded_diagnostics_case(case, workdir):
    """sharded_diagnostics of a state held as the mesh's blocks."""
    from tpu_qg_torch.models.core import init_state
    from tpu_qg_torch.parallel import shard_state
    from tpu_qg_torch.utils.diagnostics import sharded_diagnostics
    mesh = _mesh(case)
    cfg = case["cfg"]
    state = shard_state(init_state(cfg, "cpu", psi_init=case["psi0"]), mesh)
    return sharded_diagnostics(cfg, state._replace(step=case["step"]), mesh)


def _block(mesh, a):
    """This rank's (K, m, p) block of a (K, M, P) array, as a tensor."""
    a = torch.as_tensor(a)
    nx, ny = mesh.shape
    m, p = a.shape[-2] // nx, a.shape[-1] // ny
    return a[:, mesh.ix * m:(mesh.ix + 1) * m,
             mesh.iy * p:(mesh.iy + 1) * p].contiguous()


def mg_solver(case, workdir):
    """DistributedMultigridSolver on a (K, M, P) right-hand side; the
    answer gathered."""
    from tpu_qg_torch.parallel.collectives import all_gather_blocks
    from tpu_qg_torch.parallel.multigrid import DistributedMultigridSolver
    mesh = _mesh(case)
    f = case["rhs"]
    solve = DistributedMultigridSolver(f.shape[1], f.shape[2], case["dx"],
                                       case["alphas"], mesh,
                                       n_cycles=case["cycles"])
    return all_gather_blocks(solve(_block(mesh, f)), mesh).numpy()


def mg_inverter(case, workdir):
    """DistributedMultigridInverter on zeta's blocks, cold, or seeded with
    ``psi_prev``'s blocks; psi gathered."""
    from tpu_qg_torch.parallel.collectives import all_gather_blocks
    from tpu_qg_torch.parallel.multigrid import DistributedMultigridInverter
    mesh = _mesh(case)
    cfg = case["cfg"]
    inv = DistributedMultigridInverter(
        cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
        cfg.back_projection_matrix(), mesh, n_cycles=case["cycles"])
    prev = case.get("psi_prev")
    psi = inv(_block(mesh, case["zeta"]),
              psi_prev=None if prev is None else _block(mesh, prev))
    return all_gather_blocks(psi, mesh).numpy()


def mg_extrapolated(case, workdir):
    """make_halo_run_fn under mg_extrapolate: ``steps`` steps in one call;
    the same steps cut into two calls (``split``), the second from the
    state the first returned; and the second call from a copy of that
    state (the plain seed). Each gathered, with the route."""
    from tpu_qg_torch.models.core import init_state
    from tpu_qg_torch.parallel import (gather_state, make_halo_run_fn,
                                       shard_state)
    mesh = _mesh(case)
    cfg = case["cfg"]
    a, steps = case["split"], case["steps"]

    def start():
        return shard_state(init_state(cfg, "cpu", psi_init=case["psi0"]),
                           mesh)

    run = make_halo_run_fn(cfg, mesh)
    whole = run(start(), steps)
    run = make_halo_run_fn(cfg, mesh)
    first = run(start(), a)
    copy = first._replace(psi=first.psi.clone())
    split = run(first, steps - a)
    restarted = make_halo_run_fn(cfg, mesh)(copy, steps - a)
    return {"route": run.route,
            **{k: _numpy(gather_state(v, mesh)) for k, v in (
                ("whole", whole), ("split", split),
                ("restarted", restarted))}}


def _count_loads():
    """A patch of numpy.load inside tpu_qg_torch.io that records the names
    of the files it opens."""
    from unittest import mock

    import tpu_qg_torch.io as tio
    seen = []
    real = np.load

    def load(path, *args, **kwargs):
        seen.append(os.path.basename(str(path)))
        return real(path, *args, **kwargs)

    return mock.patch.object(tio.np, "load", load), seen


def io_sharded(case, workdir):
    """On each mesh of ``shapes``: this rank's blocks of ``state`` written
    as a checkpoint and a snapshot shard set (the port's writer) under
    ``workdir/name/shape``, read back with load_checkpoint_sharded on the
    same mesh (the files it opens recorded), then tpu_qg's 8-device shard
    set in ``jax_dir`` read with load_checkpoint_sharded. Returns, by
    shape, every rank's largest difference from the expected block, and
    rank 0's opened files."""
    from tpu_qg_torch.io import RunReader, RunWriter
    from tpu_qg_torch.models.core import State
    from tpu_qg_torch.parallel import make_mesh, shard_state
    from tpu_qg_torch.parallel.collectives import all_gather_scalars
    cfg = case["cfg"]
    full = State(*(torch.as_tensor(case["state"][k])
                   for k in ("zeta", "psi", "f1", "f2")),
                 case["state"]["step"])
    jax_full = {k: torch.as_tensor(v) for k, v in case["jax_state"].items()}
    out = {}
    for shape in case["shapes"]:
        mesh = make_mesh(shape, device="cpu")
        run_dir = os.path.join(workdir, case["name"], "x".join(map(str,
                                                                   shape)))
        mine = shard_state(full, mesh)
        writer = RunWriter(run_dir, cfg, write_metadata=mesh.rank == 0)
        writer.write_checkpoint_sharded(mine, mesh)
        writer.write_snapshot_sharded(mine.step, mine.zeta, mine.psi, mesh)
        dist.barrier()
        patch, seen = _count_loads()
        with patch:
            back = RunReader(run_dir).load_checkpoint_sharded(mesh)
        jax_back = RunReader(case["jax_dir"]).load_checkpoint_sharded(mesh)
        want_jax = shard_state(full._replace(**{
            k: jax_full[k] for k in ("zeta", "psi", "f1", "f2")}), mesh)
        diff = torch.tensor([
            max(float((getattr(back, k) - getattr(mine, k)).abs().max()),
                float((getattr(jax_back, k)
                       - getattr(want_jax, k)).abs().max()))
            for k in ("zeta", "psi", "f1", "f2")]
            + [float(back.step != mine.step),
               float(jax_back.step != case["jax_step"])], dtype=torch.float64)
        out[shape] = {"run_dir": run_dir, "opened": seen,
                      "diff": all_gather_scalars(diff, mesh).numpy()}
        dist.barrier()
    return out


def io_resume(case, workdir):
    """run_model on the mesh (``run_opts``: more of its arguments) with
    shard-file checkpoints every 2 steps to ``steps``, a resume to
    ``steps + 2``, and an uninterrupted run of ``steps + 2``; both final
    states gathered, and rank 0's listing of the run directory."""
    from tpu_qg_torch.models.core import init_state
    from tpu_qg_torch.parallel import gather_state
    from tpu_qg_torch.run import run_model
    mesh = _mesh(case)
    cfg = case["cfg"]
    run_dir = os.path.join(workdir, case["name"])
    state0 = init_state(cfg, "cpu", psi_init=case["psi0"])
    opts = case.get("run_opts", {})
    run_model(cfg, run_dir=run_dir, n_steps=case["steps"], checkpoint_every=2,
              verbose=False, state=state0, mesh=mesh, sample_interval=cfg.dt,
              checkpoint_mode="sharded", **opts)
    resumed = run_model(cfg, run_dir=run_dir, n_steps=case["steps"] + 2,
                        resume=True, verbose=False, mesh=mesh,
                        sample_interval=cfg.dt, checkpoint_mode="sharded",
                        **opts)
    whole = run_model(cfg, save_results=False, n_steps=case["steps"] + 2,
                      verbose=False, state=state0, mesh=mesh, **opts)
    result = {"resumed": _numpy(gather_state(resumed, mesh)),
              "whole": _numpy(gather_state(whole, mesh))}
    dist.barrier()
    result["files"] = sorted(os.listdir(run_dir))
    return result


def _placements(t) -> dict:
    """A DTensor's layout: placements, mesh dims and shape, local shape."""
    return {"placements": [(type(p).__name__, getattr(p, "dim", None))
                           for p in t.placements],
            "mesh_dims": t.device_mesh.mesh_dim_names,
            "mesh_shape": tuple(t.device_mesh.shape),
            "mesh_ranks": t.device_mesh.mesh.tolist(),
            "local_shape": tuple(t.to_local().shape)}


def gspmd_run(case, workdir):
    """gspmd.make_sharded_run_fn, ``steps`` steps of the DTensor state from
    ``psi0`` (or make_sharded_step_fn, one call a step, with ``one_step``:
    the step counter after the first); the result gathered by
    ``full_tensor``, with each field's layout."""
    from tpu_qg_torch.models.core import init_state
    from tpu_qg_torch.parallel import gspmd
    mesh = _mesh(case)
    cfg = case["cfg"]
    state = gspmd.shard_state(init_state(cfg, "cpu", psi_init=case["psi0"]),
                              mesh)
    out = {}
    if case.get("one_step"):
        step = gspmd.make_sharded_step_fn(cfg, mesh, donate=False)
        state = step(state)
        out["first_step"] = state.step
        for _ in range(case["steps"] - 1):
            state = step(state)
        out["route"] = step.route
    else:
        run = gspmd.make_sharded_run_fn(cfg, mesh)
        state = run(state, case["steps"])
        out["route"] = run.route
    out.update({f: getattr(state, f).full_tensor().numpy()
                for f in ("zeta", "psi", "f1")})
    out["step"] = state.step
    out["layout"] = {f: _placements(getattr(state, f))
                     for f in ("zeta", "psi", "f1", "f2")}
    return out


def gspmd_comms(case, workdir):
    """CommDebugMode's collectives, by op, over ``_tendencies`` of the
    DTensor state inside ``gspmd.sharded_ops``, and over one sharded step;
    the bytes this rank sends in that step (ring shifts, gathers); the
    sharded tendencies gathered, and the tendencies of the full plain
    fields inside and outside the mode; the error of a grid that does not
    divide over the mesh."""
    from unittest import mock

    from torch.distributed.tensor.debug import CommDebugMode

    from tpu_qg_torch.models.core import _tendencies, init_state
    from tpu_qg_torch.parallel import gspmd
    mesh = _mesh(case)
    cfg = case["cfg"]
    state = gspmd.shard_state(init_state(cfg, "cpu", psi_init=case["psi0"]),
                              mesh)
    step = gspmd.make_sharded_step_fn(cfg, mesh)
    with CommDebugMode() as tend:
        with gspmd.sharded_ops(mesh):
            sharded = _tendencies(cfg, state.zeta, state.psi)
    full = init_state(cfg, "cpu", psi_init=case["psi0"])
    with CommDebugMode() as plain_comm:
        with gspmd.sharded_ops(mesh):
            plain = _tendencies(cfg, full.zeta, full.psi)
    try:
        gspmd.make_sharded_step_fn(cfg.replace(P=cfg.P + 2), mesh)
        bad_grid = None
    except ValueError as e:
        bad_grid = str(e)
    sent = {"ring_shift": 0, "all_gather_blocks": 0, "slabs": {}}

    def shift(t, group, index, size, s, **kwargs):
        if size > 1:
            sent["ring_shift"] += t.numel() * t.element_size()
            key = str(tuple(t.shape))
            sent["slabs"][key] = sent["slabs"].get(key, 0) + 1
        return real_shift(t, group, index, size, s, **kwargs)

    def gather(t, m):
        sent["all_gather_blocks"] += (m.size - 1) * t.numel() \
            * t.element_size()
        return real_gather(t, m)

    real_shift, real_gather = gspmd.ring_shift, gspmd.all_gather_blocks
    with CommDebugMode() as whole, \
            mock.patch.object(gspmd, "ring_shift", shift), \
            mock.patch.object(gspmd, "all_gather_blocks", gather):
        step(state)
    return {"tendencies": {str(k): v for k, v in
                           tend.get_comm_counts().items()},
            "tendencies_sharded": sharded.full_tensor().numpy(),
            "tendencies_plain": plain.numpy(),
            "tendencies_reference": _tendencies(cfg, full.zeta,
                                                full.psi).numpy(),
            "plain_comms": dict(plain_comm.get_comm_counts()),
            "plain_type": type(plain).__name__, "bad_grid": bad_grid,
            "step": {str(k): v for k, v in whole.get_comm_counts().items()},
            "bytes_sent": sent}


def debug_nans_case(case, workdir):
    """run_model with debug_nans on the mesh (``run_opts``) from a state
    with a NaN at ``nan_at`` of ``field``: the error's message."""
    from tpu_qg_torch.models.core import init_state
    from tpu_qg_torch.run import run_model
    mesh = _mesh(case)
    cfg = case["cfg"]
    state = init_state(cfg, "cpu", psi_init=case["psi0"])
    seeded = getattr(state, case["field"]).clone()
    seeded[case["nan_at"]] = float("nan")
    try:
        run_model(cfg, save_results=False, n_steps=case["steps"],
                  verbose=False, state=state._replace(**{case["field"]:
                                                         seeded}),
                  mesh=mesh, debug_nans=True, **case.get("run_opts", {}))
    except FloatingPointError as e:
        return str(e)
    return None


RUNNERS = {"run": run_steps, "halo": halo, "solver": solver,
           "inverter": inverter, "run_model": run_model_case,
           "mg_solver": mg_solver, "mg_inverter": mg_inverter,
           "mg_extrapolated": mg_extrapolated, "io_sharded": io_sharded,
           "io_resume": io_resume,
           "sharded_diagnostics": sharded_diagnostics_case,
           "gspmd_run": gspmd_run, "gspmd_comms": gspmd_comms,
           "debug_nans": debug_nans_case}

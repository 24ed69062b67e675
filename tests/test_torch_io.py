"""Shard sets between the two packages, and run_model's checkpoint_mode on
one device and on a mesh.

A shard set is one ``{kind}_{step:09d}-shard{process:05d}.npz`` per process
with an ``.index.json`` that places each shard in its field. tpu_qg writes
one on the 8-device CPU mesh beside a monolithic checkpoint, and the port's
``RunReader`` must list, assemble and resume from it exactly, and refuse a
set whose shards do not cover every field exactly once. Then four gloo
ranks (one spawn, tests/torch_parallel_ranks.py) write the port's shard
sets on (2, 2) and (4, 1), which tpu_qg's reader must read back exactly;
read them and tpu_qg's set with ``load_checkpoint_sharded`` (a rank of the
same mesh opening only its own file); and resume a (2, 2) run from its
shard files bit for bit.
"""

import json

import numpy as np
import pytest

import tpu_qg
import tpu_qg.io as jio
from tpu_qg.parallel import make_mesh, shard_state
from tpu_qg_torch import io as tio
from tpu_qg_torch import run as trun
from tpu_qg_torch.interop import config_from_jax

import torch_parallel_ranks as ranks

M = 32


def _jax_run_dir(path):
    """A run directory as tpu_qg writes it: a monolithic checkpoint at step
    10, a sharded checkpoint and snapshot at step 20 on a (2, 4) mesh.
    Returns (config, the step-20 state)."""
    jcfg = tpu_qg.preset("turbulence-2048").replace(M=M, P=M, dtype="float64")
    rng = np.random.default_rng(11)
    psi = jcfg.initial_kick * jcfg.U * jcfg.Ly * rng.random((2, M, M))
    model = tpu_qg.QGModel(jcfg)
    s10 = model.run(tpu_qg.init_state(jcfg, psi_init=psi), 10)
    s20 = shard_state(model.run(s10, 10), make_mesh((2, 4)))
    writer = jio.RunWriter(path, jcfg)
    writer.write_checkpoint(s10)
    writer.write_checkpoint_sharded(s20)
    writer.write_snapshot_sharded(20, s20.zeta, s20.psi)
    return jcfg, s20


def test_reader_lists_and_resumes_from_tpu_qg_shard_files(tmp_path):
    jcfg, s20 = _jax_run_dir(tmp_path)
    assert len(list(tmp_path.glob("checkpoint_000000020-shard*.npz"))) == 1
    reader = tio.RunReader(tmp_path)
    assert reader.config() == config_from_jax(jcfg)
    assert reader.checkpoint_steps() == jio.RunReader(
        tmp_path).checkpoint_steps() == [10, 20]
    assert reader.snapshot_steps() == [20]
    got = reader.load_checkpoint(device="cpu")
    want = jio.RunReader(tmp_path).load_checkpoint()
    assert got.step == 20 == int(want.step)
    for name in ("zeta", "psi", "f1", "f2"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(s20, name)))
    assert reader.load_checkpoint(10, device="cpu").step == 10
    z, p = reader.load_snapshot(20)
    np.testing.assert_array_equal(z, np.asarray(s20.zeta))
    np.testing.assert_array_equal(p, np.asarray(s20.psi))


def _tamper(index_path, field, how):
    """Drop one shard of ``field`` from the index, or place it over
    another shard of the same field."""
    index = json.loads(index_path.read_text())
    keys = [k for k, meta in index["shards"].items() if meta["field"] == field]
    assert len(keys) == 8
    if how == "missing":
        del index["shards"][keys[0]]
    else:
        index["shards"][keys[0]]["index"] = index["shards"][keys[1]]["index"]
    index_path.write_text(json.dumps(index))


@pytest.mark.parametrize("how", ["missing", "twice"])
def test_incomplete_shard_set_raises(tmp_path, how):
    _jax_run_dir(tmp_path)
    _tamper(tmp_path / "checkpoint_000000020-shard00000.index.json", "f1",
            how)
    _tamper(tmp_path / "snap_000000020-shard00000.index.json", "zeta", how)
    reader = tio.RunReader(tmp_path)
    assert reader.checkpoint_steps() == [10, 20]
    for load in (lambda: reader.load_checkpoint(device="cpu"),
                 lambda: reader.load_checkpoint(20, device="cpu")):
        with pytest.raises(ValueError, match=r"step 20 .*'f1'"):
            load()
    with pytest.raises(ValueError, match=r"step 20 .*'zeta'"):
        reader.load_snapshot(20)
    assert reader.load_checkpoint(10, device="cpu").step == 10


@pytest.mark.parametrize("mode", ["bogus", "sharded"])
def test_checkpoint_mode_is_checked_on_one_device(tmp_path, mode):
    """An unknown mode raises before anything is written; "sharded" on one
    device writes its checkpoint as one shard file holding whole fields,
    which both packages' readers load (tpu_qg/run.py:122)."""
    cfg = config_from_jax(tpu_qg.preset("turbulence-2048")).replace(M=M, P=M)
    if mode == "bogus":
        with pytest.raises(ValueError, match="unknown checkpoint_mode 'bogus'"):
            trun.run_model(cfg, run_dir=str(tmp_path), n_steps=2,
                           verbose=False, checkpoint_mode=mode, device="cpu")
        assert not list(tmp_path.glob("*.npz"))
        return
    out = trun.run_model(cfg, run_dir=str(tmp_path), n_steps=2, verbose=False,
                         checkpoint_mode=mode, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpoint_000000002-shard00000.index.json",
        "checkpoint_000000002-shard00000.npz", "metadata.json",
        "snap_000000000.npz"]
    index = json.loads((tmp_path / "checkpoint_000000002-shard00000"
                        ".index.json").read_text())
    assert index["shards"]["zeta_2_shard0"] == {
        "field": "zeta", "index": [[0, 2], [0, M], [0, M]]}
    back = jio.RunReader(tmp_path).load_checkpoint()
    assert int(back.step) == 2
    for name in ("zeta", "psi", "f1", "f2"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(out, name).numpy())
        np.testing.assert_array_equal(
            getattr(tio.RunReader(tmp_path).load_checkpoint(device="cpu"),
                    name).numpy(), getattr(out, name).numpy())


# --- Shard sets on four ranks ---------------------------------------------

IO_SHAPES = [(2, 2), (4, 1)]
IO_STEP = 5


def _io_state():
    """A full state of random fields at step IO_STEP."""
    rng = np.random.default_rng(21)
    state = {k: rng.standard_normal((2, M, M)) for k in
             ("zeta", "psi", "f1", "f2")}
    state["step"] = IO_STEP
    return state


RESUME = tpu_qg.preset("turbulence-2048").replace(M=64, P=64,
                                                 dtype="float64")


@pytest.fixture(scope="module")
def shard_runs(tmp_path_factory):
    """The spawn's results and tpu_qg's run directory with the step-20
    state its shard set holds."""
    jax_dir = tmp_path_factory.mktemp("jax_run")
    jcfg, s20 = _jax_run_dir(jax_dir)
    jax_state = {k: np.asarray(getattr(s20, k))
                 for k in ("zeta", "psi", "f1", "f2")}
    rng = np.random.default_rng(3)
    psi0 = (RESUME.initial_kick * RESUME.U * RESUME.Ly
            * rng.random((2, 64, 64)))
    cases = [
        dict(name="io", kind="io_sharded", shapes=IO_SHAPES,
             cfg=config_from_jax(jcfg), state=_io_state(),
             jax_dir=str(jax_dir), jax_state=jax_state, jax_step=20),
        dict(name="resume", kind="io_resume", shape=(2, 2),
             cfg=config_from_jax(RESUME), psi0=psi0, steps=4),
    ]
    return ranks.spawn(4, tmp_path_factory.mktemp("io4"), cases)


@pytest.mark.parametrize("shape", IO_SHAPES)
def test_port_shard_sets_are_read_by_tpu_qg(shard_runs, shape):
    """Four files and four indices for each kind, in tpu_qg's layout, no
    temporary file left; tpu_qg's reader assembles the checkpoint and the
    snapshot exactly."""
    import pathlib
    run_dir = pathlib.Path(shard_runs["io"][shape]["run_dir"])
    names = sorted(p.name for p in run_dir.iterdir())
    assert names == sorted(
        ["metadata.json"]
        + [f"{kind}_{IO_STEP:09d}-shard{r:05d}.{ext}"
           for kind in ("checkpoint", "snap") for r in range(4)
           for ext in ("npz", "index.json")])
    index = json.loads((run_dir / f"checkpoint_{IO_STEP:09d}-shard00003"
                        ".index.json").read_text())
    m, p = M // shape[0], M // shape[1]
    ix, iy = divmod(3, shape[1])
    assert index["step"] == IO_STEP and index["process"] == 3
    assert index["fields"]["f2"] == {"shape": [2, M, M], "dtype": "float64"}
    assert index["shards"][f"psi_{IO_STEP}_shard0"] == {
        "field": "psi", "index": [[0, 2], [ix * m, (ix + 1) * m],
                                  [iy * p, (iy + 1) * p]]}
    want = _io_state()
    reader = jio.RunReader(run_dir)
    assert reader.checkpoint_steps() == reader.snapshot_steps() == [IO_STEP]
    got = reader.load_checkpoint()
    assert int(got.step) == IO_STEP
    for name in ("zeta", "psi", "f1", "f2"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      want[name], err_msg=name)
    z, ps = reader.load_snapshot(IO_STEP)
    np.testing.assert_array_equal(z, want["zeta"])
    np.testing.assert_array_equal(ps, want["psi"])


@pytest.mark.parametrize("shape", IO_SHAPES)
def test_load_checkpoint_sharded_gives_each_rank_its_blocks(shard_runs,
                                                            shape):
    """Every rank's blocks of the port's set and of tpu_qg's 8-device set
    (assembled, then sliced) are exact, with the step; on the mesh that
    wrote it a rank opens its own shard file alone."""
    got = shard_runs["io"][shape]
    assert got["diff"].shape == (4, 6)
    assert not got["diff"].any(), got["diff"]
    assert got["opened"] == [f"checkpoint_{IO_STEP:09d}-shard00000.npz"]


def test_mesh_resumes_from_shard_files_bit_for_bit(shard_runs):
    """A (2, 2) run on the generic route with shard-file checkpoints every
    2 steps and snapshots every step, resumed from its step-4 shard set,
    ends where the uninterrupted run does, bit for bit."""
    got = shard_runs["resume"]
    assert got["resumed"]["step"] == got["whole"]["step"] == 6
    for name in ("zeta", "psi", "f1"):
        np.testing.assert_array_equal(got["resumed"][name],
                                      got["whole"][name], err_msg=name)
    files = got["files"]
    assert not [f for f in files if f.startswith("checkpoint_")
                and "-shard" not in f]
    assert not [f for f in files if f.endswith(".tmp")]
    for step in (2, 4, 6):
        assert {f"checkpoint_{step:09d}-shard{r:05d}.npz"
                for r in range(4)} <= set(files)
    for step in range(1, 7):
        assert {f"snap_{step:09d}-shard{r:05d}.npz"
                for r in range(4)} <= set(files)

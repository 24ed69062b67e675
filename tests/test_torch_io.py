"""The port's run-directory reader on tpu_qg's shard files, and run_model's
checkpoint_mode check on one device.

tpu_qg writes a shard set per step on a mesh (one
``{kind}_{step:09d}-shard{process:05d}.npz`` per process with an
``.index.json`` that places each shard in its field); here it writes one on
the 8-device CPU mesh beside a monolithic checkpoint, and the port's
``RunReader`` must list, assemble and resume from it exactly, and refuse a
set whose shards do not cover every field exactly once.
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


@pytest.mark.parametrize("mode,error,match", [
    ("bogus", ValueError, "unknown checkpoint_mode 'bogus'"),
    ("sharded", NotImplementedError, "sharded")])
def test_checkpoint_mode_is_checked_on_one_device(tmp_path, mode, error,
                                                  match):
    cfg = config_from_jax(tpu_qg.preset("turbulence-2048")).replace(M=M, P=M)
    with pytest.raises(error, match=match):
        trun.run_model(cfg, run_dir=str(tmp_path), n_steps=2, verbose=False,
                       checkpoint_mode=mode, device="cpu")
    assert not list(tmp_path.glob("*.npz"))

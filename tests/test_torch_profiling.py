"""tpu_qg_torch.utils.profiling against tpu_qg.utils.profiling: Timer,
sync, the Chrome trace of a small CPU step, and roofline_report's byte
count (tpu_qg's), with the card's bandwidth from the port's table and no
figure for any other device."""

import json

import pytest
import torch

from tpu_qg.config import preset as jax_preset
from tpu_qg.utils.profiling import roofline_report as jax_roofline
import tpu_qg_torch
from tpu_qg_torch.utils import profiling
from tpu_qg_torch.utils.profiling import (HBM_BANDWIDTH, Timer,
                                          roofline_report, sync, trace)

H100 = "NVIDIA H100 80GB HBM3"


def test_h100_is_the_only_entry():
    assert HBM_BANDWIDTH == {H100: 3.35e12}


def test_timer_sections_and_report():
    t = Timer()
    x = torch.ones(64, 64)
    with t.section("a", result=x):
        x = x @ x
    with t.section("b"):
        sum(range(1000))
    with t.section("a"):
        pass
    assert set(t.times) == {"a", "b"} and all(v > 0 for v in t.times.values())
    report = t.report()
    assert "a" in report and "b" in report and "%" in report
    sync(x)          # a CPU tensor is already done
    sync(3.0)


@pytest.mark.parametrize("preset,over", [
    ("turbulence-2048", {}), ("two-layer-256", {}),
    ("turbulence-2048", {"n_layers": 1, "U": 0.0}),
    ("pod-8192", {})])
def test_roofline_bytes_match_tpu_qg(preset, over):
    cfg = tpu_qg_torch.preset(preset).replace(**over)
    got = roofline_report(cfg, step_seconds=1e-3, device=H100)
    want = jax_roofline(jax_preset(preset).replace(**over),
                        step_seconds=1e-3)
    assert got["estimated_min_bytes"] == want["estimated_min_bytes"]
    assert got["hbm_bandwidth"] == 3.35e12
    assert got["light_speed_seconds"] == got["estimated_min_bytes"] / 3.35e12
    assert got["fraction_of_light_speed"] == pytest.approx(
        got["light_speed_seconds"] / 1e-3, rel=1e-15)
    assert got["step_seconds"] == 1e-3


def test_roofline_reads_the_card_of_a_cuda_device(monkeypatch):
    monkeypatch.setattr(profiling.torch.cuda, "get_device_name",
                        lambda device=None: H100)
    cfg = tpu_qg_torch.preset("turbulence-2048")
    got = roofline_report(cfg, 1e-3, device=torch.device("cuda", 0))
    assert got["hbm_bandwidth"] == 3.35e12
    assert roofline_report(cfg, 1e-3, device="cuda:0") == got


@pytest.mark.parametrize("device", [
    "cpu", torch.device("cpu"), "TPU v5 lite", "NVIDIA A100-SXM4-80GB",
    "NVIDIA H100 PCIe"])
def test_roofline_unknown_device_raises(device):
    cfg = tpu_qg_torch.preset("turbulence-2048")
    with pytest.raises(ValueError, match="no memory bandwidth"):
        roofline_report(cfg, 1e-3, device=device)


def test_trace_writes_a_chrome_trace(tmp_path):
    cfg = tpu_qg_torch.preset("two-layer-256").replace(M=32, P=32)
    model = tpu_qg_torch.QGModel(cfg, device="cpu")
    state = model.init_state()
    with trace(str(tmp_path / "tr")) as prof:
        state = model.run(state, 2)
    assert state.step == 2
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any("fft" in n for n in names), sorted(names)[:20]
    assert prof.key_averages()

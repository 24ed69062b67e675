"""tpu_qg_torch.plotting against tpu_qg.plotting on one run directory that
the port's run_model writes on the CPU (32^2, five snapshots): the same
pixels (plt.imread, exact: both packages draw the same arrays with the same
matplotlib calls), the same spectra, the same animation frames."""

import numpy as np
import pytest
from matplotlib import animation, rcParams
import matplotlib.pyplot as plt
from PIL import Image, ImageSequence

from tpu_qg import plotting as jplot
from tpu_qg.utils.diagnostics import energy_spectrum as jax_spectrum
import tpu_qg_torch
from tpu_qg_torch import plotting as tplot
from tpu_qg_torch.io import RunReader
from tpu_qg_torch.run import run_model
from tpu_qg_torch.utils.diagnostics import energy_spectrum

STEPS = 4


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("plotrun")
    cfg = tpu_qg_torch.preset("two-layer-256").replace(M=32, P=32)
    run_model(cfg, run_dir=str(d), n_steps=STEPS, sample_interval=cfg.dt,
              device="cpu", verbose=False)
    return d


def _frames(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB"))
                for f in ImageSequence.Iterator(im)]


@pytest.mark.parametrize("field,layer,step", [("zeta", 0, None),
                                              ("psi", 1, 2)])
def test_heatmap_pixels_match_tpu_qg(run_dir, tmp_path, field, layer, step):
    got = tplot.plot_heatmap(str(run_dir), step=step, field=field,
                             layer=layer, out_file=str(tmp_path / "t.png"))
    want = jplot.plot_heatmap(str(run_dir), step=step, field=field,
                              layer=layer, out_file=str(tmp_path / "j.png"))
    a, b = plt.imread(got), plt.imread(want)
    assert a.shape == b.shape and np.array_equal(a, b)


def test_heatmap_default_file_name(run_dir):
    out = tplot.plot_heatmap(str(run_dir))
    assert out == str(run_dir / f"zeta_{STEPS}.png")


def test_spectrum_matches_tpu_qg(run_dir, tmp_path):
    got = tplot.plot_spectrum(str(run_dir), out_file=str(tmp_path / "t.png"))
    want = jplot.plot_spectrum(str(run_dir), out_file=str(tmp_path / "j.png"))
    assert np.array_equal(plt.imread(got), plt.imread(want))
    reader = RunReader(run_dir)
    _, psi = reader.load_snapshot(STEPS)
    k, E = energy_spectrum(reader.config(), psi)
    from tpu_qg.io import RunReader as JaxReader
    jk, jE = jax_spectrum(JaxReader(run_dir).config(), psi)
    np.testing.assert_allclose(k, jk, rtol=1e-12)
    np.testing.assert_allclose(E, np.asarray(jE), rtol=1e-12, atol=0)


@pytest.mark.parametrize("max_frames", [None, 2])
def test_gif_frames_are_the_snapshots(run_dir, tmp_path, max_frames):
    """Every snapshot on disk is one frame (no doubled stride), as in
    tpu_qg; max_frames thins them as tpu_qg does."""
    got = tplot.create_animation(str(run_dir), out_file=str(
        tmp_path / "t.gif"), fps=5, max_frames=max_frames)
    want = jplot.create_animation(str(run_dir), out_file=str(
        tmp_path / "j.gif"), fps=5, max_frames=max_frames)
    a, b = _frames(got), _frames(want)
    n = len(RunReader(run_dir).snapshot_steps())
    assert n == STEPS + 1
    assert len(a) == len(b) == (n if max_frames is None else 2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_mp4_without_ffmpeg_raises(run_dir, tmp_path, monkeypatch):
    """mp4 goes through ffmpeg; where it cannot run, its error stands and
    no gif is written instead."""
    monkeypatch.setitem(rcParams, "animation.ffmpeg_path",
                        str(tmp_path / "no-ffmpeg"))
    assert not animation.writers.is_available("ffmpeg")
    with pytest.raises(FileNotFoundError):
        tplot.create_animation(str(run_dir), out_file=str(tmp_path / "a.mp4"))
    assert not list(tmp_path.glob("a.*"))


def test_show_animation_needs_a_display(run_dir, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(RuntimeError, match="needs a display"):
        tplot.show_animation(str(run_dir))


def test_cli(run_dir, tmp_path, capsys):
    out = tmp_path / "h.png"
    tplot.main(["heatmap", str(run_dir), "--field", "psi", "--layer", "1",
                "--out", str(out)])
    assert capsys.readouterr().out.strip() == str(out) and out.exists()
    tplot.main(["spectrum", str(run_dir), "--step", "2"])
    assert capsys.readouterr().out.strip() == str(run_dir / "spectrum_2.png")
    gif = tmp_path / "a.gif"
    tplot.main(["animate", str(run_dir), "--out", str(gif), "--fps", "5"])
    assert len(_frames(gif)) == STEPS + 1

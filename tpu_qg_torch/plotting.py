"""Post-hoc visualization of run directories.

Counterpart of ``tpu_qg.plotting`` (the reference's GLMakie plotting
layer), with the same functions, arguments, defaults, file names and CLI:
  * ``create_animation``  — 2x2 grid (zeta/psi x layer 1/2) over the
    snapshots, saved as mp4 or gif (reference:
    src/plotting/animation.jl:19-89 ``create_mp4``).
  * ``show_animation``    — the same animation in an interactive window.
  * ``plot_heatmap``      — single-frame heatmap of one field and layer
    (reference: src/plotting/heatmap.jl:1-81).
  * ``plot_spectrum``     — the isotropic kinetic-energy spectrum per layer.

    python -m tpu_qg_torch.plotting heatmap RUN_DIR [--field psi --layer 1]
    python -m tpu_qg_torch.plotting animate RUN_DIR --out RUN_DIR/anim.gif
    python -m tpu_qg_torch.plotting spectrum RUN_DIR

Matplotlib on its Agg backend; reads the npz run directories either package
writes, through ``tpu_qg_torch.io.RunReader`` (monolithic files and shard
sets), on the host. Unlike the reference's animation stride quirk (it
doubles the already-doubled sample stride, src/plotting/animation.jl:21),
frames are exactly the snapshots on disk. An animation's writer follows its
file's suffix: ".gif" through pillow, anything else through ffmpeg, whose
own error stands where ffmpeg is missing (no quiet change of format).
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Optional

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from .constants import DAY
from .io import RunReader


def plot_heatmap(run_dir: str, step: Optional[int] = None,
                 out_file: Optional[str] = None, field: str = "zeta",
                 layer: int = 0) -> str:
    """Single-frame heatmap of one field/layer (reference:
    src/plotting/heatmap.jl — hard-coded to top-layer zeta; field/layer are
    parameters here)."""
    reader = RunReader(run_dir)
    steps = reader.snapshot_steps()
    step = steps[-1] if step is None else step
    zeta, psi = reader.load_snapshot(step)
    data = {"zeta": zeta, "psi": psi}[field][layer]
    dt = reader.metadata["dt"]

    fig, ax = plt.subplots(figsize=(8, 4 * data.shape[1] / data.shape[0] + 1))
    im = ax.imshow(data.T, origin="lower", cmap="RdBu_r", aspect="equal")
    ax.set_title(f"{field} layer {layer + 1}, day {step * dt / DAY:.1f}")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.colorbar(im, ax=ax, shrink=0.8)
    out_file = out_file or str(pathlib.Path(run_dir) / f"{field}_{step}.png")
    fig.savefig(out_file, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_file


def _animation_frames(run_dir: str, max_frames: Optional[int]):
    reader = RunReader(run_dir)
    steps = reader.snapshot_steps()
    if max_frames and len(steps) > max_frames:
        steps = steps[:: len(steps) // max_frames + 1]
    return reader, steps


def _build_animation(reader: RunReader, steps, fps: int):
    """Shared 2x2 figure + FuncAnimation (rows: zeta/psi, cols: layers),
    used by both the file writer and the interactive window."""
    from matplotlib import animation

    dt = reader.metadata["dt"]

    z0, p0 = reader.load_snapshot(steps[0])
    n_layers = z0.shape[0]
    fig, axes = plt.subplots(2, n_layers, figsize=(5 * n_layers, 8),
                             squeeze=False)
    images = []
    for row, (name, data) in enumerate([("zeta", z0), ("psi", p0)]):
        for col in range(n_layers):
            ax = axes[row][col]
            im = ax.imshow(data[col].T, origin="lower", cmap="RdBu_r")
            ax.set_title(f"{name} layer {col + 1}")
            ax.set_xticks([])
            ax.set_yticks([])
            images.append(im)
    suptitle = fig.suptitle(f"day {steps[0] * dt / DAY:.1f}")

    def update(frame_idx):
        z, p = reader.load_snapshot(steps[frame_idx])
        for col in range(n_layers):
            images[col].set_data(z[col].T)
            images[col].set_clim(z[col].min(), z[col].max() or 1.0)
            images[n_layers + col].set_data(p[col].T)
            images[n_layers + col].set_clim(p[col].min(), p[col].max() or 1.0)
        suptitle.set_text(f"day {steps[frame_idx] * dt / DAY:.1f}")
        return images

    anim = animation.FuncAnimation(fig, update, frames=len(steps),
                                   interval=1000.0 / fps)
    return fig, anim


def create_animation(run_dir: str, out_file: Optional[str] = None,
                     fps: int = 30, max_frames: Optional[int] = None) -> str:
    """2x2 animation (rows: zeta/psi, cols: layer 1/2) over all snapshots,
    written to mp4 (ffmpeg) or, for a ".gif" ``out_file``, gif (pillow)
    (reference: src/plotting/animation.jl:19-89 ``create_mp4``)."""
    from matplotlib import animation

    reader, steps = _animation_frames(run_dir, max_frames)
    fig, anim = _build_animation(reader, steps, fps)
    if out_file is None:
        out_file = str(pathlib.Path(run_dir) / "animation.mp4")
    writer = (animation.PillowWriter(fps=fps)
              if pathlib.Path(out_file).suffix.lower() == ".gif"
              else animation.FFMpegWriter(fps=fps))
    try:
        anim.save(out_file, writer=writer)
    finally:
        plt.close(fig)
    return out_file


def show_animation(run_dir: str, fps: int = 30,
                   max_frames: Optional[int] = None) -> None:
    """Live on-screen animation window (reference: ``show_animation``,
    src/plotting/animation.jl:91-173 — an interactive GLMakie window). The
    module default backend is Agg for headless use; this switches to an
    interactive backend when a display exists and raises a clear error
    otherwise (the file-writing ``create_animation`` is the headless
    counterpart)."""
    import os

    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        raise RuntimeError(
            "show_animation needs a display (DISPLAY/WAYLAND_DISPLAY unset); "
            "use `python -m tpu_qg_torch.plotting animate <run_dir>` to "
            "write an mp4/gif instead")
    for backend in ("QtAgg", "TkAgg", "GTK4Agg"):
        try:
            plt.switch_backend(backend)
            break
        except Exception:
            continue
    else:
        raise RuntimeError("no interactive matplotlib backend available")
    reader, steps = _animation_frames(run_dir, max_frames)
    fig, anim = _build_animation(reader, steps, fps)
    plt.show()
    plt.close(fig)


def plot_spectrum(run_dir: str, step: Optional[int] = None,
                  out_file: Optional[str] = None) -> str:
    """Isotropic kinetic-energy spectrum per layer at one snapshot."""
    from .utils.diagnostics import energy_spectrum

    reader = RunReader(run_dir)
    steps = reader.snapshot_steps()
    step = steps[-1] if step is None else step
    _, psi = reader.load_snapshot(step)
    cfg = reader.config()
    k, E = energy_spectrum(cfg, psi)

    fig, ax = plt.subplots()
    for layer in range(E.shape[0]):
        mask = E[layer] > 0
        ax.loglog(k[mask], E[layer][mask], label=f"layer {layer + 1}")
    ax.set_xlabel("|k| [1/m]")
    ax.set_ylabel("E(k)")
    ax.set_title(f"KE spectrum, step {step}")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)
    out_file = out_file or str(pathlib.Path(run_dir) / f"spectrum_{step}.png")
    fig.savefig(out_file, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_file


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Plot a run directory's output")
    sub = parser.add_subparsers(dest="cmd", required=True)
    h = sub.add_parser("heatmap")
    h.add_argument("run_dir")
    h.add_argument("--step", type=int, default=None)
    h.add_argument("--field", default="zeta", choices=["zeta", "psi"])
    h.add_argument("--layer", type=int, default=0)
    h.add_argument("--out", default=None)
    a = sub.add_parser("animate")
    a.add_argument("run_dir")
    a.add_argument("--fps", type=int, default=30)
    a.add_argument("--out", default=None)
    a.add_argument("--max-frames", type=int, default=None)
    a.add_argument("--show", action="store_true",
                   help="open an interactive window (needs a display) "
                        "instead of writing a file")
    s = sub.add_parser("spectrum")
    s.add_argument("run_dir")
    s.add_argument("--step", type=int, default=None)
    s.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    if args.cmd == "heatmap":
        out = plot_heatmap(args.run_dir, step=args.step, out_file=args.out,
                           field=args.field, layer=args.layer)
    elif args.cmd == "spectrum":
        out = plot_spectrum(args.run_dir, step=args.step, out_file=args.out)
    elif args.show:
        show_animation(args.run_dir, fps=args.fps,
                       max_frames=args.max_frames)
        return
    else:
        out = create_animation(args.run_dir, out_file=args.out, fps=args.fps,
                               max_frames=args.max_frames)
    print(out)


if __name__ == "__main__":
    main()

"""Skeleton sequence visualization (port of ``stgcn_tpu/utils/visualize.py``).

Counterpart of the reference's ``plot_skeleton`` and ffmpeg conversion
(src/data/util.py:183-253): each frame's joints and bones drawn with
matplotlib, then one video: mp4 through ffmpeg where it is on the PATH,
else an animated GIF through Pillow, else a directory of PNGs.
matplotlib is imported only when something is drawn; without it the
drawing functions raise ``ImportError`` saying so.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np

from stgcn_tpu_torch.graph.skeleton import EDGES


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported at the first
    drawing (the report CLI draws through it too)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_frame(ax, frame: np.ndarray) -> None:
    """Draw one ``(V, 2)`` skeleton on a matplotlib axis: y flipped to
    screen coordinates, bones to joints at (0, 0) (missing) skipped, as in
    the reference (util.py:230-245)."""
    x, y = frame[:, 0], frame[:, 1]
    ax.scatter(x, -y, s=40)
    for a, b in EDGES:
        if (x[a], y[a]) == (0, 0) or (x[b], y[b]) == (0, 0):
            continue
        ax.plot([x[a], x[b]], [-y[a], -y[b]], "g")
    ax.set_aspect("equal", adjustable="box")
    ax.axis("off")


def render_sequence_frames(seq: np.ndarray, out_dir: str,
                           figsize=(3, 8)) -> list[str]:
    """Write one PNG per frame, ``out_dir/<i>.png``; returns the paths."""
    plt = pyplot()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, frame in enumerate(np.asarray(seq)):
        fig, ax = plt.subplots(1, figsize=figsize)
        render_frame(ax, frame)
        p = os.path.join(out_dir, f"{i}.png")
        fig.savefig(p, bbox_inches="tight")
        plt.close(fig)
        paths.append(p)
    return paths


def save_skeleton_video(seq: np.ndarray, out_path: str, fps: int = 30) -> str:
    """Render a ``(T, V, >=2)`` sequence to video; returns the path written:
    ``out_path`` through ffmpeg (the reference's
    ``_convert_images_to_video``, util.py:183-203), else a GIF beside it,
    else a ``<stem>_frames`` directory of PNGs."""
    seq = np.asarray(seq)[:, :, :2]
    if shutil.which("ffmpeg"):
        with tempfile.TemporaryDirectory() as tmp:
            render_sequence_frames(seq, tmp)
            cmd = ["ffmpeg", "-y", "-framerate", str(fps),
                   "-i", os.path.join(tmp, "%d.png"),
                   "-c:v", "libx264", "-pix_fmt", "yuv420p",
                   "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2", out_path]
            subprocess.run(cmd, check=True, capture_output=True)
        return out_path

    plt = pyplot()
    import matplotlib.animation as animation

    gif_path = os.path.splitext(out_path)[0] + ".gif"
    fig, ax = plt.subplots(1, figsize=(3, 8))

    def update(i):
        ax.clear()
        render_frame(ax, seq[i])

    try:
        ani = animation.FuncAnimation(fig, update, frames=len(seq))
        ani.save(gif_path, writer=animation.PillowWriter(fps=fps))
        return gif_path
    except (ImportError, OSError, RuntimeError, ValueError):
        # no Pillow writer (or it failed): the PNG directory
        frame_dir = os.path.splitext(out_path)[0] + "_frames"
        render_sequence_frames(seq, frame_dir)
        return frame_dir
    finally:
        plt.close(fig)

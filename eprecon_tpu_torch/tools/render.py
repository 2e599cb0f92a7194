"""Incremental reconstruction viewer (port of eprecon_tpu/tools/render.py;
reference tools/render.py:8-33, a pyrender window updated with each new
incremental mesh during streaming inference).

matplotlib draws the mesh: in a live window where a display exists, else
headless, one PNG snapshot per mesh update. It watches the
`<out_dir>/incremental` directory that the streaming evaluation writes
with `save_incremental` on. matplotlib is imported when a viewer is made,
never when this module is imported (a GPU host need not have it).

CLI:
  python -m eprecon_tpu_torch.tools.render --dir out/scenes/incremental \
      [--headless snaps/] [--once mesh.ply]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np

from eprecon_tpu_torch.tools.ply_io import read_ply_mesh


class Visualizer:
    """Live mesh viewer (reference tools/render.py Visualizer)."""

    def __init__(self, headless_dir: Optional[str] = None,
                 max_faces: int = 200_000):
        import matplotlib

        self.headless = headless_dir is not None or not os.environ.get("DISPLAY")
        if self.headless:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self.plt = plt
        self.headless_dir = headless_dir or "."
        self.max_faces = max_faces
        self.fig = plt.figure(figsize=(10, 8))
        self.ax = self.fig.add_subplot(111, projection="3d")
        if not self.headless:
            plt.ion()
            plt.show(block=False)
        self._count = 0

    def vis_mesh(self, ply_path: str):
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        verts, faces, colors = read_ply_mesh(ply_path)
        if len(faces) == 0:
            return
        if len(faces) > self.max_faces:  # decimate for drawing speed
            sel = np.linspace(0, len(faces) - 1, self.max_faces).astype(int)
            faces = faces[sel]
        self.ax.cla()
        tri = verts[faces]
        if colors is not None:
            fc = colors[faces[:, 0]].astype(np.float32) / 255.0
        else:
            # shade by normal z for depth cues
            n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
            nz = np.abs(n[:, 2]) / (np.linalg.norm(n, axis=1) + 1e-9)
            fc = np.stack([0.4 + 0.5 * nz] * 3, axis=1)
        coll = Poly3DCollection(tri, facecolors=fc, edgecolors="none")
        self.ax.add_collection3d(coll)
        lo, hi = verts.min(0), verts.max(0)
        c = (lo + hi) / 2
        r = (hi - lo).max() / 2
        self.ax.set_xlim(c[0] - r, c[0] + r)
        self.ax.set_ylim(c[1] - r, c[1] + r)
        self.ax.set_zlim(c[2] - r, c[2] + r)
        self.ax.set_title(os.path.basename(ply_path))
        if self.headless:
            out = os.path.join(self.headless_dir,
                               f"view_{self._count:04d}.png")
            os.makedirs(self.headless_dir, exist_ok=True)
            self.fig.savefig(out, dpi=90)
            self._count += 1
            return out
        self.fig.canvas.draw()
        self.fig.canvas.flush_events()

    def close(self):
        self.plt.close(self.fig)


def watch(directory: str, headless_dir: Optional[str] = None,
          poll: float = 1.0, max_updates: Optional[int] = None):
    """Re-render whenever a newer incremental mesh appears."""
    vis = Visualizer(headless_dir)
    seen = None
    n = 0
    try:
        while max_updates is None or n < max_updates:
            plys = sorted(f for f in os.listdir(directory)
                          if f.endswith(".ply") and "semantic" not in f
                          and "instance" not in f)
            if plys and plys[-1] != seen:
                seen = plys[-1]
                vis.vis_mesh(os.path.join(directory, seen))
                n += 1
            time.sleep(poll)
    except KeyboardInterrupt:
        pass
    finally:
        vis.close()
    return n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", help="incremental mesh directory to watch")
    ap.add_argument("--once", help="render a single PLY and exit")
    ap.add_argument("--headless", default=None,
                    help="write PNG snapshots to this dir instead of a window")
    args = ap.parse_args()

    if args.once:
        vis = Visualizer(args.headless)
        out = vis.vis_mesh(args.once)
        if out:
            print(out)
        vis.close()
    elif args.dir:
        watch(args.dir, args.headless)
    else:
        raise SystemExit("pass --dir or --once")


if __name__ == "__main__":
    main()

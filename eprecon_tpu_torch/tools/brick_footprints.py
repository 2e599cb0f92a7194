"""Count the back-projection's brick footprints at the four call shapes of a
full-width fragment, on the CPU: how often a brick's visible voxel corners
meet on one pixel of a view, which bounds what summing a brick's footprint
per pixel (the backward kernel's box) saves over adding every corner to the
gradient in device memory.

    python -m eprecon_tpu_torch.tools.brick_footprints [BRICK ...]

BRICK is XxYxZ (default: 8x8x8 4x8x8 4x4x8 4x4x4; the occupancy init's
grid is a window too).
Per shape and brick it prints the non-empty brick-views, the visible
voxel-corners that carry weight, the distinct (brick-view, pixel) pairs
they land on (one 8-channel sum each, the global atomics of the box path
per vector pair) and their ratio, and quantiles of the box size in pixels
with the f32 box bytes at the shape's channels. Uses the plain projection
(ops/back_project.project_to_view) and the fragment's cameras (seed 0).
"""
from __future__ import annotations

import math
import sys

import torch

from eprecon_tpu_torch.data.synthetic import make_fragment
from eprecon_tpu_torch.ops import back_project as bp
from eprecon_tpu_torch.ops.grid import dense_coords
from eprecon_tpu_torch.tools.bench_back_project import SHAPES

BRICKS = ((8, 8, 8), (4, 8, 8), (4, 4, 8), (4, 4, 4))


def footprints(world, bid, nb, proj, h, w):
    """(non-empty brick-views, corners, distinct (brick, pixel), box pixels
    per non-empty brick-view) over every view."""
    kept = corners = distinct = 0
    areas = []
    for p in proj:
        u, v, m = bp.project_to_view(world, p.float(), h, w)
        b, iu, iv = bid[m], torch.floor(u[m]).long(), torch.floor(v[m]).long()
        if b.numel() == 0:
            continue

        def reduce(x, how, init):
            return torch.full((nb,), init).scatter_reduce(0, b, x, how)

        umin, umax = reduce(iu, "amin", 10 ** 9), reduce(iu, "amax", -1)
        vmin, vmax = reduce(iv, "amin", 10 ** 9), reduce(iv, "amax", -1)
        has = umax >= 0
        kept += int(has.sum())
        areas.append(((vmax + 1).clamp(max=h - 1) - vmin + 1)[has]
                     * ((umax + 1).clamp(max=w - 1) - umin + 1)[has])
        keys = []
        for dy in (0, 1):
            for dx in (0, 1):
                ok = (iu + dx <= w - 1) & (iv + dy <= h - 1)
                corners += int(ok.sum())
                keys.append((b[ok] * h + iv[ok] + dy) * w + iu[ok] + dx)
        distinct += int(torch.unique(torch.cat(keys)).numel())
    return kept, corners, distinct, torch.cat(areas).float()


def main() -> int:
    bricks = ([tuple(int(x) for x in a.split("x")) for a in sys.argv[1:]]
              or list(BRICKS))
    frag = make_fragment(seed=0)
    proj_all = torch.as_tensor(frag["proj_matrices"])
    origin = torch.as_tensor(frag["vol_origin_partial"])
    for name, dim, interval, scale, h, w, c in SHAPES:
        grid = dense_coords(dim, "cpu").reshape(-1, 3)
        world = (grid * interval).float() * 0.04 + origin
        n = grid.shape[0]
        print(f"== {name}: N={n} C={c} {h}x{w}", flush=True)
        for br in bricks:
            gy, gz = math.ceil(dim[1] / br[1]), math.ceil(dim[2] / br[2])
            bid = ((grid[:, 0] // br[0]) * gy + grid[:, 1] // br[1]) * gz + grid[:, 2] // br[2]
            kept, corners, distinct, areas = footprints(
                world, bid, int(bid.max()) + 1, proj_all[:, scale], h, w)
            q = torch.quantile(areas, torch.tensor([0.5, 0.9, 0.99, 1.0])).tolist()
            print(f"  {'x'.join(map(str, br))}: non-empty brick-views {kept}, "
                  f"corners {corners}, distinct (brick, pixel) {distinct}, "
                  f"{corners / distinct:.2f} corners per pixel; box pixels "
                  f"p50/p90/p99/max {q[0]:.0f}/{q[1]:.0f}/{q[2]:.0f}/{q[3]:.0f} "
                  f"({q[0] * c * 4 / 1024:.1f}/{q[1] * c * 4 / 1024:.1f} KB of f32 "
                  f"at C={c})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

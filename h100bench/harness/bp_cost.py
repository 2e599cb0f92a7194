"""The least time the card could take for one back-projection call:
bytes over the HBM rate and f32 operations over the f32 rate, the larger
(a frozen copy of the port's `tools/bench_back_project.py` arithmetic:
`Case.bound`, the forward's bytes in `cases` and the backward's in
`add_backward`). It counts what the function needs from its shapes and
its visible (voxel, view) pairs, whatever implements it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from h100bench.harness.peaks import F32_OPS_PER_S, HBM_BYTES_PER_S

WINDOW_MEAN, VARIANCE = "window_mean", "variance_window"


@dataclasses.dataclass(frozen=True)
class Call:
    """One call: the op, the window's voxels n, views v, the feature
    table's h x w x c, and the visible (voxel, view) pairs."""
    op: str
    n: int
    v: int
    h: int
    w: int
    c: int
    visible: int

    def forward_bytes(self) -> int:
        # table (bf16), projections, origin, output (bf16), count (f32)
        return (self.v * self.h * self.w * self.c * 2 + self.v * 64 + 12
                + self.n * self.c * 2 + self.n * 4)

    def backward_bytes(self) -> int:
        if self.op == VARIANCE:   # ct, count, the table
            nbytes = (self.n * self.c * 2 + self.n * 4
                      + self.v * self.h * self.w * self.c * 2)
        else:                     # ct, count
            nbytes = self.n * self.c * 2 + self.n * 4
        # projections, origin, and dT written once in f32
        return nbytes + self.v * 64 + 12 + self.v * self.h * self.w * self.c * 4

    def bound_s(self, direction: str = "forward") -> Tuple[float, str]:
        """(least seconds, what bounds it)."""
        variance = self.op == VARIANCE
        if direction == "forward":
            nbytes = self.forward_bytes()
            per_vis, per_vox = (11, 4) if variance else (9, 1)
            proj = 1
        else:
            nbytes = self.backward_bytes()
            per_vis, per_vox = (28, 6) if variance else (8, 1)
            proj = 2 if variance else 1
        ops = (proj * self.n * self.v * 22 + self.visible * self.c * per_vis
               + self.n * self.c * per_vox)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / F32_OPS_PER_S
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fragment_calls(mcfg, frag, device):
    """The back-projection calls one fragment needs, from the
    configuration's shapes and the fragment's cameras: the occupancy
    init's variance over its grid, then each stage's window mean; each
    with its visible (voxel, view) pairs, counted by the frozen plain
    projection test."""
    import numpy as np
    import torch

    from h100bench.reference.epr.models.eprecon import channel_plan
    from h100bench.reference.epr.ops.back_project import (_window_world,
                                                          project_to_view)

    ch_init, _, _ = channel_plan(mcfg)
    imgs_hw = np.asarray(frag["imgs_host"].shape[1:3] if "imgs_host" in frag
                         else tuple(frag["imgs"].shape[1:3]))
    proj = torch.as_tensor(frag["proj_matrices"], device=device)
    origin = torch.as_tensor(frag["vol_origin_partial"], device=device)
    v = proj.shape[0]
    n_scales = mcfg.n_scales
    # (op, window dims, interval, feature scale, channels)
    init_interval = 2 ** (n_scales - mcfg.init_stage)
    shapes = [(VARIANCE, tuple(d // init_interval for d in mcfg.n_vox),
               init_interval, n_scales - mcfg.init_stage, 32)]
    for i in range(mcfg.n_layer):
        interval = 2 ** (n_scales - i)
        shapes.append((WINDOW_MEAN, tuple(d // interval for d in mcfg.n_vox),
                       interval, n_scales - i, ch_init[i]))
    calls = []
    for op, dim, interval, scale, c in shapes:
        h, w = (int(x) // (4 * 2 ** scale) for x in imgs_hw)
        world = _window_world(dim, interval, origin.float(), mcfg.voxel_size,
                              device)
        visible = 0
        for vi in range(v):
            visible += int(project_to_view(world, proj[vi, scale].float(), h, w)[2].sum())
        calls.append(Call(op, int(np.prod(dim)), v, h, w, c, visible))
    return calls

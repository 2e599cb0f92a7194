"""The reference as a streaming reconstructor: the frozen model copy and
per-fragment program behind the port's `process_fragment` signature, so
that the harness can put it in the program's place (the control runs it
with TF32 on: the precision below the configuration's TF32-off float32)."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from h100bench.reference.epr.fragment_io import (FragmentInputs,
                                                 PanopticGlobalDense)
from h100bench.reference.epr.models.eprecon import (EPRecon,
                                                    make_recurrent_state)
from h100bench.reference.epr.pipeline import fragment_forward


def set_tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    if not on:
        torch.backends.cudnn.benchmark = False


class Reconstructor:
    """One scene stream, anchored at the first fragment's `anchor`."""

    def __init__(self, mcfg, device, tf32: bool = False, reorder: bool = False):
        """`reorder`: cuDNN picks its fastest algorithms (same precision,
        another order of sums), a stand-in for a change that reorders
        arithmetic and nothing else."""
        self.mcfg, self.device = mcfg, device
        set_tf32(tf32)
        torch.backends.cudnn.benchmark = reorder
        self.model = EPRecon(mcfg).to(device).eval()
        self.scene = None
        self.last_outputs = {}

    def process_fragment(self, scene, imgs, proj_matrices, vol_origin,
                         vol_origin_partial, world_to_aligned_camera,
                         anchor=None):
        m, dev = self.mcfg, self.device
        if scene != self.scene:
            self.scene = scene
            snap = 2 ** m.n_scales
            margin = int(m.origin_margin) // snap * snap
            self.origin = (np.asarray(anchor, np.float32)
                           - np.float32(margin * m.voxel_size))
            self.rec_state = make_recurrent_state(m, dev)
            self.pmap_state = PanopticGlobalDense.empty(
                tuple(m.global_extent), device=dev)
        rel = np.stack([np.round((np.asarray(vol_origin_partial) - self.origin)
                                 / (m.voxel_size * 2 ** (m.n_scales - i))
                                 ).astype(np.int64) for i in range(m.n_layer)])
        frag = FragmentInputs(
            torch.as_tensor(proj_matrices, dtype=torch.float32, device=dev),
            torch.as_tensor(vol_origin_partial, dtype=torch.float32, device=dev),
            torch.as_tensor(world_to_aligned_camera, dtype=torch.float32,
                            device=dev),
            torch.as_tensor(rel, device=dev))
        outputs, _, self.rec_state, self.pmap_state = fragment_forward(
            self.model, SimpleNamespace(model=m),
            torch.as_tensor(np.asarray(imgs), device=dev), frag,
            self.rec_state, self.pmap_state)
        self.last_outputs = outputs

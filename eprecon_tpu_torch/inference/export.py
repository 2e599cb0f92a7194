"""The fragment forward as a serving artifact (torch.export), the
counterpart of eprecon_tpu/inference/export.py.

`export_fragment_forward` traces the complete per-fragment inference
program, `pipeline.fragment_forward` (dual backbones, occupancy init, the
three coarse-to-fine stages with GRU fusion, the panoptic decoder and its
post-processing, the direct global fusion), into one
`torch.export.ExportedProgram` with the call convention of the live
`StreamingReconstructor`:

    (imgs, frag, rec_state, pmap_state) -> (outputs, losses, rec_state,
                                            pmap_state)

What makes one artifact serve a stream:
  * the back-projection kernels are custom ops (`eprecon_tpu_torch::`),
    so the graph records them and a loaded program launches the kernels
    on CUDA tensors (the plain versions on CPU ones);
  * the fragment's window origins (`frag.rel_origins`) are a tensor input,
    read as data by the window slicing, so every fragment position runs
    the same program, as the JAX artifact's traced origins do;
  * the weights are the program's state: `ep.module().load_state_dict`
    swaps in another checkpoint of the same configuration, the counterpart
    of JAX passing `variables` as an argument;
  * the maps are written in place, as the live path writes them: the
    program's peak memory is the live path's.
The JAX package lowers one artifact for ("tpu", "cpu"); here an artifact
exported on the CPU moves to the card at load time
(`serving.load_serving_artifact(path, device="cuda")`). No compiler runs:
the artifact is ATen ops and the port's custom ops, executed eagerly.
Saving and loading live in `inference/serving.py`, which a serving
process imports without the model code.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from eprecon_tpu_torch.config import Config
from eprecon_tpu_torch.device import DeviceLike, resolve_device
from eprecon_tpu_torch.fragment_io import FragmentInputs
from eprecon_tpu_torch.inference.pipeline import fragment_forward
from eprecon_tpu_torch.inference.serving import (  # noqa: F401
    load_serving_artifact, save_serving_artifact)
from eprecon_tpu_torch.models.eprecon import EPRecon, make_recurrent_state
from eprecon_tpu_torch.models.gru_fusion import PanopticGlobalDense


class FragmentProgram(nn.Module):
    """`fragment_forward` as a module whose parameters and buffers are the
    model's under the model's own names, so that the exported program's
    state_dict is an EPRecon state_dict."""

    def __init__(self, cfg: Config, model: EPRecon):
        super().__init__()
        for name, child in model.named_children():
            self.add_module(name, child)
        object.__setattr__(self, "model", model)  # not a second submodule
        self.cfg = cfg

    def forward(self, imgs, frag, rec_state, pmap_state):
        # the function inside fragment_forward's no_grad: export traces
        # under no_grad, so the program holds no grad-mode region (whose
        # export pass costs seconds)
        return fragment_forward.__wrapped__(self.model, self.cfg, imgs, frag,
                                            rec_state, pmap_state)


def export_fragment_forward(cfg: Config, model: EPRecon, imgs: torch.Tensor,
                            frag: FragmentInputs, device: DeviceLike = None
                            ) -> torch.export.ExportedProgram:
    """Export the fragment forward of `model` on `device` (CUDA unless
    "cpu"). `imgs` [V, H, W, 3] and `frag` fix the static shapes (views,
    resolution); their values are not baked in. The model moves to the
    device and to eval mode, as `StreamingReconstructor` puts it. The
    program is an inference program: call the returned one under
    `torch.no_grad()` (its parameters are the model's); a loaded one
    computes no gradients (`serving.load_serving_artifact`)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    frag = FragmentInputs(*(torch.as_tensor(x).to(dev) for x in frag))
    args = (torch.as_tensor(imgs).to(dev), frag,
            make_recurrent_state(cfg.model, dev),
            PanopticGlobalDense.empty(tuple(cfg.model.global_extent),
                                      device=dev))
    with torch.no_grad():
        ep = torch.export.export(FragmentProgram(cfg, model), args,
                                 strict=False)
    ep.example_inputs = None  # the empty maps passed above
    return ep

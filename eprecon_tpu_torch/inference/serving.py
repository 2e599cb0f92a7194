"""Load and save the fragment program's serving artifact without the model
code (counterpart of the load half of eprecon_tpu/inference/export.py).

Importing this module is all a serving process needs besides torch: it
registers the back-projection custom ops (`eprecon_tpu_torch::window_mean`,
`::variance` and their backward ops, `ops/back_project.py`) and the pytrees
of the call convention (`fragment_io`). It imports nothing of
`eprecon_tpu_torch.models`. The artifact itself is made by
`inference/export.export_fragment_forward`.

    ep = load_serving_artifact(path)           # onto CUDA; device="cpu" too
    serve = ep.module()
    rec_state, pmap_state = initial_state(ep)  # a new scene's empty maps
    outputs, losses, rec_state, pmap_state = serve(imgs, frag, rec_state,
                                                   pmap_state)

The program writes the recurrent and panoptic maps in place, as the live
`StreamingReconstructor` does; thread the returned states into the next
call (the panoptic map's `next_instance_id` is a new tensor each call).
`serve.load_state_dict(model.state_dict())` swaps in another checkpoint of
the same configuration.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator, Tuple, Union

import torch
import torch.utils._pytree as pytree

from eprecon_tpu_torch.device import DeviceLike, resolve_device
# imported for what they register: the call convention's pytrees, the ops
from eprecon_tpu_torch import fragment_io  # noqa: F401
from eprecon_tpu_torch.ops import back_project  # noqa: F401

NAMESPACE = "eprecon_tpu_torch"

PathLike = Union[str, Path]


def custom_op_nodes(ep: torch.export.ExportedProgram) -> Iterator[str]:
    """The names of the port's custom ops that the program calls, node by
    node, in every graph it holds (the body of its no-grad region
    included)."""
    for gm in ep.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                name = str(node.target)
                if node.op == "call_function" and NAMESPACE in name:
                    yield name


def save_serving_artifact(path: PathLike,
                          ep: torch.export.ExportedProgram) -> None:
    """`torch.export.save`, without the example inputs: they hold the
    global maps of the state passed at export, up to a gigabyte at the
    default extent, and the program does not need them."""
    ep.example_inputs = None
    torch.export.save(ep, str(path))


def load_serving_artifact(path: PathLike, device: DeviceLike = None
                          ) -> torch.export.ExportedProgram:
    """`torch.export.load`, onto `device` (CUDA unless "cpu", as every
    entry point of the port; on CUDA with TF32 off, as the live path runs),
    with parameters that record no gradient.
    A program exported on another device moves there: its weights and the
    devices named in its graph (`move_to_device_pass`), so an artifact
    exported on the CPU serves on the card, where its custom ops dispatch to
    the CUDA kernels."""
    dev = resolve_device(device)
    ep = torch.export.load(str(path))
    if any(t.device != dev for t in ep.state_dict.values()):
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, dev)
    for t in ep.state_dict.values():  # an inference program: no autograd
        t.requires_grad_(False)
    return ep


def initial_state(ep: torch.export.ExportedProgram
                  ) -> Tuple[fragment_io.RecurrentState,
                             fragment_io.PanopticGlobalDense]:
    """A new scene's empty recurrent and panoptic maps for the program, on
    its device, shaped from its own input signature (what
    `make_recurrent_state` and `PanopticGlobalDense.empty` give the live
    path), so a serving process needs no model code to start a stream."""
    user = set(ep.graph_signature.user_inputs)
    fakes = [n.meta["val"] for n in ep.graph.nodes
             if n.op == "placeholder" and n.name in user]
    (_, _, rec, pmap), _ = pytree.tree_unflatten(fakes, ep.call_spec.in_spec)
    dev = next(iter(ep.state_dict.values())).device
    io = fragment_io
    gmaps = tuple(io.DenseGlobalLevel.empty(tuple(g.feats.shape[:3]),
                                            g.feats.shape[3], g.feats.dtype, dev)
                  for g in rec.gmaps)
    tmaps = tuple(io.DenseTargetLevel.empty(tuple(t.tsdf.shape), dev)
                  for t in rec.tmaps)
    return (io.RecurrentState(gmaps, tmaps),
            io.PanopticGlobalDense.empty(tuple(pmap.tsdf.shape), device=dev))

"""Checkpoints of the training step (port of eprecon_tpu/train/checkpoint.py
:24-78; reference main.py:186-219, 343-348): model, optimizer state, step
and epoch under the reference's `model_%06d` names, with torch.save and
torch.load(weights_only=True). Every restore also takes the JAX package's
own checkpoints, orbax directories recognised by their `_METADATA`: they
go through tools/import_jax_checkpoint.py, which needs `tensorstore` (on a
host without it, convert them there first with that tool). Across ranks
rank 0 writes and every rank restores onto its own device.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.nn as nn

from eprecon_tpu_torch.parallel import mesh
from eprecon_tpu_torch.tools import import_jax_checkpoint as jax_ckpt
from eprecon_tpu_torch.train.state import Trainer


def save_checkpoint(logdir: str, epoch: int, trainer: Trainer) -> str:
    """Save under <logdir>/model_<epoch:06d>; returns the path. Across
    ranks, rank 0 writes (every rank holds the same state) and then all
    ranks meet at a barrier, so none reads the file before it exists."""
    path = os.path.join(logdir, f"model_{epoch:06d}")
    if mesh.is_main_process():
        os.makedirs(logdir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(trainer.state_dict(), tmp)
        os.replace(tmp, path)
    mesh.synchronize()
    return path


def latest_checkpoint(logdir: str) -> Optional[str]:
    if not os.path.isdir(logdir):
        return None
    cands = [d for d in os.listdir(logdir) if re.fullmatch(r"model_\d{6}", d)]
    return os.path.join(logdir, sorted(cands)[-1]) if cands else None


def restore_checkpoint(path: str, trainer: Trainer) -> Trainer:
    """Restore model, optimizer, step and epoch into `trainer`."""
    if jax_ckpt.is_orbax_checkpoint(path):
        return jax_ckpt.jax_state_to_port(jax_ckpt.read_orbax_tree(path), trainer)
    trainer.load_state_dict(torch.load(path, map_location=trainer.device,
                                       weights_only=True))
    return trainer


def restore_model(path: str, model: nn.Module) -> nn.Module:
    """Load the model of a checkpoint into `model` (reference main.py:
    362-367, the test-mode load_state_dict)."""
    if jax_ckpt.is_orbax_checkpoint(path):
        return jax_ckpt.jax_state_to_port(jax_ckpt.read_model_tree(path), model)
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=device,
                                     weights_only=True)["model"])
    return model


def restore_submodule(path: str, model: nn.Module, prefix: str) -> nn.Module:
    """Warm-start only the tensors of `model` whose state_dict name starts
    with `prefix` (flax '/' paths are accepted), from the model of a
    checkpoint, the port's or the JAX package's (reference main.py:
    208-219; the JAX package's finetune_layer warm start,
    eprecon_tpu/train/checkpoint.py:63-78)."""
    prefix = prefix.replace("/", ".")
    if jax_ckpt.is_orbax_checkpoint(path):
        saved = jax_ckpt.model_state(jax_ckpt.read_model_tree(path), model)
    else:
        saved = torch.load(path, map_location="cpu", weights_only=True)["model"]
    state = model.state_dict()
    with torch.no_grad():
        for name, value in saved.items():
            if name.startswith(prefix) and name in state:
                state[name].copy_(value)
    return model

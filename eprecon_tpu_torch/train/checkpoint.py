"""Checkpoints of the training step (port of eprecon_tpu/train/checkpoint.py
:24-78; reference main.py:186-219, 343-348): model, optimizer state, step
and epoch under the reference's `model_%06d` names, with torch.save and
torch.load(weights_only=True). The JAX package's orbax checkpoints are not
read; carry flax trees over with convert.variables_to_torch.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.nn as nn

from eprecon_tpu_torch.train.state import Trainer


def save_checkpoint(logdir: str, epoch: int, trainer: Trainer) -> str:
    """Save under <logdir>/model_<epoch:06d>; returns the path."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"model_{epoch:06d}")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(trainer.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(logdir: str) -> Optional[str]:
    if not os.path.isdir(logdir):
        return None
    cands = [d for d in os.listdir(logdir) if re.fullmatch(r"model_\d{6}", d)]
    return os.path.join(logdir, sorted(cands)[-1]) if cands else None


def restore_checkpoint(path: str, trainer: Trainer) -> Trainer:
    """Restore model, optimizer, step and epoch into `trainer`."""
    trainer.load_state_dict(torch.load(path, map_location=trainer.device,
                                       weights_only=True))
    return trainer


def restore_model(path: str, model: nn.Module) -> nn.Module:
    """Load the model of a checkpoint into `model` (reference main.py:
    362-367, the test-mode load_state_dict)."""
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=device,
                                     weights_only=True)["model"])
    return model


def restore_submodule(path: str, model: nn.Module, prefix: str) -> nn.Module:
    """Warm-start only the tensors of `model` whose state_dict name starts
    with `prefix` (flax '/' paths are accepted), from the model of a
    checkpoint (reference main.py:208-219)."""
    prefix = prefix.replace("/", ".")
    saved = torch.load(path, map_location="cpu", weights_only=True)["model"]
    state = model.state_dict()
    with torch.no_grad():
        for name, value in saved.items():
            if name.startswith(prefix) and name in state:
                state[name].copy_(value)
    return model

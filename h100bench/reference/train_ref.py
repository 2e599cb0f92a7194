"""The reference's training step: the frozen model copy's forward with
targets, torch.autograd.grad over the named parameters, across ranks the
mean of the gradients and the loss terms (one all-reduce of plain
torch.distributed), and the frozen optimizer copy. The harness replays
the program's checked steps with it, and puts it in the program's place
for the control."""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from h100bench.reference.epr.models.eprecon import (EPRecon,
                                                    make_recurrent_state)
from h100bench.reference.epr.train.optim import Optimizer


def _mean_over_ranks(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


class Trainer:
    """Model, optimizer and step; the model's remat mode is "none" (a
    recompute changes no result)."""

    def __init__(self, mcfg, tcfg, sd: Dict[str, torch.Tensor], device,
                 steps_per_epoch: float = 1000):
        import dataclasses
        self.mcfg = dataclasses.replace(mcfg, remat_mode="none")
        self.device = device
        self.model = EPRecon(self.mcfg).to(device).train()
        if sd is not None:
            self.model.load_state_dict(sd)
        params = dict(self.model.named_parameters())
        self.optimizer = Optimizer(params, tcfg, steps_per_epoch)

    def recurrent_state(self):
        return make_recurrent_state(self.mcfg, self.device)

    def step(self, imgs, frag, targets, rec):
        outputs, losses, new_rec = self.model(imgs, frag, rec, targets)
        names = list(self.optimizer.params)
        params = [self.optimizer.params[n] for n in names]
        grads = torch.autograd.grad(losses["total_loss"], params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        metrics = {k: v.detach() for k, v in losses.items()}
        out = _mean_over_ranks([*grads, *metrics.values()])
        grads, metrics = out[:len(grads)], dict(zip(metrics, out[len(grads):]))
        opt = self.optimizer
        if opt.mini_step == opt.cfg.accumulation_steps - 1:
            # the accumulated gradient the update is about to take
            n = opt.mini_step
            self.update_grad = {k: opt.acc[k] + (g.float() - opt.acc[k]) / (n + 1)
                                for k, g in zip(names, grads)}
        opt.step(dict(zip(names, grads)))
        return new_rec, metrics

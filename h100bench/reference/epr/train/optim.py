"""Frozen copy of the port's optimizer: optax's MultiSteps(chain(
clip_by_global_norm, adam(piecewise schedule))) over named parameters."""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from h100bench.reference.epr.config import TrainConfig

# parameter-name prefixes frozen by `finetune_layer` (reference main.py:221-230)
FROZEN_PREFIXES = {"init": ("backbone2d", "neucon_net.initialization")}
ADAM_EPS = 1e-8


def parse_lr_epochs(spec: str) -> Tuple[List[int], float]:
    """'70,90:10' -> ([70, 90], 0.1) (reference main.py:245-253)."""
    miles, gamma = spec.split(":")
    return [int(m) for m in miles.split(",")], 1.0 / float(gamma)


def learning_rate(cfg: TrainConfig, steps_per_epoch: float, update: int) -> float:
    """The rate of optimizer update `update` (0-based): lr, times gamma
    for each milestone epoch * steps_per_epoch it has reached, in f32 as
    optax's piecewise_constant_schedule computes it. The schedule counts
    updates, so `steps_per_epoch` is updates per epoch (the CLI passes
    micro-steps / accumulation_steps, which may be fractional)."""
    miles, gamma = parse_lr_epochs(cfg.lr_epochs)
    lr = np.float32(cfg.lr)
    for m in sorted(set(m * steps_per_epoch for m in miles)):
        if update >= m:
            lr = np.float32(gamma) * lr
    return float(lr)


def frozen_names(names: Sequence[str], finetune_layer: Optional[str]) -> List[str]:
    if finetune_layer is None:
        return []
    prefixes = FROZEN_PREFIXES[finetune_layer]
    return [n for n in names if n.startswith(prefixes)]


class Optimizer:
    """MultiSteps(chain(clip_by_global_norm, adam(schedule)), k) over named
    parameters, as optax computes it. State is f32, beside each parameter."""

    def __init__(self, params: Mapping[str, nn.Parameter], cfg: TrainConfig,
                 steps_per_epoch: float = 1000, frozen: Sequence[str] = ()):
        if cfg.weight_decay:
            raise ValueError("the training recipe has no weight decay")
        self.cfg, self.steps_per_epoch = cfg, steps_per_epoch
        self.frozen = set(frozen)
        self.params = {n: p for n, p in params.items() if n not in self.frozen}
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in self.params.items()}
        self.mu, self.nu, self.acc = zeros(), zeros(), zeros()
        self.mini_step = 0   # micro-steps accumulated since the last update
        self.updates = 0     # updates applied (the schedule's count)

    @torch.no_grad()
    def step(self, grads: Mapping[str, Optional[torch.Tensor]]) -> bool:
        """Take one micro-step's gradients (a missing or None gradient is
        zero; frozen names are ignored). Returns True when it updated the
        parameters."""
        cfg = self.cfg
        n_acc = self.mini_step
        for n, a in self.acc.items():
            g = grads.get(n)
            g = torch.zeros_like(a) if g is None else g.float()
            self.acc[n] = a + (g - a) / (n_acc + 1)
        if self.mini_step < cfg.accumulation_steps - 1:
            self.mini_step += 1
            return False
        norm = torch.sqrt(sum(g.square().sum() for g in self.acc.values()))
        lr = learning_rate(cfg, self.steps_per_epoch, self.updates)
        b1, b2 = cfg.betas
        # bias corrections in f32, as optax forms them: 1 - f32(b)^count
        # (1 - 0.999 differs from 1 - f32(0.999) by 1.3e-5 of itself)
        count = np.float32(self.updates + 1)
        bc1 = float(np.float32(1) - np.float32(b1) ** count)
        bc2 = float(np.float32(1) - np.float32(b2) ** count)
        for n, p in self.params.items():
            g = self.acc[n]
            g = torch.where(norm < cfg.grad_clip, g, g / norm * cfg.grad_clip)
            self.mu[n] = (1 - b1) * g + b1 * self.mu[n]
            self.nu[n] = (1 - b2) * (g * g) + b2 * self.nu[n]
            upd = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + ADAM_EPS)
            p.add_((upd * -lr).to(p.dtype))
            self.acc[n] = torch.zeros_like(g)
        self.updates += 1
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        return dict(mu=self.mu, nu=self.nu, acc=self.acc,
                    mini_step=self.mini_step, updates=self.updates)

    def load_state_dict(self, state: Mapping):
        for key in ("mu", "nu", "acc"):
            mine = getattr(self, key)
            if set(state[key]) != set(mine):
                raise KeyError(f"optimizer {key}: parameter names differ")
            for n in mine:
                mine[n] = state[key][n].to(mine[n].device)
        self.mini_step, self.updates = int(state["mini_step"]), int(state["updates"])

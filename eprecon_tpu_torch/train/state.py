"""Optimizer, learning-rate schedule, freezing and the training step of one
scene stream on one card (port of eprecon_tpu/train/state.py:32-169;
reference main.py:154-348: Adam lr 1e-4, betas (0.9, 0.999), no weight
decay, MultiStepLR '70,90:10', grad clip 1.0, gradient accumulation 8,
staged freezing).

The optimizer is optax's chain written out: clip_by_global_norm, then
adam with a piecewise-constant schedule, under MultiSteps (the running
mean of k micro-steps' gradients, one update every k micro-steps; the
schedule counts updates). Frozen parameters take no update, which is what
zeroing their gradients before the optax chain gives.

Across ranks (parallel/mesh.py, torchrun) the step is the JAX package's
sharded step (eprecon_tpu/train/state.py:171-205): each rank differentiates
its own fragment, then one all-reduce averages the gradients, the metrics
and the BatchNorm running statistics, as its `pmean`s do, and every rank
applies the same optimizer to the same mean. The epoch loop is
train/loop.py.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from eprecon_tpu_torch.config import Config, TrainConfig
from eprecon_tpu_torch.device import DeviceLike, resolve_device
from eprecon_tpu_torch.models.eprecon import (EPRecon, FragmentInputs,
                                              FragmentTargets, RecurrentState,
                                              make_recurrent_state)
from eprecon_tpu_torch.parallel import mesh

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


def fragment_tensors(d: Mapping[str, np.ndarray], rel_origins: np.ndarray,
                     device: torch.device
                     ) -> Tuple[torch.Tensor, FragmentInputs, FragmentTargets]:
    """A synthetic fragment (data/synthetic.make_fragment) on `device`:
    (images, FragmentInputs, FragmentTargets)."""
    t = lambda x: torch.as_tensor(np.array(x), device=device)
    frag = FragmentInputs(t(d["proj_matrices"]).float(),
                          t(d["vol_origin_partial"]).float(),
                          t(d["world_to_aligned_camera"]).float(),
                          t(rel_origins))
    targets = FragmentTargets(tuple(t(x).float() for x in d["tsdf_levels"]),
                              tuple(t(x).bool() for x in d["occ_levels"]),
                              t(d["semantic"]).int(), t(d["instance"]).int())
    return t(d["imgs"]), frag, targets


class Trainer:
    """The training step of one scene stream: forward with targets,
    backward, optimizer, each in a profiler range (train::forward,
    train::backward, train::optimizer; tools/profile_fragment.py --train
    reads them). Batch-statistics BatchNorm updates its running statistics
    on every micro-step, as the JAX step's `batch_stats` do.

    In a process group of more than one rank, each rank steps on its own
    stream: rank 0's parameters and buffers are broadcast at construction,
    and every micro-step averages over the ranks, in one all-reduce
    (train::all_reduce), the trainable parameters' gradients (a None
    gradient is zero), the metrics and the running statistics. Frozen
    parameters take part in no collective. DistributedDataParallel would
    not do: the step differentiates named parameters with
    torch.autograd.grad, some get no gradient, and DDP averages no
    buffers."""

    def __init__(self, cfg: Config, model: EPRecon, device: DeviceLike = None,
                 steps_per_epoch: float = 1000):
        """`device` defaults to CUDA and raises if it is absent; pass
        device="cpu" to run the plain versions on the CPU."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        params = dict(self.model.named_parameters())
        self.optimizer = Optimizer(params, cfg.train, steps_per_epoch,
                                   frozen_names(params, cfg.train.finetune_layer))
        self.step_count = 0  # micro-steps taken
        self.epoch = 0
        # BatchNorm's and MaskedBatchNorm's running statistics, averaged
        # over the ranks as the JAX step's pmean of `batch_stats`
        self.running_stats = [b for n, b in self.model.named_buffers()
                              if n.endswith((".running_mean", ".running_var"))]
        self.distributed = mesh.world_size() > 1
        if self.distributed:
            mesh.broadcast_from_main([*self.model.parameters(),
                                      *self.model.buffers()])

    def recurrent_state(self) -> RecurrentState:
        """A fresh recurrent state for a new scene stream."""
        return make_recurrent_state(self.cfg.model, self.device)

    def step(self, imgs, frag: FragmentInputs, targets: FragmentTargets,
             rec: RecurrentState) -> Tuple[RecurrentState, Dict[str, torch.Tensor]]:
        """One micro-step on one fragment. Returns (the new recurrent
        state, metrics): the loss terms and total, `overflow` and `frag_ok`
        as f32 device scalars (nothing is read back to the host)."""
        self.model.train()
        with record_function("train::forward"):
            outputs, losses, new_rec = self.model(
                torch.as_tensor(imgs, device=self.device), frag, rec, targets,
                only_train_init=self.cfg.train.only_init)
        names = list(self.optimizer.params)
        params = [self.optimizer.params[n] for n in names]
        with record_function("train::backward"):
            grads = torch.autograd.grad(losses["total_loss"], params,
                                        allow_unused=True)
        metrics = {k: v.detach() for k, v in losses.items()}
        dev = self.device
        metrics["overflow"] = torch.as_tensor(
            outputs.get("overflow", 0), device=dev).float()
        metrics["frag_ok"] = torch.as_tensor(
            outputs.get("frag_ok", True), device=dev).float()
        if self.distributed:
            with record_function("train::all_reduce"):
                grads, metrics = self._average(grads, params, metrics)
        with record_function("train::optimizer"):
            self.optimizer.step(dict(zip(names, grads)))
        self.step_count += 1
        return new_rec, metrics

    def _average(self, grads, params, metrics):
        """The mean over the ranks of the gradients (None as zero, so
        every rank's buffer has one layout), the metrics and the running
        statistics, in one all-reduce; the statistics are written back."""
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        n_g, n_m = len(grads), len(metrics)
        out = mesh.all_reduce_mean([*grads, *metrics.values(),
                                    *self.running_stats])
        with torch.no_grad():
            for stat, mean in zip(self.running_stats, out[n_g + n_m:]):
                stat.copy_(mean)
        return out[:n_g], dict(zip(metrics, out[n_g:n_g + n_m]))

    def state_dict(self) -> dict:
        return dict(model=self.model.state_dict(),
                    optimizer=self.optimizer.state_dict(),
                    step=self.step_count, epoch=self.epoch)

    def load_state_dict(self, state: Mapping):
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count, self.epoch = int(state["step"]), int(state["epoch"])

"""The training cells: `Trainer.step` back to back under the published
accumulation, the recurrent state carried through each scene of the
pool and reset at its start, as `train.loop` does; on several ranks,
one process per card, the port's all-reduce every micro-step.

Set-up drives the one Trainer through its first accumulation cycle (the
checked steps, on fragments that all differ) and keeps what the check
compares; the same Trainer then runs the window, which holds whole
accumulation cycles.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import torch

from h100bench.harness import common, weights
from h100bench.harness.common import Record


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-leaf L2 norms, in f64 on the host, in the dict's order."""
    return torch.stack([t.detach().double().norm() for t in tensors.values()]).cpu()


def step_inputs(frag: Dict[str, Any], device, ref: bool):
    """A pool fragment as (images, FragmentInputs, FragmentTargets), the
    port's containers or the reference's."""
    if ref:
        from h100bench.reference.epr.fragment_io import FragmentInputs
        from h100bench.reference.epr.models.eprecon import FragmentTargets
    else:
        from eprecon_tpu_torch.fragment_io import FragmentInputs
        from eprecon_tpu_torch.models.eprecon import FragmentTargets
    f32 = dict(dtype=torch.float32, device=device)
    fi = FragmentInputs(torch.as_tensor(frag["proj_matrices"], **f32),
                        torch.as_tensor(frag["vol_origin_partial"], **f32),
                        torch.as_tensor(frag["world_to_aligned_camera"], **f32),
                        torch.as_tensor(frag["rel"], device=device))
    tg = FragmentTargets(tuple(frag["tsdf_levels"]), tuple(frag["occ_levels"]),
                         frag["semantic"], frag["instance"])
    return frag["imgs"], fi, tg


def stream(pool: List[List[Dict[str, Any]]]):
    """The pool in stream order, cycled: (fragment, first of its scene)."""
    flat = [(f, j == 0) for frags in pool for j, f in enumerate(frags)]
    i = 0
    while True:
        yield flat[i % len(flat)]
        i += 1


@contextlib.contextmanager
def planted(trainer, fault: Optional[str]):
    """The port's step with a fault underneath: "state" returns the
    trainer's state unchanged (no optimizer step); "half" leaves every
    other micro-step's gradient out, the mean taken over the rest;
    "exchange" leaves the all-reduce between the ranks out."""
    if fault is None:
        yield
        return
    opt = trainer.optimizer
    real = opt.step
    if fault == "state":
        opt.step = lambda grads: False
    elif fault == "half":
        def half(grads):
            if opt.mini_step % 2 == 1:   # the running mean stays as it is
                grads = {n: a.clone() for n, a in opt.acc.items()}
            return real(grads)
        opt.step = half
    elif fault == "exchange":
        trainer.distributed = False
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        opt.step = real


def build_trainer(spec, device, system: str):
    from h100bench.harness import config as hc
    if system in ("control", "reorder"):
        from h100bench.reference.serve_ref import set_tf32
        from h100bench.reference.train_ref import Trainer as RefTrainer
        mcfg, tcfg = hc.reference_configs(spec)
        set_tf32(system == "control")
        torch.backends.cudnn.benchmark = system == "reorder"
        return RefTrainer(mcfg, tcfg, None, device), mcfg
    from eprecon_tpu_torch.models.eprecon import EPRecon
    from eprecon_tpu_torch.train.state import Trainer
    cfg = hc.port_config(spec)
    return Trainer(cfg, EPRecon(cfg.model, seed=cfg.seed), device=device), cfg.model


def all_past(past: bool, device) -> bool:
    """Whether the window has closed, decided by all the ranks together
    (any rank's clock past it), so that every rank runs the same cycles."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return past
    flag = torch.tensor([float(past)], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


@contextlib.contextmanager
def timed_optimizer(trainer, spent: List[float]):
    """The host wall of each call of the optimizer's step (the call the
    program's train::optimizer range wraps), appended to `spent`."""
    opt = trainer.optimizer
    real = opt.step

    def step(grads):
        t = time.perf_counter()
        out = real(grads)
        spent.append(time.perf_counter() - t)
        return out

    opt.step = step
    try:
        yield
    finally:
        opt.step = real


def run(spec: Dict[str, Any], traffic: Dict[str, Any], seed: int,
        seconds: float, trace: bool, device, t_start: float, rank: int = 0,
        system: str = "port", fault: Optional[str] = None,
        ranges: Optional[Dict[str, Any]] = None, sample_span: Optional[int] = None):
    """One rank's run: set-up with the checked steps, the window (or one
    traced cycle, then one untraced cycle that times the optimizer's
    step by the host clock, the profiler's cost per launch left out).
    Returns (Record, check inputs)."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trainer, mcfg = build_trainer(spec, device, system)
    sd = weights.seeded_state_dict(trainer.model.state_dict(), seed, device)
    trainer.model.load_state_dict(sd)
    pool = common.make_pool(traffic, spec["inputs"], seed, rank, mcfg, device,
                            with_gt=True)
    feed = stream(pool)
    ref = system != "port"
    acc_steps = int(spec["train"]["accumulation_steps"])
    checked = int(traffic["checked_steps"])
    rec_state = None
    got: Dict[str, Any] = dict(losses=[])
    names = list(trainer.optimizer.params)

    def one_step():
        nonlocal rec_state
        frag, first = next(feed)
        if first:
            rec_state = trainer.recurrent_state()
        imgs, fi, tg = step_inputs(frag, device, ref)
        rec_state, metrics = trainer.step(imgs, fi, tg, rec_state)
        return (frag, first), metrics

    with planted(trainer, fault):
        frags = []
        for s in range(checked):
            frag, metrics = one_step()
            frags.append(frag)
            got["losses"].append({k: float(v) for k, v in metrics.items()
                                  if "loss" in k})
            if s == 0:
                got["grad1"] = leaf_norms(trainer.optimizer.acc)
            if s == 2:
                got["acc3"] = leaf_norms(trainer.optimizer.acc)
        got["update"] = leaf_norms({n: trainer.optimizer.params[n].detach() - sd[n]
                                    for n in names})
        got["names"] = names
        sync()
        record = Record(program="train", views=int(spec["inputs"]["views"]),
                        setup_s=0.0)
        hooks = None
        if trace:
            from h100bench.harness import trace as tr
            hooks = tr.RangeHooks(trainer.model, ranges["modules"],
                                  ranges["functions"])
            prof_cm = tr.profiled()
        else:
            prof_cm = contextlib.nullcontext()
        with prof_cm as prof:
            sync()
            t0 = time.perf_counter()
            record.setup_s = time.time() - t_start
            done = 0
            while True:
                for _ in range(acc_steps):
                    one_step()
                done += acc_steps
                sync()
                if trace or all_past(time.perf_counter() - t0 >= seconds, device):
                    break
            t_end = time.perf_counter()
        if hooks is not None:
            hooks.remove()
        if trace:
            spent: List[float] = []
            with timed_optimizer(trainer, spent):
                for _ in range(acc_steps):
                    one_step()
                sync()
            record.optimizer_host_s, record.optimizer_steps = sum(spent), len(spent)
    record.window_s = t_end - t0
    record.completed = record.attempted = done
    record.peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        from h100bench.harness import trace as tr
        record.trace = tr.summarize(prof, done, record.window_s)
    check = dict(frags=frags, sd=sd, got=got, spec=spec, rank=rank)
    del trainer, rec_state
    common.free_cuda()
    return record, check


def numbers(check: Dict[str, Any], device) -> Dict[str, float]:
    from h100bench.harness.check import train_numbers
    return train_numbers(check, device)


def costs(spec: Dict[str, Any], check: Dict[str, Any], device):
    """(model FLOPs, least back-projection seconds) of one micro-step."""
    from h100bench.harness import bp_cost, config as hc, flops
    mcfg, _ = hc.reference_configs(spec)
    frag = check["frags"][0][0]
    _, _, targets = step_inputs(frag, device, ref=True)
    fl = flops.train_step_flops(mcfg, frag, device, targets)
    bound = sum(c.bound_s("forward")[0] + c.bound_s("backward")[0]
                for c in bp_cost.fragment_calls(mcfg, frag, device))
    common.free_cuda()
    return float(fl), float(bound)

"""The process group of data-parallel training (port of
eprecon_tpu/parallel/mesh.py; reference main.py:67-77, ops/comm.py:9-41).

The JAX package runs one program over a 1-D `data` mesh of devices. The
port runs one process per rank under torchrun, and the process group is
the mesh: each rank carries its own contiguous scene stream and recurrent
state (data/sampler.py), and the training step averages the gradients,
the metrics and the BatchNorm running statistics over the ranks
(train/state.py). `make_mesh`, `replicated` and `data_sharded` therefore
have no counterpart: the parameters are replicated by construction (one
broadcast from rank 0) and each rank holds only its own stream's data.

    torchrun --standalone --nproc_per_node N -m eprecon_tpu_torch.main \\
        --cfg config/train.yaml [--dist-backend nccl|gloo] [KEY VALUE ...]

Backends: `nccl` on CUDA, one card per local rank (`cuda:LOCAL_RANK`;
NCCL refuses two ranks on one card), and `gloo` on the CPU or on CUDA,
where ranks may share a card. `nccl` is the default on CUDA and `gloo` on
the CPU; nothing switches backend by itself. The collectives are
`all_reduce` and `broadcast` only, the two that gloo runs on CUDA
tensors. Agreements of the host (a stop request, a barrier) go over the
CPU: under nccl through a second, gloo group, so that they wait for no
device work.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from eprecon_tpu_torch.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")
# the process group of the host's agreements (None: the default group,
# which is gloo); set by initialize_distributed under nccl
_host_group = None


def env_world_size() -> int:
    """The world size torchrun gives this process (1 outside torchrun)."""
    return int(os.environ.get("WORLD_SIZE") or 1)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """reference ops/comm.py:22-27."""
    return rank() == 0


def rank_device(device: torch.device, backend: str) -> torch.device:
    """The device of this rank: the CPU as asked; on CUDA, the card of
    the local rank under nccl (raises where there are fewer cards than
    local ranks), under gloo the local rank's card modulo the cards, so
    ranks may share one."""
    if device.type != "cuda":
        return device
    if device.index is not None:
        raise ValueError(f"{device}: under torchrun each rank takes its "
                         f"own card; pass the device type only ('cuda')")
    local = int(os.environ.get("LOCAL_RANK") or 0)
    cards = torch.cuda.device_count()
    if backend == "nccl" and local >= cards:
        raise RuntimeError(
            f"nccl needs one card per local rank: local rank {local}, "
            f"{cards} card(s); --dist-backend gloo lets ranks share a card")
    return torch.device("cuda", local % cards)


def initialize_distributed(backend: Optional[str] = None,
                           device: DeviceLike = None,
                           timeout: Optional[datetime.timedelta] = None
                           ) -> torch.device:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this rank's device
    (reference main.py:73-75). With no WORLD_SIZE, or 1, it joins
    nothing and returns `device` resolved (CUDA unless the CPU is asked
    for), as the JAX package's is a no-op on one host. `backend` defaults
    to nccl on CUDA and gloo on the CPU; nccl on the CPU is refused."""
    global _host_group
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA; train on the CPU "
                         "with --dist-backend gloo")
    world = env_world_size()
    if world <= 1:
        return dev
    dev = rank_device(dev, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://", world_size=world,
            rank=int(os.environ["RANK"]),
            timeout=timeout or datetime.timedelta(minutes=30))
        if backend == "nccl":
            _host_group = dist.new_group(backend="gloo")
    return dev


def shutdown_distributed():
    """Leave the process group, if this process joined one."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def synchronize():
    """Barrier of the ranks' hosts (reference ops/comm.py:29-41): a
    one-element all-reduce on the CPU. A no-op with one rank."""
    if world_size() > 1:
        dist.all_reduce(torch.zeros(1), group=_host_group)


def any_rank(*flags: bool) -> Tuple[bool, ...]:
    """Each flag or-ed over the ranks, in one all-reduce on the CPU: every
    rank gets the same answer. The flags themselves with one rank."""
    if world_size() == 1:
        return tuple(bool(f) for f in flags)
    t = torch.tensor([float(bool(f)) for f in flags])
    dist.all_reduce(t, group=_host_group)
    return tuple(x > 0 for x in t.tolist())


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor, through one flat f32 buffer
    on the tensors' device: one collective whatever their number. Each
    result has its input's shape and dtype (f32 results are views of the
    buffer); every rank gets the same bits. The inputs themselves with
    one rank."""
    world = world_size()
    if world == 1:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= world
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].view(t.shape).to(t.dtype))
        at += n
    return out


@torch.no_grad()
def broadcast_from_main(tensors: Sequence[torch.Tensor]):
    """Overwrite each tensor with rank 0's, one broadcast per dtype. A
    no-op with one rank."""
    if world_size() == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=0)
        at = 0
        for t in group:
            t.copy_(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()

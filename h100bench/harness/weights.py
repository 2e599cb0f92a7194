"""Random weights made on the device from the seed.

One normal draw on the card for every weight tensor at once, scaled per
tensor to variance 1 / fan_in (flax's lecun-normal scale, which the
port's own initialiser uses for most layers); biases zero, normalisation
scales one, buffers (running statistics) as the module holds them. The
program and the reference load the same state_dict.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _fan_in(name: str, shape) -> int:
    if len(shape) < 2:
        return 1
    return max(1, math.prod(shape[1:]))


def seeded_state_dict(template: Dict[str, torch.Tensor], seed: int,
                      device) -> Dict[str, torch.Tensor]:
    """A state_dict with `template`'s names, shapes and dtypes: every
    tensor of two or more dimensions drawn from one generator on
    `device`, seeded with `seed`; one-dimensional weights one, biases
    zero; buffers copied."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    drawn = [(n, t) for n, t in template.items()
             if t.is_floating_point() and t.dim() >= 2]
    total = sum(t.numel() for _, t in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    scale = torch.tensor([1.0 / math.sqrt(_fan_in(n, t.shape)) for n, t in drawn],
                         device=device)
    counts = torch.tensor([t.numel() for _, t in drawn], device=device)
    flat.mul_(torch.repeat_interleave(scale, counts, output_size=total))
    out, at = {}, 0
    drawn_names = {n for n, _ in drawn}
    for n, t in template.items():
        if n in drawn_names:
            out[n] = flat[at:at + t.numel()].view(t.shape).to(t.dtype)
            at += t.numel()
        elif t.is_floating_point() and n.endswith(".weight"):
            out[n] = torch.ones(t.shape, dtype=t.dtype, device=device)
        elif t.is_floating_point() and n.endswith(".bias"):
            out[n] = torch.zeros(t.shape, dtype=t.dtype, device=device)
        else:
            out[n] = t.detach().to(device).clone()
    return out

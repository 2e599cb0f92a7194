"""Wall-clock timing of a device function (port of
eprecon_tpu/utils/benchmark.py).

PyTorch returns before the card finishes, so the clock stops only after
`torch.cuda.synchronize()`: enqueue `iters` calls back to back (the card
runs them in order), synchronise once, and divide.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def _sync():
    """Wait for every queued kernel of this process's current card. Held
    to whatever the timed function returns (a dataclass, None, an
    in-place update), so no launch escapes the clock."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(f: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Total wall clock of `iters` enqueued calls divided by iters (ms per
    call). Includes dispatch, excludes the warm-up calls."""
    for _ in range(warmup):
        f(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        f(*args)
    _sync()
    return (time.perf_counter() - t0) * 1e3 / iters

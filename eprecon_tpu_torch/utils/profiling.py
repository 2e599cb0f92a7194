"""Profiling utilities (port of eprecon_tpu/utils/profiling.py).

Reference: ad-hoc memory_profiler/tracemalloc/psutil instrumentation
(main.py:15,173-179,441-449). Here: a torch.profiler trace written as a
Chrome trace (viewable in Perfetto), a trace summary that ranks device
kernels without a UI, and host RSS reporting.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from collections import Counter
from typing import List, Tuple

import torch

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block (host and, where there is a card, CUDA activity)
    and write <logdir>/trace.json in the Chrome trace format."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_NAME))


def summarize_trace(logdir: str, top: int = 20,
                    divide_by: int = 1) -> List[Tuple[str, float, int]]:
    """Rank device kernels by total time from the trace in logdir (host
    operators when the trace holds no kernel: a run without a card).

    Returns [(name, ms, calls)]; prints a table.
    """
    paths = sorted(glob.glob(os.path.join(logdir, TRACE_NAME)))
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    with open(paths[-1]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    chosen = kernels or [e for e in events if e.get("cat") == "cpu_op"]
    agg: Counter = Counter()
    calls: Counter = Counter()
    for e in chosen:
        agg[e["name"]] += e["dur"]
        calls[e["name"]] += 1
    rows = [(n, d / 1000 / divide_by, calls[n]) for n, d in agg.most_common(top)]
    total = sum(agg.values()) / 1000 / divide_by
    where = "device" if kernels else "host operator"
    print(f"total {where} time: {total:.1f} ms")
    for n, ms, k in rows:
        print(f"{ms:9.2f} ms  {k:6d}x  {n[:90]}")
    return rows


def host_memory_mb() -> float:
    """Resident host memory (reference psutil printers, main.py:173-179)."""
    try:
        import psutil
    except ImportError:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return float(line.split()[1]) / 1000.0
        return 0.0
    return psutil.Process().memory_info().rss / 1e6


class StepTimer:
    """Wall-clock per-step timing with running mean
    (reference main.py:269,337 time.time() deltas)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.total = 0.0
        self.count = 0

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        self.total += dt
        self.count += 1
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)

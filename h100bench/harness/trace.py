"""The traced window: named ranges opened from the benchmark's own hooks,
torch.profiler over a fixed number of items, and the reduction of its
events into what the per-layer readers take (`TraceSummary`).

Ranges come from two places: forward hooks on named submodules and
wrappers around named module-level functions (as the port's
`tools/profile_fragment.py` does), each opening a `layer::<label>`
record_function range; and the program's own ranges (`train::*`, the
custom ops `eprecon_tpu_torch::*`). A range's device time is the device
time of the kernels launched inside it, on its own thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Dict, List, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

LAYER = "layer::"


@dataclasses.dataclass
class TraceSummary:
    """What a traced window gives its readers (times in seconds)."""
    items: int                        # fragments or micro-steps traced
    window_s: float                   # host clock over the traced items
    busy_s: float                     # union of device activity
    kernels: int                      # kernel launches
    device_s: float                   # sum of kernel durations
    range_device_s: Dict[str, float]  # label -> device s launched inside
    range_host_s: Dict[str, float]    # label -> host wall s
    op_device_s: Dict[str, float]     # eprecon_tpu_torch::* op -> device s
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


class RangeHooks:
    """Open `layer::<label>` ranges around named submodules' forwards and
    named functions (`module.path:attribute`), until `remove`."""

    def __init__(self, model: torch.nn.Module,
                 modules: Dict[str, Sequence[str]],
                 functions: Dict[str, Sequence[str]]):
        self.handles, self.patched = [], []
        for label, names in modules.items():
            for name in names:
                self._hook(model.get_submodule(name), label)
        for label, targets in functions.items():
            for target in targets:
                mod_name, attr = target.split(":")
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr)
                self.patched.append((mod, attr, fn))
                setattr(mod, attr, _wrapped(fn, label))

    def _hook(self, sub: torch.nn.Module, label: str):
        stack: List = []

        def pre(_m, _a):
            r = record_function(LAYER + label)
            r.__enter__()
            stack.append(r)

        def post(_m, _a, _o):
            stack.pop().__exit__(None, None, None)

        self.handles += [sub.register_forward_pre_hook(pre),
                         sub.register_forward_hook(post)]

    def remove(self):
        for h in self.handles:
            h.remove()
        for mod, attr, fn in self.patched:
            setattr(mod, attr, fn)
        self.handles, self.patched = [], []


def _wrapped(fn, label):
    def run(*a, **kw):
        with record_function(LAYER + label):
            return fn(*a, **kw)
    return run


@contextlib.contextmanager
def profiled():
    """torch.profiler over the block, host and CUDA activity."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _annotation(e) -> bool:
    return (getattr(e, "is_user_annotation", False)
            or e.name.startswith((LAYER, "train::", "ProfilerStep")))


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Total length of the union, and the gaps between its pieces."""
    total, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s <= cur[1]:
            cur[1] = max(cur[1], e)
        else:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def summarize(prof, items: int, window_s: float, top: int = 10) -> TraceSummary:
    """Reduce the profiler's events (microseconds) to a TraceSummary."""
    dev_iv, per_kernel = [], {}
    rdev, rhost, odev = {}, {}, {}
    host = []
    kernels = 0
    device_s = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if _annotation(e):   # a host range's span drawn on the device
                continue
            s, t = e.time_range.start, e.time_range.end
            if t > s:
                dev_iv.append((s, t))
            if "memcpy" in e.name.lower() or "memset" in e.name.lower():
                continue
            kernels += 1
            d = (t - s) / 1e6
            device_s += d
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + d
            continue
        name = e.name
        if name.startswith(LAYER) or name.startswith("train::"):
            key = name[len(LAYER):] if name.startswith(LAYER) else name
            rdev[key] = rdev.get(key, 0.0) + e.device_time_total / 1e6
            rhost[key] = rhost.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
        elif name.startswith("eprecon_tpu_torch::"):
            odev[name] = odev.get(name, 0.0) + e.device_time_total / 1e6
        host.append((e.time_range.start, e.time_range.end, name))
    busy_us, gaps = _union(dev_iv)
    return TraceSummary(
        items=items, window_s=window_s, busy_s=busy_us / 1e6, kernels=kernels,
        device_s=device_s, range_device_s=rdev, range_host_s=rhost,
        op_device_s=odev,
        device_ops=sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=_label_gaps(gaps, host, top))


def _label_gaps(gaps, host, top: int) -> List[Tuple[str, float]]:
    """The longest device-idle gaps, each named by the innermost host
    range or op running at its midpoint (`host` events: start, end, name)."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    out = []
    for s, e in longest:
        mid = (s + e) / 2
        best, best_len = "host (no range)", float("inf")
        for hs, he, name in host:
            if hs <= mid <= he and he - hs < best_len:
                best, best_len = name, he - hs
        out.append((best, (e - s) / 1e6))
    return out

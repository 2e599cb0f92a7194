"""What every cell shares: the run's record, the card's description, the
scene pools of a traffic mix, and the host clock's origin."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from h100bench.harness import scene as sc

ROOT = Path(__file__).resolve().parents[2]       # the checkout
BENCH = ROOT / "h100bench"


def process_start_time() -> float:
    """This process's start on the `time.time()` clock, read from /proc
    (boot time plus the process's start in clock ticks); now where /proc
    does not say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


@dataclasses.dataclass
class Record:
    """One run's measurements, as the metric readers take them."""
    program: str                       # "serve" or "train"
    views: int
    setup_s: float
    window_s: float = 0.0
    completed: int = 0                 # fragments or micro-steps in the window
    attempted: int = 0                 # fragments submitted or micro-steps run
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    ranks: int = 1
    trace: Optional[Any] = None        # TraceSummary of a --trace 1 run
    flops_per_item: float = 0.0        # model FLOPs per fragment / micro-step
    bp_bound_s_per_item: float = 0.0   # least back-projection time per item
    optimizer_host_s: float = 0.0      # host wall of the optimizer's steps,
    optimizer_steps: int = 0           # timed untraced after a traced window


def global_origin(anchor: np.ndarray, mcfg) -> np.ndarray:
    """The global volume's origin from a window-union anchor (the port's
    `ops/grid.anchored_global_origin`)."""
    snap = 2 ** mcfg.n_scales
    margin = int(mcfg.origin_margin) // snap * snap
    return (np.asarray(anchor, np.float32)
            - np.float32(margin * mcfg.voxel_size))


def rel_origins(origin: np.ndarray, g_origin: np.ndarray, mcfg) -> np.ndarray:
    """Window origins per stage in level units (as process_fragment)."""
    return np.stack([
        np.round((np.asarray(origin) - g_origin)
                 / (mcfg.voxel_size * 2 ** (mcfg.n_scales - i))).astype(np.int64)
        for i in range(mcfg.n_layer)])


def make_pool(traffic: Dict[str, Any], inputs: Dict[str, Any], seed: int,
              rank: int, mcfg, device, with_gt: bool) -> List[List[Dict[str, Any]]]:
    """The mix's scenes, each a list of fragments in stream order, drawn
    from (seed, rank, scene): every seed gets the same sizes and counts.
    `inputs` (the configuration's) gives the views per fragment and the
    image size. Each fragment carries its scene's anchor and its
    rel_origins; all lie inside the global extent, or this raises."""
    hw = tuple(inputs["image_hw"])
    scenes = []
    for s in range(traffic["scenes"]):
        rng = np.random.default_rng([int(seed), int(rank), s])
        layout = sc.make_scene(rng, traffic["rooms"], traffic["boxes_per_room"],
                               traffic["room_extent"], traffic["room_pitch"])
        poses = sc.walkthrough(traffic["fragments_per_scene"], inputs["views"],
                               traffic["rooms"], traffic["room_pitch"],
                               traffic["radius"], traffic["height"],
                               float(rng.uniform(0, 2 * np.pi)))
        frags = [sc.make_fragment(layout, p, hw, mcfg.n_vox, mcfg.voxel_size,
                                  device, with_gt) for p in poses]
        anchor = sc.snapped_anchor([f["vol_origin_partial"] for f in frags],
                                   mcfg.voxel_size, mcfg.n_scales)
        g = global_origin(anchor, mcfg)
        hi = np.asarray(mcfg.global_extent) - np.asarray(mcfg.n_vox)
        for f in frags:
            f["anchor"] = anchor
            f["rel"] = rel_origins(f["vol_origin_partial"], g, mcfg)
            if (f["rel"][-1] < 0).any() or (f["rel"][-1] > hi).any():
                raise ValueError(f"traffic: a fragment at {f['rel'][-1]} lies "
                                 f"outside the global extent (0..{hi})")
        scenes.append(frags)
    return scenes


def sample_indices(seed: int, n: int, span: int) -> List[int]:
    """`n` item indices in [0, span), drawn from the seed."""
    rng = np.random.default_rng([int(seed), 17])
    return sorted(rng.choice(span, size=min(n, span), replace=False).tolist())


def free_cuda():
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

"""Train the tiny quality config on one synthetic scene and score the
reconstruction against its analytic GT at chosen steps (port of the JAX
package's tools_dev/quality_pq_experiment.py and of the training loops of
tests/test_quality_loop.py:23-47 and tests/test_quality_pq.py:31-49).

    python -m eprecon_tpu_torch.tools.quality_run [steps] [report_every]
        [--seeds 0,1,2] [--device cpu|cuda] [--deterministic]

The device defaults to CUDA, as every entry point of the port. Each seed
prints its loss at every `report_every` steps (and at step 47, which the
loss-fall floor reads), then its scores after 48 and 100 steps and at
the end. `--deterministic` (`deterministic_mode`) makes a run on the card
repeat bit for bit: the back-projection backward sums in fixed point, and
torch's own ops take their deterministic algorithms, so two runs print
identical lines.

The floors are the JAX package's: the loss at step 47 below 0.7 x the
loss at step 0 (tests/test_quality_loop.py:48), the window F-score above
0.5 after 48 steps (:79), and after 100 steps the F-score above 0.4, at
least one predicted instance and PQ above 0.25
(tests/test_quality_pq.py:53-55). A seed can sit on the cliff that
tests/test_quality_loop.py:71-78 describes (the floor's surface missing,
precision kept), in either package, so a run over seeds is held by the
median over them (`floor_failures`).
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from eprecon_tpu_torch.config import Config
from eprecon_tpu_torch.device import DeviceLike, resolve_device
from eprecon_tpu_torch.models.eprecon import EPRecon
from eprecon_tpu_torch.ops import back_project as bp
from eprecon_tpu_torch.tools.quality_utils import (build_scene_and_fragments,
                                                   score_vs_gt, tiny_cfg)
from eprecon_tpu_torch.train.loop import _scene_origin, fragment_to_device_args
from eprecon_tpu_torch.train.state import Trainer

# the floors of the JAX package's quality tests
LOSS_FALL_STEP, LOSS_FALL_RATIO = 47, 0.7
WINDOW_FSCORE_STEPS, WINDOW_FSCORE_FLOOR = 48, 0.5
PQ_STEPS, FSCORE_FLOOR, PQ_FLOOR = 100, 0.4, 0.25


def deterministic_mode() -> None:
    """torch's deterministic algorithms in raise mode (an op that has none
    raises), cuDNN's benchmark off, and CUBLAS_WORKSPACE_CONFIG=:4096:8,
    which torch reads when it makes its first cuBLAS handle: call it
    before any CUDA work of the process. With it a training run on the
    card repeats bit for bit (the back-projection kernels' sums are
    order-free by themselves). The mode's NaN fill of every torch.empty
    (a debugging aid for reads of memory never written, which nothing
    here does) stays off: at the tiny config's host-bound step it is a
    launch per allocation."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def train_and_score(cfg: Config, steps: int, score_at: Iterable[int] = (),
                    seed: int = 0, device: DeviceLike = None,
                    report_at: Iterable[int] = ()) -> dict:
    """Train EPRecon(cfg.model, seed=seed) for `steps` steps over the
    quality scene's three fragments in turn, with a fresh
    recurrent state at each cycle's start, and score it after each step
    count in `score_at` (quality_utils.score_vs_gt).

    Returns {"losses": {step: {metric: value}} at the steps in
    `report_at` (0-based; read back there and nowhere else),
    "scores": {step count: metrics}, "ms_per_step" (training only, the
    scoring left out), "launches": per step (forward, backward) kernel
    launches (0 on the CPU, where the plain versions run)}."""
    device = resolve_device(device)
    scene, frags, samples = build_scene_and_fragments(cfg)
    origin = _scene_origin(cfg, samples[0])
    args = [fragment_to_device_args(cfg, s, origin, device) for s in samples]
    trainer = Trainer(cfg, EPRecon(cfg.model, seed=seed), device,
                      steps_per_epoch=100)
    report_at, score_at = set(report_at), set(score_at)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    losses: Dict[int, Dict[str, float]] = {}
    scores: Dict[int, Dict[str, float]] = {}
    launches: List[tuple] = []
    train_s = 0.0
    rec = None
    sync()
    t0 = time.perf_counter()
    for it in range(steps):
        i = it % len(args)
        if i == 0:
            rec = trainer.recurrent_state()
        fwd, bwd = bp.total_launches(), bp.total_backward_launches()
        rec, metrics = trainer.step(*args[i], rec)
        launches.append((bp.total_launches() - fwd,
                         bp.total_backward_launches() - bwd))
        if it in report_at:
            names = sorted(metrics)
            vals = torch.stack([metrics[k].float() for k in names]).cpu()
            losses[it] = dict(zip(names, vals.tolist()))
        if it + 1 in score_at:
            sync()
            train_s += time.perf_counter() - t0
            scores[it + 1] = score_vs_gt(cfg, trainer.model, frags, scene,
                                         device)
            t0 = time.perf_counter()
    sync()
    train_s += time.perf_counter() - t0
    return dict(losses=losses, scores=scores, launches=launches,
                ms_per_step=1e3 * train_s / max(steps, 1))


def floor_failures(runs: Sequence[dict]) -> List[str]:
    """The JAX package's floors over runs of train_and_score (each with
    losses at 0 and LOSS_FALL_STEP, scores after WINDOW_FSCORE_STEPS and
    PQ_STEPS): every loss finite, every run's loss falling, and the median
    over the runs clearing the score floors. Returns what failed."""
    bad = []
    for r, run in enumerate(runs):
        tot = {s: v["total_loss"] for s, v in run["losses"].items()}
        if not all(np.isfinite(x) for x in tot.values()):
            bad.append(f"run {r}: non-finite loss {tot}")
        elif not tot[LOSS_FALL_STEP] < LOSS_FALL_RATIO * tot[0]:
            bad.append(f"run {r}: loss at step {LOSS_FALL_STEP} "
                       f"{tot[LOSS_FALL_STEP]:.4f} not below {LOSS_FALL_RATIO} "
                       f"x step 0's {tot[0]:.4f}")
    med = median_scores(runs)
    for key, floor in (((WINDOW_FSCORE_STEPS, "window_fscore"), WINDOW_FSCORE_FLOOR),
                       ((PQ_STEPS, "fscore"), FSCORE_FLOOR),
                       ((PQ_STEPS, "n_pred_inst"), 0),
                       ((PQ_STEPS, "PQ"), PQ_FLOOR)):
        if not med[key] > floor:
            bad.append(f"median {key[1]} after {key[0]} steps {med[key]} "
                       f"not above {floor}")
    return bad


def median_scores(runs: Sequence[dict]) -> Dict[tuple, float]:
    """{(step count, metric): the median over runs} for every score."""
    out = {}
    for s, m in runs[0]["scores"].items():
        for k in m:
            out[s, k] = float(np.median([run["scores"][s][k] for run in runs]))
    return out


def format_run(seed: int, run: dict) -> List[str]:
    """Lines for one run: its losses, then each scored step's metrics."""
    lines = [f"seed {seed} loss " + " ".join(
        f"{s}:{v['total_loss']:.4f}" for s, v in sorted(run["losses"].items()))
        + f" ms/step {run['ms_per_step']:.1f}"]
    for s, m in sorted(run["scores"].items()):
        lines.append(
            f"seed {seed} after {s}: fscore {m['fscore']:.4f} "
            f"(prec {m['prec']:.4f} / recal {m['recal']:.4f}) window fscore "
            f"{m['window_fscore']:.4f} PQ {m['PQ']:.4f} SQ {m['SQ']:.4f} "
            f"RQ {m['RQ']:.4f} instances {m['n_pred_inst']}/{m['n_gt_inst']}")
    return lines


def run_seeds(cfg: Config, seeds: Sequence[int], steps: int = PQ_STEPS,
              device: DeviceLike = None,
              report_at: Iterable[int] = (0, LOSS_FALL_STEP),
              log: Callable[[str], None] = functools.partial(print, flush=True)
              ) -> Tuple[Dict[int, dict], List[str]]:
    """train_and_score at each seed, scored after WINDOW_FSCORE_STEPS and
    PQ_STEPS (those within `steps`) and at `steps`; each run's lines go
    to `log` as it ends. Returns ({seed: run, with its "wall_s"}, what
    failed): on CUDA, a step that did not launch the forward and
    backward kernel of the occupancy init and of every stage; after
    PQ_STEPS or more, the floors (floor_failures)."""
    device = resolve_device(device)
    score_at = {s for s in (WINDOW_FSCORE_STEPS, PQ_STEPS) if s <= steps}
    want = (cfg.model.n_layer + 1,) * 2  # forward, backward
    runs, bad = {}, []
    for seed in seeds:
        t0 = time.perf_counter()
        run = train_and_score(cfg, steps, score_at | {steps}, seed, device,
                              set(report_at) | {0, LOSS_FALL_STEP})
        run["wall_s"] = time.perf_counter() - t0
        runs[seed] = run
        for line in format_run(seed, run):
            log(line)
        log(f"seed {seed} wall {run['wall_s']:.1f} s")
        short = [i for i, n in enumerate(run["launches"]) if n != want]
        if device.type == "cuda" and short:
            bad.append(f"seed {seed}: steps {short[:8]} launched "
                       f"{run['launches'][short[0]]} forward/backward "
                       f"kernels, want {want}")
    if steps >= PQ_STEPS:
        bad += floor_failures(list(runs.values()))
    return runs, bad


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", type=int, nargs="?", default=PQ_STEPS)
    ap.add_argument("report_every", type=int, nargs="?", default=25)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--device", default=None)
    ap.add_argument("--deterministic", action="store_true",
                    help="repeat bit for bit on the card: torch's "
                         "deterministic algorithms, raising where an op "
                         "has none (deterministic_mode)")
    a = ap.parse_args(argv)
    if a.deterministic:
        deterministic_mode()
    report = set(range(0, a.steps, a.report_every)) | {a.steps - 1}
    _, bad = run_seeds(tiny_cfg(), [int(s) for s in a.seeds.split(",")],
                       a.steps, a.device, report)
    print("checks: " + ("pass" if not bad else "; ".join(bad)), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

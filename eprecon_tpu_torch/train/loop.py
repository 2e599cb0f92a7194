"""Training and evaluation loops (port of eprecon_tpu/train/loop.py
:26-377; reference main.py:183-348, the train epoch loop with loss
logging, checkpointing, LR schedule and accumulation, and :351-411, the
streaming test loop with mesh saving).

One scene stream per rank: the loop drives a `Trainer`, carries the
recurrent state across a scene's fragments and resets it when the
(scene, epoch) pair changes. Metrics stay on the device: they are summed
there and read back once per `summary_freq` steps and once per epoch, so
no per-step read-back holds the host while the card works. Across ranks
(`train_epochs_sharded`, parallel/mesh.py) each rank runs the same loop
over its own contiguous shard; the step averages the metrics, so every
rank's means are the means over all streams.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from eprecon_tpu_torch.config import Config
from eprecon_tpu_torch.models.eprecon import FragmentInputs, FragmentTargets
from eprecon_tpu_torch.parallel import mesh
from eprecon_tpu_torch.train import checkpoint as ckpt
from eprecon_tpu_torch.train.state import Trainer


class MetricsMeter:
    """Running means of scalar metrics (reference utils.py:116-135
    DictAverageMeter). The sums are f64 device scalars: `update` reads
    nothing back; `mean` reads every sum in one transfer."""

    def __init__(self):
        self.sums: Dict[str, torch.Tensor] = {}
        self.count = 0

    def update(self, metrics: Dict[str, torch.Tensor]):
        for k, v in metrics.items():
            v = torch.as_tensor(v).detach().to(torch.float64)
            self.sums[k] = self.sums[k] + v if k in self.sums else v
        self.count += 1

    def mean(self) -> Dict[str, float]:
        if not self.sums:
            return {}
        vals = torch.stack(list(self.sums.values())).cpu().tolist()
        return {k: v / max(self.count, 1) for k, v in zip(self.sums, vals)}


def _tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def fragment_targets(data: dict, device: torch.device) -> FragmentTargets:
    """The GT windows of a sample from the data pipeline, on `device`."""
    return FragmentTargets(
        tsdf=tuple(_tensor(t, device, torch.float32) for t in data["tsdf_list"]),
        occ=tuple(_tensor(o, device, torch.bool) for o in data["occ_list"]),
        semantic=(_tensor(data["semantic"], device, torch.int32)
                  if "semantic" in data else None),
        instance=(_tensor(data["instance"], device, torch.int32)
                  if "instance" in data else None))


def fragment_to_device_args(cfg: Config, data: dict, global_origin: np.ndarray,
                            device: torch.device):
    """dict from the data pipeline -> (imgs, FragmentInputs, FragmentTargets
    or None) on `device`."""
    rel = []
    for i in range(cfg.model.n_layer):
        interval = 2 ** (cfg.model.n_scales - i)
        vsz = cfg.model.voxel_size * interval
        rel.append(np.round((data["vol_origin_partial"] - global_origin)
                            / vsz).astype(np.int32))
    frag = FragmentInputs(
        _tensor(data["proj_matrices"], device, torch.float32),
        _tensor(data["vol_origin_partial"], device, torch.float32),
        _tensor(data["world_to_aligned_camera"], device, torch.float32),
        _tensor(np.stack(rel), device))
    targets = fragment_targets(data, device) if "tsdf_list" in data else None
    imgs_np = (np.stack(data["imgs"]) if isinstance(data["imgs"], list)
               else data["imgs"])
    if cfg.model.transfer_images_uint8 and imgs_np.dtype != np.uint8:
        imgs_np = np.clip(np.round(imgs_np), 0, 255).astype(np.uint8)
    return _tensor(imgs_np, device), frag, targets


def _scene_origin(cfg: Config, data: dict) -> np.ndarray:
    """Global dense-volume origin for a new (scene, epoch), the convention
    the streaming pipeline shares: at the dataset's window-union anchor
    ("window_union"), else a slack-capped margin below the scene origin."""
    from eprecon_tpu_torch.ops.grid import (anchored_global_origin,
                                            scene_global_origin)

    m = cfg.model
    anchor = data.get("global_anchor")
    if m.scene_anchor == "window_union" and anchor is not None:
        return anchored_global_origin(anchor, m.n_scales, m.voxel_size,
                                      m.origin_margin)
    return scene_global_origin(
        m.global_extent, m.n_vox, m.n_scales, m.voxel_size,
        np.asarray(data.get("vol_origin", np.zeros(3)), np.float32),
        m.origin_margin)


def _stop_requested() -> bool:
    """Cooperative shutdown: touch the file named by EPRECON_STOP_FILE and
    the train loop checkpoints and returns between steps."""
    stop = os.environ.get("EPRECON_STOP_FILE")
    return bool(stop) and os.path.exists(stop)


# exit code of an RSS-ceiling self-restart (EX_TEMPFAIL): the caller re-runs
# the train CLI with resume=true and training continues from the checkpoint
RSS_RESTART_EXIT_CODE = 75


def _rss_gb() -> float:
    """Current resident set (GB) via /proc/self/statm (not ru_maxrss, which
    is the peak and never decreases)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 30
    except (OSError, ValueError, IndexError):
        return 0.0


def _rss_restart_due() -> bool:
    """With EPRECON_MAX_RSS_GB set, the loop checkpoints and exits
    RSS_RESTART_EXIT_CODE between steps once the host's resident set
    passes it, and a runner re-executes with resume."""
    limit = float(os.environ.get("EPRECON_MAX_RSS_GB", "0") or 0)
    return limit > 0 and _rss_gb() > limit


def _fmt(means: Dict[str, float]) -> str:
    return "{" + ", ".join(f"{k}: {v:.6g}" for k, v in means.items()) + "}"


def train_epochs(cfg: Config, trainer: Trainer,
                 dataset_iter_fn: Callable[[int], Iterable[dict]],
                 epochs: Optional[int] = None,
                 log_fn: Callable[[str], None] = print) -> Trainer:
    """Training loop of this rank's stream from `trainer.epoch` to
    `epochs` (default cfg.train.epochs), checkpointing every `save_freq`
    epochs.

    Every `summary_freq` micro-steps the loop reads the window's metric
    means back in one transfer, logs them and writes them to
    <logdir>/metrics.jsonl with `step_ms` (wall time per micro-step of the
    loop, the sample included) and `sample_ms` (the part spent obtaining
    the sample: read, transforms, GT fusion); the epoch's means are logged
    at its end.

    Across ranks every rank must yield as many samples per epoch (equal
    shards): the stop file and the RSS limit are or-ed over the ranks
    before each step, so all stop at the same step; rank 0 alone logs and
    writes summaries, and checkpoints through rank 0. With one rank the
    agreements are the local checks."""
    from eprecon_tpu_torch.utils.logging import SummaryWriter

    main = mesh.is_main_process()
    writer = SummaryWriter(cfg.logdir) if main else None
    if not main:
        log_fn = lambda _: None  # noqa: E731
    epochs = epochs or cfg.train.epochs
    rec, scene = None, None
    global_origin = np.zeros(3, np.float32)
    window = MetricsMeter()
    win_step_s = win_sample_s = 0.0
    try:
        for epoch in range(trainer.epoch, epochs):
            meter = MetricsMeter()
            t0 = t_prev = time.perf_counter()
            samples = iter(dataset_iter_fn(epoch))
            while True:
                data = next(samples, None)
                t_data = time.perf_counter()
                if data is None:
                    break
                stop, rss_over = mesh.any_rank(_stop_requested(),
                                               _rss_restart_due())
                if stop:
                    log_fn(f"stop file present - checkpointing at step "
                           f"{trainer.step_count} and exiting")
                    ckpt.save_checkpoint(cfg.logdir, epoch, trainer)
                    return trainer
                if rss_over:
                    log_fn(f"host RSS {_rss_gb():.1f} GB over "
                           f"EPRECON_MAX_RSS_GB - checkpointing at step "
                           f"{trainer.step_count} and exiting "
                           f"{RSS_RESTART_EXIT_CODE} for a resume-restart")
                    ckpt.save_checkpoint(cfg.logdir, epoch, trainer)
                    sys.exit(RSS_RESTART_EXIT_CODE)
                # key on (scene, epoch): the augmentation, and with it the
                # window-union anchor, changes at every epoch boundary even
                # when the scene name does not
                if (data.get("scene"), epoch) != scene:
                    scene = (data.get("scene"), epoch)
                    rec = trainer.recurrent_state()
                    global_origin = _scene_origin(cfg, data)
                imgs, frag, targets = fragment_to_device_args(
                    cfg, data, global_origin, trainer.device)
                rec, metrics = trainer.step(imgs, frag, targets, rec)
                meter.update(metrics)
                window.update(metrics)
                now = time.perf_counter()
                win_step_s += now - t_prev
                win_sample_s += t_data - t_prev
                t_prev = now
                if trainer.step_count % cfg.summary_freq == 0 and main:
                    means = window.mean()
                    timing = {"step_ms": 1e3 * win_step_s / window.count,
                              "sample_ms": 1e3 * win_sample_s / window.count}
                    writer.add_scalars("train", {**means, **timing},
                                       trainer.step_count)
                    log_fn(f"step {trainer.step_count}: {_fmt(means)} "
                           f"step_ms={timing['step_ms']:.1f} "
                           f"sample_ms={timing['sample_ms']:.1f}")
                    window = MetricsMeter()
                    win_step_s = win_sample_s = 0.0
            means = meter.mean() if main else {}
            if means.get("overflow", 0.0) > 0:
                log_fn(f"WARNING: mean voxel-capacity overflow "
                       f"{means['overflow']:.0f}/step - raise "
                       f"model.voxel_capacity")
            log_fn(f"epoch {epoch}: {_fmt(means)} "
                   f"({time.perf_counter() - t0:.1f}s)")
            trainer.epoch = epoch + 1
            if (epoch + 1) % cfg.save_freq == 0:
                ckpt.save_checkpoint(cfg.logdir, epoch, trainer)
    finally:
        if writer is not None:
            writer.close()
    return trainer


def iterate_samples(dataset, prefetcher, indices: Iterable[int]):
    """dataset[i] for each index, decoded ahead through `prefetcher`
    (data/prefetch.py) where one is given."""
    if prefetcher is not None:
        yield from prefetcher.iterate(list(indices))
    else:
        for i in indices:
            yield dataset[i]


def train_epochs_sharded(cfg: Config, trainer: Trainer, dataset,
                         prefetcher=None, epochs: Optional[int] = None,
                         log_fn: Callable[[str], None] = print) -> Trainer:
    """Data-parallel training loop (port of eprecon_tpu/train/loop.py
    :195-276; reference datasets/sampler.py:56-76): this rank consumes
    contiguous shard `rank` of `world` (parallel/mesh.py), scene-shuffled
    per epoch where cfg.train.shuffle is set and the dataset names each
    fragment's scene, through `prefetcher` where one is given, with its
    own recurrent state and scene origin; the loop is `train_epochs`, and
    `trainer`'s step averages over the ranks. One rank is one stream over
    the whole dataset."""
    from eprecon_tpu_torch.data.sampler import ContiguousDistributedSampler

    scene_ids = ([f.get("scene") for f in dataset.fragments]
                 if cfg.train.shuffle and hasattr(dataset, "fragments")
                 else None)
    sampler = ContiguousDistributedSampler(
        len(dataset), mesh.world_size(), mesh.rank(),
        shuffle=cfg.train.shuffle and scene_ids is not None,
        seed=cfg.seed, scene_ids=scene_ids)

    def iter_epoch(epoch):
        dataset.epoch = epoch
        sampler.set_epoch(epoch)
        yield from iterate_samples(dataset, prefetcher, list(sampler))

    return train_epochs(cfg, trainer, iter_epoch, epochs, log_fn)


def evaluate(cfg: Config, reconstructor, dataset_iter: Iterable[dict],
             out_dir: Optional[str] = None,
             log_fn: Callable[[str], None] = print,
             with_losses: bool = True,
             gt_dir: Optional[str] = None):
    """Streaming test loop (reference main.py:351-411): feed fragments in
    temporal order, save finished scenes, and, when the dataset carries
    GT, average the loss scalars over the split (summed on the device,
    read back once). With gt_dir set, finished scenes are scored against
    the generated GT volumes (mesh F-score + voxel PQ, written to
    <out_dir>/<scene>_metrics.json). Logs each fragment's wall time (the
    sample included) and the time spent obtaining its sample."""
    from eprecon_tpu_torch.inference.mesh_export import save_scene

    def score_scene(finished):
        if gt_dir is None:
            return
        from eprecon_tpu_torch.tools.evaluation import evaluate_scene_vs_gt

        try:
            m = evaluate_scene_vs_gt(finished, gt_dir)
        except FileNotFoundError:
            return
        if m:
            log_fn(f"scene {finished.name}: "
                   + " ".join(f"{k}={v:.4f}" for k, v in m.items()
                              if isinstance(v, float)))
            if out_dir:
                with open(os.path.join(out_dir,
                                       f"{finished.name}_metrics.json"),
                          "w") as f:
                    json.dump(m, f)

    def finish(result):
        results.append(result)
        if out_dir:
            save_scene(result, out_dir)
        if result.overflow:
            log_fn(f"WARNING: scene {result.name} dropped "
                   f"{result.overflow} voxels to capacity - raise "
                   f"model.voxel_capacity")
        score_scene(result)

    n = 0
    t0 = t_prev = time.perf_counter()
    results, frag_ms = [], []
    loss_sums: Dict[str, torch.Tensor] = {}
    loss_count = 0
    samples = iter(dataset_iter)
    while True:
        data = next(samples, None)
        t_data = time.perf_counter()
        if data is None:
            break
        targets = None
        if with_losses and "tsdf_list" in data:
            targets = fragment_targets(data, reconstructor.device)
        finished = reconstructor.process_fragment(
            scene=data["scene"], imgs=np.stack(data["imgs"]),
            proj_matrices=data["proj_matrices"],
            vol_origin=np.asarray(data["vol_origin"]),
            vol_origin_partial=np.asarray(data["vol_origin_partial"]),
            world_to_aligned_camera=data["world_to_aligned_camera"],
            targets=targets, anchor=data.get("global_anchor"))
        if targets is not None and reconstructor.last_losses:
            for k, v in reconstructor.last_losses.items():
                loss_sums[k] = v if k not in loss_sums else loss_sums[k] + v
            loss_count += 1
        if finished is not None:
            finish(finished)
            log_fn(f"scene {finished.name} done")
        if cfg.save_incremental and out_dir:
            snap = reconstructor.snapshot()
            if snap is not None:
                snap = dataclasses.replace(snap, name=f"{snap.name}_{n:04d}")
                save_scene(snap, os.path.join(out_dir, "incremental"),
                           save_npz=False)
        now = time.perf_counter()
        frag_ms.append(1e3 * (now - t_prev))
        log_fn(f"fragment {n} ({data['scene']}): {frag_ms[-1]:.1f} ms "
               f"(sample {1e3 * (t_data - t_prev):.1f} ms)")
        t_prev = now
        n += 1
    final = reconstructor.flush()
    if final is not None:
        finish(final)
    dt = time.perf_counter() - t0
    if loss_count:
        keys = list(loss_sums)
        vals = torch.stack([loss_sums[k].float() for k in keys]).cpu().tolist()
        means = {k: round(v / loss_count, 4) for k, v in zip(keys, vals)}
        log_fn(f"eval losses over {loss_count} fragments: {means}")
    p50 = float(np.median(frag_ms)) if frag_ms else float("nan")
    log_fn(f"{n} fragments in {dt:.1f}s "
           f"({n * cfg.test.n_views / max(dt, 1e-9):.1f} keyframes/s, "
           f"p50 fragment {p50:.1f} ms)")
    return results

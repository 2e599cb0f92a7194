"""Training / evaluation CLI (port of eprecon_tpu/main.py; reference
main.py:25-449).

  python -m eprecon_tpu_torch.main --cfg config/train.yaml [KEY VALUE ...]
  python -m eprecon_tpu_torch.main --cfg config/test.yaml  [KEY VALUE ...]
  torchrun --standalone --nproc_per_node N -m eprecon_tpu_torch.main \
      --cfg config/train.yaml [--dist-backend nccl|gloo] [KEY VALUE ...]

Runs on CUDA (`--device cuda:N` picks a card) and raises where CUDA is
absent; `--device cpu` runs the plain versions on the CPU. Checkpoints are
the port's own (`train/checkpoint.py`). `train.n_workers` /
`test.n_workers` > 0 decode the frames ahead in that many native threads
(data/prefetch.py); 0 reads them in the loop's thread.

Under torchrun, training is data-parallel (parallel/mesh.py): each rank
trains its own contiguous shard of the fragments on its own device
(nccl: `cuda:LOCAL_RANK`; gloo: ranks may share a card, or run on the
CPU with `--device cpu`), and the step averages over the ranks. Testing
runs in one process, as the JAX CLI builds no mesh for it.

Departure from the JAX CLI: the learning-rate milestones count optimizer
updates, so the schedule is given updates per epoch (micro-steps /
accumulation_steps, unrounded; across ranks the rank's shard length /
accumulation_steps) and each milestone falls within one update of its
epoch's start, as the reference's MultiStepLR does; the JAX CLI gives
micro-steps per epoch and drops the rate accumulation_steps times late.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

from eprecon_tpu_torch.config import Config, load_config, parse_cli_overrides
from eprecon_tpu_torch.device import DeviceLike, resolve_device
from eprecon_tpu_torch.parallel import mesh


def build_dataset(cfg: Config, mode: str, epoch: int = 0,
                  device: DeviceLike = None):
    """The fragment dataset of `mode` with its transform chain; the GT
    fusion runs on `device` (CUDA unless the caller passes the CPU)."""
    from eprecon_tpu_torch.data.scannet import find_dataset_def
    from eprecon_tpu_torch.data.transforms import (Compose,
                                                   IntrinsicsPoseToProjection,
                                                   RandomTransformSpace,
                                                   ResizeImage)

    n_views = cfg.train.n_views if mode == "train" else cfg.test.n_views
    transforms = Compose([
        ResizeImage((640, 480)),
        RandomTransformSpace(
            cfg.model.n_vox, cfg.model.voxel_size,
            random_rotation=cfg.train.random_rotation_3d and mode == "train",
            random_translation=cfg.train.random_translation_3d and mode == "train",
            paddingXY=cfg.train.pad_xy_3d, paddingZ=cfg.train.pad_z_3d,
            device=device),
        IntrinsicsPoseToProjection(n_views, stride=4),
    ])
    ds_cls = find_dataset_def(cfg.dataset)
    path = cfg.train.path if mode == "train" else cfg.test.path
    return ds_cls(path, mode, transforms, n_views, cfg.model.n_scales,
                  epoch=epoch)


def _resolve_auto_extent(cfg: Config, mode: str) -> Config:
    """model.global_extent_auto: size the dense global volume from the
    dataset's window placements (data/extent.py) before building anything
    shape-dependent."""
    if not cfg.model.global_extent_auto:
        return cfg
    from eprecon_tpu_torch.data.extent import fit_global_extent

    ext, margin = fit_global_extent(cfg, mode)
    if mesh.is_main_process():
        print(f"auto global_extent ({mode}): {list(ext)}, "
              f"origin_margin {margin}")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, global_extent=ext, origin_margin=margin))


def _make_prefetcher(cfg: Config, dataset, n_workers: int):
    """The native decode-ahead loader (reference main.py:130-151
    num_workers), or None when n_workers <= 0."""
    if n_workers <= 0:
        return None
    from eprecon_tpu_torch.data.prefetch import FragmentPrefetcher

    return FragmentPrefetcher(dataset, n_threads=n_workers)


def run_train(cfg: Config, device: DeviceLike = None,
              backend: Optional[str] = None):
    """Train from cfg.train.path; with cfg.resume, from the newest
    checkpoint in cfg.logdir (fresh where there is none), else from
    cfg.loadckpt. Returns the Trainer. Under torchrun (WORLD_SIZE > 1)
    it joins the process group over `backend` (parallel/mesh.py) and,
    where every rank gets a fragment, trains one contiguous shard per
    rank; otherwise one scene stream."""
    from eprecon_tpu_torch.data.sampler import ContiguousDistributedSampler
    from eprecon_tpu_torch.models.eprecon import EPRecon
    from eprecon_tpu_torch.train import checkpoint as ckpt
    from eprecon_tpu_torch.train.loop import (iterate_samples, train_epochs,
                                              train_epochs_sharded)
    from eprecon_tpu_torch.train.state import Trainer

    device = mesh.initialize_distributed(backend, device)
    world = mesh.world_size()
    cfg = _resolve_auto_extent(cfg, "train")
    dataset = build_dataset(cfg, "train", device=device)
    sharded = world > 1 and len(dataset) >= world
    # optimizer updates per epoch: the schedule counts updates, and each
    # rank takes len(dataset) // world micro-steps an epoch
    per_stream = len(dataset) // world if sharded else len(dataset)
    updates_per_epoch = max(per_stream, 1) / cfg.train.accumulation_steps
    trainer = Trainer(cfg, EPRecon(cfg.model, seed=cfg.seed), device,
                      updates_per_epoch)
    if cfg.resume:
        latest = ckpt.latest_checkpoint(cfg.logdir)
        if latest:
            ckpt.restore_checkpoint(latest, trainer)
            if mesh.is_main_process():
                print(f"resumed from {latest} at epoch {trainer.epoch}, "
                      f"step {trainer.step_count}")
    elif cfg.loadckpt:
        ckpt.restore_checkpoint(cfg.loadckpt, trainer)
    prefetcher = _make_prefetcher(cfg, dataset, cfg.train.n_workers)
    try:
        if sharded:
            return train_epochs_sharded(cfg, trainer, dataset, prefetcher)
        sampler = ContiguousDistributedSampler(len(dataset), 1, 0)

        def iter_epoch(epoch):
            dataset.epoch = epoch
            yield from iterate_samples(dataset, prefetcher, list(sampler))

        return train_epochs(cfg, trainer, iter_epoch)
    finally:
        if prefetcher is not None:
            prefetcher.close()


def run_test(cfg: Config, device: DeviceLike = None):
    """Stream the test split through the reconstructor, save the scenes
    under <logdir>/scenes and score them against the tree's GT volumes;
    with test.eval_depth_frames > 0, then run the depth protocol over the
    saved scenes (tools/evaluation.py main). Returns the finished
    scenes."""
    from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
    from eprecon_tpu_torch.models.eprecon import EPRecon
    from eprecon_tpu_torch.train import checkpoint as ckpt
    from eprecon_tpu_torch.train.loop import evaluate, iterate_samples

    if mesh.env_world_size() > 1:
        raise RuntimeError("the test split runs in one process: launch "
                           "config/test.yaml without torchrun")
    device = resolve_device(device)
    cfg = _resolve_auto_extent(cfg, "test")
    dataset = build_dataset(cfg, "test", device=device)
    model = EPRecon(cfg.model, seed=cfg.seed).to(device)
    if cfg.loadckpt:
        ckpt.restore_model(cfg.loadckpt, model)
    recon = StreamingReconstructor(cfg, model, device)
    out_dir = os.path.join(cfg.logdir, "scenes")
    gt_dir = os.path.join(cfg.test.path, "all_tsdf_9")
    prefetcher = _make_prefetcher(cfg, dataset, cfg.test.n_workers)
    try:
        results = evaluate(cfg, recon,
                           iterate_samples(dataset, prefetcher,
                                           range(len(dataset))),
                           out_dir=out_dir,
                           gt_dir=gt_dir if os.path.isdir(gt_dir) else None)
    finally:
        if prefetcher is not None:
            prefetcher.close()
    if cfg.test.eval_depth_frames > 0:
        # the depth protocol over the saved scenes (reference
        # tools/evaluation.py:161-208): held-out frames come from the tree
        # the dataset read
        from eprecon_tpu_torch.tools.evaluation import main as eval_main

        eval_main(["--result_dir", out_dir, "--data_path", cfg.test.path,
                   "--max_frames", str(cfg.test.eval_depth_frames),
                   "--device", str(device)])
    return results


def main(argv=None):
    ap = argparse.ArgumentParser("EPRecon (PyTorch)")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--dist-backend", choices=mesh.BACKENDS, default=None,
                    help="process-group backend under torchrun (default: "
                         "nccl on CUDA, gloo on the CPU)")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="KEY VALUE config overrides")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.cfg, parse_cli_overrides(args.opts))
    if cfg.mode != "train":
        return run_test(cfg, device)
    try:
        return run_train(cfg, device, args.dist_backend)
    finally:
        mesh.shutdown_distributed()


if __name__ == "__main__":
    main()

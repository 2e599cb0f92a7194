"""Training / evaluation CLI (port of eprecon_tpu/main.py; reference
main.py:25-449).

  python -m eprecon_tpu_torch.main --cfg config/train.yaml [KEY VALUE ...]
  python -m eprecon_tpu_torch.main --cfg config/test.yaml  [KEY VALUE ...]

Runs on CUDA (`--device cuda:N` picks a card) and raises where CUDA is
absent; `--device cpu` runs the plain versions on the CPU. Checkpoints are
the port's own (`train/checkpoint.py`). The fragment loader reads in the
loop's own thread: `n_workers` does not start a prefetcher.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from eprecon_tpu_torch.config import Config, load_config, parse_cli_overrides
from eprecon_tpu_torch.device import DeviceLike, resolve_device


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
    print(f"auto global_extent ({mode}): {list(ext)}, origin_margin {margin}")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, global_extent=ext, origin_margin=margin))


def run_train(cfg: Config, device: DeviceLike = None):
    """Train one scene stream on one card from cfg.train.path; resume from
    the newest checkpoint in cfg.logdir (cfg.resume) or start from
    cfg.loadckpt. Returns the Trainer."""
    from eprecon_tpu_torch.data.sampler import ContiguousDistributedSampler
    from eprecon_tpu_torch.models.eprecon import EPRecon
    from eprecon_tpu_torch.train import checkpoint as ckpt
    from eprecon_tpu_torch.train.loop import train_epochs
    from eprecon_tpu_torch.train.state import Trainer

    device = resolve_device(device)
    cfg = _resolve_auto_extent(cfg, "train")
    dataset = build_dataset(cfg, "train", device=device)
    steps_per_epoch = max(len(dataset), 1)
    trainer = Trainer(cfg, EPRecon(cfg.model, seed=cfg.seed), device,
                      steps_per_epoch)
    latest = ckpt.latest_checkpoint(cfg.logdir) if cfg.resume else None
    if latest:
        ckpt.restore_checkpoint(latest, trainer)
        print(f"resumed from {latest} at epoch {trainer.epoch}, "
              f"step {trainer.step_count}")
    elif cfg.loadckpt:
        ckpt.restore_checkpoint(cfg.loadckpt, trainer)
    sampler = ContiguousDistributedSampler(len(dataset), 1, 0)

    def iter_epoch(epoch):
        dataset.epoch = epoch
        for i in sampler:
            yield dataset[i]

    return train_epochs(cfg, trainer, iter_epoch)


def run_test(cfg: Config, device: DeviceLike = None):
    """Stream the test split through the reconstructor, save the scenes
    under <logdir>/scenes and score them against the tree's GT volumes.
    Returns the finished scenes."""
    from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
    from eprecon_tpu_torch.models.eprecon import EPRecon
    from eprecon_tpu_torch.train import checkpoint as ckpt
    from eprecon_tpu_torch.train.loop import evaluate

    if cfg.test.eval_depth_frames > 0:
        raise NotImplementedError(
            "test.eval_depth_frames > 0: the depth-evaluation protocol "
            "(tools/evaluation.py render_tsdf_depth, trim_tsdf) is not ported "
            "yet (ROADMAP item 14)")
    device = resolve_device(device)
    cfg = _resolve_auto_extent(cfg, "test")
    dataset = build_dataset(cfg, "test", device=device)
    model = EPRecon(cfg.model, seed=cfg.seed).to(device)
    if cfg.loadckpt:
        ckpt.restore_model(cfg.loadckpt, model)
    recon = StreamingReconstructor(cfg, model, device)
    out_dir = os.path.join(cfg.logdir, "scenes")
    gt_dir = os.path.join(cfg.test.path, "all_tsdf_9")
    return evaluate(cfg, recon, (dataset[i] for i in range(len(dataset))),
                    out_dir=out_dir,
                    gt_dir=gt_dir if os.path.isdir(gt_dir) else None)


def main(argv=None):
    ap = argparse.ArgumentParser("EPRecon (PyTorch)")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="KEY VALUE config overrides")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.cfg, parse_cli_overrides(args.opts))
    if cfg.mode == "train":
        return run_train(cfg, device)
    return run_test(cfg, device)


if __name__ == "__main__":
    main()

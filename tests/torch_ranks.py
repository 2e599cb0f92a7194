"""Rank-side code of tests/test_torch_distributed.py.

The test spawns WORLD processes (multiprocessing, spawn) that run
`rank_main`: each joins a gloo group through
parallel/mesh.initialize_distributed with the variables torchrun would
set, runs torch on one thread (tests/torch_parity.one_torch_thread),
runs the scenarios below in order, then leaves the group and takes one
single-process step, and saves what it saw to <work>/rank<r>.pt; a
failure writes its traceback to <work>/rank<r>.err.
This module imports torch and the port only: a rank that imported JAX
would take seconds longer to start.
"""
import dataclasses
import datetime
import hashlib
import os
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from eprecon_tpu_torch import config as tconfig
from eprecon_tpu_torch.data.synthetic import make_fragment, make_scene
from eprecon_tpu_torch.models.eprecon import EPRecon
from eprecon_tpu_torch.parallel import mesh
from eprecon_tpu_torch.train import checkpoint as ckpt
from eprecon_tpu_torch.train import loop
from eprecon_tpu_torch.train.state import Trainer, fragment_tensors
from eprecon_tpu_torch.utils import logging as tlog

WORLD = 2
TIMEOUT = datetime.timedelta(seconds=120)   # a lost rank fails, not hangs
CPU = torch.device("cpu")
# tests/test_train_cli.py:70-127: shard 0 sees scene A twice, shard 1
# scene B then scene C (a reset mid-shard); 3 views at 96x128
LOOP_SAMPLES = (("scene_a", 0, 0.0), ("scene_a", 0, 0.7),
                ("scene_b", 1, 0.0), ("scene_c", 2, 0.0))
# the micro config's stream for the stop and RSS agreements: one scene
# per shard, 3 views at 48x64
MICRO_SAMPLES = (("a", 0, 0.0), ("a", 0, 0.3), ("b", 4, 0.0), ("b", 4, 0.3))


def digest(tensors) -> str:
    """sha256 of named tensors' bytes, in name order."""
    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def params_of(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def running_stats_of(model):
    return {n: b.clone() for n, b in model.named_buffers()
            if n.endswith((".running_mean", ".running_var"))}


def loop_config(logdir) -> tconfig.Config:
    """tests/test_train_cli.py's micro_cfg in the port's config: a 32^3
    window at 12 cm, the backbone and occupancy init frozen
    (finetune_layer 'init'), 2 epochs, no accumulation; a checkpoint and
    a summary every epoch and step. Stage selection is threshold-free
    (thresholds -100): at the default thresholds a fresh model aborts
    every sample of the loop (frag_ok 0, the heads untrained) at about
    half the draws, in both packages alike (tests/torch_micro_frag_ok.py:
    JAX at 8 of PRNGKey(0-15), among them key 1; the port at 6 of seeds
    0-15, among them seed 1, which this test draws)."""
    cfg = tconfig.default_config()
    pan = dataclasses.replace(cfg.model.panoptic, num_queries=16, dec_layers=2,
                              max_instances=8, hidden_dim=16, nheads=4,
                              min_instance_voxels=10)
    m = dataclasses.replace(
        cfg.model, n_vox=(32, 32, 32), voxel_size=0.12,
        voxel_capacity=(512, 2048, 8192), global_extent=(64, 64, 32),
        min_init_voxels=100, min_stage_voxels=50, thresholds=(-100.0,) * 3,
        panoptic=pan)
    t = dataclasses.replace(cfg.train, finetune_layer="init", epochs=2,
                            accumulation_steps=1)
    return dataclasses.replace(cfg, model=m, train=t, logdir=str(logdir),
                               save_freq=1, summary_freq=1)


def micro_config(logdir) -> tconfig.Config:
    """__graft_entry__._micro_cfg's widths (tests/test_torch_loop.py)."""
    cfg = tconfig.default_config()
    pan = dataclasses.replace(cfg.model.panoptic, num_queries=16, dec_layers=1,
                              max_instances=8, hidden_dim=16, nheads=4)
    m = dataclasses.replace(
        cfg.model, n_vox=(16, 16, 16), voxel_size=0.24,
        voxel_capacity=(128, 512, 2048), global_extent=(32, 32, 16),
        min_init_voxels=10, min_stage_voxels=5, panoptic=pan)
    return dataclasses.replace(
        cfg, model=m, logdir=str(logdir), train=dataclasses.replace(
            cfg.train, epochs=2, accumulation_steps=2))


def sample(d, scene):
    """A data-pipeline sample (the keys ScanNetDataset yields) from a
    synthetic fragment."""
    return dict(scene=scene, imgs=list(d["imgs"]),
                vol_origin=d["vol_origin_partial"],
                proj_matrices=d["proj_matrices"],
                vol_origin_partial=d["vol_origin_partial"],
                world_to_aligned_camera=d["world_to_aligned_camera"],
                tsdf_list=d["tsdf_levels"], occ_list=d["occ_levels"],
                semantic=d["semantic"], instance=d["instance"])


class LazyDataset:
    """Samples made on first use, so a rank makes only its shard's; an
    optional hook runs before index `at` is returned."""

    def __init__(self, specs, n_vox, voxel_size, image_hw, hook=None, at=None):
        self.specs, self.n_vox, self.voxel_size = specs, n_vox, voxel_size
        self.image_hw, self.hook, self.at = image_hw, hook, at
        self.epoch = 0

    def __len__(self):
        return len(self.specs)

    def __getitem__(self, i):
        scene, seed, angle = self.specs[i]
        d = make_fragment(n_views=3, image_hw=self.image_hw, n_vox=self.n_vox,
                          voxel_size=self.voxel_size, seed=seed,
                          scene=make_scene(seed), start_angle=angle)
        if self.hook is not None and i == self.at:
            self.hook()
        return sample(d, scene)


class Recorder:
    """Instruments one rank: the optimizer's input, the all-reduces per
    step, which steps started from a fresh recurrent state, the files
    torch.save wrote under a log directory, the summary writers opened."""

    def __init__(self):
        self.saved, self.writers = [], 0
        save, writer_cls, all_reduce = torch.save, tlog.SummaryWriter, dist.all_reduce
        self._restore = lambda: (setattr(torch, "save", save),
                                 setattr(tlog, "SummaryWriter", writer_cls),
                                 setattr(dist, "all_reduce", all_reduce))
        self.all_reduces = 0

        def recorded_save(obj, f, *a, **kw):
            self.saved.append(str(f))
            return save(obj, f, *a, **kw)

        recorder = self

        class CountedWriter(writer_cls):
            def __init__(self, *a, **kw):
                recorder.writers += 1
                super().__init__(*a, **kw)

        def counted_all_reduce(*a, **kw):
            self.all_reduces += 1
            return all_reduce(*a, **kw)

        torch.save, tlog.SummaryWriter = recorded_save, CountedWriter
        dist.all_reduce = counted_all_reduce

    def close(self):
        self._restore()


def watch_trainer(trainer):
    """Record the gradients the optimizer receives and the steps that
    start from a fresh recurrent state."""
    trainer.received, trainer.fresh_at = [], []
    opt_step, fresh = trainer.optimizer.step, trainer.recurrent_state

    def recorded_step(grads):
        trainer.received.append({n: None if g is None else g.clone()
                                 for n, g in grads.items()})
        return opt_step(grads)

    def recurrent_state():
        trainer.fresh_at.append(trainer.step_count)
        return fresh()

    trainer.optimizer.step = recorded_step
    trainer.recurrent_state = recurrent_state
    return trainer


def one_step(cfg, model, d):
    """One Trainer.step of `model` on the synthetic fragment `d` from a
    fresh recurrent state; returns (trainer, its metrics as floats, the
    gradients the optimizer received, all-reduces in the step)."""
    trainer = watch_trainer(Trainer(cfg, model, CPU, steps_per_epoch=1))
    imgs, frag, targets = fragment_tensors(d, np.zeros((3, 3), np.int64), CPU)
    rec = Recorder()
    try:
        _, metrics = trainer.step(imgs, frag, targets, trainer.recurrent_state())
    finally:
        rec.close()
    return (trainer, {k: float(v) for k, v in metrics.items()},
            trainer.received[0], rec.all_reduces)


def parity_step(spec, r):
    """Running-statistics BatchNorm, the JAX variables' weights, rank r
    on fragment r, accumulation 1."""
    m = spec["model"]
    model = EPRecon(m, use_running_average=True)
    model.load_state_dict(spec["weights"])
    cfg = dataclasses.replace(tconfig.Config(model=m), train=dataclasses.replace(
        tconfig.Config().train, accumulation_steps=1))
    trainer, metrics, grads, n_reduce = one_step(cfg, model, spec["frags"][r])
    return dict(metrics=metrics, grads=grads if r == 0 else None,
                grads_digest=digest(grads),
                params_digest=digest(params_of(trainer.model)),
                all_reduces=n_reduce)


def batch_stats_config(m) -> tconfig.Config:
    return dataclasses.replace(tconfig.Config(model=m), train=dataclasses.replace(
        tconfig.Config().train, accumulation_steps=1))


def batch_stats_step(spec, r):
    """Batch-statistics BatchNorm, weights from seed 3, rank r on
    fragment r, accumulation 1."""
    m = spec["model"]
    trainer, metrics, grads, n_reduce = one_step(
        batch_stats_config(m), EPRecon(m, seed=3), spec["frags"][r])
    params, stats = params_of(trainer.model), running_stats_of(trainer.model)
    return dict(metrics=metrics, params=params if r == 0 else None,
                stats=stats if r == 0 else None,
                params_digest=digest(params), stats_digest=digest(stats),
                all_reduces=n_reduce)


def single_batch_stats_step(spec, r):
    """The batch-statistics step on fragment r in one process (called once
    the rank has left the group): the gradients its optimizer received and
    its running statistics."""
    m = spec["model"]
    assert mesh.world_size() == 1
    trainer, _, grads, _ = one_step(batch_stats_config(m), EPRecon(m, seed=3),
                                    spec["frags"][r])
    return dict(grads=grads, stats=running_stats_of(trainer.model))


def sharded_loop(work, r):
    """The JAX sharded-loop scenario as ranks: one epoch, then a fresh
    trainer (other initial weights) resumed from its checkpoint trains the
    second; records resets, the checkpoint and summary writes of this
    rank, and parameters before and after."""
    cfg = loop_config(work / "loop")
    m = cfg.model
    dataset = LazyDataset(LOOP_SAMPLES, m.n_vox, m.voxel_size, (96, 128))
    rec = Recorder()
    logs = []
    try:
        first = watch_trainer(Trainer(cfg, EPRecon(m, seed=cfg.seed), CPU, 2))
        before = params_of(first.model)
        loop.train_epochs_sharded(cfg, first, dataset, epochs=1,
                                  log_fn=logs.append)
        second = Trainer(cfg, EPRecon(m, seed=99), CPU, 2)
        ckpt.restore_checkpoint(ckpt.latest_checkpoint(cfg.logdir), second)
        resumed_at = (second.epoch, second.step_count)
        watch_trainer(second)
        loop.train_epochs_sharded(cfg, second, dataset, log_fn=logs.append)
    finally:
        rec.close()
    after = params_of(second.model)
    frozen = [n for n in before if n.startswith(("backbone2d.",
                                                 "neucon_net.initialization."))]
    head = [n for n in before if n.startswith("neucon_net.tsdf_pred_2.")]
    return dict(
        fresh_at=[first.fresh_at, second.fresh_at], resumed_at=resumed_at,
        end=(second.epoch, second.step_count),
        frozen_unchanged=all(torch.equal(before[n], after[n]) for n in frozen),
        n_frozen=len(frozen),
        head_moved=any(not torch.equal(before[n], after[n]) for n in head),
        params_digest=digest(after), saved=rec.saved, writers=rec.writers,
        logs=logs)


def stop_agreement(work, r):
    """Only rank 1 sees a stop file, which appears as it fetches its
    second sample: both ranks stop there."""
    cfg = micro_config(work / "stop")
    m = cfg.model
    stop_file = work / f"stop{r}"
    hook = (lambda: stop_file.touch()) if r == 1 else None
    dataset = LazyDataset(MICRO_SAMPLES, m.n_vox, m.voxel_size, (48, 64),
                          hook=hook, at=3)
    os.environ["EPRECON_STOP_FILE"] = str(stop_file)
    rec = Recorder()
    try:
        trainer = Trainer(cfg, EPRecon(m, seed=1), CPU, 2)
        loop.train_epochs_sharded(cfg, trainer, dataset, log_fn=lambda _: None)
    finally:
        rec.close()
        del os.environ["EPRECON_STOP_FILE"]
    return dict(at=(trainer.epoch, trainer.step_count), saved=rec.saved,
                params_digest=digest(params_of(trainer.model)))


def rss_agreement(work, r):
    """Only rank 0 is over the RSS limit: both ranks checkpoint through
    rank 0 and exit 75 before their first step."""
    cfg = micro_config(work / "rss")
    m = cfg.model
    dataset = LazyDataset(MICRO_SAMPLES, m.n_vox, m.voxel_size, (48, 64))
    if r == 0:
        os.environ["EPRECON_MAX_RSS_GB"] = "1e-6"
    rec = Recorder()
    code = None
    try:
        trainer = Trainer(cfg, EPRecon(m, seed=1), CPU, 2)
        loop.train_epochs_sharded(cfg, trainer, dataset, log_fn=lambda _: None)
    except SystemExit as e:
        code = e.code
    finally:
        rec.close()
        os.environ.pop("EPRECON_MAX_RSS_GB", None)
    return dict(exit_code=code, steps=trainer.step_count, saved=rec.saved)


def rank_main(r: int, port: int, work: str):
    """One rank: join the group, run every scenario, save the results."""
    work = Path(work)
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        device = mesh.initialize_distributed("gloo", "cpu", timeout=TIMEOUT)
        spec = torch.load(work / "spec.pt", weights_only=False)
        out = dict(device=str(device), world=mesh.world_size(),
                   rank=mesh.rank())
        out["parity"] = parity_step(spec, r)
        out["batch_stats"] = batch_stats_step(spec, r)
        out["loop"] = sharded_loop(work, r)
        out["stop"] = stop_agreement(work, r)
        out["rss"] = rss_agreement(work, r)
        mesh.shutdown_distributed()
        out["single"] = single_batch_stats_step(spec, r)
        torch.save(out, work / f"rank{r}.pt")
    except BaseException:
        (work / f"rank{r}.err").write_text(traceback.format_exc())
        raise
    finally:
        mesh.shutdown_distributed()

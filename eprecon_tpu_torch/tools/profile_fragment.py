"""Where one fragment's time goes on the GPU, served or trained.

    python -m eprecon_tpu_torch.tools.profile_fragment [--train [--quality]]
        [--out FILE]

Serves warm-up fragments through StreamingReconstructor at the default
config (random weights), then profiles one steady-state fragment with
torch.profiler. With --train it takes training micro-steps instead
(Trainer at the default config, accumulation 2, threshold-free selection
as chip_smoke.py trains) and profiles one accumulation cycle (a micro-step
and an update step); the Trainer's own ranges (train::forward,
train::backward, train::optimizer) give their host wall time, and the
backward's device time is what the kernels of the cycle take beyond the
forward's and the optimizer's (and the uploads'). With --quality it
trains the quality loop's tiny config over its scene's three fragments
instead (tools/quality_run.py: accumulation 1, the config's thresholds)
and profiles two steps. Top-level modules and the post-processing steps are
wrapped in named ranges through forward hooks (the model code carries no
instrumentation), so the report gives, per layer, the device time of the
kernels it launched, plus the device busy share of the fragment and the
top kernels. Needs CUDA.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from eprecon_tpu_torch.config import default_config
from eprecon_tpu_torch.data.synthetic import make_fragment, make_scene
from eprecon_tpu_torch.inference import pipeline
from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
from eprecon_tpu_torch.models.eprecon import EPRecon
from eprecon_tpu_torch.ops import grid
from eprecon_tpu_torch.tools.quality_utils import (build_scene_and_fragments,
                                                   tiny_cfg)
from eprecon_tpu_torch.train.loop import _scene_origin, fragment_to_device_args
from eprecon_tpu_torch.train.state import Trainer, fragment_tensors


def _range_hooks(module: torch.nn.Module, names):
    """Open a record_function range around each named submodule's forward."""
    handles, open_ranges = [], {}
    for name in names:
        sub = module.get_submodule(name)

        def pre(_m, _a, name=name):
            open_ranges[name] = record_function(f"layer::{name}")
            open_ranges[name].__enter__()

        def post(_m, _a, _o, name=name):
            open_ranges.pop(name).__exit__(None, None, None)

        handles += [sub.register_forward_pre_hook(pre),
                    sub.register_forward_hook(post)]
    return handles


def _wrap(fn, label):
    def wrapped(*args, **kwargs):
        with record_function(f"layer::{label}"):
            return fn(*args, **kwargs)
    return wrapped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile_fragment.json")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--train", action="store_true",
                    help="profile training micro-steps instead of serving")
    ap.add_argument("--quality", action="store_true",
                    help="with --train: the quality loop's tiny config")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fragment needs CUDA")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = default_config()
    if args.train:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, thresholds=(-100.0,) * 3,
                                           occ_init_threshold=0.0),
            train=dataclasses.replace(cfg.train, accumulation_steps=2))
    if args.quality:
        cfg = tiny_cfg()
    m = cfg.model
    scene = make_scene(0)
    n_profiled = 2 if args.train else 1
    frags = [make_fragment(n_vox=m.n_vox, voxel_size=m.voxel_size, scene=scene,
                           start_angle=0.3 * i)
             for i in range(0 if args.quality else args.warmup + n_profiled)]
    model = EPRecon(m, seed=cfg.seed)
    layers = (["backbone2d", "backbone_occ_pano", "neucon_net.initialization"]
              + [f"neucon_net.{p}_{i}" for i in range(m.n_layer)
                 for p in ("sp_conv", "gru_fusion", "tsdf_pred", "occ_pred")]
              + [f"neucon_net.panoptic_pred_{p}" for p in range(3)]
              + [f"neucon_net.mask_feat_{p}" for p in range(3)]
              + ["neucon_net.panoptic"])
    _range_hooks(model, layers)
    pipeline.panoptic_inference = _wrap(pipeline.panoptic_inference,
                                        "panoptic_inference")
    pipeline.fuse_tsdf_direct = _wrap(pipeline.fuse_tsdf_direct,
                                      "fuse_tsdf_direct")

    if args.quality:
        trainer = Trainer(cfg, model, steps_per_epoch=100)
        _, _, samples = build_scene_and_fragments(cfg)
        origin = _scene_origin(cfg, samples[0])
        step_args = [fragment_to_device_args(cfg, d, origin, trainer.device)
                     for d in samples]
        # the loop's order, a fresh recurrent state at each cycle's start
        frags = [step_args[i % 3] for i in range(args.warmup + n_profiled)]
        state = {"rec": None, "i": 0}

        def feed(d):
            if state["i"] % len(step_args) == 0:
                state["rec"] = trainer.recurrent_state()
            state["i"] += 1
            state["rec"], _ = trainer.step(*d, state["rec"])
    elif args.train:
        trainer = Trainer(cfg, model)
        state = {"rec": trainer.recurrent_state()}
        g_origin = grid.scene_global_origin(
            m.global_extent, m.n_vox, m.n_scales, m.voxel_size,
            frags[0]["vol_origin_partial"] - 0.5, m.origin_margin)

        def feed(d):
            rel = np.stack([np.round((d["vol_origin_partial"] - g_origin)
                                     / (m.voxel_size * 2 ** (m.n_scales - lv)))
                            for lv in range(m.n_layer)]).astype(np.int64)
            imgs, frag, targets = fragment_tensors(d, rel, torch.device("cuda"))
            state["rec"], _ = trainer.step(imgs, frag, targets, state["rec"])
    else:
        rec = StreamingReconstructor(cfg, model)

        def feed(d):
            rec.process_fragment("scene", d["imgs"], d["proj_matrices"],
                                 d["vol_origin_partial"] - 0.5,
                                 d["vol_origin_partial"],
                                 d["world_to_aligned_camera"])

    for d in frags[:-n_profiled]:
        feed(d)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for d in frags[-n_profiled:]:
            feed(d)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # Layer time: the device time of the kernels launched inside each
    # host-side range. Busy time: the kernels themselves (device-side
    # events), leaving out the device-side copies of the range markers.
    layers_ms: dict = {}
    per_kernel: dict = {}
    train_ms: dict = {}
    for e in prof.events():
        if e.name.startswith("train::"):
            if e.device_type == DeviceType.CPU:
                wall, dev = train_ms.get(e.name, (0.0, 0.0))
                train_ms[e.name] = (wall + e.cpu_time_total / 1e3,
                                    dev + e.device_time_total / 1e3)
        elif e.name.startswith("layer::"):
            if e.device_type == DeviceType.CPU:
                key = e.name[len("layer::"):]
                layers_ms[key] = layers_ms.get(key, 0.0) + e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:
            ms, calls = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (ms + e.device_time_total / 1e3, calls + 1)
    kernel_ms = sum(ms for ms, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    report = dict(card=card, wall_ms=wall_ms, device_kernel_ms=kernel_ms,
                  device_busy_share=kernel_ms / wall_ms,
                  layers_device_ms=dict(sorted(layers_ms.items(),
                                               key=lambda kv: -kv[1])),
                  top_kernels=[dict(name=name, device_ms=ms, calls=calls)
                               for name, (ms, calls) in top],
                  kernel_launches=sum(c for _, c in per_kernel.values()),
                  profiled_fragments=n_profiled,
                  mode=("train quality" if args.quality else "train")
                  if args.train else "serve")
    if args.train:
        # host wall ms of each range; the kernels launched on the main thread
        # inside it (the backward's run on the autograd engine's thread)
        report["train_ranges"] = {k: dict(host_wall_ms=w, device_ms_launched_inside=d)
                                  for k, (w, d) in train_ms.items()}
        outside = kernel_ms - sum(d for k, (_, d) in train_ms.items()
                                  if k != "train::backward")
        report["device_ms_outside_forward_and_optimizer"] = outside
    print(f"card: {card}")
    print(f"{report['mode']}: {n_profiled} fragment(s) wall {wall_ms:.1f} ms, "
          f"device kernels {kernel_ms:.1f} ms (busy share {kernel_ms / wall_ms:.2f}), "
          f"{report['kernel_launches']} device events")
    for k, v in report.get("train_ranges", {}).items():
        print(f"  {k:34s} host {v['host_wall_ms']:8.2f} ms, device launched "
              f"inside {v['device_ms_launched_inside']:8.2f} ms")
    if args.train:
        print(f"  device ms outside the forward and optimizer ranges (the "
              f"backward, and the uploads) {outside:.2f}")
    for name, ms in report["layers_device_ms"].items():
        print(f"  {name:34s} {ms:8.2f} ms")
    for k in report["top_kernels"]:
        print(f"  {k['device_ms']:8.2f} ms  {k['calls']:5d}x  {k['name'][:90]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

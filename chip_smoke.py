#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eprecon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ddp-phase    # the ddp phase alone (several cards)
    python3 chip_smoke.py --serve-artifact ARTIFACT REQUESTS RESULTS
                                         # the export phase's model-free server
    python3 chip_smoke.py --quality-phase RESULTS
                                         # the quality phase's process

Phases (any failure exits non-zero before the result line):
  1. build csrc/back_project.cu (forward and backward kernels) for sm_90a
     with nvcc;
  2. at the four back-projection call shapes of a full-width fragment,
     hold the kernel against its plain PyTorch version on the card (bit
     for bit), tally its brick-views (some voxel visible / empty), check
     that the card holds as many CTAs per SM as the launch plan assumes
     (CUDA occupancy calculator; the plan models each kernel instance's
     registers), and time it
     (eprecon_tpu_torch/tools/bench_back_project.py):
     ms is the kernel's device time under torch.profiler with the L2
     flushed, call_ms the wrapper's time per call, beside the plain
     version, an F.grid_sample yardstick (library_ms) and the least time
     the card could take (bound_ms);
  3. the backward kernels at the same four shapes against the plain
     backward (f32 gradient of the tables): both sum in 64-bit fixed point
     (each term rounded once at the scale 2^e, integer sums, one
     conversion), so the kernel must equal the plain version bit for bit,
     and REPEATS more calls on the same inputs must equal the first bit
     for bit (it prints the relative error beside it, and e with the
     resolution 2^-e it gives); tally its
     brick-views where its plan takes bricks (stages 1-2: summed per pixel
     in shared memory and added once / scattered straight into the
     gradient / empty: the box path must run); where the window mean's
     plan takes view tiles (stage 0, whose bricks cannot fill the card) the
     visible (voxel, view) pairs the tiles took must equal the forward's
     view counts' sum; the variance's per-voxel kernel tallies nothing;
     check that the card holds as many CTAs per SM as the plan assumes (a
     brick plan cuts shared memory for them; a tile plan's clusters must
     fit the card at once, and its visible-records pass is checked too),
     and time it the same way, every kernel of a call summed (library_ms:
     autograd of the F.grid_sample yardstick);
  4. serve the main path: StreamingReconstructor at the default config
     (96^3 window at 4 cm, 9 views at 640x480, 80-query 6-layer decoder),
     random weights from a seed, 3 fragments of one scene then 1 of a
     second (scene flush); the kernel must launch 4 times per fragment;
     [jax-session]: after fragment 0 the reconstructor's state is written
     in the JAX package's session layout (write_jax_session: flattened
     leaves rec_{i} / pmap_{i}, lane-flattened [Gx, Gy, Gz*C] feature
     maps), restored into a fresh reconstructor on the card, and fed the
     rest of scene a: every state tensor and the fragment outputs
     (tsdf_window, occupancy, pred_logits, pred_masks) must equal the
     uninterrupted stream's bit for bit, with 4 launches per fragment;
     then restore_model on an orbax-shaped directory must raise
     ImportError naming tensorstore (the card's host has none);
  4a. export (inference/export.py): the fragment program exported on the
     card and saved; a process that refuses eprecon_tpu_torch.models
     (--serve-artifact) loads it and serves phase 4's fragments, which
     must equal the live path (tsdf_window 1e-5, pred_logits 1e-4, the
     panoptic maps at each scene's end exactly), then seed-2 weights
     swapped into it must equal the live path on them; an artifact
     exported on the CPU, moved to the card at load, serves fragment 0
     (4 kernel launches, equal to the live path). Prints [export]: export,
     save and load s, artifact MB, p50 ms per fragment and peak GiB
     against the live path's;
  4b. the sparse research engine (models/spvcnn.py) on the first served
     fragment's fused voxels per stage (at most 131,072 points): SPVCNN at
     the reference's three stage configurations (cr 1, 1/2, 1/4 at 16, 8,
     4 cm, 80 / 138 / 74 input channels) and ConvGRU at the fine stage,
     build_plan and forward timed (median of 5 after a warm-up, the card
     synchronised), peak GiB, and held against the port's own CPU run on
     an 8,192-point cut (plans equal, outputs within 1e-4 of scale); the
     stage-2 dense U-Net's time on its served input beside them.
     Prints [spvcnn];
  5. train at full width: Trainer at the default config with the port's
     own GT fragments (one scene stream threading the recurrent state),
     random weights from the seed, 6 micro-steps = 3 optimizer updates.
     Two reductions: accumulation 2 (not 8) and threshold-free selection
     (stage thresholds -100, occupancy-init threshold 0), without which
     random weights select an arbitrary, often empty, set. Checks: every
     loss term finite and > 0; a non-zero gradient in each trained module
     group; parameters move on each update and not between; 4 forward and
     4 backward kernel launches per step; the maps finite and growing.
     Prints step ms (step 0 and the median of steps 3-6) and peak GiB;
  5a. the closed quality loop (the quality phase; tools/quality_run.py),
     in a process of its own (--quality-phase) in quality_run's
     deterministic mode (torch's deterministic algorithms in raise mode,
     cuDNN benchmark off, CUBLAS_WORKSPACE_CONFIG=:4096:8, set before any
     CUDA work; the back-projection backward sums in fixed point), so a
     run repeats bit for bit and its verdict is fixed for a tree: the tiny
     quality config trained 100 steps from each of the seeds 0,
     1 and 2 over one synthetic scene's 3 fragments (a fresh recurrent
     state each cycle), reconstructed and scored against the scene's
     analytic GT after 48 and 100 steps; then seed 0 again for 20 steps.
     Fails unless every loss is
     finite, every seed's loss at step 47 is below 0.7x its step-0 loss,
     the median over the seeds clears the JAX package's floors (window
     F-score > 0.5 after 48 steps; F-score > 0.4, a predicted instance and
     PQ > 0.25 after 100), every step launched 4 forward and 4
     backward kernels, and every loss term of the 20-step repeat equals
     the first run's bit for bit. Prints [quality] (losses at steps
     0/25/47/50/75/99, seed 0's total loss at steps 0-19 to 9 digits, the
     scores, ms per step, the repeat's verdict, the process's wall and
     launches);
  6. the CLI (eprecon_tpu_torch.main.main, in this process) at full width
     over a ScanNet-layout tree in a temporary directory that the port
     writes itself: tools/make_synthetic_scannet.write_scene, 2 textured
     scenes of 27 frames (every one a keyframe: 3 fragments of 9 views),
     color 1296x968 jpg and depth 640x480 png through the native library
     (csrc/fragment_loader.cpp: libjpeg, or nvJPEG on the card where the
     host has no libjpeg, and zlib), then tools/generate_gt.generate_all on
     the card at 4 cm. Loader checks: decoded depth equals the written
     u16 / 1000; decoded color, padded and resized, within 2 grey levels
     (mean) of its render; every fragment of the GT pkls names 9 frames on
     disk; the prefetcher's first sample equals dataset[0] (images bit for
     bit, cameras and GT exactly). Then config/train.yaml with the training
     phase's reductions: one epoch through the decode-ahead loader
     (train.n_workers 8), a resumed second epoch reading synchronously
     (train.n_workers 0), then config/test.yaml from the last checkpoint
     through the loader (test.n_workers 4) with the depth protocol
     (test.eval_depth_frames 9). Fails unless every training step launched
     4 forward and 4 backward kernels and every test fragment 4 forward,
     the prefetcher served the first epoch and the test, every GT fusion
     ran on cuda, the resume starts at epoch 1 step 6 and ends at epoch 2
     step 12 with parameters moved, metrics.jsonl holds one record per
     step, the losses are finite, both scenes are saved with a finite
     TSDF, scored, and have finite depth metrics. Prints [loader] (the
     libraries found, the route, decode ms per fragment, prefetch depth),
     [gt] (seconds per scene, voxels), the loop's step and sample ms with
     and without the prefetcher, host ms per sample by stage, the test's
     fragment ms, keyframes/s and p50, [depth-eval] (render ms per frame,
     trim seconds, AbsRel / RMSE / fscore per scene) and the peak memory;
  7. data-parallel training (the ddp phase, over the cli phase's tree and
     reductions; parallel/mesh.py): (a) `torchrun --standalone
     --nproc_per_node 2 chip_smoke.py --ddp-rank ...` runs
     eprecon_tpu_torch.main.main in each rank with `--dist-backend gloo`
     (two ranks share the card), one scene per rank, 2 epochs, decode-ahead
     with 4 threads per rank; (b) the same launch with `--dist-backend
     nccl` and one rank per card (`torch.cuda.device_count()`), 1 epoch.
     Each rank counts its kernel launches per step, times its steps and
     its all-reduce (host clock, card synchronised around it; the
     collective apart from packing the flat buffer, the wait for the other
     ranks apart) and prints one JSON line. Fails unless torchrun exits 0, every step
     of every rank launched 4 forward and 4 backward kernels, the ranks'
     parameters are equal bit for bit at the end of (a) (and of (b) with
     two or more cards) and moved, rank 0 alone wrote the checkpoints and
     metrics.jsonl (one record per step, finite losses), and, with one
     card, (b)'s first step's loss terms equal the cli phase's first
     step's within 1e-3 relative. Prints [ddp] (per rank the medians of the
     steps after its first: step ms, all-reduce ms and its collective,
     the wait; peak GiB per rank; free memory before the launch).
     `chip_smoke.py --ddp-phase` runs this phase alone over a fresh tree
     (on several cards: nccl across them);
  8. upstream artifacts (the import phase, over the cli phase's tree and
     reductions): a reference-format checkpoint of random weights from a
     seed ({"epoch", "model" with 'module.' prefixes, "optimizer"}) and its
     activation fingerprint recorded under a non-default layout
     (ts_odd=zfast) go through `python -m
     eprecon_tpu_torch.tools.import_reference_weights --fingerprint` in a
     subprocess, which must report the auto-flip, convert more than 900
     tensors and cover every tensor of EPRecon at the default config; the
     file must equal the in-process conversion and load through
     restore_model bit for bit. A torchvision-mnasnet1_0-schema state_dict
     goes through import_backbone_weights and warm-starts both backbones
     through restore_submodule: exactly their trunk tensors change. Scene 0
     of the cli tree is packed as a raw ScanNet scan (.sens with its JPEG
     bytes and zlib u16 depth, a binary _vh_clean_2.ply, segs and
     aggregation json, a label tsv), then sens_reader.extract,
     load_scannet_labels and generate_gt (on cuda) build a fresh tree,
     which must give back the color bytes, the decoded depth, the poses (at
     the .sens format's f32), the intrinsics and the labels up to ScanNet's
     renumbering. config/test.yaml then serves the ingested scene from the
     imported checkpoint (test.n_workers 4): 4 forward launches per
     fragment, the scene saved with a finite surface and scored, and
     generate_semantic_instance.export_scene writes a label per vertex of
     the scan's mesh. Prints [import], [ingest] and [serve-imported];
  9. reference checks at tiny size: the same forward, and one training
     micro-step, on CUDA and on the CPU (the CPU port is held against the
     JAX package by tests/test_torch_forward.py and test_torch_train.py).
Prints ptxas's registers and spills per kernel instance, the card's name
and power limit, a JSON line of kernel results (`launches` from the
serving path, `session_launches` from the restored JAX-layout session,
`export_launches` from the export phase's serving process,
`train_launches` from the training phase, `cli_launches`
from the CLI phase, `ddp_launches` summed over the ddp phase's ranks,
`import_launches` from serving the imported checkpoint), and as the last
line {"ok": true, "device": {...}}.
Full results also go to chip_smoke.json in the output directory beside
the script.
"""
import ast
import collections
import contextlib
import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parent
TOL = 1e-2                  # kernel vs plain, relative to max(1, |plain|)
REPEATS = 4                 # backward calls on the same inputs, against the first
TRAIN_STEPS = 6


def ptxas_lines(so: Path):
    """Registers, spills and shared memory of each kernel instance, from
    the ptxas report kept beside the built library."""
    from eprecon_tpu_torch import kernels

    entries, name = {}, None
    for line in kernels.ptxas_report(so).read_text().splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            f = re.search(r"project_kernelILi(\d+)ELb([01])E", m.group(1))
            k = re.search(r"backward_kernelILi(\d+)E", m.group(1))
            t = re.search(r"backward_tileILi(\d+)E", m.group(1))
            b = re.search(r"back_project_(backward_by_voxel|backward_visible|"
                          r"backward_scale|backward_convert)", m.group(1))
            mode = lambda x: "variance" if x == "1" else "mean"
            name = (f"items={f.group(1)} {mode(f.group(2))}" if f
                    else f"backward items={k.group(1)} mean" if k
                    else f"backward view tile cs={t.group(1)} mean" if t
                    else {"backward_by_voxel": "backward per voxel variance",
                          "backward_visible": "backward visible records mean",
                          "backward_scale": "backward fixed-point scale",
                          "backward_convert": "backward fixed-point conversion"
                          }[b.group(1)] if b
                    else m.group(1))
            entries.setdefault(name, [])
        elif name and ("spill" in line or "Used" in line):
            entries[name].append(line.split(":", 1)[-1].strip())
    return [" | ".join([k, *x]) for k, x in entries.items()]


def kernel_phase(case_list, v, card):
    """Kernel vs plain at the main path's four call shapes, then timed
    (tools/bench_back_project.py): device time under the profiler with
    the L2 flushed, wrapper time, plain, library yardstick, bound."""
    import torch
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.tools import bench_back_project as bench

    results = []
    for case in case_list:
        name, n, c = case.name, case.n, case.c
        stats = torch.zeros(2, dtype=torch.int64, device="cuda")
        (k_out, k_cnt), (p_out, p_cnt) = case.run(stats=stats), case.plain()
        torch.cuda.synchronize()
        k_out, p_out = k_out.float().reshape(n, c), p_out.float().reshape(n, c)
        err = (k_out - p_out).abs().max().item()
        scale_ = max(1.0, p_out.abs().max().item())
        if not torch.equal(k_cnt.reshape(-1), p_cnt.reshape(-1)):
            raise AssertionError(f"{name}: kernel and plain view counts differ")
        if not (err <= TOL * scale_):
            raise AssertionError(f"{name}: max abs err {err} > {TOL * scale_}")
        if not (0.05 * n < (p_cnt > 0).sum().item()):
            raise AssertionError(f"{name}: degenerate geometry, few visible voxels")
        seen, empty = stats.tolist()
        plan = bp.plan_launch(case.extent, c, v, 1, case.mode)
        if seen + empty != plan.grid * v:
            raise AssertionError(f"{name}: brick-view tallies {stats.tolist()} "
                                 f"!= {plan.grid} CTAs x {v} views")
        ctas_per_sm = bp.occupancy(plan, case.mode)
        if ctas_per_sm != plan.ctas_per_sm:
            raise AssertionError(f"{name}: the card holds {ctas_per_sm} CTAs per "
                                 f"SM, the plan assumes {plan.ctas_per_sm}")
        t = bench.time_case(case, v)
        res = dict(name=f"back_project/{name}", route="cuda",
                   source="eprecon_tpu_torch/csrc/back_project.cu",
                   replaces="tools_dev/pallas_gather_probe.py:56",
                   launches=0, max_abs_err=err, **t,
                   key=[case.mode, n, c], bitwise_equal=err == 0.0,
                   ctas_per_sm=ctas_per_sm, plan_ctas_per_sm=plan.ctas_per_sm,
                   brick_views=dict(seen=seen, empty=empty),
                   launch_parameters=dict(brick=list(plan.brick), grid=plan.grid,
                                          threads=plan.threads,
                                          smem_bytes=plan.smem_bytes))
        print(f"[kernel] {name}: N={n} C={c} err={err:.3g} ms={t['ms']:.4f} "
              f"(profiled windows {t['profiler_windows']}) "
              f"call_ms={t['call_ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
              f"({t['bound_by']}) CTAs/SM on the card={ctas_per_sm} (plan "
              f"{plan.ctas_per_sm}) brick-views seen/empty={seen}/{empty} | "
              f"launched with brick={plan.brick} grid={plan.grid} "
              f"threads={plan.threads} smem={plan.smem_bytes} B | {card}",
              flush=True)
        results.append(res)
    return results


def backward_phase(case_list, v, card):
    """Backward kernels vs plain backward at the four call shapes, then
    timed like the forward."""
    import torch
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.tools import bench_back_project as bench

    results = []
    for case in case_list:
        stats = torch.zeros(3, dtype=torch.int64, device="cuda")
        got, want = case.backward(stats=stats), case.backward_plain()
        torch.cuda.synchronize()
        got = got.reshape(want.shape)
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        e, nan = case.backward_exponent().tolist()
        resolution = 2.0 ** -e
        if not (scale > 0 and not nan and torch.equal(got, want)):
            raise AssertionError(f"backward {case.name}: the kernel differs from "
                                 f"the plain version (max abs err {err}, scale "
                                 f"{scale}, e {e}, nan {nan})")
        in_box, direct, empty = stats.tolist()
        # integer sums: repeats on the same inputs give the same bits
        repeats = [case.backward().reshape(got.shape) for _ in range(REPEATS)]
        repeat_diff = max((r - got).abs().max().item() for r in repeats)
        if not all(torch.equal(r, got) for r in repeats):
            raise AssertionError(f"backward {case.name}: a repeat differs from "
                                 f"the first call by up to {repeat_diff}")
        plan = bp.plan_backward(case.extent, case.c, case.h, case.w, v,
                                case.mode)
        tile = isinstance(plan, bp.TilePlan)
        if tile:
            if (in_box, direct, empty) != (case.visible, 0, 0):
                raise AssertionError(f"backward {case.name}: the view tiles took "
                                     f"{stats.tolist()} visible pairs, the forward "
                                     f"counted {case.visible}")
        elif plan.per_voxel:
            if in_box + direct + empty != 0:
                raise AssertionError(f"backward {case.name}: the per-voxel "
                                     f"kernel tallied {stats.tolist()}")
        elif in_box + direct + empty != plan.grid * v or in_box == 0:
            raise AssertionError(f"backward {case.name}: brick-view tallies "
                                 f"{stats.tolist()} for {plan.grid} CTAs x {v} "
                                 f"views (the shared-memory path must run)")
        ctas_per_sm = bp.occupancy(plan, case.mode)
        if ctas_per_sm != plan.ctas_per_sm:
            raise AssertionError(f"backward {case.name}: the card holds "
                                 f"{ctas_per_sm} CTAs per SM, the plan assumes "
                                 f"{plan.ctas_per_sm}")
        held = {}
        if tile:
            held = dict(clusters=bp.tile_occupancy(plan)[1],
                        visible_ctas_per_sm=bp.visible_occupancy(plan))
            if held["clusters"] < plan.tiles:
                raise AssertionError(f"backward {case.name}: the card holds "
                                     f"{held['clusters']} clusters of {plan.ranges} "
                                     f"at once, the plan's {plan.tiles} assume one "
                                     "wave")
            if held["visible_ctas_per_sm"] != plan.visible_ctas_per_sm:
                raise AssertionError(f"backward {case.name}: the card holds "
                                     f"{held['visible_ctas_per_sm']} visible-pass "
                                     f"CTAs per SM, the plan assumes "
                                     f"{plan.visible_ctas_per_sm}")
        t = bench.time_case(case, v, "backward")
        launch = (dict(view_tiles=True, cs=plan.cs, ranges=plan.ranges,
                       tiles=plan.tiles, grid=plan.grid, threads=plan.threads,
                       smem_bytes=plan.smem_bytes, **held) if tile else
                  dict(per_voxel=plan.per_voxel, brick=list(plan.brick),
                       grid=plan.grid, threads=plan.threads, cvec=plan.cvec,
                       box_px=plan.box_px, smem_bytes=plan.smem_bytes))
        results.append(dict(
            name=f"back_project_backward/{case.name}", route="cuda",
            source="eprecon_tpu_torch/csrc/back_project.cu",
            replaces="eprecon_tpu/ops/back_project.py:24",
            launches=0, max_abs_err=err, **t, key=[case.mode, case.n, case.c],
            bitwise_equal=True, rel_err=err / scale,
            repeat_max_abs_diff=repeat_diff, fixed_point_exponent=e,
            resolution=resolution, max_plain=scale,
            ctas_per_sm=ctas_per_sm,
            plan_ctas_per_sm=plan.ctas_per_sm,
            brick_views=dict(in_box=in_box, direct=direct, empty=empty),
            launch_parameters=launch))
        if tile:
            how = (f"view tiles: {plan.cs} channels x {plan.ranges} ranges per "
                   f"tile, {plan.tiles} clusters (the card holds "
                   f"{held['clusters']} at once), grid={plan.grid} threads="
                   f"{plan.threads} smem={plan.smem_bytes} B, visible pairs="
                   f"{in_box}, visible-pass CTAs/SM on the card="
                   f"{held['visible_ctas_per_sm']} (plan "
                   f"{plan.visible_ctas_per_sm})")
        elif plan.per_voxel:
            how = f"per-voxel kernel, grid={plan.grid} threads={plan.threads}"
        else:
            how = (f"brick-views in-box/direct/empty={in_box}/{direct}/{empty} | "
                   f"launched with brick={plan.brick} grid={plan.grid} threads="
                   f"{plan.threads} cvec={plan.cvec} box_px={plan.box_px} "
                   f"smem={plan.smem_bytes} B")
        print(f"[backward] {case.name}: N={case.n} C={case.c} bitwise equal to "
              f"the plain version (err={err:.3g}, rel err {err / scale:.3g}, max "
              f"|plain| {scale:.3g}); {REPEATS} repeats bitwise equal to the "
              f"first (max diff {repeat_diff:.3g}); fixed point e={e}, "
              f"resolution 2^-{e}={resolution:.3g} ({resolution / scale:.3g} "
              f"of max |plain|) ms={t['ms']:.4f} "
              f"(profiled windows {t['profiler_windows']}; per kernel "
              + ", ".join(f"{k} {x:.4f}" for k, x in t["parts"].items())
              + f") call_ms={t['call_ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
              f"({t['bound_by']}) CTAs/SM on the card={ctas_per_sm} (plan "
              f"{plan.ctas_per_sm}) {how} | {card}", flush=True)
    return results


def main_path_phase(card):
    """Serve 3 fragments of scene 'a' and 1 of scene 'b' at full width.
    Returns (results, launches, served): `served` keeps, on the host, what
    the export and spvcnn phases hold against: each fragment's program
    inputs and outputs, the panoptic map at each scene's end, the first
    fragment's fused voxels per stage and stage-2 U-Net input, and the
    model."""
    import numpy as np
    import torch
    from eprecon_tpu_torch.config import default_config
    from eprecon_tpu_torch.data.synthetic import make_fragment, make_scene
    from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
    from eprecon_tpu_torch.models.eprecon import EPRecon
    from eprecon_tpu_torch.ops import back_project as bp

    cfg = default_config()
    m = cfg.model
    scene_a, scene_b = make_scene(0), make_scene(7)
    frags = [("a", make_fragment(n_vox=m.n_vox, voxel_size=m.voxel_size,
                                 scene=scene_a, start_angle=a)) for a in (0.0, 0.5, 1.0)]
    frags.append(("b", make_fragment(n_vox=m.n_vox, voxel_size=m.voxel_size,
                                     scene=scene_b, start_angle=0.3)))
    rec = StreamingReconstructor(cfg, EPRecon(m, seed=cfg.seed))  # device: CUDA
    # on the first (warm-up) fragment: the stage-2 U-Net's input and each
    # stage's fused voxel set (the GRU fusion's union mask)
    unet_args, stage_voxels = [], []
    core = rec.model.neucon_net
    hooks = [core.sp_conv_2.register_forward_pre_hook(
        lambda mod, args: unet_args.append([a.detach().cpu() for a in args])
        if not unet_args else None)]
    for i in range(m.n_layer):
        hooks.append(getattr(core, f"gru_fusion_{i}").register_forward_hook(
            lambda mod, args, out: stage_voxels.append(out[1].nonzero().cpu())
            if len(stage_voxels) < m.n_layer else None))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bp.launch_counts.clear()
    per_frag, map_sizes, finished = [], [], None
    served = dict(cfg=cfg, model=rec.model, fragments=[], outputs=[],
                  snapshots=[], raw=frags, stream=[])
    for i, (scene, d) in enumerate(frags):
        before = bp.total_launches()
        t0 = time.perf_counter()
        out = rec.process_fragment(scene, d["imgs"], d["proj_matrices"],
                                   d["vol_origin_partial"] - 0.5,
                                   d["vol_origin_partial"],
                                   d["world_to_aligned_camera"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = bp.total_launches() - before
        if launched != 4:
            raise AssertionError(f"fragment {i}: {launched} kernel launches, want 4")
        if out is not None:
            finished = out
        sizes = [int(g.mask.sum()) for g in rec.rec_state.gmaps]
        for g in rec.rec_state.gmaps:
            if not torch.isfinite(g.feats.float()).all():
                raise AssertionError(f"fragment {i}: non-finite global map")
        if not torch.isfinite(rec.pmap_state.tsdf).all():
            raise AssertionError(f"fragment {i}: non-finite panoptic tsdf")
        per_frag.append(ms)
        map_sizes.append(sizes)
        # what the artifact must reproduce (copied after the clock)
        imgs_t, frag = rec.last_inputs
        last_of_scene = i + 1 == len(frags) or frags[i + 1][0] != scene
        served["fragments"].append(dict(
            imgs=imgs_t.cpu(), **{k: v.cpu() for k, v in frag._asdict().items()},
            reset=i == 0 or frags[i - 1][0] != scene, snapshot=last_of_scene))
        served["outputs"].append({k: rec.last_outputs[k].cpu()
                                  for k in ("tsdf_window", "pred_logits")})
        if last_of_scene:
            served["snapshots"].append({"instance": rec.pmap_state.instance.cpu(),
                                        "semantic": rec.pmap_state.semantic.cpu()})
        if i == 0:
            served["origin"] = frag.vol_origin_partial.cpu()
            session_dir = Path(tempfile.mkdtemp(prefix="eprecon_session_"))
            t0 = time.perf_counter()
            served["jax_session"] = write_jax_session(
                rec, session_dir / "session.npz")
            served["jax_session_write_s"] = time.perf_counter() - t0
        elif scene == frags[0][0]:
            # the uninterrupted stream that the [jax-session] phase's
            # restored reconstructor must reproduce bit for bit
            copy = lambda x: x.to("cpu", copy=True)
            served["stream"].append(dict(
                state={k: copy(v) for k, v in rec._state_arrays().items()},
                outputs={k: copy(rec.last_outputs[k]) for k in SESSION_OUTPUTS}))
        print(f"[main] fragment {i} scene={scene} ms={ms:.1f} "
              f"global-map voxels per level={sizes} | {card}", flush=True)
    for h in hooks:
        h.remove()
    served.update(unet_args=unet_args[0], stage_voxels=stage_voxels)
    launches = dict(bp.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # state threads: scene 'a' maps grow, scene 'b' starts from a reset
    if not (map_sizes[0][2] > 0 and map_sizes[2][2] > map_sizes[0][2]):
        raise AssertionError(f"global map did not grow over scene a: {map_sizes}")
    if not map_sizes[3][2] < map_sizes[2][2]:
        raise AssertionError(f"scene change did not reset the maps: {map_sizes}")
    if finished is None or finished.name != "a":
        raise AssertionError("scene change did not flush scene a")
    if not (np.isfinite(finished.tsdf).all() and finished.tsdf.ndim == 3
            and (np.abs(finished.tsdf) < 1).any()):
        raise AssertionError("flushed scene a has no finite surface")
    print(f"[main] peak memory {peak:.2f} GiB; flushed scene a "
          f"{finished.tsdf.shape} | {card}", flush=True)
    served.update(ms=per_frag, peak_gib=peak)
    return dict(fragment_ms=per_frag, peak_gib=peak, map_sizes=map_sizes,
                launches={str(k): n for k, n in launches.items()},
                flushed_shape=list(finished.tsdf.shape)), launches, served


# [jax-session]: the main phase's reconstructor, saved after fragment 0 in
# the JAX package's session layout, restored into a fresh reconstructor
# and run on; outputs held bit for bit besides every state tensor
SESSION_OUTPUTS = ("tsdf_window", "occupancy", "pred_logits", "pred_masks")


def write_jax_session(rec, path: Path) -> Path:
    """Write a StreamingReconstructor's scene in progress as the JAX
    package's save_session writes it (eprecon_tpu/inference/pipeline.py:
    196-216; tests/test_torch_jax_artifacts.py holds the two writers
    equal): the recurrent state's leaves in its flattening order as
    rec_{i} (per level the global map's features, lane-flattened to
    [Gx, Gy, Gz*C], and mask; then per level the target TSDF and
    occupancy), the panoptic map's as pmap_{i} (tsdf, instance, semantic,
    mask, next_instance_id), bf16 widened to f32, then scene, origin,
    overflows and clipped. Uncompressed: at full width the maps are 2.2 GB
    of f32."""
    import numpy as np
    import torch

    def host(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    st, pm = rec.rec_state, rec.pmap_state
    leaves = [a for g in st.gmaps
              for a in (host(g.feats).reshape(*g.feats.shape[:2], -1), host(g.mask))]
    leaves += [host(a) for t in st.tmaps for a in (t.tsdf, t.occ)]
    pmap = [host(getattr(pm, f)) for f in
            ("tsdf", "instance", "semantic", "mask", "next_instance_id")]
    np.savez(path, scene=np.asarray(rec.scene_name or ""),
             origin=(rec.global_origin if rec.global_origin is not None
                     else np.full(3, np.nan, np.float32)),
             overflows=np.asarray([int(o) for o in rec._overflows], np.int64),
             clipped=np.asarray(rec.clipped_fragments, np.int64),
             **{f"rec_{i}": a for i, a in enumerate(leaves)},
             **{f"pmap_{i}": a for i, a in enumerate(pmap)})
    return path


def jax_session_phase(card, served):
    """Restore the JAX-layout session written after the main phase's
    fragment 0 into a fresh StreamingReconstructor on the card and feed it
    the rest of scene a: every state tensor (global, target and panoptic
    maps) and the outputs in SESSION_OUTPUTS must equal the uninterrupted
    stream's bit for bit, with 4 kernel launches per fragment. Then
    restore_model on an orbax-shaped directory must raise ImportError
    naming tensorstore, which the card's host lacks. Returns (results,
    launches)."""
    import torch
    from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    path = served["jax_session"]
    try:
        size_gb = path.stat().st_size / 1e9
        rec = StreamingReconstructor(served["cfg"], served["model"])
        t0 = time.perf_counter()
        rec.restore_session(str(path))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(path.parent, ignore_errors=True)
    bp.launch_counts.clear()
    rest = [f for f in served["raw"][1:] if f[0] == served["raw"][0][0]]
    if len(rest) != len(served["stream"]) or not rest:
        raise AssertionError("no recorded continuation of scene a")
    compared, frag_ms = 0, []
    for j, ((scene, d), want) in enumerate(zip(rest, served["stream"]), 1):
        before = bp.total_launches()
        t0 = time.perf_counter()
        rec.process_fragment(scene, d["imgs"], d["proj_matrices"],
                             d["vol_origin_partial"] - 0.5,
                             d["vol_origin_partial"],
                             d["world_to_aligned_camera"])
        torch.cuda.synchronize()
        frag_ms.append((time.perf_counter() - t0) * 1e3)
        if bp.total_launches() - before != 4:
            raise AssertionError(f"[jax-session] fragment {j}: "
                                 f"{bp.total_launches() - before} launches, want 4")
        got = {**{k: v.cpu() for k, v in rec._state_arrays().items()},
               **{k: rec.last_outputs[k].cpu() for k in SESSION_OUTPUTS}}
        for k, w in {**want["state"], **want["outputs"]}.items():
            if got[k].dtype != w.dtype or not torch.equal(got[k], w):
                raise AssertionError(f"[jax-session] fragment {j}: {k} differs "
                                     f"from the uninterrupted stream")
            compared += 1
    launches = dict(bp.launch_counts)
    del rec
    work = Path(tempfile.mkdtemp(prefix="eprecon_orbax_"))
    try:
        (work / "_METADATA").write_text(json.dumps({"tree_metadata": {}}))
        try:
            ckpt.restore_model(str(work), served["model"])
        except ImportError as e:
            if "tensorstore" not in str(e):
                raise
            refusal = f"ImportError: {e}"
        else:
            raise AssertionError("restore_model of an orbax directory did "
                                 "not raise without tensorstore")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"[jax-session] written after fragment 0 in "
          f"{served['jax_session_write_s']:.2f} s ({size_gb:.2f} GB), "
          f"restored in {restore_s:.2f} s; fragments 1-{len(rest)} of scene a "
          f"({', '.join(f'{x:.1f}' for x in frag_ms)} ms): {compared} tensors "
          f"bit for bit equal to the uninterrupted stream; phase wall "
          f"{wall:.1f} s | {card}", flush=True)
    print(f"[jax-session] restore_model(orbax dir): {refusal}", flush=True)
    return dict(write_s=served["jax_session_write_s"], file_gb=size_gb,
                restore_s=restore_s, fragment_ms=frag_ms, tensors=compared,
                orbax_refusal=refusal, wall_s=wall), launches


EXPORT_TOL = {"tsdf_window": 1e-5, "pred_logits": 1e-4}  # tests/test_export.py


def _held(got, want, name):
    """Max abs error of got against want, raising beyond EXPORT_TOL (rtol
    and atol, as numpy's allclose)."""
    import torch

    tol = EXPORT_TOL[name]
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{name}: artifact vs live max abs err {err} "
                             f"beyond rtol = atol = {tol}")
    return err


def export_phase(card, served):
    """The fragment forward as a serving artifact at full width, held
    against the main phase's live StreamingReconstructor: exported on the
    card and saved; served from disk by a process that refuses the model
    code (chip_smoke.py --serve-artifact); seed-2 weights swapped into the
    loaded program; and an artifact exported on the CPU, moved to the card
    at load, serving fragment 0. The CPU export runs while the serving
    process loads."""
    import numpy as np
    import torch
    from eprecon_tpu_torch.fragment_io import FragmentInputs
    from eprecon_tpu_torch.inference import export as ex
    from eprecon_tpu_torch.inference import serving
    from eprecon_tpu_torch.inference.pipeline import fragment_forward
    from eprecon_tpu_torch.models.eprecon import EPRecon, make_recurrent_state
    from eprecon_tpu_torch.models.gru_fusion import PanopticGlobalDense
    from eprecon_tpu_torch.ops import back_project as bp

    cfg, model, frags = served["cfg"], served["model"], served["fragments"]
    m = cfg.model
    want_ops = {"eprecon_tpu_torch.window_mean.default": 3,
                "eprecon_tpu_torch.variance.default": 1}

    def inputs(f, dev):
        return (f["imgs"].to(dev),
                FragmentInputs(*(f[k].to(dev) for k in FragmentInputs._fields)))

    work = Path(tempfile.mkdtemp(prefix="eprecon_export_"))
    proc = None
    try:
        t0 = time.perf_counter()
        ep = ex.export_fragment_forward(cfg, model, *inputs(frags[0], "cuda"))
        export_s = time.perf_counter() - t0
        ops = dict(collections.Counter(serving.custom_op_nodes(ep)))
        if ops != want_ops:
            raise AssertionError(f"exported graph's custom ops {ops}, want {want_ops}")
        art = work / "fragment_forward.pt2"
        t0 = time.perf_counter()
        ex.save_serving_artifact(art, ep)
        save_s = time.perf_counter() - t0
        del ep
        swap = EPRecon(m, seed=2)
        torch.save(swap.state_dict(), work / "seed2.pt")
        go = work / "go"
        torch.save({"device": "cuda", "swap": str(work / "seed2.pt"),
                    "go": str(go), "fragments": frags}, work / "requests.pt")
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--serve-artifact",
             str(art), str(work / "requests.pt"), str(work / "results.pt")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        # while it loads: the live path on the seed-2 weights and the export
        # on the CPU; then it serves, alone
        swap = swap.cuda().eval()
        live2, _, _, _ = fragment_forward(
            swap, cfg, *inputs(frags[0], "cuda"), make_recurrent_state(m, "cuda"),
            PanopticGlobalDense.empty(tuple(m.global_extent), device="cuda"))
        live2 = {k: live2[k].cpu() for k in EXPORT_TOL}
        del swap
        cpu_model = EPRecon(m, seed=cfg.seed)
        for a, b in zip(cpu_model.state_dict().values(),
                        model.state_dict().values()):
            if not torch.equal(a, b.cpu()):
                raise AssertionError("the CPU model's weights differ from the card's")
        t0 = time.perf_counter()
        ep_cpu = ex.export_fragment_forward(cfg, cpu_model,
                                            *inputs(frags[0], "cpu"), device="cpu")
        cpu_export_s = time.perf_counter() - t0
        ex.save_serving_artifact(work / "cpu.pt2", ep_cpu)
        del ep_cpu, cpu_model
        go.touch()
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"serving process exited {proc.returncode}:\n"
                                 f"{stderr[-6000:]}")
        res = torch.load(work / "results.pt")
        art_mb = art.stat().st_size / 2 ** 20
        t0 = time.perf_counter()
        moved = serving.load_serving_artifact(work / "cpu.pt2")  # onto CUDA
        moved_load_s = time.perf_counter() - t0
        rec, pmap = serving.initial_state(moved)
        before = bp.total_launches()
        with torch.no_grad():
            out, _, _, _ = moved.module()(*inputs(frags[0], "cuda"), rec, pmap)
        torch.cuda.synchronize()
        moved_launches = bp.total_launches() - before
        if moved_launches != 4:
            raise AssertionError(f"the CPU-exported artifact launched "
                                 f"{moved_launches} kernels, want 4")
        moved_err = {k: _held(out[k].cpu(), served["outputs"][0][k], k)
                     for k in EXPORT_TOL}
        del moved, rec, pmap, out
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(work, ignore_errors=True)
    if res["model_modules"]:
        raise AssertionError(f"the serving process imported {res['model_modules']}")
    errs = {k: max(_held(g[k], w[k], k) for g, w in
                   zip(res["outputs"], served["outputs"], strict=True))
            for k in EXPORT_TOL}
    for got, want in zip(res["snapshots"], served["snapshots"], strict=True):
        for k in ("instance", "semantic"):
            if not torch.equal(got[k], want[k]):
                n = int((got[k] != want[k]).sum())
                raise AssertionError(f"panoptic map {k}: {n} voxels differ "
                                     f"from the live path")
    swap_err = {k: _held(res["swap_outputs"][0][k], live2[k], k)
                for k in EXPORT_TOL}
    # (mode, voxels, channels) -> launches over the served fragments and
    # the swapped-weights one
    launches = {ast.literal_eval(k): n for k, n in res["launches"].items()}
    art_p50 = float(np.median(res["ms"][1:]))
    live_p50 = float(np.median(served["ms"][1:]))
    out = dict(export_s=export_s, save_s=save_s, artifact_mb=art_mb,
               load_s=res["load_s"], module_s=res["module_s"],
               artifact_ms=res["ms"], live_ms=served["ms"],
               artifact_p50_ms=art_p50, live_p50_ms=live_p50,
               artifact_peak_gib=res["peak_gib"], live_peak_gib=served["peak_gib"],
               max_abs_err=errs, swap_max_abs_err=swap_err,
               cpu_export_s=cpu_export_s, moved_load_s=moved_load_s,
               moved_max_abs_err=moved_err, custom_ops=ops,
               launches=res["launches"])
    print(f"[export] export {export_s:.2f} s, save {save_s:.2f} s, artifact "
          f"{art_mb:.1f} MB, load {res['load_s']:.2f} s (+ module "
          f"{res['module_s']:.2f} s) in a process without the model code | "
          f"p50 ms per fragment: artifact {art_p50:.1f} vs live {live_p50:.1f} "
          f"| peak GiB: artifact {res['peak_gib']:.2f} vs live "
          f"{served['peak_gib']:.2f} | {card}", flush=True)
    print(f"[export] ms per fragment: artifact {[round(x, 1) for x in res['ms']]}"
          f" vs live {[round(x, 1) for x in served['ms']]} | {card}", flush=True)
    print(f"[export] max abs err vs live: {errs}; seed-2 weights swapped in: "
          f"{swap_err}; panoptic maps equal at {len(res['snapshots'])} scene "
          f"ends; kernel launches in the serving process "
          f"{res['launches']} | {card}", flush=True)
    print(f"[export] CPU-exported artifact moved to the card: export "
          f"{cpu_export_s:.2f} s, load {moved_load_s:.2f} s, 4 launches, max abs "
          f"err vs live {moved_err} | {card}", flush=True)
    return out, launches


SPVCNN_STAGES = (  # (stage, cr, voxel size m, input channels)
    (0, 1.0, 0.16, 80), (1, 0.5, 0.08, 138), (2, 0.25, 0.04, 74))
SPVCNN_POINTS = 131072  # at most, the fine stage's capacity
SPVCNN_CUT = 8192    # points of the CPU check
SPVCNN_TOL = 1e-4    # card vs CPU, relative to the output's scale
GRU_CH = 48          # the fine stage's fused width (voxel ++ image branch)


def _device_ms(fn, reps=5):
    """Median host ms of `fn` with the card synchronised around each call,
    after one warm-up call."""
    import numpy as np
    import torch

    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def _same_plans(a, b, what):
    """Two plans (SparsePlan or SConv3dPlan) hold equal index tensors."""
    import torch

    def leaves(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, tuple):
            for y in x:
                yield from leaves(y)

    for x, y in zip(leaves(a), leaves(b), strict=True):
        if not x.is_floating_point() and not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what}: card and CPU plans differ")


def spvcnn_phase(card, served):
    """The research engine on real geometry: the voxel centres of the
    first served fragment's fused set at each stage (the GRU fusion's
    union mask, at most 131,072 points), through build_plan and SPVCNN at
    the reference's three stage configurations, and a ConvGRU at the fine
    stage; timed, and held against the port's own CPU run on an 8,192-point
    cut. The stage-2 dense U-Net's time on its captured input stands beside
    it for comparison."""
    import torch
    from eprecon_tpu_torch.models import spvcnn
    from eprecon_tpu_torch.ops import sparse as sp

    origin = served["origin"]
    results = []

    def points(cells, vres, ch, dev, n=SPVCNN_POINTS):
        cells = cells[:n]
        k = cells.shape[0]
        xyz = origin + (cells.float() + 0.5) * vres
        feats = torch.randn(k, ch, generator=torch.Generator().manual_seed(ch))
        return sp.PointSet(xyz.to(dev), torch.zeros(k, dtype=torch.int32, device=dev),
                           feats.to(dev), torch.ones(k, dtype=torch.bool, device=dev))

    def held(module_of, run, plan_of, pts_of, what):
        outs, plans = [], []
        for dev in ("cpu", "cuda"):
            pts, mod = pts_of(dev), module_of(dev)
            plan = plan_of(pts)
            plans.append(plan)
            with torch.no_grad():
                outs.append(run(mod, pts, plan).cpu())
        _same_plans(*plans, what)
        scale = outs[0].abs().max().item()
        err = (outs[1] - outs[0]).abs().max().item()
        if not (scale > 0 and err <= SPVCNN_TOL * scale):
            raise AssertionError(f"{what}: card vs CPU max abs err {err} > "
                                 f"{SPVCNN_TOL} x {scale}")
        return err / scale

    for stage, cr, vres, ch in SPVCNN_STAGES:
        cells = served["stage_voxels"][stage]
        pts = points(cells, vres, ch, "cuda")
        model = spvcnn.SPVCNN(ch, cr=cr, seed=1).eval()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plan_ms = _device_ms(lambda: spvcnn.build_plan(pts, vres))
        plan = spvcnn.build_plan(pts, vres)
        with torch.no_grad():
            fwd_ms = _device_ms(lambda: model(pts.feats, plan))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        voxels = [int(lv.grid.voxels.num_valid()) for lv in plan.levels]
        rel = held(lambda dev: spvcnn.SPVCNN(ch, cr=cr, seed=1, device=dev).eval(),
                   lambda mod, p, pl: mod(p.feats, pl),
                   lambda p: spvcnn.build_plan(p, vres),
                   lambda dev: points(cells, vres, ch, dev, SPVCNN_CUT),
                   f"spvcnn stage {stage}")
        n = int(pts.xyz.shape[0])
        results.append(dict(stage=stage, cr=cr, vres=vres, in_ch=ch, points=n,
                            voxels=voxels, plan_ms=plan_ms, forward_ms=fwd_ms,
                            peak_gib=peak, cpu_rel_err=rel))
        print(f"[spvcnn] stage {stage}: cr={cr} vres={vres * 100:.0f} cm "
              f"C_in={ch} points={n} voxels per level={voxels} build_plan "
              f"ms={plan_ms:.2f} forward ms={fwd_ms:.2f} peak {peak:.2f} GiB | "
              f"card vs CPU on {SPVCNN_CUT} points: plans equal, rel err "
              f"{rel:.2e} | {card}", flush=True)
        del model, plan, pts

    # ConvGRU at the fine stage
    _, _, vres, _ = SPVCNN_STAGES[-1]
    fine = served["stage_voxels"][-1]
    pts = points(fine, vres, GRU_CH, "cuda")
    n = int(pts.xyz.shape[0])
    h = torch.randn(n, GRU_CH, generator=torch.Generator().manual_seed(0))
    gru = spvcnn.ConvGRU(GRU_CH, GRU_CH, seed=1)
    torch.cuda.reset_peak_memory_stats()
    gplan_ms = _device_ms(lambda: spvcnn.build_sconv_plan(pts, vres))
    gplan = spvcnn.build_sconv_plan(pts, vres)
    with torch.no_grad():
        gru_ms = _device_ms(lambda: gru(h.cuda(), pts.feats, gplan))
    gpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    grel = held(lambda dev: spvcnn.ConvGRU(GRU_CH, GRU_CH, seed=1, device=dev),
                lambda mod, p, pl: mod(h[:SPVCNN_CUT].to(p.xyz.device), p.feats, pl),
                lambda p: spvcnn.build_sconv_plan(p, vres),
                lambda dev: points(fine, vres, GRU_CH, dev, SPVCNN_CUT),
                "convgru")
    # the dense stage-2 U-Net on the input it had in the served fragment
    unet = served["model"].neucon_net.sp_conv_2
    args = [a.cuda() for a in served["unet_args"]]
    with torch.no_grad():
        unet_ms = _device_ms(lambda: unet(*args))
    del args
    print(f"[spvcnn] ConvGRU({GRU_CH}) at 4 cm on {n} points: build_sconv_plan "
          f"ms={gplan_ms:.2f} forward ms={gru_ms:.2f} peak {gpeak:.2f} GiB, "
          f"card vs CPU rel err {grel:.2e} | the stage-2 dense U-Net (96^3 "
          f"window) on its served input: {unet_ms:.2f} ms (for comparison) | "
          f"{card}", flush=True)
    return dict(stages=results, gru=dict(points=n, plan_ms=gplan_ms,
                                         forward_ms=gru_ms, peak_gib=gpeak,
                                         cpu_rel_err=grel),
                dense_unet_stage2_ms=unet_ms)


def reference_phase(card):
    """Tiny forward on CUDA and on the CPU with the same weights."""
    import numpy as np
    import torch
    from eprecon_tpu_torch.config import default_config
    from eprecon_tpu_torch.data.synthetic import make_fragment
    from eprecon_tpu_torch.models import eprecon as te

    m = dataclasses.replace(
        default_config().model, n_vox=(32, 32, 32), voxel_size=0.12,
        voxel_capacity=(512, 4096, 32768), global_extent=(64, 64, 32),
        thresholds=(-100.0,) * 3, occ_init_threshold=0.0)
    d = make_fragment(n_views=3, image_hw=(96, 128), n_vox=m.n_vox,
                      voxel_size=m.voxel_size, seed=3)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = te.EPRecon(m, use_running_average=True, seed=5).to(dev)
        frag = te.FragmentInputs(
            torch.as_tensor(d["proj_matrices"], device=dev),
            torch.as_tensor(d["vol_origin_partial"], device=dev),
            torch.as_tensor(d["world_to_aligned_camera"], device=dev),
            np.zeros((3, 3), np.int64))
        with torch.no_grad():
            out, _, _ = model(torch.as_tensor(d["imgs"], device=dev), frag,
                           te.make_recurrent_state(m, dev))
        outs[dev] = {k: v.cpu() for k, v in out.items()
                     if isinstance(v, torch.Tensor)}
    res = {}
    for k in ("occupancy", "valid", "coords"):
        if not torch.equal(outs["cpu"][k], outs["cuda"][k]):
            raise AssertionError(f"reference check: {k} differs CPU vs CUDA")
    for k in ("tsdf_window", "pred_logits"):
        a, b = outs["cpu"][k].float(), outs["cuda"][k].float()
        rel = ((a - b).abs().max() / a.abs().max().clamp(min=1e-6)).item()
        res[k] = rel
        if not (torch.isfinite(b).all() and rel < 0.1):
            raise AssertionError(f"reference check: {k} rel err {rel}")
    print(f"[reference] tiny forward CUDA vs CPU: {res} | {card}", flush=True)
    return res


def train_phase(card):
    """Six training micro-steps at full width over one scene stream."""
    import numpy as np
    import torch
    from eprecon_tpu_torch.config import default_config
    from eprecon_tpu_torch.data.synthetic import make_fragment, make_scene
    from eprecon_tpu_torch.models.eprecon import EPRecon, LOSS_ORDER
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.ops import grid
    from eprecon_tpu_torch.train.state import Trainer, fragment_tensors

    cfg = default_config()
    m = dataclasses.replace(cfg.model, thresholds=(-100.0,) * 3,
                            occ_init_threshold=0.0)
    cfg = dataclasses.replace(cfg, model=m, train=dataclasses.replace(
        cfg.train, accumulation_steps=2))
    reduced = dict(accumulation_steps=2, thresholds=m.thresholds,
                   occ_init_threshold=m.occ_init_threshold)
    print(f"[train] reduced from the default config: {reduced} | {card}",
          flush=True)
    scene = make_scene(0)
    frags = [make_fragment(n_vox=m.n_vox, voxel_size=m.voxel_size, scene=scene,
                           start_angle=0.2 * i) for i in range(TRAIN_STEPS)]
    g_origin = grid.scene_global_origin(m.global_extent, m.n_vox, m.n_scales,
                                        m.voxel_size,
                                        frags[0]["vol_origin_partial"] - 0.5,
                                        m.origin_margin)
    trainer = Trainer(cfg, EPRecon(m, seed=cfg.seed))  # device: CUDA
    groups = (["backbone2d.", "backbone_occ_pano.", "neucon_net.panoptic."]
              + [f"neucon_net.{g}_{i}." for g in ("sp_conv", "gru_fusion")
                 for i in range(m.n_layer)])
    rec = trainer.recurrent_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bp.launch_counts.clear()
    bp.backward_launch_counts.clear()
    step_ms, losses, map_sizes, grad_norms = [], [], [], {}
    for i, d in enumerate(frags):
        rel = np.stack([np.round((d["vol_origin_partial"] - g_origin)
                                 / (m.voxel_size * 2 ** (m.n_scales - lv)))
                        for lv in range(m.n_layer)]).astype(np.int64)
        imgs, frag, targets = fragment_tensors(d, rel, torch.device("cuda"))
        before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        fwd, bwd = bp.total_launches(), bp.total_backward_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec, metrics = trainer.step(imgs, frag, targets, rec)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launched = (bp.total_launches() - fwd, bp.total_backward_launches() - bwd)
        if launched != (4, 4):
            raise AssertionError(f"step {i}: {launched} forward/backward kernel "
                                 f"launches, want (4, 4)")
        terms = {k: float(metrics[k]) for k in (*LOSS_ORDER, "total_loss")}
        if not all(np.isfinite(x) and x > 0 for x in terms.values()):
            raise AssertionError(f"step {i}: loss terms {terms}")
        updated = trainer.optimizer.mini_step == 0
        if i == 0:  # the accumulator holds step 0's gradients
            acc = trainer.optimizer.acc
            grad_norms = {g: float(torch.sqrt(sum(acc[n].square().sum() for n in acc
                                                  if n.startswith(g))))
                          for g in groups}
            if not all(x > 0 for x in grad_norms.values()):
                raise AssertionError(f"zero gradient in a module group: {grad_norms}")
        moved = any(not torch.equal(p, before[n])
                    for n, p in trainer.model.named_parameters())
        if moved != updated:
            raise AssertionError(f"step {i}: parameters moved={moved}, "
                                 f"optimizer updated={updated}")
        for gm in rec.gmaps:
            if not torch.isfinite(gm.feats.float()).all():
                raise AssertionError(f"step {i}: non-finite global map")
        map_sizes.append([int(gm.mask.sum()) for gm in rec.gmaps])
        losses.append(terms)
        print(f"[train] step {i} ms={step_ms[-1]:.1f} updated={updated} "
              f"losses={ {k: round(x, 4) for k, x in terms.items()} } "
              f"global-map voxels per level={map_sizes[-1]} | {card}", flush=True)
    if not map_sizes[-1][2] > map_sizes[0][2]:
        raise AssertionError(f"global map did not grow: {map_sizes}")
    if trainer.optimizer.updates != TRAIN_STEPS // 2:
        raise AssertionError(f"{trainer.optimizer.updates} optimizer updates")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = float(np.median(step_ms[2:]))
    print(f"[train] step 0 ms={step_ms[0]:.1f}; steady-state step ms (median of "
          f"steps 3-{TRAIN_STEPS})={steady:.1f}; peak memory {peak:.2f} GiB; "
          f"gradient norms at step 0 { {k: round(x, 5) for k, x in grad_norms.items()} }"
          f" | {card}", flush=True)
    return dict(step_ms=step_ms, steady_step_ms=steady, peak_gib=peak,
                losses=losses, map_sizes=map_sizes, grad_norms=grad_norms,
                reduced=reduced), dict(bp.launch_counts), dict(bp.backward_launch_counts)


QUALITY_SEEDS = (0, 1, 2)
QUALITY_REPORT = (0, 25, 47, 50, 75, 99)
QUALITY_REPEAT_STEPS = 20  # seed 0 again, every loss bitwise equal to its first run's


def quality_phase(card):
    """The closed quality loop on the card, in a process of its own that
    turns on quality_run's deterministic mode before any CUDA work
    (`--quality-phase`, quality_checks). Returns its results."""
    out = Path(tempfile.mkdtemp(prefix="eprecon_quality_"))
    t0 = time.perf_counter()
    try:
        rc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                             "--quality-phase", str(out / "quality.json")],
                            cwd=REPO).returncode
        if rc != 0:
            raise AssertionError(f"quality: the phase's process exited {rc}")
        res = json.loads((out / "quality.json").read_text())
    finally:
        shutil.rmtree(out, ignore_errors=True)
    res["process_wall_s"] = time.perf_counter() - t0
    print(f"[quality] process wall {res['process_wall_s']:.1f} s | {card}",
          flush=True)
    return res


def quality_checks(out: Path) -> int:
    """The quality phase's process: deterministic mode first, then
    quality_run.run_seeds at each seed, held to the JAX package's floors by
    the median over the seeds, every step through the kernels; then seed
    0 again for QUALITY_REPEAT_STEPS steps, every loss equal to the first
    run's bit for bit. Writes the results to `out`."""
    from eprecon_tpu_torch.tools import quality_run as qr

    qr.deterministic_mode()
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.tools.bench_back_project import card_line
    from eprecon_tpu_torch.tools.quality_utils import tiny_cfg

    card = card_line()
    t_phase = time.perf_counter()
    bp.launch_counts.clear()
    bp.backward_launch_counts.clear()
    report = sorted(set(QUALITY_REPORT) | set(range(QUALITY_REPEAT_STEPS)))
    runs, bad = qr.run_seeds(
        tiny_cfg(), QUALITY_SEEDS, device="cuda", report_at=report,
        log=lambda line: print(f"[quality] {line} | {card}", flush=True))
    runs = [runs[s] for s in QUALITY_SEEDS]
    med = qr.median_scores(runs)
    wall = time.perf_counter() - t_phase
    fwd, bwd = bp.total_launches(), bp.total_backward_launches()
    print(f"[quality] deterministic mode: median over seeds {list(QUALITY_SEEDS)}: "
          f"window fscore after {qr.WINDOW_FSCORE_STEPS} "
          f"{med[qr.WINDOW_FSCORE_STEPS, 'window_fscore']:.4f} (floor "
          f"{qr.WINDOW_FSCORE_FLOOR}); after {qr.PQ_STEPS}: fscore "
          f"{med[qr.PQ_STEPS, 'fscore']:.4f} (floor {qr.FSCORE_FLOOR}), PQ "
          f"{med[qr.PQ_STEPS, 'PQ']:.4f} (floor {qr.PQ_FLOOR}), predicted "
          f"instances {med[qr.PQ_STEPS, 'n_pred_inst']:.0f}; ms per step "
          f"{[round(r['ms_per_step'], 1) for r in runs]}; launches forward "
          f"{fwd} backward {bwd}; seeds' wall {wall:.1f} s | {card}", flush=True)
    seed = QUALITY_SEEDS[0]
    first = [runs[0]["losses"][i]["total_loss"] for i in range(QUALITY_REPEAT_STEPS)]
    print(f"[quality] seed {seed} total loss at steps 0-{QUALITY_REPEAT_STEPS - 1}: "
          + " ".join(f"{x:.9g}" for x in first) + f" | {card}", flush=True)
    t0 = time.perf_counter()
    again = qr.train_and_score(tiny_cfg(), QUALITY_REPEAT_STEPS, (), seed,
                               "cuda", range(QUALITY_REPEAT_STEPS))
    differ = [i for i in range(QUALITY_REPEAT_STEPS)
              if again["losses"][i] != runs[0]["losses"][i]]
    repeat_s = time.perf_counter() - t0
    print(f"[quality] seed {seed} again for {QUALITY_REPEAT_STEPS} steps "
          f"({repeat_s:.1f} s): " + ("every loss term equal bit for bit to the "
                                     "first run's" if not differ else
                                     f"steps {differ} differ from the first run")
          + f" | {card}", flush=True)
    if differ:
        i = differ[0]
        bad.append(f"seed {seed} again: step {i} losses {again['losses'][i]} != "
                   f"the first run's {runs[0]['losses'][i]}")
    for r in runs:
        r["launches"] = [sum(n[0] for n in r["launches"]),
                         sum(n[1] for n in r["launches"])]
        r["losses"] = {str(k): v for k, v in r["losses"].items()}
        r["scores"] = {str(k): v for k, v in r["scores"].items()}
    out.write_text(json.dumps(dict(
        seeds=list(QUALITY_SEEDS), runs=runs, wall_s=wall,
        median={f"{k[1]}@{k[0]}": v for k, v in med.items()},
        launches=dict(forward=fwd, backward=bwd), deterministic=True,
        repeat=dict(seed=seed, steps=QUALITY_REPEAT_STEPS, equal=not differ,
                    wall_s=repeat_s), failures=bad)))
    if bad:
        print("[quality] FAILED: " + "; ".join(bad), flush=True)
        return 1
    return 0


def train_reference_phase(card):
    """One training micro-step at tiny size on CUDA and on the CPU, same
    weights and data, running-statistics BatchNorm: loss terms and the
    gradient (the optimizer's accumulator) compared."""
    import numpy as np
    import torch
    from eprecon_tpu_torch.config import default_config
    from eprecon_tpu_torch.data.synthetic import make_fragment
    from eprecon_tpu_torch.models import eprecon as te
    from eprecon_tpu_torch.train.state import Trainer, fragment_tensors

    cfg = default_config()
    m = dataclasses.replace(
        cfg.model, n_vox=(32, 32, 32), voxel_size=0.12,
        voxel_capacity=(512, 4096, 32768), global_extent=(64, 64, 32),
        thresholds=(-100.0,) * 3, occ_init_threshold=0.0, min_init_voxels=1,
        min_stage_voxels=1, panoptic=dataclasses.replace(
            cfg.model.panoptic, min_instance_voxels=20))
    cfg = dataclasses.replace(cfg, model=m, train=dataclasses.replace(
        cfg.train, accumulation_steps=2))
    d = make_fragment(n_views=3, image_hw=(96, 128), n_vox=m.n_vox,
                      voxel_size=m.voxel_size, seed=3)
    terms, grads = {}, {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, te.EPRecon(m, use_running_average=True, seed=5),
                     device=dev)
        imgs, frag, targets = fragment_tensors(d, np.zeros((3, 3), np.int64),
                                               torch.device(dev))
        _, metrics = tr.step(imgs, frag, targets, tr.recurrent_state())
        terms[dev] = {k: float(x) for k, x in metrics.items()}
        grads[dev] = torch.cat([a.flatten().cpu() for _, a in
                                sorted(tr.optimizer.acc.items())])
    rel = {k: abs(terms["cuda"][k] - x) / max(abs(x), 1e-6)
           for k, x in terms["cpu"].items() if "loss" in k}
    a, b = grads["cpu"], grads["cuda"]
    cos = float((a * b).sum() / (a.norm() * b.norm()))
    print(f"[reference] tiny training step CUDA vs CPU: loss rel err {rel}, "
          f"gradient cosine {cos:.5f} | {card}", flush=True)
    if not (all(x < 5e-2 for x in rel.values()) and torch.isfinite(b).all()
            and cos > 0.98):
        raise AssertionError(f"training reference check: {rel}, cosine {cos}")
    return dict(loss_rel_err=rel, grad_cosine=cos)


# --------------------------------------------------------------------------
# cli phase: the CLI (eprecon_tpu_torch.main) over a ScanNet-layout tree
# that the port writes, with GT that the port generates
# --------------------------------------------------------------------------

CLI_SCENES, CLI_FRAGMENTS, CLI_VIEWS = 2, 3, 9
# an orbit of 27 frames 0.51 m apart: every frame is a keyframe (> 0.1 m)
CLI_FRAMES = CLI_FRAGMENTS * CLI_VIEWS
CLI_COLOR_HW, CLI_DEPTH_HW = (968, 1296), (480, 640)   # ScanNet's raw sizes
CLI_TRAIN_STEPS = CLI_SCENES * CLI_FRAGMENTS            # per epoch
CLI_REDUCED = ["train.accumulation_steps", "2", "model.thresholds",
               "[-100,-100,-100]", "model.occ_init_threshold", "0"]
CLI_TRAIN_WORKERS, CLI_TEST_WORKERS, CLI_DEPTH_FRAMES = 8, 4, 9
COLOR_MEAN_TOL = 2.0   # grey levels: JPEG at quality 95 against the render


def generate_gt_on_card(scans: Path, labels: Path):
    """tools/generate_gt.generate_all over `scans` at 4 cm on cuda; fails
    unless every volume it fused lay on the card. Returns (the GT
    directory, the lines it printed, its seconds)."""
    from eprecon_tpu_torch.ops import tsdf_fusion
    from eprecon_tpu_torch.tools.generate_gt import generate_all

    devices = []
    make_volume = tsdf_fusion.make_volume

    def recorded(*a, **kw):
        vol = make_volume(*a, **kw)
        devices.append(vol.tsdf.device.type)
        return vol

    tee = _Tee(sys.stdout)
    tsdf_fusion.make_volume = recorded
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            gt = Path(generate_all(str(scans), "all_tsdf_9", 0.04, CLI_VIEWS,
                                   label_path=str(labels), device="cuda"))
        seconds = time.perf_counter() - t0
    finally:
        tsdf_fusion.make_volume = make_volume
    if set(devices) != {"cuda"}:
        raise AssertionError(f"GT fusion ran on {sorted(set(devices))}")
    return gt, tee.lines, seconds


def write_tree(root: Path, card):
    """The port writes the tree (tools/make_synthetic_scannet.write_scene:
    textured scenes, color 1296x968 jpg, depth 640x480 png, poses,
    intrinsics, label exports) and generates its GT on the card
    (tools/generate_gt.generate_all at 4 cm). Returns timings and GT
    facts."""
    import numpy as np
    from eprecon_tpu_torch.tools.make_synthetic_scannet import write_scene

    scans, labels = root / "scans", root / "labels"
    t0 = time.perf_counter()
    for s in range(CLI_SCENES):
        write_scene(str(scans), str(labels), f"scene{s:04d}_00", seed=s,
                    n_frames=CLI_FRAMES, image_hw=CLI_DEPTH_HW,
                    color_hw=CLI_COLOR_HW)
    write_s = time.perf_counter() - t0
    (root / "scans_test").symlink_to(scans)

    gt, lines, _ = generate_gt_on_card(scans, labels)
    per_scene = {}
    for line in lines:
        scene = line.split(":")[0]
        with np.load(gt / scene / "full_tsdf_layer0.npz") as z:
            shape = z["arr_0"].shape
        per_scene[scene] = dict(
            seconds=float(re.search(r"in ([0-9.]+) s$", line).group(1)),
            voxels=int(np.prod(shape)), shape=list(shape))
    print(f"[gt] generate_all on cuda at 4 cm, {CLI_FRAMES} frames per scene: "
          + "; ".join(f"{n} {x['seconds']:.2f} s, {x['voxels']} voxels "
                      f"{x['shape']}" for n, x in per_scene.items())
          + f" | {card}", flush=True)
    return dict(write_s=write_s, gt=per_scene, gt_devices=["cuda"])


def loader_checks(root: Path, common, card):
    """The tree against its sources and the decode-ahead path against the
    synchronous one: decoded depth equals the written u16 / 1000; decoded
    color, padded and resized, within COLOR_MEAN_TOL of the render resized
    the same way; every fragment of the GT pkls names 9 frames on disk;
    the prefetcher's first sample equals dataset[0] (images bit for bit,
    cameras, projections and GT exactly); decode ms per fragment."""
    import pickle

    import numpy as np
    from eprecon_tpu_torch import main as cli
    from eprecon_tpu_torch.config import load_config, parse_cli_overrides
    from eprecon_tpu_torch.data import native_loader as nl
    from eprecon_tpu_torch.data.prefetch import FragmentPrefetcher
    from eprecon_tpu_torch.data.synthetic import make_scene, orbit_poses, render_view
    from eprecon_tpu_torch.data.transforms import pad_scannet, resize_bilinear

    found = nl.probe_libraries()
    scans, gt = root / "scans", root / "all_tsdf_9"
    for split in ("train", "val", "test"):
        with open(gt / f"fragments_{split}.pkl", "rb") as f:
            metas = pickle.load(f)
        if len(metas) != CLI_SCENES * CLI_FRAGMENTS:
            raise AssertionError(f"fragments_{split}.pkl: {len(metas)} fragments")
        for m in metas:
            files = [scans / m["scene"] / sub / f"{v}.{ext}" for v in m["image_ids"]
                     for sub, ext in (("color", "jpg"), ("depth", "png"),
                                      ("pose", "txt"))]
            if len(m["image_ids"]) != CLI_VIEWS or not all(f.is_file() for f in files):
                raise AssertionError(f"{split} fragment {m['scene']} "
                                     f"{m['fragment_id']}: {m['image_ids']}")

    # frame 0 of scene 0 against its render
    src = scans / "scene0000_00"
    k_color = np.loadtxt(src / "intrinsic" / "intrinsic_color.txt")[:3, :3].astype(np.float32)
    k_depth = np.loadtxt(src / "intrinsic" / "intrinsic_depth.txt")[:3, :3].astype(np.float32)
    pose = orbit_poses(CLI_FRAMES, sweep=2 * np.pi * (CLI_FRAMES - 1) / CLI_FRAMES)[0]
    scene = make_scene(0, textured=True)
    want_d = (render_view(scene, k_depth, pose, CLI_DEPTH_HW)[0] * 1000.0).astype(np.uint16)
    want_d = want_d.astype(np.float32) / 1000.0
    want_d[want_d > 3.0] = 0.0
    got_d = nl.decode_png_depth(str(src / "depth" / "0.png"), 3.0)
    if not np.array_equal(got_d, want_d):
        raise AssertionError(f"decoded depth differs from the written one by "
                             f"{np.abs(got_d - want_d).max()}")
    small = lambda im: resize_bilinear(pad_scannet(im, np.eye(3))[0], (640, 480))
    render = render_view(scene, k_color, pose, CLI_COLOR_HW)[1].astype(np.uint8)
    color_err = float(np.abs(small(nl.decode_jpeg(str(src / "color" / "0.jpg")))
                             - small(render.astype(np.float32))).mean())
    if not color_err <= COLOR_MEAN_TOL:
        raise AssertionError(f"decoded color: mean error {color_err} grey levels")

    # decode per fragment: the threaded loader and the synchronous readers
    cfg = load_config(str(REPO / "config/train.yaml"), parse_cli_overrides(common))
    ds = cli.build_dataset(cfg, "train")
    imgs, depths = ds.image_paths(0)
    native_ms, sync_ms = [], []
    with nl.NativeFragmentLoader(CLI_TRAIN_WORKERS) as loader:
        for _ in range(4):
            t0 = time.perf_counter()
            loader.fetch(loader.submit(imgs, depths), len(imgs))
            native_ms.append(1e3 * (time.perf_counter() - t0))
    for _ in range(2):
        t0 = time.perf_counter()
        for c, d in zip(imgs, depths):
            ds._read_img(c)
            ds._read_depth(d)
        sync_ms.append(1e3 * (time.perf_counter() - t0))

    # the prefetcher's sample against the synchronous one
    want = ds[0]
    pf = FragmentPrefetcher(ds, n_threads=CLI_TRAIN_WORKERS)
    try:
        got = next(pf.iterate([0]))
    finally:
        pf.close()
    if set(got) != set(want):
        raise AssertionError(f"prefetched keys {sorted(set(got) ^ set(want))}")
    for key, w in want.items():
        g = got[key]
        same = (all(np.array_equal(a, b) for a, b in zip(g, w)) and len(g) == len(w)
                if isinstance(w, list) else np.array_equal(g, w)
                if isinstance(w, np.ndarray) else g == w)
        if not same:
            raise AssertionError(f"prefetched sample differs from dataset[0] at {key}")
    res = dict(libraries={k: v is not None for k, v in found.items()},
               route=nl.route(), color_mean_err=color_err,
               decode_fragment_ms=native_ms, sync_read_fragment_ms=sync_ms,
               prefetch_depth=pf.depth, threads=CLI_TRAIN_WORKERS)
    print(f"[loader] libraries found: "
          + ", ".join(f"{k} {'yes' if v else 'no'}" for k, v in res["libraries"].items())
          + f"; route {res['route']}; decode of a fragment (9 views, color "
          f"1296x968 -> 640x480, depth 640x480) by the loader's "
          f"{CLI_TRAIN_WORKERS} threads {[round(x, 1) for x in native_ms]} ms, "
          f"by the synchronous readers (full size, no resize) "
          f"{[round(x, 1) for x in sync_ms]} ms; prefetch depth {pf.depth}; "
          f"decoded color {color_err:.3f} grey levels from its render; "
          f"prefetched sample == dataset[0] | {card}", flush=True)
    return res


def time_sample_stages(dataset, indices, prefetcher=None):
    """Host ms per sample, by stage, with the card synchronised at each
    stage's end: frame reads (decode; with a prefetcher the wait for its
    fetch and the camera reads), resize, the world-frame transform (its GT
    fusion on the card apart), projections, and the whole sample."""
    import numpy as np
    import torch
    from eprecon_tpu_torch.ops import tsdf_fusion

    acc = {}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc[name] = acc.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
            return out
        return run

    stages, fuse = dataset.transforms.transforms, tsdf_fusion.fuse_frames
    names = ["resize", "world_transform_and_gt", "projection"]
    dataset.transforms.transforms = [timed(n, t) for n, t in zip(names, stages)]
    for r in ("_read_img", "_read_depth", "_read_cam"):
        setattr(dataset, r, timed("read", getattr(dataset, r)))
    tsdf_fusion.fuse_frames = timed("gt_fusion", tsdf_fusion.fuse_frames)
    if prefetcher is not None:
        prefetcher.loader.fetch = timed("fetch_wait", prefetcher.loader.fetch)
        samples = prefetcher.iterate(indices)
    else:
        samples = (dataset[i] for i in indices)
    try:
        per = []
        while True:
            acc.clear()
            t0 = time.perf_counter()
            if next(samples, None) is None:
                break
            torch.cuda.synchronize()
            per.append(dict(acc, total=1e3 * (time.perf_counter() - t0)))
    finally:
        dataset.transforms.transforms = stages
        del dataset._read_img, dataset._read_depth, dataset._read_cam
        tsdf_fusion.fuse_frames = fuse
    return {k: float(np.median([p.get(k, 0.0) for p in per])) for k in per[0]}


class _Tee:
    """stdout that is also kept, line by line."""

    def __init__(self, out):
        self.out, self.lines, self._buf = out, [], ""

    def write(self, text):
        self.out.write(text)
        self._buf += text
        *done, self._buf = self._buf.split("\n")
        self.lines += done
        return len(text)

    def flush(self):
        self.out.flush()


def _run_cli(args):
    """eprecon_tpu_torch.main.main(args) in this process; returns (its
    result, the lines it printed)."""
    from eprecon_tpu_torch import main as cli

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = cli.main(args)
    return out, tee.lines


def cli_phase(root: Path, card):
    """Write a ScanNet-layout tree and its GT with the port under `root`,
    check the loader on it, then train (decode-ahead), resume (synchronous
    reads) and test (decode-ahead, depth protocol) through the CLI at full
    width."""
    import gc

    import numpy as np
    import torch
    from eprecon_tpu_torch import main as cli
    from eprecon_tpu_torch.config import load_config, parse_cli_overrides
    from eprecon_tpu_torch.data import prefetch
    from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.ops import tsdf_fusion
    from eprecon_tpu_torch.tools import evaluation
    from eprecon_tpu_torch.train.state import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    tree = write_tree(root, card)
    logdir = root / "run"
    common = ["train.path", str(root), "test.path", str(root), "logdir",
              str(logdir), "summary_freq", "1", *CLI_REDUCED]
    print(f"[cli] tree of {CLI_SCENES} scenes x {CLI_FRAGMENTS} fragments x "
          f"{CLI_VIEWS} views (color {CLI_COLOR_HW[1]}x{CLI_COLOR_HW[0]} jpg, "
          f"depth {CLI_DEPTH_HW[1]}x{CLI_DEPTH_HW[0]} png) written by the "
          f"port in {tree['write_s']:.1f} s, GT generated on the card; "
          f"reduced from config/*.yaml: {CLI_REDUCED} | {card}", flush=True)
    loader = loader_checks(root, common, card)

    # instrumentation: launches per training step and per test fragment,
    # the device of every GT fusion of the data pipeline, the samples
    # that came through the prefetcher, the depth protocol's times
    per_step, per_frag, fusion_devices, prefetched = [], [], [], []
    render_ms, trim_s = [], []
    step, process = Trainer.step, StreamingReconstructor.process_fragment
    fuse, iterate = tsdf_fusion.fuse_frames, prefetch.FragmentPrefetcher.iterate
    render, trim = evaluation.render_tsdf_depth, evaluation.trim_tsdf

    def counted(fn, out_list):
        def run(*a, **kw):
            before = (bp.total_launches(), bp.total_backward_launches())
            out = fn(*a, **kw)
            out_list.append((bp.total_launches() - before[0],
                             bp.total_backward_launches() - before[1]))
            return out
        return run

    def timed(fn, out_list, scale):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            out_list.append(scale * (time.perf_counter() - t0))
            return out
        return run

    def fuse_recorded(depths, *a, **kw):
        fusion_devices.append(depths.device.type)
        return fuse(depths, *a, **kw)

    def iterate_recorded(self, indices):
        for sample in iterate(self, indices):
            prefetched.append(sample["fragment"])
            yield sample

    Trainer.step = counted(step, per_step)
    StreamingReconstructor.process_fragment = counted(process, per_frag)
    tsdf_fusion.fuse_frames = fuse_recorded
    prefetch.FragmentPrefetcher.iterate = iterate_recorded
    evaluation.render_tsdf_depth = timed(render, render_ms, 1e3)
    evaluation.trim_tsdf = timed(trim, trim_s, 1.0)
    bp.launch_counts.clear()
    bp.backward_launch_counts.clear()
    try:
        t0 = time.perf_counter()
        tr1, log1 = _run_cli(["--cfg", "config/train.yaml", *common,
                              "train.epochs", "1",
                              "train.n_workers", str(CLI_TRAIN_WORKERS)])
        train1_s = time.perf_counter() - t0
        n_prefetched_train = len(prefetched)
        t0 = time.perf_counter()
        tr2, log2 = _run_cli(["--cfg", "config/train.yaml", *common,
                              "train.epochs", "2", "resume", "true",
                              "train.n_workers", "0"])
        train2_s = time.perf_counter() - t0
        n_prefetched_resume = len(prefetched) - n_prefetched_train
        del tr1, tr2
        gc.collect()
        t0 = time.perf_counter()
        results, log3 = _run_cli(["--cfg", "config/test.yaml", *common,
                                  "loadckpt", str(logdir / "model_000001"),
                                  "test.n_workers", str(CLI_TEST_WORKERS),
                                  "test.eval_depth_frames",
                                  str(CLI_DEPTH_FRAMES)])
        test_s = time.perf_counter() - t0
        n_prefetched_test = (len(prefetched) - n_prefetched_train
                             - n_prefetched_resume)
    finally:
        Trainer.step, StreamingReconstructor.process_fragment = step, process
        tsdf_fusion.fuse_frames = fuse
        prefetch.FragmentPrefetcher.iterate = iterate
        evaluation.render_tsdf_depth, evaluation.trim_tsdf = render, trim
    launches = dict(bp.launch_counts)
    backward_launches = dict(bp.backward_launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # checks
    steps = 2 * CLI_TRAIN_STEPS
    if per_step != [(4, 4)] * steps:
        raise AssertionError(f"training steps launched {per_step} forward/"
                             f"backward kernels, want (4, 4) x {steps}")
    n_test = CLI_SCENES * CLI_FRAGMENTS
    if per_frag != [(4, 0)] * n_test:
        raise AssertionError(f"test fragments launched {per_frag}, want "
                             f"(4, 0) x {n_test}")
    if (n_prefetched_train, n_prefetched_resume, n_prefetched_test) != (
            CLI_TRAIN_STEPS, 0, n_test):
        raise AssertionError(f"samples through the prefetcher: train "
                             f"{n_prefetched_train}, resume "
                             f"{n_prefetched_resume}, test {n_prefetched_test}")
    if not fusion_devices or set(fusion_devices) != {"cuda"}:
        raise AssertionError(f"GT fusion ran on {sorted(set(fusion_devices))}")
    resumed = [x for x in log2 if x.startswith("resumed from ")]
    if not (len(resumed) == 1 and resumed[0].endswith(
            f"model_000000 at epoch 1, step {CLI_TRAIN_STEPS}")):
        raise AssertionError(f"resume: {resumed}")
    ckpts = sorted(x.name for x in logdir.glob("model_*"))
    if ckpts != ["model_000000", "model_000001"]:
        raise AssertionError(f"checkpoints {ckpts}")
    state = [torch.load(logdir / c, map_location="cpu", weights_only=True)
             for c in ckpts]
    if [(x["epoch"], x["step"]) for x in state] != [(1, CLI_TRAIN_STEPS),
                                                     (2, steps)]:
        raise AssertionError(f"checkpoint epochs/steps "
                             f"{[(x['epoch'], x['step']) for x in state]}")
    if all(torch.equal(a, state[1]["model"][n])
           for n, a in state[0]["model"].items()):
        raise AssertionError("parameters did not move in the resumed epoch")
    del state
    records = [json.loads(x) for x in (logdir / "metrics.jsonl").open()]
    if [r["step"] for r in records] != list(range(1, steps + 1)):
        raise AssertionError(f"metrics.jsonl steps {[r['step'] for r in records]}")
    loss_keys = [k for k in records[0] if "loss" in k]
    if not all(np.isfinite(r[k]) for r in records for k in loss_keys):
        raise AssertionError("non-finite training loss in metrics.jsonl")
    eval_line = [x for x in log3 if x.startswith("eval losses over ")]
    eval_means = (ast.literal_eval(eval_line[0].split(": ", 1)[1])
                  if eval_line else {})
    if not (eval_means and all(np.isfinite(v) for v in eval_means.values())):
        raise AssertionError(f"eval losses: {eval_line}")
    scenes_dir = logdir / "scenes"
    scores = {}
    names = [f"scene{s:04d}_00" for s in range(CLI_SCENES)]
    for name in names:
        with np.load(scenes_dir / f"{name}.npz") as z:
            if not (np.isfinite(z["tsdf"]).all() and (np.abs(z["tsdf"]) < 1).any()):
                raise AssertionError(f"scene {name}: no finite surface")
        mfile = scenes_dir / f"{name}_metrics.json"
        if not mfile.is_file():
            raise AssertionError(f"scene {name}: not scored")
        scores[name] = json.loads(mfile.read_text())
        depth_keys = ("AbsRel", "RMSE", "fscore")
        if not all(np.isfinite(scores[name].get(k, np.nan)) for k in depth_keys):
            raise AssertionError(f"scene {name}: depth metrics "
                                 f"{ {k: scores[name].get(k) for k in depth_keys} }")
    if sorted(r.name for r in results) != names:
        raise AssertionError(f"run_test returned {[r.name for r in results]}")
    if not (len(render_ms) == CLI_SCENES * CLI_DEPTH_FRAMES
            and len(trim_s) == CLI_SCENES):
        raise AssertionError(f"depth protocol rendered {len(render_ms)} frames "
                             f"and trimmed {len(trim_s)} scenes")

    # numbers
    step_ms = [r["step_ms"] for r in records]
    sample_ms = [r["sample_ms"] for r in records]
    after_first = lambda xs, epoch: [x for i, x in enumerate(xs)
                                     if i % CLI_TRAIN_STEPS
                                     and i // CLI_TRAIN_STEPS == epoch]
    epochs = [float(re.search(r"\(([0-9.]+)s\)$", x).group(1))
              for x in log1 + log2 if x.startswith("epoch ")]
    frag_ms = [float(re.search(r": ([0-9.]+) ms", x).group(1))
               for x in log3 if x.startswith("fragment ")]
    summary = re.search(r"\(([0-9.]+) keyframes/s, p50 fragment ([0-9.]+) ms\)",
                        "\n".join(x for x in log3 if "keyframes/s" in x))
    train_ds = cli.build_dataset(load_config(
        str(REPO / "config/train.yaml"), parse_cli_overrides(common)), "train")
    stages = time_sample_stages(train_ds, range(len(train_ds)))
    pf = prefetch.FragmentPrefetcher(train_ds, n_threads=CLI_TRAIN_WORKERS)
    try:
        prefetch_stages = time_sample_stages(train_ds, range(len(train_ds)), pf)
    finally:
        pf.close()
    del train_ds, results
    wall = time.perf_counter() - t_phase
    median = lambda xs: float(np.median(xs))
    res = dict(
        train_step_ms=step_ms, train_sample_ms=sample_ms,
        prefetch_steady_step_ms=median(after_first(step_ms, 0)),
        prefetch_steady_sample_ms=median(after_first(sample_ms, 0)),
        sync_steady_step_ms=median(after_first(step_ms, 1)),
        sync_steady_sample_ms=median(after_first(sample_ms, 1)),
        epoch_s=epochs, test_fragment_ms=frag_ms,
        test_keyframes_per_s=float(summary.group(1)),
        test_p50_fragment_ms=float(summary.group(2)),
        sample_stage_ms=stages, prefetch_sample_stage_ms=prefetch_stages,
        eval_loss_means=eval_means, scores=scores,
        render_ms=render_ms, trim_s=trim_s, loader=loader, tree=tree,
        peak_gib=peak, wall_s=wall,
        run_s=dict(train=train1_s, resume=train2_s, test=test_s),
        reduced=CLI_REDUCED, color_hw=list(CLI_COLOR_HW))
    print(f"[cli] train through train_epochs: step ms {[round(x, 1) for x in step_ms]}; "
          f"steady (median of the steps after the epoch's first): epoch 0 "
          f"with the prefetcher ({CLI_TRAIN_WORKERS} threads) "
          f"{res['prefetch_steady_step_ms']:.1f} ms, of it sample "
          f"{res['prefetch_steady_sample_ms']:.1f} ms; resumed epoch 1 "
          f"synchronous {res['sync_steady_step_ms']:.1f} ms, of it sample "
          f"{res['sync_steady_sample_ms']:.1f} ms; epochs {epochs} s | {card}",
          flush=True)
    print(f"[cli] host ms per sample (median, card synchronised per stage), "
          f"synchronous: { {k: round(v, 1) for k, v in stages.items()} }; "
          f"through the prefetcher ({CLI_TRAIN_WORKERS} threads): "
          f"{ {k: round(v, 1) for k, v in prefetch_stages.items()} } | {card}",
          flush=True)
    print(f"[cli] test: fragment ms {[round(x, 1) for x in frag_ms]}, "
          f"{res['test_keyframes_per_s']} keyframes/s, p50 "
          f"{res['test_p50_fragment_ms']} ms; eval losses {eval_means} | {card}",
          flush=True)
    print(f"[depth-eval] {len(render_ms)} frames rendered at "
          f"{CLI_DEPTH_HW[1]}x{CLI_DEPTH_HW[0]} (192 steps): median "
          f"{median(render_ms):.1f} ms per frame (first {render_ms[0]:.1f}); "
          f"trim {[round(x, 2) for x in trim_s]} s per scene; "
          + "; ".join(f"{n} AbsRel={m['AbsRel']:.4f} RMSE={m['RMSE']:.4f} "
                      f"fscore={m['fscore']:.4f} PQ={m.get('PQ', float('nan')):.4f}"
                      for n, m in scores.items()) + f" | {card}", flush=True)
    print(f"[cli] peak memory {peak:.2f} GiB; phase wall {wall:.1f} s "
          f"(write {tree['write_s']:.1f}, GT "
          f"{sum(x['seconds'] for x in tree['gt'].values()):.1f}, train "
          f"{train1_s:.1f}, resume {train2_s:.1f}, test {test_s:.1f}) | {card}",
          flush=True)
    return res, launches, backward_launches


# --------------------------------------------------------------------------
# ddp phase: data-parallel training through the CLI under torchrun, one
# scene stream per rank, over the cli phase's tree
# --------------------------------------------------------------------------

DDP_GLOO_RANKS, DDP_GLOO_EPOCHS, DDP_NCCL_EPOCHS = 2, 2, 1
DDP_WORKERS = 4          # decode-ahead threads per rank (8 cores, 2 ranks)
DDP_LOSS_RTOL = 1e-3     # nccl with one card against the cli phase's step 1


def _params_digest(model) -> str:
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def ddp_rank(out_dir: Path, cli_args) -> int:
    """One rank of the ddp phase, started by torchrun: runs
    eprecon_tpu_torch.main.main(cli_args) with each Trainer.step counted
    (forward and backward launches, host ms with the card synchronised),
    each all-reduce timed (the card synchronised and the ranks' hosts met
    before it, so the wait for the slower rank is apart; the card
    synchronised after it; the collective itself, torch.distributed's
    all_reduce, timed apart from packing the flat buffer), torch.save and
    SummaryWriter recorded; prints one JSON line and writes it to
    <out_dir>/rank<r>.json."""
    import torch

    sys.path.insert(0, str(REPO))
    from eprecon_tpu_torch import main as cli
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.parallel import mesh
    from eprecon_tpu_torch.train.state import Trainer
    from eprecon_tpu_torch.utils import logging as tlog

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    per_step, step_ms, saved, writers, digests = [], [], [], [], {}
    reduce_ms, wait_ms, collective_ms, buffer_mib = [], [], [], []
    init, step, reduce_ = Trainer.__init__, Trainer.step, mesh.all_reduce_mean
    collective = mesh.dist.all_reduce
    save, writer_cls = torch.save, tlog.SummaryWriter

    def init_recorded(self, *a, **kw):
        init(self, *a, **kw)
        digests["initial"] = _params_digest(self.model)

    def step_recorded(self, *a, **kw):
        torch.cuda.synchronize()
        before = (bp.total_launches(), bp.total_backward_launches())
        t0 = time.perf_counter()
        out = step(self, *a, **kw)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        per_step.append((bp.total_launches() - before[0],
                         bp.total_backward_launches() - before[1]))
        return out

    def collective_recorded(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = collective(*a, **kw)
        torch.cuda.synchronize()
        collective_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    def reduce_recorded(tensors):
        # the wait for the other ranks apart: card synchronised, hosts met;
        # the collective itself apart from packing the flat buffer
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.synchronize()
        t1 = time.perf_counter()
        mesh.dist.all_reduce = collective_recorded
        try:
            out = reduce_(tensors)
        finally:
            mesh.dist.all_reduce = collective
        torch.cuda.synchronize()
        buffer_mib.append(4 * sum(t.numel() for t in tensors) / 2 ** 20)
        wait_ms.append(1e3 * (t1 - t0))
        reduce_ms.append(1e3 * (time.perf_counter() - t1))
        return out

    def save_recorded(obj, f, *a, **kw):
        saved.append(str(f))
        return save(obj, f, *a, **kw)

    class CountedWriter(writer_cls):
        def __init__(self, *a, **kw):
            writers.append(rank)
            super().__init__(*a, **kw)

    Trainer.__init__, Trainer.step = init_recorded, step_recorded
    mesh.all_reduce_mean, torch.save = reduce_recorded, save_recorded
    tlog.SummaryWriter = CountedWriter
    bp.launch_counts.clear()
    bp.backward_launch_counts.clear()
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer = cli.main(cli_args)
    finally:
        Trainer.__init__, Trainer.step = init, step
        mesh.all_reduce_mean, torch.save = reduce_, save
        tlog.SummaryWriter = writer_cls
    res = dict(
        rank=rank, world=world, device=str(trainer.device), steps=per_step,
        step_ms=step_ms, all_reduce_ms=reduce_ms, wait_ms=wait_ms,
        collective_ms=collective_ms,
        buffer_mib=buffer_mib[0] if buffer_mib else None,
        peak_gib=torch.cuda.max_memory_allocated(trainer.device) / 2 ** 30,
        initial=digests["initial"], final=_params_digest(trainer.model),
        saved=saved, writers=len(writers),
        launches=[[*k, n] for k, n in bp.launch_counts.items()],
        backward_launches=[[*k, n] for k, n in bp.backward_launch_counts.items()])
    line = json.dumps(res)
    print(f"[ddp-rank] {line}", flush=True)
    (Path(out_dir) / f"rank{rank}.json").write_text(line)
    return 0


def _torchrun(nproc: int, out_dir: Path, args, tag: str):
    """torchrun --standalone --nproc_per_node nproc chip_smoke.py
    --ddp-rank out_dir ARGS; fails unless it exits 0. Returns the ranks'
    results and the launch's wall seconds."""
    out_dir.mkdir(parents=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(REPO / "chip_smoke.py"),
           "--ddp-rank", str(out_dir), *args]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"[ddp:{tag}] {line}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-6000:], file=sys.stderr, flush=True)
        raise AssertionError(f"torchrun ({tag}, {nproc} ranks) exited "
                             f"{proc.returncode}")
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(nproc)], wall


def _check_ranks(ranks, steps: int, logdir: Path, epochs: int, tag: str):
    """Every step of every rank launched 4 + 4 kernels; parameters equal
    across ranks and moved; rank 0 alone wrote the checkpoints and
    metrics.jsonl (one record per step, finite losses). Returns the
    records."""
    import numpy as np

    for r in ranks:
        if r["steps"] != [[4, 4]] * steps:
            raise AssertionError(f"{tag} rank {r['rank']}: steps launched "
                                 f"{r['steps']}, want [4, 4] x {steps}")
    if len({r["final"] for r in ranks}) != 1:
        raise AssertionError(f"{tag}: the ranks' parameters differ")
    if ranks[0]["final"] == ranks[0]["initial"]:
        raise AssertionError(f"{tag}: parameters did not move")
    want = [f"model_{e:06d}" for e in range(epochs)]
    if [Path(p).name.split(".")[0] for p in ranks[0]["saved"]] != want or any(
            r["saved"] for r in ranks[1:]):
        raise AssertionError(f"{tag}: checkpoints written "
                             f"{[r['saved'] for r in ranks]}")
    if [r["writers"] for r in ranks] != [1] + [0] * (len(ranks) - 1):
        raise AssertionError(f"{tag}: summary writers "
                             f"{[r['writers'] for r in ranks]}")
    if sorted(p.name for p in logdir.glob("model_*")) != want:
        raise AssertionError(f"{tag}: checkpoints {sorted(logdir.glob('model_*'))}")
    records = [json.loads(x) for x in (logdir / "metrics.jsonl").open()]
    if [x["step"] for x in records] != list(range(1, steps + 1)):
        raise AssertionError(f"{tag}: metrics.jsonl steps "
                             f"{[x['step'] for x in records]}")
    if not all(np.isfinite(x[k]) for x in records for k in x if "loss" in k):
        raise AssertionError(f"{tag}: non-finite loss in metrics.jsonl")
    return records


def _steady(xs):
    """Median of the steps after a process's first (its warm-up)."""
    import numpy as np

    return float(np.median(xs[1:])) if len(xs) > 1 else None


def _ddp_lines(ranks, tag: str, wall: float, card):
    for r in ranks:
        reduce_ = (f"all-reduce of {r['buffer_mib']:.1f} MiB, ms per step "
                   f"{_steady(r['all_reduce_ms']):.1f} (first "
                   f"{r['all_reduce_ms'][0]:.1f}), of it the collective "
                   f"{_steady(r['collective_ms']):.1f}; wait for the other "
                   f"ranks {_steady(r['wait_ms']):.1f}"
                   if r["all_reduce_ms"] else "no all-reduce (one rank)")
        print(f"[ddp] {tag} rank {r['rank']}/{r['world']} on {r['device']}: "
              f"{len(r['steps'])} steps, step ms {_steady(r['step_ms']):.1f} "
              f"(first {r['step_ms'][0]:.1f}); {reduce_} (medians after the "
              f"first step); peak {r['peak_gib']:.2f} GiB | {card}", flush=True)
    print(f"[ddp] {tag}: torchrun wall {wall:.1f} s | {card}", flush=True)


def ddp_phase(root: Path, card, cli_metrics: Optional[Path] = None):
    """(a) two gloo ranks (sharing the card where there is one), (b) nccl
    with one rank per card, both through the CLI under torchrun over the
    cli phase's tree and reductions; with one card, (b)'s first step is
    held against the cli phase's (`cli_metrics`, its metrics.jsonl).
    Returns (results, forward and backward launches summed over the ranks
    by kernel key)."""
    import collections
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[ddp] free device memory before the launches {free / 2 ** 30:.2f} "
          f"of {total / 2 ** 30:.2f} GiB | {card}", flush=True)
    t_phase = time.perf_counter()
    common = ["--cfg", "config/train.yaml", "train.path", str(root),
              "summary_freq", "1", "train.n_workers", str(DDP_WORKERS),
              *CLI_REDUCED]
    steps_gloo = DDP_GLOO_EPOCHS * CLI_TRAIN_STEPS // DDP_GLOO_RANKS
    gloo, gloo_wall = _torchrun(
        DDP_GLOO_RANKS, root / "ddp_gloo", ["--dist-backend", "gloo", *common,
                                            "logdir", str(root / "ddp_gloo" / "run"),
                                            "train.epochs", str(DDP_GLOO_EPOCHS)],
        "gloo")
    _check_ranks(gloo, steps_gloo, root / "ddp_gloo" / "run", DDP_GLOO_EPOCHS,
                 "gloo")
    _ddp_lines(gloo, f"gloo, {DDP_GLOO_RANKS} ranks", gloo_wall, card)

    cards = torch.cuda.device_count()
    per_rank = CLI_TRAIN_STEPS // cards if cards > 1 else CLI_TRAIN_STEPS
    accumulation = int(CLI_REDUCED[CLI_REDUCED.index(
        "train.accumulation_steps") + 1])
    # enough epochs for one optimizer update on every rank
    epochs_nccl = max(DDP_NCCL_EPOCHS, -(-accumulation // per_rank))
    nccl, nccl_wall = _torchrun(
        cards, root / "ddp_nccl", ["--dist-backend", "nccl", *common,
                                   "logdir", str(root / "ddp_nccl" / "run"),
                                   "train.epochs", str(epochs_nccl)],
        "nccl")
    records = _check_ranks(nccl, epochs_nccl * per_rank,
                           root / "ddp_nccl" / "run", epochs_nccl, "nccl")
    first_rel = None
    if cards == 1 and cli_metrics is not None:
        # one rank is one stream: its first step is the cli phase's
        with open(cli_metrics) as f:
            want = json.loads(f.readline())
        got = records[0]
        first_rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
                     for k in want if "loss" in k}
        if not all(x <= DDP_LOSS_RTOL for x in first_rel.values()):
            raise AssertionError(f"nccl first step against the cli phase's: "
                                 f"relative differences {first_rel}")
        print(f"[ddp] nccl, one card: first step's loss terms against the cli "
              f"phase's step 1, largest relative difference "
              f"{max(first_rel.values()):.3g} | {card}", flush=True)
    _ddp_lines(nccl, f"nccl, {cards} rank(s), one per card", nccl_wall, card)

    fwd, bwd = collections.Counter(), collections.Counter()
    for r in gloo + nccl:
        for *key, n in r["launches"]:
            fwd[tuple(key)] += n
        for *key, n in r["backward_launches"]:
            bwd[tuple(key)] += n
    wall = time.perf_counter() - t_phase
    print(f"[ddp] phase wall {wall:.1f} s | {card}", flush=True)
    summary = lambda rs: dict(  # noqa: E731
        ranks=rs, step_ms=[_steady(r["step_ms"]) for r in rs],
        all_reduce_ms=[_steady(r["all_reduce_ms"]) for r in rs],
        collective_ms=[_steady(r["collective_ms"]) for r in rs],
        peak_gib=[r["peak_gib"] for r in rs])
    res = dict(free_gib_before=free / 2 ** 30, wall_s=wall,
               gloo=dict(summary(gloo), wall_s=gloo_wall),
               nccl=dict(summary(nccl), wall_s=nccl_wall, cards=cards,
                         first_step_rel_diff=first_rel))
    return res, dict(fwd), dict(bwd)


# --------------------------------------------------------------------------
# raw-scan writers: the formats of a ScanNet download (.sens, the binary
# _vh_clean_2.ply, the segs and aggregation json, the label tsv) and the
# torchvision MNASNet schema, written from the port's synthetic tree for
# the import phase (tests/torch_parity.py uses them too; the port itself
# only reads these formats)
# --------------------------------------------------------------------------

# the synthetic scenes' nyu40 classes (data/synthetic.py) by raw category
SYNTHETIC_CATEGORIES = {1: "wall", 2: "floor", 4: "bed", 5: "chair",
                        6: "sofa", 7: "table"}


def write_sens(path, colors, depths, poses, intrinsic_color, intrinsic_depth,
               color_hw, depth_shift=1000.0):
    """A ScanNet SensorData file (version 4, little-endian): `colors` the
    frames' JPEG bytes, `depths` [H, W] u16 (stored zlib-compressed),
    `poses` 4x4 camera-to-world, the intrinsics 4x4; both extrinsics
    identity."""
    import struct
    import zlib

    import numpy as np

    dh, dw = depths[0].shape
    eye = np.eye(4)
    with open(path, "wb") as f:
        name = b"StructureSensor"
        f.write(struct.pack("<IQ", 4, len(name)) + name)
        for m in (intrinsic_color, eye, intrinsic_depth, eye):
            f.write(np.asarray(m, "<f4").tobytes())
        f.write(struct.pack("<iiIIIIfQ", 2, 1, color_hw[1], color_hw[0], dw,
                            dh, depth_shift, len(colors)))
        for i, (color, depth, pose) in enumerate(zip(colors, depths, poses)):
            packed = zlib.compress(np.ascontiguousarray(depth, "<u2").tobytes())
            f.write(np.asarray(pose, "<f4").tobytes())
            f.write(struct.pack("<QQQQ", i, i, len(color), len(packed)))
            f.write(color)
            f.write(packed)


def pack_scene_sens(scene_dir: Path, path: Path):
    """Pack a scene of a ScanNet-layout tree (color/N.jpg, depth/N.png,
    pose/N.txt, intrinsic/*.txt) into a .sens file: the JPEG bytes as they
    are, depth as u16 millimetres. Returns the number of frames."""
    import numpy as np
    from eprecon_tpu_torch.data import native_loader as nl

    n = len(list((scene_dir / "color").glob("*.jpg")))
    colors = [(scene_dir / "color" / f"{i}.jpg").read_bytes() for i in range(n)]
    depths = [np.round(nl.decode_png_depth(str(scene_dir / "depth" / f"{i}.png"))
                       * 1000.0).astype(np.uint16) for i in range(n)]
    poses = [np.loadtxt(scene_dir / "pose" / f"{i}.txt") for i in range(n)]
    intr = {k: np.loadtxt(scene_dir / "intrinsic" / f"intrinsic_{k}.txt")
            for k in ("color", "depth")}
    color_hw = nl.jpeg_size(str(scene_dir / "color" / "0.jpg"))
    write_sens(path, colors, depths, poses, intr["color"], intr["depth"],
               color_hw)
    return n


def write_ply_binary(path, verts):
    """A binary little-endian PLY with ScanNet's vertex properties (x, y, z
    float; red, green, blue, alpha uchar) and no faces."""
    import numpy as np

    rows = np.zeros(len(verts), [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                 ("red", "u1"), ("green", "u1"),
                                 ("blue", "u1"), ("alpha", "u1")])
    for i, axis in enumerate("xyz"):
        rows[axis] = np.asarray(verts)[:, i]
    rows["alpha"] = 255
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "property uchar alpha\nelement face 0\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii") + rows.tobytes())


def write_scannet_annotations(scene_dir: Path, scene: str, verts, semantic,
                              instance, categories=SYNTHETIC_CATEGORIES):
    """ScanNet's annotation files for labeled vertices: the mesh
    <scene>_vh_clean_2.ply (vertices only), an over-segmentation with one
    segment per instance id, and an aggregation with one group per
    instance, labeled with its class's raw category."""
    import numpy as np

    semantic, instance = np.asarray(semantic), np.asarray(instance)
    write_ply_binary(scene_dir / f"{scene}_vh_clean_2.ply", verts)
    (scene_dir / f"{scene}_vh_clean_2.0.010000.segs.json").write_text(json.dumps(
        {"sceneId": scene, "segIndices": instance.tolist()}))
    groups = []
    for k, iid in enumerate(sorted(set(instance.tolist()) - {0})):
        cls = int(np.bincount(semantic[instance == iid]).argmax())
        groups.append({"id": k, "objectId": k, "segments": [iid],
                       "label": categories[cls]})
    (scene_dir / f"{scene}.aggregation.json").write_text(json.dumps(
        {"sceneId": scene, "segGroups": groups}))


def write_label_tsv(path: Path, categories=SYNTHETIC_CATEGORIES):
    """scannetv2-labels.combined.tsv's columns, one row per category."""
    rows = ["id\traw_category\tcategory\tcount\tnyu40id\tnyu40class"]
    rows += [f"{i}\t{name}\t{name}\t1\t{nyu}\t{name}"
             for i, (nyu, name) in enumerate(sorted(categories.items()), 1)]
    path.write_text("\n".join(rows) + "\n")


def scannet_renumbered(semantic, instance):
    """The instance ids load_scannet_labels.export gives labeled vertices:
    wall 1, floor 2, things from 3 in the order of their original ids."""
    import numpy as np

    semantic, instance = np.asarray(semantic), np.asarray(instance)
    out = np.zeros_like(instance)
    things = 3
    for iid in sorted(set(instance.tolist()) - {0}):
        cls = int(np.bincount(semantic[instance == iid]).argmax())
        out[instance == iid] = cls if cls in (1, 2) else things
        things += cls not in (1, 2)
    return out


def mnasnet1_0_schema():
    """(key, shape) of every tensor of torchvision's mnasnet1_0 state_dict
    (models/mnasnet.py at alpha 1.0: depths 32, 16, then six stacks, the
    1280-wide head and the 1000-way classifier)."""
    keys = []

    def conv(name, shape):
        keys.append((f"{name}.weight", shape))

    def bn(name, c):
        keys.extend([(f"{name}.weight", (c,)), (f"{name}.bias", (c,)),
                     (f"{name}.running_mean", (c,)),
                     (f"{name}.running_var", (c,)),
                     (f"{name}.num_batches_tracked", ())])

    conv("layers.0", (32, 3, 3, 3))
    bn("layers.1", 32)
    conv("layers.3", (32, 1, 3, 3))
    bn("layers.4", 32)
    conv("layers.6", (16, 32, 1, 1))
    bn("layers.7", 16)
    stacks = [(16, 24, 3, 3, 3), (24, 40, 5, 3, 3), (40, 80, 5, 6, 3),
              (80, 96, 3, 6, 2), (96, 192, 5, 6, 4), (192, 320, 3, 6, 1)]
    for layer, (ci, co, k, e, reps) in enumerate(stacks, 8):
        for b in range(reps):
            cin = ci if b == 0 else co
            base = f"layers.{layer}.{b}.layers"
            conv(f"{base}.0", (cin * e, cin, 1, 1))
            bn(f"{base}.1", cin * e)
            conv(f"{base}.3", (cin * e, 1, k, k))
            bn(f"{base}.4", cin * e)
            conv(f"{base}.6", (co, cin * e, 1, 1))
            bn(f"{base}.7", co)
    conv("layers.14", (1280, 320, 1, 1))
    bn("layers.15", 1280)
    keys.extend([("classifier.1.weight", (1000, 1280)),
                 ("classifier.1.bias", (1000,))])
    return keys


def random_mnasnet_state_dict(seed: int):
    """A torchvision mnasnet1_0 state_dict of random values from `seed`
    (running variances in [0.5, 1.5], batch counters 0)."""
    from collections import OrderedDict

    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sd = OrderedDict()
    for key, shape in mnasnet1_0_schema():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros(shape, dtype=torch.int64)
        elif key.endswith("running_var"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        else:
            sd[key] = torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))
    return sd


def write_reference_checkpoint(path: Path, sd, epoch: int = 0):
    """`sd` (numpy) in the reference's save format (reference main.py:
    343-348): {"epoch", "model" with DDP's 'module.' prefixes,
    "optimizer": an Adam state_dict}."""
    from collections import OrderedDict

    import torch

    model = OrderedDict(("module." + k, torch.from_numpy(v)) for k, v in sd.items())
    optimizer = {"state": {}, "param_groups": [dict(
        lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
        amsgrad=False, params=list(range(len(model))))]}
    torch.save({"epoch": epoch, "model": model, "optimizer": optimizer}, path)


# --------------------------------------------------------------------------
# import phase: upstream artifacts into the port, then served on the card
# --------------------------------------------------------------------------

IMPORT_LAYOUT = {"ts_odd": "zfast"}   # recorded layout: not the default
IMPORT_SCENE = "scene0000_00"


def _import_checkpoint(work: Path, card):
    """A reference-format checkpoint with a fingerprint recorded under a
    non-default layout, imported by the importer's CLI in a subprocess:
    the layout is auto-flipped, more than 900 tensors convert, every
    tensor of EPRecon at the default config is covered, the file equals the
    in-process conversion under that layout and loads through
    restore_model bit for bit."""
    import os
    import subprocess

    import torch
    from eprecon_tpu_torch.config import default_config
    from eprecon_tpu_torch.models.eprecon import EPRecon
    from eprecon_tpu_torch.tools import fingerprint as fp
    from eprecon_tpu_torch.tools import import_reference_weights as irw
    from eprecon_tpu_torch.train.checkpoint import restore_model

    sd = irw.random_state_dict(irw.all_entries()[0], seed=1)
    ref_ckpt, fp_json, out = (work / "model_000099.ckpt", work / "fingerprint.json",
                              work / "imported.pt")
    write_reference_checkpoint(ref_ckpt, sd, epoch=99)
    layout = dict(fp.DEFAULT_LAYOUT, **IMPORT_LAYOUT)
    t0 = time.perf_counter()
    fp.save_fingerprint(fp.fingerprint_state_dict(sd, layout), str(fp_json))
    record_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "eprecon_tpu_torch.tools.import_reference_weights",
         "--torch_ckpt", str(ref_ckpt), "--fingerprint", str(fp_json),
         "--out", str(out)], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(REPO)))
    import_s = time.perf_counter() - t0
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"import_reference_weights exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    name = fp.layout_name(layout)
    if f"auto-flipped to {name}" not in proc.stdout:
        raise AssertionError(f"the importer did not report the flip to {name}")
    verified = re.search(r"verified under layout (\S+) in ([0-9.]+) s", proc.stdout)
    wrote = re.search(r": (\d+) tensors \(converted in ([0-9.]+) s\)", proc.stdout)
    if not (verified and wrote and verified.group(1) == name):
        raise AssertionError(f"importer output: {proc.stdout[-1000:]}")
    saved = torch.load(out, map_location="cpu", weights_only=True)["model"]
    if not len(saved) > 900:
        raise AssertionError(f"{len(saved)} tensors converted")
    model = EPRecon(default_config().model)
    if set(saved) != set(model.state_dict()):
        raise AssertionError(f"imported names differ from EPRecon's: "
                             f"{sorted(set(saved) ^ set(model.state_dict()))[:8]}")
    want = irw.convert_reference_state_dict(sd, transforms=fp.transforms_for(layout))
    if not all(torch.equal(saved[k], v) for k, v in want.items()):
        raise AssertionError("imported tensors differ from the in-process "
                             f"conversion under {name}")
    model = restore_model(str(out), model.cuda())
    state = model.state_dict()
    if not all(torch.equal(state[k].cpu(), v) for k, v in saved.items()):
        raise AssertionError("restore_model did not load the import bit for bit")
    res = dict(tensors=len(saved), layout=name, import_s=import_s,
               convert_s=float(wrote.group(2)),
               fingerprint_s=float(verified.group(2)), record_s=record_s)
    print(f"[import] reference checkpoint ({len(sd)} tensors, fingerprint "
          f"recorded under {name} in {record_s:.3f} s): {len(saved)} port "
          f"tensors converted, layout auto-flipped to {name}; import "
          f"subprocess {import_s:.2f} s (conversion {res['convert_s']:.3f} s, "
          f"fingerprint check {res['fingerprint_s']:.3f} s); restore_model bit "
          f"for bit | {card}", flush=True)
    return res, out, model


def _warm_start_backbones(work: Path, model, card):
    """A torchvision-mnasnet1_0-schema state_dict through
    import_backbone_weights, then both backbones warm-started by
    restore_submodule: exactly their trunk tensors change, to the
    converted values."""
    import torch
    from eprecon_tpu_torch.tools import import_backbone_weights as ibw
    from eprecon_tpu_torch.train.checkpoint import restore_submodule

    src, out = work / "mnasnet1_0.pth", work / "backbone.pt"
    torch.save(random_mnasnet_state_dict(seed=2), src)
    t0 = time.perf_counter()
    converted = ibw.main(["--torch_ckpt", str(src), "--out", str(out)])
    convert_s = time.perf_counter() - t0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for name in ibw.BACKBONES:
        restore_submodule(str(out), model, name)
    after = model.state_dict()
    changed = {k for k, v in after.items() if not torch.equal(v, before[k])}
    want = {f"{b}.{k}" for b in ibw.BACKBONES for k in converted}
    if changed != want:
        raise AssertionError(f"warm start changed {len(changed)} tensors, want "
                             f"the {len(want)} trunk tensors: "
                             f"{sorted(changed ^ want)[:8]}")
    for b in ibw.BACKBONES:
        if not all(torch.equal(after[f"{b}.{k}"].cpu(), v) for k, v in converted.items()):
            raise AssertionError(f"{b}: warm-started tensors differ from the import")
    print(f"[import] torchvision mnasnet1_0 schema: {len(converted)} trunk tensors "
          f"per backbone in {convert_s:.2f} s; restore_submodule warm-started "
          f"{', '.join(ibw.BACKBONES)}, {len(changed)} tensors changed, no other "
          f"| {card}", flush=True)
    return dict(trunk_tensors=len(converted), changed=len(changed),
                convert_s=convert_s)


def _ingest_scan(root: Path, work: Path, card):
    """Pack scene 0 of the cli tree as a raw ScanNet scan (.sens, mesh,
    segs, aggregation, label tsv), then extract it, export its labels and
    generate its GT on the card into a fresh tree; the tree must give back
    the color bytes, the decoded depth, the poses (at the .sens format's
    f32) and intrinsics, and the labels up to ScanNet's renumbering."""
    import numpy as np
    from eprecon_tpu_torch.data import native_loader as nl
    from eprecon_tpu_torch.tools import load_scannet_labels, sens_reader

    src, raw, tree = root / "scans" / IMPORT_SCENE, work / "raw", work / "tree"
    scan = raw / IMPORT_SCENE
    scan.mkdir(parents=True)
    frames = pack_scene_sens(src, scan / f"{IMPORT_SCENE}.sens")
    labels = {k: np.load(root / "labels" / f"{IMPORT_SCENE}_{k}.npy")
              for k in ("vert", "sem_label", "ins_label")}
    write_scannet_annotations(scan, IMPORT_SCENE, labels["vert"][:, :3],
                              labels["sem_label"], labels["ins_label"])
    write_label_tsv(raw / "scannetv2-labels.combined.tsv")

    out = tree / "scans" / IMPORT_SCENE
    t0 = time.perf_counter()
    written = sens_reader.extract(str(scan / f"{IMPORT_SCENE}.sens"), str(out))
    extract_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_scannet_labels.main(["--scannet_path", str(raw), "--label_map_file",
                              str(raw / "scannetv2-labels.combined.tsv"),
                              "--output_folder", str(tree / "labels")])
    labels_s = time.perf_counter() - t0
    if written != frames:
        raise AssertionError(f"extracted {written} of {frames} frames")
    for i in range(frames):
        if (out / "color" / f"{i}.jpg").read_bytes() != (src / "color" / f"{i}.jpg").read_bytes():
            raise AssertionError(f"frame {i}: color bytes differ")
        got, want = (nl.decode_png_depth(str(d / "depth" / f"{i}.png")) for d in (out, src))
        if not np.array_equal(got, want):
            raise AssertionError(f"frame {i}: decoded depth differs")
        if not np.array_equal(np.loadtxt(out / "pose" / f"{i}.txt"),
                              np.loadtxt(src / "pose" / f"{i}.txt").astype(np.float32)):
            raise AssertionError(f"frame {i}: pose differs")
    for k in ("color", "depth"):
        name = f"intrinsic/intrinsic_{k}.txt"
        if not np.array_equal(np.loadtxt(out / name), np.loadtxt(src / name)):
            raise AssertionError(f"{name} differs")
    got = {k: np.load(tree / "labels" / f"{IMPORT_SCENE}_{k}.npy")
           for k in ("vert", "sem_label", "ins_label")}
    if not (np.array_equal(got["vert"], labels["vert"])
            and np.array_equal(got["sem_label"], labels["sem_label"])
            and np.array_equal(got["ins_label"], scannet_renumbered(
                labels["sem_label"], labels["ins_label"]))):
        raise AssertionError("exported labels differ from the originals")

    gt, _, gt_s = generate_gt_on_card(tree / "scans", tree / "labels")
    with np.load(gt / IMPORT_SCENE / "full_tsdf_layer0.npz") as z:
        shape = z["arr_0"].shape
    (tree / "scans_test").symlink_to(tree / "scans")
    res = dict(frames=frames, extract_s=extract_s, labels_s=labels_s, gt_s=gt_s,
               voxels=int(np.prod(shape)), shape=list(shape),
               label_points=len(labels["vert"]))
    print(f"[ingest] {IMPORT_SCENE}.sens ({frames} frames, color "
          f"{'x'.join(map(str, nl.jpeg_size(str(src / 'color' / '0.jpg'))[::-1]))} "
          f"jpeg, depth zlib u16): extract {extract_s:.2f} s, label export "
          f"({len(labels['vert'])} vertices) {labels_s:.2f} s, GT on cuda "
          f"{gt_s:.2f} s, {res['voxels']} voxels {list(shape)}; color bytes, "
          f"depth, poses and labels as packed | {card}", flush=True)
    return res, tree


def _serve_imported(tree: Path, work: Path, ckpt: Path, card):
    """config/test.yaml over the ingested tree from the imported checkpoint
    (the cli phase's reductions), in this process: 4 forward launches per
    fragment, the scene saved with a finite surface and scored, and its
    labels exported onto the scan's mesh. Returns (results, launches)."""
    import numpy as np
    import torch
    from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.tools import generate_semantic_instance as gsi
    from eprecon_tpu_torch.tools.ply_io import read_ply_vertices

    logdir = work / "run"
    per_frag, process = [], StreamingReconstructor.process_fragment

    def counted(*a, **kw):
        before = bp.total_launches()
        out = process(*a, **kw)
        per_frag.append(bp.total_launches() - before)
        return out

    StreamingReconstructor.process_fragment = counted
    bp.launch_counts.clear()
    try:
        t0 = time.perf_counter()
        results, log = _run_cli(["--cfg", "config/test.yaml", "test.path", str(tree),
                                 "logdir", str(logdir), *CLI_REDUCED, "loadckpt",
                                 str(ckpt), "test.n_workers", str(CLI_TEST_WORKERS)])
        test_s = time.perf_counter() - t0
    finally:
        StreamingReconstructor.process_fragment = process
    launches = dict(bp.launch_counts)
    if per_frag != [4] * CLI_FRAGMENTS:
        raise AssertionError(f"fragments launched {per_frag}, want 4 x {CLI_FRAGMENTS}")
    scenes = logdir / "scenes"
    with np.load(scenes / f"{IMPORT_SCENE}.npz") as z:
        if not (np.isfinite(z["tsdf"]).all() and (np.abs(z["tsdf"]) < 1).any()):
            raise AssertionError("served scene: no finite surface")
    if not (scenes / f"{IMPORT_SCENE}_metrics.json").is_file():
        raise AssertionError("served scene: not scored")
    score = json.loads((scenes / f"{IMPORT_SCENE}_metrics.json").read_text())
    verts = read_ply_vertices(str(work / "raw" / IMPORT_SCENE / f"{IMPORT_SCENE}_vh_clean_2.ply"))
    t0 = time.perf_counter()
    gsi.export_scene(str(scenes / f"{IMPORT_SCENE}.npz"), verts, str(work / "benchmark"))
    export_s = time.perf_counter() - t0
    per_vertex = np.loadtxt(work / "benchmark" / "semantic" / f"{IMPORT_SCENE}.txt")
    if per_vertex.shape != (len(verts),):
        raise AssertionError(f"benchmark export: {per_vertex.shape} labels for "
                             f"{len(verts)} vertices")
    frag_ms = [float(re.search(r": ([0-9.]+) ms", x).group(1))
               for x in log if x.startswith("fragment ")]
    summary = re.search(r"\(([0-9.]+) keyframes/s, p50 fragment ([0-9.]+) ms\)",
                        "\n".join(x for x in log if "keyframes/s" in x))
    res = dict(fragment_ms=frag_ms, keyframes_per_s=float(summary.group(1)),
               p50_fragment_ms=float(summary.group(2)), test_s=test_s,
               export_s=export_s, score=score, launches_per_fragment=per_frag,
               scenes=[r.name for r in results])
    print(f"[serve-imported] {IMPORT_SCENE} from the imported checkpoint: fragment "
          f"ms {[round(x, 1) for x in frag_ms]}, p50 {res['p50_fragment_ms']} ms, "
          f"{res['keyframes_per_s']} keyframes/s; run_test {test_s:.1f} s; "
          f"fscore {score.get('fscore', float('nan')):.4f}; benchmark export of "
          f"{len(verts)} vertices {export_s:.2f} s | {card}", flush=True)
    return res, launches


def import_phase(root: Path, card):
    """Upstream artifacts into the port, then served on the card: a
    reference-format checkpoint with a fingerprint (auto-flipped layout),
    a torchvision backbone warm start, a raw ScanNet scan packed from the
    cli tree's scene 0 and ingested, and the ingested scene served by the
    test CLI from the imported checkpoint. Returns (results, launches of
    the serving run)."""
    import gc

    import torch

    t_phase = time.perf_counter()
    work = root / "import"
    work.mkdir()
    imported, ckpt, model = _import_checkpoint(work, card)
    backbones = _warm_start_backbones(work, model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ingest, tree = _ingest_scan(root, work, card)
    served, launches = _serve_imported(tree, work, ckpt, card)
    wall = time.perf_counter() - t_phase
    print(f"[import] phase wall {wall:.1f} s | {card}", flush=True)
    return dict(imported=imported, backbones=backbones, ingest=ingest,
                served=served, wall_s=wall), launches


def serve_artifact(artifact: Path, requests: Path, results: Path) -> int:
    """`chip_smoke.py --serve-artifact ARTIFACT REQUESTS RESULTS`: serve
    fragments from an exported fragment program in a process that loads no
    model code (`eprecon_tpu_torch.models` is refused by a meta-path
    blocker, JAX too): the artifact onto the requests' device
    (inference/serving.py), the empty maps from its signature, the
    fragments in order (a `reset` starts a new scene's maps), the panoptic
    map kept where a fragment asks for a `snapshot`; then, with a `swap`
    state_dict, those weights loaded into the program and the first
    fragment served again on empty maps. With a `go` path, the serving
    waits, once the program is loaded, until that file exists (so that no
    other work of the caller's shares the host while it is timed). Writes
    the outputs, the kernel launches, the times and the peak memory to
    RESULTS (torch.save) and prints a JSON summary."""
    for name in ("jax", "jaxlib", "flax", "optax", "orbax", "eprecon_tpu"):
        sys.modules[name] = None

    class BlockModelCode:
        def find_spec(self, name, path=None, target=None):
            if name.startswith("eprecon_tpu_torch.models"):
                raise ImportError(f"{name}: the serving process loads no model code")

    sys.meta_path.insert(0, BlockModelCode())
    sys.path.insert(0, str(REPO))
    import torch
    from eprecon_tpu_torch.fragment_io import FragmentInputs
    from eprecon_tpu_torch.inference import serving
    from eprecon_tpu_torch.ops import back_project as bp

    req = torch.load(requests)
    dev = torch.device(req["device"])
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    ep = serving.load_serving_artifact(artifact, dev)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = ep.module()
    module_s = time.perf_counter() - t0
    if req.get("go") is not None:
        while not Path(req["go"]).exists():
            time.sleep(0.05)
    bp.launch_counts.clear()
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def run(frags, snapshots):
        outs, ms = [], []
        rec = pmap = None
        for f in frags:
            if f["reset"] or rec is None:
                rec, pmap = serving.initial_state(ep)
            frag = FragmentInputs(*(f[k].to(dev) for k in FragmentInputs._fields))
            sync()
            t = time.perf_counter()
            with torch.no_grad():
                out, _, rec, pmap = serve(f["imgs"].to(dev), frag, rec, pmap)
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
            outs.append({k: out[k].cpu() for k in ("tsdf_window", "pred_logits")})
            if f.get("snapshot") and snapshots is not None:
                snapshots.append({"instance": pmap.instance.cpu(),
                                  "semantic": pmap.semantic.cpu()})
        return outs, ms

    snapshots = []
    outs, ms = run(req["fragments"], snapshots)
    res = dict(load_s=load_s, module_s=module_s, ms=ms, outputs=outs,
               snapshots=snapshots,
               launches={str(k): n for k, n in bp.launch_counts.items()},
               peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if cuda else None),
               custom_ops=sorted(set(serving.custom_op_nodes(ep))),
               model_modules=sorted(m for m in sys.modules
                                    if m.startswith("eprecon_tpu_torch.models")))
    if req.get("swap") is not None:
        serve.load_state_dict(torch.load(req["swap"]))
        res["swap_outputs"], _ = run(req["fragments"][:1], None)
    torch.save(res, results)
    print(json.dumps({k: res[k] for k in ("load_s", "module_s", "ms",
                                          "launches", "peak_gib",
                                          "custom_ops", "model_modules")}),
          flush=True)
    return 0


def ddp_only() -> int:
    """`chip_smoke.py --ddp-phase`: the ddp phase alone over a fresh tree,
    for a machine of several cards (nccl across them); the cli phase's
    first step is not there to compare with."""
    import torch

    sys.path.insert(0, str(REPO))
    from eprecon_tpu_torch import kernels
    from eprecon_tpu_torch.tools.bench_back_project import card_line

    card = card_line()
    print(f"[card] {card} x {torch.cuda.device_count()}", flush=True)
    kernels.load("back_project")
    root = Path(tempfile.mkdtemp(prefix="eprecon_ddp_"))
    try:
        write_tree(root, card)
        res, fwd, bwd = ddp_phase(root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_ddp.json").write_text(json.dumps(dict(
        card=card, cards=torch.cuda.device_count(), ddp=res,
        launches=[[*k, n] for k, n in fwd.items()],
        backward_launches=[[*k, n] for k, n in bwd.items()]), indent=1))
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--serve-artifact"]:  # the export phase's server
        return serve_artifact(*map(Path, sys.argv[2:5]))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "eprecon_tpu_torch" / "csrc" / "back_project.cu").is_file():
        print("chip_smoke: run from a checkout of the repository "
              "(eprecon_tpu_torch/ not found)", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--quality-phase"]:  # the quality phase's process
        sys.path.insert(0, str(REPO))
        return quality_checks(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--ddp-rank"]:  # a rank of the ddp phase
        return ddp_rank(Path(sys.argv[2]), sys.argv[3:])
    if sys.argv[1:] == ["--ddp-phase"]:
        return ddp_only()
    sys.path.insert(0, str(REPO))
    from eprecon_tpu_torch import kernels
    from eprecon_tpu_torch.data.synthetic import make_fragment
    from eprecon_tpu_torch.tools.bench_back_project import card_line

    card = card_line()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    so = kernels.build("back_project")
    kernels.load("back_project")
    build_s = time.perf_counter() - t0
    print(f"[build] {so.name} in {build_s:.1f} s", flush=True)
    ptxas = ptxas_lines(so)
    for line in ptxas:
        print(f"[ptxas] {line}", flush=True)

    from eprecon_tpu_torch.tools import bench_back_project as bench

    frag = make_fragment(seed=0)
    v = frag["proj_matrices"].shape[0]
    case_list = bench.cases(frag["proj_matrices"], frag["vol_origin_partial"])
    kern = kernel_phase(case_list, v, card)
    kern_bwd = backward_phase(case_list, v, card)
    del case_list
    main_res, launches, served = main_path_phase(card)
    session_res, session_fwd = jax_session_phase(card, served)
    t0 = time.perf_counter()
    export_res, export_fwd = export_phase(card, served)
    t1 = time.perf_counter()
    spvcnn_res = spvcnn_phase(card, served)
    export_res["wall_s"], spvcnn_res["wall_s"] = t1 - t0, time.perf_counter() - t1
    print(f"[export] phase wall {t1 - t0:.1f} s; [spvcnn] phase wall "
          f"{spvcnn_res['wall_s']:.1f} s | {card}", flush=True)
    del served
    train_res, train_fwd, train_bwd = train_phase(card)
    quality_res = quality_phase(card)
    for k in kern:
        key = tuple(k["key"])
        k["launches"] = int(launches.get(key, 0))
        k["train_launches"] = int(train_fwd.get(key, 0))
        k["export_launches"] = int(export_fwd.get(key, 0))
        k["session_launches"] = int(session_fwd.get(key, 0))
        if k["launches"] == 0 or k["train_launches"] == 0:
            raise AssertionError(f"{k['name']}: not launched on the main path")
        if k["session_launches"] == 0:
            raise AssertionError(f"{k['name']}: not launched by the restored session")
        if k["export_launches"] == 0:
            raise AssertionError(f"{k['name']}: not launched by the artifact")
    for k in kern_bwd:
        k["launches"] = int(train_bwd.get(tuple(k["key"]), 0))
        if k["launches"] != TRAIN_STEPS:
            raise AssertionError(f"{k['name']}: {k['launches']} launches in "
                                 f"{TRAIN_STEPS} training steps")
    root = Path(tempfile.mkdtemp(prefix="eprecon_cli_"))
    try:
        cli_res, cli_fwd, cli_bwd = cli_phase(root, card)
        ddp_res, ddp_fwd, ddp_bwd = ddp_phase(root, card,
                                              root / "run" / "metrics.jsonl")
        import_res, import_fwd = import_phase(root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in kern:
        k["cli_launches"] = int(cli_fwd.get(tuple(k["key"]), 0))
        k["import_launches"] = int(import_fwd.get(tuple(k["key"]), 0))
        if k["import_launches"] == 0:
            raise AssertionError(f"{k['name']}: not launched serving the import")
    for k in kern_bwd:
        k["cli_launches"] = int(cli_bwd.get(tuple(k["key"]), 0))
    for ks, counts in ((kern, ddp_fwd), (kern_bwd, ddp_bwd)):
        for k in ks:
            k["ddp_launches"] = int(counts.get(tuple(k["key"]), 0))
    for k in kern + kern_bwd:
        k.pop("key")
        if k["cli_launches"] == 0:
            raise AssertionError(f"{k['name']}: not launched by the CLI")
        if k["ddp_launches"] == 0:
            raise AssertionError(f"{k['name']}: not launched by the ddp ranks")
    kern = kern + kern_bwd
    ref = reference_phase(card)
    ref["train"] = train_reference_phase(card)

    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, ptxas=ptxas, kernels=kern, main_path=main_res,
        jax_session=session_res, export=export_res, spvcnn=spvcnn_res, train=train_res, quality=quality_res, cli=cli_res, ddp=ddp_res, import_phase=import_res,
        reference=ref),
        indent=1))
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eprecon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

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
  3. the backward kernel at the same four shapes against the plain
     backward (f32 gradient of the tables, max abs error <= 1e-4 of its
     largest entry: f32 atomics sum in a changing order); tally its
     brick-views where its plan takes bricks (summed per pixel in shared
     memory and added once / scattered straight into the gradient / empty:
     the box path must run; shapes whose bricks cannot pay take the
     per-voxel kernel, which tallies nothing), check that the card holds
     as many CTAs per SM as its plan assumes (a brick plan cuts shared
     memory for them), and time it the same way (library_ms: autograd of
     the F.grid_sample yardstick);
  4. serve the main path: StreamingReconstructor at the default config
     (96^3 window at 4 cm, 9 views at 640x480, 80-query 6-layer decoder),
     random weights from a seed, 3 fragments of one scene then 1 of a
     second (scene flush); the kernel must launch 4 times per fragment;
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
  7. upstream artifacts (the import phase, over the cli phase's tree and
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
  8. reference checks at tiny size: the same forward, and one training
     micro-step, on CUDA and on the CPU (the CPU port is held against the
     JAX package by tests/test_torch_forward.py and test_torch_train.py).
Prints ptxas's registers and spills per kernel instance, the card's name
and power limit, a JSON line of kernel results (`launches` from the
serving path, `train_launches` from the training phase, `cli_launches`
from the CLI phase, `import_launches` from serving the imported
checkpoint), and as the last line {"ok": true, "device": {...}}.
Full results also go to chip_smoke.json in the output directory beside
the script.
"""
import ast
import contextlib
import dataclasses
import json
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOL = 1e-2                  # kernel vs plain, relative to max(1, |plain|)
BACKWARD_TOL = 1e-4         # backward kernel vs plain, relative to max |plain|
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
            b = re.search(r"backward_by_voxelILb([01])E", m.group(1))
            mode = lambda x: "variance" if x == "1" else "mean"
            name = (f"items={f.group(1)} {mode(f.group(2))}" if f
                    else f"backward items={k.group(1)} mean" if k
                    else f"backward per voxel {mode(b.group(1))}" if b
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
    """Backward kernel vs plain backward at the four call shapes, then
    timed like the forward."""
    import torch
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.tools import bench_back_project as bench

    results = []
    for case in case_list:
        stats = torch.zeros(3, dtype=torch.int64, device="cuda")
        got, want = case.backward(stats=stats), case.backward_plain()
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got.reshape(want.shape) - want).abs().max().item()
        if not (scale > 0 and err <= BACKWARD_TOL * scale):
            raise AssertionError(f"backward {case.name}: max abs err {err} > "
                                 f"{BACKWARD_TOL} x {scale}")
        in_box, direct, empty = stats.tolist()
        plan = bp.plan_backward(case.extent, case.c, case.h, case.w, v,
                                case.mode)
        if plan.per_voxel:
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
        t = bench.time_case(case, v, "backward")
        results.append(dict(
            name=f"back_project_backward/{case.name}", route="cuda",
            source="eprecon_tpu_torch/csrc/back_project.cu",
            replaces="eprecon_tpu/ops/back_project.py:24",
            launches=0, max_abs_err=err, **t, key=[case.mode, case.n, case.c],
            rel_err=err / scale, ctas_per_sm=ctas_per_sm,
            plan_ctas_per_sm=plan.ctas_per_sm,
            brick_views=dict(in_box=in_box, direct=direct, empty=empty),
            launch_parameters=dict(per_voxel=plan.per_voxel, brick=list(plan.brick),
                                   grid=plan.grid, threads=plan.threads,
                                   cvec=plan.cvec, box_px=plan.box_px,
                                   smem_bytes=plan.smem_bytes)))
        print(f"[backward] {case.name}: N={case.n} C={case.c} err={err:.3g} "
              f"(max |plain| {scale:.3g}) ms={t['ms']:.4f} "
              f"(profiled windows {t['profiler_windows']}) "
              f"call_ms={t['call_ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
              f"({t['bound_by']}) CTAs/SM on the card={ctas_per_sm} (plan "
              f"{plan.ctas_per_sm}) " + (
                  f"per-voxel kernel, grid={plan.grid} threads={plan.threads}"
                  if plan.per_voxel else
                  f"brick-views in-box/direct/empty={in_box}/{direct}/{empty} | "
                  f"launched with brick={plan.brick} grid={plan.grid} threads="
                  f"{plan.threads} cvec={plan.cvec} box_px="
                  f"{plan.box_px} smem={plan.smem_bytes} B") + f" | {card}",
              flush=True)
    return results


def main_path_phase(card):
    """Serve 3 fragments of scene 'a' and 1 of scene 'b' at full width."""
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bp.launch_counts.clear()
    per_frag, map_sizes, finished = [], [], None
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
        print(f"[main] fragment {i} scene={scene} ms={ms:.1f} "
              f"global-map voxels per level={sizes} | {card}", flush=True)
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
    return dict(fragment_ms=per_frag, peak_gib=peak, map_sizes=map_sizes,
                launches={str(k): n for k, n in launches.items()},
                flushed_shape=list(finished.tsdf.shape)), launches


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


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "eprecon_tpu_torch" / "csrc" / "back_project.cu").is_file():
        print("chip_smoke: run from a checkout of the repository "
              "(eprecon_tpu_torch/ not found)", file=sys.stderr)
        return 2
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
    main_res, launches = main_path_phase(card)
    train_res, train_fwd, train_bwd = train_phase(card)
    for k in kern:
        key = tuple(k["key"])
        k["launches"] = int(launches.get(key, 0))
        k["train_launches"] = int(train_fwd.get(key, 0))
        if k["launches"] == 0 or k["train_launches"] == 0:
            raise AssertionError(f"{k['name']}: not launched on the main path")
    for k in kern_bwd:
        k["launches"] = int(train_bwd.get(tuple(k["key"]), 0))
        if k["launches"] != TRAIN_STEPS:
            raise AssertionError(f"{k['name']}: {k['launches']} launches in "
                                 f"{TRAIN_STEPS} training steps")
    root = Path(tempfile.mkdtemp(prefix="eprecon_cli_"))
    try:
        cli_res, cli_fwd, cli_bwd = cli_phase(root, card)
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
    for k in kern + kern_bwd:
        k.pop("key")
        if k["cli_launches"] == 0:
            raise AssertionError(f"{k['name']}: not launched by the CLI")
    kern = kern + kern_bwd
    ref = reference_phase(card)
    ref["train"] = train_reference_phase(card)

    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, ptxas=ptxas, kernels=kern, main_path=main_res,
        train=train_res, cli=cli_res, import_phase=import_res, reference=ref),
        indent=1))
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

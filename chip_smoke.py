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
     over a ScanNet-layout tree in a temporary directory: 2 scenes of 3
     fragments of 9 views of the port's synthetic scenes, color at
     ScanNet's 1296x968 and depth at 640x480 (rendered once on a thread
     pool: the tree holds no image files, and a dataset registered here
     serves the frames through the port's ScanNetDataset, whose readers
     alone it replaces), full-scene GT fused on the card. config/train.yaml
     with the training phase's reductions: one epoch (6 micro-steps), a
     resumed second epoch, then config/test.yaml from the last checkpoint,
     scoring both scenes against the tree's GT. Fails unless every
     training step launched 4 forward and 4 backward kernels and every test
     fragment 4 forward, every GT fusion of the data pipeline ran on
     cuda, the resume starts at epoch 1 step 6 and ends at epoch 2 step 12
     with parameters moved, metrics.jsonl holds one record per step, the
     losses are finite and both scenes are saved with a finite TSDF and
     scored. Prints the loop's step ms and sample ms per step, host ms per
     sample by stage, the test's fragment ms, keyframes/s and p50, the
     scores (F-score, PQ) and the peak memory;
  7. reference checks at tiny size: the same forward, and one training
     micro-step, on CUDA and on the CPU (the CPU port is held against the
     JAX package by tests/test_torch_forward.py and test_torch_train.py).
Prints ptxas's registers and spills per kernel instance, the card's name
and power limit, a JSON line of kernel results (`launches` from the
serving path, `train_launches` from the training phase, `cli_launches`
from the CLI phase), and as the last line {"ok": true, "device": {...}}.
Full results also go to chip_smoke.json in the output directory beside
the script.
"""
import ast
import dataclasses
import json
import re
import sys
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
# --------------------------------------------------------------------------

CLI_DATASET = "chip_smoke_synthetic"
CLI_SCENES, CLI_FRAGMENTS, CLI_VIEWS = 2, 3, 9
CLI_COLOR_HW, CLI_DEPTH_HW = (968, 1296), (480, 640)   # ScanNet's raw sizes
CLI_TRAIN_STEPS = CLI_SCENES * CLI_FRAGMENTS            # per epoch
CLI_REDUCED = ["train.accumulation_steps", "2", "model.thresholds",
               "[-100,-100,-100]", "model.occ_init_threshold", "0"]


def scannet_intrinsics():
    """(depth, color) intrinsics with ScanNet's split: after the 968 -> 972
    pad and the resize to 640x480, the color intrinsics land on the depth
    intrinsics, as on real ScanNet."""
    import numpy as np

    (dh, dw), (ch, cw) = CLI_DEPTH_HW, CLI_COLOR_HW
    f = 0.9 * dw / 2
    depth = np.array([[f, 0, dw / 2 - 0.5], [0, f, dh / 2 - 0.5], [0, 0, 1]])
    color = depth.copy()
    color[0] *= cw / dw
    color[1] *= (ch + 4) / dh
    color[1, 2] -= 2
    return depth, color


class SyntheticFrames:
    """Frames of the port's synthetic scenes (data/synthetic.py): an orbit
    of CLI_FRAGMENTS * CLI_VIEWS poses per scene; color (BGR, integer
    levels) at 1296x968 and depth at 640x480, rendered once and cached."""

    def __init__(self):
        import numpy as np
        from eprecon_tpu_torch.data.synthetic import make_scene, orbit_poses

        n = CLI_FRAGMENTS * CLI_VIEWS
        self.scenes = {f"scene{s:04d}_00": (make_scene(s), orbit_poses(
            n, start=0.5 * s, sweep=2 * np.pi * (n - 1) / n))
                       for s in range(CLI_SCENES)}
        self.depth_intr, self.color_intr = scannet_intrinsics()
        self.cache = {}

    def _render(self, key):
        import numpy as np
        from eprecon_tpu_torch.data.synthetic import render_view

        scene, kind, i = key
        sc, poses = self.scenes[scene]
        if kind == "color":
            rgb = render_view(sc, self.color_intr, poses[i], CLI_COLOR_HW)[1]
            return np.clip(np.round(rgb), 0, 255).astype(np.float32)
        return render_view(sc, self.depth_intr, poses[i], CLI_DEPTH_HW)[0]

    def get(self, scene: str, kind: str, i: int):
        key = (scene, kind, i)
        if key not in self.cache:
            self.cache[key] = self._render(key)
        return self.cache[key]

    def render_all(self, threads: int = 8):
        """Fill the cache on a thread pool (numpy releases the GIL)."""
        from concurrent.futures import ThreadPoolExecutor

        keys = [(s, k, i) for s in self.scenes for k in ("depth", "color")
                for i in range(CLI_FRAGMENTS * CLI_VIEWS)]
        with ThreadPoolExecutor(threads) as ex:
            for key, img in zip(keys, ex.map(self._render, keys)):
                self.cache[key] = img


def register_synthetic_dataset(frames: SyntheticFrames):
    """Register CLI_DATASET: the port's ScanNetDataset with only its image
    readers replaced (the tree holds no image files, and the script needs
    no image decoder): they serve the rendered frames. Everything from
    _build_sample on is the package's code."""
    from eprecon_tpu_torch.data.scannet import ScanNetDataset, register_dataset

    @register_dataset(CLI_DATASET)
    class SyntheticScanNet(ScanNetDataset):
        def _frame(self, path, kind):
            p = Path(path)
            return frames.get(p.parents[1].name, kind, int(p.stem))

        def _read_img(self, path):
            return self._frame(path, "color").copy()

        def _read_depth(self, path):
            d = self._frame(path, "depth").copy()
            d[d > 3.0] = 0.0  # the ScanNet reader's depth clamp
            return d

        def _color_size(self, scene, vid):
            return CLI_COLOR_HW

    return SyntheticScanNet


def write_cli_tree(root: Path, frames: SyntheticFrames, device: str = "cuda"):
    """The ScanNet layout without image files: intrinsics and pose .txt,
    full-scene GT at three levels fused on the card with the port's
    ops/tsdf_fusion (the GT generator's layout: full_tsdf_layer*.npz,
    tsdf_info.npz, label volumes), fragments_{train,test}.pkl."""
    import pickle

    import numpy as np
    import torch
    from eprecon_tpu_torch.data.synthetic import voxel_labels
    from eprecon_tpu_torch.data.transforms import get_view_frustum
    from eprecon_tpu_torch.ops import tsdf_fusion

    metas = []
    for name, (scene, poses) in frames.scenes.items():
        src = root / "scans" / name
        for sub in ("intrinsic", "pose"):
            (src / sub).mkdir(parents=True, exist_ok=True)
        for fname, k in (("intrinsic_color.txt", frames.color_intr),
                         ("intrinsic_depth.txt", frames.depth_intr)):
            k4 = np.eye(4)
            k4[:3, :3] = k
            np.savetxt(src / "intrinsic" / fname, k4)
        for i, pose in enumerate(poses):
            np.savetxt(src / "pose" / f"{i}.txt", pose)
        depths = np.stack([frames.get(name, "depth", i) for i in range(len(poses))])
        depths[depths > 3.0] = 0.0
        pts = np.concatenate([get_view_frustum(3.0, CLI_DEPTH_HW, frames.depth_intr,
                                               p) for p in poses], axis=1)
        lo, hi = pts.min(1), pts.max(1)
        origin = lo.astype(np.float32)
        gt = root / "all_tsdf_9" / name
        gt.mkdir(parents=True)
        dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        k = np.repeat(frames.depth_intr[None], len(poses), 0)
        for lvl in range(3):
            vsz = 0.04 * 2 ** lvl
            dim = tuple(int(np.ceil((hi[i] - lo[i]) / vsz)) for i in range(3))
            t, _ = tsdf_fusion.fuse_frames(dev(depths), dev(k), dev(poses),
                                           dev(origin), dim, vsz, margin=3)
            t = t.cpu().numpy()
            np.savez_compressed(gt / f"full_tsdf_layer{lvl}.npz", t)
            if lvl == 0:
                occ = np.abs(t) < 0.999
                sem, ins = voxel_labels(scene, origin, vsz, dim)
                for label, vol in (("semantic", sem), ("instance", ins)):
                    np.savez_compressed(gt / f"full_{label}_layer_interpolate0.npz",
                                        np.where(occ, vol, 0).astype(np.int32))
        np.savez(gt / "tsdf_info.npz", vol_origin=origin, voxel_size=np.float32(0.04))
        metas += [dict(scene=name, fragment_id=f, vol_origin=origin,
                       image_ids=list(range(f * CLI_VIEWS, (f + 1) * CLI_VIEWS)))
                  for f in range(CLI_FRAGMENTS)]
    for split in ("train", "test"):
        with open(root / "all_tsdf_9" / f"fragments_{split}.pkl", "wb") as f:
            pickle.dump(metas, f)
    (root / "scans_test").symlink_to(root / "scans")


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
    import contextlib

    from eprecon_tpu_torch import main as cli

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = cli.main(args)
    return out, tee.lines


def time_sample_stages(dataset, indices):
    """Host ms per sample, by stage, with the card synchronised at each
    stage's end: frame reads, resize, the world-frame transform (its GT
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
    try:
        per = []
        for i in indices:
            acc.clear()
            t0 = time.perf_counter()
            dataset[i]
            torch.cuda.synchronize()
            per.append(dict(acc, total=1e3 * (time.perf_counter() - t0)))
    finally:
        dataset.transforms.transforms = stages
        del dataset._read_img, dataset._read_depth, dataset._read_cam
        tsdf_fusion.fuse_frames = fuse
    return {k: float(np.median([p.get(k, 0.0) for p in per])) for k in per[0]}


def cli_phase(card):
    """Train, resume and test through the CLI at full width over a
    ScanNet-layout tree of the port's synthetic scenes; the GT fusion of
    the data pipeline runs on the card."""
    import gc
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch
    from eprecon_tpu_torch import main as cli
    from eprecon_tpu_torch.config import load_config, parse_cli_overrides
    from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.ops import tsdf_fusion
    from eprecon_tpu_torch.train.state import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="eprecon_cli_"))
    try:
        frames = SyntheticFrames()
        t0 = time.perf_counter()
        frames.render_all()
        render_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_cli_tree(root, frames)
        tree_s = time.perf_counter() - t0
        register_synthetic_dataset(frames)
        logdir = root / "run"
        common = ["train.path", str(root), "test.path", str(root), "logdir",
                  str(logdir), "dataset", CLI_DATASET, "summary_freq", "1",
                  *CLI_REDUCED]
        print(f"[cli] tree of {CLI_SCENES} scenes x {CLI_FRAGMENTS} fragments x "
              f"{CLI_VIEWS} views (color {CLI_COLOR_HW[1]}x{CLI_COLOR_HW[0]}, "
              f"depth {CLI_DEPTH_HW[1]}x{CLI_DEPTH_HW[0]}): frames rendered in "
              f"{render_s:.1f} s, GT written in {tree_s:.1f} s; reduced from "
              f"config/*.yaml: {CLI_REDUCED} | {card}", flush=True)

        # instrumentation: launches per training step and per test fragment,
        # the device of every GT fusion of the data pipeline
        per_step, per_frag, fusion_devices = [], [], []
        step, process = Trainer.step, StreamingReconstructor.process_fragment
        fuse = tsdf_fusion.fuse_frames

        def counted(fn, out_list):
            def run(*a, **kw):
                before = (bp.total_launches(), bp.total_backward_launches())
                out = fn(*a, **kw)
                out_list.append((bp.total_launches() - before[0],
                                 bp.total_backward_launches() - before[1]))
                return out
            return run

        def fuse_recorded(depths, *a, **kw):
            fusion_devices.append(depths.device.type)
            return fuse(depths, *a, **kw)

        Trainer.step = counted(step, per_step)
        StreamingReconstructor.process_fragment = counted(process, per_frag)
        tsdf_fusion.fuse_frames = fuse_recorded
        bp.launch_counts.clear()
        bp.backward_launch_counts.clear()
        try:
            t0 = time.perf_counter()
            tr1, log1 = _run_cli(["--cfg", "config/train.yaml", *common,
                                  "train.epochs", "1"])
            train1_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tr2, log2 = _run_cli(["--cfg", "config/train.yaml", *common,
                                  "train.epochs", "2", "resume", "true"])
            train2_s = time.perf_counter() - t0
            del tr1, tr2
            gc.collect()
            t0 = time.perf_counter()
            results, log3 = _run_cli(["--cfg", "config/test.yaml", *common,
                                      "loadckpt", str(logdir / "model_000001")])
            test_s = time.perf_counter() - t0
        finally:
            Trainer.step, StreamingReconstructor.process_fragment = step, process
            tsdf_fusion.fuse_frames = fuse
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
        for name in frames.scenes:
            with np.load(scenes_dir / f"{name}.npz") as z:
                if not (np.isfinite(z["tsdf"]).all() and (np.abs(z["tsdf"]) < 1).any()):
                    raise AssertionError(f"scene {name}: no finite surface")
            mfile = scenes_dir / f"{name}_metrics.json"
            if not mfile.is_file():
                raise AssertionError(f"scene {name}: not scored")
            scores[name] = json.loads(mfile.read_text())
        if sorted(r.name for r in results) != sorted(frames.scenes):
            raise AssertionError(f"run_test returned {[r.name for r in results]}")

        # numbers
        step_ms = [r["step_ms"] for r in records]
        sample_ms = [r["sample_ms"] for r in records]
        steady = [x for i, x in enumerate(step_ms) if i % CLI_TRAIN_STEPS]
        epochs = [float(re.search(r"\(([0-9.]+)s\)$", x).group(1))
                  for x in log1 + log2 if x.startswith("epoch ")]
        frag_ms = [float(re.search(r": ([0-9.]+) ms", x).group(1))
                   for x in log3 if x.startswith("fragment ")]
        summary = re.search(r"\(([0-9.]+) keyframes/s, p50 fragment ([0-9.]+) ms\)",
                            log3[-1])
        train_ds = cli.build_dataset(load_config(
            str(REPO / "config/train.yaml"), parse_cli_overrides(common)), "train")
        stages = time_sample_stages(train_ds, range(len(train_ds)))
        del train_ds, results
        wall = time.perf_counter() - t_phase
        res = dict(
            train_step_ms=step_ms, train_sample_ms=sample_ms,
            train_steady_step_ms=float(np.median(steady)),
            train_steady_sample_ms=float(np.median(
                [x for i, x in enumerate(sample_ms) if i % CLI_TRAIN_STEPS])),
            epoch_s=epochs, test_fragment_ms=frag_ms,
            test_keyframes_per_s=float(summary.group(1)),
            test_p50_fragment_ms=float(summary.group(2)),
            sample_stage_ms=stages, eval_loss_means=eval_means, scores=scores,
            peak_gib=peak, wall_s=wall, render_s=render_s, tree_s=tree_s,
            run_s=dict(train=train1_s, resume=train2_s, test=test_s),
            reduced=CLI_REDUCED, color_hw=list(CLI_COLOR_HW))
        print(f"[cli] train through train_epochs: step ms {[round(x, 1) for x in step_ms]}"
              f"; steady (median of steps after each epoch's first) "
              f"{res['train_steady_step_ms']:.1f} ms, of it sample "
              f"{res['train_steady_sample_ms']:.1f} ms; epochs {epochs} s | {card}",
              flush=True)
        print(f"[cli] host ms per sample (median, card synchronised per stage): "
              f"{ {k: round(v, 1) for k, v in stages.items()} } | {card}", flush=True)
        print(f"[cli] test: fragment ms {[round(x, 1) for x in frag_ms]}, "
              f"{res['test_keyframes_per_s']} keyframes/s, p50 "
              f"{res['test_p50_fragment_ms']} ms; eval losses {eval_means}; "
              + "; ".join(f"{n} fscore={m.get('fscore', float('nan')):.4f} "
                          f"PQ={m.get('PQ', float('nan')):.4f}"
                          for n, m in scores.items()) + f" | {card}", flush=True)
        print(f"[cli] peak memory {peak:.2f} GiB; phase wall {wall:.1f} s "
              f"(render {render_s:.1f}, tree {tree_s:.1f}, train {train1_s:.1f}, "
              f"resume {train2_s:.1f}, test {test_s:.1f}) | {card}", flush=True)
        return res, launches, backward_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    cli_res, cli_fwd, cli_bwd = cli_phase(card)
    for k in kern:
        k["cli_launches"] = int(cli_fwd.get(tuple(k["key"]), 0))
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
        train=train_res, cli=cli_res, reference=ref), indent=1))
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

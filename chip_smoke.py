#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eprecon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. build csrc/back_project.cu for sm_90a with nvcc;
  2. at the four back-projection call shapes of a full-width fragment,
     hold the kernel against its plain PyTorch version on the card, tally
     its brick-views (staged in shared memory / read from device memory /
     empty), check that the card holds as many CTAs per SM as the launch
     plan assumes (CUDA occupancy calculator), and time it
     (eprecon_tpu_torch/tools/bench_back_project.py):
     ms is the kernel's device time under torch.profiler with the L2
     flushed, call_ms the wrapper's time per call, beside the plain
     version, an F.grid_sample yardstick (library_ms) and the least time
     the card could take (bound_ms);
  3. serve the main path: StreamingReconstructor at the default config
     (96^3 window at 4 cm, 9 views at 640x480, 80-query 6-layer decoder),
     random weights from a seed, 3 fragments of one scene then 1 of a
     second (scene flush); the kernel must launch 4 times per fragment;
  4. reference check at tiny size: the same forward on CUDA and on the
     CPU (the CPU port is held against the JAX package by
     tests/test_torch_forward.py).
Prints ptxas's registers and spills per kernel instance, the card's name
and power limit, a JSON line of kernel results,
and as the last line {"ok": true, "device": {...}}. Full results also go
to chiprun_out/chip_smoke.json.
"""
import dataclasses
import json
import re
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOL = 1e-2                  # kernel vs plain, relative to max(1, |plain|)


def ptxas_lines(so: Path):
    """Registers, spills and shared memory of each kernel instance, from
    the ptxas report kept beside the built library."""
    from eprecon_tpu_torch import kernels

    entries, name = {}, None
    for line in kernels.ptxas_report(so).read_text().splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            k = re.search(r"ILi(\d+)ELb([01])E", m.group(1))
            name = (f"items={k.group(1)} {'variance' if k.group(2) == '1' else 'mean'}"
                    if k else m.group(1))
            entries.setdefault(name, [])
        elif name and ("spill" in line or "Used" in line):
            entries[name].append(line.split(":", 1)[-1].strip())
    return [" | ".join([k, *x]) for k, x in entries.items()]


def kernel_phase(frag, card):
    """Kernel vs plain at the main path's four call shapes, then timed
    (tools/bench_back_project.py): device time under the profiler with
    the L2 flushed, wrapper time, plain, library yardstick, bound."""
    import torch
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.tools import bench_back_project as bench

    v = frag["proj_matrices"].shape[0]
    results = []
    for case in bench.cases(frag["proj_matrices"], frag["vol_origin_partial"]):
        name, n, c = case.name, case.n, case.c
        stats = torch.zeros(3, dtype=torch.int64, device="cuda")
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
        staged, from_memory, empty = stats.tolist()
        plan = bp.plan_launch(case.extent, c, case.h, case.w, v, 1, case.mode)
        if staged + from_memory + empty != plan.grid * v:
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
                   ctas_per_sm=ctas_per_sm,
                   brick_views=dict(staged=staged, from_memory=from_memory,
                                    empty=empty),
                   launch_parameters=dict(brick=list(plan.brick), grid=plan.grid,
                                          threads=plan.threads,
                                          smem_bytes=plan.smem_bytes))
        print(f"[kernel] {name}: N={n} C={c} err={err:.3g} ms={t['ms']:.4f} "
              f"(profiled windows {t['profiler_windows']}) "
              f"call_ms={t['call_ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
              f"({t['bound_by']}) CTAs/SM on the card={ctas_per_sm} "
              f"brick-views staged/from-memory/empty={staged}/{from_memory}/"
              f"{empty} | launched with brick={plan.brick} grid={plan.grid} "
              f"threads={plan.threads} smem={plan.smem_bytes} B | {card}",
              flush=True)
        results.append(res)
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
            out, _ = model(torch.as_tensor(d["imgs"], device=dev), frag,
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

    frag = make_fragment(seed=0)
    kern = kernel_phase(frag, card)
    main_res, launches = main_path_phase(card)
    for k in kern:
        k["launches"] = int(launches.get(tuple(k.pop("key")), 0))
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']}: not launched on the main path")
    ref = reference_phase(card)

    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, ptxas=ptxas, kernels=kern, main_path=main_res,
        reference=ref), indent=1))
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

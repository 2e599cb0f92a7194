"""Ablations of the back-projection kernels, on one NVIDIA GPU.

    python -m eprecon_tpu_torch.tools.ablate_back_project [--out FILE] [--variants-only]

Builds variants of csrc/back_project.cu, each the source with a few text
substitutions, and times each at the four call shapes of
tools/bench_back_project.py (device time under the profiler, L2 flushed),
forward and backward:

  as_is              the kernels as committed
  no_view_cull       no brick-view is skipped before projecting it
  compiler_division  the forward divides as nvcc emits an IEEE division,
                     one per output quotient, instead of a shared reciprocal
                     per voxel
  no_gather          the forward's gather skipped: a floor for its other
                     phases
  no_global_atomics  the backward adds nothing to the gradient in device
                     memory (its sums are still formed): the atomics' cost
  no_box_terms       the brick backward forms and adds no term of the
                     brick-views that take the box (their flush still runs,
                     on a zero box): a floor for setup, cull, projection,
                     the cotangents, the variance's samples and the flush
  no_shared_atomics  the brick box and the view tiles add their terms with
                     plain loads and stores: the cost of the shared
                     atomics (two 32-bit ones per term, add_words)
  no_conversions     every term is cast to an integer by its bits instead
                     of the float-to-int64 conversion: the conversions' cost
  no_first_pass      the variance's brick backward skips its first pass
                     over the views (the samples for s1, s2): its cost
  no_box_flush       the brick backward neither reads nor zeroes its box
                     after a brick-view's adds, nor adds it to the
                     gradient: the flush's cost
  no_direct          the brick-views whose box does not fit add nothing
                     (warp_scatter8 sees no lane): the direct path's cost
  no_tile_records    the view-tile backward takes no record: a floor for its
                     visible-records pass, zero fill and merge
  no_tile_merge      the view-tile backward neither takes records nor merges:
                     a floor for the visible-records pass and the launch

The last ten give wrong outputs, which are not checked; every other
variant must stay bitwise equal to the plain forward and backward. Then,
with the kernels as
committed, it times every brick the forward plan may choose from
(ops/back_project.py brick_choices) and every backward launch the backward
plan may choose from: each channel split (vectors per CTA) with each brick
it allows (for the window mean and the variance; every brick whose items
fit, filling a CTA or not), each with its box and with boxes of BOX_SIZES
pixels (more or fewer CTAs per SM), the chosen brick plan with no box
(every brick-view scattered straight into the gradient; where the plan
takes view tiles, the largest one-vector brick's), and the
view-tile kernel at every channel slice and number of record ranges
(ops/back_project.py plan_tile), beside the CTAs per SM (and clusters per
card) the card holds.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

VARIANTS = {
    "as_is": [],
    "no_view_cull": [("view_may_see(s_proj + (v * p.B + blo) * 16, lo, hi,\n"
                      "                                      p.H, p.W)", "true")],
    "compiler_division": [
        ("      r1[e] = by_cnt.fast(s1[k][e]);", "      r1[e] = s1[k][e] / denom;"),
        ("      r2[e] = kVariance ? by_cnt.fast(s2[k][e]) : 0.f;",
         "      r2[e] = kVariance ? s2[k][e] / denom : 0.f;")],
    "no_gather": [("      gather_view<K, kVariance>(view,",
                   "      if (0) gather_view<K, kVariance>(view,")],
    "no_global_atomics": [("    if (a >= 0)\n      atomicAdd(",
                           "    if (a >= 0 && q[k] == 0x123456789LL)\n      atomicAdd(")],
    "no_box_terms": [("    if (uv >= 0) {\n      const int iu = uv & 0xffff",
                      "    if (uv >= 0 && kVec < 0) {\n      const int iu = uv & 0xffff")],
    "no_shared_atomics": [("  const unsigned old = atomicAdd(lo_w, lo);\n"
                           "  const unsigned carry_hi = hi + (old + lo < old ? 1u : 0u);\n"
                           "  if (carry_hi != 0u) atomicAdd(hi_w, carry_hi);",
                           "  const unsigned old = *lo_w;\n  *lo_w = old + lo;\n"
                           "  *hi_w += hi + (old + lo < old ? 1u : 0u);")],
    "no_conversions": [("  return __float2ll_rn(term * scale);",
                        "  return (long long)__float_as_int(term * scale);")],
    "no_box_flush": [("    for (int t0 = tid - lane; t0 < npx * cvec; t0 += nthr) {",
                      "    for (int t0 = tid - lane; t0 < 0; t0 += nthr) {")],
    "no_direct": [("      warp_scatter8(grad, item_off, uv >= 0,",
                   "      warp_scatter8(grad, item_off, uv >= 0 && kVec < 0,")],
    "no_first_pass": [("      if (uv < 0) continue;\n      float s[kVec];\n"
                       "      sample8(view, l, uv,",
                       "      if (uv < 0 || kVec > 0) continue;\n      float s[kVec];\n"
                       "      sample8(view, l, uv,")],
    "no_tile_records": [("  for (int q = warp; q < Q; q += nwarps) {",
                         "  for (int q = warp; q < 0; q += nwarps) {")],
    "no_tile_merge": [("  for (int q = warp; q < Q; q += nwarps) {",
                       "  for (int q = warp; q < 0; q += nwarps) {"),
                      ("  for (int t0 = px0 * CS + tid; t0 < px1 * CS; t0 += kMerge * nthr) {",
                       "  for (int t0 = px0 * CS + tid; t0 < 0; t0 += kMerge * nthr) {")],
}
WRONG_FORWARD = {"no_gather"}
WRONG_BACKWARD = {"no_gather", "no_global_atomics", "no_box_terms",
                  "no_shared_atomics", "no_conversions", "no_first_pass",
                  "no_box_flush", "no_direct",
                  "no_tile_records", "no_tile_merge"}
BOX_SIZES = (64, 96, 160, 256)  # box pixels tried beside each plan's own


def variant_sources(src: str) -> dict:
    """Each variant's source: `src` with its substitutions, every one of
    which must find its text."""
    out = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not found in back_project.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants(out_dir: Path) -> dict:
    """Compile every variant in parallel (one nvcc each); name -> .so."""
    from eprecon_tpu_torch import kernels

    sources = variant_sources((kernels.CSRC / "back_project.cu").read_text())
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _backward_close(case) -> None:
    import torch

    got, want = case.backward(), case.backward_plain()
    torch.cuda.synchronize()
    if not torch.equal(got.reshape(want.shape), want):
        err = (got.reshape(want.shape) - want).abs().max().item()
        raise AssertionError(f"backward {case.name}: differs from the plain "
                             f"version by up to {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write the results here")
    ap.add_argument("--variants-only", action="store_true",
                    help="time the source variants, not the plans' choices")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ablate_back_project: CUDA is not available", file=sys.stderr)
        return 2
    from eprecon_tpu_torch import kernels
    from eprecon_tpu_torch.data.synthetic import make_fragment
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.tools import bench_back_project as bench

    card = bench.card_line()
    libs = build_variants(kernels.BUILD_DIR / "ablate")
    frag = make_fragment(seed=0)
    v = frag["proj_matrices"].shape[0]
    cases = bench.cases(frag["proj_matrices"], frag["vol_origin_partial"])
    res = {"card": card, "device_ms": {}, "bricks": {}, "backward_plans": {}}
    library, plan_launch, plan_backward = bp._library, bp.plan_launch, bp.plan_backward
    try:
        for name, lib in libs.items():
            bp._library = lambda lib=bp.bind(lib): lib
            for case in cases:
                (k_out, k_cnt), (p_out, p_cnt) = case.run(), case.plain()
                torch.cuda.synchronize()
                equal = torch.equal(k_out, p_out) and torch.equal(k_cnt, p_cnt)
                if name not in WRONG_FORWARD and not equal:
                    raise AssertionError(f"{name} {case.name}: differs from the plain version")
                row = {"forward": bench.device_ms(case.run, 20)[0],
                       "backward": bench.device_ms(case.backward, 20,
                                                   bench.BACKWARD_KERNEL)[0]}
                if name not in WRONG_BACKWARD:
                    _backward_close(case)
                res["device_ms"].setdefault(name, {})[case.name] = row
                print(f"[ablate] {name} {case.name}: " + " ".join(
                    f"{k}_ms={x:.4f}" for k, x in row.items()) + f" | {card}",
                    flush=True)
        bp._library = library
        for case in [] if args.variants_only else cases:
            for brick in bp.brick_choices(case.extent, case.c, case.mode):
                plan = bp.plan_brick(case.extent, case.c, v, 1, brick, case.mode)
                bp.plan_launch = lambda *_, plan=plan: plan
                (k_out, k_cnt), (p_out, p_cnt) = case.run(), case.plain()
                torch.cuda.synchronize()
                if not (torch.equal(k_out, p_out) and torch.equal(k_cnt, p_cnt)):
                    raise AssertionError(f"brick {brick} {case.name}: differs "
                                         "from the plain version")
                ms, windows, _ = bench.device_ms(case.run, 20)
                row = dict(device_ms=ms, ctas_per_sm=bp.occupancy(plan, case.mode),
                           plan_ctas_per_sm=plan.ctas_per_sm, grid=plan.grid,
                           threads=plan.threads, chosen=brick == plan_launch(
                               case.extent, case.c, v, 1, case.mode).brick)
                res["bricks"].setdefault(case.name, {})["x".join(map(str, brick))] = row
                print(f"[brick] {case.name} {brick}: device_ms={ms:.4f} (profiled "
                      f"windows {windows}) " + " ".join(
                          f"{k}={x}" for k, x in row.items() if k != "device_ms")
                      + f" | {card}", flush=True)
            bp.plan_launch = plan_launch
            chosen = plan_backward(case.extent, case.c, case.h, case.w, v, case.mode)
            nvec = case.c // 8
            plans = {}
            cvecs = [d for d in range(1, nvec + 1) if nvec % d == 0]
            for cvec in cvecs:
                for brick in bp.backward_brick_choices(case.extent, cvec, v,
                                                       case.mode):
                    for px in (None, *BOX_SIZES):
                        try:
                            plan = bp.plan_backward_brick(
                                case.extent, case.c, case.h, case.w, v, brick,
                                cvec, box_px=px, mode=case.mode)
                        except ValueError:  # items or box exceed a CTA
                            continue
                        if plan.threads < 64:  # a warp per CTA: slower at every shape
                            continue
                        plans[f"cvec{cvec} {'x'.join(map(str, brick))} box "
                              f"{plan.box_px} px"] = plan
            best = chosen if isinstance(chosen, bp.BackwardPlan) else bp.plan_backward_brick(
                case.extent, case.c, case.h, case.w, v,
                bp.backward_brick_choices(case.extent, 1, v)[0], 1)
            plans[f"{'x'.join(map(str, best.brick))} cvec{best.cvec}, direct only"] = (
                bp.plan_backward_brick(case.extent, case.c, case.h, case.w, v,
                                       best.brick, best.cvec, box_px=0,
                                       mode=case.mode))
            if case.mode == bp.WINDOW_MEAN:
                for cs in bp.tile_channel_choices(case.c, case.h, case.w):
                    for ranges in range(1, bp.MAX_CLUSTER + 1):
                        plans[f"tiles cs{cs} ranges{ranges}"] = bp.plan_tile(
                            case.c, case.h, case.w, v, cs, ranges)
            for label, plan in plans.items():
                bp.plan_backward = lambda *_, plan=plan: plan
                _backward_close(case)
                stats = torch.zeros(3, dtype=torch.int64, device="cuda")
                case.backward(stats=stats)
                ms, windows, _ = bench.device_ms(case.backward, 20, bench.BACKWARD_KERNEL)
                tile = isinstance(plan, bp.TilePlan)
                row = dict(device_ms=ms, ctas_per_sm=bp.occupancy(plan, case.mode),
                           plan_ctas_per_sm=plan.ctas_per_sm, grid=plan.grid,
                           threads=plan.threads,
                           **(dict(cs=plan.cs, ranges=plan.ranges,
                                   clusters=bp.tile_occupancy(plan)[1],
                                   visible_pairs=stats.tolist()[0]) if tile else
                              dict(cvec=plan.cvec, box_px=plan.box_px,
                                   brick_views=stats.tolist())),
                           chosen=plan == chosen)
                res["backward_plans"].setdefault(case.name, {})[label] = row
                print(f"[backward plan] {case.name} {label}: device_ms={ms:.4f} "
                      f"(profiled windows {windows}) " + " ".join(
                          f"{k}={x}" for k, x in row.items() if k != "device_ms")
                      + f" | {card}", flush=True)
            bp.plan_backward = plan_backward
    finally:
        bp._library = library
        bp.plan_launch = plan_launch
        bp.plan_backward = plan_backward
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Ablations of the back-projection kernel, on one NVIDIA GPU.

    python -m eprecon_tpu_torch.tools.ablate_back_project [--out FILE]

Builds variants of csrc/back_project.cu, each the source with a few text
substitutions, and times each at the four call shapes of
tools/bench_back_project.py (device time under the profiler, L2 flushed):

  as_is              the kernel as committed
  no_view_cull       no brick-view is skipped before projecting it
  from_memory        no box is staged: every corner read from device memory
  compiler_division  one IEEE division per output quotient as nvcc emits
                     it, instead of a shared reciprocal per voxel
  no_gather          phase C skipped: a floor for the other phases (its
                     output is wrong and is not checked)

Every other variant must stay bitwise equal to the plain version. For the
kernel as committed it also prints the mean cycles per CTA that thread 0
spends in each phase, from clock64() stamps added the same way, and times
each shape with every brick the launch plan may choose from
(ops/back_project.py brick_choices), beside the CTAs per SM the card holds.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

PHASES = ["setup+cull", "project", "box+copy", "wait", "gather", "write"]


def _stamp(i: int) -> str:
    return (" { const long long _n = clock64(); if (threadIdx.x == 0) "
            f"atomicAdd(&g_phase[{i}], (unsigned long long)(_n - _t)); _t = _n; }}\n")


CLOCK_READER = '''
extern "C" int bp_phases(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
  const unsigned long long zero[8] = {};
  cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return (int)e;
}
'''

VARIANTS = {
    "as_is": [],
    "no_view_cull": [("view_may_see(s_proj + (v * B + blo) * 16, lo, hi, H, W)", "true")],
    "from_memory": [("    bx_.staged = bx_.any && bmin == bmax &&",
                     "    bx_.staged = false && bmin == bmax &&")],
    "compiler_division": [
        ("      r1[e] = by_cnt.fast(s1[k][e]);", "      r1[e] = s1[k][e] / denom;"),
        ("      r2[e] = kVariance ? by_cnt.fast(s2[k][e]) : 0.f;",
         "      r2[e] = kVariance ? s2[k][e] / denom : 0.f;")],
    "no_gather": [("      gather_view<K, kVariance>(rows,", "      if (0) gather_view<K, kVariance>(rows,")],
    "phase_clock": [
        ("namespace {\n", "namespace {\n__device__ unsigned long long g_phase[8];\n"),
        ("  extern __shared__ __align__(16) unsigned char smem[];\n",
         "  extern __shared__ __align__(16) unsigned char smem[];\n  long long _t = clock64();\n"),
        ("  const int nviews = s_views[V];\n", "  const int nviews = s_views[V];\n" + _stamp(0)),
        ("    project(s_views[0], 0);\n    __syncthreads();\n",
         "    project(s_views[0], 0);\n    __syncthreads();\n" + _stamp(1)),
        ("    if (cur.staged) stage(s_views[0], cur, 0);\n    cp_async_commit();\n",
         "    if (cur.staged) stage(s_views[0], cur, 0);\n    cp_async_commit();\n" + _stamp(2)),
        ("      project(vn, buf ^ 1);\n      __syncthreads();\n",
         "      project(vn, buf ^ 1);\n      __syncthreads();\n" + _stamp(1)),
        ("      if (nxt.staged) stage(vn, nxt, buf ^ 1);\n      cp_async_commit();\n",
         "      if (nxt.staged) stage(vn, nxt, buf ^ 1);\n      cp_async_commit();\n" + _stamp(2)),
        ("    __syncthreads();  // everyone's copies of view v are visible\n",
         "    __syncthreads();  // everyone's copies of view v are visible\n" + _stamp(3)),
        ("    __syncthreads();  // buffers buf are free for the view after next\n",
         "    __syncthreads();  // buffers buf are free for the view after next\n" + _stamp(4)),
        ("    if (item_cv[k] == 0) count[n] = cnt;\n  }\n",
         "    if (item_cv[k] == 0) count[n] = cnt;\n  }\n" + _stamp(5))],
}


def build_variants(out_dir: Path) -> dict:
    """Compile every variant in parallel (one nvcc each); name -> .so."""
    from eprecon_tpu_torch import kernels

    src = (kernels.CSRC / "back_project.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not found in back_project.cu")
            text = text.replace(old, new)
        if name == "phase_clock":
            text += CLOCK_READER
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write the results here")
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
    res = {"card": card, "device_ms": {}, "phase_cycles_per_cta": {},
           "bricks": {}}
    library, plan_launch = bp._library, bp.plan_launch
    try:
        for name, lib in libs.items():
            bp._library = lambda lib=bp.bind(lib): lib
            for case in cases:
                (k_out, k_cnt), (p_out, p_cnt) = case.run(), case.plain()
                torch.cuda.synchronize()
                equal = torch.equal(k_out, p_out) and torch.equal(k_cnt, p_cnt)
                if name != "no_gather" and not equal:
                    raise AssertionError(f"{name} {case.name}: differs from the plain version")
                if name == "phase_clock":
                    cycles = (ctypes.c_ulonglong * 8)()
                    lib.bp_phases(cycles)  # clear
                    case.run()
                    torch.cuda.synchronize()
                    lib.bp_phases(cycles)
                    grid = bp.plan_launch(case.extent, case.c, case.h, case.w, v, 1,
                                          case.mode).grid
                    res["phase_cycles_per_cta"][case.name] = {
                        p: cycles[j] / grid for j, p in enumerate(PHASES)}
                    print(f"[phases] {case.name}: " + " ".join(
                        f"{p}={cycles[j] / grid:.0f}" for j, p in enumerate(PHASES))
                        + f" | {card}", flush=True)
                    continue
                ms, windows = bench.device_ms(case.run, 20)
                res["device_ms"].setdefault(name, {})[case.name] = ms
                print(f"[ablate] {name} {case.name}: device_ms={ms:.4f} "
                      f"(profiled windows {windows}) | {card}", flush=True)
        bp._library = library
        for case in cases:
            for brick in bp.brick_choices(case.extent, case.c, case.mode):
                plan = bp.plan_brick(case.extent, case.c, case.h, case.w, v, 1, brick)
                bp.plan_launch = lambda *_, plan=plan: plan
                (k_out, k_cnt), (p_out, p_cnt) = case.run(), case.plain()
                torch.cuda.synchronize()
                if not (torch.equal(k_out, p_out) and torch.equal(k_cnt, p_cnt)):
                    raise AssertionError(f"brick {brick} {case.name}: differs "
                                         "from the plain version")
                ms, windows = bench.device_ms(case.run, 20)
                row = dict(device_ms=ms, ctas_per_sm=bp.occupancy(plan, case.mode),
                           plan_ctas_per_sm=plan.ctas_per_sm, grid=plan.grid,
                           threads=plan.threads, chosen=brick == plan_launch(
                               case.extent, case.c, case.h, case.w, v, 1, case.mode).brick)
                res["bricks"].setdefault(case.name, {})["x".join(map(str, brick))] = row
                print(f"[brick] {case.name} {brick}: device_ms={ms:.4f} (profiled "
                      f"windows {windows}) " + " ".join(
                          f"{k}={x}" for k, x in row.items() if k != "device_ms")
                      + f" | {card}", flush=True)
    finally:
        bp._library = library
        bp.plan_launch = plan_launch
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

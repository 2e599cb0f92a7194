"""Time the back-projection kernel at the four call shapes of a full-width
fragment, on one NVIDIA GPU.

    python eprecon_tpu_torch/tools/bench_back_project.py [--root DIR] [--out FILE]

Per shape: `ms`, the kernel's own device time (mean duration of its
`back_project_kernel` events under torch.profiler, with 128 MB written
between launches so the tables come from device memory, as they do in a
fragment; only a profiled window with a record of every launch counts);
`call_ms`, the wrapper's time per call (CUDA events around a run of Python
calls); the plain PyTorch version's and an F.grid_sample yardstick's times;
and `bound_ms`, the least time the card could take.
`--root` names the checkout whose eprecon_tpu_torch is timed (default:
the one holding this file), so that two versions of the kernel can be
timed on one card: run this file as a script, once per root. chip_smoke.py
uses the same cases and also holds the kernel against the plain version.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, List, Tuple

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
FLUSH_BYTES = 128 << 20     # written between timed launches; L2 is 50 MB
WINDOWS = 3                 # profiled windows tried per device time
KERNEL = "back_project_kernel"

# (name, window dim, interval, proj scale, feature h, w, channels); the
# first is the occupancy-init variance over a coordinate list, the others
# the stage windows' means
SHAPES = [("occ_init_variance", (48, 48, 48), 2, 1, 60, 80, 32),
          ("stage0_window", (24, 24, 24), 4, 2, 30, 40, 80),
          ("stage1_window", (48, 48, 48), 2, 1, 60, 80, 40),
          ("stage2_window", (96, 96, 96), 1, 0, 120, 160, 24)]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@dataclasses.dataclass
class Case:
    name: str
    mode: int
    extent: Tuple[int, ...]  # window dims, or (rows,) of a coordinate list
    h: int
    w: int
    n: int
    c: int
    run: Callable      # run(**kw) -> (out, count); kw may hold `stats`
    plain: Callable
    library: Callable  # the yardstick, same function from stock calls
    bytes_: int        # each input read once, each output written once
    visible: int       # visible (voxel, view) pairs
    ops_per_visible: int
    ops_per_voxel: int

    def bound(self, v: int):
        ops = (self.n * v * 22 + self.visible * self.c * self.ops_per_visible
               + self.n * self.c * self.ops_per_voxel)
        t_bytes = self.bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def yardstick(feats_vchw, proj, world, h, w, variance):
    """The same function from stock PyTorch calls: projection, one
    F.grid_sample over all views, masked mean (and variance)."""
    import torch
    import torch.nn.functional as F

    pts = torch.cat([world, torch.ones_like(world[:, :1])], dim=1)
    cam = torch.einsum("vij,nj->vni", proj, pts)
    z = cam[..., 2]
    z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    u, v = cam[..., 0] / z, cam[..., 1] / z
    m = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (z > 0)
    grid = torch.stack([2 * u / (w - 1) - 1, 2 * v / (h - 1) - 1], -1)[:, None]
    s = F.grid_sample(feats_vchw, grid, align_corners=True,
                      padding_mode="zeros")[:, :, 0] * m[:, None]
    cnt = m.sum(0).clamp(min=1)
    mean = s.sum(0) / cnt
    if variance:
        return (s.square().sum(0) / cnt - mean.square()).clamp(min=0), cnt
    return mean, cnt


def cases(proj_matrices, vol_origin) -> List[Case]:
    """The four call shapes on random bf16 features (seed 0) and the
    fragment's cameras."""
    import torch
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.ops.grid import dense_coords

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    proj_all = torch.as_tensor(proj_matrices, device=dev)
    origin = torch.as_tensor(vol_origin, device=dev)[None]
    v = proj_all.shape[0]
    out = []
    for name, dim, interval, scale, h, w, c in SHAPES:
        feats = torch.randn(v, 1, h, w, c, device=dev, generator=gen).to(torch.bfloat16)
        proj = proj_all[:, None, scale].contiguous()
        n = dim[0] * dim[1] * dim[2]
        grid = dense_coords(dim, dev).reshape(-1, 3) * interval
        world = grid.float() * 0.04 + origin[0]
        variance = name == "occ_init_variance"
        if variance:
            coords = torch.cat([torch.zeros(n, 1, dtype=torch.int32, device=dev),
                                grid.to(torch.int32)], 1)
            valid = torch.ones(n, dtype=torch.bool, device=dev)
            args = (coords, valid, origin, 0.04, feats, proj)
            run = lambda args=args, **kw: bp.back_project_variance(*args, **kw)
            plain = lambda args=args: bp.back_project_variance_plain(*args)
            mode, extra_in, ops = bp.VARIANCE, n * 16 + n, (11, 4)
        else:
            args = (dim, interval, origin, 0.04, feats, proj)
            run = lambda args=args, **kw: bp.back_project_window(*args, **kw)
            plain = lambda args=args: bp.back_project_window_plain(*args)
            mode, extra_in, ops = bp.WINDOW_MEAN, 0, (9, 1)
        visible = int(plain()[1].sum().item())
        feats_f32 = feats[:, 0].permute(0, 3, 1, 2).float().contiguous()
        library = (lambda f=feats_f32, p=proj[:, 0].float(), wo=world, h=h, w=w,
                   var=variance: yardstick(f, p, wo, h, w, var))
        out.append(Case(name, mode, (n,) if variance else dim, h, w, n, c,
                        run, plain, library,
                        v * h * w * c * 2 + v * 64 + 12 + extra_in + n * c * 2 + n * 4,
                        visible, *ops))
    return out


def cuda_ms(fn, iters: int) -> float:
    """Per-call time of `fn` from CUDA events around `iters` calls: the
    device time where the device is the bottleneck, else the host's."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> Tuple[float, int]:
    """Mean device duration of the KERNEL events that `iters` calls of
    `fn` launch under torch.profiler, each after a write of FLUSH_BYTES,
    and the number of profiled windows that took. Only a window with a
    record of every launch counts. The profiler has kept fewer records than
    launches (seldom, cause unknown): such a window is dropped whole and
    the launches profiled again, at most WINDOWS times in all, then this
    raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for window in range(1, WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                flush.fill_(i & 255)
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if KERNEL in e.name and "CUDA" in str(e.device_type)]
        if len(us) == iters:
            return sum(us) / len(us) / 1e3, window
        print(f"[profiler] kept {len(us)} {KERNEL} records of {iters} "
              f"launches; profiling them again", file=sys.stderr, flush=True)
    raise AssertionError(f"profiler kept fewer {KERNEL} records than launches "
                         f"in {WINDOWS} windows of {iters}")


def time_case(case: Case, v: int) -> dict:
    iters = 50 if case.n < 200_000 else 20
    bound, bound_by = case.bound(v)
    ms, windows = device_ms(case.run, iters)
    return dict(ms=ms, profiler_windows=windows,
                call_ms=cuda_ms(case.run, iters),
                plain_ms=cuda_ms(case.plain, max(3, iters // 5)),
                bound_ms=bound, bound_by=bound_by,
                library_ms=cuda_ms(case.library, max(3, iters // 5)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="checkout whose eprecon_tpu_torch is timed")
    ap.add_argument("--out", type=Path, help="also write the results here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_back_project: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from eprecon_tpu_torch.data.synthetic import make_fragment

    card = card_line()
    frag = make_fragment(seed=0)
    v = frag["proj_matrices"].shape[0]
    res = {"root": str(args.root), "card": card, "shapes": {}}
    for case in cases(frag["proj_matrices"], frag["vol_origin_partial"]):
        t = time_case(case, v)
        res["shapes"][case.name] = t
        print(f"[bench] {case.name}: " + " ".join(
            f"{k}={x:.4f}" if isinstance(x, float) else f"{k}={x}"
            for k, x in t.items()) + f" | {card}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

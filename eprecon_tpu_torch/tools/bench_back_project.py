"""Time the back-projection kernels, forward and backward, at the four call
shapes of a full-width fragment, and the occupancy init's grid passed as
the JAX signature's coordinate list, on one NVIDIA GPU.

    python eprecon_tpu_torch/tools/bench_back_project.py [--root DIR] [--out FILE]
        [--shapes NAME ...]

Per shape and direction: `ms`, the kernels' own device time per call (the
durations of the call's `back_project_kernel` / `back_project_backward*`
events under torch.profiler, summed per call: every backward first
reduces max |ct| (`back_project_backward_scale`, which also zeroes the
int64 fixed-point accumulator where the design keeps one), then the
window mean's view tiles launch a visible-records pass and the tile
kernel, the bricks of either mode their kernel and the conversion pass
(`back_project_backward_convert`); `parts` splits it
by kernel), with 128 MB written between calls so the tables come from
device memory, as they do in a fragment; only a profiled window with a
record of every launch counts; `call_ms`, the wrapper's time per call
(CUDA events around a run of Python calls); the plain PyTorch version's
and an F.grid_sample yardstick's times (the backward's: autograd of the
yardstick for the same cotangent); and `bound_ms`, the least time the
card could take (the coordinate list's counts its rows' coordinates and
valid flags too).
`--root` names the checkout whose eprecon_tpu_torch is timed (default:
the one holding this file), so that two versions of the kernel can be
timed on one card: run this file as a script, once per root. `--shapes`
times only the named shapes (default: all five). chip_smoke.py uses the
same cases and also holds the kernel against the plain version.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
FLUSH_BYTES = 128 << 20     # written between timed launches; L2 is 50 MB
WINDOWS = 3                 # profiled windows tried per device time
KERNEL = "back_project_kernel"
BACKWARD_KERNEL = "back_project_backward"  # every kernel of the backward

# (name, window dim, interval, proj scale, feature h, w, channels); the
# first is the occupancy-init variance over its dense grid (the window form
# the model calls), the others the stage windows' means
SHAPES = [("occ_init_variance", (48, 48, 48), 2, 1, 60, 80, 32),
          ("stage0_window", (24, 24, 24), 4, 2, 30, 40, 80),
          ("stage1_window", (48, 48, 48), 2, 1, 60, 80, 40),
          ("stage2_window", (96, 96, 96), 1, 0, 120, 160, 24)]
# the occupancy-init variance's rows passed as the JAX signature's
# coordinate list (runs of rows both ways): a case of its own, after the
# window's, on the same features and cotangent
LIST_CASE = "occ_init_variance_list"


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
    projections: int   # passes that project every (voxel, view)
    backward: Callable = None           # the backward kernel's wrapper
    backward_plain: Callable = None
    backward_library: Callable = None   # autograd of the yardstick
    backward_bytes: int = 0
    backward_ops: Tuple[int, int] = (0, 0)  # per visible pair x channel, per voxel x channel
    backward_exponent: Callable = None  # the plain version's fixed-point (e, nan)
    # the public function forward and torch.autograd.grad for the
    # cotangent: the table's gradient as a user receives it (the
    # coordinate list's path)
    autograd: Callable = None

    @property
    def rows(self) -> bool:  # a coordinate list
        return len(self.extent) == 1

    def bound(self, v: int, direction: str = "forward"):
        """(least ms, what bounds it): bytes over 3.35 TB/s, f32
        operations over 67 TFLOP/s, the larger."""
        if direction == "forward":
            nbytes, per_vis, per_vox, proj = (self.bytes_, self.ops_per_visible,
                                              self.ops_per_voxel, 1)
        else:
            nbytes, (per_vis, per_vox), proj = (self.backward_bytes,
                                                self.backward_ops,
                                                self.projections)
        ops = (proj * self.n * v * 22 + self.visible * self.c * per_vis
               + self.n * self.c * per_vox)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
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
    fragment's cameras, the variance's followed by its rows as a
    coordinate list (LIST_CASE)."""
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
        args = (dim, interval, origin, 0.04, feats, proj)
        if variance:
            run = lambda args=args, **kw: bp.back_project_variance_window(*args, **kw)
            plain = lambda args=args: bp.back_project_variance_window_plain(*args)
            mode, ops = bp.VARIANCE, (11, 4)
        else:
            run = lambda args=args, **kw: bp.back_project_window(*args, **kw)
            plain = lambda args=args: bp.back_project_window_plain(*args)
            mode, ops = bp.WINDOW_MEAN, (9, 1)
        count = plain()[1].reshape(-1).contiguous()
        visible = int(count.sum().item())
        feats_f32 = feats[:, 0].permute(0, 3, 1, 2).float().contiguous()
        library = (lambda f=feats_f32, p=proj[:, 0].float(), wo=world, h=h, w=w,
                   var=variance: yardstick(f, p, wo, h, w, var))
        nbytes = v * h * w * c * 2 + v * 64 + 12 + n * c * 2 + n * 4
        case = Case(name, mode, dim, h, w, n, c, run, plain, library, nbytes,
                    visible, *ops, 2 if variance else 1)
        # the cotangent is drawn for every checkout, so that --root A/B runs
        # see the same features
        ct = torch.randn(n, c, device=dev, generator=gen).to(torch.bfloat16)
        add_backward(case, feats, proj, origin, count, world, dim, interval, ct)
        out.append(case)
        if variance:
            coords, valid = bp._window_rows(dim, interval, dev)
            listed = (coords, valid, origin, 0.04, feats, proj)
            case = dataclasses.replace(
                case, name=LIST_CASE, extent=(n,),
                run=lambda a=listed, **kw: bp.back_project_variance(*a, **kw),
                plain=lambda a=listed: bp.back_project_variance_plain(*a),
                bytes_=nbytes + n * 16 + n)
            add_backward(case, feats, proj, origin, count, world, dim, interval,
                         ct, coords, valid)
            out.append(case)
    return out


def add_backward(case: Case, feats, proj, origin, count, world, dim, interval,
                 ct, coords=None, valid=None):
    """The backward kernel, its plain version and the yardstick's autograd
    for the bf16 cotangent ct, and the backward's bytes and operations;
    for the variance's coordinate list (coords, valid) also the public
    function through autograd."""
    import torch
    from eprecon_tpu_torch.ops import back_project as bp

    v, h, w, n, c = proj.shape[0], case.h, case.w, case.n, case.c
    variance = case.mode == bp.VARIANCE
    proj16 = proj.float().reshape(v, 1, 16).contiguous()
    if coords is not None:
        case.backward = functools.partial(
            bp._launch_backward, bp.VARIANCE, feats.reshape(v, h * w, c),
            proj16, origin, ct, count, v, h, w, None, 1, 0.04,
            coords=coords, valid=valid.to(torch.uint8))
        case.backward_plain = functools.partial(
            bp.variance_backward_plain, coords, valid, origin, 0.04, feats,
            proj, count, ct)

        def through_autograd():
            f = feats.detach().requires_grad_(True)
            out, _ = bp.back_project_variance(coords, valid, origin, 0.04, f,
                                              proj)
            return torch.autograd.grad(out, f, ct)[0]

        case.autograd = through_autograd
        # ct, count, the table, the rows' coordinates and valid flags
        nbytes = n * c * 2 + n * 4 + v * h * w * c * 2 + n * 16 + n
        case.backward_ops = (28, 6)
    elif variance:
        case.backward = functools.partial(
            bp._launch_backward, bp.VARIANCE, feats.reshape(v, h * w, c),
            proj16, origin, ct, count, v, h, w, dim, interval, 0.04)
        case.backward_plain = functools.partial(
            bp.variance_window_backward_plain, dim, interval, origin, 0.04,
            feats, proj, count, ct)
        # ct, count, the table
        nbytes = n * c * 2 + n * 4 + v * h * w * c * 2
        case.backward_ops = (28, 6)
    else:
        case.backward = functools.partial(
            bp._launch_backward, bp.WINDOW_MEAN, None, proj16, origin, ct,
            count, v, h, w, dim, interval, 0.04)
        case.backward_plain = functools.partial(
            bp.window_backward_plain, dim, interval, origin, 0.04, proj,
            count.reshape(dim), ct.reshape(*dim, c), h, w)
        nbytes = n * c * 2 + n * 4
        case.backward_ops = (8, 1)
    # projections, origin, and dT written once in f32: what the function
    # needs, whatever the design adds in between
    case.backward_bytes = nbytes + v * 64 + 12 + v * h * w * c * 4
    case.backward_exponent = functools.partial(
        bp.fixed_point_exponent, n, ct.float().abs().amax(),
        *((feats.float().abs().amax(), v) if variance else ()))
    f_lib = feats[:, 0].permute(0, 3, 1, 2).float().contiguous().requires_grad_(True)
    lib_out = yardstick(f_lib, proj[:, 0].float(), world, h, w, variance)[0]
    case.backward_library = functools.partial(
        torch.autograd.grad, lib_out, f_lib, ct.float().T.contiguous(),
        retain_graph=True)


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


def kernel_name(name: str) -> str:
    """A profiler event's kernel, without namespace and arguments:
    `back_project_backward_tile<true, 4>`."""
    m = re.search(r"(back_project\w*(<[^>()]*>)?)", name)
    return m.group(1) if m else name


def _records(prof, kernel: str):
    return [e for e in prof.events()
            if kernel in e.name and "CUDA" in str(e.device_type)]


def device_ms(fn, iters: int, kernel: str = KERNEL
              ) -> Tuple[float, int, Dict[str, float]]:
    """Mean device time per call of `fn`: the durations of the KERNEL
    events (every kernel whose name holds it) that `iters` calls launch
    under torch.profiler, each call after a write of FLUSH_BYTES, summed
    per call; the number of profiled windows that took; and the time per
    call of each kernel by name. One call profiled alone gives the kernels
    per call, and only a window with that many records per call counts.
    The profiler has kept fewer records than launches (seldom, cause
    unknown): such a window is dropped whole and the launches profiled
    again, at most WINDOWS times in all, then this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for window in range(1, WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as one:
            flush.fill_(0)
            fn()
            torch.cuda.synchronize()
        per_call = len(_records(one, kernel))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                flush.fill_(i & 255)
                fn()
            torch.cuda.synchronize()
        recs = _records(prof, kernel)
        if per_call > 0 and len(recs) == per_call * iters:
            parts: Dict[str, float] = collections.defaultdict(float)
            for e in recs:
                parts[kernel_name(e.name)] += e.time_range.elapsed_us() / iters / 1e3
            return sum(parts.values()), window, dict(parts)
        print(f"[profiler] kept {len(recs)} {kernel} records of {iters} calls "
              f"x {per_call} kernels; profiling them again", file=sys.stderr,
              flush=True)
    raise AssertionError(f"profiler kept fewer {kernel} records than launches "
                         f"in {WINDOWS} windows of {iters}")


def time_case(case: Case, v: int, direction: str = "forward") -> dict:
    iters = 50 if case.n < 200_000 else 20
    bound, bound_by = case.bound(v, direction)
    run, plain, library, kernel = (
        (case.run, case.plain, case.library, KERNEL) if direction == "forward"
        else (case.backward, case.backward_plain, case.backward_library,
              BACKWARD_KERNEL))
    ms, windows, parts = device_ms(run, iters, kernel)
    return dict(ms=ms, profiler_windows=windows, parts=parts,
                call_ms=cuda_ms(run, iters),
                plain_ms=cuda_ms(plain, max(3, iters // 5)),
                bound_ms=bound, bound_by=bound_by,
                library_ms=cuda_ms(library, max(3, iters // 5)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="checkout whose eprecon_tpu_torch is timed")
    ap.add_argument("--out", type=Path, help="also write the results here")
    ap.add_argument("--shapes", nargs="+",
                    choices=[s[0] for s in SHAPES] + [LIST_CASE],
                    help="time only these shapes")
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
        if args.shapes and case.name not in args.shapes:
            continue
        for direction in ("forward", "backward")[:2 if case.backward else 1]:
            t = time_case(case, v, direction)
            res["shapes"][f"{case.name}/{direction}"] = t
            print(f"[bench] {case.name} {direction}: " + " ".join(
                f"{k}={x:.4f}" if isinstance(x, float) else f"{k}={x}"
                for k, x in t.items()) + f" | {card}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

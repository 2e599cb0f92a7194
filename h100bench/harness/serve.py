"""The streamed-reconstruction cells: the mix's scenes streamed through
`StreamingReconstructor.process_fragment` in order and cycled (one long
scan where the mix has one scene; a scene change ends the scene and
starts the next from an empty state), a fixed number of fragments in
flight, the client timing each fragment from its submission to its
completion event; then the output check against the reference.

The system under test is the port's reconstructor, or (for the control
and the faults, `system`) the reference in its place or the port with a
fault planted underneath.
"""
from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace
from typing import Any, Dict, Optional

import torch

from h100bench.harness import common, weights
from h100bench.harness.common import Record

STATE_FIELDS = ("tsdf", "instance", "semantic", "mask")
OUTPUTS = ("tsdf_window", "occupancy", "pred_logits")


def _window(rel, shape):
    return tuple(slice(int(o), int(o) + int(s)) for o, s in zip(rel, shape))


def _level_window(frag, lv: int, mcfg):
    """Level lv's window of the global map at the fragment's rel_origin."""
    dim = [v // 2 ** (mcfg.n_scales - lv) for v in mcfg.n_vox]
    return _window(frag["rel"][lv], dim)


def gmap_windows(rec_state, frag, mcfg) -> Dict[str, torch.Tensor]:
    """Each level's global-map features and mask in the fragment's window."""
    out = {}
    for lv, g in enumerate(rec_state.gmaps):
        w = _level_window(frag, lv, mcfg)
        out[f"gmap{lv}_feats"], out[f"gmap{lv}_mask"] = g.feats[w], g.mask[w]
    return out


class Capture:
    """Copies of the stream's state and outputs around sampled fragments,
    taken in stream order: a device copy (fast, so the stream barely
    waits), then a copy to pinned host memory on a side stream, so that
    the window's device memory does not grow with the sample."""

    def __init__(self, device):
        self.device = device
        self.side = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.items: Dict[int, Dict[str, Any]] = {}

    def reserve(self, key: int, name: str, tensors: Dict[str, torch.Tensor]):
        """Pinned host buffers for a later `take` of tensors like these,
        allocated now (set-up), not inside the window."""
        if self.side is None:
            return
        self.items.setdefault(key, {})[name] = {
            k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for k, t in tensors.items()}

    def take(self, key: int, name: str, tensors: Dict[str, torch.Tensor]):
        out = self.items.setdefault(key, {}).setdefault(name, {})
        if self.side is None:
            out.update({k: t.detach().clone() for k, t in tensors.items()})
            return
        clones = {k: t.detach().clone() for k, t in tensors.items()}
        ev = torch.cuda.Event()
        ev.record()
        with torch.cuda.stream(self.side):
            self.side.wait_event(ev)
            for k, c in clones.items():
                if k not in out:
                    out[k] = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
                out[k].copy_(c, non_blocking=True)
                c.record_stream(self.side)

    def take_whole(self, key: int, name: str, tensors: Dict[str, torch.Tensor]):
        """Copy the tensors straight into the buffers `reserve` made, on
        the current stream (no device copy: the state is large), which
        orders them before anything later writes there."""
        out = self.items.setdefault(key, {}).setdefault(name, {})
        for k, t in tensors.items():
            if self.side is None:
                out[k] = t.detach().clone()
            else:
                out[k].copy_(t, non_blocking=True)

    def wait(self):
        if self.side is not None:
            self.side.synchronize()


def state_before(rec, frag, mcfg) -> Dict[str, torch.Tensor]:
    """What fragment `frag` reads of the stream's state: each level's
    global-map window at its rel_origin, and the whole panoptic map (its
    per-instance statistics are taken over the whole map)."""
    out = gmap_windows(rec.rec_state, frag, mcfg)
    for k in STATE_FIELDS:
        out[f"pmap_{k}"] = getattr(rec.pmap_state, k)
    out["pmap_next_instance_id"] = rec.pmap_state.next_instance_id
    return out


def state_after(rec, frag, mcfg) -> Dict[str, torch.Tensor]:
    """The fragment's outputs and the state it wrote: the global-map
    windows and the whole panoptic map."""
    return written(rec.last_outputs, rec.rec_state, rec.pmap_state, frag, mcfg)


def written(outputs, rec_state, pmap, frag, mcfg) -> Dict[str, torch.Tensor]:
    """A fragment's outputs, each level's global-map window and the whole
    panoptic map, after it ran; with `frag` None each level's whole
    global map."""
    out = {k: outputs[k] for k in OUTPUTS}
    if frag is None:
        for lv, g in enumerate(rec_state.gmaps):
            out[f"gmap{lv}_feats"], out[f"gmap{lv}_mask"] = g.feats, g.mask
    else:
        out.update(gmap_windows(rec_state, frag, mcfg))
    for k in STATE_FIELDS:
        out[f"pmap_{k}"] = getattr(pmap, k)
    out["pmap_next_instance_id"] = pmap.next_instance_id
    return out


class Stream:
    """The mix's scenes in stream order, cycled: item j is (fragment,
    scene name). `fresh(j)`: the program starts item j from an empty
    state, at the stream's first item and wherever the scene differs from
    the item before's (with one scene the scan goes round in it)."""

    def __init__(self, pool):
        self.flat = [(f, f"scene{s}") for s, frags in enumerate(pool) for f in frags]

    def __getitem__(self, j: int):
        return self.flat[j % len(self.flat)]

    def fresh(self, j: int) -> bool:
        return j == 0 or self[j][1] != self[j - 1][1]


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """The port's per-fragment program with a fault underneath: "answer"
    alters the TSDF where it is produced; "state" returns the stream's
    state unchanged."""
    if fault is None:
        yield
        return
    from eprecon_tpu_torch.inference import pipeline
    real = pipeline.fragment_forward

    def answer(model, cfg, imgs, frag, rec_state, pmap_state, targets=None):
        outputs, losses, rec, pmap = real(model, cfg, imgs, frag, rec_state,
                                          pmap_state, targets)
        outputs["tsdf_window"] = torch.where(
            outputs["occupancy"], outputs["tsdf_window"] + 1e-3,
            outputs["tsdf_window"])
        return outputs, losses, rec, pmap

    def state(model, cfg, imgs, frag, rec_state, pmap_state, targets=None):
        keep = ([(g.feats, g.feats.clone()) for g in rec_state.gmaps]
                + [(g.mask, g.mask.clone()) for g in rec_state.gmaps]
                + [(getattr(pmap_state, k), getattr(pmap_state, k).clone())
                   for k in (*STATE_FIELDS, "next_instance_id")])
        out = real(model, cfg, imgs, frag, rec_state, pmap_state, targets)
        for t, saved in keep:
            t.copy_(saved)
        return out[0], out[1], rec_state, pmap_state

    pipeline.fragment_forward = {"answer": answer, "state": state}[fault]
    try:
        yield
    finally:
        pipeline.fragment_forward = real


def build_system(spec, device, system: str):
    """The reconstructor under test: the port's, or the reference in its
    place in TF32 (the control)."""
    from h100bench.harness import config as hc
    if system in ("control", "reorder"):
        from h100bench.reference.serve_ref import Reconstructor
        mcfg, _ = hc.reference_configs(spec)
        return Reconstructor(mcfg, device, tf32=system == "control",
                             reorder=system == "reorder")
    from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
    from eprecon_tpu_torch.models.eprecon import EPRecon
    cfg = hc.port_config(spec)
    return StreamingReconstructor(cfg, EPRecon(cfg.model, seed=cfg.seed),
                                  device=device)


def serve(rec, frag, scene: str):
    rec.process_fragment(scene, frag["imgs_host"], frag["proj_matrices"],
                         frag["vol_origin_partial"], frag["vol_origin_partial"],
                         frag["world_to_aligned_camera"], anchor=frag["anchor"])


def run(spec: Dict[str, Any], traffic: Dict[str, Any], seed: int,
        seconds: float, trace: bool, device, t_start: float, rank: int = 0,
        system: str = "port", fault: Optional[str] = None,
        ranges: Optional[Dict[str, Any]] = None, sample_span: Optional[int] = None):
    """One run: set-up, the window (or the traced window), then what the
    check needs. Returns (Record, check inputs).

    The check's inputs: the stream's state and outputs around fragments
    drawn from the seed among those the window serves, and the whole
    state after the window's first fragment, which the reference reaches
    by following the stream from its start (the warm-up and that
    fragment) itself."""
    from h100bench.harness import config as hc
    mcfg = hc.port_config(spec).model if system == "port" else hc.reference_configs(spec)[0]
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    pool = common.make_pool(traffic, spec["inputs"], seed, rank, mcfg, device,
                            with_gt=False)
    for frags in pool:
        for f in frags:
            f["imgs_host"] = f["imgs"].cpu().numpy()
            del f["imgs"]
    stream = Stream(pool)
    rec = build_system(spec, device, system)
    sd = weights.seeded_state_dict(rec.model.state_dict(), seed, device)
    rec.model.load_state_dict(sd)
    cap = Capture(device)
    warm, in_flight = int(traffic["warmup"]), int(traffic["in_flight"])
    with planted(fault):
        for j in range(warm):          # every shape the window uses
            serve(rec, *stream[j])
            sync()
        record = Record(program="serve", views=int(spec["inputs"]["views"]), setup_s=0.0)
        if trace:
            n_items = int(traffic["trace_items"])
            span = n_items
        else:
            n_items = None
            span = int(sample_span or traffic["check_span"])
        sample = set(common.sample_indices(seed, int(traffic["check_sample"]), span))
        frag0 = stream[0][0]
        like_before = state_before(rec, frag0, mcfg)
        like_after = state_after(rec, frag0, mcfg)
        for k in sample:
            cap.reserve(k, "before", like_before)
            cap.reserve(k, "after", like_after)
        cap.reserve(-1, "whole", written(rec.last_outputs, rec.rec_state,
                                         rec.pmap_state, None, mcfg))
        hooks = None
        if trace:
            from h100bench.harness import trace as tr
            hooks = tr.RangeHooks(rec.model, ranges["modules"], ranges["functions"])
            prof_cm = tr.profiled()
        else:
            prof_cm = contextlib.nullcontext()
        subs, evs = [], []
        ev0 = torch.cuda.Event(enable_timing=True) if cuda else None
        with prof_cm as prof:
            if cuda:
                ev0.record()
            sync()
            t0 = time.perf_counter()
            record.setup_s = time.time() - t_start
            i = 0
            while True:
                if n_items is not None and i >= n_items:
                    break
                if i >= in_flight and cuda:
                    evs[i - in_flight].synchronize()
                if (n_items is None and i > 0
                        and time.perf_counter() - t0 >= seconds):
                    break
                frag, scene = stream[warm + i]
                if i in sample and not stream.fresh(warm + i):
                    cap.take(i, "before", state_before(rec, frag, mcfg))
                subs.append(time.perf_counter())
                serve(rec, frag, scene)
                if cuda:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    evs.append(ev)
                else:
                    evs.append(time.perf_counter())
                if i in sample:
                    cap.take(i, "after", state_after(rec, frag, mcfg))
                if i == 0:
                    cap.take_whole(-1, "whole", written(
                        rec.last_outputs, rec.rec_state, rec.pmap_state, None, mcfg))
                i += 1
            sync()
            t_end = time.perf_counter()
        cap.wait()
        if hooks is not None:
            hooks.remove()
    done = [t0 + ev0.elapsed_time(e) / 1e3 for e in evs] if cuda else evs
    record.latencies_s = [d - s for d, s in zip(done, subs)]
    record.attempted = len(subs)
    if trace:
        record.window_s = t_end - t0
        record.completed = len(subs)
        from h100bench.harness import trace as tr
        record.trace = tr.summarize(prof, len(subs), record.window_s)
    else:
        record.window_s = float(seconds)
        record.completed = sum(d <= t0 + seconds for d in done)
    record.peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    items = [dict(frag=stream[warm + k][0], fresh=stream.fresh(warm + k),
                  before=v.get("before"), after=v["after"])
             for k, v in sorted(cap.items.items()) if 0 <= k < len(subs)]
    prefix = [stream[j] for j in range(warm + 1)]
    check = dict(items=items, prefix=prefix, whole=cap.items[-1]["whole"], sd=sd,
                 pool_first=frag0, mcfg_spec=spec)
    del rec
    common.free_cuda()
    return record, check


def numbers(check: Dict[str, Any], device) -> Dict[str, float]:
    from h100bench.harness.check import serve_numbers
    return serve_numbers(check, device)


def costs(spec: Dict[str, Any], check: Dict[str, Any], device):
    """(model FLOPs, least back-projection seconds) of one fragment."""
    from h100bench.harness import bp_cost, config as hc, flops
    mcfg, _ = hc.reference_configs(spec)
    frag = check["pool_first"]
    fl = flops.forward_flops(mcfg, frag, device)
    bound = sum(c.bound_s("forward")[0]
                for c in bp_cost.fragment_calls(mcfg, frag, device))
    common.free_cuda()
    return float(fl), float(bound)


def reference_fragment(model, mcfg, frag, before: Optional[Dict[str, torch.Tensor]],
                       device):
    """The reference's outputs and written state for one fragment, from
    the stream's state as the program held it before (`before`; None for
    a fresh stream)."""
    from h100bench.reference.epr.fragment_io import (FragmentInputs,
                                                     PanopticGlobalDense)
    from h100bench.reference.epr.models.eprecon import make_recurrent_state
    from h100bench.reference.epr.pipeline import fragment_forward
    rec_state = make_recurrent_state(mcfg, device)
    pmap = PanopticGlobalDense.empty(tuple(mcfg.global_extent), device=device)
    if before is not None:
        for lv, g in enumerate(rec_state.gmaps):
            w = _level_window(frag, lv, mcfg)
            g.feats[w] = before[f"gmap{lv}_feats"].to(device)
            g.mask[w] = before[f"gmap{lv}_mask"].to(device)
        for k in (*STATE_FIELDS, "next_instance_id"):
            setattr(pmap, k, before[f"pmap_{k}"].to(device).clone())
    fi = FragmentInputs(
        torch.as_tensor(frag["proj_matrices"], device=device),
        torch.as_tensor(frag["vol_origin_partial"], device=device),
        torch.as_tensor(frag["world_to_aligned_camera"], device=device),
        torch.as_tensor(frag["rel"], device=device))
    imgs = torch.as_tensor(frag["imgs_host"], device=device)
    outputs, _, new_rec, new_pmap = fragment_forward(
        model, SimpleNamespace(model=mcfg), imgs, fi, rec_state, pmap)
    return written(outputs, new_rec, new_pmap, frag, mcfg)


def reference_prefix(sd, mcfg, prefix, device) -> Dict[str, torch.Tensor]:
    """The reference's outputs and whole state after following the stream
    from its start over `prefix` ((fragment, scene) in stream order) with
    its own state, as the reference reconstructor (TF32 off)."""
    from h100bench.reference.serve_ref import Reconstructor
    ref = Reconstructor(mcfg, device)
    ref.model.load_state_dict(sd)
    for frag, scene in prefix:
        serve(ref, frag, scene)
    return written(ref.last_outputs, ref.rec_state, ref.pmap_state, None, mcfg)

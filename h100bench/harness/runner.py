"""A cell's run from its BENCHMARK.json entry: the configuration, traffic
and metrics it names, in this process or, for a mix of several ranks, in
one spawned process per card (nccl over localhost); then the result
line's content."""
from __future__ import annotations

import dataclasses
import json
import math
import multiprocessing
import os
import signal
import socket
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import Any, Dict, List

from h100bench.harness import check, manifest as mf
from h100bench.harness.common import ROOT, Record, card_line

RANK_SLACK_S = 900.0   # set-up, compilation and the check, past the window


def _values(readers, rec: Record) -> Dict[str, float]:
    out = {}
    for name, r in readers.items():
        v = r.read(rec)
        if v is not None:
            out[name] = float(v)
    return out


def _setup(manifest, cell, trace: bool, micro: bool = False):
    """The cell's configuration, traffic, metric readers and units; with
    `micro` (the CPU tests) at the micro size."""
    spec = mf.read_json(ROOT / mf.config_entry(manifest, cell["config"])["file"])
    traffic = mf.traffic(cell["traffic"])
    if micro:
        from h100bench.harness import micro as mc
        spec, traffic = mc.micro_spec(spec), mc.micro_traffic(traffic)
    entries = mf.metrics_for(manifest, cell["name"], trace)
    readers = {m["name"]: mf.reader(m["name"]) for m in entries}
    units = {m["name"]: m["unit"] for m in entries}
    return spec, traffic, readers, units


def worst_numbers(per_rank: List[Dict[str, Any]], limits: Dict[str, float]
                  ) -> Dict[str, Any]:
    """Every rank's check in one: each compared number at its worst over
    the ranks (missing or non-finite on any rank: NaN), every other entry
    from the rank that is furthest past its limits."""
    if len(per_rank) == 1:
        return per_rank[0]

    def finite(x):
        return isinstance(x, (int, float)) and math.isfinite(x)

    def badness(n):
        out = 0.0
        for k, lim in limits.items():
            x = n.get(k)
            if not finite(x):
                return math.inf
            out = max(out, x / lim if lim > 0 else (math.inf if x > 0 else 0.0))
        return out

    worst = max(range(len(per_rank)), key=lambda r: badness(per_rank[r]))
    out = dict(per_rank[worst], worst_rank=float(worst))
    for k in limits:
        xs = [n.get(k) for n in per_rank]
        out[k] = max(xs) if all(finite(x) for x in xs) else float("nan")
    return out


def run(manifest, cell, seed: int, seconds: float, trace: bool,
        t_start: float, micro: bool = False, system: str = "port",
        fault=None) -> Dict[str, Any]:
    """The cell's result line's content, with `numbers` (what the check
    compared) and `forbidden` (modules of JAX or the JAX package that a
    rank held after its window; this process's own are the caller's to
    look for). `micro`, `system` and `fault` serve the tests and the
    calibration (`cell.run`, `rank_main`)."""
    import torch
    spec, traffic, readers, units = _setup(manifest, cell, trace, micro)
    world = int(traffic.get("ranks", 1))
    if world == 1:
        from h100bench.harness import cell as one
        if micro:
            dev, kind = torch.device("cpu"), "cpu"
        else:
            dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)
            kind = torch.cuda.get_device_name(0)
        ranges = mf.ranges(readers.values()) if trace else None
        record, numbers = one.run(spec, traffic, seed, seconds, trace, dev,
                                  t_start, system=system, fault=fault,
                                  ranges=ranges)
        values = _values(readers, record)
        ranks = [dict(record=record, numbers=numbers, values=values, forbidden=[])]
    else:
        ranks = _run_ranks(cell, seed, seconds, trace, t_start, world, system,
                           fault, micro)
        kind = ranks[0]["kind"]
        record = ranks[0]["record"]
        record.ranks = world
        record.window_s = max(r["record"].window_s for r in ranks)
        record.peak_bytes = max(r["record"].peak_bytes for r in ranks)
        record.setup_s = max(r["record"].setup_s for r in ranks)
        values = _values(readers, record)
        if trace:   # each rank's reading, averaged over the cards
            values = {}
            for name in readers:
                got = [r["values"][name] for r in ranks if name in r["values"]]
                if got:
                    values[name] = sum(got) / len(got)
    limits = check.limits_for(cell["name"])
    numbers = worst_numbers([r["numbers"] for r in ranks], limits)
    correct, compared = check.judge(numbers, limits)
    peak = max(r["record"].peak_bytes for r in ranks)
    device = dict(platform="gpu", kind=kind, count=world, memory_peak_bytes=int(peak),
                  card=card_line())
    out: Dict[str, Any] = dict(
        correct=bool(correct),
        attempted=sum(r["record"].attempted for r in ranks),
        failed=0,
        metrics={k: dict(value=v, unit=units[k]) for k, v in values.items()},
        device=device)
    if trace:
        ts = [r["record"].trace for r in ranks]
        device["busy_s"] = sum(t.busy_s for t in ts) / len(ts)
        device["window_s"] = sum(t.window_s for t in ts) / len(ts)
        out["breakdown"] = dict(
            device_ops=[[n, s] for n, s in ts[0].device_ops],
            idle_gaps=[[n, s] for n, s in ts[0].idle_gaps])
    out["numbers"] = numbers
    out["forbidden"] = sorted({m for r in ranks for m in r["forbidden"]})
    out["compared"] = compared
    return out


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(cell, seed, seconds, trace, t_start, world, system: str = "port",
               fault=None, micro: bool = False) -> List[Dict[str, Any]]:
    """One spawned process per card; each writes its result to a file in
    a directory of TMPDIR, which this process reads and removes. A rank
    that has not ended `RANK_SLACK_S` past the window's length is ended,
    with the others, and the run fails."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="h100bench-ranks-") as tmp:
        procs = [ctx.Process(target=rank_main,
                             args=(r, world, port, cell["name"], seed, seconds,
                                   trace, t_start, tmp, system, fault, micro))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + seconds + RANK_SLACK_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise RuntimeError(f"ranks {hung} had not ended {RANK_SLACK_S} s "
                               f"past the window's length")
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} failed "
                               f"(exit codes {[procs[r].exitcode for r in bad]})")
        out = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.json") as f:
                d = json.load(f)
            d["record"] = _record_from(d["record"])
            out.append(d)
        return out


def _record_from(d: Dict[str, Any]) -> Record:
    from h100bench.harness.trace import TraceSummary
    tr = d.pop("trace")
    rec = Record(**d)
    if tr is not None:
        tr["device_ops"] = [tuple(x) for x in tr["device_ops"]]
        tr["idle_gaps"] = [tuple(x) for x in tr["idle_gaps"]]
        rec.trace = TraceSummary(**tr)
    return rec


def _die_with_parent():
    """Have the kernel end this rank if the process that spawned it ends
    (Linux), so that no rank outlives a run that was killed."""
    try:
        import ctypes
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def rank_main(rank: int, world: int, port: int, workload: str, seed: int,
              seconds: float, trace: bool, t_start: float, out_dir: str,
              system: str = "port", fault=None, micro: bool = False):
    """A rank's process: join the group, run the cell, check, look for
    modules of JAX or the JAX package, write. `fault` "jax" (the tests)
    plants a module named jax in the last rank instead of a fault in the
    step."""
    _die_with_parent()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch
    from eprecon_tpu_torch.parallel import mesh
    from h100bench.harness import cell as one
    from h100bench.harness.modules import forbidden_modules
    if fault == "jax":
        if rank == world - 1:
            sys.modules.setdefault("jax", types.ModuleType("jax"))
        fault = None
    manifest = mf.load(ROOT)
    c = mf.workload(manifest, workload)
    spec, traffic, readers, _ = _setup(manifest, c, trace, micro)
    ranges = mf.ranges(readers.values()) if trace else None
    if micro:
        torch.set_num_threads(2)
        dev = mesh.initialize_distributed("gloo", "cpu")
    else:
        dev = mesh.initialize_distributed("nccl", "cuda")
    try:
        record, numbers = one.run(spec, traffic, seed, seconds, trace, dev,
                                  t_start, rank=rank, system=system, fault=fault,
                                  ranges=ranges)
        values = _values(readers, record)
        d = dataclasses.asdict(record)
        kind = "cpu" if micro else torch.cuda.get_device_name(dev)
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(dict(record=d, numbers=numbers, values=values, kind=kind,
                           forbidden=forbidden_modules()), f)
    finally:
        mesh.shutdown_distributed()

"""BENCHMARK.json and the files it names: a configuration is
`h100bench/configs/<config>.json`, a traffic mix `h100bench/traffic/
<traffic>.json` (with `traffic/<traffic>.py` where it brings its own
program), a metric `h100bench/metrics/<name>.py` (a `read(record)`
returning a number or None, its `UNIT`, and optionally the `RANGES` its
traced run needs), a cell's output limits `h100bench/limits/<workload>
.json`. A later change adds a configuration, mix, metric or cell by
adding such files and entries; nothing here needs an edit."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List

from h100bench.harness.common import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_for(manifest: Dict[str, Any], cell: str, trace: bool
                ) -> List[Dict[str, Any]]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those listing the cell, or listing no cells."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def traffic(name: str, bench: Path = BENCH) -> Dict[str, Any]:
    """The mix's parameters, with its name under `mix`."""
    return dict(read_json(bench / "traffic" / f"{name}.json"), mix=name)


def _load(path: Path, prefix: str, name: str):
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench: Path = BENCH):
    """The metric's reader module, loaded from its file."""
    return _load(bench / "metrics" / f"{name}.py", "h100bench_metric_", name)


PROGRAM = ("run", "numbers", "costs")


def program(traffic: Dict[str, Any], bench: Path = BENCH):
    """The mix's program: `traffic/<mix>.py` where the mix brings its own,
    else `harness/<program>.py` for its `program` key. A program has
    `run(spec, traffic, seed, seconds, trace, device, t_start, rank=,
    system=, fault=, ranges=, sample_span=)` -> (Record, check inputs),
    `numbers(check inputs, device)` -> the numbers compared, and
    `costs(spec, check inputs, device)` -> one item's (model FLOPs,
    least back-projection seconds)."""
    own = bench / "traffic" / f"{traffic['mix']}.py"
    if own.is_file():
        mod = _load(own, "h100bench_traffic_", traffic["mix"])
    else:
        name = str(traffic.get("program"))
        if not NAME.match(name) or not (bench / "harness" / f"{name}.py").is_file():
            raise ValueError(f"traffic {traffic['mix']!r}: no program {name!r} "
                             f"(harness/<program>.py or traffic/<mix>.py)")
        mod = importlib.import_module(f"h100bench.harness.{name}")
    missing = [a for a in PROGRAM if not callable(getattr(mod, a, None))]
    if missing:
        raise ValueError(f"traffic {traffic['mix']!r}: its program lacks {missing}")
    return mod


def ranges(readers) -> Dict[str, Dict[str, List[str]]]:
    """The union of the readers' RANGES."""
    out: Dict[str, Dict[str, List[str]]] = {"modules": {}, "functions": {}}
    for r in readers:
        for kind in out:
            for label, names in getattr(r, "RANGES", {}).get(kind, {}).items():
                out[kind].setdefault(label, [])
                out[kind][label] += [n for n in names
                                     if n not in out[kind][label]]
    return out

"""BENCHMARK.json against the benchmark's contract, and the files it names;
a configuration, traffic mix and metric added as files in a copy are found
without an edit to any file that is there."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100bench.harness import manifest as mf  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return mf.load(ROOT)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == KEYS
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_configs(manifest):
    names = [c["name"] for c in manifest["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        assert (ROOT / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in used
        spec = json.loads((ROOT / c["file"]).read_text())
        assert spec["name"] == c["name"] and spec["reduced"] == c["reduced"]


def test_workloads(manifest):
    cells = manifest["workloads"]
    assert 1 <= len(cells) <= 24
    names = [w["name"] for w in cells]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    assert [w["name"] for w in four] == ["train-ddp4"]
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (ROOT / "h100bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "h100bench" / "limits" / f"{w['name']}.json").is_file()
        traffic = mf.traffic(w["traffic"])
        assert int(traffic.get("ranks", 1)) == w["chips"]


def _reported(manifest, metric, cell):
    return cell in metric.get("workloads", [w["name"] for w in manifest["workloads"]])


def test_metrics(manifest):
    e2e, pl = manifest["end_to_end"], manifest["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(pl) <= 128
    names = [m["name"] for m in e2e + pl]
    assert len(set(names)) == len(names)
    assert "setup_s" in [m["name"] for m in e2e]
    cells = [w["name"] for w in manifest["workloads"]]
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in pl:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert _line(m["layer"])
        moved = [x for x in e2e if x["name"] == m["moves"]]
        assert moved, f"{m['name']} moves no end-to-end metric"
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reported(manifest, moved[0], cell), (m["name"], cell)
    for m in e2e + pl:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "h100bench" / "metrics" / f"{m['name']}.py").is_file()
        assert mf.reader(m["name"]).UNIT == m["unit"]
    for cell in cells:   # setup_s, another end-to-end metric, a per-layer one
        got = [m["name"] for m in e2e if _reported(manifest, m, cell)]
        assert "setup_s" in got and len(got) >= 2
        assert any(_reported(manifest, m, cell) for m in pl)
    # one layer name per layer, letter for letter, for the issue's table
    layers = {m["layer"] for m in pl}
    assert {"device", "kernels", "whole step", "collective"} <= layers


def test_files_are_named_from_names():
    for p in (ROOT / "h100bench").rglob("*"):
        if p.is_file() and ".cache" not in p.parts and "__pycache__" not in p.parts:
            rel = p.relative_to(ROOT).as_posix()
            assert PATH.match(rel), rel


def test_added_config_mix_and_metric_are_found(tmp_path):
    """Copy the benchmark, add one file of each kind and the entries that
    name them; nothing that was there is edited, and a run of the new
    cell (micro size, on the CPU) reads the new metric."""
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "h100bench").rglob("*") if p.is_file()}
    b = tmp_path / "h100bench"
    spec = json.loads((b / "configs" / "eprecon-scannet-test.json").read_text())
    spec["name"] = "eprecon-added"
    (b / "configs" / "eprecon-added.json").write_text(json.dumps(spec))
    mix = json.loads((b / "traffic" / "scan.json").read_text())
    mix["in_flight"] = 1
    (b / "traffic" / "scan-added.json").write_text(json.dumps(mix))
    (b / "metrics" / "served_items.py").write_text(
        'UNIT = "fragments"\n\n\ndef read(rec):\n    return float(rec.completed)\n')
    (b / "limits" / "added-cell.json").write_text(
        (b / "limits" / "serve-scan.json").read_text())
    man["configs"].append(dict(name="eprecon-added", source="https://arxiv.org/abs/2409.01807",
                               file="h100bench/configs/eprecon-added.json", reduced=[],
                               why="added"))
    man["workloads"].append(dict(name="added-cell", config="eprecon-added",
                                 traffic="scan-added", chips=1, why="added"))
    man["end_to_end"].append(dict(name="served_items", unit="fragments",
                                  better="higher", bound=0.05, source="host_clock",
                                  workloads=["added-cell"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data
    code = f"""
import json, sys, time
sys.path.insert(0, {str(tmp_path)!r})
sys.path.append({str(ROOT)!r})   # the port, which the copy does not hold
import torch
torch.set_num_threads(2)
from h100bench.harness import manifest as mf, cell, micro, runner
from h100bench.harness.common import ROOT
assert str(ROOT) == {str(tmp_path)!r}, ROOT
man = mf.load(ROOT)
w = mf.workload(man, "added-cell")
spec, traffic, readers, units = runner._setup(man, w, False)
assert "served_items" in readers and traffic["in_flight"] == 1
rec, nums = cell.run(micro.micro_spec(spec), micro.micro_traffic(traffic), 7, 1.0,
                     False, torch.device("cpu"), time.time())
print(json.dumps(runner._values(readers, rec)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    values = json.loads(out.stdout.strip().splitlines()[-1])
    assert "served_items" in values


def test_a_mix_that_brings_its_own_program_is_found(tmp_path):
    """A mix added as `traffic/<mix>.json` with `traffic/<mix>.py` runs the
    program its file brings (here the serving program, its numbers
    marked), found by the mix's name, in a copy with nothing edited."""
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = tmp_path / "h100bench"
    (b / "traffic" / "scan-own.json").write_text((b / "traffic" / "scan.json").read_text())
    (b / "traffic" / "scan-own.py").write_text(
        '"""The serving program, its numbers marked."""\n'
        "from h100bench.harness import serve\n\n"
        "run, costs = serve.run, serve.costs\n\n\n"
        "def numbers(check, device):\n"
        "    return dict(serve.numbers(check, device), own_program=1.0)\n")
    code = f"""
import json, sys, time
sys.path.insert(0, {str(tmp_path)!r})
sys.path.append({str(ROOT)!r})   # the port, which the copy does not hold
import torch
torch.set_num_threads(2)
from h100bench.harness import manifest as mf, cell, micro
traffic = mf.traffic("scan-own")
assert mf.program(traffic).__file__.endswith("traffic/scan-own.py")
assert mf.program(mf.traffic("scan")).__name__ == "h100bench.harness.serve"
spec = mf.read_json(mf.BENCH / "configs" / "eprecon-scannet-test.json")
rec, nums = cell.run(micro.micro_spec(spec), micro.micro_traffic(traffic), 7, 1.0,
                     False, torch.device("cpu"), time.time())
print(json.dumps(nums))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["own_program"] == 1.0


@pytest.mark.parametrize("program", ["nope", "../run", "common"])
def test_an_unknown_program_is_refused(program):
    """A mix whose `program` names no program module, and that brings no
    file of its own, is refused before anything runs."""
    with pytest.raises(ValueError):
        mf.program({"mix": "no-such-mix", "program": program})

"""The output check fails a broken timed path: each fault a cell can
have, planted under a run at the micro size on the CPU (the card's look
skipped), makes `correct` false against the cell's limits, where the
sound run passes. The control (the reference in the program's place in
TF32) is a `cuda` test: TF32 exists only on the card."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100bench.harness import cell, check, manifest as mf, micro, runner  # noqa: E402


def _cell(workload):
    man = mf.load(ROOT)
    w = mf.workload(man, workload)
    spec = micro.micro_spec(mf.read_json(ROOT / mf.config_entry(man, w["config"])["file"]))
    return spec, micro.micro_traffic(mf.traffic(w["traffic"])), check.limits_for(workload)


def _correct(workload, fault, system="port", device="cpu", seed=13):
    torch.set_num_threads(4)
    spec, traffic, limits = _cell(workload)
    _, numbers = cell.run(spec, traffic, seed, 2.0, False, torch.device(device),
                          time.time(), system=system, fault=fault)
    return check.judge(numbers, limits)


@pytest.mark.parametrize("workload,fault", [
    ("serve-scan", None), ("serve-scan", "answer"), ("serve-scan", "state"),
    ("train-step", None), ("train-step", "state"), ("train-step", "half")])
def test_a_fault_makes_correct_false(workload, fault):
    ok, compared = _correct(workload, fault)
    assert ok == (fault is None), compared


def _ranks(fault, seed=21):
    """The four-chip cell through the runner at the micro size: 2 gloo
    ranks, spawned as on the card, every rank's check judged."""
    man = mf.load(ROOT)
    return runner.run(man, mf.workload(man, "train-ddp4"), seed, 0.5, False,
                      time.time(), micro=True, fault=fault)


@pytest.mark.parametrize("fault", [None, "exchange", "state", "half"])
def test_ranks_fault_makes_correct_false(fault):
    """The four-chip mix on two gloo ranks: leaving the exchange out (or
    the other faults) fails; the sound run passes."""
    out = _ranks(fault)
    assert out["correct"] == (fault is None), out["compared"]
    assert out["attempted"] >= 2 * 4 and out["forbidden"] == []


def test_a_rank_that_loads_jax_fails_the_run(capsys):
    """A module named jax in one rank's process (the last), after its
    window: the runner reports it, and the entry point prints no result
    and exits 3, though the check passed."""
    from h100bench.run import finish
    out = _ranks("jax")
    assert out["correct"] and out["forbidden"] == ["jax"]
    assert finish(out) == 3
    got = capsys.readouterr()
    assert got.out == "" and "['jax']" in got.err


def test_the_worst_rank_is_judged():
    """A rank past a limit fails the run whatever the others read, and a
    number missing on one rank is NaN."""
    limits = {"a": 1.0, "b": 0.0}
    ranks = [dict(a=0.5, b=0.0, note="r0"), dict(a=2.0, b=0.0, note="r1")]
    got = runner.worst_numbers(ranks, limits)
    assert got["a"] == 2.0 and got["note"] == "r1" and got["worst_rank"] == 1.0
    assert not check.judge(got, limits)[0]
    got = runner.worst_numbers([dict(a=0.5, b=0.0), dict(b=0.0)], limits)
    assert got["a"] != got["a"] and not check.judge(got, limits)[0]
    assert check.judge(runner.worst_numbers([dict(a=0.5, b=0.0)] * 2, limits),
                       limits)[0]


@pytest.mark.parametrize("fault", [None, "state"])
def test_scene_changes_are_followed(fault):
    """A serving mix of two scenes: the stream changes scene in the
    reference's replay and inside the window, the program starts each
    from an empty state, and the check follows (sound: correct; the state
    fault: not)."""
    torch.set_num_threads(4)
    spec, traffic, limits = _cell("serve-scan")
    traffic.update(scenes=2, fragments_per_scene=2, warmup=3, check_sample=3,
                   check_span=4)
    _, numbers = cell.run(spec, traffic, 17, 2.0, False, torch.device("cpu"),
                          time.time(), fault=fault)
    assert numbers["replayed"] == 4   # the warm-up and the window's first
    ok, compared = check.judge(numbers, limits)
    assert ok == (fault is None), compared


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["serve-scan", "train-step"])
def test_control_makes_correct_false_on_the_card(workload):
    """The reference in the program's place, computed in TF32 (the
    precision below the configuration's TF32-off float32): not correct."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on an NVIDIA card")
    ok, compared = _correct(workload, None, system="control", device="cuda")
    assert not ok, compared
    ok, compared = _correct(workload, None, device="cuda")
    assert ok, compared

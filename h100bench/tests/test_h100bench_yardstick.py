"""The yardstick's pieces on the CPU: what the runner and the reference
import, the FLOP count, the back-projection bounds against the port's
bench, and the frozen reference against the port's CPU path."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100bench.harness import bp_cost, flops, manifest as mf, micro, weights  # noqa: E402
from h100bench.harness import common  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "eprecon_tpu"}


def _spec(cfg_name):
    man = mf.load(ROOT)
    return micro.micro_spec(mf.read_json(ROOT / mf.config_entry(man, cfg_name)["file"]))


def _top_names(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_jax_or_the_port():
    names = _top_names(
        "import json, sys, pkgutil, importlib\n"
        "sys.path.insert(0, '.')\n"
        "import h100bench.reference as r\n"
        "for m in pkgutil.walk_packages(r.__path__, 'h100bench.reference.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    assert not names & (FORBIDDEN | {"eprecon_tpu_torch"})


def test_runner_imports_nothing_of_jax_in_a_run():
    """The runner, every harness module and metric reader, and a whole
    micro-size cell on the CPU (the card's look skipped): no module whose
    top-level name is JAX's or the JAX package's, compared whole."""
    names = _top_names(
        "import json, sys, time, pkgutil, importlib\n"
        "sys.path.insert(0, '.')\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import h100bench.run, h100bench.harness as h\n"
        "for m in pkgutil.walk_packages(h.__path__, 'h100bench.harness.'):\n"
        "    importlib.import_module(m.name)\n"
        "from h100bench.harness import manifest as mf, cell, micro\n"
        "from h100bench.harness.common import ROOT\n"
        "man = mf.load(ROOT)\n"
        "for m in man['end_to_end'] + man['per_layer']:\n"
        "    mf.reader(m['name'])\n"
        "w = mf.workload(man, 'serve-scan')\n"
        "spec = micro.micro_spec(mf.read_json(ROOT / mf.config_entry(man, w['config'])['file']))\n"
        "cell.run(spec, micro.micro_traffic(mf.traffic(w['traffic'])), 5, 1.0, True,\n"
        "         torch.device('cpu'), time.time(),\n"
        "         ranges=mf.ranges([mf.reader(m['name']) for m in man['per_layer']]))\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    assert "eprecon_tpu_torch" in names
    assert not names & FORBIDDEN


def test_forbidden_modules_compares_top_level_names_whole(monkeypatch):
    from h100bench.run import forbidden_modules
    monkeypatch.setitem(sys.modules, "eprecon_tpu_torch_like", None)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "eprecon_tpu.models", None)
    monkeypatch.setitem(sys.modules, "jax", None)
    assert forbidden_modules() == ["eprecon_tpu.models", "jax"]


def _fragment(spec, seed, with_gt=False):
    from h100bench.harness import config as hc
    mcfg, _ = hc.reference_configs(spec)
    traffic = micro.micro_traffic(mf.traffic("stream"))
    pool = common.make_pool(traffic, spec["inputs"], seed, 0, mcfg,
                            torch.device("cpu"), with_gt)
    return mcfg, pool[0][0]


def test_flops_are_flop_counter_mode_over_the_reference_and_data_free():
    from torch.utils.flop_counter import FlopCounterMode
    from h100bench.reference.epr.fragment_io import FragmentInputs
    from h100bench.reference.epr.models.eprecon import EPRecon, make_recurrent_state
    torch.set_num_threads(4)
    spec = _spec("eprecon-scannet-test")
    mcfg, frag = _fragment(spec, 3)
    dev = torch.device("cpu")
    counted = flops.forward_flops(mcfg, frag, dev)
    model = EPRecon(mcfg)
    model.load_state_dict(weights.seeded_state_dict(model.state_dict(), 9, dev))
    fi = FragmentInputs(torch.as_tensor(frag["proj_matrices"]),
                        torch.as_tensor(frag["vol_origin_partial"]),
                        torch.as_tensor(frag["world_to_aligned_camera"]),
                        torch.as_tensor(frag["rel"]))
    c = FlopCounterMode(display=False)
    with torch.no_grad(), c:
        model(frag["imgs"], fi, make_recurrent_state(mcfg, dev))
    assert counted == c.get_total_flops() > 0
    # static shapes: another scene and other weights count the same
    assert flops.forward_flops(mcfg, _fragment(spec, 4)[1], dev) == counted
    spec_t = _spec("eprecon-scannet-train")
    mcfg_t, frag_t = _fragment(spec_t, 3, with_gt=True)
    from h100bench.harness.train import step_inputs
    _, _, tg = step_inputs(frag_t, dev, ref=True)
    assert (flops.train_step_flops(mcfg_t, frag_t, dev, tg)
            == 3 * flops.forward_flops(mcfg_t, frag_t, dev, tg))


def test_bp_bounds_equal_the_port_bench_at_its_five_shapes(monkeypatch):
    """bp_cost's bytes and operations give Case.bound's numbers for the
    bench's five cases (its shapes and a synthetic fragment's cameras), the
    bench's cases built on the CPU."""
    from eprecon_tpu_torch.data.synthetic import make_fragment
    from eprecon_tpu_torch.tools import bench_back_project as bbp
    torch.set_num_threads(4)
    real_device = torch.device
    monkeypatch.setattr(torch, "device", lambda *a, **k: real_device("cpu"))
    monkeypatch.setattr(bbp, "yardstick",
                        lambda f, p, wo, h, w, var: (f.sum() * 0, None))
    d = make_fragment(n_views=9, image_hw=(480, 640), n_vox=(8, 8, 8), seed=0)
    cases = bbp.cases(d["proj_matrices"], d["vol_origin_partial"])
    monkeypatch.setattr(torch, "device", real_device)
    assert len(cases) == 5
    v = d["proj_matrices"].shape[0]
    for case in cases:
        op = bp_cost.VARIANCE if case.mode == 1 else bp_cost.WINDOW_MEAN
        call = bp_cost.Call(op, case.n, v, case.h, case.w, case.c, case.visible)
        extra = case.n * 16 + case.n if case.rows else 0   # a list's rows
        fwd = call.forward_bytes() + extra
        bwd = call.backward_bytes() + extra
        assert fwd == case.bytes_ and bwd == case.backward_bytes, case.name
        for direction in ("forward", "backward"):
            want = case.bound(v, direction)
            if case.rows:
                continue
            got = call.bound_s(direction)
            assert got[1] == want[1] and got[0] * 1e3 == pytest.approx(want[0], rel=1e-12)


def test_fragment_calls_count_visible_pairs_like_the_plain_version():
    from h100bench.reference.epr.ops.back_project import back_project_window_plain
    spec = _spec("eprecon-scannet-test")
    mcfg, frag = _fragment(spec, 5)
    calls = bp_cost.fragment_calls(mcfg, frag, torch.device("cpu"))
    assert [c.op for c in calls] == [bp_cost.VARIANCE] + [bp_cost.WINDOW_MEAN] * 3
    c = calls[3]    # the finest stage: count from the plain window mean
    feats = torch.zeros(c.v, 1, c.h, c.w, 1)
    proj = torch.as_tensor(frag["proj_matrices"])[:, None, 0]
    _, count = back_project_window_plain(tuple(mcfg.n_vox), 1,
                                         torch.as_tensor(frag["vol_origin_partial"])[None],
                                         mcfg.voxel_size, feats, proj)
    assert int(count.sum()) == c.visible > 0


def test_reference_agrees_with_the_port_on_the_cpu():
    """The frozen copy and the port's CPU path, same weights and inputs:
    one forward bit for bit, and one training step's losses and
    gradients bit for bit."""
    from eprecon_tpu_torch.models.eprecon import (EPRecon as PEPRecon,
                                                  make_recurrent_state as pstate)
    from eprecon_tpu_torch.train.state import Trainer
    from h100bench.harness import config as hc
    from h100bench.harness.train import step_inputs
    from h100bench.reference.train_ref import Trainer as RefTrainer
    torch.set_num_threads(4)
    spec = _spec("eprecon-scannet-train")
    mcfg, frag = _fragment(spec, 6, with_gt=True)
    cfg = hc.port_config(spec)
    dev = torch.device("cpu")
    port = PEPRecon(cfg.model)
    sd = weights.seeded_state_dict(port.state_dict(), 12, dev)
    port.load_state_dict(sd)
    imgs, fi, tg = step_inputs(frag, dev, ref=False)
    ref_trainer = RefTrainer(mcfg, hc.reference_configs(spec)[1], sd, dev)
    rimgs, rfi, rtg = step_inputs(frag, dev, ref=True)
    with torch.no_grad():
        out_p, _, _ = port.eval()(imgs, fi, pstate(cfg.model, dev))
        out_r, _, _ = ref_trainer.model.eval()(rimgs, rfi, ref_trainer.recurrent_state())
    for k in ("tsdf_window", "occupancy", "pred_logits", "pred_masks", "coords"):
        assert torch.equal(out_p[k], out_r[k]), k
    trainer = Trainer(cfg, port, device=dev)
    ref_trainer.model.train()
    _, m_p = trainer.step(imgs, fi, tg, trainer.recurrent_state())
    _, m_r = ref_trainer.step(rimgs, rfi, rtg, ref_trainer.recurrent_state())
    for k, v in m_r.items():
        assert torch.equal(m_p[k], v), k
    for n, a in ref_trainer.optimizer.acc.items():
        assert torch.equal(trainer.optimizer.acc[n], a), n

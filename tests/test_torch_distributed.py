"""Data-parallel training of the port (parallel/mesh.py, the sharded step
of train/state.Trainer, train/loop.train_epochs_sharded, the CLI under
torchrun) on the CPU over gloo.

Two ranks are spawned once per module (tests/torch_ranks.py holds their
code) and run, in one process group, each scenario below, then leave the
group and take the single-process steps the scenarios are held against;
meanwhile this process computes JAX's side:
  * parity with JAX, at the threshold-free tiny config of
    test_torch_train.py with running-statistics BatchNorm and
    accumulation 1: rank r steps on fragment r (seeds 0 and 1), and the
    averaged gradient the optimizer received is held against the mean of
    JAX's `fragment_loss_fn` gradients of the two fragments, which is
    what the sharded JAX step's pmean computes
    (eprecon_tpu/train/state.py:186), by cosine per leaf as
    test_torch_train.py does, with its floors taken as it takes them:
    from JAX's own spread under half a grey level of image noise, on
    these two fragments (`jax_noise_cosines_of_mean` below). The median
    (>= 0.99) and the occupancy-init path (>= 0.75) keep
    test_torch_train.py's floors. Fragment 1 moves JAX's own "other"
    leaves much further than fragment 0: over three noise draws the mean
    gradient's lowest falls to 0.795-0.956 with 56-186 of 595 leaves
    below 0.99 (fragment 1 alone: 0.34-0.94, 141-271 of 630), so those
    leaves are held at >= 0.75 and at most a third below 0.99 (the port:
    0.873, 146 of 595; the floors of seed 0 alone, 0.90 and 20%, fail
    JAX against itself here). The averaged loss terms within 3e-2 of the
    mean of JAX's;
  * with batch-statistics BatchNorm: both ranks' parameters equal bit for
    bit after the update, and equal to one process's Optimizer.step on
    the mean of the two single-process gradients; each rank's running
    statistics equal the mean of the two single-process runs' (bit for
    bit: the mean of two f32 values is one rounding on either side);
  * the sharded-loop scenario of tests/test_train_cli.py:70-127 (rank 0
    sees scene A twice, rank 1 scenes B and C, frozen backbone and
    occupancy init, 2 epochs), the second epoch resumed by new trainers
    from the first's checkpoint;
  * a stop file seen by one rank stops both at the same step, and the RSS
    limit on one rank exits both with 75, each with one checkpoint.
Then, in this process: one rank through train_epochs_sharded equals
train_epochs bit for bit, and the CLI trains under torchrun with
`--dist-backend gloo --device cpu` (nccl on the CPU is refused).
"""
import dataclasses
import json
import multiprocessing
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from test_torch_cli import micro_overrides
from test_torch_train import (HW, INIT_PATH, TERMS, VIEWS, _model_config,
                              _variance_in_f32)
from torch_parity import (load, one_torch_thread, port_model_config,
                          random_variables, to_np)

from eprecon_tpu.data import synthetic as jsyn
from eprecon_tpu.models import occupancy_init as joi
from eprecon_tpu.models.eprecon import EPRecon as JaxEPRecon
from eprecon_tpu.models.eprecon import FragmentInputs, FragmentTargets
from eprecon_tpu.models.eprecon import make_recurrent_state as jax_state
from eprecon_tpu.train.state import fragment_loss_fn
from eprecon_tpu_torch import main as tmain
from eprecon_tpu_torch.convert import tree_to_torch
from eprecon_tpu_torch.models import eprecon as te
from eprecon_tpu_torch.parallel import mesh
from eprecon_tpu_torch.train import loop as tloop
from eprecon_tpu_torch.train.state import Optimizer, Trainer

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT = 600   # seconds for both ranks; a hang fails the module
LOOP_STEPS = 2       # per rank and epoch in the sharded-loop scenario


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_side():
    """The tiny config's JAX model with random variables (seed 0), the
    fragments of seeds 0 and 1, and a function giving one JAX training
    step's loss terms and gradients on a fragment."""
    m = _model_config()
    frags = [jsyn.make_fragment(n_views=VIEWS, image_hw=HW, n_vox=m.n_vox,
                                voxel_size=m.voxel_size, seed=s) for s in (0, 1)]

    def args(d):
        frag = FragmentInputs(jnp.asarray(d["proj_matrices"]),
                              jnp.asarray(d["vol_origin_partial"]),
                              jnp.asarray(d["world_to_aligned_camera"]),
                              jnp.zeros((m.n_layer, 3), jnp.int32))
        targets = FragmentTargets(
            tuple(jnp.asarray(x) for x in d["tsdf_levels"]),
            tuple(jnp.asarray(x) for x in d["occ_levels"]),
            jnp.asarray(d["semantic"]), jnp.asarray(d["instance"]))
        return jnp.asarray(d["imgs"]), frag, targets

    model = JaxEPRecon(m, use_running_average=True)
    state = jax_state(m)
    imgs, frag, targets = args(frags[0])
    variables = random_variables(model, imgs, frag, state, targets, seed=0)
    params = variables["params"]
    aux = {k: v for k, v in variables.items() if k != "params"}
    step = jax.jit(jax.value_and_grad(
        lambda p, a, i, f, t, r: fragment_loss_fn(model, p, a, i, f, t, r),
        has_aux=True))

    def run(d):
        (_, (metrics, _, _)), grads = step(params, aux, *args(d), state)
        return to_np(metrics), to_np(grads)

    return m, frags, variables, run


def _start_ranks(work):
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=torch_ranks.rank_main, args=(r, port, str(work)))
             for r in range(torch_ranks.WORLD)]
    for p in procs:
        p.start()
    return procs


def _join_ranks(procs, work):
    deadline = time.monotonic() + JOIN_TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = "\n".join(f.read_text() for f in sorted(work.glob("rank*.err")))
    assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT} s\n{errors}"
    assert [p.exitcode for p in procs] == [0] * len(procs), errors
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    with pytest.MonkeyPatch.context() as mp, one_torch_thread():
        # the JAX occupancy init's variance summed in f32, as the port sums
        # it (test_torch_train.f32_variance)
        mp.setattr(joi, "back_project_variance", _variance_in_f32)
        m, frags, variables, run = _jax_side()
        pm = port_model_config(m)
        weights = load(te.EPRecon(pm, use_running_average=True),
                       variables).state_dict()
        torch.save(dict(model=pm, weights=weights, frags=frags),
                   work / "spec.pt")
        procs = _start_ranks(work)
        try:
            jax_runs = [run(d) for d in frags]
            results = _join_ranks(procs, work)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
    return dict(results=results, jax=jax_runs, model=pm, work=work)


def test_ranks_join_one_gloo_group(ranks):
    for r, out in enumerate(ranks["results"]):
        assert (out["device"], out["world"], out["rank"]) == ("cpu", 2, r)


def test_averaged_gradient_matches_mean_of_jax(ranks):
    """The averaged gradient and loss terms of the 2-rank step against the
    mean of JAX's over the two fragments (test_torch_train.py's floors)."""
    (m0, g0), (m1, g1) = ranks["jax"]
    r0, r1 = (out["parity"] for out in ranks["results"])
    assert r0["metrics"] == r1["metrics"]
    assert r0["metrics"]["frag_ok"] == 1.0
    for k in TERMS:
        want = (float(m0[k]) + float(m1[k])) / 2
        assert want > 0.1, k
        assert abs(r0["metrics"][k] - want) <= 3e-2 * want, (k, r0["metrics"][k], want)
    model = te.EPRecon(ranks["model"], use_running_average=True)
    want = tree_to_torch(model, jax.tree_util.tree_map(
        lambda a, b: (a + b) / 2, g0, g1))
    got = r0["grads"]
    assert set(want) == set(got)
    norms = {n: float(w.norm()) for n, w in want.items()}
    floor = 1e-3 * max(norms.values())
    cosines = {n: float((got[n] * w).sum() / (got[n].norm() * w.norm()))
               for n, w in want.items() if norms[n] > floor}
    assert len(cosines) > 500
    low = {n: c for n, c in cosines.items() if c < 0.99}
    init = {n: c for n, c in low.items() if n.startswith(INIT_PATH)}
    other = {n: c for n, c in low.items() if n not in init}
    assert min(init.values(), default=1) >= 0.75, init
    assert min(other.values(), default=1) >= 0.75, other
    assert len(other) <= len(cosines) / 3, len(other)
    assert np.median(list(cosines.values())) >= 0.99


def test_one_all_reduce_per_step_and_ranks_stay_equal(ranks):
    """Each micro-step is one collective; both ranks received the same
    gradient bits and hold the same parameters after the update."""
    r0, r1 = ranks["results"]
    for key in ("parity", "batch_stats"):
        assert r0[key]["all_reduces"] == r1[key]["all_reduces"] == 1, key
        assert r0[key]["params_digest"] == r1[key]["params_digest"], key
    assert r0["parity"]["grads_digest"] == r1["parity"]["grads_digest"]
    assert r0["batch_stats"]["stats_digest"] == r1["batch_stats"]["stats_digest"]


def test_update_equals_one_process_on_the_mean_gradient(ranks):
    """Batch-statistics BatchNorm: the ranks' parameters after the update
    equal, bit for bit, one process's Optimizer.step on the mean of the
    two single-process gradients (None as zero)."""
    m = ranks["model"]
    g0, g1 = (out["single"]["grads"] for out in ranks["results"])
    zero = lambda g, ref: torch.zeros_like(ref) if g is None else g  # noqa: E731
    model = te.EPRecon(m, seed=3)
    params = dict(model.named_parameters())
    before = torch_ranks.params_of(model)
    mean = {n: (zero(g0[n], p) + zero(g1[n], p)) / 2 for n, p in params.items()}
    cfg = torch_ranks.batch_stats_config(m)
    assert Optimizer(params, cfg.train, 1).step(mean)
    got = ranks["results"][0]["batch_stats"]["params"]
    for n, p in params.items():
        assert torch.equal(got[n], p.detach()), n
    assert any(not torch.equal(p.detach(), before[n]) for n, p in params.items()
               if n.startswith("neucon_net.tsdf_pred_2."))


def test_running_statistics_are_the_mean_of_single_runs(ranks):
    s0, s1 = (out["single"]["stats"] for out in ranks["results"])
    got = ranks["results"][0]["batch_stats"]["stats"]
    assert set(got) == set(s0) and len(got) == 350
    fresh = torch_ranks.running_stats_of(te.EPRecon(ranks["model"], seed=3))
    assert any(not torch.equal(s0[n], fresh[n]) for n in got)
    for n, x in got.items():
        assert torch.equal(x, (s0[n] + s1[n]) / 2), n


def test_sharded_loop_freeze_reset_and_resume(ranks):
    """tests/test_train_cli.py:70-127 as ranks: fresh recurrent states at
    each (scene, epoch) of each rank's own stream (rank 1 mid-shard, at
    scene C); the resumed trainers start at the stored epoch and step;
    frozen parameters unchanged, the tsdf head moved, both ranks equal;
    rank 0 alone wrote the checkpoints and metrics.jsonl, one record per
    step with finite losses."""
    r0, r1 = (out["loop"] for out in ranks["results"])
    assert r0["fresh_at"] == [[0], [2]]
    assert r1["fresh_at"] == [[0, 1], [2, 3]]
    for r in (r0, r1):
        assert r["resumed_at"] == (1, LOOP_STEPS)
        assert r["end"] == (2, 2 * LOOP_STEPS)
        assert r["frozen_unchanged"] and r["n_frozen"] > 100
        assert r["head_moved"]
    assert r0["params_digest"] == r1["params_digest"]
    logdir = ranks["work"] / "loop"
    names = [str(logdir / f"model_{e:06d}") for e in (0, 1)]
    assert [Path(p).name.split(".")[0] for p in r0["saved"]] == \
        [Path(n).name for n in names]
    assert r1["saved"] == [] and (r0["writers"], r1["writers"]) == (2, 0)
    assert sorted(p.name for p in logdir.glob("model_*")) == \
        ["model_000000", "model_000001"]
    records = [json.loads(x) for x in (logdir / "metrics.jsonl").open()]
    assert [x["step"] for x in records] == [1, 2, 3, 4]
    assert all(np.isfinite(x[k]) for x in records for k in x if "loss" in k)
    assert r1["logs"] == [] and any(x.startswith("epoch 1:") for x in r0["logs"])


def test_stop_file_on_one_rank_stops_both(ranks):
    r0, r1 = (out["stop"] for out in ranks["results"])
    assert r0["at"] == r1["at"] == (0, 1)
    assert r0["params_digest"] == r1["params_digest"]
    assert [Path(p).parent.name for p in r0["saved"]] == ["stop"] and r1["saved"] == []
    saved = torch.load(ranks["work"] / "stop" / "model_000000", weights_only=True)
    assert (saved["epoch"], saved["step"]) == (0, 1)


def test_rss_limit_on_one_rank_exits_both_75(ranks):
    r0, r1 = (out["rss"] for out in ranks["results"])
    assert r0["exit_code"] == r1["exit_code"] == tloop.RSS_RESTART_EXIT_CODE == 75
    assert r0["steps"] == r1["steps"] == 0
    assert len(r0["saved"]) == 1 and r1["saved"] == []
    assert (ranks["work"] / "rss" / "model_000000").is_file()


def test_one_rank_through_sharded_loop_equals_train_epochs(tmp_path):
    """Without a process group, train_epochs_sharded is train_epochs over
    the whole dataset: parameters, buffers, optimizer state, step, epoch
    and the metrics records (timings aside) bit for bit."""
    runs = {}
    with one_torch_thread():
        for name in ("sharded", "plain"):
            cfg = dataclasses.replace(torch_ranks.micro_config(tmp_path / name),
                                      summary_freq=1)
            m = cfg.model
            dataset = torch_ranks.LazyDataset(torch_ranks.MICRO_SAMPLES, m.n_vox,
                                              m.voxel_size, (48, 64))
            trainer = Trainer(cfg, te.EPRecon(m, seed=1), "cpu", 2)
            assert not trainer.distributed
            if name == "sharded":
                tloop.train_epochs_sharded(cfg, trainer, dataset, epochs=1,
                                           log_fn=lambda _: None)
            else:
                tloop.train_epochs(cfg, trainer, lambda e: (
                    dataset[i] for i in range(len(dataset))), epochs=1,
                    log_fn=lambda _: None)
            records = [json.loads(x) for x in (tmp_path / name / "metrics.jsonl").open()]
            runs[name] = (trainer.state_dict(), records)
    (a, ra), (b, rb) = runs["sharded"], runs["plain"]
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"]) == (4, 1)
    for name, x in a["model"].items():
        assert torch.equal(x, b["model"][name]), name
    for key in ("mu", "nu", "acc"):
        for name, x in a["optimizer"][key].items():
            assert torch.equal(x, b["optimizer"][key][name]), (key, name)
    strip = lambda rs: [{k: v for k, v in r.items() if not k.endswith("_ms")}  # noqa: E731
                        for r in rs]
    assert strip(ra) == strip(rb) and len(ra) == 4


def test_mesh_without_a_process_group():
    """Outside torchrun every helper is the one-rank identity, and nccl on
    the CPU is refused before any group is joined."""
    assert (mesh.world_size(), mesh.rank(), mesh.is_main_process()) == (1, 0, True)
    x = [torch.ones(2), torch.zeros(3, dtype=torch.float64)]
    assert mesh.all_reduce_mean(x)[0] is x[0]
    assert mesh.any_rank(True, False) == (True, False)
    mesh.synchronize()
    assert mesh.initialize_distributed("gloo", "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        mesh.initialize_distributed("nccl", "cpu")
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        tmain.main(["--cfg", str(REPO / "config/train.yaml"), "--device", "cpu",
                    "--dist-backend", "nccl"])


def _two_fragment_tree(root: Path):
    """A ScanNet-layout tree written by the port (tools/
    make_synthetic_scannet, tools/generate_gt on the CPU at 0.24 m): two
    scenes of 9 frames at 120x160, one fragment each, cut to 3 of its 9
    views so that each rank's step stays small."""
    from eprecon_tpu_torch.tools.generate_gt import generate_all
    from eprecon_tpu_torch.tools.make_synthetic_scannet import write_scene

    for s in range(2):
        write_scene(str(root / "scans"), str(root / "labels"),
                    f"scene{s:04d}_00", seed=s, n_frames=9, image_hw=(120, 160))
    gt = Path(generate_all(str(root / "scans"), "all_tsdf_9", 0.24, 9,
                           label_path=str(root / "labels"), device="cpu"))
    pkl = gt / "fragments_train.pkl"
    with open(pkl, "rb") as f:
        frags = pickle.load(f)
    assert [f["scene"] for f in frags] == ["scene0000_00", "scene0001_00"]
    with open(pkl, "wb") as f:
        pickle.dump([dict(f, image_ids=f["image_ids"][::4][:3]) for f in frags], f)
    return root


def test_cli_trains_under_torchrun_on_cpu(tmp_path):
    """torchrun --standalone --nproc_per_node 2 -m eprecon_tpu_torch.main
    --device cpu --dist-backend gloo: one fragment per rank through the
    prefetcher, one averaged step; rank 0 alone logs, writes the
    checkpoint and one metrics record."""
    tree = _two_fragment_tree(tmp_path / "tree")
    logdir = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "eprecon_tpu_torch.main",
         "--cfg", "config/train.yaml", "--device", "cpu", "--dist-backend",
         "gloo", *micro_overrides(tree, logdir), "train.n_views", "3",
         "train.epochs", "1", "summary_freq", "1", "train.n_workers", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert sorted(p.name for p in logdir.glob("model_*")) == ["model_000000"]
    (record,) = [json.loads(x) for x in (logdir / "metrics.jsonl").open()]
    assert record["step"] == 1 and np.isfinite(record["total_loss"])
    assert len([x for x in out.stdout.splitlines() if x.startswith("epoch 0: ")]) == 1
    saved = torch.load(logdir / "model_000000", weights_only=True)
    assert (saved["epoch"], saved["step"]) == (1, 1)
    assert saved["optimizer"]["mini_step"] == 1   # accumulation 8: not updated


def jax_noise_cosines_of_mean(draws: int = 3, seed: int = 123):
    """Per draw of half a grey level of uniform image noise on both
    fragments: for the mean gradient and for fragment 1's alone, the
    lowest cosine of JAX's gradient with the noise against JAX's without
    over the "other" leaves, how many fall below 0.99 of how many
    compared, and the occupancy-init path's lowest. The parity test's
    floors come from these. Run from the repository's root:

        JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_distributed.py
    """
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(joi, "back_project_variance", _variance_in_f32)
        m, frags, variables, run = _jax_side()
        model = te.EPRecon(port_model_config(m), use_running_average=True)
        base = [tree_to_torch(model, run(d)[1]) for d in frags]
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(draws):
            noisy = [tree_to_torch(model, run(dict(d, imgs=np.clip(
                d["imgs"] + rng.uniform(-0.5, 0.5, d["imgs"].shape), 0, 255)
                .astype(np.float32)))[1]) for d in frags]
            row = {}
            for name, got, want in (
                    ("mean", {n: (noisy[0][n] + noisy[1][n]) / 2 for n in base[0]},
                     {n: (base[0][n] + base[1][n]) / 2 for n in base[0]}),
                    ("fragment 1", noisy[1], base[1])):
                norms = {n: float(w.norm()) for n, w in want.items()}
                names = [n for n in want if norms[n] > 1e-3 * max(norms.values())]
                cos = {n: float((got[n] * want[n]).sum()
                                / (got[n].norm() * want[n].norm())) for n in names}
                other = [c for n, c in cos.items() if not n.startswith(INIT_PATH)]
                init = [c for n, c in cos.items() if n.startswith(INIT_PATH)]
                row[name] = (min(other), sum(c < 0.99 for c in other), len(cos),
                             min(init))
            out.append(row)
        return out


if __name__ == "__main__":
    os.environ.setdefault("XLA_FLAGS", "--xla_backend_optimization_level=0 "
                          "--xla_llvm_disable_expensive_passes=true")
    jax.config.update("jax_platforms", "cpu")
    for i, row in enumerate(jax_noise_cosines_of_mean()):
        for name, (lo, below, n, init) in row.items():
            print(f"noise draw {i}, {name}: other leaves' lowest cosine "
                  f"{lo:.4f} ({below} of {n} below 0.99); occupancy-init "
                  f"path's lowest {init:.4f}")

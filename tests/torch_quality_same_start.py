"""The quality loop from the JAX package's own initial weights, on the CPU:
`create_train_state(cfg, PRNGKey(key), ...)` builds them as
tests/test_quality_pq.py:37-40 does; `--package torch` carries them into
the port (convert.variables_to_torch) and trains the port, `--package jax`
trains the JAX package as its quality tests do, and `--package
torch-native` trains the port from its own EPRecon(seed=key). Both score after 48 and
100 steps, with the JAX package scored by its own functions
(tests/quality_utils.score_vs_gt and the window F-score of
tests/test_quality_loop.py:56-79). The port's run also splits the recall
by fragment window and surface class, and counts the voxels each stage
keeps per fragment.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_quality_same_start.py \
        --key 0 --package torch [--steps 100] [--out runs.json]

XLA runs at the test suite's codegen flags (tests/conftest.py), the flags
the JAX package's floors were calibrated at. On one core a JAX run of
100 steps takes 40-45 min with its scoring, a port run ~5 min.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (XLA flags, CPU platform, compile cache)
import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from eprecon_tpu.models.eprecon import make_recurrent_state  # noqa: E402
from eprecon_tpu.train.loop import (_scene_origin,  # noqa: E402
                                    fragment_to_device_args)
from eprecon_tpu.train.state import (create_train_state,  # noqa: E402
                                     make_train_step)
from quality_utils import (build_scene_and_fragments,  # noqa: E402
                           score_vs_gt, tiny_cfg, train_state_to_variables)
from torch_parity import load  # noqa: E402

from eprecon_tpu_torch.models.eprecon import EPRecon  # noqa: E402
from eprecon_tpu_torch.tools import quality_run  # noqa: E402
from eprecon_tpu_torch.tools import quality_utils as tq  # noqa: E402

SCORE_AT = (quality_run.WINDOW_FSCORE_STEPS, quality_run.PQ_STEPS)


def jax_start(key: int):
    cfg = tiny_cfg()
    scene, frags, samples = build_scene_and_fragments(cfg)
    origin = _scene_origin(cfg, samples[0])
    args = [fragment_to_device_args(cfg, s, origin) for s in samples]
    rec0 = make_recurrent_state(cfg.model)
    tstate, model, tx = create_train_state(
        cfg, jax.random.PRNGKey(key), (args[0][0], args[0][1], rec0, args[0][2]),
        steps_per_epoch=100)
    return cfg, scene, frags, args, tstate, model, tx


def window_fscore_jax(cfg, out, frags):
    from eprecon_tpu.inference.mesh_export import marching_cubes
    from eprecon_tpu.tools.evaluation_utils import eval_mesh

    gt_verts = []
    for d in frags:
        t = d["tsdf_levels"][0]
        if (np.abs(t) < 1).any():
            v, _, _ = marching_cubes(t)
            gt_verts.append(v * cfg.model.voxel_size + d["vol_origin_partial"])
    pv, _, _ = marching_cubes(out.tsdf)
    mw = eval_mesh(pv * out.voxel_size + out.origin, np.concatenate(gt_verts),
                   threshold=0.15, down_sample=0.06)
    return dict(window_fscore=mw["fscore"], window_prec=mw["prec"],
                window_recal=mw["recal"])


def run_jax(key: int, steps: int, report):
    cfg, scene, frags, args, tstate, model, tx = jax_start(key)
    step = make_train_step(model, tx, cfg)
    losses, scores, rec = {}, {}, None
    t0 = time.perf_counter()
    for it in range(steps):
        i = it % len(args)
        if i == 0:
            rec = make_recurrent_state(cfg.model)
        imgs, frag, targets = args[i]
        tstate, rec, metrics = step(tstate, imgs, frag, targets, rec)
        if it in report:
            losses[it] = {k: float(v) for k, v in metrics.items()}
        if it + 1 in SCORE_AT:
            m, out = score_vs_gt(cfg, train_state_to_variables(tstate), frags,
                                 scene, return_result=True)
            if out is not None and (np.abs(out.tsdf) < 1).any():
                m.update(window_fscore_jax(cfg, out, frags))
                m["recall_breakdown"] = recall_breakdown(out, scene, frags)
            scores[it + 1] = m
    return dict(losses=losses, scores=scores,
                s_per_step=(time.perf_counter() - t0) / steps)


def recall_breakdown(result, scene, frags, threshold=tq.MESH_THRESHOLD):
    """Where a reconstruction misses the GT surface: the GT mesh's
    vertices (fused on the reconstructed grid, not down-sampled) split per
    fragment window and per surface class (each box by instance id, the
    floor band, the rest), each with its count and the share within
    `threshold` of the predicted mesh."""
    from scipy.spatial import cKDTree

    from eprecon_tpu_torch.data.synthetic import FLOOR_CLASS, voxel_labels
    from eprecon_tpu_torch.inference.mesh_export import marching_cubes

    vsz, origin, dim = float(result.voxel_size), result.origin, result.tsdf.shape
    gt_tsdf = tq.gt_on_grid(scene, frags, origin, dim, vsz)[0]
    if not ((np.abs(gt_tsdf) < 1).any() and (np.abs(result.tsdf) < 1).any()):
        return {}
    gv, pv = marching_cubes(gt_tsdf)[0], marching_cubes(result.tsdf)[0]
    hit = cKDTree(pv * vsz).query(gv * vsz, k=1)[0] < threshold
    world = gv * vsz + origin
    out = {}
    for i, d in enumerate(frags):
        lo = d["vol_origin_partial"]
        inside = ((world >= lo) & (world < lo + np.asarray(
            d["tsdf_levels"][0].shape) * vsz)).all(1)
        out[f"window{i}"] = inside
    _, ins = voxel_labels(scene, np.asarray(origin), vsz, tuple(dim))
    cell = tuple(np.clip(np.round(gv).astype(np.int64), 0,
                         np.asarray(dim) - 1).T)
    for b in scene.boxes:
        out[f"box{b.instance}"] = ins[cell] == b.instance
    out["floor"] = ins[cell] == FLOOR_CLASS
    out["other"] = ins[cell] == 0
    return {k: dict(n=int(m.sum()), recall=float(hit[m].mean()) if m.any()
                    else 0.0) for k, m in out.items()}


def stage_counts(cfg, model, frags):
    """Per fragment: the occupancy init's kept voxels and each stage's
    occupied voxels, streaming as the reconstruction does."""
    from eprecon_tpu_torch.models.eprecon import make_recurrent_state as mrs

    recon = tq.StreamingReconstructor(cfg, model, "cpu")
    out = []
    for d in frags:
        recon.process_fragment("s", d["imgs"], d["proj_matrices"],
                               d["vol_origin_partial"], d["vol_origin_partial"],
                               d["world_to_aligned_camera"])
        o = recon.last_outputs
        with torch.no_grad():
            dbg = model(*recon.last_inputs, mrs(cfg.model, "cpu"),
                        debug_outputs=True)[0]
        out.append(dict(init=int(dbg["occ_init_mask"].sum()),
                        **{f"stage{i}": int(o[f"n_occ_{i}"])
                           for i in range(cfg.model.n_layer)}))
    return out


def run_torch(key: int, steps: int, report, native: bool = False):
    cfg = tq.tiny_cfg()
    if native:  # the port's own initialisation, EPRecon(seed=key)
        model = EPRecon(cfg.model, seed=key)
    else:
        tstate = jax_start(key)[4]
        model = load(EPRecon(cfg.model), train_state_to_variables(tstate))
        del tstate
    quality_run.EPRecon = lambda _cfg, seed: model  # train this start
    t0 = time.perf_counter()
    run = quality_run.train_and_score(cfg, steps, SCORE_AT, device="cpu",
                                      report_at=report)
    run["s_per_step"] = (time.perf_counter() - t0) / steps
    scene, frags, _ = tq.build_scene_and_fragments(cfg)
    result = tq.reconstruct(cfg, model, frags, "cpu")
    run["recall_breakdown"] = recall_breakdown(result, scene, frags)
    run["stage_counts"] = stage_counts(cfg, model, frags)
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--key", type=int, default=0)
    ap.add_argument("--package", choices=("torch", "jax", "torch-native"),
                    default="torch")
    ap.add_argument("--steps", type=int, default=quality_run.PQ_STEPS)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    torch.set_num_threads(1)
    report = {0, 25, quality_run.LOSS_FALL_STEP, 50, 75, a.steps - 1}
    if a.package == "jax":
        run = run_jax(a.key, a.steps, report)
    else:
        run = run_torch(a.key, a.steps, report, a.package == "torch-native")
    run.update(key=a.key, package=a.package, steps=a.steps)
    text = json.dumps(run, indent=1, default=float)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()

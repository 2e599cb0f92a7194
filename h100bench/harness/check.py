"""The comparison that decides `correct`: what the timed path produced,
at the timed sizes, against the reference (`h100bench/reference/`),
which gets the same weights and inputs and works out everything else
itself. Each number compared has its limit in
`h100bench/limits/<workload>.json`; PERF.md gives the readings each was
set from.

Streamed reconstruction: the reference follows the stream from its
start with its own state over the warm-up and the window's first
fragments, and its outputs and whole state (every level's global map,
the panoptic map) are compared with the program's there; then for each
sampled fragment (drawn from the seed among those the window served)
the reference runs the fragment from the state the program held before
it (the global-map windows the fragment reads and the whole panoptic
map; fresh where the program started a scene) and compares outputs,
global-map windows and the whole panoptic map.

Training: the reference replays the checked steps (one accumulation
cycle from the same weights, fragments and recurrent states; across
ranks with its own all-reduce, every rank's numbers held to the
limits) and compares each step's loss terms, the first gradient and the
running mean after three steps as the optimizer holds them, and the
update, each by its worst leaf.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

import torch

from h100bench.harness import common


def limits_for(workload: str) -> Dict[str, float]:
    path = common.BENCH / "limits" / f"{workload}.json"
    with open(path) as f:
        return json.load(f)["limits"]


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, List[float]]]:
    """Every number within its limit (a missing or non-finite number
    fails). Returns (correct, {name: [number, limit]})."""
    out, ok = {}, True
    for name, limit in limits.items():
        x = numbers.get(name, float("nan"))
        out[name] = [x, limit]
        ok = ok and x == x and abs(x) != float("inf") and x <= limit
    return ok, out


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b| (1 where b is all zero and a is not)."""
    a, b = a.double(), b.double()
    d = (a - b).abs().max().item() if a.numel() else 0.0
    s = b.abs().max().item() if b.numel() else 0.0
    return d / s if s > 0 else (0.0 if d == 0 else 1.0)


def _serve_gaps(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor],
                n_layer: int) -> Dict[str, float]:
    """One fragment's numbers: its outputs, and the state both sides hold
    (global-map windows or whole maps, the whole panoptic map)."""
    occ_r, occ_p = ref["occupancy"], got["occupancy"]
    both = occ_r & occ_p
    seen = ref["pmap_mask"] & got["pmap_mask"]
    gaps = [(ref["tsdf_window"] - got["tsdf_window"]).abs()[both],
            (ref["pmap_tsdf"] - got["pmap_tsdf"]).abs()[seen]]
    return dict(
        occupancy_mismatch=int((occ_r != occ_p).sum()) / max(int(occ_r.sum()), 1),
        tsdf_gap=max((g.max().item() for g in gaps if g.numel()), default=0.0),
        logit_gap=_max_rel(got["pred_logits"], ref["pred_logits"]),
        state_gap=max(_max_rel(got[f"gmap{lv}_feats"].float(),
                               ref[f"gmap{lv}_feats"].float())
                      for lv in range(n_layer)),
        map_mismatch=(sum(int((got[f"pmap_{k}"] != ref[f"pmap_{k}"]).sum())
                          for k in ("mask", "semantic", "instance"))
                      + sum(int((got[f"gmap{lv}_mask"] != ref[f"gmap{lv}_mask"]).sum())
                            for lv in range(n_layer))
                      + int(got["pmap_next_instance_id"].item()
                            != ref["pmap_next_instance_id"].item()))
        / max(int(ref["pmap_mask"].sum()), 1))


def serve_numbers(check: Dict[str, Any], device) -> Dict[str, float]:
    """The worst of the compared fragments, for each number: the
    reference follows the stream from its start with its own state over
    the warm-up and the window's first fragments and is held to the
    program's whole state there; then each sampled fragment is run from
    the state the program held before it (fresh where the program
    started its scene there)."""
    from h100bench.harness import config as hc
    from h100bench.harness.serve import reference_fragment, reference_prefix
    from h100bench.reference.epr.models.eprecon import EPRecon
    from h100bench.reference.serve_ref import set_tf32
    set_tf32(False)
    mcfg, _ = hc.reference_configs(check["mcfg_spec"])
    worst = dict(occupancy_mismatch=0.0, tsdf_gap=0.0, logit_gap=0.0,
                 state_gap=0.0, map_mismatch=0.0)

    def fold(ref, got):
        got = {k: v.to(device) for k, v in got.items()}
        for k, v in _serve_gaps(ref, got, mcfg.n_layer).items():
            worst[k] = max(worst[k], float(v))

    with torch.no_grad():
        fold(reference_prefix(check["sd"], mcfg, check["prefix"], device),
             check["whole"])
    common.free_cuda()
    set_tf32(False)
    model = EPRecon(mcfg).to(device).eval()
    model.load_state_dict(check["sd"])
    for item in check["items"]:
        before = None if item["fresh"] else item["before"]
        with torch.no_grad():
            fold(reference_fragment(model, mcfg, item["frag"], before, device),
                 item["after"])
    worst["compared"] = float(len(check["items"]) + 1)
    worst["replayed"] = float(len(check["prefix"]))
    del model
    common.free_cuda()
    return worst


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each leaf's gap between the program's norm and the reference's,
    against the larger of that leaf's reference norm and the median
    leaf's."""
    scale = torch.maximum(ref, ref.median())
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return (prog - ref).abs() / scale


def leaf_gap(prog: torch.Tensor, ref: torch.Tensor, keep=None) -> float:
    """The worst leaf's gap (`leaf_gaps`), over the leaves `keep` holds."""
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    if ref.numel() == 0:
        return 0.0
    return float(leaf_gaps(prog, ref).max())


def train_numbers(check: Dict[str, Any], device) -> Dict[str, float]:
    """Replay the checked steps with the reference and compare."""
    from h100bench.harness import config as hc
    from h100bench.harness.train import leaf_norms, step_inputs
    from h100bench.reference.serve_ref import set_tf32
    from h100bench.reference.train_ref import Trainer
    set_tf32(False)
    mcfg, tcfg = hc.reference_configs(check["spec"])
    sd = check["sd"]
    tr = Trainer(mcfg, tcfg, sd, device)
    got = check["got"]
    names = got["names"]
    if list(tr.optimizer.params) != names:
        raise ValueError("the reference's parameters differ from the program's")
    losses, rec = [], None
    for s, (frag, first) in enumerate(check["frags"]):
        if first:
            rec = tr.recurrent_state()
        imgs, fi, tg = step_inputs(frag, device, ref=True)
        rec, metrics = tr.step(imgs, fi, tg, rec)
        losses.append({k: float(v) for k, v in metrics.items() if "loss" in k})
        if s == 0:
            grad1 = leaf_norms(tr.optimizer.acc)
        if s == 2:
            acc3 = leaf_norms(tr.optimizer.acc)
    update = leaf_norms({n: tr.optimizer.params[n].detach() - sd[n] for n in names})
    g_upd = leaf_norms(tr.update_grad)
    keep = g_upd >= 1e-3 * g_upd.median()
    loss_gap = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-6)
                   for p, r in zip(got["losses"], losses) for k in r)
    nums = dict(loss_gap=loss_gap,
                grad_gap=leaf_gap(got["grad1"], grad1),
                acc3_gap=leaf_gap(got["acc3"], acc3),
                update_gap=leaf_gap(got["update"], update, keep),
                update_leaves_left_out=float((~keep).sum()),
                compared_steps=float(len(losses)))
    for key, p, r in (("grad", got["grad1"], grad1), ("acc3", got["acc3"], acc3)):
        gaps = leaf_gaps(p, r)
        i = int(gaps.argmax())
        nums[f"{key}_worst_leaf"] = f"{names[i]} prog {float(p[i]):.6g} ref {float(r[i]):.6g}"
        nums[f"{key}_median_leaf_gap"] = float(gaps.median())
    del tr, rec
    common.free_cuda()
    return nums

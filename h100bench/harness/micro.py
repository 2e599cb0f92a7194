"""A micro configuration and traffic for the CPU tests: the same code
paths at sizes a test run holds (32^3 window at 12 cm, 3 views of
96x128, small capacities and global extent, low minimum voxel counts;
at most 2 ranks, run over gloo by `runner.run(..., micro=True)`)."""
from __future__ import annotations

import copy
from typing import Any, Dict


def micro_spec(spec: Dict[str, Any]) -> Dict[str, Any]:
    s = copy.deepcopy(spec)
    s["inputs"] = {"views": 3, "image_hw": [96, 128]}
    s["model"].update(n_vox=[32, 32, 32], voxel_size=0.12,
                      voxel_capacity=[512, 4096, 32768],
                      global_extent=[64, 64, 40], origin_margin=4,
                      min_init_voxels=1, min_stage_voxels=1)
    s["model"]["panoptic"] = dict(s["model"]["panoptic"], min_instance_voxels=20)
    if "accumulation_steps" in s.get("train", {}):
        s["train"]["accumulation_steps"] = 4
    return s


def micro_traffic(traffic: Dict[str, Any]) -> Dict[str, Any]:
    t = copy.deepcopy(traffic)
    t.update(rooms=1, room_pitch=3.0, radius=0.6, fragments_per_scene=3,
             scenes=min(t.get("scenes", 1), 2), ranks=min(t.get("ranks", 1), 2))
    if t["program"] == "serve":
        t.update(warmup=1, trace_items=2, check_sample=2, check_span=3)
    else:
        # one accumulation cycle, as the cells check: no checked loss
        # follows the update, whose round-off-driven leaves Adam moves by
        # the whole learning rate either way
        t.update(checked_steps=4)
    return t

"""Time the live serving path, `StreamingReconstructor.process_fragment`,
at the full default config on one NVIDIA GPU.

    python eprecon_tpu_torch/tools/bench_serving.py [--root DIR]
        [--fragments N] [--out FILE]

Serves one warm-up fragment and then N fragments of one synthetic scene
(random weights from the config's seed; 9 views at 640x480, the 96^3
window; the fragments turn 0.25 rad apart) and reports each fragment's
host time with the card synchronised after it, their median and quartiles,
the peak device memory over the N (`max_memory_allocated`), the
back-projection launches per fragment, and the card's name and power
limit. `--root` names the checkout whose eprecon_tpu_torch serves
(default: the one holding this file), so that two versions can be timed
on one card: run this file as a script once per root, in turns.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--fragments", type=int, default=12)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import numpy as np
    import torch
    from eprecon_tpu_torch.config import default_config
    from eprecon_tpu_torch.data.synthetic import make_fragment, make_scene
    from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
    from eprecon_tpu_torch.models.eprecon import EPRecon
    from eprecon_tpu_torch.ops import back_project as bp
    from eprecon_tpu_torch.tools.bench_back_project import card_line

    cfg = default_config()
    m = cfg.model
    scene = make_scene(0)
    frags = [make_fragment(n_vox=m.n_vox, voxel_size=m.voxel_size, scene=scene,
                           start_angle=0.25 * i)
             for i in range(args.fragments + 1)]
    rec = StreamingReconstructor(cfg, EPRecon(m, seed=cfg.seed))  # CUDA

    def serve(d):
        rec.process_fragment("a", d["imgs"], d["proj_matrices"],
                             d["vol_origin_partial"] - 0.5,
                             d["vol_origin_partial"],
                             d["world_to_aligned_camera"])
        torch.cuda.synchronize()

    serve(frags[0])
    torch.cuda.reset_peak_memory_stats()
    before = bp.total_launches()
    ms = []
    for d in frags[1:]:
        t0 = time.perf_counter()
        serve(d)
        ms.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    res = dict(root=str(args.root), card=card_line(), fragment_ms=ms,
               median_ms=float(med), q1_ms=float(q1), q3_ms=float(q3),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches_per_fragment=(bp.total_launches() - before) / len(ms))
    line = json.dumps(res)
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

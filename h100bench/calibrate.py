"""The readings the output limits are set from, at a cell's own size, on
one card: for each seed, the port (sound runs: the lower reading), the
control (the reference in the program's place in TF32, the precision
below the configuration's TF32-off float32) and the faults the cell can
have (the upper readings), each against the reference, in one process.

    python3 h100bench/calibrate.py --workload NAME --seeds 1,2,3
        [--runs port,control,port:answer] [--seconds 4] [--span 12]

Prints one JSON line per run with its numbers. The benchmark's own runs
do not run this. A workload of several ranks runs each reading on its
ranks, one process per card (the worst rank's numbers are printed, as
the check judges them).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--runs", default="port,control")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--span", type=int, default=12)
    args = ap.parse_args(argv)
    from h100bench.run import set_environment
    set_environment()
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    from h100bench.harness import cell, check, manifest as mf, runner
    from h100bench.reference.serve_ref import set_tf32
    man = mf.load(ROOT)
    w = mf.workload(man, args.workload)
    spec = mf.read_json(ROOT / mf.config_entry(man, w["config"])["file"])
    traffic = mf.traffic(w["traffic"])
    dev = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",")]:
        for run in args.runs.split(","):
            system, _, fault = run.partition(":")
            set_tf32(False)
            t = time.time()
            if int(traffic.get("ranks", 1)) > 1:
                ranks = runner._run_ranks(w, seed, args.seconds, False, t,
                                          int(traffic["ranks"]), system,
                                          fault or None)
                rec = ranks[0]["record"]
                nums = runner.worst_numbers([r["numbers"] for r in ranks],
                                            check.limits_for(args.workload))
            else:
                torch.cuda.reset_peak_memory_stats()
                rec, nums = cell.run(spec, traffic, seed, args.seconds, False, dev,
                                     t, system=system, fault=fault or None,
                                     sample_span=args.span)
            print(json.dumps(dict(workload=args.workload, seed=seed, run=run,
                                  numbers=nums, completed=rec.completed,
                                  seconds=round(time.time() - t, 1))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

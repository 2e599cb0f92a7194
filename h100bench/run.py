"""The benchmark of eprecon_tpu_torch on NVIDIA H100 cards: one cell of
BENCHMARK.json per run.

    python3 h100bench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout, on a machine with the cards the cell
asks for. It builds the cell's configuration, traffic and metrics from
the files BENCHMARK.json names, runs the port (never the JAX package),
checks what the timed path produced against the plain reference in
h100bench/reference/, and prints one JSON line last on standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), `device`, with
--trace 1 `breakdown`, and last `compared` (each number compared, with
its limit; also the last lines of standard error). Without the cards, it
prints no result and exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench.harness.modules import forbidden_modules  # noqa: E402


def set_environment():
    """Caches inside the checkout at fixed paths; no library loads JAX by
    itself; nccl keeps out of /dev/shm."""
    cache = ROOT / "h100bench" / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["NCCL_SHM_DISABLE"] = "1"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from h100bench.harness.common import process_start_time
    t_start = process_start_time()
    args = parse(argv)
    set_environment()
    from h100bench.harness import manifest as mf
    manifest = mf.load(ROOT)
    cell = mf.workload(manifest, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"h100bench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from h100bench.harness import runner
    result = runner.run(manifest, cell, args.seed, args.seconds,
                        bool(args.trace), t_start)
    return finish(result)


def finish(result) -> int:
    """Print the result, or nothing and 3 where this process or a rank
    held a module of JAX or the JAX package once the window had closed."""
    found = sorted(set(forbidden_modules()) | set(result.pop("forbidden", [])))
    if found:
        print(f"h100bench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"check numbers {json.dumps(result.pop('numbers'))}", file=sys.stderr)
    for name, (x, limit) in result["compared"].items():
        print(f"compared {name} = {x!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

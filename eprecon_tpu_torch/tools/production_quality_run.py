"""The production quality protocol on the card (port of the JAX package's
tools_dev/production_quality_run.py): synthetic multi-room ScanNet-layout
scenes at 480x640 depth, 96^3 windows at 4 cm, through the port's own
tools and CLI: make_synthetic_scannet.write_scene -> generate_gt on the
card -> `python -m eprecon_tpu_torch.main` training -> the same entry
point testing -> per-scene F-score and PQ under the label-transfer
protocol (tools/evaluation.py), averaged over the held-out scenes (one
scene's PQ swings on one or two instance flips).

    python -m eprecon_tpu_torch.tools.production_quality_run ROOT [EPOCHS]

ROOT holds the tree, the checkpoints, the test output and summary.json
(the schema of docs/artifacts/prodq_r5_summary.json, with the epochs
trained under "protocol"). The phases are resumable by marker files
(ROOT/.done_<phase>). Training polls the stop file ROOT/STOP between steps
(EPRECON_STOP_FILE, exported to the child explicitly) and checkpoints
and returns when it appears; a later call (STOP removed) resumes from
ROOT/ckpt to the full epoch count. EPRECON_MAX_RSS_GB (default 48) makes the loop
checkpoint and exit 75 once the host's resident set passes it, and the
runner resumes it.

The recipe is the JAX package's: 3 train + 3 held-out scenes of 96 frames
and 2 rooms, lr 1e-3, accumulation 1, occ_init_threshold 0.05,
global_extent_auto, save every 5 epochs, 2 decode threads, and
`model.remat_mode full` (the backward recomputes the backbones and every
3-D module; the results are those of any other mode).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
N_TRAIN_SCENES, N_HELDOUT, N_FRAMES, N_ROOMS = 3, 3, 96, 2
MAX_RESTARTS = 50
RSS_RESTART_EXIT_CODE = 75  # train/loop.RSS_RESTART_EXIT_CODE


class Run:
    def __init__(self, root: str, epochs: int):
        # absolute: the CLI runs in the repository's root
        self.root, self.epochs = Path(root).resolve(), epochs
        self.data = self.root / "data"
        self.scans, self.labels = self.data / "scans", self.data / "labels"
        self.ckpt, self.testlog = self.root / "ckpt", self.root / "test_out"
        self.stop = self.root / "STOP"
        self.env = {**os.environ,
                    "EPRECON_STOP_FILE": str(self.stop),
                    "EPRECON_MAX_RSS_GB": os.environ.get("EPRECON_MAX_RSS_GB",
                                                         "48")}
        self.root.mkdir(parents=True, exist_ok=True)
        self.phase_s = {}

    def phase(self, name: str, fn):
        marker = self.root / f".done_{name}"
        if marker.exists():
            print(f"[{name}] already done", flush=True)
            return
        t0 = time.time()
        print(f"[{name}] running...", flush=True)
        fn()
        marker.touch()
        self.phase_s[name] = time.time() - t0
        print(f"[{name}] done in {self.phase_s[name]:.0f}s", flush=True)

    def scenes(self):
        from eprecon_tpu_torch.tools.make_synthetic_scannet import write_scene

        for s in range(N_TRAIN_SCENES + N_HELDOUT):
            name = f"scene{s:04d}_00"
            write_scene(str(self.scans), str(self.labels), name, seed=s,
                        n_frames=N_FRAMES, image_hw=(480, 640),
                        n_rooms=N_ROOMS)
            print(f"  {name} written", flush=True)
        st = self.data / "scans_test"
        if not st.exists():
            st.symlink_to("scans")  # beside it, so the tree can move

    def gt(self):
        from eprecon_tpu_torch.tools.generate_gt import generate_all

        scenes = sorted(os.listdir(self.scans))
        held = scenes[N_TRAIN_SCENES:]
        generate_all(str(self.scans), save_name="all_tsdf_9", voxel_size=0.04,
                     n_views=9, label_path=str(self.labels),
                     splits={"train": scenes[:N_TRAIN_SCENES], "val": held,
                             "test": held},
                     device="cuda")

    def _cli(self, yaml: str, *overrides) -> int:
        cmd = [sys.executable, "-m", "eprecon_tpu_torch.main", "--cfg",
               f"config/{yaml}"] + [str(x) for x in overrides]
        print("  $", " ".join(cmd), flush=True)
        return subprocess.run(cmd, cwd=REPO, env=self.env).returncode

    def train(self):
        args = ["train.yaml", "train.path", self.data, "logdir", self.ckpt,
                "train.epochs", self.epochs, "train.lr", "1e-3",
                "train.accumulation_steps", 1, "model.occ_init_threshold", 0.05,
                "train.n_workers", 2, "save_freq", 5,
                "model.global_extent_auto", "true", "model.remat_mode", "full"]
        rc = self._cli(*args, *self.resume())
        restarts = 0
        while rc == RSS_RESTART_EXIT_CODE and restarts < MAX_RESTARTS:
            restarts += 1
            print(f"[train] RSS restart #{restarts} (resume)", flush=True)
            rc = self._cli(*args, *self.resume())
        if rc != 0:
            raise RuntimeError(f"train CLI failed with exit {rc}")
        epochs, _ = self.epochs_trained()
        if epochs < self.epochs:  # the stop file: not done, resumed later
            raise SystemExit(f"[train] stopped after {epochs} of {self.epochs} "
                             f"epochs; remove {self.stop} and call again")

    def test(self):
        ckpts = sorted(glob.glob(str(self.ckpt / "model_*")))
        if not ckpts:
            raise RuntimeError(f"no checkpoints under {self.ckpt}")
        rc = self._cli("test.yaml", "test.path", self.data,
                       "logdir", self.testlog, "loadckpt", ckpts[-1],
                       "model.occ_init_threshold", 0.05, "test.n_workers", 2,
                       "model.global_extent_auto", "true")
        if rc != 0:
            raise RuntimeError(f"test CLI failed with exit {rc}")

    def latest_checkpoint(self):
        from eprecon_tpu_torch.train import checkpoint as ckpt

        return ckpt.latest_checkpoint(str(self.ckpt))

    def resume(self):
        """The CLI's resume override once ROOT/ckpt holds a checkpoint: an
        earlier call that stopped, or the loop's RSS restart."""
        return ["resume", "true"] if self.latest_checkpoint() else []

    def epochs_trained(self):
        """(epochs, steps) of the newest checkpoint's trainer."""
        latest = self.latest_checkpoint()
        if not latest:
            return 0, 0
        import torch

        state = torch.load(latest, map_location="cpu", weights_only=True)
        return int(state["epoch"]), int(state["step"])

    def report(self) -> dict:
        import numpy as np

        scenes = {}
        for p in glob.glob(str(self.testlog / "scenes" / "*_metrics.json")):
            with open(p) as f:
                scenes[os.path.basename(p)[:-len("_metrics.json")]] = json.load(f)
        agg = {}
        if scenes:
            keys = [k for k, v in next(iter(scenes.values())).items()
                    if isinstance(v, (int, float))]
            for k in keys:
                vals = [m[k] for m in scenes.values() if k in m]
                agg[k] = {"mean": float(np.mean(vals)),
                          "min": float(np.min(vals)),
                          "max": float(np.max(vals)), "n": len(vals)}
        epochs, steps = self.epochs_trained()
        out = {"scenes": scenes, "aggregate": agg,
               "protocol": {"epochs": self.epochs, "epochs_trained": epochs,
                            "steps_trained": steps, "n_train": N_TRAIN_SCENES,
                            "n_heldout": N_HELDOUT, "frames": N_FRAMES,
                            "rooms": N_ROOMS},
               "phase_s": self.phase_s}
        print(json.dumps(out, indent=2), flush=True)
        with open(self.root / "summary.json", "w") as f:
            json.dump(out, f, indent=2)
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("epochs", type=int, nargs="?", default=40)
    a = ap.parse_args(argv)
    run = Run(a.root, a.epochs)
    run.phase("scenes", run.scenes)
    run.phase("gt", run.gt)
    run.phase("train", run.train)
    run.phase("test", run.test)
    run.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())

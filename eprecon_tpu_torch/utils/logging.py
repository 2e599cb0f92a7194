"""Logging + scalar summaries (port of eprecon_tpu/utils/logging.py).

Reference: main.py:84-93 (loguru file+console logging, rank-0 only;
tensorboardX SummaryWriter) and utils.py:83-93 (save_scalars). Here:
stdlib logging, and scalar summaries to `metrics.jsonl` always, and to
tensorboard events where torch.utils.tensorboard imports. One process
writes (the sharded loop is not ported yet).
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
import types
from typing import Dict, Optional


def setup_logger(logdir: Optional[str] = None, name: str = "eprecon") -> logging.Logger:
    """Console + file logger (reference main.py:84-91)."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(
            logdir, f"{time.strftime('%Y%m%d-%H%M%S')}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class SummaryWriter:
    """Scalar summary writer: JSONL always, tensorboard events where
    tensorboard imports (reference utils.py:83-93 save_scalars)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self.tb = None
        # scalar events need no TensorFlow: the `notf` marker module is
        # tensorboard's switch to its own stub (importing TensorFlow where
        # it is installed takes seconds)
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
        except ImportError:
            return
        self.tb = TBWriter(logdir)

    def add_scalars(self, mode: str, scalars: Dict[str, float], step: int):
        rec = {"mode": mode, "step": step,
               **{k: float(v) for k, v in scalars.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(f"{mode}/{k}", float(v), step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()

"""A configuration file (`h100bench/configs/<name>.json`) as the port's
and the reference's config objects.

The file holds the keys it sets under `model` and `train` (lists where
the dataclasses hold tuples); every other key keeps the dataclasses'
default, which the file records under `assumed` where it matters.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict


def load(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _tuples(v):
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    return v


def _replace(obj, keys: Dict[str, Any]):
    """dataclasses.replace with nested dicts for nested dataclasses."""
    fields = {f.name for f in dataclasses.fields(obj)}
    kw = {}
    for k, v in keys.items():
        if k not in fields:
            raise KeyError(f"{type(obj).__name__} has no field {k!r}")
        cur = getattr(obj, k)
        kw[k] = (_replace(cur, v) if dataclasses.is_dataclass(cur)
                 and isinstance(v, dict) else _tuples(v))
    return dataclasses.replace(obj, **kw)


def port_config(spec: Dict[str, Any]):
    """The port's Config with the file's model and train keys."""
    from eprecon_tpu_torch.config import default_config
    cfg = default_config()
    return dataclasses.replace(
        cfg, model=_replace(cfg.model, spec.get("model", {})),
        train=_replace(cfg.train, spec.get("train", {})))


def reference_configs(spec: Dict[str, Any]):
    """The reference's (ModelConfig, TrainConfig) with the same keys."""
    from h100bench.reference.epr.config import ModelConfig, TrainConfig
    return (_replace(ModelConfig(), spec.get("model", {})),
            _replace(TrainConfig(), spec.get("train", {})))

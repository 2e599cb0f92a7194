"""Typed configuration tree, YAML overlay and dotted-key CLI overrides.

Own copy of the dataclasses in `eprecon_tpu/config.py` (reference:
config/default.py, config/train.yaml, config/test.yaml). Left for the
slices that use them: sparse-engine capacities. Two JAX-only knobs are not
fields (`remat_mode`, a TPU memory setting: the port's peak of 26.92 GiB
on an 80 GB card has not called for recompute; and `bp_backward`, a TPU
choice between two equal adjoints: the port has one backward kernel); a
YAML file or override that sets one is accepted and ignored.
`model.sparsereg_dropout` is a field, and only False builds a model (see
models/eprecon.EPReconCore).

The YAML files are read by a parser of the subset they use (nested
mappings by indentation, scalars resolved as YAML 1.1 resolves them, flow
lists `[a, b]`, quoted strings, `#` comments), so no YAML package is
needed.
"""
from __future__ import annotations

import ast
import dataclasses
import re
import typing
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Backbone2DConfig:
    # reference: config/default.py:65-66 ('fpn-mnas-1' -> alpha=1.0)
    arc: str = "fpn-mnas-1"

    @property
    def alpha(self) -> float:
        return float(self.arc.split("-")[-1])


@dataclass(frozen=True)
class PanopticConfig:
    """Panoptic decoder hyperparameters (reference: models/neucon_network.py:60-97)."""
    num_classes: int = 20
    num_queries: int = 80
    hidden_dim: int = 48
    nheads: int = 8
    dec_layers: int = 6
    dim_feedforward_mult: int = 4
    # set-criterion weights (reference models/criterion.py)
    class_weight: float = 0.2
    mask_weight: float = 0.8
    dice_weight: float = 0.8
    no_object_weight: float = 0.1
    # static slots of GT instances per fragment
    max_instances: int = 48
    # GT instances with this many voxels or fewer are dropped
    min_instance_voxels: int = 100


@dataclass(frozen=True)
class ModelConfig:
    n_vox: Tuple[int, int, int] = (96, 96, 96)
    voxel_size: float = 0.04
    n_layer: int = 3
    thresholds: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # occupancy BCE positive weight, and the loss weights over
    # (tsdf_occ_loss_0, 1, 2, panoptic) (reference models/neuralrecon.py:79-84)
    pos_weight: float = 1.5
    lw: Tuple[float, ...] = (1.0, 0.8, 0.64, 1.2)
    # BGR pixel mean/std (reference config/default.py:60-61)
    pixel_mean: Tuple[float, float, float] = (103.53, 116.28, 123.675)
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # dropout at the U-Net's L2 in training (JAX eprecon_tpu/models/
    # unet_dense.py:76-77); True is refused when the model is built
    sparsereg_dropout: bool = False
    backbone2d: Backbone2DConfig = field(default_factory=Backbone2DConfig)
    panoptic: PanopticConfig = field(default_factory=PanopticConfig)
    # occupancy initialization (reference models/neucon_network.py:239-244)
    init_stage: int = 1
    min_view_number: int = 2
    occ_init_threshold: float = 0.3
    # fragment flagged not-ok below these active-voxel counts
    min_init_voxels: int = 1000
    min_stage_voxels: int = 500
    # static voxel capacities per stage (coarse->fine) of the compacted
    # panoptic voxel sets
    voxel_capacity: Tuple[int, int, int] = (16384, 65536, 131072)
    # dense global scene volume extent in FINEST-level voxels; coarser
    # levels are this / 2^scale. (256, 256, 128) @ 4 cm = 10.2 x 10.2 x 5.1 m
    global_extent: Tuple[int, int, int] = (256, 256, 128)
    # "window_union": anchor the global volume at the scene's minimum
    # fragment-window origin when the caller knows it; else at vol_origin
    scene_anchor: str = "window_union"
    # margin (finest voxels) the global volume keeps below a scene origin
    origin_margin: int = 32
    # storage dtype of the recurrent global feature volumes
    global_dtype: str = "bfloat16"
    # round float images to uint8 before the forward (the JAX package's
    # host->device transfer format; the cast to f32 happens in normalize)
    transfer_images_uint8: bool = False
    # size global_extent and origin_margin from the dataset's fragment
    # windows at run_train/run_test start-up (data/extent.py)
    global_extent_auto: bool = False
    # the reference's per-stage voxel sample caps (config/train.yaml)
    train_num_sample: Tuple[int, int, int] = (15000, 60000, 120000)
    test_num_sample: Tuple[int, int, int] = (15000, 60000, 120000)

    @property
    def n_scales(self) -> int:
        return len(self.thresholds) - 1


@dataclass(frozen=True)
class TrainConfig:
    """Data, loop and optimizer recipe of training (reference
    config/train.yaml TRAIN and main.py:154-348): Adam, MultiStepLR, grad
    clip, gradient accumulation, staged freezing, world-frame
    augmentation."""
    path: str = ""
    epochs: int = 100
    lr: float = 1e-4
    lr_epochs: str = "70,90:10"   # milestones (epochs) : lr divisor
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    grad_clip: float = 1.0
    n_views: int = 9
    n_workers: int = 8
    accumulation_steps: int = 8
    random_rotation_3d: bool = True
    random_translation_3d: bool = True
    pad_xy_3d: float = 0.1
    pad_z_3d: float = 0.025
    only_init: bool = False       # train the occupancy initialization alone
    # scene-granularity shuffling of the sharded loop (fragments stay in
    # temporal order within a scene)
    shuffle: bool = False
    finetune_layer: Optional[str] = None  # 'init': freeze backbone2d + init
    seed: int = 1


@dataclass(frozen=True)
class TestConfig:
    path: str = ""
    n_views: int = 9
    n_workers: int = 4
    # frames per scene of the depth-evaluation protocol after run_test
    # (0: off; the protocol itself is not ported yet)
    eval_depth_frames: int = 0


@dataclass(frozen=True)
class Config:
    mode: str = "train"
    dataset: str = "scannet"
    batch_size: int = 1
    logdir: str = "./checkpoints"
    resume: bool = True
    loadckpt: str = ""
    summary_freq: int = 20
    save_freq: int = 1
    seed: int = 1
    save_scene_mesh: bool = False
    save_incremental: bool = False
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)


def default_config() -> Config:
    return Config()


# keys of the JAX package's config that have no meaning here (see the
# module docstring): accepted from a YAML file or override, and ignored
JAX_ONLY_KEYS = frozenset({"model.remat_mode", "model.bp_backward"})


# ---------------------------------------------------------------------------
# YAML overlay + dotted-key overrides (replaces yacs merge_from_file/list,
# reference: config/default.py:78-83)
# ---------------------------------------------------------------------------

def _coerce(value: Any, target_type: Any) -> Any:
    origin = typing.get_origin(target_type)
    if origin in (tuple, Tuple):
        args = typing.get_args(target_type)
        elem = args[0] if args else float
        if elem is Ellipsis:
            elem = float
        return tuple(_coerce(v, elem) for v in value)
    if target_type is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if target_type in (int, float, str, bool):
        return target_type(value)
    return value


def _replace_path(cfg: Any, dotted: str, value: Any, prefix: str = "") -> Any:
    head, _, rest = dotted.partition(".")
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    if head not in fields:
        if prefix + dotted in JAX_ONLY_KEYS:
            return cfg
        raise KeyError(f"unknown config key: {head!r} in {type(cfg).__name__}")
    current = getattr(cfg, head)
    if rest:
        new_child = _replace_path(current, rest, value, f"{prefix}{head}.")
        return dataclasses.replace(cfg, **{head: new_child})
    ftype = typing.get_type_hints(type(cfg)).get(head, type(current))
    return dataclasses.replace(cfg, **{head: _coerce(value, ftype)})


def apply_overrides(cfg: Config, overrides: Sequence[Tuple[str, Any]]) -> Config:
    """Apply dotted-key overrides, e.g. [('model.voxel_size', 0.04)]."""
    for key, value in overrides:
        cfg = _replace_path(cfg, key.lower(), value)
    return cfg


def _merge_dict(cfg: Any, d: dict, prefix: str = "") -> Any:
    for k, v in d.items():
        key = k.lower()
        if isinstance(v, dict):
            child = getattr(cfg, key)
            cfg = dataclasses.replace(
                cfg, **{key: _merge_dict(child, v, f"{prefix}{key}.")})
        else:
            cfg = _replace_path(cfg, key, v, prefix)
    return cfg


def load_config(yaml_path: Optional[str] = None,
                overrides: Sequence[Tuple[str, Any]] = ()) -> Config:
    """Build a Config from defaults + optional YAML file + CLI overrides."""
    cfg = default_config()
    if yaml_path:
        with open(yaml_path) as f:
            data = parse_yaml(f.read()) or {}
        cfg = _merge_dict(cfg, data)
    return apply_overrides(cfg, overrides)


def parse_cli_overrides(opts: List[str]) -> List[Tuple[str, Any]]:
    """Parse ['model.voxel_size', '0.04', ...] KEY VALUE pairs (yacs-style)."""
    if len(opts) % 2 != 0:
        raise ValueError("overrides must be KEY VALUE pairs")
    out = []
    for k, v in zip(opts[::2], opts[1::2]):
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        out.append((k, v))
    return out


# ---------------------------------------------------------------------------
# the YAML subset of config/*.yaml
# ---------------------------------------------------------------------------

# plain-scalar resolution of YAML 1.1, as yaml.safe_load applies it
_NULL = re.compile(r"~|null|Null|NULL|")
_BOOL = {v: b for b, vs in ((True, "yes Yes YES true True TRUE on On ON"),
                            (False, "no No NO false False FALSE off Off OFF"))
         for v in vs.split()}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
_KEY = re.compile(r"([A-Za-z_][\w.-]*)\s*:(?:\s+(.*))?$")


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (one that starts the line or follows
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_flow(text: str) -> List[str]:
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(text):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(text[start:i])
            start = i + 1
    items.append(text[start:])
    return [x.strip() for x in items if x.strip()]


def _scalar(text: str) -> Any:
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        return [_scalar(x) for x in _split_flow(text[1:-1])]
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return ast.literal_eval(text)
    if text[:1] in ("[", "{", "'", '"', "&", "*", "!", "|", ">", "%", "@") \
            or text == "-" or text.startswith("- "):
        raise ValueError(f"YAML syntax outside the supported subset: {text!r}")
    if _NULL.fullmatch(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    m = _INF.fullmatch(text)
    if m:
        return float(f"{m.group(1)}inf")
    if _NAN.fullmatch(text):
        return float("nan")
    return text


def parse_yaml(text: str) -> Optional[dict]:
    """Parse the YAML subset the config files use into nested dicts, as
    yaml.safe_load would. Raises ValueError on anything else (block lists,
    anchors, multi-line scalars, tabs)."""
    root: dict = {}
    stack = [(-1, root)]       # (indent, mapping) of the open mappings
    pending = None             # (parent, key, indent) of a `key:` line
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body.startswith("\t") or "\t" in line[:indent]:
            raise ValueError(f"line {n}: tab in indentation")
        if pending is not None:
            parent, key, p_indent = pending
            pending = None
            if indent > p_indent:
                parent[key] = child = {}
                stack.append((indent, child))
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0] and stack[-1][1] is not root:
            raise ValueError(f"line {n}: inconsistent indentation")
        if stack[-1][1] is root and indent != 0:
            raise ValueError(f"line {n}: unexpected indentation")
        m = _KEY.match(body)
        if not m:
            raise ValueError(f"line {n}: not a `key: value` line: {raw!r}")
        key, value = m.group(1), m.group(2)
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        if value is None or not value.strip():
            mapping[key] = None
            pending = (mapping, key, indent)
        else:
            mapping[key] = _scalar(value)
    return root or None

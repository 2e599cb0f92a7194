"""JAX checkpoint importer: a checkpoint of the JAX package's training
state (eprecon_tpu/train/checkpoint.save_checkpoint, an orbax
`model_NNNNNN` directory) -> the port's model, optimizer, step and epoch,
read without JAX.

An orbax PyTreeCheckpointer directory holds `_METADATA` (JSON: per leaf its
tree path, each component a dict key or a sequence index, and its value
type) and the leaves as zarr arrays in an OCDBT key-value store named by
the dotted path. `tensorstore` reads them; it is imported when a
checkpoint is read, and every host that writes an orbax checkpoint has it.
Where it is missing (the card's host), convert on the host that wrote the
checkpoint and load the output:

  python -m eprecon_tpu_torch.tools.import_jax_checkpoint \\
      logdir/model_000099 model_000099 [--cfg config/train.yaml] \\
      [--model-only] [KEY VALUE ...]

The output is the port's own checkpoint (Trainer.state_dict(), or
{"model": ...} with --model-only), which `loadckpt` and `resume` take.
The config (YAML and overrides) must build the model the JAX run
trained, and for a full resume its optimizer: accumulation_steps and
finetune_layer select the optimizer state's layout.

The JAX TrainState (eprecon_tpu/train/state.py) is
  params                                  the flax parameter tree
  batch_stats.{batch_stats, buffers}      the other collections
  opt_state                               optax state, one of
    MultiSteps (accumulation_steps > 1):  {mini_step, gradient_step,
        acc_grads, skip_state, inner_opt_state: [clip, [adam, schedule]]}
    no MultiSteps (accumulation 1):       [clip, [adam, schedule]]
    either under finetune_layer's mask:   [{inner_state}, <one of the two>]
  step, epoch
where adam is {count, mu, nu}. The optimizer runs under optax.flatten, so
mu, nu and acc_grads are single vectors over the raveled parameters
(jax.flatten_util.ravel_pytree: leaves in the tree's flattening order,
dict keys sorted, each leaf in C order). They are unravelled into
parameter-shaped trees and carried through convert.tree_to_torch, which is
exact for elementwise state only because every layout change it makes
moves each element to one place (checked: a transform that did more would
make the moments wrong, and the importer raises).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Iterable, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from eprecon_tpu_torch.convert import tree_to_torch, variables_to_torch

METADATA = "_METADATA"
SEQUENCE_KEY = 1   # orbax key_type of a sequence index (2: a dict key)
# the value an empty node (orbax's skip_deserialize entries) reads back as
_EMPTY = {"Dict": dict, "List": list, "Tuple": tuple, "None": lambda: None}


def is_orbax_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, METADATA))


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading a JAX (orbax) checkpoint needs the `tensorstore` "
            "package, which is not installed here: convert the checkpoint on "
            "the host that wrote it (python -m eprecon_tpu_torch.tools."
            "import_jax_checkpoint CKPT_DIR OUT) and load OUT") from e
    return tensorstore


def _as_sequences(node):
    """Dict nodes keyed by sequence indices (ints) -> lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _as_sequences(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def read_orbax_tree(path: str, prefixes: Optional[Iterable[str]] = None) -> dict:
    """The tree of an orbax PyTreeCheckpointer directory as nested dicts
    (dict keys) and lists (sequence indices) of numpy arrays (scalars as
    0-d arrays); empty nodes read back as {}, [], () or None. With
    `prefixes`, only the top-level entries named there are read."""
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"{path} is not an orbax checkpoint "
                                f"(no {METADATA} in it)")
    with open(meta_path) as f:
        meta = json.load(f)
    ts = _tensorstore()
    context = ts.Context()
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    base = os.path.abspath(path)
    keep = None if prefixes is None else set(prefixes)
    tree: dict = {}
    opened = []
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] if k["key_type"] != SEQUENCE_KEY else int(k["key"])
                for k in entry["key_metadata"]]
        if keep is not None and keys[0] not in keep:
            continue
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            node[keys[-1]] = _EMPTY[value["value_type"]]()
            continue
        kvstore = {"driver": "ocdbt", "base": f"file://{base}",
                   "path": ".".join(str(k) for k in keys)}
        opened.append((node, keys[-1], ts.open(
            {"driver": driver, "kvstore": kvstore}, open=True, context=context)))
    reads = [(node, key, store.result().read()) for node, key, store in opened]
    for node, key, read in reads:
        node[key] = np.asarray(read.result())
    return _as_sequences(tree)


# ---------------------------------------------------------------------------
# flat optimizer vectors <-> parameter trees
# ---------------------------------------------------------------------------

def _leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    """The leaves of a nested dict in ravel_pytree's order (keys sorted)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _set(tree: dict, path: Tuple[str, ...], value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def unravel(flat: np.ndarray, params: Mapping) -> dict:
    """A raveled vector as a tree shaped like `params` (the inverse of
    jax.flatten_util.ravel_pytree for it)."""
    out: dict = {}
    offset = 0
    for path, leaf in _leaves(params):
        n = int(np.prod(leaf.shape))
        _set(out, path, flat[offset:offset + n].reshape(leaf.shape))
        offset += n
    if offset != flat.size:
        raise ValueError(f"optimizer vector of {flat.size} entries over "
                         f"parameters of {offset}")
    return out


def check_elementwise_carry(model: nn.Module, params: Mapping):
    """Raise unless convert.tree_to_torch moves every element of a
    parameter-shaped tree to exactly one place, so that elementwise state
    (Adam's moments, accumulated gradients) converts as the parameters do.
    Each element's index goes through in two parts below 2^12, which f32
    holds exactly."""
    def index_tree(part):
        out: dict = {}
        for path, leaf in _leaves(params):
            idx = np.arange(int(np.prod(leaf.shape)), dtype=np.int64)
            _set(out, path, part(idx).reshape(leaf.shape).astype(np.float32))
        return out

    lo = tree_to_torch(model, index_tree(lambda i: i % 4096))
    hi = tree_to_torch(model, index_tree(lambda i: i // 4096))
    for name, low in lo.items():
        idx = hi[name].long().flatten() * 4096 + low.long().flatten()
        if int(idx.max()) >= idx.numel() or not bool(
                (torch.bincount(idx, minlength=idx.numel()) == 1).all()):
            raise ValueError(
                f"{name}: the flax -> port layout change is not a "
                f"permutation of elements, so optimizer moments cannot be "
                f"carried over; load the parameters alone (restore_model)")


# ---------------------------------------------------------------------------
# the JAX TrainState -> the port
# ---------------------------------------------------------------------------

def _collections(tree: Mapping) -> Tuple[Mapping, Mapping]:
    """(batch_stats, buffers) of a TrainState, whose batch_stats holds the
    dict of collections."""
    return tree["batch_stats"]["batch_stats"], tree["batch_stats"]["buffers"]


def model_state(tree: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """{state_dict name: tensor} of a JAX tree's parameters and
    collections, in the port's layout (nothing is copied into `model`)."""
    stats, buffers = _collections(tree)
    out = {}
    for part in (tree["params"], stats, buffers):
        out.update(tree_to_torch(model, part))
    return out


def optimizer_layout(opt_state) -> Tuple[bool, Optional[Mapping], Mapping]:
    """(masked, the MultiSteps state or None, the Adam state) of an optax
    state that make_optimizer built (see the module docstring). Refuses
    the layout from before optax.flatten (per-leaf moments)."""
    masked = (isinstance(opt_state, list) and len(opt_state) == 2
              and isinstance(opt_state[0], Mapping)
              and "inner_state" in opt_state[0])
    node = opt_state[1] if masked else opt_state
    multi = node if isinstance(node, Mapping) and "mini_step" in node else None
    chain = multi["inner_opt_state"] if multi is not None else node
    try:
        adam = chain[1][0]
    except (IndexError, KeyError, TypeError):
        adam = None
    if not isinstance(adam, Mapping) or not {"count", "mu", "nu"} <= set(adam):
        raise ValueError("not an optimizer state of the JAX package's "
                         "make_optimizer (clip, adam, schedule)")
    if isinstance(adam["mu"], Mapping) or (
            multi is not None and isinstance(multi["acc_grads"], Mapping)):
        raise ValueError(
            "the checkpoint has an incompatible opt_state layout "
            "(pre-flat-optimizer format, before the optimizer ran under "
            "optax.flatten). Full resume is not possible; warm-start params "
            "only with `loadckpt` into a fresh optimizer.")
    return masked, multi, adam


def jax_state_to_port(tree: Mapping, target: Union[nn.Module, "Trainer"]):
    """Load a JAX TrainState tree (read_orbax_tree of a checkpoint) into
    `target`: a module takes the parameters and collections (every tensor
    must be covered); a train.state.Trainer also takes the optimizer
    state, step and epoch. Returns `target`."""
    from eprecon_tpu_torch.train.state import Trainer

    if not isinstance(target, Trainer):
        stats, buffers = _collections(tree)
        return variables_to_torch(target, tree["params"], stats, buffers)
    trainer = target
    masked, multi, adam = optimizer_layout(tree["opt_state"])
    cfg = trainer.cfg.train
    if masked != (cfg.finetune_layer is not None) or \
            (multi is not None) != (cfg.accumulation_steps > 1):
        raise ValueError(
            f"the checkpoint's optimizer ({'masked, ' if masked else ''}"
            f"{'MultiSteps' if multi is not None else 'no MultiSteps'}) does "
            f"not match train.finetune_layer={cfg.finetune_layer} and "
            f"train.accumulation_steps={cfg.accumulation_steps}")
    params = tree["params"]
    check_elementwise_carry(trainer.model, params)
    jax_state_to_port(tree, trainer.model)
    opt = trainer.optimizer
    moments = {"mu": adam["mu"], "nu": adam["nu"],
               "acc": (multi["acc_grads"] if multi is not None
                       else np.zeros_like(adam["mu"]))}
    state = {}
    for key, flat in moments.items():
        named = tree_to_torch(trainer.model, unravel(np.asarray(flat), params))
        state[key] = {n: named[n] for n in opt.params}
    updates = int(adam["count"])
    if multi is not None and int(multi["gradient_step"]) != updates:
        raise ValueError(f"MultiSteps gradient_step "
                         f"{int(multi['gradient_step'])} != Adam count {updates}")
    opt.load_state_dict(dict(state, updates=updates, mini_step=int(
        multi["mini_step"]) if multi is not None else 0))
    trainer.step_count, trainer.epoch = int(tree["step"]), int(tree["epoch"])
    return trainer


def read_model_tree(path: str) -> dict:
    """The parameters and collections of a JAX checkpoint (the optimizer
    state is not read)."""
    return read_orbax_tree(path, prefixes=("params", "batch_stats"))


def main(argv=None):
    ap = argparse.ArgumentParser(
        "python -m eprecon_tpu_torch.tools.import_jax_checkpoint",
        description="Convert a JAX (orbax) training checkpoint into the "
                    "port's checkpoint file.")
    ap.add_argument("ckpt", help="the orbax model_NNNNNN directory")
    ap.add_argument("out", help="the port's checkpoint file to write")
    ap.add_argument("--cfg", default=None, help="YAML config of the run")
    ap.add_argument("--model-only", action="store_true",
                    help='write {"model": ...} without the optimizer')
    ap.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    args = ap.parse_intermixed_args(argv)

    from eprecon_tpu_torch.config import load_config, parse_cli_overrides
    from eprecon_tpu_torch.models.eprecon import EPRecon
    from eprecon_tpu_torch.train.state import Trainer

    cfg = load_config(args.cfg, parse_cli_overrides(args.opts))
    model = EPRecon(cfg.model, seed=cfg.seed)
    t0 = time.perf_counter()
    tree = (read_model_tree(args.ckpt) if args.model_only
            else read_orbax_tree(args.ckpt))
    t1 = time.perf_counter()
    if args.model_only:
        state = {"model": jax_state_to_port(tree, model).state_dict()}
        what = "model"
    else:
        trainer = jax_state_to_port(tree, Trainer(cfg, model, device="cpu"))
        state = trainer.state_dict()
        opt = trainer.optimizer
        what = (f"model, optimizer at update {opt.updates} (micro-step "
                f"{opt.mini_step}), step {trainer.step_count}, epoch "
                f"{trainer.epoch}")
    t2 = time.perf_counter()
    torch.save(state, args.out)
    t3 = time.perf_counter()
    print(f"wrote {args.out}: {what}; {len(state['model'])} model tensors; "
          f"host seconds: read {t1 - t0:.3f}, convert {t2 - t1:.3f}, "
          f"write {t3 - t2:.3f}")
    return state


if __name__ == "__main__":
    main()

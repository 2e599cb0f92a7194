"""Activation-fingerprint check of the reference-checkpoint importer (own
copy of eprecon_tpu/tools/fingerprint.py).

The enumeration ORDER of a torchsparse [K, I, O] kernel's K offsets
(reference models/modules.py:75-175), and the spatial order of an spconv
KRSC kernel (models/occupancy_initialization.py:30-36), is a
shape-invariant permutation: a wrong assumption converts silently, and
the importer's own layout tests embed the assumption they test.

Protocol
--------
1. In an environment that has the real libraries,
   ``tools_dev/record_reference_fingerprint.py <ckpt> <out.json>`` builds,
   for one representative kernel per layout-sensitive transform, a dense
   conv kernel by placing each of the K rows at the offset the library
   itself reports, and records the dense-conv output on a fixed seeded
   input.
2. ``verify_or_fix_layout(sd, expected)`` converts the same kernels under
   every candidate enumeration order (8 combinations over ts-odd / ts-even
   / spconv spatial order), runs the same probe convolutions, and picks the
   layout whose activations match the recording. The importer then uses
   that layout for the whole conversion.

A mismatch that no layout explains raises: an importer bug or a corrupted
checkpoint, not an enumeration-order question.

Probe semantics (the recorder's and the JAX package's, number for number,
so that one recording verifies under both packages):
  * input: standard-normal, ``np.random.default_rng(seed_for(src_key))``,
    shape [1, 5, 5, 5, I] (channels-last; spatial axes in the order of the
    CONVERTED kernel's first three axes).
  * ts3 / ts3_pad3 / spconv: stride-1 SAME conv.
  * ts2: stride-2 VALID conv.  * ts2T: stride-2 VALID transposed conv in
    the flax ConvTranspose sense (``lax.conv_transpose`` without kernel
    transposition: the converted kernel already bakes the spatial flip), so
    F.conv_transpose3d takes the kernel flipped back.
  * fingerprint: first 48 values of the flattened channels-last output,
    then its mean and std (float64 of the f32 output).
The probes run in f32 on the CPU, as the JAX package's do: a host tool,
not the card's path.
"""
from __future__ import annotations

import itertools
import json
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from eprecon_tpu_torch.tools import import_reference_weights as irw

# Layout axes: each is a shape-invariant enumeration ambiguity.
#   ts_odd:  torchsparse ks=3 [27, I, O]: "xfast" (x-fastest, the
#            get_kernel_offsets order for odd kernels; the default) or
#            "zfast" (z-fastest).
#   ts_even: torchsparse ks=2 [8, I, O]: "zfast" (the default) or "xfast".
#   spconv:  spconv KRSC [O, kd, kh, kw, I] spatial order: "dhw" (the
#            default: axes map to the port's (x, y, z)) or "whd" (reversed).
LAYOUT_AXES = {
    "ts_odd": ("xfast", "zfast"),
    "ts_even": ("zfast", "xfast"),
    "spconv": ("dhw", "whd"),
}
DEFAULT_LAYOUT = {k: v[0] for k, v in LAYOUT_AXES.items()}

# transforms whose enumeration order is at risk -> the layout axis they follow
SENSITIVE = {"ts3": "ts_odd", "ts3_pad3": "ts_odd",
             "ts2": "ts_even", "ts2T": "ts_even",
             "spconv": "spconv"}


def _ts3_with(order: str) -> Callable[[np.ndarray], np.ndarray]:
    def t(w):
        k, i, o = w.shape
        assert k == 27, w.shape
        cube = w.reshape(3, 3, 3, i, o)
        if order == "xfast":      # flat = z*9 + y*3 + x -> (z, y, x, I, O)
            cube = cube.transpose(2, 1, 0, 3, 4)
        return np.ascontiguousarray(cube)  # zfast: flat = x*9+y*3+z: direct
    return t


def _ts2_with(order: str) -> Callable[[np.ndarray], np.ndarray]:
    def t(w):
        k, i, o = w.shape
        assert k == 8, w.shape
        cube = w.reshape(2, 2, 2, i, o)
        if order == "xfast":
            cube = cube.transpose(2, 1, 0, 3, 4)
        return np.ascontiguousarray(cube)
    return t


def _spconv_with(order: str) -> Callable[[np.ndarray], np.ndarray]:
    def t(w):
        v = np.transpose(w, (1, 2, 3, 4, 0))   # KRSC -> [kd, kh, kw, I, O]
        if order == "whd":
            v = np.transpose(v, (2, 1, 0, 3, 4))
        return np.ascontiguousarray(v)
    return t


def transforms_for(layout: Dict[str, str]) -> Dict[str, Callable]:
    """The importer's TRANSFORMS with the layout-sensitive kernel reshapes
    overridden."""
    ts3 = _ts3_with(layout["ts_odd"])
    ts2 = _ts2_with(layout["ts_even"])

    def ts3_pad3(w):
        k = ts3(w)
        pad = np.zeros(k.shape[:3] + (3, k.shape[4]), k.dtype)
        return np.concatenate([k, pad], axis=3)

    t = dict(irw.TRANSFORMS)
    t.update({"ts3": ts3, "ts3_pad3": ts3_pad3, "ts2": ts2,
              "ts2T": lambda w: np.ascontiguousarray(
                  ts2(w)[::-1, ::-1, ::-1]),
              "spconv": _spconv_with(layout["spconv"])})
    return t


def layout_name(layout: Dict[str, str]) -> str:
    return ",".join(f"{k}={layout[k]}" for k in sorted(LAYOUT_AXES))


def all_layouts() -> List[Dict[str, str]]:
    keys = sorted(LAYOUT_AXES)
    combos = itertools.product(*(LAYOUT_AXES[k] for k in keys))
    return [dict(zip(keys, c)) for c in combos]


def probe_entries() -> List[irw.Entry]:
    """One representative importer entry per sensitive transform.

    Skips spatially degenerate kernels (a 1x1x1 spconv kernel is invariant
    under any spatial-order flip, so it cannot identify the layout axis)."""
    entries, _ = irw.all_entries()
    picked: Dict[str, irw.Entry] = {}
    for e in entries:
        if e.transform not in SENSITIVE or e.transform in picked:
            continue
        if e.transform == "spconv" and e.src_shape[1] == 1:  # [O,kd,kh,kw,I]
            continue
        picked[e.transform] = e
    return [picked[k] for k in sorted(picked)]


def seed_for(key: str) -> int:
    """Stable probe-input seed (hash() is salted per process: crc32)."""
    return zlib.crc32(key.encode()) & 0x7FFFFFFF


def _probe_output(kernel: np.ndarray, transform: str, src_key: str
                  ) -> np.ndarray:
    """The probe convolution of a converted [kx, ky, kz, I, O] kernel on the
    key's seeded input, in f32 on the CPU."""
    rng = np.random.default_rng(seed_for(src_key))
    ci = kernel.shape[3]
    x = rng.standard_normal((1, 5, 5, 5, ci)).astype(np.float32)
    x_cf = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    k = torch.from_numpy(np.ascontiguousarray(kernel, np.float32))
    with torch.no_grad():
        if transform in ("ts3", "ts3_pad3", "spconv"):
            y = F.conv3d(x_cf, k.permute(4, 3, 0, 1, 2),
                         padding=kernel.shape[0] // 2)
        elif transform == "ts2":
            y = F.conv3d(x_cf, k.permute(4, 3, 0, 1, 2), stride=2)
        elif transform == "ts2T":
            y = F.conv_transpose3d(x_cf, k.flip(0, 1, 2).permute(3, 4, 0, 1, 2),
                                   stride=2)
        else:  # pragma: no cover
            raise ValueError(transform)
    flat = y.permute(0, 2, 3, 4, 1).numpy().astype(np.float64).reshape(-1)
    return np.concatenate([flat[:48], [flat.mean(), flat.std()]])


def fingerprint_state_dict(sd: Dict[str, np.ndarray],
                           layout: Optional[Dict[str, str]] = None
                           ) -> Dict[str, List[float]]:
    """Per-probe activation fingerprints of `sd` under `layout`."""
    layout = layout or DEFAULT_LAYOUT
    t = transforms_for(layout)
    out = {}
    for e in probe_entries():
        if e.src not in sd:
            continue
        w = np.asarray(sd[e.src], np.float32)
        if tuple(w.shape) != e.src_shape:
            raise ValueError(f"{e.src}: shape {w.shape} != {e.src_shape}")
        out[e.src] = _probe_output(t[e.transform](w), e.transform,
                                   e.src).tolist()
    return out


def verify_or_fix_layout(sd: Dict[str, np.ndarray],
                         expected: Dict[str, List[float]],
                         atol: float = 1e-3, rtol: float = 1e-3
                         ) -> Tuple[Dict[str, str], Dict[str, float]]:
    """Find the enumeration layout under which `sd` reproduces the recorded
    activation fingerprints. Returns (layout, max-abs-diff per probe).

    Tries DEFAULT_LAYOUT first; on mismatch searches all combinations and
    returns the first full match (with a printed warning naming the flip).
    Raises ValueError if no layout explains the recording."""
    diags = {}
    for layout in [DEFAULT_LAYOUT] + [l for l in all_layouts()
                                      if l != DEFAULT_LAYOUT]:
        got = fingerprint_state_dict(sd, layout)
        keys = [k for k in expected if k in got]
        if not keys:
            raise ValueError("no probe key of the recording is present in "
                             "the checkpoint")
        diffs = {k: float(np.max(np.abs(np.asarray(got[k]) -
                                        np.asarray(expected[k]))))
                 for k in keys}
        ok = all(np.allclose(got[k], expected[k], atol=atol, rtol=rtol)
                 for k in keys)
        diags[layout_name(layout)] = diffs
        if ok:
            if layout != DEFAULT_LAYOUT:
                print(f"fingerprint: default layout MISMATCHED; "
                      f"auto-flipped to {layout_name(layout)}")
            return layout, diffs
    lines = "\n".join(f"  {n}: {d}" for n, d in diags.items())
    raise ValueError(
        "no kernel-enumeration layout reproduces the recorded activation "
        f"fingerprints (importer bug or corrupt checkpoint):\n{lines}")


def save_fingerprint(fp: Dict[str, List[float]], path: str) -> None:
    with open(path, "w") as f:
        json.dump({"version": 1, "probes": fp}, f)


def load_fingerprint(path: str) -> Dict[str, List[float]]:
    with open(path) as f:
        d = json.load(f)
    return d["probes"] if "probes" in d else d

"""Streaming incremental reconstruction (port of
eprecon_tpu/inference/pipeline.py; reference models/neuralrecon.py:71-72,
models/gru_fusion.py:259-394, main.py:351-411).

Feed the fragments of one scene in temporal order; the global panoptic
TSDF volume grows; a scene change flushes the finished scene and resets
the state. The recurrent maps and the panoptic map are updated in place
on the device. With GT targets the losses of each fragment are kept on the
device (`last_losses`); a session's state round-trips through one `.npz`
(`save_session` / `restore_session`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from eprecon_tpu_torch.config import Config
from eprecon_tpu_torch.device import DeviceLike, resolve_device
from eprecon_tpu_torch.models.eprecon import (EPRecon, FragmentInputs,
                                              FragmentTargets, RecurrentState,
                                              make_recurrent_state)
from eprecon_tpu_torch.models.gru_fusion import (DenseGlobalLevel,
                                                 DenseTargetLevel,
                                                 PanopticGlobalDense,
                                                 fuse_tsdf_direct)
from eprecon_tpu_torch.models.panoptic.post import panoptic_inference
from eprecon_tpu_torch.ops import grid, sparse as sp


@dataclasses.dataclass
class SceneResult:
    """Finished-scene volumes (reference gru_fusion.py:217-257 save_mesh)."""
    name: str
    origin: np.ndarray        # [3] world origin of the dense crop
    voxel_size: float
    tsdf: np.ndarray          # [X, Y, Z]
    instance: np.ndarray      # [X, Y, Z] int32
    semantic: np.ndarray      # [X, Y, Z] int32
    overflow: int = 0         # voxels dropped by capacity compaction
    clipped: int = 0          # fragments clamped into the global volume


@torch.no_grad()
def fragment_forward(model: EPRecon, cfg: Config, imgs, frag, rec_state,
                     pmap_state, targets: Optional[FragmentTargets] = None):
    """The complete per-fragment inference program: model forward +
    panoptic post-processing + direct-substitute global fusion. With
    `targets` the losses are computed against the GT too, as the reference
    test loop does (main.py:375-401)."""
    outputs, losses, new_rec = model(imgs, frag, rec_state, targets)
    seg = panoptic_inference(outputs["pred_logits"], outputs["pred_masks"],
                             outputs["panoptic_valid"])
    seg_window = sp.sparse_to_dense(
        outputs["coords"][:, 1:], seg.voxel_seg[:, None], outputs["valid"],
        cfg.model.n_vox)[..., 0]
    new_pmap = fuse_tsdf_direct(
        pmap_state, outputs["tsdf_window"], outputs["occupancy"], seg_window,
        seg.seg_class, seg.seg_isthing, seg.seg_valid, frag.rel_origins[-1])
    return outputs, losses, new_rec, new_pmap


class StreamingReconstructor:
    """Incremental panoptic reconstruction over a fragment stream."""

    def __init__(self, cfg: Config, model: EPRecon, device: DeviceLike = None):
        """`device` defaults to CUDA and raises if it is absent; pass
        device="cpu" to run on the CPU."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.scene_name: Optional[str] = None
        self.global_origin: Optional[np.ndarray] = None
        self.last_losses: Dict[str, torch.Tensor] = {}
        # the last fragment's program inputs (images, FragmentInputs) and
        # outputs, for a caller that holds another server to this one
        self.last_inputs: Optional[tuple] = None
        self.last_outputs: Dict[str, torch.Tensor] = {}
        self._reset_state()

    def _reset_state(self):
        self.rec_state = make_recurrent_state(self.cfg.model, self.device)
        self.pmap_state = PanopticGlobalDense.empty(
            tuple(self.cfg.model.global_extent), device=self.device)
        self._overflows = []  # device scalars, read once per scene
        self.clipped_fragments = 0

    def process_fragment(self, scene: str, imgs: np.ndarray,
                         proj_matrices: np.ndarray, vol_origin: np.ndarray,
                         vol_origin_partial: np.ndarray,
                         world_to_aligned_camera: np.ndarray,
                         targets: Optional[FragmentTargets] = None,
                         anchor: Optional[np.ndarray] = None
                         ) -> Optional[SceneResult]:
        """Feed one fragment. Returns the finished previous scene when the
        scene name changes, else None. With cfg.model.scene_anchor ==
        "window_union" and an `anchor`, the global volume anchors there;
        otherwise below `vol_origin`. With `targets` (on this device),
        `last_losses` holds the fragment's losses as device scalars."""
        finished = None
        self.last_outputs = {}  # not held through this fragment's forward
        m = self.cfg.model
        if scene != self.scene_name:
            if self.scene_name is not None:
                finished = self.flush()
            self.scene_name = scene
            if m.scene_anchor == "window_union" and anchor is not None:
                self.global_origin = grid.anchored_global_origin(
                    anchor, m.n_scales, m.voxel_size, m.origin_margin)
            else:
                self.global_origin = grid.scene_global_origin(
                    m.global_extent, m.n_vox, m.n_scales, m.voxel_size,
                    vol_origin, m.origin_margin)
            self._reset_state()

        rel = np.stack([
            np.round((np.asarray(vol_origin_partial) - self.global_origin)
                     / (m.voxel_size * 2 ** (m.n_scales - i))).astype(np.int64)
            for i in range(m.n_layer)])
        fine_hi = np.asarray(m.global_extent) - np.asarray(m.n_vox)
        if (rel[-1] < 0).any() or (rel[-1] > fine_hi).any():
            self.clipped_fragments += 1
            if self.clipped_fragments == 1:
                warnings.warn(
                    f"scene '{scene}' exceeds the global volume (rel_origin "
                    f"{rel[-1].tolist()} outside [0, {fine_hi.tolist()}]); "
                    f"fragment clamped - raise model.global_extent")
        dev = self.device
        frag = FragmentInputs(
            torch.as_tensor(proj_matrices, dtype=torch.float32, device=dev),
            torch.as_tensor(vol_origin_partial, dtype=torch.float32, device=dev),
            torch.as_tensor(world_to_aligned_camera, dtype=torch.float32,
                            device=dev),
            torch.as_tensor(rel, device=dev))
        imgs = np.asarray(imgs)
        if m.transfer_images_uint8 and imgs.dtype != np.uint8:
            imgs = np.clip(np.round(imgs), 0, 255).astype(np.uint8)
        self.last_inputs = (torch.as_tensor(imgs, device=dev), frag)
        outputs, self.last_losses, self.rec_state, self.pmap_state = \
            fragment_forward(self.model, self.cfg, *self.last_inputs,
                             self.rec_state, self.pmap_state, targets)
        self.last_outputs = outputs
        self._overflows.append(outputs["overflow"])
        return finished

    def flush(self) -> Optional[SceneResult]:
        """Crop and return the current scene (reference save_mesh)."""
        pm = self.pmap_state
        mask = pm.mask.cpu().numpy()
        if not mask.any():
            return None
        occ = np.argwhere(mask)
        lo = occ.min(0)
        hi = occ.max(0) + 1
        sl = tuple(slice(a, b) for a, b in zip(lo, hi))
        vol_t = np.where(mask[sl], pm.tsdf[sl].cpu().numpy(), 1.0).astype(np.float32)
        vol_i = pm.instance[sl].cpu().numpy()
        vol_s = pm.semantic[sl].cpu().numpy()
        origin = self.global_origin + lo * self.cfg.model.voxel_size
        ovf = int(torch.stack(self._overflows).sum()) if self._overflows else 0
        return SceneResult(self.scene_name, origin, self.cfg.model.voxel_size,
                           vol_t, vol_i, vol_s, overflow=ovf,
                           clipped=self.clipped_fragments)

    def snapshot(self) -> Optional[SceneResult]:
        """The scene in progress, without ending it (backs the
        save_incremental export, reference utils.py:318-360)."""
        return self.flush()

    # ------------------------------------------------------------------
    # mid-scene session checkpointing: the recurrent maps, the panoptic
    # map, the origin and the overflow counters round-trip through one
    # .npz, so a session continues exactly after a restart
    # ------------------------------------------------------------------

    def _state_arrays(self) -> Dict[str, torch.Tensor]:
        out = {}
        for i, g in enumerate(self.rec_state.gmaps):
            out[f"gmap{i}_feats"], out[f"gmap{i}_mask"] = g.feats, g.mask
        for i, t in enumerate(self.rec_state.tmaps):
            out[f"tmap{i}_tsdf"], out[f"tmap{i}_occ"] = t.tsdf, t.occ
        for f in dataclasses.fields(PanopticGlobalDense):
            out[f"pmap_{f.name}"] = getattr(self.pmap_state, f.name)
        return out

    def save_session(self, path: str):
        """Write the state of the scene in progress to an .npz (bf16 maps
        widened to f32, which is exact)."""
        def host(x: torch.Tensor) -> np.ndarray:
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

        np.savez_compressed(
            path, scene=np.asarray(self.scene_name or ""),
            origin=(self.global_origin if self.global_origin is not None
                    else np.full(3, np.nan, np.float32)),
            overflows=np.asarray([int(o) for o in self._overflows], np.int64),
            clipped=np.asarray(self.clipped_fragments, np.int64),
            **{k: host(v) for k, v in self._state_arrays().items()})

    def restore_session(self, path: str):
        """Resume a session written by save_session, or by the JAX
        package's save_session (recognised by its `rec_0` entry); the
        continuation is exact."""
        self._reset_state()
        refs = self._state_arrays()
        with np.load(path) as z:
            name = str(z["scene"])
            self.scene_name = name or None
            origin = z["origin"]
            self.global_origin = (None if np.isnan(origin).any()
                                  else np.asarray(origin, np.float32))
            arrays = (_jax_session_arrays(z, self.cfg.model.n_layer)
                      if "rec_0" in z.files else {k: z[k] for k in refs})
            dev = self.device
            state = {}
            for k, ref in refs.items():
                a = arrays[k]
                if k.endswith("_feats") and a.ndim == 3:   # JAX's [Gx, Gy, Gz*C]
                    a = a.reshape(*a.shape[:2], -1, ref.shape[-1])
                if tuple(a.shape) != tuple(ref.shape):
                    raise ValueError(f"session {k}: shape {tuple(a.shape)}, "
                                     f"this config's {tuple(ref.shape)}")
                state[k] = torch.as_tensor(a, device=dev).to(ref.dtype)
            self._overflows = [torch.tensor(int(v), dtype=torch.int32, device=dev)
                               for v in z["overflows"]]
            self.clipped_fragments = int(z["clipped"])
        n = self.cfg.model.n_layer
        self.rec_state = RecurrentState(
            tuple(DenseGlobalLevel(state[f"gmap{i}_feats"], state[f"gmap{i}_mask"])
                  for i in range(n)),
            tuple(DenseTargetLevel(state[f"tmap{i}_tsdf"], state[f"tmap{i}_occ"])
                  for i in range(n)))
        self.pmap_state = PanopticGlobalDense(
            **{f.name: state[f"pmap_{f.name}"]
               for f in dataclasses.fields(PanopticGlobalDense)})


# the JAX package's session leaves in its flattening order (own copy):
# RecurrentState(gmaps, tmaps) gives per level DenseGlobalLevel(feats,
# mask), then per level DenseTargetLevel(tsdf, occ)
# (eprecon_tpu/models/eprecon.py:71-80); PanopticGlobalDense gives
# (tsdf, instance, semantic, mask, next_instance_id)
# (eprecon_tpu/models/gru_fusion.py:170-183)
JAX_PMAP_LEAVES = ("tsdf", "instance", "semantic", "mask", "next_instance_id")


def _jax_session_arrays(z, n_layer: int) -> Dict[str, np.ndarray]:
    """The JAX session's rec_{i} and pmap_{i} under the port's state names."""
    rec = ([f"gmap{i}_{f}" for i in range(n_layer) for f in ("feats", "mask")]
           + [f"tmap{i}_{f}" for i in range(n_layer) for f in ("tsdf", "occ")])
    pmap = [f"pmap_{f}" for f in JAX_PMAP_LEAVES]
    if f"rec_{len(rec)}" in z.files or f"rec_{len(rec) - 1}" not in z.files:
        raise ValueError(f"the JAX session's recurrent state is not of "
                         f"{n_layer} levels")
    out = {name: z[f"rec_{i}"] for i, name in enumerate(rec)}
    out.update({name: z[f"pmap_{i}"] for i, name in enumerate(pmap)})
    return out

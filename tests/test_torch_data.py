"""The port's data pipeline against the JAX package's, on the same inputs:
the sampler, the transforms (resize, projections, world-frame augmentation
with the GT re-fusion), the ScanNet dataset and the global-extent fit.

The on-disk data is the JAX tools' own ScanNet-layout tree
(`torch_parity.write_scannet_fixture`: 2 scenes of 20 frames at 120x160,
GT at 0.24 m). The port runs its GT fusion on the CPU in these tests
(device="cpu"); by default the same code runs it on CUDA.
"""
import copy
import dataclasses

import cv2
import numpy as np
import pytest

from torch_parity import (assert_exemption_caps, one_torch_thread,
                          rounding_boundary_levels, write_scannet_fixture)

from eprecon_tpu import main as jmain
from eprecon_tpu.config import default_config as jax_config
from eprecon_tpu.data import extent as jextent
from eprecon_tpu.data import sampler as jsampler
from eprecon_tpu.data import scannet as jscannet
from eprecon_tpu.data import transforms as jtf
from eprecon_tpu_torch import main as tmain
from eprecon_tpu_torch.config import load_config
from eprecon_tpu_torch.data import extent as textent
from eprecon_tpu_torch.data import sampler as tsampler
from eprecon_tpu_torch.data import transforms as ttf

IMG_TOL = 1e-3 * 255   # resize vs cv2: bilinear weights rounded differently
GEOM_TOL = 1e-5        # f32 matrix products (XLA vs numpy), of each scale
TSDF_TOL = 1e-5        # f32 fusion, as tests/test_torch_train_parts.py


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_scannet_fixture(tmp_path_factory.mktemp("synthscan"))


def _configs(root, **model):
    """(JAX Config, port Config) at the fixture's widths."""
    jc = jax_config()
    jc = dataclasses.replace(
        jc, model=dataclasses.replace(jc.model, n_vox=(16, 16, 16),
                                      voxel_size=0.24, **model),
        train=dataclasses.replace(jc.train, path=str(root)),
        test=dataclasses.replace(jc.test, path=str(root)))
    tc = load_config(None, [("model.n_vox", (16, 16, 16)),
                            ("model.voxel_size", 0.24),
                            ("train.path", str(root)), ("test.path", str(root))]
                     + [(f"model.{k}", v) for k, v in model.items()])
    return jc, tc


def _close(got, want, tol, name):
    """max |got - want| <= tol * max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, (name, np.abs(got - want).max())


@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("scenes", ["aabbbccd", "abcdefgh"])
def test_sampler_matches_jax(shards, shuffle, scenes):
    """Identical index streams, every shard, three epochs."""
    ids = list(scenes)
    for shard in range(shards):
        j = jsampler.ContiguousDistributedSampler(len(ids), shards, shard,
                                                  shuffle, 5, ids)
        t = tsampler.ContiguousDistributedSampler(len(ids), shards, shard,
                                                  shuffle, 5, ids)
        assert len(t) == len(j)
        for epoch in range(3):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            assert list(t) == list(j)
    assert tsampler.scene_runs(ids) == jsampler.scene_runs(ids)


@pytest.mark.parametrize("hw", [(968, 1296), (120, 160)])
def test_resize_matches_cv2(hw):
    """ResizeImage (F.interpolate, half-pixel bilinear) against the JAX
    package's (cv2 INTER_LINEAR), ScanNet's pad included: images within
    1e-3 of 255, intrinsics equal."""
    rng = np.random.default_rng(0)
    h, w = hw
    intr = np.array([[1170.2, 0, 647.8], [0, 1170.2, 483.7], [0, 0, 1]],
                    np.float32) * np.array([[w / 1296], [h / 968], [1]],
                                           np.float32)
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.float32) for _ in range(2)]
    data = dict(imgs=imgs, intrinsics=[intr, intr * 1.01])
    want = jtf.ResizeImage((640, 480))(copy.deepcopy(data))
    got = ttf.ResizeImage((640, 480))(copy.deepcopy(data))
    for g, w_ in zip(got["imgs"], want["imgs"]):
        assert g.shape == w_.shape == (480, 640, 3) and g.dtype == np.float32
        assert np.abs(g - w_).max() <= IMG_TOL
    for g, w_ in zip(got["intrinsics"], want["intrinsics"]):
        np.testing.assert_array_equal(g, w_)
    # the resize itself is cv2's, unpadded too
    np.testing.assert_allclose(ttf.resize_bilinear(imgs[0], (640, 480)),
                               cv2.resize(imgs[0], (640, 480)), atol=IMG_TOL)


def test_projection_matches_jax(root):
    """IntrinsicsPoseToProjection on the fixture's cameras: projections and
    the aligned-camera transform within 1e-5 of their scale (f32 inverse
    and products in XLA vs numpy)."""
    ds = jscannet.ScanNetDataset(str(root), "train", None, 9, 2)
    for i in range(len(ds)):
        raw = ds[i]
        data = dict(intrinsics=raw["intrinsics"], extrinsics=raw["extrinsics"])
        want = jtf.IntrinsicsPoseToProjection(9, stride=4)(dict(data))
        got = ttf.IntrinsicsPoseToProjection(9, stride=4)(dict(data))
        for k in ("proj_matrices", "world_to_aligned_camera"):
            assert got[k].dtype == np.float32
            _close(got[k], want[k], GEOM_TOL, k)


def _assert_gt_equal(got, want, dim):
    """GT windows: tsdf within 1e-5, occupancy and labels exact at every
    voxel, except voxels whose projection lies within 1e-4 px of a
    pixel-rounding boundary in some view (torch_parity.on_rounding_boundary:
    f32 fusion may round such a voxel to either neighbouring depth pixel).
    Every disagreement must lie on such a boundary, and the boundary voxels
    that disagree are held to torch_parity.assert_exemption_caps. The caps
    count disagreements, not the boundary itself: a 16^3 window's 8^3 level
    holds 512 voxels, of which 6 lie on a boundary in some fragments, over
    the one-column cap, while few of them disagree."""
    dims = [tuple(v // 2 ** lvl for v in dim) for lvl in range(3)]
    wt = [np.asarray(x) for x in want["tsdf_list"]]
    wo = [np.asarray(x) for x in want["occ_list"]]
    for lvl in range(3):
        assert got["tsdf_list"][lvl].shape == wt[lvl].shape == dims[lvl]
    differs = [(np.abs(got["tsdf_list"][lvl] - wt[lvl]) > TSDF_TOL)
               | (got["occ_list"][lvl] != wo[lvl]) for lvl in range(3)]
    for k in ("semantic", "instance"):
        if k in want:
            assert got[k].shape == np.asarray(want[k]).shape == dims[0], k
            differs[0] |= got[k] != np.asarray(want[k])
    near = rounding_boundary_levels(
        got["vol_origin_partial"],
        np.stack(got["extrinsics"]).astype(np.float32),
        np.stack(got["intrinsics"]), dims, 0.24)
    for lvl in range(3):
        off = differs[lvl] & ~near[lvl]
        assert not off.any(), (lvl, np.argwhere(off)[:8].tolist())
    assert_exemption_caps([d & n for d, n in zip(differs, near)])
    assert got["occ_list"][0].sum() > 20


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("epoch", [0, 3])
def test_random_transform_space_matches_jax(root, mode, epoch):
    """RandomTransformSpace on the fixture's raw fragments (augmented in
    train mode, identity in test mode): window origin exact, augmented
    cameras and origin exact, labels equal, GT as in _assert_gt_equal."""
    aug = mode == "train"
    kw = dict(random_rotation=aug, random_translation=aug, paddingXY=0.1,
              paddingZ=0.025)
    jrts = jtf.RandomTransformSpace((16, 16, 16), 0.24, **kw)
    trts = ttf.RandomTransformSpace((16, 16, 16), 0.24, device="cpu", **kw)
    ds = jscannet.ScanNetDataset(str(root), mode, None, 9, 2, epoch=epoch)
    for i in range(len(ds)):
        raw = ds[i]
        want = jrts(copy.deepcopy(raw))
        got = trts(copy.deepcopy(raw))
        np.testing.assert_array_equal(got["vol_origin_partial"],
                                      want["vol_origin_partial"])
        np.testing.assert_array_equal(got["vol_origin"], want["vol_origin"])
        np.testing.assert_array_equal(np.stack(got["extrinsics"]),
                                      np.stack(want["extrinsics"]))
        assert set(got) == set(want)
        _assert_gt_equal(got, want, (16, 16, 16))


def test_dataset_items_match_jax(root):
    """ScanNetDataset[i] through build_dataset, every fragment of both
    splits at epochs 0 and 1: every key of the sample, global_anchor
    included. Exact except images (1e-3 of 255), projections (1e-5 of
    scale) and the GT (_assert_gt_equal)."""
    jc, tc = _configs(root)
    for mode in ("train", "test"):
        jds = jmain.build_dataset(jc, mode)
        tds = tmain.build_dataset(tc, mode, device="cpu")
        assert len(tds) == len(jds) == 4
        for epoch in (0, 1):
            jds.epoch = tds.epoch = epoch
            for i in range(len(jds)):
                want, got = jds[i], tds[i]
                assert set(got) == set(want)
                for k in ("scene", "fragment", "epoch"):
                    assert got[k] == want[k], k
                for g, w in zip(got["imgs"], want["imgs"]):
                    assert np.abs(g - w).max() <= IMG_TOL
                for k in ("intrinsics", "extrinsics"):
                    np.testing.assert_array_equal(np.stack(got[k]),
                                                  np.stack(want[k]), k)
                for k in ("vol_origin", "vol_origin_partial", "global_anchor"):
                    np.testing.assert_array_equal(got[k], want[k], k)
                for k in ("proj_matrices", "world_to_aligned_camera"):
                    _close(got[k], np.asarray(want[k]), GEOM_TOL, k)
                _assert_gt_equal(got, want, (16, 16, 16))


@pytest.mark.parametrize("anchor", ["window_union", "vol_origin"])
def test_fit_global_extent_matches_jax(root, anchor):
    """model.global_extent_auto's fit, test mode (exact placement) and
    train mode (augmentation sweep, capped): equal."""
    jc, tc = _configs(root, scene_anchor=anchor)
    assert (textent.fit_global_extent(tc, "test", round_to=8)
            == jextent.fit_global_extent(jc, "test", round_to=8))
    kw = dict(epochs=3, round_to=8, cap=(64, 64, 48), cap_margin=24)
    assert (textent.fit_global_extent(tc, "train", **kw)
            == jextent.fit_global_extent(jc, "train", **kw))


@pytest.mark.parametrize("mode", ["train", "test"])
def test_getitem_decoded_matches_getitem(root, mode):
    """ScanNetDataset.getitem_decoded, the entry for frames decoded ahead
    (ScanNet pad and resize applied by the decoder), fed the frames of
    `image_paths` padded and resized as ResizeImage does and the depths at
    their own resolution: the sample equals ds[i] at every key, exactly
    (the same inputs reach _build_sample; the transforms' resize is then
    the identity)."""
    _, tc = _configs(root)
    ds = tmain.build_dataset(tc, mode, device="cpu")
    for i in range(len(ds)):
        cpaths, dpaths = ds.image_paths(i)
        imgs = np.stack([ttf.resize_bilinear(
            ttf.pad_scannet(ds._read_img(p), np.eye(3))[0], (640, 480))
            for p in cpaths])
        depths = np.stack([ds._read_depth(p) for p in dpaths])
        got, want = ds.getitem_decoded(i, imgs, depths), ds[i]
        assert set(got) == set(want)
        for k, w in want.items():
            if isinstance(w, list):
                assert len(got[k]) == len(w), k
                for g, w_ in zip(got[k], w):
                    np.testing.assert_array_equal(g, w_, k)
            elif isinstance(w, np.ndarray):
                np.testing.assert_array_equal(got[k], w, k)
            else:
                assert got[k] == w, k

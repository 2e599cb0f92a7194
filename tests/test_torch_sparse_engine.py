"""The port's sparse voxel engine (`eprecon_tpu_torch/ops/sparse.py`:
hashed grids, lookups, neighbour maps, the gather-GEMM conv, voxelise /
devoxelise, downsampling) against eprecon_tpu/ops/sparse.py on seeded
numpy inputs, the cases of tests/test_sparse.py.

Integer results are exact and f32 results within 1e-5 (relative, with an
absolute floor of 1e-5). Where several rows hold one coordinate, the
JAX table's representative is XLA's choice and the port's the largest
row, so per-voxel results are compared keyed by coordinate and per-point
results directly.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import one_torch_thread, t

from eprecon_tpu.ops import sparse as jsp
from eprecon_tpu_torch.ops import sparse as tsp

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=TOL, atol=TOL)


def voxel_sets(rng, n_active, capacity, span=20, channels=8, dup=0):
    """(JAX SparseVoxels, port SparseVoxels, coords [n, 4], feats [n, C]):
    n_active random coords, the last `dup` of them repeating earlier
    ones, then invalid padding rows."""
    flat = rng.choice(span ** 3, size=n_active - dup, replace=False)
    flat = np.concatenate([flat, rng.choice(flat, size=dup)])
    x, y, z = flat // (span * span), (flat // span) % span, flat % span
    c = np.stack([np.zeros(n_active), x, y, z], axis=1).astype(np.int32)
    f = rng.standard_normal((n_active, channels)).astype(np.float32)
    pad = capacity - n_active
    coords = np.concatenate([c, np.zeros((pad, 4), np.int32)])
    feats = np.concatenate([f, np.zeros((pad, channels), np.float32)])
    valid = np.arange(capacity) < n_active
    return (jsp.SparseVoxels(jnp.asarray(coords), jnp.asarray(feats),
                             jnp.asarray(valid)),
            tsp.SparseVoxels(t(coords), t(feats), t(valid)), c, f)


def point_sets(rng, n, cap, c, span=5.0, batch=None):
    xyz = rng.uniform(0, span, (n, 3)).astype(np.float32)
    feats = rng.standard_normal((n, c)).astype(np.float32)
    b = np.zeros(n, np.int32) if batch is None else batch
    pad = cap - n
    arrays = (np.concatenate([xyz, np.zeros((pad, 3), np.float32)]),
              np.concatenate([b, np.zeros(pad, np.int32)]),
              np.concatenate([feats, np.zeros((pad, c), np.float32)]),
              np.arange(cap) < n)
    return (jsp.PointSet(*map(jnp.asarray, arrays)),
            tsp.PointSet(*map(t, arrays)), xyz, feats)


def by_coord(coords, valid, values):
    """{coordinate tuple: value row} over the valid rows."""
    coords, valid, values = map(np.asarray, (coords, valid, values))
    return {tuple(c): v for c, v, ok in zip(coords, values, valid) if ok}


def assert_same_voxels(jgrid, tgrid):
    """The two grids hold the same valid coordinates with the same
    features."""
    jv, tv = jgrid.voxels, tgrid.voxels
    want = by_coord(jv.coords, jv.valid, jv.feats)
    got = by_coord(tv.coords, tv.valid, tv.feats)
    assert got.keys() == want.keys()
    assert int(tv.num_valid()) == int(jv.num_valid()) == len(got)
    for key in want:
        close(got[key], want[key])


def test_voxel_set_properties(rng):
    _, tv, _, _ = voxel_sets(rng, 30, 48, channels=5)
    assert (tv.capacity, tv.channels, int(tv.num_valid())) == (48, 5, 30)


@pytest.mark.parametrize("dup", [0, 12])
def test_build_hash_and_lookup(rng, dup):
    jv, tv, coords, _ = voxel_sets(rng, 100, 128, dup=dup)
    jg, tg = jsp.build_hash(jv, (64, 64, 64)), tsp.build_hash(tv, (64, 64, 64))
    np.testing.assert_array_equal(tg.offset.numpy(), np.asarray(jg.offset))
    # every coordinate is found, at a row holding that coordinate
    jrow = np.asarray(jsp.lookup(jg, jnp.asarray(coords)))
    trow = tsp.lookup(tg, t(coords)).numpy()
    assert (trow >= 0).all() and (jrow >= 0).all()
    np.testing.assert_array_equal(coords[trow], coords)
    # the table indexes the same cells; its rows agree wherever a coordinate
    # is held by one row, and the port's representative is the largest row
    jt, tt = np.asarray(jg.table), tg.table.numpy()
    np.testing.assert_array_equal(tt >= 0, jt >= 0)
    for row, c in enumerate(coords):
        holders = np.flatnonzero((coords == c).all(axis=1))
        assert trow[row] == holders.max()
        if len(holders) == 1:
            assert jrow[row] == trow[row]
    # absent coordinates and masked queries miss
    miss = coords.copy()
    miss[:, 1] += 1000
    assert (tsp.lookup(tg, t(miss)).numpy() == -1).all()
    qv = np.arange(len(coords)) % 2 == 0
    masked = tsp.lookup(tg, t(coords), t(qv)).numpy()
    np.testing.assert_array_equal(masked, np.where(qv, trow, -1))
    jmasked = np.asarray(jsp.lookup(jg, jnp.asarray(coords), jnp.asarray(qv)))
    np.testing.assert_array_equal(jmasked >= 0, qv)


def test_gather_rows_and_kernel_offsets(rng):
    for ks in (2, 3):
        np.testing.assert_array_equal(tsp.kernel_offsets(ks),
                                      jsp.kernel_offsets(ks))
    feats = rng.standard_normal((10, 3)).astype(np.float32)
    idx = rng.integers(-1, 10, (6, 4))
    close(tsp.gather_rows(t(feats), t(idx)).numpy(),
          jsp.gather_rows(jnp.asarray(feats), jnp.asarray(idx)))


def test_neighbor_map_and_subm_conv(rng):
    """Submanifold conv: the neighbour maps are equal row for row, the
    outputs within 1e-5 (and the dense-conv oracle of tests/test_sparse.py
    holds for the port too)."""
    span, cin, cout = 10, 4, 6
    jv, tv, coords, feats = voxel_sets(rng, 60, 64, span=span, channels=cin)
    jg, tg = jsp.build_hash(jv, (span,) * 3), tsp.build_hash(tv, (span,) * 3)
    offsets = jsp.kernel_offsets(3)
    jmap = jsp.neighbor_map(jg, jg.voxels.coords, jg.voxels.valid, offsets)
    tmap = tsp.neighbor_map(tg, tg.voxels.coords, tg.voxels.valid, offsets)
    np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))
    w = rng.standard_normal((27, cin, cout)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    want = jsp.sparse_conv_apply(jg.voxels.feats, jmap, jnp.asarray(w),
                                 jnp.asarray(bias), out_valid=jg.voxels.valid)
    got = tsp.sparse_conv_apply(tg.voxels.feats, tmap, t(w), t(bias),
                                out_valid=tg.voxels.valid).numpy()
    close(got, want)

    dense = np.zeros((span + 2,) * 3 + (cin,), np.float32)
    dense[coords[:, 1] + 1, coords[:, 2] + 1, coords[:, 3] + 1] = feats
    dense_out = np.zeros((span + 2,) * 3 + (cout,), np.float32)
    for o, (dx, dy, dz) in enumerate(offsets):
        dense_out += np.roll(dense, (-dx, -dy, -dz), axis=(0, 1, 2)) @ w[o]
    oracle = dense_out[coords[:, 1] + 1, coords[:, 2] + 1, coords[:, 3] + 1]
    np.testing.assert_allclose(got[:60] - bias, oracle, rtol=1e-4, atol=1e-4)


def test_voxelize_and_point_to_voxel(rng):
    """Voxel means keyed by coordinate, each point's voxel row holding its
    own coordinate, and point_to_voxel over the same links."""
    n, cap, c = 120, 160, 3
    batch = (rng.uniform(size=n) < 0.3).astype(np.int32)
    jp, tp, xyz, feats = point_sets(rng, n, cap, c, batch=batch)
    jg, jq = jsp.voxelize(jp, 1.0, (8, 8, 8), n_batch=2)
    tg, tq = tsp.voxelize(tp, 1.0, (8, 8, 8), n_batch=2)
    assert_same_voxels(jg, tg)
    vox = np.concatenate([batch[:, None], np.floor(xyz).astype(np.int32)], 1)
    tq = tq.numpy()
    np.testing.assert_array_equal(tg.voxels.coords.numpy()[tq[:n]], vox)
    np.testing.assert_array_equal(tq[n:], -1)
    np.testing.assert_array_equal(np.asarray(jg.voxels.coords)[np.asarray(jq)[:n]],
                                  vox)
    # each voxel's mean is its points' mean
    got = by_coord(tg.voxels.coords, tg.voxels.valid, tg.voxels.feats)
    for key in {tuple(v) for v in vox}:
        close(got[key], feats[(vox == key).all(axis=1)].mean(0))

    new_feats = rng.standard_normal((cap, 5)).astype(np.float32)
    jv = jsp.point_to_voxel(jg, jp._replace(feats=jnp.asarray(new_feats)), jq)
    tv = tsp.point_to_voxel(tg, tp._replace(feats=t(new_feats)), t(tq))
    assert_same_voxels(jsp.HashedGrid(jv, jg.table, jg.offset),
                       tsp.HashedGrid(tv, tg.table, tg.offset))


def test_devoxelize_trilinear(rng):
    """Per point within 1e-5 on random voxel features, and a linear field
    reproduced at interior points."""
    span = 8
    grid = np.stack(np.meshgrid(*[np.arange(span)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    keep = rng.uniform(size=len(grid)) < 0.8  # missing corners add zero
    coords = np.concatenate([np.zeros((len(grid), 1)), grid], 1).astype(np.int32)
    linear = np.stack([grid[:, 0], grid[:, 1] + 2.0 * grid[:, 2]], 1)
    for feats, valid in ((rng.standard_normal((len(grid), 4)), keep),
                         (linear, np.ones(len(grid), bool))):
        feats = feats.astype(np.float32)
        jg = jsp.build_hash(jsp.SparseVoxels(jnp.asarray(coords),
                                             jnp.asarray(feats),
                                             jnp.asarray(valid)), (span,) * 3)
        tg = tsp.build_hash(tsp.SparseVoxels(t(coords), t(feats), t(valid)),
                            (span,) * 3)
        jp, tp, xyz, _ = point_sets(rng, 40, 64, 1, span=span - 1.0)
        got = tsp.devoxelize_trilinear(tg, tp, 1.0).numpy()
        close(got, jsp.devoxelize_trilinear(jg, jp, 1.0))
    inner = (xyz >= 1) & (xyz <= span - 2)
    rows = inner.all(axis=1)
    close(got[:40][rows], np.stack([xyz[:, 0], xyz[:, 1] + 2 * xyz[:, 2]],
                                   1)[rows])


def test_downsample_coords(rng):
    jv, tv, coords, _ = voxel_sets(rng, 40, 64, span=16, channels=2, dup=5)
    jg, jparent = jsp.downsample_coords(jv, (10, 10, 10))
    tg, tparent = tsp.downsample_coords(tv, (10, 10, 10))
    assert_same_voxels(jg, tg)
    expect = coords // np.array([1, 2, 2, 2])
    np.testing.assert_array_equal(tg.voxels.coords.numpy()[tparent.numpy()[:40]],
                                  expect)
    np.testing.assert_array_equal(tparent.numpy()[40:], -1)

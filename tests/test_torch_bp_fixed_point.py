"""The back-projection backward's fixed point, on the CPU
(eprecon_tpu_torch.ops.back_project: fixed_point_exponent, scatter_corners,
fixed_to_float and the plain backwards that use them): sums that do not
depend on the order of their terms, the scale rule's overflow bound and
resolution, and NaN for a non-finite input. The CUDA kernels repeat this
arithmetic and are held to the plain versions bit for bit on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py); the plain versions are
held to the JAX package by tests/test_torch_bp_backward.py.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_back_project import H, W, _cameras
from test_torch_bp_backward import _variance_inputs
from torch_parity import one_torch_thread

from eprecon_tpu_torch.ops import back_project as tbp

BF16_MAX = float(torch.finfo(torch.bfloat16).max)
# rows of the cotangent at the path's four call shapes (variance: the
# occupancy init's 48^3 coordinate list; then the stage windows)
PATH_ROWS = {"occ_init_variance": 48 ** 3, "stage0_window": 24 ** 3,
             "stage1_window": 48 ** 3, "stage2_window": 96 ** 3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    return _cameras(5, rng), np.array([[0.0013, 0.0029, 0.0041]], np.float32)


def _window_inputs(scene, dim=(8, 8, 8), c=16, seed=0):
    proj, origin = (torch.from_numpy(x) for x in scene)
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal((5, 1, H, W, c)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((*dim, c)).astype(np.float32))
    count = tbp.back_project_window_plain(dim, 2, origin, 0.1, feats, proj)[1]
    return dim, origin, proj, count, ct


def _window_terms(dim, origin, proj, count, ct):
    """Every term the window mean's plain backward rounds, as
    scatter_corners forms it (f32): (entry index into the flat [V, H*W, C]
    table, term) per corner of every visible (voxel, view), channel by
    channel."""
    c = ct.shape[-1]
    world = tbp._window_world(dim, 2, origin, 0.1, "cpu")
    d = ct.reshape(-1, c).float() / count.reshape(-1, 1).clamp(min=1.0)
    idx, terms = [], []
    for vi in range(proj.shape[0]):
        u, v, m = tbp.project_to_view(world, proj[vi, 0].float(), H, W)
        u0, v0 = torch.floor(u), torch.floor(v)
        du, dv = u - u0, v - v0
        iu, iv = torch.where(m, u0, 0).long(), torch.where(m, v0, 0).long()
        for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            pu, pv = iu + cx, iv + cy
            wgt = (du if cx else 1 - du) * (dv if cy else 1 - dv)
            wgt = torch.where((pu <= W - 1) & (pv <= H - 1) & m, wgt, 0.0)
            px = pv.clamp(max=H - 1) * W + pu.clamp(max=W - 1)
            idx.append(((vi * H * W + px)[:, None] * c + torch.arange(c)).reshape(-1))
            terms.append((wgt[:, None] * d).reshape(-1))
    return torch.cat(idx).numpy(), torch.cat(terms).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_variance_gradient_is_independent_of_row_order(scene, seed):
    """The variance's plain gradient over a coordinate list whose rows (with
    their valid flags, counts and cotangents) are permuted is bitwise the
    same: every term is rounded once and the sums are integer ones."""
    coords, valid, origin2, feats, proj2, ct = (
        torch.from_numpy(x) for x in _variance_inputs(*scene, 16, 2))
    count = tbp.back_project_variance_plain(coords, valid, origin2, 0.1, feats,
                                            proj2)[1]
    want = tbp.variance_backward_plain(coords, valid, origin2, 0.1, feats,
                                       proj2, count, ct)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(len(coords)))
    got = tbp.variance_backward_plain(coords[perm], valid[perm], origin2, 0.1,
                                      feats, proj2, count[perm], ct[perm])
    assert want.abs().max() > 0
    assert torch.equal(got, want)


def test_window_gradient_is_independent_of_voxel_order(scene):
    """The window mean's gradient, each view's voxels scattered in reverse
    order through the plain scatter, is bitwise the plain backward's."""
    dim, origin, proj, count, ct = _window_inputs(scene)
    want = tbp.window_backward_plain(dim, 2, origin, 0.1, proj, count, ct, H, W)
    c = ct.shape[-1]
    ctf = ct.reshape(-1, c).float()
    fixed = tbp.fixed_point_exponent(ctf.shape[0], ctf.abs().amax())
    d = ctf / count.reshape(-1, 1).clamp(min=1.0)
    rev = torch.arange(ctf.shape[0] - 1, -1, -1)
    world = tbp._window_world(dim, 2, origin, 0.1, "cpu")[rev]
    grad = torch.zeros(proj.shape[0], H * W, c, dtype=torch.int64)
    for vi in range(proj.shape[0]):
        u, v, m = tbp.project_to_view(world, proj[vi, 0].float(), H, W)
        tbp.scatter_corners(grad[vi], 0, u, v, m, d[rev], H, W, fixed)
    got = tbp.fixed_to_float(grad, fixed)
    assert (count > 1).any() and want.abs().max() > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(PATH_ROWS))
def test_resolution_at_the_path_shapes(name):
    """e = 62 - ceil(log2 N) - k, k the frexp exponent of the bound: at
    stage 2 (N = 884,736) a resolution 2^-e of max|ct| * 2^-42 .. 2^-41;
    at every shape N * 2^k * 2^e = 2^62 at most (no overflow)."""
    n = PATH_ROWS[name]
    nb = (n - 1).bit_length()
    for m in (3.5, 1.0, 0.75, 2.0 ** -20, 1e-3, BF16_MAX):
        ct = torch.tensor(m)
        if name == "occ_init_variance":
            e, nan = tbp.fixed_point_exponent(n, ct, torch.tensor(4.0), 9).tolist()
            k = math.frexp(m)[1] + 3 + 2   # |T| < 2^3
        else:
            e, nan = tbp.fixed_point_exponent(n, ct).tolist()
            k = math.frexp(m)[1]
        if nan:
            assert name == "occ_init_variance" and k > 127
            continue
        assert e == min(62 - nb - k, 126)
        assert n * 2.0 ** (k + e) <= 2.0 ** 62
        if name == "stage2_window":
            assert m * 2.0 ** -42 < 2.0 ** -e <= m * 2.0 ** -41


@pytest.mark.parametrize("kind,max_ct,max_t", [
    ("window", BF16_MAX, None), ("window", 2.0 ** 100, None),
    ("window", 1.0, None), ("window", 2.0 ** -70, None),
    ("variance", 2.0 ** 60, 2.0 ** 60), ("variance", 1.0, 8.0)])
def test_no_overflow_at_the_bound(kind, max_ct, max_t):
    """N = 884,736 rows (stage 2), every one adding to the same entry a
    term at the rule's bound (the largest f32 below 2^k: the cotangent
    itself for the window mean, 4 max|ct| max|T| for the variance): the
    int64 sum is exactly N times the rounded term, below 2^63, and the f32
    result is within half a unit per term (2^-e / 2 each) of N terms'
    exact sum, or inf where that sum is beyond f32."""
    n = PATH_ROWS["stage2_window"]
    if kind == "window":
        fixed = tbp.fixed_point_exponent(n, torch.tensor(max_ct))
        k = math.frexp(max_ct)[1]
    else:
        fixed = tbp.fixed_point_exponent(n, torch.tensor(max_ct),
                                         torch.tensor(max_t), 9)
        k = math.frexp(max_ct)[1] + math.frexp(max_t)[1] + 2
    e, nan = fixed.tolist()
    assert not nan
    term = (2.0 - 2.0 ** -23) * 2.0 ** (k - 1)  # the largest f32 below 2^k
    u = torch.full((n,), 3.0)  # every row on pixel (3, 2), weight 1
    v = torch.full((n,), 2.0)
    acc = torch.zeros(H * W, 1, dtype=torch.int64)
    tbp.scatter_corners(acc, 0, u, v, torch.ones(n, dtype=torch.bool),
                        torch.full((n, 1), term), H, W, fixed)
    q = round(term * 2.0 ** e)
    assert int(acc[2 * W + 3, 0]) == n * q and abs(n * q) < 2 ** 62 + n
    assert int(acc.abs().sum()) == n * q  # the other corners added zeros
    got = float(tbp.fixed_to_float(acc, fixed)[2 * W + 3, 0])
    exact = n * term
    if exact >= 2.0 ** 128:
        assert got == math.inf
    else:
        assert abs(got - exact) <= n / 2 * 2.0 ** -e + exact * 2.0 ** -24


@settings(max_examples=20, deadline=None)
@given(shift=st.integers(-80, 100), seed=st.integers(0, 2 ** 16))
def test_within_resolution_of_the_exact_sum(scene, shift, seed):
    """Over cotangent magnitudes 2^-80 .. 2^100: every entry of the plain
    window gradient is within K / 2 * 2^-e (K its terms) of the exact sum
    of its f32 terms, beside the one rounding to f32."""
    dim, origin, proj, count, ct = _window_inputs(scene, seed=seed)
    ct = ct * 2.0 ** shift
    got = tbp.window_backward_plain(dim, 2, origin, 0.1, proj, count, ct, H, W)
    e = int(tbp.fixed_point_exponent(ct[..., 0].numel(), ct.abs().amax())[0])
    idx, terms = _window_terms(dim, origin, proj, count, ct)
    order = np.argsort(idx, kind="stable")
    idx, terms = idx[order], terms[order].astype(np.float64)
    starts = np.flatnonzero(np.r_[True, idx[1:] != idx[:-1]])
    got = got.reshape(-1).double().numpy()
    seen = np.zeros(got.size, bool)
    for lo, hi in zip(starts, np.r_[starts[1:], idx.size]):
        exact = math.fsum(terms[lo:hi])
        slack = (hi - lo) / 2 * 2.0 ** -e + abs(exact) * 2.0 ** -23
        assert abs(got[idx[lo]] - exact) <= slack, (idx[lo], exact, got[idx[lo]])
        seen[idx[lo]] = True
    assert (got[~seen] == 0).all() and seen.any()


@settings(max_examples=20, deadline=None)
@given(shift=st.integers(-60, 60))
def test_scale_follows_the_cotangent_exactly(scene, shift):
    """e moves with max|ct|'s exponent, so a cotangent scaled by 2^shift
    gives the same integer sums and the gradient scaled by 2^shift, bit
    for bit: the resolution is relative to the cotangent."""
    dim, origin, proj, count, ct = _window_inputs(scene)
    want = tbp.window_backward_plain(dim, 2, origin, 0.1, proj, count, ct, H, W)
    got = tbp.window_backward_plain(dim, 2, origin, 0.1, proj, count,
                                    ct * 2.0 ** shift, H, W)
    assert torch.equal(got, want * 2.0 ** shift)


@pytest.mark.parametrize("case", ["window inf", "window nan", "variance inf",
                                  "variance table nan", "variance bound"])
def test_non_finite_input_gives_nan(scene, case):
    """A non-finite cotangent entry (or, for the variance, feature entry,
    or a bound of its terms at 2^127 or more) makes the whole plain
    gradient NaN, never a finite one."""
    if case.startswith("window"):
        dim, origin, proj, count, ct = _window_inputs(scene)
        ct[1, 2, 3, 4] = math.inf if case.endswith("inf") else math.nan
        got = tbp.window_backward_plain(dim, 2, origin, 0.1, proj, count, ct,
                                        H, W)
    else:
        coords, valid, origin2, feats, proj2, ct = (
            torch.from_numpy(x) for x in _variance_inputs(*scene, 16, 2))
        count = tbp.back_project_variance_plain(coords, valid, origin2, 0.1,
                                                feats, proj2)[1]
        if case == "variance inf":
            ct[7, 1] = -math.inf
        elif case == "variance table nan":
            feats[2, 1, 3, 4, 5] = math.nan
        else:  # finite, but 4 max|ct| max|T| >= 2^127
            feats, ct = feats * 2.0 ** 70, ct * 2.0 ** 60
        got = tbp.variance_backward_plain(coords, valid, origin2, 0.1, feats,
                                          proj2, count, ct)
    assert torch.isnan(got).all()

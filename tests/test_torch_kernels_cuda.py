"""The back-projection CUDA kernel against its plain PyTorch version on the
card, at small shapes (the full-size comparison is in chip_smoke.py).
Needs an NVIDIA GPU and nvcc; skips without them. On the card (where JAX
may be missing, so skip tests/conftest.py, which imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from eprecon_tpu_torch.ops import back_project as bp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from eprecon_tpu_torch import kernels
    try:
        kernels.find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc")
    return torch.device("cuda")


def _proj(v, h, w):
    out = np.zeros((v, 1, 4, 4), np.float32)
    for i in range(v):
        k = np.array([[w * 2.0, 0, (w - 1) / 2], [0, w * 2.0, (h - 1) / 2], [0, 0, 1]])
        out[i, 0] = np.eye(4)
        out[i, 0, :3, :4] = k @ np.array([[1, 0, 0, -0.4 - 0.05 * i],
                                          [0, 1, 0, -0.35], [0, 0, 1, 1.2]])
    return torch.from_numpy(out)


@pytest.mark.parametrize("dim,interval,c", [((16, 16, 16), 1, 24),
                                            ((8, 8, 8), 2, 40)])
def test_window_kernel_bitwise(cuda, dim, interval, c):
    rng = np.random.default_rng(0)
    h, w = 15, 20
    feats = torch.from_numpy(rng.standard_normal((4, 1, h, w, c)).astype(np.float32))
    proj = _proj(4, h, w)
    origin = torch.tensor([[0.0013, 0.0027, 0.0031]])
    args = (dim, interval, origin.to(cuda), 0.05, feats.to(cuda), proj.to(cuda))
    before = bp.total_launches()
    got, cnt = bp.back_project_window(*args)
    want, want_cnt = bp.back_project_window_plain(*args)
    torch.cuda.synchronize()
    assert bp.total_launches() == before + 1
    assert torch.equal(cnt, want_cnt) and (cnt > 0).any() and (cnt < 4).any()
    assert torch.equal(got, want)


def test_variance_kernel_bitwise(cuda):
    rng = np.random.default_rng(1)
    h, w, c = 15, 20, 32
    feats = torch.from_numpy(rng.standard_normal((4, 1, h, w, c))).to(torch.bfloat16)
    xyz = np.stack(np.meshgrid(*[np.arange(0, 16, 2)] * 3, indexing="ij"), -1)
    coords = torch.from_numpy(np.concatenate(
        [np.zeros((512, 1)), xyz.reshape(-1, 3)], 1).astype(np.int32))
    valid = torch.from_numpy(rng.uniform(size=512) > 0.1)
    args = (coords.to(cuda), valid.to(cuda), torch.tensor([[0.002, 0.001, 0.003]]).to(cuda),
            0.05, feats.to(cuda), _proj(4, h, w).to(cuda))
    got, cnt = bp.back_project_variance(*args)
    want, want_cnt = bp.back_project_variance_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(cnt, want_cnt) and (cnt >= 2).any()
    assert torch.equal(got, want)


def test_kernel_rejects_bad_input(cuda):
    feats = torch.zeros(2, 1, 4, 4, 12, device=cuda)  # 12 channels: not a multiple of 8
    with pytest.raises(ValueError, match="multiple of 8"):
        bp.back_project_window((2, 2, 2), 1, torch.zeros(1, 3, device=cuda), 0.1,
                               feats, torch.zeros(2, 1, 4, 4, device=cuda))

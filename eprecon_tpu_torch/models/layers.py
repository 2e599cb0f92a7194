"""Channels-last layer primitives with flax.linen's dtype rules.

The JAX package computes in NHWC / [X, Y, Z, C] with flax layers; these
are their PyTorch counterparts on the same layout, so every module of the
port keeps the reference's tensor shapes at its interface:

  * `compute dtype`: with `dtype` set, inputs and parameters are cast to
    it (bf16 convs); without, the input dtype is promoted with the f32
    parameters (bf16 in -> f32 out), as flax's promote_dtype does.
  * normalisation statistics are f32 whatever the input dtype; LayerNorm
    and BatchNorm use flax's E[x^2] - E[x]^2 variance.

Parameters are stored in PyTorch's layouts (conv [Cout, Cin/g, *k], linear
[out, in]); convert.py maps flax trees onto them. A channels-last tensor
permuted to NC* is what cuDNN calls channels_last / channels_last_3d, so
the permutes around a convolution are views, not copies.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Dtype = Optional[torch.dtype]


def compute_dtype(x: torch.Tensor, dtype: Dtype) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype,
                                                               torch.float32)


def mask3(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero inactive voxels: x [..., X, Y, Z, C] * mask [X, Y, Z]."""
    return x * mask[..., None].to(x.dtype)


def _xavier_(w: torch.Tensor, fan_in: int, fan_out: int,
             generator: Optional[torch.Generator]):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]):
    """flax's default kernel init: variance 1 / fan_in from a normal
    truncated at two standard deviations (rescaled to keep the variance)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """flax nn.Conv / nn.ConvTranspose on channels-last input.

    x: [N, *spatial, Cin] or (3D only) unbatched [X, Y, Z, Cin]. `padding`
    is per-side and symmetric ("SAME" for odd kernels at stride 1 is
    kernel // 2). `transpose` gives flax's ConvTranspose (stride = kernel,
    no padding), whose kernel convert.py flips into PyTorch's convention.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int],
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True, dtype: Dtype = None,
                 transpose: bool = False, xavier: bool = False):
        super().__init__()
        self.nd = len(kernel)
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype, self.transpose, self.xavier = dtype, transpose, xavier
        shape = ((in_ch, out_ch // groups) if transpose
                 else (out_ch, in_ch // groups)) + tuple(kernel)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Xavier-uniform (the submanifold 3D convs' init), or flax's
        default lecun-normal (truncated) over the kernel's fan-in; zero
        bias."""
        rf = math.prod(self.weight.shape[2:])
        a, b = self.weight.shape[:2]
        cin, cout = (a, b) if self.transpose else (b, a)
        if self.xavier:
            _xavier_(self.weight, cin * rf, cout * rf, generator)
        else:
            _lecun_normal_(self.weight, cin * rf, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = self.nd
        unbatched = x.ndim == nd + 1
        if unbatched:
            x = x[None]
        dt = compute_dtype(x, self.dtype)
        xc = x.to(dt).movedim(-1, 1)
        w = self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        if self.transpose:
            fn = F.conv_transpose3d if nd == 3 else F.conv_transpose2d
            y = fn(xc, w, b, stride=self.stride)
        else:
            fn = F.conv3d if nd == 3 else F.conv2d
            y = fn(xc, w, b, stride=self.stride, padding=self.padding,
                   groups=self.groups)
        y = y.movedim(1, -1)
        return y[0] if unbatched else y


class Dense(nn.Module):
    """flax nn.Dense: y = x @ kernel + bias over the last axis."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Dtype = None, xavier: bool = False):
        super().__init__()
        self.dtype, self.xavier = dtype, xavier
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Xavier-uniform, or flax's default lecun-normal (truncated)."""
        out_f, in_f = self.weight.shape
        if self.xavier:
            _xavier_(self.weight, in_f, out_f, generator)
        else:
            _lecun_normal_(self.weight, in_f, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x, self.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


def _affine(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            scale: torch.Tensor, bias: torch.Tensor, eps: float,
            dtype: Dtype) -> torch.Tensor:
    """flax _normalize: (x - mean) * (rsqrt(var + eps) * scale) + bias in
    f32, cast to `dtype` (or f32)."""
    y = (x.float() - mean) * (torch.rsqrt(var + eps) * scale) + bias
    return y.to(dtype or torch.float32)


def _fast_stats(x: torch.Tensor, dims):
    x32 = x.float()
    mean = x32.mean(dims)
    var = (x32.square().mean(dims) - mean.square()).clamp(min=0.0)
    return mean, var


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis (f32 statistics)."""

    def __init__(self, features: int, eps: float = 1e-5, dtype: Dtype = None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _fast_stats(x, -1)
        return _affine(x, mean[..., None], var[..., None], self.weight,
                       self.bias, self.eps, self.dtype)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over all axes but the last. Batch statistics by
    default (the reference's inference semantics); running statistics with
    `use_running_average`. In training mode with batch statistics the
    running statistics follow flax's update (`update_running_stats`,
    momentum 0.99); in eval mode nothing changes."""

    momentum = 0.99

    def __init__(self, features: int, use_running_average: bool = False,
                 eps: float = 1e-5, dtype: Dtype = None):
        super().__init__()
        self.ura, self.eps, self.dtype = use_running_average, eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ura:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = _fast_stats(x, tuple(range(x.ndim - 1)))
            if self.training:
                update_running_stats(self, mean, var)
        return _affine(x, mean, var, self.weight, self.bias, self.eps,
                       self.dtype)


@torch.no_grad()
def update_running_stats(norm: nn.Module, mean: torch.Tensor,
                         var: torch.Tensor):
    """flax's rule: ra = m * ra + (1 - m) * batch, m = norm.momentum, with
    the biased batch variance the layer normalised with. Inside a recompute
    (`remat`) nothing changes: the statistics move once per forward, as
    the JAX step's `batch_stats` do."""
    if getattr(_recompute, "depth", 0):
        return
    m = norm.momentum
    norm.running_mean.copy_(m * norm.running_mean + (1 - m) * mean)
    norm.running_var.copy_(m * norm.running_var + (1 - m) * var)


# the depth of the recomputes (`remat`) running in this thread; autograd
# may run a backward, and with it a recompute, in a thread of its own
_recompute = threading.local()


@contextlib.contextmanager
def _recomputing():
    depth = getattr(_recompute, "depth", 0)
    _recompute.depth = depth + 1
    try:
        yield
    finally:
        _recompute.depth = depth


def remat(fn: Callable, *args, enabled: bool = True):
    """fn(*args), its activations recomputed in the backward instead of
    kept (the counterpart of flax's nn.remat; torch.utils.checkpoint,
    non-reentrant), where `enabled` and autograd records; else (under
    no_grad: inference, export) a plain call. The recompute runs fn again
    on the same inputs and moves no running statistics
    (`update_running_stats`), so gradients, updates and statistics are
    those of the plain call; it may stop once it has every tensor the
    backward needs."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    calls = []

    def run(*a):
        if calls:
            with _recomputing():
                return fn(*a)
        calls.append(1)
        return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


def init_module(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random-initialise every Conv / Dense under `module` from one seeded
    generator (weights for runs without a converted checkpoint)."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            m.reset_parameters(generator)
    return module

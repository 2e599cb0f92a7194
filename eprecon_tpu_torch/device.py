"""Device selection for the port's entry points.

Entry points default to CUDA and refuse to run when it is absent: a
silent CPU fallback would hide that the card and its kernels were never
used. Tests and CPU tools pass `device="cpu"` explicitly.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means CUDA. Raises if CUDA is asked for and absent.

    On CUDA, also fixes float32 numerics: TF32 is off for matmuls and
    cuDNN convolutions, so the f32 parts of the model (heads, decoder,
    projections) run in full f32 as the JAX reference does on the CPU.
    The bf16 parts are bf16 by construction.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


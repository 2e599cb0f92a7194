"""Model FLOPs of one fragment, counted from the configuration's shapes:
every convolution, matrix product and attention of the architecture, as
torch.utils.flop_counter.FlopCounterMode counts them over the frozen
reference's forward at those shapes. The model's shapes are static
(dense windows, capacity-padded sets), so the count does not depend on
the data. A training micro-step counts three forwards with the loss
(forward, and the backward's two products per forward product);
recomputation does not count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode


def forward_flops(mcfg, frag: Dict, device, targets=None) -> int:
    """FLOPs of the reference's forward (with the loss where `targets`
    are given) on one fragment of the configuration's shapes."""
    from h100bench.reference.epr.fragment_io import FragmentInputs
    from h100bench.reference.epr.models.eprecon import (EPRecon,
                                                        make_recurrent_state)
    m = dataclasses.replace(mcfg, remat_mode="none")
    model = EPRecon(m).to(device)
    model.train(targets is not None)
    fi = FragmentInputs(
        torch.as_tensor(frag["proj_matrices"], dtype=torch.float32, device=device),
        torch.as_tensor(frag["vol_origin_partial"], dtype=torch.float32, device=device),
        torch.as_tensor(frag["world_to_aligned_camera"], dtype=torch.float32,
                        device=device),
        torch.as_tensor(np.asarray(frag["rel"]), device=device))
    imgs = frag.get("imgs")
    if imgs is None:
        imgs = torch.as_tensor(frag["imgs_host"], device=device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(imgs, fi, make_recurrent_state(m, device), targets)
    del model
    return int(counter.get_total_flops())


def train_step_flops(mcfg, frag: Dict, device, targets) -> int:
    return 3 * forward_flops(mcfg, frag, device, targets)

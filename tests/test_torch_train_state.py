"""The port's optimizer (eprecon_tpu_torch.train.state.Optimizer) against
the JAX package's optax chain (make_optimizer: MultiSteps over clip by
global norm and Adam with a piecewise-constant schedule, freezing by
zeroed gradients), on the same seeded gradients: 8 micro-steps with
accumulation 2 and milestones at updates 2 and 3, so both lr boundaries
are crossed and the clip both fires and does not. Parameters agree to
1e-7 after every micro-step (as tests/test_train_state.py holds optax's
own formulations); frozen ones stay bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eprecon_tpu.config import default_config as jax_config
from eprecon_tpu.train.state import (freeze_mask_for, make_lr_schedule,
                                     make_optimizer)
from eprecon_tpu_torch.config import default_config
from eprecon_tpu_torch.train import state as ts

SHAPES = {"backbone2d/Conv_0/kernel": (3, 3, 4),
          "backbone_occ_pano/Conv_0/kernel": (5, 4),
          "neucon_net/initialization/subm1/kernel": (6,),
          "neucon_net/tsdf_pred_0/Dense_0/kernel": (4, 3),
          "neucon_net/tsdf_pred_0/Dense_0/bias": (3,)}


def _nest(flat):
    tree = {}
    for path, x in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = x
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("finetune", [None, "init"])
def test_optimizer_matches_optax(finetune):
    rng = np.random.default_rng(0)
    train = dict(accumulation_steps=2, lr_epochs="2,3:10", lr=1e-2,
                 finetune_layer=finetune)
    jcfg = jax_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, **train))
    tcfg = dataclasses.replace(default_config().train, **train)
    # |p| < 0.5, where an f32 ulp is under 3e-8
    init = {p: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for p, s in SHAPES.items()}

    jparams = _nest({p: jnp.asarray(x) for p, x in init.items()})
    tx = make_optimizer(jcfg, steps_per_epoch=1,
                        freeze_mask=freeze_mask_for(jparams, finetune))
    opt_state = tx.init(jparams)
    tparams = {p.replace("/", "."): torch.nn.Parameter(torch.from_numpy(x.copy()))
               for p, x in init.items()}
    frozen = ts.frozen_names(list(tparams), finetune)
    assert len(frozen) == (2 if finetune else 0)
    opt = ts.Optimizer(tparams, tcfg, steps_per_epoch=1, frozen=frozen)

    updated = []
    for micro in range(8):
        # global norm of the accumulated mean: about 0.5 on even updates
        # (no clip), about 4 on odd ones (clipped to 1)
        scale = 0.08 if micro // 2 % 2 == 0 else 0.6
        grads = {p: (scale * rng.standard_normal(s)).astype(np.float32)
                 for p, s in SHAPES.items()}
        updates, opt_state = tx.update(_nest({p: jnp.asarray(g) for p, g in grads.items()}),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        updated.append(opt.step({p.replace("/", "."): torch.from_numpy(g)
                                 for p, g in grads.items()}))
        want = _flat(jparams)
        for p, x in want.items():
            got = tparams[p.replace("/", ".")].detach().numpy()
            np.testing.assert_allclose(got, x, atol=1e-7, rtol=0,
                                       err_msg=f"{p} after micro-step {micro}")
            if p.replace("/", ".") in frozen:
                np.testing.assert_array_equal(got, init[p])
    assert updated == [False, True] * 4 and opt.updates == 4
    moved = np.abs(tparams["neucon_net.tsdf_pred_0.Dense_0.kernel"].detach().numpy()
                   - init["neucon_net/tsdf_pred_0/Dense_0/kernel"]).max()
    assert moved > 1e-3


def test_learning_rate_schedule_matches_optax():
    jcfg = jax_config()
    sched = make_lr_schedule(jcfg, steps_per_epoch=10)
    for update in (0, 699, 700, 899, 900, 2000):
        np.testing.assert_allclose(
            ts.learning_rate(default_config().train, 10, update),
            float(sched(update)), rtol=1e-6)
    assert ts.parse_lr_epochs("70,90:10") == ([70, 90], 0.1)


def test_weight_decay_is_refused():
    cfg = dataclasses.replace(default_config().train, weight_decay=1e-4)
    with pytest.raises(ValueError, match="weight decay"):
        ts.Optimizer({"w": torch.nn.Parameter(torch.zeros(2))}, cfg)

"""How often a fresh model trains at all at the sharded-loop test's micro
config (tests/test_train_cli.py micro_cfg, which
tests/torch_ranks.loop_config mirrors) and its default thresholds: for
each of the loop's four samples, whether the first forward keeps every
stage (frag_ok), for the JAX package from PRNGKey(k), for the port from
the same variables (convert.variables_to_torch), and for the port's own
EPRecon(seed=k). A draw whose four samples all abort never trains the
heads (the occupancy init is frozen).

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_micro_frag_ok.py \
        [--keys 16]

Four minutes for 16 keys on one core.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (XLA flags, CPU platform, compile cache)
import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_ranks  # noqa: E402
from eprecon_tpu.models.eprecon import EPRecon as JEPRecon  # noqa: E402
from eprecon_tpu.models.eprecon import make_recurrent_state  # noqa: E402
from eprecon_tpu.train.loop import _scene_origin, fragment_to_device_args  # noqa: E402
from eprecon_tpu.train.state import fragment_loss_fn  # noqa: E402
from test_train_cli import _sample, micro_cfg  # noqa: E402
from torch_parity import load  # noqa: E402

from eprecon_tpu_torch.models import eprecon as tmodel  # noqa: E402
from eprecon_tpu_torch.train import loop as tloop  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=16)
    a = ap.parse_args()
    torch.set_num_threads(1)
    jcfg = micro_cfg("unused")
    tcfg = torch_ranks.loop_config("unused")
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, thresholds=jcfg.model.thresholds))
    samples = [_sample(jcfg, *spec) for spec in torch_ranks.LOOP_SAMPLES]
    jargs = [fragment_to_device_args(jcfg, s, _scene_origin(jcfg, s))
             for s in samples]
    targs = [tloop.fragment_to_device_args(tcfg, s, tloop._scene_origin(tcfg, s),
                                           torch.device("cpu")) for s in samples]
    model = JEPRecon(jcfg.model)
    rec0 = make_recurrent_state(jcfg.model)
    init = jax.jit(model.init)

    @jax.jit
    def jax_ok(variables, imgs, frag, targets):
        aux = {k: v for k, v in variables.items() if k != "params"}
        _, (metrics, _, _) = fragment_loss_fn(model, variables["params"], aux,
                                              imgs, frag, targets, rec0)
        return metrics["frag_ok"]

    def port_ok(m):
        m.train()
        with torch.no_grad():
            return [int(bool(m(torch.as_tensor(imgs), frag,
                                tmodel.make_recurrent_state(tcfg.model, "cpu"),
                                targets)[0].get("frag_ok", True)))
                    for imgs, frag, targets in targs]

    rows = []
    for k in range(a.keys):
        v = init(jax.random.PRNGKey(k), *jargs[0][:2], rec0, jargs[0][2])
        row = ([int(jax_ok(v, *x)) for x in jargs],
               port_ok(load(tmodel.EPRecon(tcfg.model), v)),
               port_ok(tmodel.EPRecon(tcfg.model, seed=k)))
        rows.append(row)
        print(f"key/seed {k}: JAX {row[0]}  port from JAX's {row[1]}  "
              f"port's own {row[2]}", flush=True)
    for i, name in enumerate(("JAX", "port from JAX's", "port's own")):
        ok = np.array([r[i] for r in rows])
        print(f"{name}: {ok.sum()} of {ok.size} fragments keep every stage; "
              f"{ok.any(1).sum()} of {len(rows)} draws train at all")


if __name__ == "__main__":
    main()

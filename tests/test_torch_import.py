"""Upstream weights into the port, held against the JAX package on the CPU:
the reference-checkpoint importer (bitwise against JAX's importer followed
by convert.tree_to_torch, on a random checkpoint with the reference's exact
key schema), the reference save format, the activation fingerprint (to
1e-5 against JAX's probes; all 8 layouts identified; the JSON crosses the
packages), the torchvision backbone importer (bitwise) and its warm start,
and the `sparsereg_dropout` config repair."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eprecon_tpu.models.unet_dense import DenseUNet as JaxDenseUNet
from eprecon_tpu.tools import fingerprint as jfp
from eprecon_tpu.tools import import_backbone_weights as jibw
from eprecon_tpu.tools import import_reference_weights as jirw
from eprecon_tpu_torch.config import default_config, load_config
from eprecon_tpu_torch.convert import tree_to_torch
from eprecon_tpu_torch.data.synthetic import make_fragment
from eprecon_tpu_torch.models.backbone import MnasMulti
from eprecon_tpu_torch.models.eprecon import (EPRecon, FragmentInputs,
                                              make_recurrent_state)
from eprecon_tpu_torch.tools import fingerprint as fp
from eprecon_tpu_torch.tools import import_backbone_weights as ibw
from eprecon_tpu_torch.tools import import_reference_weights as irw
from eprecon_tpu_torch.train.checkpoint import restore_model, restore_submodule
from torch_parity import (one_torch_thread, random_mnasnet_state_dict,
                          write_reference_checkpoint)

FP_TOL = 1e-5          # fingerprints: f32 convs on the CPU in both stacks
PERMUTED = dict(fp.DEFAULT_LAYOUT, ts_odd="zfast", ts_even="xfast", spconv="whd")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def reference_sd():
    return irw.random_state_dict(irw.all_entries()[0], seed=0)


@pytest.fixture(scope="module")
def ported(reference_sd):
    return irw.convert_reference_state_dict(reference_sd)


def small_model_config():
    """Default channels (the reference schema fixes them) at the slow JAX
    test's small geometry (tests/test_import_reference.py)."""
    return dataclasses.replace(
        default_config().model, n_vox=(16, 16, 16), voxel_size=0.24,
        voxel_capacity=(64, 256, 1024), global_extent=(32, 32, 16),
        min_init_voxels=10, min_stage_voxels=5)


def _zero_names():
    """The port names of the biases the reference's torchsparse convs lack
    (the z and r gates' biases land in the fused zr conv's)."""
    _, zeros = irw.all_entries()
    return sorted({".".join(z.dst[:-1]).replace("convzr__z", "convzr")
                   .replace("convzr__r", "convzr") + ".bias" for z in zeros})


def test_entry_tables_and_random_checkpoint_match_jax(reference_sd):
    assert irw.all_entries() == jirw.all_entries()
    assert irw.SKIPPED_PREFIXES == jirw.SKIPPED_PREFIXES
    want = jirw.random_state_dict(jirw.all_entries()[0], seed=0)
    assert list(reference_sd) == list(want)
    assert all(np.array_equal(reference_sd[k], want[k]) for k in want)


def test_reference_import_matches_jax_bitwise(reference_sd, ported):
    """Every tensor equals JAX's importer followed by tree_to_torch, bit for
    bit; the import covers every tensor of the port's EPRecon; the stem's 3
    aligned-coordinate rows and the bias-less convs' biases are zero."""
    model = EPRecon(small_model_config())
    tree = jirw.convert_reference_state_dict(reference_sd)
    want = {}
    for coll in ("params", "batch_stats", "buffers"):
        want.update(tree_to_torch(model, tree[coll]))
    assert set(ported) == set(want) == set(model.state_dict())
    assert len(ported) > 900
    for name, value in want.items():
        assert ported[name].dtype == torch.float32, name
        assert torch.equal(ported[name], value), name
    for i in range(3):
        stem = ported[f"neucon_net.sp_conv_{i}.stem_conv.Conv_0.weight"]
        assert stem.shape[1] == irw.CH_IN[i] + 3
        assert not stem[:, -3:].any() and stem[:, :-3].any()
    # the two flips of a transposed even kernel cancel: the port's
    # ConvTranspose weight [I, O, kx, ky, kz] is the torch kernel as placed
    placed = reference_sd["neucon_net.sp_convs.0.up1.0.net.0.kernel"].reshape(
        2, 2, 2, 128, 96).transpose(3, 4, 0, 1, 2)
    assert torch.equal(ported["neucon_net.sp_conv_0.up1.ConvTranspose_0.weight"],
                       torch.from_numpy(np.ascontiguousarray(placed)))
    zeros = _zero_names()
    assert len(zeros) == 63
    assert all(not ported[n].any() for n in zeros)


def test_imported_model_runs(ported):
    """The small-geometry port model loads the import strictly and runs
    one finite forward."""
    cfg = small_model_config()
    model = EPRecon(cfg)
    model.load_state_dict(ported, strict=True)
    d = make_fragment(n_views=2, image_hw=(48, 64), n_vox=cfg.n_vox,
                      voxel_size=cfg.voxel_size, seed=0)
    frag = FragmentInputs(torch.as_tensor(d["proj_matrices"]),
                          torch.as_tensor(d["vol_origin_partial"]),
                          torch.as_tensor(d["world_to_aligned_camera"]),
                          np.zeros((3, 3), np.int64))
    with torch.no_grad():
        out, _, _ = model(torch.as_tensor(d["imgs"]), frag,
                          make_recurrent_state(cfg, "cpu"))
    assert torch.isfinite(out["tsdf_window"].float()).all()


def test_strict_import_names_a_missing_key(reference_sd):
    sd = dict(reference_sd)
    del sd["neucon_net.panoptic.class_embed.weight"]
    with pytest.raises(KeyError, match="1 reference keys missing"):
        irw.convert_reference_state_dict(sd)


def test_load_reference_save_format(tmp_path, reference_sd):
    """The reference's save format ({"epoch", "model" with 'module.'
    prefixes, "optimizer"}, an Adam state included) loads under
    weights_only=True, its prefixes stripped, tensors bit for bit."""
    path = tmp_path / "model_000099.ckpt"
    write_reference_checkpoint(path, reference_sd, epoch=99)
    ckpt = torch.load(path, weights_only=True)
    lin = torch.nn.Linear(2, 2)
    opt = torch.optim.Adam(lin.parameters())
    lin(torch.ones(1, 2)).sum().backward()
    opt.step()
    ckpt["optimizer"] = opt.state_dict()
    torch.save(ckpt, path)
    got = irw.load_torch_checkpoint(str(path))
    assert list(got) == list(reference_sd)
    assert all(np.array_equal(got[k], v) for k, v in reference_sd.items())


@pytest.mark.parametrize("layout", [fp.DEFAULT_LAYOUT, PERMUTED],
                         ids=["default", "permuted"])
def test_fingerprints_match_jax(reference_sd, layout):
    got = fp.fingerprint_state_dict(reference_sd, layout)
    want = jfp.fingerprint_state_dict(reference_sd, layout)
    assert set(got) == set(want) and len(got) == len(fp.SENSITIVE)
    for key in want:
        err = np.abs(np.asarray(got[key]) - np.asarray(want[key])).max()
        assert err <= FP_TOL, (key, err)


def test_every_layout_is_identified(reference_sd):
    assert fp.all_layouts() == jfp.all_layouts()
    assert [e.src for e in fp.probe_entries()] == [e.src for e in jfp.probe_entries()]
    for true_layout in fp.all_layouts():
        recorded = fp.fingerprint_state_dict(reference_sd, true_layout)
        layout, diffs = fp.verify_or_fix_layout(reference_sd, recorded)
        assert layout == true_layout, fp.layout_name(true_layout)
        assert max(diffs.values()) == 0.0


def test_corrupt_checkpoint_raises_in_both(reference_sd):
    probes = {e.src: reference_sd[e.src] for e in fp.probe_entries()}
    expected = fp.fingerprint_state_dict(probes)
    rng = np.random.default_rng(99)
    bad = {k: v + rng.normal(0, 0.05, v.shape).astype(np.float32)
           for k, v in probes.items()}
    for mod in (fp, jfp):
        with pytest.raises(ValueError, match="no kernel-enumeration layout"):
            mod.verify_or_fix_layout(bad, expected)


def test_fingerprint_json_crosses_packages(tmp_path, reference_sd):
    """A recording saved by JAX's save_fingerprint verifies in the port,
    and one saved by the port verifies in JAX, each under the layout it
    was recorded with."""
    probes = {e.src: reference_sd[e.src] for e in fp.probe_entries()}
    jfp.save_fingerprint(jfp.fingerprint_state_dict(probes, PERMUTED),
                         str(tmp_path / "jax.json"))
    layout, _ = fp.verify_or_fix_layout(probes, fp.load_fingerprint(
        str(tmp_path / "jax.json")))
    assert layout == PERMUTED
    other = dict(fp.DEFAULT_LAYOUT, ts_even="xfast")
    fp.save_fingerprint(fp.fingerprint_state_dict(probes, other),
                        str(tmp_path / "port.json"))
    layout, _ = jfp.verify_or_fix_layout(probes, jfp.load_fingerprint(
        str(tmp_path / "port.json")))
    assert layout == other


def test_transforms_for_default_match_the_importer(reference_sd):
    t = fp.transforms_for(fp.DEFAULT_LAYOUT)
    for e in fp.probe_entries():
        assert np.array_equal(irw.TRANSFORMS[e.transform](reference_sd[e.src]),
                              t[e.transform](reference_sd[e.src]))


def test_importer_cli_flips_to_the_recorded_layout(tmp_path, reference_sd,
                                                   ported, capsys):
    """main with --fingerprint recorded under a non-default layout reports
    the flip, converts under it, and its file loads through restore_model
    bit for bit; --record_fingerprint writes that layout's recording."""
    layout = dict(fp.DEFAULT_LAYOUT, ts_odd="zfast")
    src, rec = tmp_path / "ref.ckpt", tmp_path / "fp.json"
    write_reference_checkpoint(src, reference_sd)
    fp.save_fingerprint(fp.fingerprint_state_dict(reference_sd, layout), str(rec))
    out = tmp_path / "imported.pt"
    converted = irw.main(["--torch_ckpt", str(src), "--fingerprint", str(rec),
                          "--out", str(out), "--record_fingerprint",
                          str(tmp_path / "again.json")])
    printed = capsys.readouterr().out
    assert f"auto-flipped to {fp.layout_name(layout)}" in printed
    assert f"{len(converted)} tensors" in printed
    want = irw.convert_reference_state_dict(
        reference_sd, transforms=fp.transforms_for(layout))
    flipped = "neucon_net.sp_conv_0.res1a.SubMConv3dDense_0.Conv_0.weight"
    assert not torch.equal(want[flipped], ported[flipped])
    model = restore_model(str(out), EPRecon(small_model_config()))
    state = model.state_dict()
    assert all(torch.equal(state[k], v) for k, v in want.items())
    assert fp.load_fingerprint(str(tmp_path / "again.json")) == \
        fp.load_fingerprint(str(rec))


@pytest.fixture(scope="module")
def mnasnet_sd():
    return random_mnasnet_state_dict(seed=0)


def test_backbone_import_matches_jax_bitwise(mnasnet_sd):
    """A torchvision mnasnet1_0 state_dict: the port's trunk tensors equal
    JAX's convert_mnasnet followed by tree_to_torch, bit for bit."""
    sd = {k: v.numpy() for k, v in mnasnet_sd.items()}
    got = ibw.convert_backbone(sd)
    params, stats = jibw.convert_mnasnet(sd)
    trunk = MnasMulti()
    want = {**tree_to_torch(trunk, params), **tree_to_torch(trunk, stats)}
    assert set(got) == set(want) and len(got) == 150
    assert all(torch.equal(got[k], want[k]) for k in want)
    fpn = {n for n in trunk.state_dict() if n.split(".")[0] in
           {f"Conv_{i}" for i in range(3, 8)}}
    assert set(trunk.state_dict()) - set(got) == fpn


def test_backbone_from_a_reference_subtree_matches_jax(reference_sd):
    """--prefix backbone2d: the reference checkpoint's subtree through the
    reference importer's backbone entries, equal to JAX's apply_entries
    followed by tree_to_torch, and to that slice of the full import."""
    got = ibw.convert_backbone(reference_sd, "backbone_occ_pano")
    tree = jirw.apply_entries(reference_sd, jirw.backbone_entries(
        "backbone_occ_pano", "backbone_occ_pano"))
    trunk = MnasMulti()
    want = {**tree_to_torch(trunk, tree["params"]["backbone_occ_pano"]),
            **tree_to_torch(trunk, tree["batch_stats"]["backbone_occ_pano"])}
    assert set(got) == set(want) == set(trunk.state_dict())
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_backbone_warm_start_touches_only_the_named_backbone(tmp_path,
                                                             mnasnet_sd):
    converted = ibw.convert_backbone({k: v.numpy() for k, v in mnasnet_sd.items()})
    model = EPRecon(small_model_config())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ibw.merge_into_backbone(model, converted, "backbone_occ_pano")
    after = model.state_dict()
    changed = {k for k in after if not torch.equal(after[k], before[k])}
    assert changed == {f"backbone_occ_pano.{k}" for k in converted}
    assert all(torch.equal(after[f"backbone_occ_pano.{k}"], v)
               for k, v in converted.items())
    # the CLI's file warm-starts each backbone through restore_submodule
    src, out = tmp_path / "mnasnet.pth", tmp_path / "backbone.pt"
    torch.save(mnasnet_sd, src)
    ibw.main(["--torch_ckpt", str(src), "--out", str(out)])
    model = EPRecon(small_model_config())
    restore_submodule(str(out), model, "backbone2d")
    after = model.state_dict()
    changed = {k for k in after if not torch.equal(after[k], before[k])}
    assert changed == {f"backbone2d.{k}" for k in converted}
    with pytest.raises(KeyError, match="no tensor"):
        ibw.merge_into_backbone(model, {"Conv_9.weight": torch.zeros(1)},
                                "backbone2d")


def test_sparsereg_dropout_false_loads(tmp_path):
    """A YAML file or override that sets model.sparsereg_dropout to false
    loads, and the model builds."""
    path = tmp_path / "cfg.yaml"
    path.write_text("mode: test\nmodel:\n  sparsereg_dropout: false\n"
                    "  n_vox: [16, 16, 16]\n")
    cfg = load_config(str(path))
    assert cfg.model.sparsereg_dropout is False
    cfg = load_config(str(path), [("model.sparsereg_dropout", "false")])
    assert cfg.model.sparsereg_dropout is False
    EPRecon(cfg.model)


def test_sparsereg_dropout_true_is_refused_as_in_jax():
    """True refuses to build the port's model, because the JAX package's
    dropout fails at its first forward: its DenseUNet(dropout=True)
    initialises (the 'dropout' stream falls back to 'params' in init), but
    apply, which no caller in the JAX package gives a 'dropout' RNG,
    raises."""
    cfg = dataclasses.replace(small_model_config(), sparsereg_dropout=True)
    with pytest.raises(ValueError, match="no apply of the JAX package"):
        EPRecon(cfg)
    m = JaxDenseUNet(cr=0.25, dropout=True)
    x = jnp.zeros((8, 8, 8, 4), jnp.float32)
    mask = jnp.ones((8, 8, 8), bool)
    variables = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), x, mask))
    with pytest.raises(flax.errors.InvalidRngError, match="dropout"):
        jax.eval_shape(lambda v: m.apply(v, x, mask, mutable=["batch_stats"]),
                       variables)
    # the same call without dropout traces
    jax.eval_shape(lambda v: JaxDenseUNet(cr=0.25).apply(
        v, x, mask, mutable=["batch_stats"]), variables)

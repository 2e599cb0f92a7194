"""The port stands alone and never hides the device: it imports nothing of
JAX or eprecon_tpu, its entry points refuse to run on the CPU unless asked,
and the kernel wrapper raises rather than falling back to the plain
version for a tensor that is not on the CPU."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from eprecon_tpu_torch import kernels
from eprecon_tpu_torch.config import default_config
from eprecon_tpu_torch.ops import back_project as bp

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "eprecon_tpu")


def test_port_imports_without_jax():
    """Import every module of eprecon_tpu_torch with jax, flax, optax and
    eprecon_tpu made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import eprecon_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'eprecon_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_port_imports_without_yaml_or_image_decoders():
    """Every module of eprecon_tpu_torch imports with yaml, cv2, PIL and
    skimage made unimportable (a GPU host need not have them), and
    the CLI's config loading needs no yaml."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('yaml', 'cv2', 'PIL', 'skimage'):\n"
        "    sys.modules[name] = None\n"
        "import eprecon_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'eprecon_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from eprecon_tpu_torch.config import load_config\n"
        "cfg = load_config('config/train.yaml', [('model.voxel_size', 0.08)])\n"
        "print(cfg.model.n_vox, cfg.train.accumulation_steps)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["(96,", "96,", "96)", "8"]


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", ["chip_smoke.py"] + sorted(
    str(p.relative_to(REPO)) for p in (REPO / "eprecon_tpu_torch").rglob("*.py")))
def test_source_imports_nothing_of_jax(path):
    roots = _imported_roots(REPO / path)
    assert not roots & set(BLOCKED), f"{path} imports {roots & set(BLOCKED)}"


def test_entry_point_defaults_to_cuda(monkeypatch):
    """Without `device`, StreamingReconstructor asks for CUDA and raises
    when it is absent instead of running on the CPU."""
    from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = default_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingReconstructor(cfg, torch.nn.Linear(1, 1))
    rec = StreamingReconstructor(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, global_extent=(8, 8, 8))),
        torch.nn.Linear(1, 1), device="cpu")
    assert rec.device.type == "cpu"


def test_trainer_defaults_to_cuda(monkeypatch):
    """Without `device`, the training step asks for CUDA and raises when
    it is absent; device="cpu" runs the plain versions."""
    from eprecon_tpu_torch.train.state import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(default_config(), torch.nn.Linear(1, 1))
    assert Trainer(default_config(), torch.nn.Linear(1, 1),
                   device="cpu").device.type == "cpu"


def test_wrapper_never_falls_back(monkeypatch, tmp_path):
    """A tensor off the CPU goes to the kernel or raises: a meta tensor is
    refused, a CPU tensor handed to the launcher is refused, and a missing
    toolchain is an error, not a detour to the plain version."""
    before = bp.total_launches() + bp.total_backward_launches()
    feats = torch.zeros(2, 1, 4, 4, 8, device="meta")
    proj = torch.zeros(2, 1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bp.back_project_window((2, 2, 2), 1, torch.zeros(1, 3, device="meta"),
                               0.1, feats, proj)
    with pytest.raises(ValueError, match="needs CUDA"):
        bp._launch(bp.WINDOW_MEAN, torch.zeros(2, 16, 8, dtype=torch.bfloat16),
                   torch.zeros(2, 1, 16), torch.zeros(1, 3), None, None, 8, 4, 4)
    with pytest.raises(ValueError, match="needs CUDA"):
        bp._launch_backward(bp.WINDOW_MEAN, None, torch.zeros(2, 1, 16),
                            torch.zeros(1, 3), None, None,
                            torch.zeros(8, 8, dtype=torch.bfloat16),
                            torch.zeros(8), 2, 4, 4, (2, 2, 2))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(kernels.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load("back_project")
    assert bp.total_launches() + bp.total_backward_launches() == before

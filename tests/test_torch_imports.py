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


def test_parallel_package_imports_without_jax():
    """eprecon_tpu_torch.parallel (the process group of data-parallel
    training) imports with JAX blocked, joins no group and starts no
    process when imported, and outside torchrun is one rank on the device
    asked for."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch.distributed as dist\n"
        "from eprecon_tpu_torch.parallel import mesh\n"
        "from eprecon_tpu_torch.train import loop, state\n"
        "assert not dist.is_initialized()\n"
        "dev = mesh.initialize_distributed('gloo', 'cpu')\n"
        "assert not dist.is_initialized()\n"
        "print(dev, mesh.world_size(), mesh.rank(), mesh.is_main_process())\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["cpu", "1", "0", "True"]


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


def test_port_imports_without_the_viewers_libraries():
    """Every module of eprecon_tpu_torch, the viewers included, imports with
    matplotlib and pyvista made unimportable: the viewers import them when
    they draw (the card's host has neither)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('matplotlib', 'mpl_toolkits', 'pyvista'):\n"
        "    sys.modules[name] = None\n"
        "import eprecon_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'eprecon_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert {'eprecon_tpu_torch.tools.render', 'eprecon_tpu_torch.data.visualization',\n"
        "        'eprecon_tpu_torch.models.spvcnn', 'eprecon_tpu_torch.inference.export',\n"
        "        'eprecon_tpu_torch.inference.serving'} <= set(mods)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok"]


def test_serving_module_imports_without_the_model_code():
    """eprecon_tpu_torch.inference.serving, all that a process serving an
    exported fragment program imports, loads no module of
    eprecon_tpu_torch.models (refused by a meta-path blocker) and no JAX,
    and registers the back-projection ops and the call convention's
    pytrees."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.startswith('eprecon_tpu_torch.models'):\n"
        "            raise ImportError('model code: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "import torch.utils._pytree as pytree\n"
        "from eprecon_tpu_torch.inference import serving\n"
        "from eprecon_tpu_torch import fragment_io as io\n"
        "for op in ('window_mean', 'window_mean_backward', 'variance',\n"
        "           'variance_backward', 'variance_window',\n"
        "           'variance_window_backward'):\n"
        "    getattr(torch.ops.eprecon_tpu_torch, op)\n"
        "for cls in (io.FragmentInputs, io.RecurrentState, io.DenseGlobalLevel,\n"
        "            io.DenseTargetLevel, io.PanopticGlobalDense):\n"
        "    assert pytree.SUPPORTED_SERIALIZED_TYPES[cls].serialized_type_name \\\n"
        "        == 'eprecon_tpu_torch.' + cls.__name__\n"
        "print(sorted(m for m in sys.modules if m.startswith('eprecon_tpu_torch.models')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]"]


def test_jax_checkpoint_reader_needs_tensorstore_only_to_read(tmp_path):
    """The JAX checkpoint importer and the checkpoint module import with
    JAX and tensorstore made unimportable; reading an orbax directory then
    raises ImportError naming tensorstore, through restore_model too (the
    card's host has no tensorstore: checkpoints are converted where they
    were written)."""
    ckpt = tmp_path / "model_000001"
    ckpt.mkdir()
    (ckpt / "_METADATA").write_text('{"tree_metadata": {}}')
    code = (
        "import sys\n"
        f"for name in {BLOCKED + ('tensorstore',)!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from eprecon_tpu_torch.tools import import_jax_checkpoint as ij\n"
        "from eprecon_tpu_torch.train import checkpoint as ck\n"
        "assert ij.is_orbax_checkpoint(sys.argv[1])\n"
        "for read in (ij.read_orbax_tree,\n"
        "             lambda p: ck.restore_model(p, torch.nn.Linear(1, 1))):\n"
        "    try:\n"
        "        read(sys.argv[1])\n"
        "    except ImportError as e:\n"
        "        assert 'tensorstore' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('read without tensorstore')\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code, str(ckpt)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok"]


def test_quality_tools_import_without_jax():
    """The closed quality loop's modules (tools/quality_utils.py,
    quality_run.py, production_quality_run.py) import with JAX, flax,
    optax and eprecon_tpu made unimportable, build the quality scene's
    config, and their CLIs parse their arguments without starting a run."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "from eprecon_tpu_torch.tools import (production_quality_run as pq,\n"
        "                                     quality_run as qr, quality_utils as qu)\n"
        "cfg = qu.tiny_cfg()\n"
        "assert cfg.model.n_vox == (32, 32, 32) and cfg.train.lr == 1e-3\n"
        "assert (qr.PQ_STEPS, qr.PQ_FLOOR, qr.FSCORE_FLOOR) == (100, 0.25, 0.4)\n"
        "for main in (qr.main, pq.main):\n"
        "    try:\n"
        "        main(['--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


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
                            torch.zeros(1, 3),
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

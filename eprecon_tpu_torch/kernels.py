"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with
nvcc into `_build/<name>-<hash>.so` at first use (the hash covers the
source and the flags, so an edited source is rebuilt), then opened with
ctypes. ptxas's report (registers, shared memory and spills per kernel)
is kept beside it as `<name>-<hash>.ptxas.txt`. Nothing is built or
imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "--ptxas-options=-v", "-shared", "-Xcompiler",
              "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(str(Path(root) / "bin" / "nvcc"))
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if not built yet) and return the .so path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
    ptxas_report(out).write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


def ptxas_report(so: Path) -> Path:
    """The ptxas report kept beside a built library."""
    return so.with_suffix(".ptxas.txt")


def load(name: str) -> ctypes.CDLL:
    """Build (once) and open the kernel library `name`."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib

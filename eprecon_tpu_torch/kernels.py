"""Build and load the native libraries under `csrc/`: the hand-written
CUDA kernels and the host library of the data path.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with
nvcc into `_build/<name>-<hash>.so` at first use (the hash covers the
source and the flags, so an edited source is rebuilt), then opened with
ctypes. ptxas's report (registers, shared memory and spills per kernel)
is kept beside it as `<name>-<hash>.ptxas.txt`. A `csrc/<name>.cpp` is
host code, compiled the same way with the host C++ compiler (the one
nvcc uses) by `build_host` / `load_host`. A failed build raises with the
compiler's output. Nothing is built or imported when this module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "--ptxas-options=-v", "-shared", "-Xcompiler",
              "-fPIC")
# the host library's resize is float arithmetic that the PyTorch path
# repeats: no fused multiply-adds
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall",
              "-ffp-contract=off", "-pthread")

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


def find_cxx() -> str:
    """The host C++ compiler: $CXX, else the `c++` / `g++` that nvcc calls
    from PATH."""
    for c in (os.environ.get("CXX"), shutil.which("c++"), shutil.which("g++")):
        if c and Path(c).is_file():
            return c
    raise RuntimeError("no host C++ compiler ($CXX, c++, g++ on PATH); the "
                       "native libraries cannot be built")


def _build(src: Path, tag: str, compiler: str, flags: Sequence[str],
           libs: Sequence[str] = (), report: str = ".log") -> Path:
    """Compile `src` into `_build/<stem><tag>-<hash>.so` unless it is there:
    the hash covers the source, compiler, flags and libraries. The
    compiler's diagnostics are kept beside the library (suffix `report`)
    and are the message of the error on failure."""
    key = " ".join([compiler, *flags, *libs]).encode()
    digest = hashlib.sha256(src.read_bytes() + key).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}{tag}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(src), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(compiler).name} failed for {src.name}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(report).write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if not built yet) and return the .so path."""
    return _build(CSRC / f"{name}.cu", "", find_nvcc(), NVCC_FLAGS,
                  report=".ptxas.txt")


def build_host(name: str, tag: str = "", flags: Sequence[str] = (),
               libs: Sequence[str] = ()) -> Path:
    """Compile the host source csrc/<name>.cpp with `flags` (defines,
    include dirs) and `libs` (link arguments) after HOST_FLAGS; `tag`
    names the variant in the file name."""
    return _build(CSRC / f"{name}.cpp", tag, find_cxx(), [*HOST_FLAGS, *flags],
                  libs)


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


def load_host(name: str, tag: str = "", flags: Sequence[str] = (),
              libs: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (once) and open the host library `name` in variant `tag`."""
    with _lock:
        lib = _libs.get(name + tag)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(name, tag, flags, libs)))
            _libs[name + tag] = lib
        return lib

"""ctypes bindings of the port's native fragment loader and image codecs
(csrc/fragment_loader.cpp; port of eprecon_tpu/data/native_loader.py).

Threaded C++ JPEG / PNG decode, ScanNet pad and resize, in place of the
reference's DataLoader worker processes (reference main.py:130-151), and
the single-image decoders and writers the rest of the data path uses (a
host need not have cv2 or PIL).

The library is built at first use, never at import, with the host C++
compiler, in the route the host's libraries allow (`image_route`): JPEG
through libjpeg where its header and library exist, else through the CUDA
toolkit's nvJPEG (on the card); PNG through zlib in both. There is no
other decoder behind it: where the library cannot be built the loader
raises with the compiler's output, and a frame that fails to decode
raises IOError.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from eprecon_tpu_torch import kernels

JPEG_QUALITY = 95   # cv2.imwrite's default
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF}
_f32p = ctypes.POINTER(ctypes.c_float)


# ---------------------------------------------------------------------------
# which codecs the host has
# ---------------------------------------------------------------------------

def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")


def _include_dirs(cxx: str) -> List[Path]:
    """The host compiler's #include <...> search list."""
    proc = subprocess.run([cxx, "-E", "-x", "c++", "-v", "-"], input="",
                          capture_output=True, text=True)
    lines = proc.stderr.splitlines()
    try:
        start = lines.index("#include <...> search starts here:") + 1
        end = lines.index("End of search list.")
    except ValueError:
        return [Path("/usr/include"), Path("/usr/local/include")]
    return [Path(x.strip()) for x in lines[start:end]]


def _library(cxx: str, name: str) -> Optional[str]:
    """Where the host compiler's linker finds `name`, or None."""
    out = subprocess.run([cxx, f"-print-file-name={name}"], capture_output=True,
                         text=True).stdout.strip()
    return out if os.path.isabs(out) and os.path.exists(out) else None


@functools.lru_cache(maxsize=1)
def probe_libraries() -> Dict[str, Optional[str]]:
    """Path of each header and library the codecs may use (None where
    absent): libjpeg, libpng, zlib on the host compiler's paths, nvJPEG
    in the CUDA toolkit."""
    cxx = kernels.find_cxx()
    incs = _include_dirs(cxx)

    def header(name):
        hits = [d / name for d in incs if (d / name).is_file()]
        return str(hits[0]) if hits else None

    cuda = _cuda_home()
    found = {h: header(h) for h in ("jpeglib.h", "png.h", "zlib.h")}
    found.update({lib: _library(cxx, lib)
                  for lib in ("libjpeg.so", "libpng16.so", "libz.so")})
    for name, path in (("nvjpeg.h", cuda / "include" / "nvjpeg.h"),
                       ("libnvjpeg.so", cuda / "lib64" / "libnvjpeg.so")):
        found[name] = str(path) if path.is_file() else None
    return found


def image_route(found: Optional[Dict[str, Optional[str]]] = None) -> str:
    """"libjpeg" where jpeglib.h and libjpeg.so exist, else "nvjpeg" where
    the toolkit has nvjpeg.h and libnvjpeg.so; zlib is needed by both.
    Raises, naming what is missing, where neither route can be built."""
    found = probe_libraries() if found is None else found
    have = lambda *names: all(found.get(n) for n in names)
    if not have("zlib.h", "libz.so"):
        raise RuntimeError(f"no zlib (zlib.h, libz.so) for the PNG codec: {found}")
    if have("jpeglib.h", "libjpeg.so"):
        return "libjpeg"
    if have("nvjpeg.h", "libnvjpeg.so"):
        return "nvjpeg"
    raise RuntimeError(f"no JPEG codec: neither libjpeg (jpeglib.h, libjpeg.so) "
                       f"nor nvJPEG (nvjpeg.h, libnvjpeg.so): {found}")


def library() -> ctypes.CDLL:
    """Build (once, in the host's route) and open the loader library."""
    route = image_route()
    if route == "libjpeg":
        flags, libs = ["-DFRAG_ROUTE_LIBJPEG"], ["-ljpeg", "-lz"]
    else:
        cuda = _cuda_home()
        flags = ["-DFRAG_ROUTE_NVJPEG", f"-I{cuda / 'include'}"]
        libs = [f"-L{cuda / 'lib64'}", f"-Wl,-rpath,{cuda / 'lib64'}",
                "-lnvjpeg", "-lcudart", "-lz"]
    lib = kernels.load_host("fragment_loader", f"-{route}", flags, libs)
    if getattr(lib, "_bound", False):
        return lib
    c_int, c_char_p, c_void_p = ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p
    lib.frag_route.restype = c_char_p
    lib.frag_route.argtypes = []
    lib.frag_loader_create.restype = c_void_p
    lib.frag_loader_create.argtypes = [c_int, c_int, c_int, ctypes.c_float]
    lib.frag_loader_destroy.restype = None
    lib.frag_loader_destroy.argtypes = [c_void_p]
    lib.frag_loader_submit.restype = ctypes.c_long
    lib.frag_loader_submit.argtypes = [c_void_p, c_int, ctypes.POINTER(c_char_p),
                                       ctypes.POINTER(c_char_p)]
    lib.frag_loader_fetch.restype = c_int
    lib.frag_loader_fetch.argtypes = [c_void_p, ctypes.c_long, _f32p, _f32p,
                                      c_int]
    lib.frag_decode_jpeg.restype = c_int
    lib.frag_decode_jpeg.argtypes = [c_char_p, _f32p, c_int, c_int]
    lib.frag_decode_png_depth.restype = c_int
    lib.frag_decode_png_depth.argtypes = [c_char_p, ctypes.c_float, _f32p,
                                          c_int, c_int]
    lib.frag_write_jpeg.restype = c_int
    lib.frag_write_jpeg.argtypes = [c_char_p, c_void_p, c_int, c_int, c_int]
    lib.frag_write_png16.restype = c_int
    lib.frag_write_png16.argtypes = [c_char_p, c_void_p, c_int, c_int]
    lib._bound = True
    return lib


def route() -> str:
    """The codecs the built library uses: "libjpeg+zlib" or "nvjpeg+zlib"."""
    return library().frag_route().decode()


# ---------------------------------------------------------------------------
# headers and single images
# ---------------------------------------------------------------------------

def jpeg_size(path: str) -> Tuple[int, int]:
    """(h, w) of a JPEG from its start-of-frame header, without decoding."""
    with open(path, "rb") as f:
        if f.read(2) != b"\xff\xd8":
            raise IOError(f"{path}: not a JPEG")
        while True:
            byte = f.read(1)
            if not byte:
                break
            if byte != b"\xff":
                continue
            marker = f.read(1)
            while marker == b"\xff":          # fill bytes
                marker = f.read(1)
            if not marker:
                break
            m = marker[0]
            if m == 0x01 or 0xD0 <= m <= 0xD8:   # markers without a length
                continue
            head = f.read(2)
            if len(head) < 2 or m == 0xDA:       # the scan starts: no frame
                break
            length = int.from_bytes(head, "big")
            if m in _SOF:
                sof = f.read(5)
                return (int.from_bytes(sof[1:3], "big"),
                        int.from_bytes(sof[3:5], "big"))
            f.seek(length - 2, os.SEEK_CUR)
    raise IOError(f"{path}: no JPEG start-of-frame header")


def png_size(path: str) -> Tuple[int, int]:
    """(h, w) of a PNG from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise IOError(f"{path}: not a PNG")
    return int.from_bytes(head[20:24], "big"), int.from_bytes(head[16:20], "big")


def _check(rc: int, what: str):
    if rc != 0:
        raise IOError(f"{what} failed (rc={rc})")


def decode_jpeg(path: str) -> np.ndarray:
    """A JPEG at full resolution: [H, W, 3] f32 BGR (cv2.imread's order)."""
    h, w = jpeg_size(path)
    out = np.empty((h, w, 3), np.float32)
    _check(library().frag_decode_jpeg(os.fsencode(path),
                                      out.ctypes.data_as(_f32p), h, w),
           f"decoding {path}")
    return out


def decode_png_depth(path: str, max_depth: float = float("inf")) -> np.ndarray:
    """A 16-bit depth PNG in mm at full resolution: [H, W] f32 meters,
    values above `max_depth` zeroed."""
    h, w = png_size(path)
    out = np.empty((h, w), np.float32)
    _check(library().frag_decode_png_depth(os.fsencode(path), max_depth,
                                           out.ctypes.data_as(_f32p), h, w),
           f"decoding {path}")
    return out


def write_jpeg(path: str, bgr: np.ndarray, quality: int = JPEG_QUALITY):
    """Write [H, W, 3] u8 BGR as a baseline 4:2:0 JPEG (cv2.imwrite's
    defaults)."""
    bgr = np.ascontiguousarray(bgr)
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"want [H, W, 3] uint8, got {bgr.dtype} {bgr.shape}")
    _check(library().frag_write_jpeg(os.fsencode(path), bgr.ctypes.data,
                                     bgr.shape[0], bgr.shape[1], quality),
           f"writing {path}")


def write_png16(path: str, image: np.ndarray):
    """Write [H, W] u16 as a 16-bit greyscale PNG."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint16 or image.ndim != 2:
        raise ValueError(f"want [H, W] uint16, got {image.dtype} {image.shape}")
    _check(library().frag_write_png16(os.fsencode(path), image.ctypes.data,
                                      image.shape[0], image.shape[1]),
           f"writing {path}")


# ---------------------------------------------------------------------------
# the threaded loader
# ---------------------------------------------------------------------------

class NativeFragmentLoader:
    """Decode-ahead fragment loader: submit() fragments, fetch() returns
    (imgs [V, H, W, 3] f32 BGR, depths [V, H, W] f32 m) for out_size
    (W, H): color padded as ScanNet's and resized bilinearly, depth
    resized to the nearest pixel, values above max_depth zeroed."""

    def __init__(self, n_threads: int = 8, out_size: Tuple[int, int] = (640, 480),
                 max_depth: float = 3.0):
        self.handle = None
        self.out_w, self.out_h = out_size
        self.max_depth = max_depth
        self.lib = library()
        self.handle = self.lib.frag_loader_create(n_threads, self.out_w,
                                                  self.out_h, max_depth)
        if not self.handle:
            raise RuntimeError(f"the {route()} loader could not start "
                               "(nvJPEG needs a CUDA device)")

    def close(self):
        if self.handle:
            self.lib.frag_loader_destroy(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    def submit(self, img_paths: Sequence[str],
               depth_paths: Optional[Sequence[str]] = None) -> int:
        n = len(img_paths)
        arr_i = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in img_paths])
        arr_d = (ctypes.c_char_p * n)(*([os.fsencode(p) for p in depth_paths]
                                        if depth_paths else [b""] * n))
        return int(self.lib.frag_loader_submit(self.handle, n, arr_i, arr_d))

    def fetch(self, ticket: int, n_views: int) -> Tuple[np.ndarray, np.ndarray]:
        imgs = np.empty((n_views, self.out_h, self.out_w, 3), np.float32)
        depths = np.empty((n_views, self.out_h, self.out_w), np.float32)
        rc = self.lib.frag_loader_fetch(self.handle, ticket,
                                        imgs.ctypes.data_as(_f32p),
                                        depths.ctypes.data_as(_f32p), n_views)
        if rc != 0:
            raise IOError(f"fragment decode failed (rc={rc})")
        return imgs, depths

"""ScanNet .sens extraction: color, depth, pose and intrinsics per frame
(own copy of eprecon_tpu/tools/sens_reader.py).

Reference: datasets/scannet/reader.py:30-94 + SensorData.py. Parses the
ScanNet SensorData binary (version 4, little-endian) and writes the layout
the dataset loader reads: color/N.jpg (the stored JPEG bytes, copied),
depth/N.png (16-bit PNG through the port's native writer,
data/native_loader.write_png16), pose/N.txt and
intrinsic/intrinsic_{color,depth}.txt.

CLI:
  python -m eprecon_tpu_torch.tools.sens_reader --filename scene.sens \\
      --output_path <root>/scans/<scene> [--frame_skip 1]
"""
from __future__ import annotations

import argparse
import os
import struct
import zlib
from typing import BinaryIO, Iterator, Tuple

import numpy as np

COMPRESSION_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort",
                     2: "occi_ushort"}


def _unpack(f: BinaryIO, fmt: str):
    fmt = "<" + fmt
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def _read_matrix(f: BinaryIO) -> np.ndarray:
    return np.asarray(_unpack(f, "16f"), np.float32).reshape(4, 4)


class SensReader:
    """Streaming .sens parser (version 4)."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        f = self.f
        self.version = _unpack(f, "I")[0]
        strlen = _unpack(f, "Q")[0]
        self.sensor_name = f.read(strlen).decode("ascii", "ignore")
        self.intrinsic_color = _read_matrix(f)
        self.extrinsic_color = _read_matrix(f)
        self.intrinsic_depth = _read_matrix(f)
        self.extrinsic_depth = _read_matrix(f)
        self.color_compression = COMPRESSION_COLOR[_unpack(f, "i")[0]]
        self.depth_compression = COMPRESSION_DEPTH[_unpack(f, "i")[0]]
        self.color_width, self.color_height = _unpack(f, "II")
        self.depth_width, self.depth_height = _unpack(f, "II")
        self.depth_shift = _unpack(f, "f")[0]
        self.num_frames = _unpack(f, "Q")[0]

    def frames(self) -> Iterator[Tuple[np.ndarray, bytes, np.ndarray]]:
        """Yields (pose 4x4 f32, color bytes (jpeg), depth uint16 [H, W])."""
        for _ in range(self.num_frames):
            pose = _read_matrix(self.f)
            _ts_color, _ts_depth = _unpack(self.f, "QQ")
            color_len, depth_len = _unpack(self.f, "QQ")
            color = self.f.read(color_len)
            depth_raw = self.f.read(depth_len)
            if self.depth_compression == "zlib_ushort":
                depth_raw = zlib.decompress(depth_raw)
            depth = np.frombuffer(depth_raw, "<u2").reshape(
                self.depth_height, self.depth_width)
            yield pose, color, depth

    def close(self):
        self.f.close()


def extract(path: str, out_dir: str, frame_skip: int = 1) -> int:
    """Write the standard layout: color/N.jpg, depth/N.png, pose/N.txt,
    intrinsic/intrinsic_{color,depth}.txt. Returns the frames written."""
    from eprecon_tpu_torch.data.native_loader import write_png16

    r = SensReader(path)
    try:
        for sub in ("color", "depth", "pose", "intrinsic"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        np.savetxt(os.path.join(out_dir, "intrinsic", "intrinsic_color.txt"),
                   r.intrinsic_color)
        np.savetxt(os.path.join(out_dir, "intrinsic", "intrinsic_depth.txt"),
                   r.intrinsic_depth)
        written = 0
        for i, (pose, color, depth) in enumerate(r.frames()):
            if i % frame_skip:
                continue
            with open(os.path.join(out_dir, "color", f"{i}.jpg"), "wb") as f:
                f.write(color)
            write_png16(os.path.join(out_dir, "depth", f"{i}.png"),
                        depth.astype(np.uint16))
            np.savetxt(os.path.join(out_dir, "pose", f"{i}.txt"), pose)
            written += 1
    finally:
        r.close()
    return written


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--filename", required=True)
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--frame_skip", type=int, default=1)
    args = ap.parse_args(argv)
    extract(args.filename, args.output_path, args.frame_skip)


if __name__ == "__main__":
    main()

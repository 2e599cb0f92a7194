"""Decode-ahead fragment prefetching over the native loader (port of
eprecon_tpu/data/prefetch.py).

Reference: main.py:130-151 uses 8 DataLoader worker processes to overlap
jpg/png decode with GPU compute. Here the overlap comes from the threaded
C++ loader (csrc/fragment_loader.cpp): fragment N+depth's images decode
while fragment N is on the card, and the loop's thread builds the rest of
the sample (poses, intrinsics, the GT windows, their fusion on the card).
"""
from __future__ import annotations

from collections import deque
from typing import Iterator, Sequence, Tuple

from eprecon_tpu_torch.data.native_loader import NativeFragmentLoader


class FragmentPrefetcher:
    """Iterate dataset samples with images decoded `depth` fragments ahead.

    Yields `dataset.getitem_decoded` of the natively decoded frames (color
    padded and resized to `out_size`, depth resized to it): the sample of
    `dataset[i]` wherever the depth frames are already at `out_size`, as
    ScanNet's 640x480 are. Raises where the native library cannot be
    built; there is no other decoder behind it."""

    def __init__(self, dataset, n_threads: int = 8,
                 out_size: Tuple[int, int] = (640, 480),
                 depth: int = 2, max_depth: float = 3.0):
        self.dataset = dataset
        self.depth = max(depth, 1)
        self.loader = NativeFragmentLoader(n_threads, out_size, max_depth)

    def close(self):
        self.loader.close()

    def iterate(self, indices: Sequence[int]) -> Iterator[dict]:
        idxs = list(indices)
        tickets: deque = deque()

        def submit(j):
            imgs, depths = self.dataset.image_paths(idxs[j])
            tickets.append((idxs[j], len(imgs), self.loader.submit(imgs, depths)))

        for j in range(min(self.depth, len(idxs))):
            submit(j)
        for i in range(len(idxs)):
            idx, n_views, ticket = tickets.popleft()
            if i + self.depth < len(idxs):
                submit(i + self.depth)
            imgs, depths = self.loader.fetch(ticket, n_views)
            yield self.dataset.getitem_decoded(idx, imgs, depths)

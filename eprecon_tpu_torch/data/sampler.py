"""Contiguous-block data sharding for fragment streams (own copy of
eprecon_tpu/data/sampler.py).

Reference: datasets/sampler.py:56-76 — rank r gets the contiguous slice
[r*n, (r+1)*n) instead of a strided split, preserving the temporal order of
a scene's fragments within a rank, which the GRU fusion's stateful global
volume requires. Each rank carries its own scene stream and recurrent
state.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


def contiguous_shards(n_items: int, n_shards: int) -> List[range]:
    """Split [0, n_items) into n_shards contiguous blocks (last may be short;
    the reference pads by repeating — we truncate to the shortest so all
    shards step in lockstep for SPMD)."""
    per = n_items // n_shards
    return [range(s * per, (s + 1) * per) for s in range(n_shards)]


def scene_runs(scene_ids: Sequence) -> List[range]:
    """Group consecutive equal scene ids into index runs."""
    runs: List[range] = []
    start = 0
    for i in range(1, len(scene_ids) + 1):
        if i == len(scene_ids) or scene_ids[i] != scene_ids[start]:
            runs.append(range(start, i))
            start = i
    return runs


class ContiguousDistributedSampler:
    """Iterate contiguous per-shard index blocks, optionally epoch-shuffled
    at the *scene granularity*: whole scenes are permuted with an
    epoch-seeded RNG while fragments within a scene stay in temporal order
    (GRU fusion needs ordered streams; the reference trains with
    shuffle=False, datasets/sampler.py:56-76 / main.py:129 — scene-level
    shuffling is the only order freedom the model admits).

    shuffle=True requires `scene_ids` (one id per dataset item, e.g.
    [f["scene"] for f in dataset.fragments]) so scene boundaries are known.
    """

    def __init__(self, n_items: int, n_shards: int, shard: int,
                 shuffle: bool = False, seed: int = 0,
                 scene_ids: Optional[Sequence] = None):
        if shuffle and scene_ids is None:
            raise ValueError("shuffle=True requires scene_ids (per-item "
                             "scene keys) to keep fragments ordered "
                             "within scenes")
        if scene_ids is not None and len(scene_ids) != n_items:
            raise ValueError(f"scene_ids has {len(scene_ids)} entries for "
                             f"{n_items} items")
        self.n_items = n_items
        self.n_shards = n_shards
        self.shard = shard
        self.shuffle = shuffle
        self.seed = seed
        self.scene_ids = scene_ids
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        block = contiguous_shards(self.n_items, self.n_shards)[self.shard]
        if not self.shuffle:
            return iter(block)
        runs = scene_runs(self.scene_ids)
        order = np.random.default_rng(self.seed + self.epoch).permutation(
            len(runs))
        flat: List[int] = []
        for r in order:
            flat.extend(runs[r])
        return iter(flat[block.start:block.stop])

    def __len__(self) -> int:
        return self.n_items // self.n_shards

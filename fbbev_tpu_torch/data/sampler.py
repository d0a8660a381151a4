"""Stream-per-slot batch samplers -- the temporal-training enabler.  The
port's own copy of ``fbbev_tpu/data/sampler.py``.

Parity reference: ``InfiniteGroupEachSampleInBatchSampler``
(``mmdet3d/datasets/samplers/infinite_group_each_sample_in_batch_sampler.py:48-220``):
each of the ``batch_size x world_size`` global batch slots streams its own
scene sequence in order, forever; shuffling happens only over the order in
which groups are assigned to slots.  This guarantees the model's per-slot
temporal state always continues the same scene (checked at runtime by the
``seq_mismatch`` diagnostic, cf. ``fbocc.py:248``).

"rank" is the data-parallel process index; a single sampler instance
with ``world_size=1`` and the global batch size reproduces the
reference's global behaviour exactly.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


class InfiniteGroupStreamSampler:
    """Yields lists of ``batch_size`` dataset indices; slot i always
    continues slot i's current scene stream."""

    def __init__(self, flags: np.ndarray, batch_size: int,
                 world_size: int = 1, rank: int = 0, seed: int = 0):
        self.flags = np.asarray(flags)
        self.batch_size = batch_size
        self.world_size = world_size
        self.rank = rank
        self.seed = seed
        self.groups_num = int(self.flags.max()) + 1
        self.global_batch_size = batch_size * world_size
        assert self.groups_num >= self.global_batch_size, (
            f"need >= {self.global_batch_size} scene groups, have "
            f"{self.groups_num}")
        self.group_idx_to_sample_idxs = {
            g: np.where(self.flags == g)[0].tolist()
            for g in range(self.groups_num)
        }
        self._group_gens = [
            self._group_indices_for_slot(rank * batch_size + i)
            for i in range(batch_size)
        ]
        self._buffers: List[List[int]] = [[] for _ in range(batch_size)]

    def _infinite_group_indices(self) -> Iterator[int]:
        rng = np.random.RandomState(self.seed)
        while True:
            yield from rng.permutation(self.groups_num).tolist()

    def _group_indices_for_slot(self, global_slot: int) -> Iterator[int]:
        it = self._infinite_group_indices()
        for _ in range(global_slot):
            next(it)
        while True:
            yield next(it)
            for _ in range(self.global_batch_size - 1):
                next(it)

    def __iter__(self) -> Iterator[List[int]]:
        while True:
            batch = []
            for slot in range(self.batch_size):
                if not self._buffers[slot]:
                    g = next(self._group_gens[slot])
                    self._buffers[slot] = list(
                        self.group_idx_to_sample_idxs[g])
                batch.append(self._buffers[slot].pop(0))
            yield batch


class EvalGroupStreamSampler:
    """Deterministic eval variant: groups are dealt round-robin to global
    slots; each slot plays its groups' samples in order; exhausted slots
    pad by repeating their last sample (flagged) so every step has a full
    batch (cf. InfiniteGroupEachSampleInBatchSamplerEval :134-220)."""

    def __init__(self, flags: np.ndarray, batch_size: int,
                 world_size: int = 1, rank: int = 0):
        flags = np.asarray(flags)
        self.batch_size = batch_size
        groups_num = int(flags.max()) + 1
        global_bs = batch_size * world_size
        slot_streams: List[List[int]] = [[] for _ in range(global_bs)]
        for g in range(groups_num):
            slot_streams[g % global_bs].extend(
                np.where(flags == g)[0].tolist())
        lo = rank * batch_size
        self.streams = slot_streams[lo:lo + batch_size]
        self.length = max((len(s) for s in slot_streams), default=0)

    def __iter__(self):
        for step in range(self.length):
            idxs, valid = [], []
            for s in self.streams:
                if step < len(s):
                    idxs.append(s[step])
                    valid.append(True)
                else:
                    idxs.append(s[-1] if s else 0)
                    valid.append(False)
            yield idxs, valid

    def __len__(self):
        return self.length

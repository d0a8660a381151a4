"""Prefetching batch loader: the port's ``build_dataloader``, a copy of
``fbbev_tpu/data/loader.py``.

The reference feeds each GPU from a multi-process mmcv dataloader
(``mmdet3d/datasets/builder.py:38-109``, ``workers_per_gpu``).  Here the
train step runs asynchronously on the card, so the host only has to stay
ahead of it: a single coordinator thread pulls index batches from the
(stream-per-slot) sampler IN ORDER, fans the per-sample loads out to a
thread pool (PIL / numpy / npz decoding release the GIL), collates, and
parks ready batches in a bounded queue.  Batch ORDER is exactly the
sampler's -- the temporal stream contract (slot -> scene stream,
``data/sampler.py``) is untouched.

Threads, not processes: sample decode is C-library work (GIL-free), and
the copy to the device stays in this process, so batches reach it
without pickling.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from fbbev_tpu_torch.data.synthetic import collate


class PrefetchLoader:
    """Iterate ``collate([dataset[i] for i in idxs])`` ahead of the consumer.

    Args:
      dataset: indexable sample source.
      sampler: iterable of index batches (may be infinite).
      num_workers: decode threads (0 = fully synchronous, no threads).
      prefetch: ready-batch queue depth.
    """

    def __init__(self, dataset, sampler, num_workers: int = 2,
                 prefetch: int = 2):
        self.dataset = dataset
        self.sampler = sampler
        self.num_workers = int(num_workers)
        self.prefetch = int(prefetch)
        self._queue = None
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers <= 0:
            for idxs in self.sampler:
                yield collate([self.dataset[i] for i in idxs])
            return
        self._queue = queue.Queue(maxsize=max(1, self.prefetch))
        self._stop.clear()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        try:
            while True:
                item = self._queue.get()
                if item is _DONE:
                    return
                if isinstance(item, _Error):
                    raise item.exc
                yield item
        finally:
            self.close()

    def close(self):
        self._stop.set()
        q = self._queue
        if q is not None:
            try:  # unblock a producer waiting on a full queue
                q.get_nowait()
            except queue.Empty:
                pass

    # ------------------------------------------------------------------
    def _producer(self):
        try:
            with ThreadPoolExecutor(self.num_workers) as pool:
                for idxs in self.sampler:
                    if self._stop.is_set():
                        return
                    samples = list(pool.map(self.dataset.__getitem__, idxs))
                    self._put(collate(samples))
            self._put(_DONE)
        except BaseException as e:  # surfaced on the consumer side
            self._put(_Error(e))

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return
            except queue.Full:
                continue


_DONE = object()


class _Error:
    def __init__(self, exc):
        self.exc = exc

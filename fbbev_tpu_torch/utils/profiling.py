"""Profiling and cost-analysis helpers of the port.  Counterpart of
``fbbev_tpu/utils/profiling.py``.

The reference's ``run_time`` decorator (``models/fbbev/utils/
bricks.py:32-47``) synchronises CUDA before it reads the clock, and so
does this one: a CUDA launch returns before the device finishes.
``tools/analysis_tools/get_flops.py`` becomes PyTorch's own operation
count (``torch.utils.flop_counter.FlopCounterMode``) of one call.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Any, Callable, Dict

import numpy as np
import torch

_STATS: Dict[str, list] = defaultdict(list)


def _sync(out):
    """Wait for the device work behind ``out`` (tensors in any nesting):
    ``torch.cuda.synchronize`` on each card a tensor of it lies on."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(out)
    for d in devices:
        torch.cuda.synchronize(d)
    return out


def run_time(name: str):
    """Decorator printing a running mean of device-synced wall time."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = _sync(fn(*args, **kwargs))
            dt = time.perf_counter() - t0
            _STATS[name].append(dt)
            times = _STATS[name]
            print(f"[run_time] {name}: {dt * 1e3:.2f} ms "
                  f"(mean {np.mean(times) * 1e3:.2f} over {len(times)})")
            return out

        return wrapped

    return deco


def flops_estimate(fn: Callable, *example_args, **kwargs) -> Dict[str, Any]:
    """Run ``fn`` once under ``FlopCounterMode`` and return its operation
    count: ``flops`` (2 per multiply-add of the matmuls and convolutions
    it counts) and ``raw``, the counts by operator.  The JAX package's
    ``bytes_accessed`` has no counterpart here and is None."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*example_args, **kwargs)
    return {
        "flops": counter.get_total_flops(),
        "bytes_accessed": None,
        "raw": {str(k): v for k, v in
                counter.get_flop_counts().get("Global", {}).items()},
    }

"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds
go to ``build/kernels/<hash>/`` at the repository root, keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so a fresh
checkout builds them at first use and an edited source or header
rebuilds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG), "build", "kernels")
KERNELS = ("bev_pool", "msda", "fuse_warp", "conv3x3", "occ_tail", "conv3d",
           "conv_s8")
# --fmad=false keeps every float expression as separately rounded
# multiplies and adds, the rounding of the plain PyTorch versions
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, object] = {}
_sm_counts: Dict[object, int] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return path


def _target(name: str) -> str:
    """The library path of kernel ``name``, keyed by the flags, its source
    and every header under ``csrc/`` (an edited header rebuilds too)."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD, h.hexdigest()[:16], f"lib{name}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together.  Returns {name: library path}."""
    out = {n: _target(n) for n in names}
    procs = []
    for n, so in out.items():
        if os.path.exists(so):
            continue
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *FLAGS, "-Xptxas", "-v", "-o", tmp,
               os.path.join(CSRC, n + ".cu")]
        procs.append((n, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, so, tmp, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        with open(so + ".log", "w") as f:
            f.write(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(build([name])[name])
    return _libs[name]


def entry(name: str, fn: str, pointers: int, ints: int):
    """Library ``name``'s C entry ``fn`` taking ``pointers`` pointers,
    ``ints`` ints and a stream, its argument types set once."""
    key = (name, fn)
    if key not in _entries:
        f = getattr(lib(name), fn)
        f.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + \
            [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _entries[key] = f
    return _entries[key]


def sm_count(dev) -> int:
    """The streaming multiprocessors of card ``dev`` (cached)."""
    if dev not in _sm_counts:
        import torch
        _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_counts[dev]


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")


def refuse_grad(name: str, *ts) -> None:
    """Raise if grad mode is on and any input requires grad: the kernel
    (and its plain version, which stands in for it) records no backward,
    so its output would silently cut the autograd graph."""
    import torch
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in ts):
        raise RuntimeError(f"{name} has no backward; call it under "
                           f"torch.no_grad() or on tensors that do not "
                           f"require grad")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream

"""PyTorch / CUDA port of FB-OCC for NVIDIA Hopper: serving, training and
evaluation.

Mirrors the module layout of the JAX package ``fbbev_tpu`` (``geometry``,
``models/...``, ``ops/...``, ``serving``, ``data``, ``evaluation``,
``train``, ``tools``) without importing it or JAX.  Every TPU kernel has
a hand-written CUDA kernel here (``csrc/``), built at first use; each
kernel module also holds a plain PyTorch version, which CPU tensors
take.
"""

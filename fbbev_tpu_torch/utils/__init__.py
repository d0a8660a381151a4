"""Utilities of the port: the inference-time BatchNorm fold."""

"""Training-metric sinks.  The port's own copy of
``fbbev_tpu/utils/logging_hooks.py``: a CSV file, a TensorBoard events
file (its own record writer and CRC-32C, no TensorBoard or TensorFlow
needed) and a JSON webhook.

Replaces the reference's logging stack (TextLoggerHook / Tensorboard /
WandB wiring / MyWechatLoggerHook, SURVEY.md section 5) with small
composable sinks fed by the train loop's metric dicts.
"""

from __future__ import annotations

import csv
import json
import os
import urllib.request
from typing import Dict, Optional


class CsvLogger:
    """Appends metric rows to ``<work_dir>/train_log.csv``."""

    def __init__(self, work_dir: str, filename: str = "train_log.csv"):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, filename)
        self._fieldnames = None

    def __call__(self, metrics: Dict[str, float]) -> None:
        write_header = self._fieldnames is None and not os.path.exists(
            self.path)
        if self._fieldnames is None:
            self._fieldnames = list(metrics)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames,
                               extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(metrics)


class WebhookLogger:
    """POSTs metric dicts as JSON to a webhook URL (the spiritual successor
    of the reference's WeChat loss-curve hook,
    ``models/fbbev/utils/wechat_logger.py``)."""

    def __init__(self, url: str, every: int = 1,
                 timeout: float = 2.0):
        self.url = url
        self.every = every
        self.timeout = timeout
        self._count = 0

    def __call__(self, metrics: Dict[str, float]) -> Optional[int]:
        self._count += 1
        if self._count % self.every:
            return None
        data = json.dumps(metrics).encode()
        req = urllib.request.Request(
            self.url, data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status
        except Exception:
            return None  # logging must never kill training


# ----------------------------------------------------------------------
# TensorBoard event-file sink (dependency-free).
#
# The reference wires mmcv's TensorboardLoggerHook
# (``log_config.hooks`` in its configs); TF is not a dependency, so
# the TFRecord + Event protobuf framing is hand-encoded: an events file
# is a sequence of [len(u64) | masked-crc32c(len) | payload |
# masked-crc32c(payload)] records whose payload is an Event proto with
# (wall_time=1(double), step=2(int64), summary=5{ value=1{ tag=1(str),
# simple_value=2(float) } }).


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _crc32c(data: bytes) -> int:
    # CRC-32C (Castagnoli), bitwise; metric cadence makes speed irrelevant
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 * (crc & 1))
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class TensorboardLogger:
    """Writes scalar metrics as a TensorBoard events file under
    ``<work_dir>/tf_logs`` (readable by tensorboard / tensorboardX)."""

    def __init__(self, work_dir: str, step_key: str = "iter"):
        import struct
        import time as _time

        self.step_key = step_key
        log_dir = os.path.join(work_dir, "tf_logs")
        os.makedirs(log_dir, exist_ok=True)
        host = os.uname().nodename if hasattr(os, "uname") else "host"
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(_time.time())}.{host}")
        self._struct = struct
        # file-version header event
        ev = (b"\x09" + struct.pack("<d", _time.time())
              + b"\x1a" + _varint(len(b"brain.Event:2")) + b"brain.Event:2")
        self._write_record(ev)

    def _write_record(self, payload: bytes) -> None:
        st = self._struct
        hdr = st.pack("<Q", len(payload))
        with open(self.path, "ab") as f:
            f.write(hdr + st.pack("<I", _masked_crc(hdr)) + payload
                    + st.pack("<I", _masked_crc(payload)))

    def __call__(self, metrics: Dict[str, float]) -> None:
        import time as _time

        st = self._struct
        step = int(metrics.get(self.step_key, 0))
        values = b""
        for k, v in metrics.items():
            if k == self.step_key:
                continue
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            tag = k.encode()
            val = (b"\x0a" + _varint(len(tag)) + tag
                   + b"\x15" + st.pack("<f", fv))
            values += b"\x0a" + _varint(len(val)) + val
        ev = (b"\x09" + st.pack("<d", _time.time())
              + b"\x10" + _varint(step)
              + b"\x2a" + _varint(len(values)) + values)
        self._write_record(ev)

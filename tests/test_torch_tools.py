"""The port's two benchmark tools and ``FixedRigPipeline.benchmark`` on
the CPU, on the tiny synthetic config: each tool prints one JSON line
with its JAX counterpart's keys."""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "fbbev_tpu_torch", "configs",
                    "fbocc-r50-tiny_synthetic.py")


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def test_serving_bench_prints_its_line(capsys):
    from fbbev_tpu_torch.tools import serving_bench
    ret = serving_bench.main([TINY, "--device", "cpu", "--chunk", "4",
                              "--rounds", "1"])
    line = _line(capsys)
    assert line == ret
    assert sorted(line) == ["int8", "latency_ms", "metric", "unit", "value"]
    assert line["metric"] == "fbocc-r50-tiny_synthetic_serving_fps_per_chip"
    assert line["unit"] == "2-cam frames/sec/chip"
    assert line["int8"] is False
    assert line["value"] > 0 and line["latency_ms"] > 0


@pytest.mark.parametrize("train_step", [False, True])
def test_benchmark_prints_its_line(capsys, train_step):
    from fbbev_tpu_torch.tools import benchmark
    argv = [TINY, "--device", "cpu", "--iters", "1"]
    line = benchmark.main(argv + ["--train-step"] * train_step)
    assert _line(capsys) == line
    assert sorted(line) == ["batch_size", "frames_per_sec", "metric",
                            "value"]
    assert line["metric"] == ("train_step_latency_ms" if train_step
                              else "inference_latency_ms")
    assert line["batch_size"] == 1
    assert line["value"] > 0 and line["frames_per_sec"] > 0


def test_pipeline_benchmark_rate_and_state():
    """A positive rate, and the stream it ran (a start, then 3 + 2
    steady frames) left both history slots filled: the newest frame at
    age 0, the one before at age 1."""
    from fbbev_tpu_torch.config import Config
    from fbbev_tpu_torch.serving import FixedRigPipeline
    from fbbev_tpu_torch.tools.serving_bench import fixed_rig
    from fbbev_tpu_torch.utils.fuse_bn import build_folded
    model = build_folded(Config.fromfile(TINY), device="cpu")
    pipe = FixedRigPipeline(model, fixed_rig(2, 64, 176))
    fps = pipe.benchmark(iters=2)
    assert np.isfinite(fps) and fps > 0
    assert sorted(pipe.state.sweep_time[0].tolist()) == [0.0, 1.0]

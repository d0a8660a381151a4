"""Command-line tools of the port: ``python -m
fbbev_tpu_torch.tools.train <config>``, ``python -m
fbbev_tpu_torch.tools.test <config>``, ``python -m
fbbev_tpu_torch.tools.serving_bench <config>`` and ``python -m
fbbev_tpu_torch.tools.benchmark [<config>]``."""

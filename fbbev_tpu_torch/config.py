"""Python-file config system with ``_base_`` inheritance and deep-merge
overrides.  The port's own copy of ``fbbev_tpu/config.py`` (numpy-free,
torch-free): the same ``Config.fromfile`` / ``merge_from_options`` /
``to_dict`` / ``list_configs``, reading the configs under
``fbbev_tpu_torch/configs/``.

Configs are executable Python modules whose module-level names become the
config dict; values are plain dicts/lists/scalars.  A dict override with
``_delete_=True`` replaces the inherited value wholesale.
"""

from __future__ import annotations

import ast
import copy
import os
import types
from typing import Any, Dict, List


_DELETE_KEY = "_delete_"


def _exec_pyfile(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        src = f.read()
    module = types.ModuleType("_cfg")
    module.__file__ = path
    exec(compile(src, path, "exec"), module.__dict__)
    return {
        k: v
        for k, v in module.__dict__.items()
        if not k.startswith("__") and not isinstance(v, types.ModuleType)
        and not callable(v)
    }


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``override`` into ``base`` (override wins).

    A dict override containing ``_delete_: True`` replaces the base value
    wholesale (mmcv convention).
    """
    out = copy.deepcopy(base)
    for k, v in override.items():
        if (
            isinstance(v, dict)
            and isinstance(out.get(k), dict)
            and not v.get(_DELETE_KEY, False)
        ):
            out[k] = deep_merge(out[k], v)
        else:
            v = copy.deepcopy(v)
            if isinstance(v, dict):
                v.pop(_DELETE_KEY, None)
            out[k] = v
    return out


class Config(dict):
    """A dict with attribute access and ``fromfile`` / ``merge_from_options``."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        path = os.path.abspath(path)
        cfg_dict = _exec_pyfile(path)
        bases = cfg_dict.pop("_base_", [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for b in bases:
            base_cfg = cls.fromfile(os.path.join(os.path.dirname(path), b))
            merged = deep_merge(merged, base_cfg)
        merged = deep_merge(merged, cfg_dict)
        return cls(_wrap(merged))

    def merge_from_options(self, options: Dict[str, Any]) -> None:
        """Apply ``{'a.b.c': v}`` dotted-key overrides (cf. --cfg-options)."""
        for dotted, value in options.items():
            keys = dotted.split(".")
            d: Any = self
            for k in keys[:-1]:
                if k not in d or not isinstance(d[k], dict):
                    d[k] = Config()
                d = d[k]
            if isinstance(value, str):
                try:
                    value = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    pass
            d[keys[-1]] = value

    def to_dict(self) -> Dict[str, Any]:
        return _unwrap(self)


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_wrap(v) for v in obj)
    return obj


def _unwrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _unwrap(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unwrap(v) for v in obj)
    return obj


def list_configs(config_dir: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(config_dir):
        for f in files:
            if f.endswith(".py") and not f.startswith("_"):
                out.append(os.path.join(root, f))
    return sorted(out)

"""String-keyed component registry, the port's own copy of
``fbbev_tpu/registry.py``: a config's ``dict(type='FBOCC', ...)`` names a
registered constructor, the other keys are its arguments.  The port's
``FBOCC`` is registered in :data:`DETECTORS`, its datasets and dataset
wrappers in :data:`DATASETS`.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional


class Registry:
    """Maps a string ``type`` name to a constructor (class or function)."""

    def __init__(self, name: str):
        self.name = name
        self._items: Dict[str, Callable] = {}

    def register(self, obj: Optional[Callable] = None, *, name: Optional[str] = None):
        """Use as ``@REGISTRY.register`` or ``@REGISTRY.register(name='X')``."""

        def _do(o: Callable) -> Callable:
            key = name or o.__name__
            if key in self._items and self._items[key] is not o:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._items[key] = o
            return o

        if obj is None:
            return _do
        return _do(obj)

    def get(self, key: str) -> Callable:
        if key not in self._items:
            raise KeyError(
                f"{key!r} not found in registry {self.name!r}; "
                f"available: {sorted(self._items)}"
            )
        return self._items[key]

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def keys(self):
        return self._items.keys()


def build_from_cfg(cfg: Dict[str, Any], registry: Registry, **extra_kwargs):
    """Instantiate ``registry[cfg['type']](**cfg_without_type, **extra)``.

    Mirrors mmcv's ``build_from_cfg`` contract: ``cfg`` is a dict with a
    ``type`` key; remaining keys are constructor kwargs.  ``None`` cfg
    returns ``None`` (optional components, as the reference FB-OCC's
    ``frpn=None`` / ``pts_bbox_head=None``).
    """
    if cfg is None:
        return None
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    cfg = copy.deepcopy(dict(cfg))
    obj_type = cfg.pop("type")
    cls = registry.get(obj_type) if isinstance(obj_type, str) else obj_type
    cfg.update(extra_kwargs)
    return cls(**cfg)


# The registries a port module registers in (the JAX package has the
# reference mmdet3d's ten; the others come with the modules that use them).
DETECTORS = Registry("detectors")
DATASETS = Registry("datasets")

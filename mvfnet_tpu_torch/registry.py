"""String-keyed registries + config-dict builders.

The port's own copy of ``mvfnet_tpu/registry.py``: components register under
a string name and are instantiated from ``dict(type='Name', **kwargs)``
nodes. Entries here are classes: models, datasets and pipeline ops.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class registry. ``register_module`` is a class decorator
    (a duplicate name is an error); ``get`` returns ``None`` for unknown
    keys."""

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return (f'{self.__class__.__name__}(name={self._name}, '
                f'items={list(self._module_dict)})')

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, cls: Callable) -> Callable:
        key = cls.__name__
        if key in self._module_dict:
            raise KeyError(f'{key} is already registered in {self._name}')
        self._module_dict[key] = cls
        return cls


def build_from_cfg(cfg: Dict[str, Any], registry: Registry,
                   default_args: Optional[Dict[str, Any]] = None) -> Any:
    """Instantiate ``registry[cfg['type']](**cfg_without_type, **default_args)``.

    ``cfg['type']`` may be a string key or a callable; ``default_args`` fill
    in missing kwargs only.
    """
    if not isinstance(cfg, dict) or 'type' not in cfg:
        raise TypeError(f'cfg must be a dict with a "type" key, got {cfg!r}')
    args = dict(cfg)
    obj_type = args.pop('type')
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f'{obj_type} is not in the {registry.name} registry')
    elif inspect.isclass(obj_type) or callable(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f'type must be a str or callable, got {type(obj_type)}')
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)

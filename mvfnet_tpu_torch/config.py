"""Executable-Python config files, mmcv.Config style.

The port's own copy of ``mvfnet_tpu/config.py``: config files are plain
Python modules whose top-level names become config entries, with
``_base_`` inheritance, attribute access, dict-style access and ``.get``.
"""

from __future__ import annotations

import importlib.util
import itertools
import os
import sys
from typing import Any, Dict, Optional


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value


class Config:
    """A loaded config: wraps a ConfigDict, records the source filename."""

    def __init__(self, cfg_dict: Optional[Dict[str, Any]] = None,
                 filename: Optional[str] = None):
        cfg_dict = cfg_dict or {}
        object.__setattr__(self, '_cfg_dict', ConfigDict._wrap(dict(cfg_dict)))
        object.__setattr__(self, '_filename', filename)

    @staticmethod
    def fromfile(filename: str) -> 'Config':
        filename = os.path.abspath(os.path.expanduser(filename))
        return Config(Config._load_dict(filename), filename=filename)

    @staticmethod
    def _load_dict(filename: str) -> Dict[str, Any]:
        """Exec one config file and resolve its ``_base_`` chain: bases
        merge recursively dict-by-key, the deriving file wins, and non-dict
        values (lists included) replace wholesale."""
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        if not filename.endswith('.py'):
            raise ValueError('Only python config files are supported')
        # unique module name per load, so files with equal basenames do not
        # collide in sys.modules; exec at the real path for __file__ logic
        mod_name = f'_mvf_torch_cfg_{next(Config._load_counter)}'
        spec = importlib.util.spec_from_file_location(mod_name, filename)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        try:
            spec.loader.exec_module(mod)
            cfg_dict = {
                k: v for k, v in mod.__dict__.items()
                if not k.startswith('__') and not callable(v)
                and not isinstance(v, type(sys))
            }
        finally:
            sys.modules.pop(mod_name, None)
        bases = cfg_dict.pop('_base_', None)
        if bases:
            if isinstance(bases, str):
                bases = [bases]
            merged: Dict[str, Any] = {}
            for base in bases:
                base_path = os.path.join(os.path.dirname(filename), base)
                Config._merge_into(merged,
                                   Config._load_dict(os.path.abspath(base_path)))
            Config._merge_into(merged, cfg_dict)
            cfg_dict = merged
        return cfg_dict

    _load_counter = itertools.count()

    @staticmethod
    def _merge_into(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
        for k, v in src.items():
            if isinstance(v, dict) and v.pop('_delete_', False):
                dst[k] = v        # mmcv: replace wholesale, no merge
            elif isinstance(v, dict) and isinstance(dst.get(k), dict):
                Config._merge_into(dst[k], v)
            else:
                dst[k] = v

    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = ConfigDict._wrap(value)

    def __getitem__(self, name: str) -> Any:
        return self._cfg_dict[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def get(self, name: str, default: Any = None) -> Any:
        return self._cfg_dict.get(name, default)

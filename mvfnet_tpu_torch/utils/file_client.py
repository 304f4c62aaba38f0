"""Pluggable storage backends (counterpart of ``mvfnet_tpu/utils/file_client.py``;
reference ``codes/utils/file_client.py:24-144``).

Disk is the always-available backend; Ceph/Memcached register lazily and
raise a clear error if their client libraries are absent (they are optional
in the reference too).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Type


class BaseStorageBackend(ABC):
    @abstractmethod
    def get(self, filepath: str) -> bytes:
        ...


class HardDiskBackend(BaseStorageBackend):
    def get(self, filepath: str) -> bytes:
        with open(filepath, 'rb') as f:
            return f.read()


class CephBackend(BaseStorageBackend):
    def __init__(self, **kwargs):
        try:
            import ceph
        except ImportError as e:
            raise ImportError('ceph client is required for CephBackend') \
                from e
        self._client = ceph.S3Client()

    def get(self, filepath: str) -> bytes:
        value = self._client.Get(filepath)
        if not value:
            raise FileNotFoundError(filepath)
        return bytes(value)


class MemcachedBackend(BaseStorageBackend):
    def __init__(self, server_list_cfg: str, client_cfg: str, **kwargs):
        try:
            import mc
        except ImportError as e:
            raise ImportError(
                'pymemcache "mc" is required for MemcachedBackend') from e
        self._client = mc.MemcachedClient.GetInstance(server_list_cfg,
                                                      client_cfg)
        self._mc = mc

    def get(self, filepath: str) -> bytes:
        value = self._mc.pyvector()
        self._client.Get(filepath, value)
        return self._mc.ConvertBuffer(value)


class FileClient:
    """Backend selected by name; extra kwargs forwarded to the backend."""

    _backends: Dict[str, Type[BaseStorageBackend]] = {
        'disk': HardDiskBackend,
        'ceph': CephBackend,
        'memcached': MemcachedBackend,
    }

    def __init__(self, backend: str = 'disk', **kwargs):
        if backend not in self._backends:
            raise ValueError(
                f'Backend {backend} is not supported. Currently supported '
                f'ones are {list(self._backends)}')
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    @classmethod
    def register_backend(cls, name: str,
                         backend: Type[BaseStorageBackend]) -> None:
        cls._backends[name] = backend

    def get(self, filepath: str) -> bytes:
        return self.client.get(filepath)

"""In-memory storage adaptor (``mem://host/container``).

The fastest tier — host-DRAM caches and transient intermediate data (paper
§4.1 usage mode 2: "short-term, transient 'storage space' for intermediate
data, which can be removed after the end of the application run").
"""

from __future__ import annotations

import threading
from typing import Dict, List

from .base import BackendProfile, KeyNotFound, StorageAdaptor

# Shared across adaptor instances so that two PDs pointing at the same
# mem://host/container see the same data (like a shared filesystem would).
_STORES: Dict[str, Dict[str, bytes]] = {}
_LOCK = threading.Lock()


class MemoryBackend(StorageAdaptor):
    scheme = "mem"

    @classmethod
    def default_profile(cls) -> BackendProfile:
        # Host DRAM-class: very high bandwidth, negligible latency.
        return BackendProfile(bandwidth=20e9, op_latency=1e-6)

    def __init__(self, url: str, profile=None):
        super().__init__(url, profile)
        with _LOCK:
            self._store = _STORES.setdefault(
                f"{self.location}/{self.container}", {}
            )
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> int:
        key = self.validate_key(key)
        with self._lock:
            self._store[key] = bytes(data)
        return len(data)

    def get(self, key: str) -> bytes:
        key = self.validate_key(key)
        with self._lock:
            if key not in self._store:
                raise KeyNotFound(f"{self.url}: {key}")
            return self._store[key]

    def delete(self, key: str) -> None:
        key = self.validate_key(key)
        with self._lock:
            self._store.pop(key, None)

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._store if k.startswith(prefix))

    def exists(self, key: str) -> bool:
        key = self.validate_key(key)
        with self._lock:
            return key in self._store

    def size(self, key: str) -> int:
        key = self.validate_key(key)
        with self._lock:
            if key not in self._store:
                raise KeyNotFound(f"{self.url}: {key}")
            return len(self._store[key])

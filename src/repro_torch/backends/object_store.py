"""Object-store adaptor (``object://region/bucket``) — the paper's S3 class.

Properties mirrored from §2.2's discussion of cloud object stores:
  * flat, 1-level namespace (keys with ``/`` are transparently encoded),
  * write-once/read-many orientation (overwrite of an existing key raises
    unless versioning is enabled),
  * WAN-constrained ingest bandwidth with per-request latency (paper Fig. 7:
    "S3 is constrained by the limited bandwidth available to the Amazon
    datacenter", T_S grows linearly),
  * region-internal replication is "free" (the store itself replicates
    within a region — paper: "Amazon S3 automatically replicates data across
    multiple data centers within a region").
"""

from __future__ import annotations

import threading
from typing import Dict, List

from .base import BackendProfile, KeyNotFound, StorageAdaptor, StorageError

_BUCKETS: Dict[str, Dict[str, bytes]] = {}
_LOCK = threading.Lock()


class ObjectStoreBackend(StorageAdaptor):
    scheme = "object"
    flat_namespace = True

    def __init__(self, url: str, profile=None, versioning: bool = False):
        super().__init__(url, profile)
        self.versioning = versioning
        with _LOCK:
            self._bucket = _BUCKETS.setdefault(
                f"{self.location}/{self.container}", {}
            )
        self._lock = threading.Lock()

    @classmethod
    def default_profile(cls) -> BackendProfile:
        # WAN-constrained: modest bandwidth, request latency, catalog cost.
        return BackendProfile(
            bandwidth=0.25e9, op_latency=0.12, register_latency=0.01
        )

    def put(self, key: str, data: bytes) -> int:
        key = self.validate_key(key)
        with self._lock:
            if key in self._bucket and not self.versioning:
                raise StorageError(
                    f"object store is write-once ({key!r} exists; "
                    "enable versioning to overwrite)"
                )
            self._bucket[key] = bytes(data)
        return len(data)

    def get(self, key: str) -> bytes:
        key = self.validate_key(key)
        with self._lock:
            if key not in self._bucket:
                raise KeyNotFound(f"{self.url}: {key}")
            return self._bucket[key]

    def delete(self, key: str) -> None:
        key = self.validate_key(key)
        with self._lock:
            self._bucket.pop(key, None)

    def list(self, prefix: str = "") -> List[str]:
        prefix = prefix.replace("/", "%2F") if prefix else prefix
        with self._lock:
            return sorted(k for k in self._bucket if k.startswith(prefix))

    def exists(self, key: str) -> bool:
        key = self.validate_key(key)
        with self._lock:
            return key in self._bucket

    def size(self, key: str) -> int:
        key = self.validate_key(key)
        with self._lock:
            if key not in self._bucket:
                raise KeyNotFound(f"{self.url}: {key}")
            return len(self._bucket[key])

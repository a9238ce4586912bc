"""Filesystem storage adaptors.

``file://<host>/<abs-or-rel-root>`` — a directory on one host (the paper's
SSH-to-a-directory backend: cheap setup, moderate bandwidth).

``sharedfs://<site>/<root>`` — a parallel/shared filesystem mounted across a
site (the paper's Lustre-scratch-on-Lonestar backend, scenario 4): higher
sustained bandwidth, visible to every host in the site subtree, so a DU in a
shared-FS PD resolves as a logical link for any pilot in that site.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import List

from .base import BackendProfile, KeyNotFound, StorageAdaptor

_SANDBOX = os.environ.get(
    "REPRO_STORAGE_ROOT", os.path.join(tempfile.gettempdir(), "repro_storage")
)


class LocalFSBackend(StorageAdaptor):
    scheme = "file"

    @classmethod
    def default_profile(cls) -> BackendProfile:
        # SSH/scp-class: low setup cost, moderate bandwidth (paper Fig. 7:
        # "For smaller data volumes SSH is a better choice").
        return BackendProfile(bandwidth=0.8e9, op_latency=0.05)

    def __init__(self, url: str, profile=None):
        super().__init__(url, profile)
        root = self.container or "default"
        self.root = os.path.join(_SANDBOX, self.scheme, self.location, root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        key = self.validate_key(key)
        return os.path.join(self.root, key.replace("%2F", "/"))

    def put(self, key: str, data: bytes) -> int:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._lock, open(path, "wb") as fh:
            fh.write(data)
        return len(data)

    def get(self, key: str) -> bytes:
        path = self._path(key)
        if not os.path.exists(path):
            raise KeyNotFound(f"{self.url}: {key}")
        with open(path, "rb") as fh:
            return fh.read()

    def delete(self, key: str) -> None:
        path = self._path(key)
        if os.path.exists(path):
            os.remove(path)

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def size(self, key: str) -> int:
        path = self._path(key)
        if not os.path.exists(path):
            raise KeyNotFound(f"{self.url}: {key}")
        return os.path.getsize(path)


class SharedFSBackend(LocalFSBackend):
    scheme = "sharedfs"

    @classmethod
    def default_profile(cls) -> BackendProfile:
        # Parallel-FS-class (GridFTP-to-Lustre in the paper): high sustained
        # bandwidth, some per-op cost.
        return BackendProfile(bandwidth=4e9, op_latency=0.02)

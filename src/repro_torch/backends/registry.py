"""URL-scheme → adaptor registry (paper: "The URL scheme is used to select
an appropriate BigJob adaptor")."""

from __future__ import annotations

import urllib.parse
from typing import Dict, Optional, Type

from .base import BackendProfile, StorageAdaptor
from .local_fs import LocalFSBackend, SharedFSBackend
from .memory import MemoryBackend
from .object_store import ObjectStoreBackend

_REGISTRY: Dict[str, Type[StorageAdaptor]] = {}


def register_backend(cls: Type[StorageAdaptor]) -> Type[StorageAdaptor]:
    if not cls.scheme:
        raise ValueError("backend class must define a scheme")
    _REGISTRY[cls.scheme] = cls
    return cls


for _cls in (MemoryBackend, LocalFSBackend, SharedFSBackend, ObjectStoreBackend):
    register_backend(_cls)


def make_backend(
    url: str, profile: Optional[BackendProfile] = None, **kwargs
) -> StorageAdaptor:
    scheme = urllib.parse.urlparse(url).scheme
    if scheme not in _REGISTRY:
        raise ValueError(
            f"no storage adaptor for scheme {scheme!r} "
            f"(available: {sorted(_REGISTRY)})"
        )
    return _REGISTRY[scheme](url, profile=profile, **kwargs)


def available_schemes() -> list:
    return sorted(_REGISTRY)

from .base import (
    CHUNK_DIR,
    BackendProfile,
    KeyNotFound,
    StorageAdaptor,
    StorageError,
    chunk_key,
    parse_chunk_key,
)
from .local_fs import LocalFSBackend, SharedFSBackend
from .memory import MemoryBackend
from .object_store import ObjectStoreBackend
from .registry import available_schemes, make_backend, register_backend

__all__ = [
    "BackendProfile",
    "CHUNK_DIR",
    "chunk_key",
    "parse_chunk_key",
    "KeyNotFound",
    "StorageAdaptor",
    "StorageError",
    "LocalFSBackend",
    "SharedFSBackend",
    "MemoryBackend",
    "ObjectStoreBackend",
    "available_schemes",
    "make_backend",
    "register_backend",
]

"""Storage adaptor base — the paper's adaptor pattern (§4.2).

"A resource adaptor encapsulates the different infrastructure-specific
semantics of the backend system ... in the case of Pilot-Data different
storage types (e.g. file vs. object storage), access and transfer
protocols."  The URL scheme selects the adaptor (paper: "The URL scheme is
used to select an appropriate BigJob adaptor").

Each adaptor also declares a performance profile (effective bandwidth,
per-operation latency) used by the simulated transfer clock so benchmarks
can reproduce the paper's backend comparisons (Fig. 7) deterministically on
a single node.  The profiles mirror the *relative* characteristics the paper
measured: GridFTP/SRM-class bulk bandwidth, SSH-class low setup cost,
service-layer (Globus-Online-class) per-request overhead, WAN-constrained
object stores.
"""

from __future__ import annotations

import abc
import dataclasses
import urllib.parse
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BackendProfile:
    """Performance profile for the simulated transfer clock."""

    bandwidth: float  # bytes/sec sustained
    op_latency: float  # fixed per-operation setup cost, seconds
    register_latency: float = 0.0  # catalog/registration cost per file


class StorageAdaptor(abc.ABC):
    """Uniform interface over heterogeneous storage backends.

    Keys are container-relative POSIX-ish paths (``a/b/c``).  Object-store
    adaptors may restrict the namespace (see ``flat_namespace``), mirroring
    the paper's note that cloud stores "provide only a namespace with a
    1-level hierarchy".
    """

    scheme: str = ""
    flat_namespace: bool = False

    def __init__(self, url: str, profile: Optional[BackendProfile] = None):
        self.url = url
        parsed = urllib.parse.urlparse(url)
        if parsed.scheme != self.scheme:
            raise ValueError(
                f"{type(self).__name__} expects scheme {self.scheme!r}, got {url!r}"
            )
        self.location = parsed.netloc  # affinity label host part
        self.container = parsed.path.lstrip("/")
        self.profile = profile or self.default_profile()

    # ------------------------------------------------------------ abstract
    @classmethod
    @abc.abstractmethod
    def default_profile(cls) -> BackendProfile: ...

    @abc.abstractmethod
    def put(self, key: str, data: bytes) -> int:
        """Store bytes under key; returns size stored."""

    @abc.abstractmethod
    def get(self, key: str) -> bytes: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    @abc.abstractmethod
    def list(self, prefix: str = "") -> List[str]: ...

    @abc.abstractmethod
    def exists(self, key: str) -> bool: ...

    # ------------------------------------------------------------- helpers
    def validate_key(self, key: str) -> str:
        if not key or key.startswith("/") or ".." in key.split("/"):
            raise ValueError(f"bad storage key {key!r}")
        if self.flat_namespace and "/" in key:
            # 1-level hierarchy (S3-style): flatten with an encoded separator.
            key = key.replace("/", "%2F")
        return key

    def size(self, key: str) -> int:
        return len(self.get(key))

    def total_bytes(self) -> int:
        return sum(self.size(k) for k in self.list())

    def simulated_put_time(self, nbytes: int) -> float:
        p = self.profile
        return p.op_latency + nbytes / p.bandwidth + p.register_latency

    def simulated_get_time(self, nbytes: int) -> float:
        p = self.profile
        return p.op_latency + nbytes / p.bandwidth

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} {self.url}>"


#: reserved sub-namespace for a DU's physical chunk stream inside a PD
#: container (no legal DU-relative file path can collide: path segments of
#: ``.c`` style dot-names are still valid, but the chunk files carry a
#: fixed-width numeric name under it that the file layer never writes)
CHUNK_DIR = ".c"


def chunk_key(du_id: str, index: int) -> str:
    """Backend key for chunk ``index`` of DU ``du_id``.

    The chunk — not the file — is the unit of physical storage: adaptors
    see a flat sequence of same-sized objects per DU, which is what makes
    partial replicas and ranged/striped transfers expressible on flat
    object stores (the paper's 1-level-hierarchy caveat) exactly as on
    hierarchical ones.
    """
    return f"{du_id}/{CHUNK_DIR}/{index:08d}"


def parse_chunk_key(key: str) -> Optional[Tuple[str, int]]:
    """Inverse of :func:`chunk_key`; None if ``key`` is not a chunk key."""
    parts = key.split("/")
    if len(parts) < 3 or parts[-2] != CHUNK_DIR:
        return None
    try:
        return "/".join(parts[:-2]), int(parts[-1])
    except ValueError:
        return None


class StorageError(RuntimeError):
    pass


class KeyNotFound(StorageError):
    pass


def join_meta(d: Dict[str, str]) -> str:
    return urllib.parse.urlencode(d)

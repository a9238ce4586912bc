"""Affinity model: logical resource topology tree with weighted edges.

Paper §5: "data centers and machines are organized in a logical topology
tree.  The further the distance between two resources, the smaller their
affinity. ... this model ... can be enhanced by assigning weights to each
edge to reflect dynamical changes in factors that contribute to
connectivity."

A location is a colon-separated label, e.g. ``"cluster:pod0:host3"`` (the
paper's user-defined affinity label from the Pilot description).  Every
prefix of a label is a node in the tree; each node carries the bandwidth and
latency of its *uplink* (edge to its parent).  The effective bandwidth
between two locations is the bottleneck (min) edge along the tree path; the
latency is the sum.

For the TPU adaptation the levels are cluster → pod → host → device and the
default uplink constants mirror the assignment's hardware model (ICI within a
pod, DCN across pods, PCIe host↔device).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

GB = 1e9


@dataclasses.dataclass
class _Node:
    label: str  # full label, e.g. "cluster:pod0:host3"
    parent: Optional[str]
    uplink_bw: float  # bytes/sec to parent
    uplink_lat: float  # seconds to parent
    meta: Dict[str, float] = dataclasses.field(default_factory=dict)


def _prefixes(label: str) -> List[str]:
    parts = label.split(":")
    return [":".join(parts[: i + 1]) for i in range(len(parts))]


class Topology:
    """A weighted logical topology tree over affinity labels."""

    #: default uplink (bandwidth bytes/s, latency s) per tree depth,
    #: depth 1 = site/pod uplink to the cluster root (WAN/DCN), deeper =
    #: faster, more local links.  Chosen to mirror TPU-fleet tiers:
    #: DCN ~ 25 GB/s per pod, pod fabric ~ 50 GB/s/link ICI, host PCIe ~ 16 GB/s.
    DEFAULT_TIER_BW = {1: 25 * GB, 2: 50 * GB, 3: 16 * GB, 4: 819 * GB}
    DEFAULT_TIER_LAT = {1: 1e-3, 2: 5e-6, 3: 2e-6, 4: 1e-7}

    def __init__(self) -> None:
        self._nodes: Dict[str, _Node] = {}

    # ------------------------------------------------------------ building
    def register(
        self,
        label: str,
        bandwidth: Optional[float] = None,
        latency: Optional[float] = None,
        **meta: float,
    ) -> None:
        """Register a location (and implicitly all its ancestors).

        ``bandwidth``/``latency`` describe the *uplink* of the deepest node
        in ``label``; ancestors get tier defaults unless already registered.
        """
        prefixes = _prefixes(label)
        for depth, prefix in enumerate(prefixes, start=1):
            is_leaf_of_label = prefix == label
            if prefix in self._nodes:
                if is_leaf_of_label:
                    node = self._nodes[prefix]
                    if bandwidth is not None:
                        node.uplink_bw = bandwidth
                    if latency is not None:
                        node.uplink_lat = latency
                    node.meta.update(meta)
                continue
            parent = prefixes[depth - 2] if depth >= 2 else None
            bw = (
                bandwidth
                if (is_leaf_of_label and bandwidth is not None)
                else self.DEFAULT_TIER_BW.get(depth, self.DEFAULT_TIER_BW[max(self.DEFAULT_TIER_BW)])
            )
            lat = (
                latency
                if (is_leaf_of_label and latency is not None)
                else self.DEFAULT_TIER_LAT.get(depth, self.DEFAULT_TIER_LAT[max(self.DEFAULT_TIER_LAT)])
            )
            self._nodes[prefix] = _Node(
                prefix, parent, bw, lat, dict(meta) if is_leaf_of_label else {}
            )

    def ensure(self, label: str) -> None:
        if label not in self._nodes:
            self.register(label)

    def labels(self) -> List[str]:
        return sorted(self._nodes)

    def set_edge_weight(
        self, label: str, bandwidth: Optional[float] = None, latency: Optional[float] = None
    ) -> None:
        """Dynamically re-weight an uplink (paper: weights "reflect dynamical
        changes in factors that contribute to connectivity")."""
        self.ensure(label)
        node = self._nodes[label]
        if bandwidth is not None:
            node.uplink_bw = bandwidth
        if latency is not None:
            node.uplink_lat = latency

    # ------------------------------------------------------------- queries
    def _path_to_root(self, label: str) -> List[str]:
        self.ensure(label)
        path = []
        cur: Optional[str] = label
        while cur is not None:
            path.append(cur)
            cur = self._nodes[cur].parent
        return path

    def common_ancestor(self, a: str, b: str) -> Optional[str]:
        pa = set(self._path_to_root(a))
        for node in self._path_to_root(b):
            if node in pa:
                return node
        return None

    def path_edges(self, a: str, b: str) -> List[_Node]:
        """Edges (as child nodes) on the tree path a→b, excluding the LCA."""
        if a == b:
            return []
        lca = self.common_ancestor(a, b)
        edges: List[_Node] = []
        for start in (a, b):
            cur: Optional[str] = start
            while cur is not None and cur != lca:
                edges.append(self._nodes[cur])
                cur = self._nodes[cur].parent
            if cur is None and lca is not None:
                raise ValueError(f"disconnected labels {a!r}, {b!r}")
        return edges

    def distance(self, a: str, b: str) -> int:
        """Tree hop distance (number of edges on the path)."""
        return len(self.path_edges(a, b))

    def affinity(self, a: str, b: str) -> float:
        """Paper: "The smaller the distance between two resources, the larger
        the affinity."  Normalized to (0, 1], 1 == same location."""
        return 2.0 ** (-self.distance(a, b))

    def bandwidth(self, a: str, b: str) -> float:
        """Bottleneck bandwidth along the tree path (bytes/s); inf if a==b
        (a co-located transfer is a logical link, §4.3.2)."""
        edges = self.path_edges(a, b)
        if not edges:
            return float("inf")
        return min(e.uplink_bw for e in edges)

    def latency(self, a: str, b: str) -> float:
        return sum(e.uplink_lat for e in self.path_edges(a, b))

    def same_subtree(self, a: str, b: str, level: int = 1) -> bool:
        """True if a and b share an ancestor at the given depth (1=site)."""
        pa, pb = _prefixes(a), _prefixes(b)
        return len(pa) >= level and len(pb) >= level and pa[level - 1] == pb[level - 1]


def match_affinity(constraint: Optional[str], location: str) -> bool:
    """Does ``location`` satisfy an affinity *constraint*?

    Paper §5: "CUs and DUs can constrain their execution resource to a
    particular affinity (e.g. to a certain location or sub-tree in the
    logical resource topology)."  A constraint matches itself and any
    descendant label.
    """
    if not constraint:
        return True
    return location == constraint or location.startswith(constraint + ":")


def make_tpu_fleet_topology(
    pods: int = 2,
    hosts_per_pod: int = 4,
    dcn_bw: float = 25 * GB,
    ici_bw: float = 50 * GB,
    pcie_bw: float = 16 * GB,
    cluster: str = "cluster",
) -> Tuple[Topology, List[str]]:
    """Convenience: build the TPU-fleet topology used across tests/benchmarks.

    Returns (topology, host labels)."""
    topo = Topology()
    hosts = []
    for p in range(pods):
        topo.register(f"{cluster}:pod{p}", bandwidth=dcn_bw, latency=1e-3)
        for h in range(hosts_per_pod):
            label = f"{cluster}:pod{p}:host{h}"
            topo.register(label, bandwidth=ici_bw, latency=5e-6)
            hosts.append(label)
    return topo, hosts


def make_grid_topology(sites: Iterable[Tuple[str, float, float]]) -> Topology:
    """Build a paper-style multi-site grid topology.

    ``sites``: iterable of (label, uplink_bandwidth_bytes_per_s, latency_s),
    e.g. the XSEDE/OSG site set of §6 with measured WAN bandwidths.
    """
    topo = Topology()
    for label, bw, lat in sites:
        topo.register(label, bandwidth=bw, latency=lat)
    return topo

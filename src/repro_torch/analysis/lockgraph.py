"""PD-L005 — static cross-module lock-order graph with cycle detection.

Nodes are canonical lock names (``Class.attr`` / ``module.var``); a
directed edge A→B means "somewhere, B is acquired while A is held" —
either a lexically nested ``with``, or a call made under A to a function
whose transitive acquisition closure contains B.  Two synthetic edge
families model the runtime that nesting can't show lexically:

  * ``CoordinationStore._inline_lock`` → every lock a subscriber callback
    acquires (inline dispatch runs callbacks under the drain lock), and
  * caller lock → the full closure of any store op it calls (mutators
    reach the shard/event/WAL locks and, in inline mode, the drain lock).

A cycle is a potential lock-order inversion; a same-name self edge
(N locks of one class acquired while a sibling is held, e.g. striped
``_lock_all`` loops) is reported too, because index-ordering is the only
thing making it safe and the analyzer cannot prove it.

:func:`build_lock_graph` is also the witness's ground truth: the runtime
lock-order witness (``analysis/witness.py``) checks the edges it observes
against this graph.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .model import Finding, Project
from .rules import LintRule, register_rule


@dataclasses.dataclass(frozen=True)
class EdgeSite:
    path: str
    line: int
    col: int
    desc: str


class LockGraph:
    def __init__(self) -> None:
        #: (a, b) -> first witnessed site for the edge
        self.edges: Dict[Tuple[str, str], EdgeSite] = {}
        self.succ: Dict[str, Set[str]] = {}
        #: same-name nested acquisitions (reported separately)
        self.self_edges: List[Tuple[str, EdgeSite]] = []

    def add(self, a: str, b: str, site: EdgeSite) -> None:
        if a == b:
            self.self_edges.append((a, site))
            return
        if (a, b) not in self.edges:
            self.edges[(a, b)] = site
            self.succ.setdefault(a, set()).add(b)

    def find_cycles(self) -> List[List[str]]:
        """Minimal-ish cycles, one per strongly-connected component."""
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            for w in self.succ.get(v, ()):
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(comp)

        for v in list(self.succ):
            if v not in index:
                strongconnect(v)
        return [self._cycle_path(scc) for scc in sccs]

    def _cycle_path(self, scc: List[str]) -> List[str]:
        """An explicit cycle inside an SCC, as [a, b, ..., a]."""
        members = set(scc)
        start = scc[0]
        path = [start]
        seen = {start}
        cur = start
        while True:
            nxts = [w for w in self.succ.get(cur, ()) if w in members]
            if not nxts:
                return path  # defensive: SCC guarantees a successor
            nxt = min(nxts)
            if nxt in seen:
                return path[path.index(nxt) :] + [nxt]
            path.append(nxt)
            seen.add(nxt)
            cur = nxt


def build_lock_graph(project: Project) -> LockGraph:
    graph = LockGraph()
    for fn in project.all_functions():
        for acq in fn.acquires:
            if acq.held:
                top = acq.held[-1]
                if (
                    top.name == acq.lock.name
                    and top.text == acq.lock.text
                    and top.tag == "rlock"
                ):
                    # re-entering the same RLock instance: safe by design
                    continue
                graph.add(
                    acq.held[-1].name,
                    acq.lock.name,
                    EdgeSite(
                        str(fn.module.path),
                        acq.line,
                        acq.col,
                        f"nested acquisition in {fn.qualname}()",
                    ),
                )
        for acq in fn.loop_acquires:
            graph.self_edges.append(
                (
                    acq.lock.name,
                    EdgeSite(
                        str(fn.module.path),
                        acq.line,
                        acq.col,
                        f"loop acquisition without release in {fn.qualname}()",
                    ),
                )
            )
        for fact in fn.calls:
            if not fact.held:
                continue
            callee = project.resolve_call(fact, fn)
            if callee is None or not callee.acq_closure:
                continue
            top = fact.held[-1]
            for target in sorted(callee.acq_closure):
                if (
                    target == top.name
                    and top.tag == "rlock"
                    and fact.recv_text == "self"
                ):
                    # self-call re-entering our own RLock: safe by design
                    continue
                graph.add(
                    fact.held[-1].name,
                    target,
                    EdgeSite(
                        str(fn.module.path),
                        fact.line,
                        fact.col,
                        f"{fn.qualname}() calls {callee.qualname}() "
                        f"while holding {fact.held[-1].name}",
                    ),
                )
    # inline dispatch: callbacks run under the store's drain lock
    for store_name in sorted(project.store_classes):
        cls = project.class_index[store_name]
        if "_inline_lock" not in cls.attr_tags:
            continue
        drain = f"{store_name}._inline_lock"
        for fn in project.all_functions():
            if not fn.is_subscriber_cb:
                continue
            for target in sorted(fn.acq_closure):
                graph.add(
                    drain,
                    target,
                    EdgeSite(
                        str(fn.module.path),
                        getattr(fn.node, "lineno", 0),
                        0,
                        f"inline dispatch into subscriber {fn.qualname}()",
                    ),
                )
    return graph


@register_rule("PD-L005")
class LockOrderInversion(LintRule):
    """The whole-project lock graph must stay acyclic (and same-class
    striped locks must not nest without a provable order)."""

    title = "lock-order inversion (cycle in the static lock graph)"
    scope = "project"

    def check_project(self, project):
        graph = build_lock_graph(project)
        for name, site in graph.self_edges:
            yield Finding(
                rule=self.rule_id,
                path=site.path,
                line=site.line,
                col=site.col,
                message=(
                    f"multiple '{name}' instances acquired while one is "
                    f"already held ({site.desc}) — ordering unprovable "
                    f"statically"
                ),
                hint=(
                    "acquire in a fixed total order (e.g. shard index) and "
                    "suppress with a justification, or restructure to hold "
                    "one at a time"
                ),
            )
        for cycle in graph.find_cycles():
            ring = " → ".join(cycle)
            sites = []
            for a, b in zip(cycle, cycle[1:]):
                site = graph.edges.get((a, b))
                if site is not None:
                    sites.append(f"{a}→{b} at {site.path}:{site.line} ({site.desc})")
            anchor: Optional[EdgeSite] = (
                graph.edges.get((cycle[0], cycle[1])) if len(cycle) > 1 else None
            )
            yield Finding(
                rule=self.rule_id,
                path=anchor.path if anchor else "<project>",
                line=anchor.line if anchor else 0,
                col=anchor.col if anchor else 0,
                message=f"lock-order inversion: {ring}",
                hint="; ".join(sites)
                or "pick one global order for these locks and stick to it",
            )

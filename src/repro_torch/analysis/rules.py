"""pdlint rules — the concurrency contracts of the coordination plane.

Each rule is a registered :class:`LintRule` (registry styled after
``core/placement.py``'s PlacementStrategy registry).  Rule ids map 1:1
onto the numbered invariants in the README "Concurrency contracts"
section:

  PD-L001  no store op while a store-internal lock is held
  PD-L002  no unbounded blocking call under any held lock
  PD-L003  subscriber callbacks must not mutate the store directly
  PD-L004  mutate-then-read of event-derived state needs flush_events()
  PD-L005  the cross-module lock graph must stay acyclic (see lockgraph)
  PD-L006  no scan materialization (sort/extend) under a shard stripe
"""

from __future__ import annotations

import abc
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional

from .model import (
    CallFact,
    Finding,
    FunctionFacts,
    ModuleModel,
    Project,
    STORE_BLOCKING,
    STORE_MUTATORS,
    STORE_PUBLISHING,
    STORE_READS,
    is_store_recv,
    leaf_blocking,
)


class LintRule(abc.ABC):
    """One checkable contract; subclasses register via @register_rule."""

    rule_id: str = "?"
    title: str = ""
    #: "module" rules run once per file; "project" rules once per run
    scope: str = "module"

    def check_module(
        self, project: Project, module: ModuleModel
    ) -> Iterator[Finding]:
        return iter(())

    def check_project(self, project: Project) -> Iterator[Finding]:
        return iter(())


_REGISTRY: Dict[str, Callable[[], LintRule]] = {}
_registry_lock = threading.Lock()


def register_rule(rule_id: str):
    """Class decorator: ``@register_rule("PD-L001")`` (placement-registry
    idiom — the id doubles as the suppression token)."""

    def deco(cls):
        cls.rule_id = rule_id
        with _registry_lock:
            _REGISTRY[rule_id] = cls
        return cls

    return deco


def make_rules(select: Optional[Iterable[str]] = None) -> List[LintRule]:
    with _registry_lock:
        ids = sorted(_REGISTRY) if select is None else list(select)
        missing = [i for i in ids if i not in _REGISTRY]
        if missing:
            raise KeyError(
                f"unknown rule(s) {missing}; known: {sorted(_REGISTRY)}"
            )
        return [_REGISTRY[i]() for i in ids]


def list_rules() -> List[str]:
    with _registry_lock:
        return sorted(_REGISTRY)


# ------------------------------------------------------------------ rules


def _held_desc(fact: CallFact) -> str:
    return ", ".join(h.name for h in fact.held)


@register_rule("PD-L001")
class StoreOpUnderStoreLock(LintRule):
    """A store-API call issued while a lock of the store itself is held:
    re-entering a shard/WAL/event lock from inside its own critical
    section is a self-deadlock (or holds a stripe across dispatch)."""

    title = "store op under a store-internal lock"

    def check_module(self, project, module):
        ops = STORE_MUTATORS | STORE_READS | STORE_BLOCKING
        for cls_name in project.store_classes & set(module.classes):
            cls = module.classes[cls_name]
            for fn in cls.methods.values():
                for fact in fn.calls:
                    if not fact.held or fact.recv_text != "self":
                        continue
                    if fact.func_name not in ops:
                        continue
                    yield Finding(
                        rule=self.rule_id,
                        path=str(module.path),
                        line=fact.line,
                        col=fact.col,
                        message=(
                            f"store op self.{fact.func_name}() called inside "
                            f"a critical section (held: {_held_desc(fact)})"
                        ),
                        hint=(
                            "collect under the lock, call the store op after "
                            "release — see hset()'s flush-after-release shape"
                        ),
                    )


@register_rule("PD-L002")
class BlockingUnderLock(LintRule):
    """An unbounded blocking call (sleep, join, Event/Condition wait,
    queue.get, file I/O, transfers, flush_events barriers) while any lock
    is held stalls every thread contending on that lock."""

    title = "blocking call under a held lock"

    def check_module(self, project, module):
        for fn in module.functions.values():
            seen = set()
            for fact in fn.calls:
                if not fact.held:
                    continue
                reason = None
                leaf = leaf_blocking(project, fact)
                if leaf is not None:
                    blocked, exempt = leaf
                    if exempt:
                        continue
                    reason = blocked
                else:
                    callee = project.resolve_call(fact, fn)
                    if (
                        callee is not None
                        and callee.blocking_reason
                        and not (
                            is_store_recv(project, fact)
                            and fact.func_name
                            in (STORE_MUTATORS | STORE_READS)
                        )
                    ):
                        reason = f"{callee.qualname}() → {callee.blocking_reason}"
                if reason is None:
                    continue
                key = (fact.line, fact.func_name)
                if key in seen:
                    continue
                seen.add(key)
                yield Finding(
                    rule=self.rule_id,
                    path=str(module.path),
                    line=fact.line,
                    col=fact.col,
                    message=(
                        f"blocking call ({reason}) while holding "
                        f"{_held_desc(fact)}"
                    ),
                    hint=(
                        "move the wait outside the critical section, or "
                        "snapshot state under the lock and block after "
                        "release"
                    ),
                )


@register_rule("PD-L003")
class MutatingSubscriberCallback(LintRule):
    """A ``store.subscribe`` callback that mutates the store directly.

    Callbacks run on the dispatcher thread; a mutation re-enters the
    event plane from inside delivery (and, in inline dispatch mode, runs
    under the caller's locks).  The sanctioned re-entrant path is a
    handoff: queue.put to your own thread or a StoreEventPump."""

    title = "subscriber callback mutates the store"
    scope = "project"

    def check_project(self, project):
        for fn in project.all_functions():
            if not fn.is_subscriber_cb:
                continue
            for fact in fn.calls:
                chain = None
                if is_store_recv(project, fact) and fact.func_name in STORE_MUTATORS:
                    chain = f"store.{fact.func_name}"
                else:
                    callee = project.resolve_call(fact, fn)
                    if (
                        callee is not None
                        and callee.publishes
                        and not (
                            is_store_recv(project, fact)
                            and fact.func_name not in STORE_MUTATORS
                        )
                    ):
                        chain = f"{callee.qualname}() → {callee.mutate_chain}"
                if chain is None:
                    continue
                yield Finding(
                    rule=self.rule_id,
                    path=str(fn.module.path),
                    line=fact.line,
                    col=fact.col,
                    message=(
                        f"subscriber callback {fn.qualname}() mutates the "
                        f"store ({chain})"
                    ),
                    hint=(
                        "hand the event to your own queue/StoreEventPump and "
                        "mutate from that thread (subscribe() docstring)"
                    ),
                )


@register_rule("PD-L004")
class MutateThenReadWithoutBarrier(LintRule):
    """Publish a mutation, then read state a subscriber callback derives
    from it, with no ``flush_events()`` barrier in between: the dispatcher
    delivers asynchronously, so the read can see the pre-mutation value."""

    title = "mutate-then-read of derived state without flush_events()"
    scope = "project"

    def check_project(self, project):
        for fn in project.all_functions():
            yield from self._check_fn(project, fn)

    def _check_fn(self, project: Project, fn: FunctionFacts):
        if fn.is_subscriber_cb:
            return  # callbacks run ON the dispatcher: nothing to barrier
        derived = set()
        if fn.cls:
            cls = fn.module.classes.get(fn.cls)
            if cls is not None:
                derived = cls.derived_attrs
        dirty: Optional[str] = None
        reported = set()
        for ev in fn.events:
            if ev[0] == "call":
                fact = ev[1]
                if fact.func_name == "flush_events" and (
                    is_store_recv(project, fact) or fact.recv_text == "self"
                ):
                    dirty = None
                    continue
                if is_store_recv(project, fact) and (
                    fact.func_name in STORE_PUBLISHING
                ):
                    dirty = f"store.{fact.func_name} (line {fact.line})"
                    continue
                callee = project.resolve_call(fact, fn)
                if callee is None:
                    continue
                if dirty is not None:
                    for attr in sorted(callee.exposed_reads):
                        yield from self._report(fn, fact, attr, dirty, reported)
                if callee.publishes and not (
                    is_store_recv(project, fact)
                    and fact.func_name not in STORE_PUBLISHING
                ):
                    dirty = (
                        f"{callee.qualname}() → {callee.mutate_chain} "
                        f"(line {fact.line})"
                    )
            elif ev[0] == "read" and dirty is not None and ev[1] in derived:
                attr, line = ev[1], ev[2]
                fake = CallFact(line, 0, "", None, None, (), None, False)
                yield from self._report(fn, fake, attr, dirty, reported)

    def _report(self, fn, fact, attr, dirty, reported):
        if attr in reported:
            return
        reported.add(attr)
        yield Finding(
            rule=self.rule_id,
            path=str(fn.module.path),
            line=fact.line,
            col=fact.col,
            message=(
                f"{fn.qualname}() reads event-derived '{attr}' after "
                f"{dirty} with no flush_events() barrier"
            ),
            hint=(
                "call store.flush_events() between the mutation and the "
                "read, or accept staleness with a reviewed disable"
            ),
        )


@register_rule("PD-L006")
class ScanMaterializationUnderStripe(LintRule):
    """Allocation-heavy result materialization (sort/extend across
    shards) under a stripe lock: per-shard critical sections must stay
    O(log n + slice); merging belongs outside the lock."""

    title = "scan materialization under a shard stripe lock"

    def check_module(self, project, module):
        for cls_name in project.store_classes & set(module.classes):
            cls = module.classes[cls_name]
            for fn in cls.methods.values():
                for fact in fn.calls:
                    if not fact.held:
                        continue
                    if fact.func_name == "sorted" or (
                        fact.func_name in ("sort", "extend")
                        and fact.recv_text is not None
                    ):
                        yield Finding(
                            rule=self.rule_id,
                            path=str(module.path),
                            line=fact.line,
                            col=fact.col,
                            message=(
                                f"{fact.func_name}() materializes results "
                                f"under {_held_desc(fact)}"
                            ),
                            hint=(
                                "copy the per-shard slice under the lock, "
                                "merge/sort the slices after release "
                                "(heapq.merge over sorted slices)"
                            ),
                        )


# PD-L005 lives in lockgraph.py (it needs the whole-project lock graph);
# importing it here registers the rule alongside the others.
from . import lockgraph as _lockgraph  # noqa: E402,F401

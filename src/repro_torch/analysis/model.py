"""Semantic model for pdlint — AST facts the concurrency rules consume.

pdlint is a *project-specific* analyzer: it does not try to type-check
arbitrary Python, it encodes the conventions of this repository (the
``CoordinationStore`` API, the ``self._lock`` naming idiom, well-known
attribute names like ``ctx.store``) and extracts, per function:

  * which locks are held at every call site (``with`` nesting plus bare
    ``.acquire()``/``.release()`` pairs),
  * every call with a best-effort receiver type (assignment inference,
    parameter annotations, well-known-name hints),
  * the ordered stream of store mutations, ``flush_events`` barriers and
    ``self.<attr>`` reads/writes that PD-L004 replays,
  * subscriber callbacks registered via ``store.subscribe``.

Everything here is pure stdlib ``ast`` — no imports of the analyzed code.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# --------------------------------------------------------------- findings


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured lint finding (``file:line:col`` + rule id + hint)."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    hint: str = ""

    def format(self) -> str:
        out = f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


_DIRECTIVE_RE = re.compile(r"#\s*pdlint:\s*disable=([A-Za-z0-9_\-, ]+)")


def parse_suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """``# pdlint: disable=PD-Lxxx[,PD-Lyyy]`` directives by line number.

    A trailing directive suppresses its own line; a directive on a line
    that is *only* a comment also suppresses the next source line."""
    out: Dict[int, Set[str]] = {}
    pending: Set[str] = set()
    for lineno, raw in enumerate(lines, start=1):
        stripped = raw.strip()
        rules: Set[str] = set()
        m = _DIRECTIVE_RE.search(raw)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if pending and not stripped.startswith("#"):
            out.setdefault(lineno, set()).update(pending)
            pending = set()
        if rules:
            out.setdefault(lineno, set()).update(rules)
            if stripped.startswith("#"):
                pending |= rules
    return out


# ----------------------------------------------------------- type tagging
#
# Tags are either primitive ("lock", "rlock", "condition", "event",
# "queue", "semaphore", "thread", "file", "deque") or a project class
# name.  LOCK_TAGS are the mutex-like ones that participate in held-lock
# tracking and the PD-L005 graph.

LOCK_TAGS = {"lock", "rlock", "condition"}
NONLOCK_TAGS = {"event", "queue", "semaphore", "thread", "file", "deque"}

_FACTORY_TAGS: Dict[Tuple[str, str], str] = {
    ("threading", "Lock"): "lock",
    ("threading", "RLock"): "rlock",
    ("threading", "Condition"): "condition",
    ("threading", "Event"): "event",
    ("threading", "Semaphore"): "semaphore",
    ("threading", "BoundedSemaphore"): "semaphore",
    ("threading", "Thread"): "thread",
    ("queue", "Queue"): "queue",
    ("queue", "SimpleQueue"): "queue",
    ("queue", "LifoQueue"): "queue",
    ("queue", "PriorityQueue"): "queue",
    ("collections", "deque"): "deque",
}

_BARE_FACTORY_TAGS = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "Event": "event",
    "open": "file",
}

#: well-known attribute / variable names → project class, used when
#: assignment inference fails (repo convention, cf. RuntimeContext wiring)
TYPE_HINTS: Dict[str, str] = {
    "store": "CoordinationStore",
    "_store": "CoordinationStore",
    "ctx": "RuntimeContext",
    "_ctx": "RuntimeContext",
    "transfer_service": "TransferService",
    "tier_manager": "TierManager",
    "sh": "_Shard",
    "du": "DataUnit",
    "cu": "ComputeUnit",
    "pd": "PilotData",
    "sandbox": "PilotData",
    "pins": "PinRegistry",
}

#: name fragments that mark an *untyped* receiver as probably-a-mutex
_LOCKISH_NAME_RE = re.compile(r"(^|_)(lock|mutex|mu)$|_cond$|^cond$")


# ----------------------------------------------------------------- facts


@dataclasses.dataclass(frozen=True)
class LockRef:
    """A canonical lock identity: ``Class.attr`` / ``module.var``."""

    name: str
    text: str
    tag: Optional[str]
    line: int


@dataclasses.dataclass
class CallFact:
    line: int
    col: int
    func_name: str
    recv_text: Optional[str]
    recv_tag: Optional[str]
    held: Tuple[LockRef, ...]
    node: ast.Call
    in_loop: bool


@dataclasses.dataclass
class AcqFact:
    lock: LockRef
    line: int
    col: int
    held: Tuple[LockRef, ...]
    manual: bool
    in_loop: bool


class FunctionFacts:
    """Everything the rules need to know about one function/method."""

    def __init__(
        self,
        qualname: str,
        name: str,
        cls: Optional[str],
        node: ast.AST,
        module: "ModuleModel",
    ):
        self.qualname = qualname
        self.name = name
        self.cls = cls
        self.node = node
        self.module = module
        self.calls: List[CallFact] = []
        self.acquires: List[AcqFact] = []
        #: ordered stream: ("call", CallFact) | ("read"|"write", attr, line)
        self.events: List[tuple] = []
        self.attr_writes: Set[str] = set()
        self.local_funcs: Dict[str, "FunctionFacts"] = {}
        #: names acquired in a loop without a paired release in that loop
        self.loop_acquires: List[AcqFact] = []
        # ---- project-phase results
        self.is_subscriber_cb = False
        self.blocking_reason: Optional[str] = None
        self.publishes = False
        self.mutate_chain: Optional[str] = None
        #: derived attrs this function reads before any flush barrier
        self.exposed_reads: Set[str] = set()
        self.acq_closure: Set[str] = set()


class ClassModel:
    def __init__(self, name: str, node: ast.ClassDef, module: "ModuleModel"):
        self.name = name
        self.node = node
        self.module = module
        self.attr_tags: Dict[str, str] = {}
        #: condition attr -> underlying lock attr (Condition(self._x))
        self.cond_underlying: Dict[str, str] = {}
        self.methods: Dict[str, FunctionFacts] = {}
        self.derived_attrs: Set[str] = set()


class ModuleModel:
    def __init__(self, path: Path, source: str):
        self.path = path
        self.stem = path.stem
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self.suppress = parse_suppressions(self.lines)
        self.classes: Dict[str, ClassModel] = {}
        self.functions: Dict[str, FunctionFacts] = {}
        self.var_tags: Dict[str, str] = {}

    def suppressed(self, line: int, rule: str) -> bool:
        return rule in self.suppress.get(line, ())


# ------------------------------------------------------- expression utils


def _attr_chain(expr: ast.AST) -> Optional[List[str]]:
    """``self.ctx.store`` -> ["self", "ctx", "store"]; None if not a pure
    name/attribute chain."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return list(reversed(parts))
    return None


def _annotation_class(ann: Optional[ast.AST], classes: Set[str]) -> Optional[str]:
    """First project-class name mentioned in an annotation."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        for name in classes:
            if re.search(rf"\b{re.escape(name)}\b", ann.value):
                return name
        return None
    for node in ast.walk(ann):
        if isinstance(node, ast.Name) and node.id in classes:
            return node.id
    return None


def _is_literal_zero(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value in (0, 0.0)


def call_kwarg(node: ast.Call, name: str, pos: Optional[int] = None):
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    if pos is not None and len(node.args) > pos:
        return node.args[pos]
    return None


# ----------------------------------------------------------- the project


class Project:
    """All analyzed modules plus the cross-module indexes."""

    def __init__(self, modules: List[ModuleModel]):
        self.modules = modules
        self.class_index: Dict[str, ClassModel] = {}
        for mod in modules:
            for cls in mod.classes.values():
                self.class_index.setdefault(cls.name, cls)
        #: classes that implement the store API (hset + push + pop_any)
        self.store_classes: Set[str] = set()
        self.errors: List[str] = []

    @property
    def store_names(self) -> Set[str]:
        return self.store_classes | {"CoordinationStore"}

    def module_for(self, path: str) -> Optional[ModuleModel]:
        for mod in self.modules:
            if str(mod.path) == path:
                return mod
        return None

    def all_functions(self) -> Iterable[FunctionFacts]:
        for mod in self.modules:
            yield from mod.functions.values()

    def resolve_call(
        self, fact: CallFact, caller: FunctionFacts
    ) -> Optional[FunctionFacts]:
        """Best-effort static call target, or None."""
        if fact.recv_text is None:
            fn = caller.local_funcs.get(fact.func_name)
            if fn is not None:
                return fn
            return caller.module.functions.get(fact.func_name)
        if fact.recv_text == "self" and caller.cls:
            cls = caller.module.classes.get(caller.cls)
            if cls is not None:
                return cls.methods.get(fact.func_name)
            return None
        if fact.recv_tag and fact.recv_tag in self.class_index:
            return self.class_index[fact.recv_tag].methods.get(fact.func_name)
        return None


def _collect_class_attrs(mod: ModuleModel, classes: Set[str]) -> None:
    """Sweep B: per-class ``self.X = <factory>()`` attribute tags and
    module-level lock variables."""
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                tag = _value_tag(node.value, classes)
                if tag:
                    mod.var_tags[tgt.id] = tag
    for cls in mod.classes.values():
        for sub in ast.walk(cls.node):
            if isinstance(sub, ast.ClassDef) and sub is not cls.node:
                continue
            if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                continue
            targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
            value = sub.value
            if value is None:
                continue
            for tgt in targets:
                chain = _attr_chain(tgt)
                if chain is None or len(chain) != 2 or chain[0] != "self":
                    continue
                attr = chain[1]
                tag = _value_tag(value, classes)
                if tag and attr not in cls.attr_tags:
                    cls.attr_tags[attr] = tag
                if tag == "condition" and isinstance(value, ast.Call) and value.args:
                    inner = _attr_chain(value.args[0])
                    if inner and len(inner) == 2 and inner[0] == "self":
                        cls.cond_underlying[attr] = inner[1]


def _value_tag(value: ast.AST, classes: Set[str]) -> Optional[str]:
    """Tag for an assigned value: factory call, project-class ctor, file."""
    if not isinstance(value, ast.Call):
        return None
    func = value.func
    if isinstance(func, ast.Name):
        if func.id in classes:
            return func.id
        if func.id == "_make_lock":
            kw = call_kwarg(value, "reentrant")
            if kw is not None and isinstance(kw, ast.Constant) and kw.value:
                return "rlock"
            return "lock"
        return _BARE_FACTORY_TAGS.get(func.id)
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        if func.attr in classes:
            return func.attr
        return _FACTORY_TAGS.get((func.value.id, func.attr))
    return None


#: container-mutation method names: ``self.x.pop(...)`` is a write, not a
#: read, for PD-L004 purposes
_MUTATING_METHODS = {
    "pop",
    "popleft",
    "append",
    "appendleft",
    "add",
    "discard",
    "remove",
    "update",
    "clear",
    "setdefault",
    "extend",
    "insert",
}


class _FnScanner:
    """One pass over a function body, source order, tracking held locks."""

    def __init__(
        self,
        project_classes: Set[str],
        mod: ModuleModel,
        cls: Optional[str],
        facts: FunctionFacts,
        pending: List[Tuple[ast.AST, Optional[str], str]],
    ):
        self.classes = project_classes
        self.mod = mod
        self.cls = cls
        self.facts = facts
        self.pending = pending
        self.locals: Dict[str, str] = {}
        self.held: List[LockRef] = []
        self.manual: List[LockRef] = []
        self.loop_depth = 0
        self.loop_acq: List[List[AcqFact]] = []
        self.loop_rel: List[Set[str]] = []
        node = facts.node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = list(node.args.posonlyargs) + list(node.args.args)
            for a in args:
                t = _annotation_class(a.annotation, project_classes)
                if t:
                    self.locals[a.arg] = t

    # ------------------------------------------------------------- typing
    def _expr_tag(self, expr: ast.AST) -> Optional[str]:
        chain = _attr_chain(expr)
        if chain is not None:
            return self._chain_tag(chain)
        if isinstance(expr, ast.Call):
            tag = _value_tag(expr, self.classes)
            if tag:
                return tag
            func = expr.func
            if isinstance(func, ast.Attribute):
                base = self._expr_tag(func.value)
                target = None
                if base and base in self.classes:
                    cls = self._class_model(base)
                    if cls is not None:
                        target = cls.methods.get(func.attr)
                if target is not None and isinstance(
                    target.node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    return _annotation_class(target.node.returns, self.classes)
        return None

    def _class_model(self, name: str) -> Optional[ClassModel]:
        cls = self.mod.classes.get(name)
        if cls is not None:
            return cls
        return _PROJECT_CLASS_INDEX.get(name)

    def _chain_tag(self, chain: List[str]) -> Optional[str]:
        head, rest = chain[0], chain[1:]
        if head == "self" and self.cls:
            cur: Optional[str] = self.cls
        else:
            cur = (
                self.locals.get(head)
                or self.mod.var_tags.get(head)
                or (head if head in self.classes else None)
                or TYPE_HINTS.get(head)
            )
        for attr in rest:
            nxt: Optional[str] = None
            if cur and cur in self.classes:
                cls = self._class_model(cur)
                if cls is not None:
                    nxt = cls.attr_tags.get(attr)
            if nxt is None:
                nxt = TYPE_HINTS.get(attr)
            cur = nxt
            if cur is None:
                return TYPE_HINTS.get(chain[-1]) if attr != chain[-1] else None
        return cur

    def _lock_ref(self, expr: ast.AST) -> Optional[LockRef]:
        chain = _attr_chain(expr)
        if chain is None:
            return None
        tag = self._chain_tag(chain)
        if tag in NONLOCK_TAGS:
            return None
        lockish = tag in LOCK_TAGS or (
            tag is None and _LOCKISH_NAME_RE.search(chain[-1]) is not None
        )
        if not lockish:
            return None
        name = self._canonical(chain)
        text = ".".join(chain)
        return LockRef(name=name, text=text, tag=tag, line=getattr(expr, "lineno", 0))

    def _canonical(self, chain: List[str]) -> str:
        attr = chain[-1]
        if len(chain) == 1:
            return f"{self.mod.stem}.{attr}"
        owner: Optional[str] = None
        if chain[0] == "self" and len(chain) == 2 and self.cls:
            owner = self.cls
        else:
            owner_chain = chain[:-1]
            owner = self._chain_tag(owner_chain)
        if owner and owner in self.classes:
            cls = self._class_model(owner)
            if cls is not None:
                attr = cls.cond_underlying.get(attr, attr)
            return f"{owner}.{attr}"
        return f"{self.mod.stem}:{'.'.join(chain)}"

    # ------------------------------------------------------------ walking
    def scan(self) -> None:
        for stmt in self.facts.node.body:
            self._stmt(stmt)

    def _stmts(self, stmts: Sequence[ast.stmt]) -> None:
        for s in stmts:
            self._stmt(s)

    def _stmt(self, s: ast.stmt) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.pending.append((s, self.cls, f"{self.facts.qualname}.<locals>"))
            self.facts.local_funcs[s.name] = None  # patched by builder
            return
        if isinstance(s, ast.ClassDef):
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            self._with(s)
            return
        if isinstance(s, ast.Assign):
            self._expr(s.value)
            self._infer_assign(s)
            for tgt in s.targets:
                self._target(tgt)
            return
        if isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self._expr(s.value)
                if isinstance(s.target, ast.Name):
                    tag = self._expr_tag(s.value) or _annotation_class(
                        s.annotation, self.classes
                    )
                    if tag:
                        self.locals[s.target.id] = tag
            elif isinstance(s.target, ast.Name):
                tag = _annotation_class(s.annotation, self.classes)
                if tag:
                    self.locals[s.target.id] = tag
            self._target(s.target)
            return
        if isinstance(s, ast.AugAssign):
            self._expr(s.value)
            self._target(s.target, aug=True)
            return
        if isinstance(s, ast.Delete):
            for tgt in s.targets:
                self._target(tgt)
            return
        if isinstance(s, (ast.For, ast.AsyncFor)):
            self._expr(s.iter)
            self._loop(s.body)
            self._stmts(s.orelse)
            return
        if isinstance(s, ast.While):
            self._expr(s.test)
            self._loop(s.body)
            self._stmts(s.orelse)
            return
        if isinstance(s, ast.If):
            self._expr(s.test)
            self._stmts(s.body)
            self._stmts(s.orelse)
            return
        if isinstance(s, ast.Try):
            self._stmts(s.body)
            for h in s.handlers:
                self._stmts(h.body)
            self._stmts(s.orelse)
            self._stmts(s.finalbody)
            return
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _loop(self, body: Sequence[ast.stmt]) -> None:
        self.loop_depth += 1
        self.loop_acq.append([])
        self.loop_rel.append(set())
        self._stmts(body)
        acqs = self.loop_acq.pop()
        rels = self.loop_rel.pop()
        self.loop_depth -= 1
        for acq in acqs:
            if acq.lock.name not in rels:
                self.facts.loop_acquires.append(acq)

    def _with(self, s: ast.With) -> None:
        pushed = 0
        for item in s.items:
            ref = self._lock_ref(item.context_expr)
            if ref is not None:
                self.facts.acquires.append(
                    AcqFact(
                        lock=ref,
                        line=item.context_expr.lineno,
                        col=item.context_expr.col_offset,
                        held=tuple(self.held + self.manual),
                        manual=False,
                        in_loop=self.loop_depth > 0,
                    )
                )
                self.held.append(ref)
                pushed += 1
            else:
                self._expr(item.context_expr)
                if (
                    isinstance(item.context_expr, ast.Call)
                    and isinstance(item.context_expr.func, ast.Name)
                    and item.context_expr.func.id == "open"
                    and isinstance(item.optional_vars, ast.Name)
                ):
                    self.locals[item.optional_vars.id] = "file"
        self._stmts(s.body)
        for _ in range(pushed):
            self.held.pop()

    def _infer_assign(self, s: ast.Assign) -> None:
        if len(s.targets) != 1 or not isinstance(s.targets[0], ast.Name):
            return
        tag = self._expr_tag(s.value)
        if tag:
            self.locals[s.targets[0].id] = tag

    def _target(self, tgt: ast.AST, aug: bool = False) -> None:
        """Record ``self.<attr>`` writes in assignment targets."""
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._target(el, aug=aug)
            return
        base = tgt
        while isinstance(base, ast.Subscript):
            self._expr(base.slice)
            base = base.value
        chain = _attr_chain(base)
        if chain and len(chain) == 2 and chain[0] == "self":
            self.facts.attr_writes.add(chain[1])
            self.facts.events.append(("write", chain[1], tgt.lineno))
            if aug:
                self.facts.events.append(("read", chain[1], tgt.lineno))
        elif not isinstance(tgt, ast.Name):
            self._expr_children(base)

    def _expr(self, e: ast.AST) -> None:
        if isinstance(e, ast.Call):
            self._call(e)
            return
        if isinstance(e, ast.Attribute):
            chain = _attr_chain(e)
            if chain and len(chain) == 2 and chain[0] == "self":
                self.facts.events.append(("read", chain[1], e.lineno))
                return
            self._expr_children(e)
            return
        if isinstance(e, ast.Lambda):
            return
        self._expr_children(e)

    def _expr_children(self, e: ast.AST) -> None:
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self._expr(child)
            elif isinstance(child, ast.comprehension):
                self._expr(child.iter)
                for cond in child.ifs:
                    self._expr(cond)

    def _call(self, e: ast.Call) -> None:
        func = e.func
        recv_text: Optional[str] = None
        recv_tag: Optional[str] = None
        if isinstance(func, ast.Attribute):
            name = func.attr
            chain = _attr_chain(func.value)
            recv_text = ".".join(chain) if chain else "<expr>"
            recv_tag = self._expr_tag(func.value) if chain else None
            # acquire()/release() on a mutex: held-set bookkeeping, and the
            # PD-L005 self-edge check for loops (e.g. _lock_all)
            lock = (
                self._lock_ref(func.value)
                if name in ("acquire", "release")
                else None
            )
            if lock is not None:
                if name == "acquire":
                    acq = AcqFact(
                        lock=lock,
                        line=e.lineno,
                        col=e.col_offset,
                        held=tuple(self.held + self.manual),
                        manual=True,
                        in_loop=self.loop_depth > 0,
                    )
                    self.facts.acquires.append(acq)
                    if self.loop_depth:
                        self.loop_acq[-1].append(acq)
                    if all(r.name != lock.name for r in self.manual):
                        self.manual.append(lock)
                else:
                    if self.loop_depth:
                        self.loop_rel[-1].add(lock.name)
                    self.manual = [r for r in self.manual if r.name != lock.name]
                for arg in e.args:
                    self._expr(arg)
                return
            # receiver subtree: count self-attr loads unless this call
            # mutates the container (then it is a write for PD-L004)
            if chain and len(chain) == 2 and chain[0] == "self":
                if name in _MUTATING_METHODS:
                    self.facts.attr_writes.add(chain[1])
                    self.facts.events.append(("write", chain[1], e.lineno))
                else:
                    self.facts.events.append(("read", chain[1], e.lineno))
            else:
                self._expr(func.value)
        elif isinstance(func, ast.Name):
            name = func.id
        else:
            self._expr(func)
            name = "<dynamic>"
        fact = CallFact(
            line=e.lineno,
            col=e.col_offset,
            func_name=name,
            recv_text=recv_text,
            recv_tag=recv_tag,
            held=tuple(self.held + self.manual),
            node=e,
            in_loop=self.loop_depth > 0,
        )
        self.facts.calls.append(fact)
        self.facts.events.append(("call", fact))
        for arg in e.args:
            self._expr(arg)
        for kw in e.keywords:
            self._expr(kw.value)


# a scanner-visible mirror of Project.class_index (set during build so
# cross-module attr tags resolve without threading the project everywhere)
_PROJECT_CLASS_INDEX: Dict[str, ClassModel] = {}


def build_project(paths: Sequence[Path]) -> Project:
    """Parse every ``.py`` under ``paths`` and build the full fact base."""
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    modules: List[ModuleModel] = []
    errors: List[str] = []
    for f in files:
        try:
            modules.append(ModuleModel(f, f.read_text(encoding="utf-8")))
        except (OSError, SyntaxError) as exc:
            errors.append(f"{f}: {exc}")
    # sweep A: class registry
    for mod in modules:
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                mod.classes[node.name] = ClassModel(node.name, node, mod)
    project = Project(modules)
    project.errors = errors
    _PROJECT_CLASS_INDEX.clear()
    _PROJECT_CLASS_INDEX.update(project.class_index)
    class_names = set(project.class_index)
    # sweep B: attribute tags
    for mod in modules:
        _collect_class_attrs(mod, class_names)
    # sweep C: function facts (methods, module functions, nested closures)
    for mod in modules:
        pending: List[Tuple[ast.AST, Optional[str], str]] = []
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                pending.append((node, None, ""))
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        pending.append((sub, node.name, node.name))
        while pending:
            node, cls, prefix = pending.pop(0)
            qual = f"{prefix}.{node.name}" if prefix else node.name
            facts = FunctionFacts(qual, node.name, cls, node, mod)
            scanner = _FnScanner(class_names, mod, cls, facts, pending)
            scanner.scan()
            mod.functions[qual] = facts
            if cls and prefix == cls:
                mod.classes[cls].methods[node.name] = facts
        # patch local_funcs placeholders with the built facts
        for facts in mod.functions.values():
            for lname in list(facts.local_funcs):
                child = mod.functions.get(f"{facts.qualname}.<locals>.{lname}")
                if child is not None:
                    facts.local_funcs[lname] = child
                else:
                    del facts.local_funcs[lname]
    # store-API classes
    for name, cls in project.class_index.items():
        if {"hset", "push", "pop_any"} <= set(cls.methods):
            project.store_classes.add(name)
    _mark_subscribers(project)
    _fixpoint_phases(project)
    return project


# ----------------------------------------------------- project-wide phases

#: CoordinationStore public ops
STORE_MUTATORS = {
    "set",
    "delete",
    "hset",
    "hdel",
    "hcas",
    "push",
    "pop",
    "pop_any",
    "qremove",
    "restore",
}
STORE_PUBLISHING = {"hset", "hcas", "push"}
STORE_READS = {"get", "keys", "hget", "hgetall", "hkeys", "qlen", "qpeek", "snapshot"}
STORE_BLOCKING = {"flush_events", "wait_field", "flush_wal", "close"}
#: store ops that never propagate a blocking taint to callers: they are
#: bounded (group-commit amortizes WAL flushes); the PD-L002 contract
#: tracks *unbounded* waits (sleeps, joins, transfers, barriers)
STORE_SAFE = STORE_MUTATORS | STORE_READS | {"subscribe", "unsubscribe", "fail_for"}
TRANSFER_BLOCKING = {
    "stage_in",
    "stage_in_bulk",
    "heal_replica",
    "replicate",
    "replicate_chunks",
    "ingest",
    "prefetch_inputs",
}


def is_store_recv(project: Project, fact: CallFact) -> bool:
    if fact.recv_tag in project.store_names:
        return True
    return fact.recv_text is not None and (
        fact.recv_text == "store"
        or fact.recv_text.endswith(".store")
        or fact.recv_text.endswith("._store")
    )


def leaf_blocking(project: Project, fact: CallFact) -> Optional[Tuple[str, bool]]:
    """(reason, idiom_exempt) when the call itself blocks, else None.

    ``idiom_exempt`` marks ``cond.wait()`` under ``with cond`` — correct
    usage at the site, but the enclosing function still blocks."""
    name, tag, recv = fact.func_name, fact.recv_tag, fact.recv_text
    if name == "sleep" and recv in (None, "time"):
        return ("time.sleep", False)
    if name == "sleep_sim":
        return ("ctx.sleep_sim (simulated wait)", False)
    if name == "open" and recv is None:
        return ("file open", False)
    if name == "with_retry" and recv is None:
        return ("with_retry backoff sleeps", False)
    if tag == "thread" and name == "join":
        return ("Thread.join", False)
    if tag == "event" and name == "wait":
        return ("Event.wait", False)
    if tag == "condition" and name in ("wait", "wait_for"):
        exempt = any(h.text == recv or h.name.endswith(recv or "") for h in fact.held)
        return ("Condition.wait", exempt)
    if tag == "queue" and name == "get":
        block = call_kwarg(fact.node, "block", 0)
        if block is not None and isinstance(block, ast.Constant) and not block.value:
            return None
        return ("queue.get", False)
    if tag == "semaphore" and name == "acquire":
        return ("Semaphore.acquire", False)
    if tag == "file" and name in ("write", "flush", "read", "readline"):
        return ("file I/O", False)
    if is_store_recv(project, fact):
        if name in ("pop", "pop_any"):
            timeout = call_kwarg(fact.node, "timeout", 1)
            if timeout is not None and not _is_literal_zero(timeout):
                return (f"store.{name} with a timeout", False)
            return None
        if name in STORE_BLOCKING:
            return (f"store.{name}", False)
    if name in TRANSFER_BLOCKING and (
        fact.recv_tag == "TransferService"
        or (recv is not None and recv.endswith("transfer_service"))
    ):
        return (f"transfer_service.{name} (striped transfer)", False)
    return None


def _mark_subscribers(project: Project) -> None:
    for fn in list(project.all_functions()):
        for fact in fn.calls:
            if fact.func_name != "subscribe" or not fact.node.args:
                continue
            if not (is_store_recv(project, fact) or fact.recv_text == "self"):
                continue
            cb = fact.node.args[0]
            target: Optional[FunctionFacts] = None
            chain = _attr_chain(cb)
            if chain and len(chain) == 2 and chain[0] == "self" and fn.cls:
                cls = fn.module.classes.get(fn.cls)
                if cls is not None:
                    target = cls.methods.get(chain[1])
            elif isinstance(cb, ast.Name):
                target = fn.local_funcs.get(cb.id) or fn.module.functions.get(cb.id)
            if target is not None:
                target.is_subscriber_cb = True


def _fixpoint_phases(project: Project) -> None:
    """Iterate blocking / publishes / exposed-reads / lock closures to a
    fixpoint over the resolvable call graph."""
    # derived attrs: written by subscriber callbacks, minus handoff
    # primitives (queues) and synchronization objects
    for mod in project.modules:
        for cls in mod.classes.values():
            derived: Set[str] = set()
            for m in cls.methods.values():
                if m.is_subscriber_cb:
                    derived |= m.attr_writes
            cls.derived_attrs = {
                a
                for a in derived
                if cls.attr_tags.get(a) not in (NONLOCK_TAGS | LOCK_TAGS)
            }
    fns = list(project.all_functions())
    for fn in fns:
        for fact in fn.calls:
            leaf = leaf_blocking(project, fact)
            if leaf and fn.blocking_reason is None:
                fn.blocking_reason = leaf[0]
            if (
                is_store_recv(project, fact)
                and fact.func_name in STORE_PUBLISHING
                and not fn.publishes
            ):
                fn.publishes = True
                fn.mutate_chain = f"store.{fact.func_name}"
        for acq in fn.acquires:
            fn.acq_closure.add(acq.lock.name)
    changed = True
    while changed:
        changed = False
        for fn in fns:
            for fact in fn.calls:
                safe_store = (
                    is_store_recv(project, fact) and fact.func_name in STORE_SAFE
                )
                callee = project.resolve_call(fact, fn)
                if callee is None:
                    continue
                if (
                    not safe_store
                    and callee.blocking_reason
                    and fn.blocking_reason is None
                ):
                    fn.blocking_reason = (
                        f"{callee.qualname}() → {callee.blocking_reason}"
                    )
                    changed = True
                if callee.publishes and not fn.publishes and not safe_store:
                    fn.publishes = True
                    fn.mutate_chain = f"{callee.qualname}() → {callee.mutate_chain}"
                    changed = True
                if not callee.acq_closure <= fn.acq_closure:
                    fn.acq_closure |= callee.acq_closure
                    changed = True
        # exposed derived reads (before any flush barrier, in call order)
        for fn in fns:
            exposed = _exposed_reads(project, fn)
            if exposed != fn.exposed_reads:
                fn.exposed_reads = exposed
                changed = True


def _is_flush_call(project: Project, fact: CallFact) -> bool:
    return fact.func_name == "flush_events" and (
        is_store_recv(project, fact) or fact.recv_text == "self"
    )


def _exposed_reads(project: Project, fn: FunctionFacts) -> Set[str]:
    derived: Set[str] = set()
    if fn.cls:
        cls = fn.module.classes.get(fn.cls)
        if cls is not None:
            derived = cls.derived_attrs
    out: Set[str] = set()
    for ev in fn.events:
        if ev[0] == "read" and ev[1] in derived:
            out.add(ev[1])
        elif ev[0] == "call":
            fact = ev[1]
            if _is_flush_call(project, fact):
                break
            callee = project.resolve_call(fact, fn)
            if callee is not None and callee is not fn:
                out |= callee.exposed_reads
    return out

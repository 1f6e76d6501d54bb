"""Whole-program static concurrency analyzer for ray_tpu_torch (RTL6xx).

``protocheck`` recovers the wire protocol; this tool recovers the LOCK
GRAPH: every lock creation site, every ``with <lock>:`` region, an
interprocedural call graph (self-method resolution, attribute-typed
receivers, module functions across import aliases, constructor calls,
``Thread(target=...)`` / executor-submit / callback spawn edges), and
the static lock-nesting graph — lock A's with-body transitively
reaching an acquisition of lock B is an edge A -> B, whether or not any
test schedule ever executes the path.  Kernel lockdep's trick, done at
review time: the runtime lockcheck (``ray_tpu_torch.devtools.lockcheck``)
only certifies schedules the suite actually executes; this tool
certifies every path the source contains.

Usage::

    python -m ray_tpu_torch.devtools.lockgraph ray_tpu_torch/
    python -m ray_tpu_torch.devtools.lockgraph --doc          # LOCK ORDER table
    python -m ray_tpu_torch.devtools.lockgraph --dump ray_tpu_torch/  # inventory
    python -m ray_tpu_torch.devtools.lockgraph --select=RTL601 ray_tpu_torch/

Annotation grammar (ONE mechanism shared by lint.py RTL402, protocheck
RTL505, this tool, and the runtime lockcheck's leaf registry) — on, or
one line above, a lock CREATION/BINDING site::

    # lock-order: leaf [-- note]
    # lock-order: io-guard [-- note]

``leaf``: the lock is a documented independent leaf — its holder
acquires nothing and signals nothing; anyone may nest INTO it.
``io-guard``: the lock exists to serialize a blocking channel (a socket
write, a snapshot file) and holding it across that IO is the design —
lint's RTL402 and this tool's RTL604 skip io-guard bodies (the guarded
IO is still flagged when reached while some OTHER lock is held).

Spawned/deferred callees (``Thread(target=...)``, ``executor.submit``,
``call_soon*``, ``add_done_callback``) run on another thread or at a
later time: they appear in the call graph for ``--dump`` but do NOT
propagate held locks — each spawned function is analyzed as its own
region root.

Rule catalog
============

RTL600  reasonless-suppression
    A ``# noqa: RTL6xx`` without a ``-- reason`` tail.  Lock-graph
    suppressions document a concurrency-contract exception; the reason
    is the documentation.

RTL601  static-lock-cycle
    A cycle in the static lock-nesting graph: two (or more) code paths
    acquire the same lock classes in opposite orders.  A potential
    deadlock even if no test schedule has ever interleaved them — the
    whole point of checking statically.

RTL602  leaf-grew-an-edge
    A lock annotated ``# lock-order: leaf`` whose with-body reaches
    (lexically or through calls) the acquisition of another lock.
    Leaves must acquire nothing; that contract is what makes nesting
    INTO them safe from every caller.

RTL603  signal-under-leaf
    ``Event.set()`` / ``Condition.notify()`` / ``notify_all()``
    lexically-or-transitively inside an annotated leaf body.  Waking a
    waiter while holding the leaf hands it a lock it may immediately
    contend on (and Event.set itself takes the event's internal lock —
    an edge out of the leaf).  Fire signals after releasing the leaf —
    the convention every PR has pinned by hand until now.

RTL604  blocking-io-reachable-under-lock
    Interprocedural RTL402: blocking socket IO (``protocol.send/recv``,
    ``*.send_bytes/recv_bytes``, sockish ``.send/.recv``) or a payload
    (un)pickle (``pickle.dumps/loads``, ``serialization.dumps*/
    loads*``) reachable THROUGH CALLS from a ``with <lock>:`` body —
    not just lexically inside it (that is RTL402's job and stays in
    lint.py).  io-guard locks are exempt: serializing that IO is what
    they are for.

Resolution is a lexical heuristic: receivers reached through
function-valued variables, dict dispatch, or untyped parameters are not
seen.  The runtime lockcheck covers the residue for executed schedules
— and the static edge set is asserted (in tests) to be a superset of
every edge the runtime checker observes across the suite.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.lint import Finding, _attr_chain, _iter_py_files

RULES: Dict[str, str] = {
    "RTL600": "lockgraph suppression without a '-- reason' tail",
    "RTL601": "cycle in the static lock-nesting graph (potential "
              "deadlock on a never-executed path)",
    "RTL602": "a '# lock-order: leaf' lock's body reaches another "
              "acquisition — leaves must acquire nothing",
    "RTL603": "Event.set/Condition.notify reached while holding a "
              "declared leaf lock",
    "RTL604": "blocking socket IO or payload (un)pickling reachable "
              "through calls from a lock body (interprocedural RTL402)",
}

LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore"}
EVENT_FACTORIES = {"Event", "Condition"}
_LOCKISH_RE = re.compile(r"lock|cond|(^|_)cv$|(^|_)sem($|_)")
_SOCKISH_RE = re.compile(r"conn|sock|agent|worker|lessee|peer|client")
_ANNOT_RE = re.compile(
    r"#\s*lock-order:\s*(?P<kind>leaf|io-guard)\b"
    r"(?:\s*--\s*(?P<note>.*))?")
_NOQA_RE = re.compile(r"#\s*noqa:\s*([A-Z0-9, ]+)(--\s*(.*))?")
_SIGNAL_METHODS = {"set", "notify", "notify_all"}
_SPAWN_CALLEES = {"submit", "call_soon", "call_soon_threadsafe",
                  "add_done_callback", "run_in_executor"}

# Lock identity: (module path, class name or None, attr/name).  The
# creation line rides along so static locks map onto the runtime
# lockcheck's ``file:line`` lock classes.
LockKey = Tuple[str, Optional[str], str]


class _LockDef:
    __slots__ = ("key", "line", "kind", "note", "factory", "forwarded")

    def __init__(self, key: LockKey, line: int, kind: Optional[str],
                 note: str, factory: str, forwarded: bool = False):
        self.key = key
        self.line = line          # creation/binding line in key[0]
        self.kind = kind          # None | 'leaf' | 'io-guard'
        self.note = note
        self.factory = factory    # 'Lock' | 'RLock' | ... | 'param'
        # True when bound from a constructor parameter (`self.x = x`):
        # the real creation site is the caller's — excluded from the
        # runtime site mapping but still a graph node.
        self.forwarded = forwarded


class _Cls:
    __slots__ = ("module", "name", "node", "bases", "methods", "locks",
                 "events", "attr_types", "cond_alias")

    def __init__(self, module: "_Module", name: str, node: ast.ClassDef,
                 bases: Tuple[str, ...]):
        self.module = module
        self.name = name
        self.node = node
        self.bases = bases
        self.methods: Dict[str, ast.AST] = {}
        self.locks: Dict[str, _LockDef] = {}
        self.events: Dict[str, str] = {}     # attr -> 'Event'|'Condition'
        self.attr_types: Dict[str, str] = {}  # self.x = ClassName(...)
        # self.cv = threading.Condition(self.lock): cv IS self.lock.
        self.cond_alias: Dict[str, str] = {}


class _Fn:
    __slots__ = ("module", "cls", "name", "node", "parent", "children")

    def __init__(self, module: "_Module", cls: Optional[_Cls], name: str,
                 node: ast.AST, parent: Optional["_Fn"]):
        self.module = module
        self.cls = cls
        self.name = name
        self.node = node
        self.parent = parent
        self.children: Dict[str, "_Fn"] = {}

    @property
    def qual(self) -> str:
        base = os.path.splitext(os.path.basename(self.module.path))[0]
        mid = f"{self.cls.name}." if self.cls is not None else ""
        return f"{base}.{mid}{self.name}"


class _Module:
    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        base = os.path.basename(path)
        self.is_test = (base.startswith("test_")
                        or (os.sep + "tests" + os.sep) in path)
        self.classes: List[_Cls] = []
        self.fns: List[_Fn] = []
        self.module_locks: Dict[str, _LockDef] = {}
        self.module_events: Dict[str, str] = {}
        self.import_aliases: Dict[str, str] = {}  # alias -> basename.py

    def annotation(self, lineno: int) -> Tuple[Optional[str], str]:
        """('leaf'|'io-guard'|None, note) on the line or the one above."""
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(self.lines):
                m = _ANNOT_RE.search(self.lines[ln - 1])
                if m:
                    return m.group("kind"), (m.group("note") or "").strip()
        return None, ""


def _is_factory(value: ast.AST, names: Set[str]) -> Optional[str]:
    if not isinstance(value, ast.Call):
        return None
    chain = _attr_chain(value.func)
    if chain and chain[-1] in names:
        return chain[-1]
    return None


# ---------------------------------------------------------------- parse --

class _Extractor(ast.NodeVisitor):
    """Pass 1, per module: classes, methods, lock/event attrs, attr
    types, import aliases.  No cross-module resolution yet."""

    def __init__(self, mod: _Module):
        self.mod = mod
        self.cls_stack: List[_Cls] = []
        self.fn_stack: List[_Fn] = []

    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            local = alias.asname or alias.name.split(".")[0]
            self.mod.import_aliases[local] = \
                alias.name.split(".")[-1] + ".py"

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module and "ray_tpu_torch" in node.module:
            for alias in node.names:
                self.mod.import_aliases[alias.asname or alias.name] = \
                    alias.name + ".py"

    def visit_ClassDef(self, node: ast.ClassDef):
        bases = tuple(c[-1] for c in
                      (_attr_chain(b) for b in node.bases) if c)
        info = _Cls(self.mod, node.name, node, bases)
        self.mod.classes.append(info)
        self.cls_stack.append(info)
        try:
            self.generic_visit(node)
        finally:
            self.cls_stack.pop()

    def _visit_fn(self, node):
        cls = None
        if self.cls_stack and node in self.cls_stack[-1].node.body:
            cls = self.cls_stack[-1]
        parent = self.fn_stack[-1] if self.fn_stack else None
        fn = _Fn(self.mod, cls, node.name, node, parent)
        self.mod.fns.append(fn)
        if cls is not None:
            cls.methods[node.name] = node
        if parent is not None:
            parent.children[node.name] = fn
        self.fn_stack.append(fn)
        try:
            self.generic_visit(node)
        finally:
            self.fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _ctor_call(self, value: ast.AST) -> Optional[ast.Call]:
        """The Call node a binding ultimately takes its type from —
        through a conditional (`X(...) if flag else None`)."""
        if isinstance(value, ast.Call):
            return value
        if isinstance(value, ast.IfExp):
            return self._ctor_call(value.body) or \
                self._ctor_call(value.orelse)
        return None

    def visit_Assign(self, node: ast.Assign):
        for target in node.targets:
            chain = _attr_chain(target)
            if not chain:
                continue
            if len(chain) == 2 and chain[0] == "self" and self.cls_stack:
                self._self_assign(self.cls_stack[-1], chain[1], node)
            elif len(chain) == 1 and not self.fn_stack \
                    and not self.cls_stack:
                self._module_assign(chain[0], node)
        self.generic_visit(node)

    def _self_assign(self, cls: _Cls, attr: str, node: ast.Assign):
        kind, note = self.mod.annotation(node.lineno)
        factory = _is_factory(node.value, LOCK_FACTORIES)
        if factory == "Condition" and isinstance(node.value, ast.Call) \
                and node.value.args:
            inner = _attr_chain(node.value.args[0])
            if inner and len(inner) == 2 and inner[0] == "self":
                # Condition(self.X): acquiring the condition IS
                # acquiring X — alias, not a new lock.
                cls.cond_alias[attr] = inner[1]
                cls.events[attr] = "Condition"
                return
        if factory:
            cls.locks[attr] = _LockDef(
                (self.mod.path, cls.name, attr), node.lineno, kind,
                note, factory)
            if factory == "Condition":
                cls.events[attr] = "Condition"
            return
        efactory = _is_factory(node.value, EVENT_FACTORIES)
        if efactory:
            cls.events[attr] = efactory
            return
        # `self.x = x` from a lockish constructor parameter: a forwarded
        # lock (created by the caller).  The annotation still binds here
        # so per-file tools (lint RTL402) see it.
        if isinstance(node.value, ast.Name) \
                and _LOCKISH_RE.search(attr.lower()) \
                and attr not in cls.locks:
            cls.locks[attr] = _LockDef(
                (self.mod.path, cls.name, attr), node.lineno, kind,
                note, "param", forwarded=True)
            return
        call = self._ctor_call(node.value)
        if call is not None:
            cchain = _attr_chain(call.func)
            if cchain and cchain[-1][:1].isupper():
                cls.attr_types[attr] = cchain[-1]

    def _module_assign(self, name: str, node: ast.Assign):
        kind, note = self.mod.annotation(node.lineno)
        factory = _is_factory(node.value, LOCK_FACTORIES)
        if factory:
            self.mod.module_locks[name] = _LockDef(
                (self.mod.path, None, name), node.lineno, kind, note,
                factory)
            if factory == "Condition":
                self.mod.module_events[name] = "Condition"
            return
        efactory = _is_factory(node.value, EVENT_FACTORIES)
        if efactory:
            self.mod.module_events[name] = efactory


# ------------------------------------------------------------- analysis --

class _Facts:
    """Direct (intra-function) effects of one function, nested defs
    excluded — they run at call time."""
    __slots__ = ("acquires", "signals", "blocking", "calls", "spawns")

    def __init__(self):
        # [(LockKey, line)] — with-entries and .acquire() sites.
        self.acquires: List[Tuple[LockKey, int]] = []
        # [(receiver LockKey or None, descr, line)]
        self.signals: List[Tuple[Optional[LockKey], str, int]] = []
        # [(descr, line)]
        self.blocking: List[Tuple[str, int]] = []
        # [(callee _Fn, line)] — synchronous edges (propagate locks).
        self.calls: List[Tuple[_Fn, int]] = []
        # [(descr, callee _Fn or None, line)] — deferred, dump-only.
        self.spawns: List[Tuple[str, Optional[_Fn], int]] = []


class Analysis:
    def __init__(self, paths):
        self.modules: List[_Module] = []
        self.findings: List[Finding] = []
        for path in _iter_py_files(paths):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    source = f.read()
                tree = ast.parse(source, filename=path)
            except (OSError, SyntaxError):
                continue  # the lint gate owns syntax errors
            mod = _Module(path, source, tree)
            _Extractor(mod).visit(tree)
            self.modules.append(mod)
        self._build_registries()
        self._facts: Dict[int, _Facts] = {}
        self._fn_by_id: Dict[int, _Fn] = {}
        for mod in self.modules:
            for fn in mod.fns:
                self._fn_by_id[id(fn)] = fn
                self._facts[id(fn)] = self._extract_facts(fn)
        self._summaries = self._fixpoint_summaries()
        # (frm, to) -> (witness module path, line, path descr, to line)
        self.edges: Dict[Tuple[LockKey, LockKey],
                         Tuple[str, int, str, int]] = {}
        self._region_findings: List[Tuple] = []
        self._seen: Set[Tuple] = set()
        for mod in self.modules:
            for fn in mod.fns:
                self._analyze_regions(fn)

    # -- registries --------------------------------------------------------
    def _build_registries(self):
        self.cls_registry: Dict[str, _Cls] = {}
        ambiguous: Set[str] = set()
        for mod in self.modules:
            for cls in mod.classes:
                if cls.name in self.cls_registry:
                    ambiguous.add(cls.name)
                self.cls_registry[cls.name] = cls
        for name in ambiguous:
            self.cls_registry.pop(name, None)
        self.mod_by_base: Dict[str, _Module] = {}
        amb_mod: Set[str] = set()
        for mod in self.modules:
            base = os.path.basename(mod.path)
            if base in self.mod_by_base:
                amb_mod.add(base)
            self.mod_by_base[base] = mod
        for base in amb_mod:
            self.mod_by_base.pop(base, None)
        # Global event-attr name set (weak fallback for receivers whose
        # owner type is unresolvable).
        self.event_names: Set[str] = set()
        for mod in self.modules:
            self.event_names |= set(mod.module_events)
            for cls in mod.classes:
                self.event_names |= set(cls.events)
        self.locks: Dict[LockKey, _LockDef] = {}
        for mod in self.modules:
            for ld in mod.module_locks.values():
                self.locks[ld.key] = ld
            for cls in mod.classes:
                for ld in cls.locks.values():
                    self.locks[ld.key] = ld

    def _mro(self, cls: _Cls) -> List[_Cls]:
        out, seen = [cls], {cls.name}
        queue = list(cls.bases)
        while queue:
            b = queue.pop()
            if b in seen:
                continue
            seen.add(b)
            info = self.cls_registry.get(b)
            if info is not None:
                out.append(info)
                queue += list(info.bases)
        return out

    def _cls_lock(self, cls: _Cls, attr: str,
                  depth: int = 0) -> Optional[_LockDef]:
        if depth > 4:
            return None
        for c in self._mro(cls):
            if attr in c.cond_alias:
                return self._cls_lock(c, c.cond_alias[attr], depth + 1)
            if attr in c.locks:
                return c.locks[attr]
        return None

    # -- resolution --------------------------------------------------------
    def _resolve_lock(self, expr: ast.AST, fn: _Fn,
                      local_types: Dict[str, str]) -> Optional[_LockDef]:
        chain = _attr_chain(expr)
        if not chain:
            return None
        mod = fn.module
        if len(chain) == 1:
            return mod.module_locks.get(chain[0])
        if chain[0] == "self" and fn.cls is not None:
            if len(chain) == 2:
                return self._cls_lock(fn.cls, chain[1])
            if len(chain) == 3:
                tname = None
                for c in self._mro(fn.cls):
                    tname = c.attr_types.get(chain[1])
                    if tname:
                        break
                target = self.cls_registry.get(tname) if tname else None
                if target is not None:
                    return self._cls_lock(target, chain[2])
            return None
        if len(chain) == 2:
            # module-alias lock (protocol._NET_STATS_LOCK) or a typed
            # local (`lease.send_lock` with `lease = _Lease(...)`).
            target_mod = self.mod_by_base.get(
                mod.import_aliases.get(chain[0], ""))
            if target_mod is not None:
                return target_mod.module_locks.get(chain[1])
            tname = local_types.get(chain[0])
            target = self.cls_registry.get(tname) if tname else None
            if target is not None:
                return self._cls_lock(target, chain[1])
        return None

    def _resolve_event(self, chain: List[str], fn: _Fn,
                       local_types: Dict[str, str]
                       ) -> Optional[Tuple[Optional[LockKey], str]]:
        """(lock identity if the receiver is ALSO a lock/condition,
        descr) for a known Event/Condition receiver, else None."""
        mod = fn.module
        owner_cls: Optional[_Cls] = None
        attr = chain[-1]
        if len(chain) == 1:
            if attr in mod.module_events:
                ld = mod.module_locks.get(attr)
                return (ld.key if ld else None, attr)
            return None
        if chain[0] == "self" and fn.cls is not None:
            if len(chain) == 2:
                owner_cls = fn.cls
            elif len(chain) == 3:
                for c in self._mro(fn.cls):
                    tname = c.attr_types.get(chain[1])
                    if tname and tname in self.cls_registry:
                        owner_cls = self.cls_registry[tname]
                        break
        elif len(chain) == 2:
            tname = local_types.get(chain[0])
            if tname:
                owner_cls = self.cls_registry.get(tname)
        if owner_cls is not None:
            for c in self._mro(owner_cls):
                if attr in c.events:
                    ld = self._cls_lock(owner_cls, attr)
                    return (ld.key if ld else None,
                            f"{owner_cls.name}.{attr}")
            return None
        # Weak fallback: untyped receiver whose final attr is a known
        # event name somewhere in the tree (no lock identity).
        if attr in self.event_names:
            return (None, f"{chain[-2]}.{attr}")
        return None

    def _resolve_call(self, call: ast.Call, fn: _Fn,
                      local_types: Dict[str, str]) -> Optional[_Fn]:
        return self._resolve_ref(call.func, fn, local_types)

    def _resolve_ref(self, func: ast.AST, fn: _Fn,
                     local_types: Dict[str, str]) -> Optional[_Fn]:
        chain = _attr_chain(func)
        if not chain:
            return None
        mod = fn.module
        if len(chain) == 1:
            name = chain[0]
            # Nested def visible in the lexical scope chain.
            scope = fn
            while scope is not None:
                if name in scope.children:
                    return scope.children[name]
                scope = scope.parent
            hit = self._module_fn(mod, name)
            if hit is not None:
                return hit
            return self._ctor_init(self.cls_registry.get(name))
        if chain[0] == "self" and fn.cls is not None:
            if len(chain) == 2:
                return self._method(fn.cls, chain[1])
            if len(chain) == 3:
                for c in self._mro(fn.cls):
                    tname = c.attr_types.get(chain[1])
                    if tname and tname in self.cls_registry:
                        return self._method(
                            self.cls_registry[tname], chain[2])
            return None
        if len(chain) == 2:
            target_mod = self.mod_by_base.get(
                mod.import_aliases.get(chain[0], ""))
            if target_mod is not None:
                hit = self._module_fn(target_mod, chain[1])
                if hit is not None:
                    return hit
                for cls in target_mod.classes:
                    if cls.name == chain[1]:
                        return self._ctor_init(cls)
                return None
            tname = local_types.get(chain[0])
            if tname and tname in self.cls_registry:
                return self._method(self.cls_registry[tname], chain[1])
        return None

    def _module_fn(self, mod: _Module, name: str) -> Optional[_Fn]:
        for f in mod.fns:
            if f.name == name and f.cls is None and f.parent is None:
                return f
        return None

    def _method(self, cls: _Cls, name: str) -> Optional[_Fn]:
        for c in self._mro(cls):
            node = c.methods.get(name)
            if node is not None:
                for f in c.module.fns:
                    if f.node is node:
                        return f
        return None

    def _ctor_init(self, cls: Optional[_Cls]) -> Optional[_Fn]:
        return self._method(cls, "__init__") if cls is not None else None

    # -- pass 2: per-function facts ---------------------------------------
    def _extract_facts(self, fn: _Fn) -> _Facts:
        facts = _Facts()
        local_types: Dict[str, str] = {}

        def type_of_value(value: ast.AST) -> Optional[str]:
            if isinstance(value, ast.Call):
                chain = _attr_chain(value.func)
                if chain and chain[-1][:1].isupper():
                    return chain[-1]
            elif isinstance(value, ast.Attribute):
                chain = _attr_chain(value)
                if chain and len(chain) == 2 and chain[0] == "self" \
                        and fn.cls is not None:
                    for c in self._mro(fn.cls):
                        if chain[1] in c.attr_types:
                            return c.attr_types[chain[1]]
            elif isinstance(value, ast.IfExp):
                return type_of_value(value.body) \
                    or type_of_value(value.orelse)
            return None

        # Single pre-pass for local variable types (order-insensitive:
        # locks are usually taken after the assignment anyway).
        for stmt in ast.walk(fn.node):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                t = type_of_value(stmt.value)
                if t:
                    local_types[stmt.targets[0].id] = t

        def visit(node: ast.AST):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue  # runs at call time
                if isinstance(child, (ast.With, ast.AsyncWith)):
                    for item in child.items:
                        ld = self._resolve_lock(item.context_expr, fn,
                                                local_types)
                        if ld is not None:
                            facts.acquires.append((ld.key, child.lineno))
                elif isinstance(child, ast.Call):
                    self._fact_call(child, fn, local_types, facts)
                visit(child)

        visit(fn.node)
        return facts

    def _fact_call(self, call: ast.Call, fn: _Fn,
                   local_types: Dict[str, str], facts: _Facts):
        chain = _attr_chain(call.func)
        leaf = chain[-1] if chain else None
        line = call.lineno
        if leaf == "acquire" and chain and len(chain) >= 2:
            ld = self._resolve_lock(call.func.value, fn, local_types)
            if ld is not None:
                facts.acquires.append((ld.key, line))
            return
        if leaf in _SIGNAL_METHODS and chain and len(chain) >= 2:
            hit = self._resolve_event(chain[:-1], fn, local_types)
            if hit is not None:
                facts.signals.append((hit[0], f"{hit[1]}.{leaf}()", line))
                return
        blocking = self._blocking_descr(chain)
        if blocking is not None:
            facts.blocking.append((blocking, line))
            return
        # Spawn edges: deferred callees (never propagate held locks).
        spawned = False
        if leaf == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    facts.spawns.append((
                        "Thread(target=...)",
                        self._resolve_ref(kw.value, fn, local_types),
                        line))
                    spawned = True
        elif leaf in _SPAWN_CALLEES:
            args = call.args
            ref = None
            if leaf == "run_in_executor" and len(args) >= 2:
                ref = args[1]
            elif args:
                ref = args[0]
            if ref is not None:
                facts.spawns.append((
                    f".{leaf}(...)",
                    self._resolve_ref(ref, fn, local_types), line))
            spawned = True
        if not spawned:
            target = self._resolve_call(call, fn, local_types)
            if target is not None and target is not fn:
                facts.calls.append((target, line))

    @staticmethod
    def _blocking_descr(chain: Optional[List[str]]) -> Optional[str]:
        """lint RTL402's blocking-call set, verbatim."""
        if not chain or len(chain) < 2:
            return None
        leaf, owner = chain[-1], chain[-2]
        if owner == "protocol" and leaf in ("send", "recv", "send_batch"):
            return f"protocol.{leaf}()"
        if leaf in ("send_bytes", "recv_bytes"):
            return f"{owner}.{leaf}()"
        if leaf in ("send", "recv") and _SOCKISH_RE.search(owner.lower()):
            return f"{owner}.{leaf}()"
        if owner == "pickle" and leaf in ("dumps", "loads"):
            return f"pickle.{leaf}()"
        if owner == "serialization" and (leaf.startswith("dumps")
                                         or leaf.startswith("loads")):
            return f"serialization.{leaf}()"
        return None

    # -- interprocedural summaries ----------------------------------------
    def _fixpoint_summaries(self) -> Dict[int, Dict]:
        """For every function: the effects reachable from calling it,
        as fact-key -> (origin, next-hop).  origin = (kind, payload,
        fn qual, module path, line); next-hop = (callee id, call line)
        or None when the fact is the function's own.  Computed as a
        worklist fixpoint so recursion converges."""
        summaries: Dict[int, Dict] = {}
        for fid, facts in self._facts.items():
            fn = self._fn_by_id[fid]
            direct = {}
            for key, line in facts.acquires:
                direct[("acquire", key)] = (
                    ("acquire", key, fn.qual, fn.module.path, line), None)
            for rid, descr, line in facts.signals:
                direct[("signal", rid, descr)] = (
                    ("signal", rid, fn.qual, fn.module.path, line,
                     descr), None)
            for descr, line in facts.blocking:
                direct[("blocking", fn.module.path, line, descr)] = (
                    ("blocking", descr, fn.qual, fn.module.path, line),
                    None)
            summaries[fid] = direct
        changed = True
        while changed:
            changed = False
            for fid, facts in self._facts.items():
                summary = summaries[fid]
                for callee, line in facts.calls:
                    for key, (origin, _hop) in \
                            summaries[id(callee)].items():
                        if key not in summary:
                            summary[key] = (origin, (id(callee), line))
                            changed = True
        return summaries

    def _chain_descr(self, fid: int, key, max_hops: int = 12) -> str:
        """'f (a.py:10) -> g (b.py:22)' call chain from fid to the
        function owning the fact."""
        steps = []
        seen = set()
        while max_hops > 0:
            max_hops -= 1
            entry = self._summaries.get(fid, {}).get(key)
            if entry is None:
                break
            origin, hop = entry
            if hop is None:
                break
            callee_id, line = hop
            if (fid, callee_id) in seen:
                break
            seen.add((fid, callee_id))
            callee = self._fn_by_id[callee_id]
            steps.append(f"{callee.qual} "
                         f"({_rel(callee.module.path)}:"
                         f"{callee.node.lineno})")
            fid = callee_id
        return " -> ".join(steps)

    # -- regions: edges + findings ----------------------------------------
    def _analyze_regions(self, fn: _Fn):
        facts = self._facts[id(fn)]
        local_types: Dict[str, str] = {}
        mod = fn.module

        def handle_effects(held: List[Tuple[_LockDef, int]],
                           target_fid: int, line: int):
            """Everything reachable through a call made at `line` while
            `held` locks are held."""
            for key, (origin, _hop) in \
                    self._summaries[target_fid].items():
                kind = origin[0]
                chain_descr = self._chain_descr(target_fid, key)
                via = self._fn_by_id[target_fid].qual
                path_descr = via if not chain_descr \
                    else f"{via} -> {chain_descr}"
                for ld, wline in held:
                    if kind == "acquire":  # noqa: RTL501 -- summary fact tag, not a wire verb
                        self._note_edge(ld, origin[1], mod, line,
                                        path_descr, origin[4])
                    elif kind == "signal" and ld.kind == "leaf":
                        self._note_signal(ld, origin, mod, line,
                                          path_descr)
                    elif kind == "blocking" and ld.kind != "io-guard":
                        # Anchor at the IO SITE, deduped per (lock,
                        # site): one region-side anchor per reaching
                        # path would repeat the same root cause dozens
                        # of times, and the fix (or the noqa) lives
                        # where the IO is.
                        dedup = ("RTL604", ld.key, origin[3], origin[4])
                        if dedup in self._seen:
                            continue
                        self._seen.add(dedup)
                        self._region_findings.append((
                            "RTL604", origin[3], origin[4],
                            f"blocking '{origin[1]}' is reachable "
                            f"through calls from a 'with "
                            f"{_fmt_lock(ld.key)}:' body (e.g. "
                            f"{_rel(mod.path)}:{line} via {path_descr})"
                            f" — holding the lock across IO stalls "
                            f"every other acquirer; move the IO "
                            f"outside the critical section, or "
                            f"suppress with a reason"))

        def visit(node: ast.AST, held: List[Tuple[_LockDef, int]]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                acquired: List[_LockDef] = []
                if isinstance(child, (ast.With, ast.AsyncWith)):
                    for item in child.items:
                        ld = self._resolve_lock(item.context_expr, fn,
                                                local_types)
                        if ld is not None:
                            for h, hline in held:
                                self._note_edge(
                                    h, ld.key, mod, child.lineno, "",
                                    child.lineno)
                            acquired.append(ld)
                elif isinstance(child, ast.Call):
                    self._region_call(child, fn, local_types, held, mod,
                                      handle_effects)
                visit(child, held + [(ld, child.lineno)
                                     for ld in acquired])

        # Rebuild local types (cheap) — shared resolver needs them.
        for stmt in ast.walk(fn.node):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and isinstance(stmt.value, ast.Call):
                chain = _attr_chain(stmt.value.func)
                if chain and chain[-1][:1].isupper():
                    local_types[stmt.targets[0].id] = chain[-1]
        visit(fn.node, [])
        # Unused-variable guard for linters: facts is used above.
        del facts

    def _region_call(self, call: ast.Call, fn: _Fn, local_types, held,
                     mod, handle_effects):
        if not held:
            return
        chain = _attr_chain(call.func)
        leaf = chain[-1] if chain else None
        if leaf == "acquire" and chain and len(chain) >= 2:
            ld = self._resolve_lock(call.func.value, fn, local_types)
            if ld is not None:
                for h, _hl in held:
                    self._note_edge(h, ld.key, mod, call.lineno, "",
                                    call.lineno)
            return
        if leaf in _SIGNAL_METHODS and chain and len(chain) >= 2:
            hit = self._resolve_event(chain[:-1], fn, local_types)
            if hit is not None:
                rid, descr = hit
                for h, _hl in held:
                    if h.kind == "leaf" and rid != h.key:
                        self._region_findings.append((
                            "RTL603", mod.path, call.lineno,
                            f"'{descr}.{leaf}()' while holding "
                            f"{_fmt_lock(h.key)}, a declared leaf "
                            f"('# lock-order: leaf' at "
                            f"{_rel(h.key[0])}:{h.line}) — waking a "
                            f"waiter under the leaf hands it a "
                            f"contended lock; signal after releasing"))
                return
        if self._blocking_descr(chain) is not None:
            return  # lexical blocking-under-lock is lint RTL402's job
        if leaf == "Thread" or leaf in _SPAWN_CALLEES:
            return  # deferred: runs without these locks held
        target = self._resolve_call(call, fn, local_types)
        if target is not None and target is not fn:
            handle_effects(held, id(target), call.lineno)

    def _note_edge(self, held: _LockDef, to: LockKey, mod: _Module,
                   line: int, path_descr: str, to_line: int):
        if held.key == to:
            return  # re-entrant same-lock (RLock) / self-alias
        if (held.key, to) not in self.edges:
            self.edges[(held.key, to)] = (mod.path, line, path_descr,
                                          to_line)
        if held.kind == "leaf":
            via = f" via {path_descr}" if path_descr else ""
            self._region_findings.append((
                "RTL602", mod.path, line,
                f"{_fmt_lock(to)} is acquired while holding "
                f"{_fmt_lock(held.key)}, a declared leaf "
                f"('# lock-order: leaf' at {_rel(held.key[0])}:"
                f"{held.line}){via} — leaves must acquire nothing"))

    def _note_signal(self, held: _LockDef, origin, mod: _Module,
                     line: int, path_descr: str):
        rid = origin[1]
        if rid == held.key:
            return  # notifying the held condition itself
        self._region_findings.append((
            "RTL603", mod.path, line,
            f"'{origin[5]}' ({_rel(origin[3])}:{origin[4]}) is reached "
            f"while holding {_fmt_lock(held.key)}, a declared leaf "
            f"('# lock-order: leaf' at {_rel(held.key[0])}:{held.line})"
            f" via {path_descr} — signal after releasing the leaf"))

    # -- rules -------------------------------------------------------------
    def run(self, select: Optional[Set[str]] = None) -> List[Finding]:
        self.findings = []
        for rule, path, line, message in self._region_findings:
            self._emit(path, line, rule, message)
        self._check_cycles()
        seen: Set[str] = set()
        unique = []
        for f in self.findings:
            if repr(f) not in seen:
                seen.add(repr(f))
                unique.append(f)
        self.findings = unique
        kept = self._apply_suppressions()
        if select:
            kept = [f for f in kept
                    if any(f.rule.startswith(s) for s in select)]
        kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return kept

    def _emit(self, path: str, line: int, rule: str, message: str):
        self.findings.append(Finding(path, line, 0, rule, message))

    def _check_cycles(self):
        adj: Dict[LockKey, Set[LockKey]] = defaultdict(set)
        for (frm, to) in self.edges:
            adj[frm].add(to)
        for scc in _sccs(adj):
            if len(scc) < 2:
                continue
            in_scc = set(scc)
            cyc_edges = sorted(
                (e for e in self.edges
                 if e[0] in in_scc and e[1] in in_scc),
                key=lambda e: (self.edges[e][0], self.edges[e][1]))
            chain = " -> ".join(_fmt_lock(k) for k in
                                sorted(in_scc)) + " -> (cycle)"
            detail = "; ".join(
                f"{_fmt_lock(frm)} -> {_fmt_lock(to)} at "
                f"{_rel(self.edges[(frm, to)][0])}:"
                f"{self.edges[(frm, to)][1]}"
                + (f" via {self.edges[(frm, to)][2]}"
                   if self.edges[(frm, to)][2] else "")
                for frm, to in cyc_edges)
            path, line = self.edges[cyc_edges[0]][:2]
            self._emit(
                path, line, "RTL601",
                f"static lock-order cycle (potential deadlock): "
                f"{chain}; {detail} — pick one global order, or break "
                f"an edge by moving the inner acquisition outside")

    def _apply_suppressions(self) -> List[Finding]:
        by_path = {m.path: m for m in self.modules}
        kept: List[Finding] = []
        flagged: Set[Tuple[str, int]] = set()
        for f in self.findings:
            mod = by_path.get(f.path)
            line = (mod.lines[f.line - 1]
                    if mod and f.line <= len(mod.lines) else "")
            m = _NOQA_RE.search(line)
            rules = set()
            if m:
                rules = {tok for tok in
                         re.split(r"[\s,]+", m.group(1).upper()) if tok}
            if m and f.rule in rules:
                reason = (m.group(3) or "").strip()
                if not reason and (f.path, f.line) not in flagged:
                    flagged.add((f.path, f.line))
                    kept.append(Finding(
                        f.path, f.line, f.col, "RTL600",
                        f"suppression of {f.rule} carries no "
                        f"'-- reason' tail; concurrency-contract "
                        f"exceptions must say why"))
                continue
            kept.append(f)
        return kept

    # -- exports -----------------------------------------------------------
    def leaf_sites(self) -> Dict[str, str]:
        """Runtime-lockcheck site ('realpath:line') -> lock name, for
        every '# lock-order: leaf' creation site (forwarded bindings
        excluded: their creation line is the caller's)."""
        out = {}
        for ld in self.locks.values():
            if ld.kind == "leaf" and not ld.forwarded:
                out[f"{os.path.realpath(ld.key[0])}:{ld.line}"] = \
                    _fmt_lock(ld.key)
        return out

    def known_sites(self) -> Dict[str, LockKey]:
        """Every non-forwarded lock creation site, runtime-site keyed."""
        out = {}
        for ld in self.locks.values():
            if not ld.forwarded:
                out[f"{os.path.realpath(ld.key[0])}:{ld.line}"] = ld.key
        return out

    def site_edges(self) -> Set[Tuple[str, str]]:
        """Static edges as (creation-site, creation-site) pairs — the
        runtime lockcheck's vocabulary, for the superset cross-check."""
        site_of = {key: site for site, key in self.known_sites().items()}
        out = set()
        for (frm, to) in self.edges:
            sf, st = site_of.get(frm), site_of.get(to)
            if sf and st:
                out.add((sf, st))
        return out

    # -- inventory / doc ---------------------------------------------------
    def dump(self) -> str:
        out = ["== locks"]
        for ld in sorted(self.locks.values(),
                         key=lambda d: (d.key[0], d.line)):
            mark = f"  [{ld.kind}]" if ld.kind else ""
            fwd = "  (forwarded)" if ld.forwarded else ""
            out.append(f"  {_fmt_lock(ld.key):44} {ld.factory:10} "
                       f"{_rel(ld.key[0])}:{ld.line}{mark}{fwd}")
        out.append("== edges")
        for (frm, to), (path, line, descr, _tl) in sorted(
                self.edges.items(),
                key=lambda kv: (kv[1][0], kv[1][1])):
            via = f"  via {descr}" if descr else ""
            out.append(f"  {_fmt_lock(frm)} -> {_fmt_lock(to)}  "
                       f"[{_rel(path)}:{line}]{via}")
        out.append("== spawn edges (deferred; do not propagate locks)")
        for fid, facts in sorted(self._facts.items(),
                                 key=lambda kv: self._fn_by_id[
                                     kv[0]].qual):
            fn = self._fn_by_id[fid]
            for descr, target, line in facts.spawns:
                tgt = target.qual if target else "<unresolved>"
                out.append(f"  {fn.qual} --{descr}--> {tgt}  "
                           f"[{_rel(fn.module.path)}:{line}]")
        return "\n".join(out)

    def lock_order_doc(self) -> str:
        """The LOCK ORDER table (``--doc``): one row per known lock,
        its contract kind, creation site, and static outgoing edges —
        the single source the README embeds and tests pin."""
        lines = [
            "| lock | kind | created at | nests (static edges out) "
            "| note |",
            "|---|---|---|---|---|",
        ]
        out_edges: Dict[LockKey, List[LockKey]] = defaultdict(list)
        for (frm, to) in self.edges:
            out_edges[frm].append(to)
        for ld in sorted(self.locks.values(),
                         key=lambda d: (_rel(d.key[0]), d.line)):
            if ld.forwarded and ld.kind is None:
                continue  # alias rows without a contract add noise
            nests = ", ".join(
                f"`{_fmt_lock(t)}`"
                for t in sorted(out_edges.get(ld.key, []))) or "—"
            lines.append(
                f"| `{_fmt_lock(ld.key)}` | {ld.kind or ''} "
                f"| {_rel(ld.key[0])}:{ld.line} | {nests} "
                f"| {ld.note} |")
        return "\n".join(lines)


# ------------------------------------------------------------- helpers --

def _rel(path: str) -> str:
    """Path relative to the ray_tpu_torch package root (stable in docs)."""
    norm = path.replace(os.sep, "/")
    marker = "ray_tpu_torch/"
    idx = norm.rfind(marker)
    if idx >= 0:
        return norm[idx + len(marker):]
    return os.path.basename(path)


def _fmt_lock(key: LockKey) -> str:
    path, cls, attr = key
    base = os.path.splitext(os.path.basename(path))[0]
    return f"{base}.{cls + '.' if cls else ''}{attr}"


def _sccs(adj: Dict[LockKey, Set[LockKey]]) -> List[List[LockKey]]:
    """Iterative Tarjan strongly-connected components."""
    index: Dict[LockKey, int] = {}
    low: Dict[LockKey, int] = {}
    on_stack: Set[LockKey] = set()
    stack: List[LockKey] = []
    out: List[List[LockKey]] = []
    counter = [0]
    nodes = set(adj)
    for tos in adj.values():
        nodes |= tos

    for root in sorted(nodes):
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(adj.get(nxt, ())))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)
    return out


# ------------------------------------------------------------------ api --

def _package_dir() -> str:
    import ray_tpu_torch
    return os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))


def check_paths(paths, select: Optional[Set[str]] = None
                ) -> List[Finding]:
    return Analysis(paths).run(select=select)


def leaf_sites(paths=None) -> Dict[str, str]:
    """site ('realpath:line') -> name for every statically-annotated
    leaf — the registry the runtime lockcheck consumes, so the static
    and dynamic checkers cannot disagree about which locks are leaves."""
    return Analysis(paths or [_package_dir()]).leaf_sites()


def known_sites(paths=None) -> Dict[str, "LockKey"]:
    """Every non-forwarded lock creation site, runtime-site keyed —
    the vocabulary filter for the static-superset cross-check."""
    return Analysis(paths or [_package_dir()]).known_sites()


def site_edges(paths=None) -> Set[Tuple[str, str]]:
    """Static lock-nesting edges in creation-site terms."""
    return Analysis(paths or [_package_dir()]).site_edges()


def lock_order_doc(paths=None) -> str:
    return Analysis(paths or [_package_dir()]).lock_order_doc()


def main(argv=None) -> int:
    from ray_tpu_torch.devtools.lint import run_cli

    argv = list(sys.argv[1:] if argv is None else argv)
    dump = "--dump" in argv
    if dump:
        argv.remove("--dump")

    def runner(paths, select):
        analysis = Analysis(paths)
        if dump:
            print(analysis.dump())
            return 0
        return analysis.run(select=select)

    return run_cli(
        argv, rules=RULES, doc=lock_order_doc, runner=runner,
        usage="usage: python -m ray_tpu_torch.devtools.lockgraph "
              "[--doc|--dump|--list-rules] [--select=RTL6xx,...] "
              "PATH [PATH ...]")


if __name__ == "__main__":
    sys.exit(main())

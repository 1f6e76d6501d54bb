"""Framework-aware AST linter for the ray_tpu_torch codebase.

Pattern-matches the concurrency and serialization traps this runtime has
actually been bitten by (flaky tier-1 timeouts, event-loop stalls,
pickling errors surfacing three frames from their cause) and fails fast
in CI instead.  The reference grew the same class of tooling once its
hand-rolled concurrency crossed the size where review alone stops working
(``ray.util.check_serializability``, TSAN jobs).

Usage::

    python -m ray_tpu_torch.devtools.lint ray_tpu_torch/ tests/
    python -m ray_tpu_torch.devtools.lint --list-rules
    python -m ray_tpu_torch.devtools.lint --select=RTL402 ray_tpu_torch/   # one rule
    python -m ray_tpu_torch.devtools.lint --doc                      # rule table

Whole-program rules (RTL5xx — wire-protocol conformance, capability
gating, knob plumbing, lock-order inference) live in the sibling
``ray_tpu_torch.devtools.protocheck``.

Findings print as ``path:line:col: RTLxxx message`` and the process exits
non-zero when any un-suppressed finding remains.

Suppression: append ``# noqa: RTL401`` (comma-separated rule IDs, with an
optional ``-- rationale`` tail) to the flagged line.  A bare ``# noqa``
does NOT suppress framework rules — every suppression names what it
silences and should carry a reason.

Rule catalog
============

RTL101  blocking-get-in-async
    ``ray_tpu_torch.get()`` / ``ray.get()`` / ``.wait()`` / ``ref.get()`` /
    ``get_objects()`` called directly inside an ``async def``.  These block
    the whole event loop, stalling every other coroutine sharing it (all
    other async actor methods, every HTTP request on a proxy).  Await the
    ref, or push the call into an executor
    (``await loop.run_in_executor(None, lambda: ray_tpu_torch.get(ref))``).

RTL102  sleep-in-async
    ``time.sleep()`` inside an ``async def``.  Blocks the event loop; use
    ``await asyncio.sleep()``.

RTL103  sleep-in-handler
    ``time.sleep()`` inside a protocol/message handler (a function named
    ``handle*`` / ``on_*`` / ``*_handler`` / ``serve_connection``).
    Handlers run on shared reader/dispatch threads; sleeping stalls every
    message queued behind this one.

RTL201  remote-closure-capture
    A ``@ray_tpu_torch.remote`` function closure-captures a variable that holds
    an ``ObjectRef`` or a (potentially large) ndarray from an enclosing
    scope.  Captured refs are serialized by value into every submitted
    task and silently pin the object; captured arrays re-ship with every
    call.  Pass them as task arguments instead.

RTL301  bare-except
    ``except:`` with no exception class and no re-raise.  Swallows
    ``SystemExit`` / ``KeyboardInterrupt`` — worker/agent loops rely on
    ``SystemExit`` propagating for clean kills.  Catch ``Exception``.

RTL401  lock-acquire-no-with
    ``.acquire()`` called on a lock outside a ``with`` statement.  An
    exception between ``acquire`` and ``release`` leaks the lock and
    deadlocks the next acquirer.  Use ``with lock:``; non-blocking /
    timeout try-locks (``acquire(False)``, ``acquire(timeout=...)``) are
    exempt because ``with`` cannot express them.

RTL403  raw-recv-outside-deadline-core
    A raw connection/socket receive (``conn.recv_bytes()``,
    ``conn.recv_bytes_into()``, ``sock.recv()``) anywhere outside the
    deadline-aware protocol core.  Raw receives bypass the
    failure-detection plane entirely: no zero-progress deadline can ever
    trip, so a stalled-but-alive peer (gray failure) wedges the calling
    thread forever.  Go through ``protocol.recv`` / ``protocol.
    recv_deadline``, or arm the socket with ``protocol.
    set_conn_deadline`` around the raw loop (the object-transfer range
    loops do this) and suppress with the reason.

RTL402  blocking-io-under-runtime-lock
    A blocking socket operation (``protocol.send/recv``,
    ``*.send_bytes/recv_bytes``, ``conn/agent/worker.send/recv``) or a
    payload (un)pickle (``pickle.dumps/loads``,
    ``serialization.dumps*/loads*``) lexically inside a ``with
    self.lock:`` / ``with self._lock:`` body.  Table locks serialize the
    whole runtime: one slow peer's TCP buffer or one multi-MB pickle
    under the lock stalls EVERY submit/result/free on the head — exactly
    the contention class the decentralized-dispatch refactor removes.
    Buffer through the conflation sender (``_queue_send``) or move the
    work outside the critical section.  Lexical heuristic only: calls
    reached from a locked section through another function are not seen.
"""

from __future__ import annotations

import ast
import os
import re
import symtable
import sys
from typing import Dict, List, Optional, Set, Tuple

RULES: Dict[str, str] = {
    "RTL101": "blocking get/wait inside 'async def' stalls the event loop",
    "RTL102": "time.sleep inside 'async def' stalls the event loop",
    "RTL103": "time.sleep inside a protocol handler stalls the dispatch "
              "thread",
    "RTL201": "@remote function closure-captures an ObjectRef/ndarray",
    "RTL301": "bare 'except:' swallows SystemExit/KeyboardInterrupt",
    "RTL401": "lock .acquire() outside 'with' leaks the lock on error "
              "paths",
    "RTL402": "blocking socket send/recv or payload (un)pickling while "
              "holding a runtime lock stalls every other acquirer",
    "RTL403": "raw conn/sock receive outside the deadline-aware protocol "
              "core can hang forever on a stalled peer",
}

# RTL402: any lock-named with-target is a runtime/table lock the rule
# guards.  Locks that exist to guard a socket write (send_lock and
# friends — holding them across the send is the design) opt out with a
# structured `# lock-order: io-guard` annotation at the creation or
# binding site; lockgraph.py reads the same grammar, so the lexical and
# interprocedural checkers cannot disagree about which locks are exempt.
_RUNTIME_LOCK_RE = re.compile(r"(^|_)lock$")
_IO_GUARD_RE = re.compile(r"#\s*lock-order:\s*io-guard\b")
_LOCK_BIND_RE = re.compile(r"([A-Za-z_]\w*)\s*=")
# Receivers whose .send()/.recv() is a blocking socket call in this
# codebase (connection objects and the head-side peer handles).
_SOCKISH_RE = re.compile(r"conn|sock|agent|worker|lessee|peer|client")

_NOQA_RE = re.compile(r"#\s*noqa:\s*([A-Z0-9, ]+)", re.IGNORECASE)

_HANDLER_NAME_RE = re.compile(r"^_?(handle|on_[a-z])|_handler$")
_LOCKISH_RE = re.compile(r"lock|mutex|cond|(^|_)cv$|(^|_)sem($|_)")
_REFISH_RE = re.compile(r"(^|_)refs?($|_)|object_?ref", re.IGNORECASE)

# Names a module-level `import numpy as np` style alias may take; used to
# classify closure-captured array constructors.
_NDARRAY_ROOTS = {"np", "numpy", "jnp", "jax"}


class Finding:
    __slots__ = ("path", "line", "col", "rule", "message")

    def __init__(self, path: str, line: int, col: int, rule: str,
                 message: str):
        self.path = path
        self.line = line
        self.col = col
        self.rule = rule
        self.message = message

    def __repr__(self):
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"

    def __eq__(self, other):
        return (isinstance(other, Finding)
                and repr(self) == repr(other))


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """['np', 'random', 'rand'] for np.random.rand, or None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


def _classify_value(value: ast.AST) -> Optional[str]:
    """What a closure-captured assignment binds: 'ObjectRef', 'ndarray',
    or None when it is not a capture hazard."""
    if not isinstance(value, ast.Call):
        return None
    chain = _attr_chain(value.func)
    if chain is None:
        return None
    if chain[-1] == "remote":
        return "ObjectRef"
    if chain in (["ray_tpu_torch", "put"], ["ray", "put"]):
        return "ObjectRef"
    if chain[-1] == "ObjectRef":
        return "ObjectRef"
    if chain[0] in _NDARRAY_ROOTS and len(chain) > 1:
        return "ndarray"
    return None


def _is_remote_decorated(node: ast.AST) -> bool:
    for dec in getattr(node, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        chain = _attr_chain(target)
        if chain and chain[-1] in ("remote", "remote_decorator"):
            return True
    return False


class _Frame:
    __slots__ = ("kind", "name", "assigns")

    def __init__(self, kind: str, name: str):
        self.kind = kind  # 'module' | 'class' | 'func' | 'async' | 'lambda'
        self.name = name
        # name -> classification ('ObjectRef'/'ndarray') for closure
        # analysis; only hazardous bindings are recorded.
        self.assigns: Dict[str, Tuple[str, int]] = {}


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, tree: ast.Module,
                 table: Optional[symtable.SymbolTable],
                 io_guard: Optional[Set[str]] = None):
        self.path = path
        # Lock names annotated `# lock-order: io-guard` in this file:
        # exempt from RTL402 (they exist to be held across the write).
        self._io_guard: Set[str] = io_guard or set()
        self.findings: List[Finding] = []
        self.frames: List[_Frame] = [_Frame("module", "<module>")]
        # symtable function blocks keyed by (name, first line) so free
        # variables of @remote functions come from the real symbol table
        # instead of a hand-rolled scope walk.
        self.blocks: Dict[Tuple[str, int], symtable.SymbolTable] = {}
        if table is not None:
            self._index_blocks(table)
        self.time_aliases: Set[str] = {"time"}
        self.sleep_aliases: Set[str] = set()
        # RTL402: lexical nesting depth inside `with <runtime lock>:`
        # bodies (reset inside nested function defs — their bodies run at
        # call time, not under this acquisition).
        self._lock_depth = 0
        self._collect_imports(tree)

    # -- setup -------------------------------------------------------------
    def _index_blocks(self, table: symtable.SymbolTable):
        for child in table.get_children():
            if child.get_type() == "function":
                self.blocks[(child.get_name(), child.get_lineno())] = child
            self._index_blocks(child)

    def _collect_imports(self, tree: ast.Module):
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "time":
                        self.time_aliases.add(alias.asname or "time")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "time":
                    for alias in node.names:
                        if alias.name == "sleep":
                            self.sleep_aliases.add(alias.asname or "sleep")

    # -- helpers -----------------------------------------------------------
    def _emit(self, node: ast.AST, rule: str, message: str):
        self.findings.append(
            Finding(self.path, node.lineno, node.col_offset, rule, message))

    def _nearest_function(self) -> Optional[_Frame]:
        for frame in reversed(self.frames):
            if frame.kind in ("func", "async", "lambda"):
                return frame
        return None

    def _enclosing_binding(self, name: str) -> Optional[Tuple[str, int]]:
        # Called from _check_remote_capture BEFORE the decorated
        # function's own frame is pushed, so the innermost frame on the
        # stack is already an ENCLOSING scope.
        for frame in reversed(self.frames):
            if frame.kind in ("func", "async", "lambda") \
                    and name in frame.assigns:
                return frame.assigns[name]
        return None

    def _is_time_sleep(self, call: ast.Call) -> bool:
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "sleep" \
                and isinstance(func.value, ast.Name) \
                and func.value.id in self.time_aliases:
            return True
        return (isinstance(func, ast.Name)
                and func.id in self.sleep_aliases)

    # -- scope handling ----------------------------------------------------
    def _visit_function(self, node, kind: str):
        self._check_remote_capture(node)
        self.frames.append(_Frame(kind, node.name))
        saved_depth, self._lock_depth = self._lock_depth, 0
        try:
            for stmt in node.body:
                self.visit(stmt)
        finally:
            self.frames.pop()
            self._lock_depth = saved_depth

    def visit_FunctionDef(self, node: ast.FunctionDef):
        for dec in node.decorator_list:
            self.visit(dec)
        self._visit_function(node, "func")

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef):
        for dec in node.decorator_list:
            self.visit(dec)
        self._visit_function(node, "async")

    def visit_Lambda(self, node: ast.Lambda):
        self.frames.append(_Frame("lambda", "<lambda>"))
        # Like nested defs, a lambda's body runs at CALL time, not under
        # the enclosing with-lock acquisition (RTL402).
        saved_depth, self._lock_depth = self._lock_depth, 0
        try:
            self.visit(node.body)
        finally:
            self.frames.pop()
            self._lock_depth = saved_depth

    def visit_ClassDef(self, node: ast.ClassDef):
        self.frames.append(_Frame("class", node.name))
        try:
            self.generic_visit(node)
        finally:
            self.frames.pop()

    def visit_Assign(self, node: ast.Assign):
        frame = self.frames[-1]
        if frame.kind in ("func", "async"):
            kind = _classify_value(node.value)
            if kind:
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        frame.assigns[target.id] = (kind, node.lineno)
        self.generic_visit(node)

    # -- rules -------------------------------------------------------------
    def _check_remote_capture(self, node):
        """RTL201 — @remote function capturing refs/arrays by closure."""
        if not _is_remote_decorated(node):
            return
        block = self.blocks.get((node.name, node.lineno))
        if block is None or not isinstance(block, symtable.Function):
            return
        for free in block.get_frees():
            binding = self._enclosing_binding(free)
            if binding is None:
                continue
            kind, bind_line = binding
            self._emit(
                node, "RTL201",
                f"@remote function {node.name!r} closure-captures "
                f"{free!r} ({kind}, bound at line {bind_line}); captured "
                f"values are pickled into every submitted task — pass "
                f"{free!r} as a task argument instead")

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if node.type is None:
            reraises = any(
                isinstance(sub, ast.Raise) and sub.exc is None
                for stmt in node.body for sub in ast.walk(stmt))
            if not reraises:
                self._emit(
                    node, "RTL301",
                    "bare 'except:' swallows SystemExit/KeyboardInterrupt "
                    "(worker kill paths rely on them propagating); catch "
                    "Exception instead")
        self.generic_visit(node)

    def _holds_runtime_lock(self, node) -> bool:
        for item in node.items:
            chain = _attr_chain(item.context_expr)
            if chain and _RUNTIME_LOCK_RE.search(chain[-1]) \
                    and chain[-1] not in self._io_guard:
                return True
        return False

    def visit_With(self, node: ast.With):
        held = self._holds_runtime_lock(node)
        if held:
            self._lock_depth += 1
        try:
            self.generic_visit(node)
        finally:
            if held:
                self._lock_depth -= 1

    def visit_AsyncWith(self, node: ast.AsyncWith):
        self.visit_With(node)

    def visit_Call(self, node: ast.Call):
        self._check_async_blocking(node)
        self._check_lock_acquire(node)
        self._check_lock_io(node)
        self._check_raw_recv(node)
        self.generic_visit(node)

    def _check_raw_recv(self, node: ast.Call):
        """RTL403 — raw connection/socket receive outside the
        deadline-aware protocol core.  ``recv_bytes``/``recv_bytes_into``
        on a connection-ish receiver, or ``recv`` on a socket-named one,
        can block forever on a stalled-but-alive peer; the deadline core
        (``protocol.recv``/``recv_deadline``/``set_conn_deadline``) is
        the one place that bounds them.  Deliberately-armed raw loops
        suppress with the arming site as the reason."""
        chain = _attr_chain(node.func)
        if not chain or len(chain) < 2:
            return
        leaf, owner = chain[-1], chain[-2]
        if leaf in ("recv_bytes", "recv_bytes_into") \
                and _SOCKISH_RE.search(owner.lower()):
            what = f"{owner}.{leaf}()"
        elif leaf == "recv" and "sock" in owner.lower():
            what = f"{owner}.{leaf}()"
        else:
            return
        self._emit(
            node, "RTL403",
            f"raw '{what}' bypasses the deadline-aware protocol core — "
            "a stalled (alive-but-hung) peer wedges this thread forever; "
            "use protocol.recv/recv_deadline, or arm "
            "protocol.set_conn_deadline around the loop and suppress "
            "with the arming site as the reason")

    def _check_lock_io(self, node: ast.Call):
        """RTL402 — blocking socket IO / payload pickling while a runtime
        lock is (lexically) held."""
        if self._lock_depth <= 0:
            return
        chain = _attr_chain(node.func)
        if not chain or len(chain) < 2:
            return
        leaf, owner = chain[-1], chain[-2]
        what = None
        if owner == "protocol" and leaf in ("send", "recv", "send_batch"):
            what = f"protocol.{leaf}()"
        elif leaf in ("send_bytes", "recv_bytes"):
            what = f"{owner}.{leaf}()"
        elif leaf in ("send", "recv") and _SOCKISH_RE.search(owner.lower()):
            what = f"{owner}.{leaf}()"
        elif owner == "pickle" and leaf in ("dumps", "loads"):
            what = f"pickle.{leaf}()"
        elif owner == "serialization" and (leaf.startswith("dumps")
                                           or leaf.startswith("loads")):
            what = f"serialization.{leaf}()"
        if what:
            self._emit(
                node, "RTL402",
                f"blocking '{what}' inside a 'with <runtime lock>:' body "
                "stalls every other lock acquirer — buffer via the "
                "conflation sender or move it outside the critical "
                "section")

    def _check_async_blocking(self, node: ast.Call):
        frame = self._nearest_function()
        in_async = frame is not None and frame.kind == "async"
        if self._is_time_sleep(node):
            if in_async:
                self._emit(node, "RTL102",
                           "time.sleep() blocks the event loop; use "
                           "'await asyncio.sleep()'")
            elif frame is not None and (
                    _HANDLER_NAME_RE.search(frame.name)
                    or frame.name == "serve_connection"):
                self._emit(
                    node, "RTL103",
                    f"time.sleep() in protocol handler {frame.name!r} "
                    "stalls every message queued on this dispatch thread")
            return
        if not in_async:
            return
        chain = _attr_chain(node.func)
        if chain is None:
            return
        blocking = None
        if chain[0] in ("ray_tpu_torch", "ray") and len(chain) == 2 \
                and chain[1] in ("get", "wait"):
            blocking = ".".join(chain)
        elif chain[-1] == "get_objects":
            blocking = "get_objects"
        elif chain[-1] in ("get", "wait") and len(chain) >= 2 \
                and _REFISH_RE.search(chain[-2]) and not node.args:
            # Positional args mean a container lookup (`refs.get(key)`),
            # not a blocking ObjectRef get — those take no positionals.
            blocking = ".".join(chain[-2:])
        if blocking:
            self._emit(
                node, "RTL101",
                f"blocking '{blocking}()' inside 'async def' "
                f"{frame.name!r} stalls the event loop for every other "
                "coroutine; await the ref or use "
                "'await loop.run_in_executor(None, ...)'")

    def _check_lock_acquire(self, node: ast.Call):
        func = node.func
        if not (isinstance(func, ast.Attribute) and func.attr == "acquire"):
            return
        chain = _attr_chain(func.value)
        leaf = chain[-1] if chain else None
        if leaf is None or not _LOCKISH_RE.search(leaf.lower()):
            return
        # Try-locks are exempt: `with` cannot express acquire(False) /
        # acquire(timeout=...) / acquire(True, 0.5).
        if len(node.args) >= 2:
            return  # second positional is a timeout
        if node.args:
            first = node.args[0]
            if isinstance(first, ast.Constant) and first.value in (False, 0):
                return
        for kw in node.keywords:
            if kw.arg == "timeout":
                return
            if kw.arg == "blocking" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is False:
                return
        self._emit(
            node, "RTL401",
            f"'{leaf}.acquire()' outside 'with': an exception before the "
            "matching release() leaks the lock and deadlocks the next "
            f"acquirer — use 'with {leaf}:'")


def _io_guard_names(source: str) -> Set[str]:
    """Lock names annotated ``# lock-order: io-guard`` anywhere in the
    file — at the creation or forwarded-binding line, or on an
    annotation-only line directly above it (lockgraph's grammar)."""
    out: Set[str] = set()
    lines = source.splitlines()
    for i, line in enumerate(lines):
        if not _IO_GUARD_RE.search(line):
            continue
        bind = line if "=" in line.split("#", 1)[0] else (
            lines[i + 1] if i + 1 < len(lines) else "")
        for name in _LOCK_BIND_RE.findall(bind.split("#", 1)[0]):
            if _RUNTIME_LOCK_RE.search(name):
                out.add(name)
    return out


def _noqa_rules(line: str) -> Set[str]:
    match = _NOQA_RE.search(line)
    if not match:
        return set()
    # Split on commas AND whitespace: '# noqa: RTL401 lock handoff'
    # (rationale without the documented '--') must still suppress RTL401
    # — stray rationale words become harmless non-rule tokens.
    return {tok for tok in re.split(r"[\s,]+", match.group(1).upper())
            if tok}


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as err:
        return [Finding(path, err.lineno or 0, err.offset or 0, "RTL000",
                        f"syntax error: {err.msg}")]
    try:
        table = symtable.symtable(source, path, "exec")
    except SyntaxError:
        table = None
    linter = _Linter(path, tree, table, _io_guard_names(source))
    linter.visit(tree)
    lines = source.splitlines()
    kept = []
    for finding in linter.findings:
        line = lines[finding.line - 1] if finding.line <= len(lines) else ""
        if finding.rule in _noqa_rules(line):
            continue
        kept.append(finding)
    kept.sort(key=lambda f: (f.line, f.col, f.rule))
    return kept


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), path)


def _iter_py_files(paths) -> List[str]:
    out = []
    for path in paths:
        if os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                # `lint_fixtures` holds this linter's own deliberately-bad
                # test corpus — excluded from directory walks so the
                # documented `lint ray_tpu_torch/ tests/` invocation can go
                # green; naming a fixture file explicitly still lints it.
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith(".")
                                 and d != "__pycache__"
                                 and d != "lint_fixtures")
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        else:
            # Explicitly named files are linted regardless of extension —
            # silently skipping one would report a clean result for a
            # file that was never parsed.
            out.append(path)
    return out


def lint_paths(paths) -> List[Finding]:
    findings: List[Finding] = []
    for path in _iter_py_files(paths):
        findings.extend(lint_file(path))
    return findings


def rules_doc() -> str:
    """Markdown table of the per-file rule catalog (``--doc``)."""
    lines = ["| rule | what it catches |", "|---|---|"]
    for rule_id in sorted(RULES):
        lines.append(f"| {rule_id} | {RULES[rule_id]} |")
    return "\n".join(lines)


def run_cli(argv, *, rules, usage, runner, doc=None) -> int:
    """Shared CLI driver for the devtools analyzers (this linter and
    ``protocheck``): --list-rules, --doc, validated --select, the
    missing-path guard, and the findings print/exit tail live ONCE here
    so the two tools cannot drift.

    ``runner(paths, select)`` returns the (already select-filtered)
    finding list — or an int to take over the exit code (protocheck's
    ``--dump``)."""
    argv = list(argv)
    if "--list-rules" in argv:
        for rule_id in sorted(rules):
            print(f"{rule_id}  {rules[rule_id]}")
        return 0
    if doc is not None and "--doc" in argv:
        print(doc())
        return 0
    select = None
    for arg in list(argv):
        if arg.startswith("--select="):
            select = {s.strip().upper() for s in
                      arg.split("=", 1)[1].split(",") if s.strip()}
            argv.remove(arg)
    if select:
        # A typo'd selector must not filter every finding and report a
        # green run (prefix match is the contract: RTL4 = the family).
        unknown = sorted(s for s in select
                         if not any(r.startswith(s) for r in rules))
        if unknown:
            print(f"error: --select matches no rule: "
                  f"{', '.join(unknown)} (known: "
                  f"{', '.join(sorted(rules))})", file=sys.stderr)
            return 2
    paths = [a for a in argv if not a.startswith("-")]
    if not paths:
        print(usage, file=sys.stderr)
        return 2
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        # A typo'd path must not report a green "clean tree" it never
        # linted.
        print(f"error: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2
    findings = runner(paths, select)
    if isinstance(findings, int):
        return findings
    for finding in findings:
        print(repr(finding))
    if findings:
        print(f"{len(findings)} finding(s). Suppress deliberate patterns "
              f"with '# noqa: <RULE-ID> -- reason'.", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    def runner(paths, select):
        findings = lint_paths(paths)
        if select:
            # Prefix match so --select=RTL4 runs the whole lock family.
            findings = [f for f in findings
                        if any(f.rule.startswith(s) for s in select)]
        return findings

    return run_cli(
        argv, rules=RULES, doc=rules_doc, runner=runner,
        usage="usage: python -m ray_tpu_torch.devtools.lint [--list-rules] "
              "[--doc] [--select=RTLxxx,...] PATH [PATH ...]")


if __name__ == "__main__":
    sys.exit(main())

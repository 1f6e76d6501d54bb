"""DAG node types.

Reference: ``python/ray/dag/dag_node.py:23`` (DAGNode base + bound
args/options), ``function_node.py``, ``class_node.py``, ``input_node.py``.
Execution semantics match: a node executes once per ``execute()`` call;
upstream results flow as ObjectRefs so the scheduler sees the real
dependency graph and runs independent branches in parallel.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    def __init__(self, args: Tuple[Any, ...] = (),
                 kwargs: Optional[Dict[str, Any]] = None):
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs or {})
        # Stable across copies/pickles — workflow storage keys step results
        # by it (reference: _stable_uuid, dag_node.py).
        self._stable_uuid = uuid.uuid4().hex

    # -- traversal ---------------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def topo_order(self) -> List["DAGNode"]:
        """Children-first order (every node once)."""
        seen: Dict[str, DAGNode] = {}
        order: List[DAGNode] = []

        def visit(n: DAGNode):
            if n._stable_uuid in seen:
                return
            seen[n._stable_uuid] = n
            for c in n._children():
                visit(c)
            order.append(n)

        visit(self)
        return order

    # -- execution ---------------------------------------------------------
    def execute(self, *input_args, _memo: Optional[dict] = None, **input_kw):
        """Run the whole DAG; returns this node's result handle
        (ObjectRef for function/method nodes, actor handle for ClassNode).
        """
        memo = _memo if _memo is not None else {}
        for node in self.topo_order():
            if node._stable_uuid not in memo:
                memo[node._stable_uuid] = node._execute_impl(
                    memo, input_args, input_kw)
        return memo[self._stable_uuid]

    def _resolve(self, memo, input_args, input_kw):
        def one(a):
            return memo[a._stable_uuid] if isinstance(a, DAGNode) else a

        args = [one(a) for a in self._bound_args]
        kwargs = {k: one(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_impl(self, memo, input_args, input_kw):
        raise NotImplementedError


class InputNode(DAGNode):
    """Runtime-input placeholder (reference: input_node.py); supports use
    as a context manager for parity with the reference idiom::

        with InputNode() as inp:
            dag = f.bind(inp)
        dag.execute(5)
    """

    def __init__(self):
        super().__init__()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_impl(self, memo, input_args, input_kw):
        if not input_args:
            raise ValueError("DAG has an InputNode: execute(...) needs an "
                             "input argument")
        return input_args[0]


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._fn = remote_fn

    def _execute_impl(self, memo, input_args, input_kw):
        args, kwargs = self._resolve(memo, input_args, input_kw)
        return self._fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """Actor construction node: executing it instantiates the actor; its
    handle memoizes for downstream ClassMethodNodes."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._cls = actor_cls

    def _execute_impl(self, memo, input_args, input_kw):
        args, kwargs = self._resolve(memo, input_args, input_kw)
        return self._cls.remote(*args, **kwargs)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return _MethodBinder(self, item)


class _MethodBinder:
    def __init__(self, class_node: ClassNode, method: str):
        self._class_node = class_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method: str, args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method = method

    def _children(self):
        return super()._children() + [self._class_node]

    def _execute_impl(self, memo, input_args, input_kw):
        handle = memo[self._class_node._stable_uuid]
        args, kwargs = self._resolve(memo, input_args, input_kw)
        return getattr(handle, self._method).remote(*args, **kwargs)

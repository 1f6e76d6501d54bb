"""Lazy task/actor DAGs (reference: ``python/ray/dag/dag_node.py:23``).

``fn.bind(*args)`` builds a graph instead of executing; ``.execute(input)``
walks it, submitting each node exactly once per execution with upstream
ObjectRefs as arguments — so the whole DAG is in flight at once and the
runtime's dependency tracking provides the ordering (the reference's
FunctionNode/ClassNode/InputNode surface, minus compiled-graph channels
which this snapshot's reference also lacks).
"""

from ray_tpu_torch.dag.node import (
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputNode,
)

__all__ = ["DAGNode", "FunctionNode", "InputNode", "ClassNode",
           "ClassMethodNode"]

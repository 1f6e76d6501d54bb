"""Developer tools for the ray_tpu_torch framework itself.

Three correctness tools for the hand-rolled concurrency in the runtime
(a dozen ``threading.Lock``\\ s across ``shm_store`` / ``object_transfer`` /
``worker_main`` / ``node_agent``, plus asyncio actor loops) — the in-repo
analog of the tooling the Ray reference grew for the same class of code
(``ray.util.check_serializability``, TSAN CI jobs):

- :mod:`ray_tpu_torch.devtools.lint` — AST-based framework linter with rules
  specific to this codebase (blocking ``get`` in ``async def``, lock
  acquisition outside ``with``, bare ``except:`` swallowing ``SystemExit``,
  closure-captured ``ObjectRef``/ndarray in ``@remote`` functions, ...).
  Run as ``python -m ray_tpu_torch.devtools.lint ray_tpu_torch/ tests/``.
- :mod:`ray_tpu_torch.devtools.lockcheck` — opt-in runtime lock-order checker
  (``RAY_TPU_LOCKCHECK=1``): wraps ``threading.Lock``/``RLock``, records
  the per-thread acquisition graph, and flags cycles (potential deadlock)
  and event-loop stalls >50 ms in async actor handlers.
- :mod:`ray_tpu_torch.devtools.serializability` —
  ``check_serializability(obj)``: walks closures/attributes/containers and
  pinpoints the exact non-serializable leaf with a path string (also wired
  into the ``@remote`` argument-pickling error path).
"""

from ray_tpu_torch.devtools.serializability import (  # noqa: F401 (public API)
    check_serializability,
    find_unserializable,
)

__all__ = ["check_serializability", "find_unserializable"]

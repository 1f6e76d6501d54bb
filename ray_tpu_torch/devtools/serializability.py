"""Pinpoint WHY an object fails to serialize, not just that it did.

Reference analog: ``ray.util.check_serializability`` /
``python/ray/util/serialization_addons.py`` — cloudpickle's error for a
deeply nested unpicklable leaf names the leaf's type but not where it
lives; on a 40-field trainer config captured by a closure that is a
20-minute hunt.  :func:`find_unserializable` walks closures, attributes,
and containers breadth-first and returns the PATH to the failing leaf
(e.g. ``arg[0].fn.__closure__['model']``), and
:func:`check_serializability` raises :class:`SerializationTrapError`
carrying it.  The ``@remote`` submit path calls this automatically when
argument pickling fails (remote_function.serialize_args).
"""

from __future__ import annotations

import inspect
from typing import Any, List, Optional, Tuple

from ray_tpu_torch.exceptions import RayTpuError

# Breadth/depth caps: diagnosis must stay cheap even for pathological
# object graphs — this runs on an error path the user is already staring
# at, not in the hot loop.
_MAX_DEPTH = 20
_MAX_CHILDREN = 256


class SerializationTrapError(RayTpuError, TypeError):
    """An object graph contains an unserializable leaf.

    ``path`` names the exact leaf (e.g. ``arg[0].fn.__closure__['model']``)
    and ``leaf_repr`` its repr.  TypeError subclass for parity with the
    reference's pickling errors (``except TypeError`` keeps working).
    """

    def __init__(self, path: str, leaf_repr: str, cause_repr: str):
        self.path = path
        self.leaf_repr = leaf_repr
        self.cause_repr = cause_repr
        super().__init__(
            f"Cannot serialize {path}: {leaf_repr} ({cause_repr}). "
            f"Pass the value explicitly (task argument / actor state) or "
            f"exclude it from the closure.")

    def __reduce__(self):
        return (SerializationTrapError,
                (self.path, self.leaf_repr, self.cause_repr))


def _dumps_ok(obj: Any) -> Optional[Exception]:
    """None when ``obj`` pickles cleanly, else the error."""
    from ray_tpu_torch._private import serialization

    try:
        serialization.dumps_inline(obj)
        return None
    except Exception as err:  # noqa: BLE001 — any failure is the answer
        return err


def _short(obj: Any) -> str:
    try:
        text = repr(obj)
    except Exception:
        text = f"<unreprable {type(obj).__name__}>"
    return text if len(text) <= 120 else text[:117] + "..."


def _children(obj: Any) -> List[Tuple[str, Any]]:
    """(path-suffix, child) pairs for one level of the object graph."""
    out: List[Tuple[str, Any]] = []
    if inspect.isfunction(obj) or inspect.ismethod(obj):
        fn = obj.__func__ if inspect.ismethod(obj) else obj
        closure = getattr(fn, "__closure__", None) or ()
        freevars = getattr(fn.__code__, "co_freevars", ())
        for name, cell in zip(freevars, closure):
            try:
                out.append((f".__closure__[{name!r}]", cell.cell_contents))
            except ValueError:
                pass  # empty cell
        for i, default in enumerate(getattr(fn, "__defaults__", None) or ()):
            out.append((f".__defaults__[{i}]", default))
        # Globals the function body references (cloudpickle captures these
        # by value for __main__/interactively defined functions).
        fn_globals = getattr(fn, "__globals__", {})
        for name in getattr(fn.__code__, "co_names", ()):
            if name in fn_globals:
                out.append((f".__globals__[{name!r}]", fn_globals[name]))
        return out[:_MAX_CHILDREN]
    if isinstance(obj, dict):
        for key, value in list(obj.items())[:_MAX_CHILDREN]:
            out.append((f"[{key!r}]" if isinstance(key, (str, bytes, int))
                        else f"[<key {_short(key)}>]", value))
            out.append((f"<key {_short(key)}>", key))
        return out
    if isinstance(obj, (list, tuple)):
        return [(f"[{i}]", value)
                for i, value in enumerate(obj[:_MAX_CHILDREN])]
    if isinstance(obj, (set, frozenset)):
        return [(f"<member {_short(value)}>", value)
                for value in list(obj)[:_MAX_CHILDREN]]
    state = getattr(obj, "__dict__", None)
    if isinstance(state, dict):
        out.extend((f".{name}", value)
                   for name, value in list(state.items())[:_MAX_CHILDREN])
    slots = getattr(type(obj), "__slots__", ())
    if isinstance(slots, str):
        slots = (slots,)
    for name in slots:
        try:
            out.append((f".{name}", getattr(obj, name)))
        except AttributeError:
            pass
    return out[:_MAX_CHILDREN]


def find_unserializable(obj: Any, name: str = "obj"
                        ) -> Optional[Tuple[str, Any, Exception]]:
    """Deepest unserializable leaf as ``(path, leaf, error)``, or None
    when ``obj`` serializes cleanly."""
    err = _dumps_ok(obj)
    if err is None:
        return None
    path, node = name, obj
    seen = {id(obj)}
    for _ in range(_MAX_DEPTH):
        for suffix, child in _children(node):
            if id(child) in seen:
                continue
            child_err = _dumps_ok(child)
            if child_err is not None:
                seen.add(id(child))
                path, node, err = path + suffix, child, child_err
                break
        else:
            break  # no failing child: `node` itself is the leaf
    return path, node, err


def diagnose_pickle_error(obj: Any, name: str, err: Exception) -> None:
    """Error-path upgrade for a pickling failure on ``obj``: when the walk
    confirms an unserializable leaf, raise :class:`SerializationTrapError`
    naming it (chained to ``err``); otherwise the failure had some other
    cause (store full, transient) — re-raise ``err`` untouched."""
    found = find_unserializable(obj, name)
    if found is None:
        raise err
    path, leaf, leaf_err = found
    raise SerializationTrapError(path, _short(leaf), repr(leaf_err)) from err


def check_serializability(obj: Any, name: str = "obj") -> None:
    """Raise :class:`SerializationTrapError` naming the exact leaf if
    ``obj`` (or anything reachable from it) cannot be cloudpickled;
    return None when it serializes cleanly.

    Reference parity: ``ray.util.check_serializability``.
    """
    found = find_unserializable(obj, name)
    if found is None:
        return
    path, leaf, err = found
    raise SerializationTrapError(path, _short(leaf), repr(err))

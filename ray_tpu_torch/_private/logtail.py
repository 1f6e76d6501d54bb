"""Incremental worker-log tailing, shared by the head's log monitor and
every node agent's shipper (reference: log_monitor.py file tailing)."""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

# A "line" that never sees a newline (carriage-return progress bars)
# flushes once it exceeds this, so tqdm-style output cannot grow the
# partial buffer without bound (and still reaches the driver).
_PARTIAL_FLUSH_AT = 64 << 10
_READ_CAP = 1 << 20


def tail_worker_logs(log_dir: str, offsets: Dict[str, int],
                     partial: Dict[str, bytes]
                     ) -> List[Tuple[str, List[str]]]:
    """One tail pass over ``log_dir``'s worker-*.log files.  ``offsets``
    and ``partial`` are caller-owned state carried between passes;
    returns [(worker_id_hex, new_lines), ...]."""
    out: List[Tuple[str, List[str]]] = []
    try:
        names = os.listdir(log_dir)
    except OSError:
        return out
    for name in names:
        if not name.startswith("worker-") or not name.endswith(".log"):
            continue
        path = os.path.join(log_dir, name)
        try:
            size = os.path.getsize(path)
            off = offsets.get(name, 0)
            if size <= off:
                continue
            with open(path, "rb") as f:
                f.seek(off)
                chunk = partial.pop(name, b"") + f.read(
                    min(size - off, _READ_CAP))
            offsets[name] = off + min(size - off, _READ_CAP)
        except OSError:
            continue
        *lines, rest = chunk.split(b"\n")
        if len(rest) > _PARTIAL_FLUSH_AT:
            # \r-rewriting output: ship the most recent screenful rather
            # than buffering the stream forever.
            lines.append(rest.split(b"\r")[-1])
            rest = b""
        if rest:
            partial[name] = rest
        if lines:
            out.append((name[len("worker-"):-len(".log")],
                        [ln.decode("utf-8", "replace") for ln in lines]))
    return out

"""Node memory readings for the OOM monitor.

Reference: ``src/ray/common/memory_monitor.h`` — the raylet samples the
cgroup first and /proc second, and triggers the worker-killing policy
above a usage threshold.  Inside a container /proc/meminfo reports the
HOST's memory, so a cgroup-limited process would never appear under
pressure; we therefore prefer cgroup v2 ``memory.current``/``memory.max``
(v1 ``memory.usage_in_bytes``/``memory.limit_in_bytes`` as fallback) and
only then fall back to /proc/meminfo's MemAvailable, which accounts for
reclaimable page cache the way the kernel's own OOM heuristics do.
"""

from __future__ import annotations

from typing import Optional

CGROUP_V2_USAGE = "/sys/fs/cgroup/memory.current"
CGROUP_V2_LIMIT = "/sys/fs/cgroup/memory.max"
CGROUP_V2_STAT = "/sys/fs/cgroup/memory.stat"
CGROUP_V1_USAGE = "/sys/fs/cgroup/memory/memory.usage_in_bytes"
CGROUP_V1_LIMIT = "/sys/fs/cgroup/memory/memory.limit_in_bytes"
CGROUP_V1_STAT = "/sys/fs/cgroup/memory/memory.stat"

# v1 reports an effectively-unlimited cgroup as a huge number (the
# kernel's page-counter max); treat anything this large as "no limit".
_NO_LIMIT = 1 << 50


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path, encoding="utf-8") as f:
            raw = f.read().strip()
    except OSError:
        return None
    if raw == "max":  # cgroup v2 spelling of "unlimited"
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def _read_inactive_file(stat_path: str) -> int:
    """Reclaimable file cache charged to the cgroup; subtracted from
    usage so cached pages don't read as pressure (the same working-set
    definition the kernel's and k8s' OOM accounting use)."""
    try:
        with open(stat_path, encoding="utf-8") as f:
            for line in f:
                if line.startswith("inactive_file ") or \
                        line.startswith("total_inactive_file "):
                    return int(line.rsplit(None, 1)[1])
    except (OSError, ValueError):
        pass
    return 0


def _cgroup_usage_fraction() -> Optional[float]:
    """Usage fraction from the cgroup limits, or None when the process
    is not memory-limited by a cgroup (no files, or limit "max")."""
    for usage_p, limit_p, stat_p in (
            (CGROUP_V2_USAGE, CGROUP_V2_LIMIT, CGROUP_V2_STAT),
            (CGROUP_V1_USAGE, CGROUP_V1_LIMIT, CGROUP_V1_STAT)):
        usage = _read_int(usage_p)
        limit = _read_int(limit_p)
        if usage is None or limit is None:
            continue
        if limit <= 0 or limit >= _NO_LIMIT:
            continue  # unlimited cgroup: host meminfo is the truth
        used = max(0, usage - _read_inactive_file(stat_p))
        return min(1.0, used / limit)
    return None


def memory_usage_fraction(test_file: str = "") -> float:
    """Fraction of node memory in use, 0.0-1.0.  ``test_file`` overrides
    with a literal float (test injection; absent/invalid reads as 0)."""
    if test_file:
        try:
            with open(test_file, encoding="utf-8") as f:
                return float(f.read().strip())
        except (OSError, ValueError):
            return 0.0
    frac = _cgroup_usage_fraction()
    if frac is not None:
        return frac
    total = avail = None
    try:
        with open("/proc/meminfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
                if total is not None and avail is not None:
                    break
    except OSError:
        return 0.0
    if not total or avail is None:
        return 0.0
    return max(0.0, 1.0 - avail / total)

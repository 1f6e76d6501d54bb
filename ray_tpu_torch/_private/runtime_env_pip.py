"""Pip runtime-env materialization: venv per requirements hash.

Reference: ``python/ray/_private/runtime_env/pip.py`` — a task/actor with
``runtime_env={"pip": [...]}`` runs in a virtualenv holding exactly those
packages, built once per unique requirements list and cached.

TPU-era shape: the WORKER builds (or reuses) the venv at startup and
re-execs itself under the venv's interpreter (``--system-site-packages``
keeps jax/numpy/cloudpickle importable).  Building in the worker keeps the
head's dispatch loop out of multi-second pip installs — the reference puts
this in its per-node agent for the same reason.  Concurrent workers of the
same env serialize on an flock so the build runs once.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Tuple

DEFAULT_BASE = "/tmp/ray_tpu_venvs"


def normalize_pip_spec(pip: Any) -> Tuple[List[str], List[str]]:
    """User spec -> (packages, extra pip options).  Accepts the reference
    forms: a list of requirement strings or {"packages": [...],
    "pip_install_options": [...]}."""
    if isinstance(pip, (list, tuple)):
        return [str(p) for p in pip], []
    if isinstance(pip, dict):
        return ([str(p) for p in pip.get("packages", [])],
                [str(o) for o in pip.get("pip_install_options", [])])
    raise ValueError(f"bad pip runtime_env spec: {pip!r}")


def pip_env_hash(pip: Any) -> str:
    packages, options = normalize_pip_spec(pip)
    blob = json.dumps([packages, options]).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def ensure_pip_env(pip: Any, base_dir: str = DEFAULT_BASE) -> str:
    """Build-or-reuse the venv for ``pip``; returns its python binary.
    Raises RuntimeError (with pip's output) on build failure."""
    import fcntl
    import venv

    packages, options = normalize_pip_spec(pip)
    key = pip_env_hash(pip)
    target = os.path.join(base_dir, key)
    python = os.path.join(target, "bin", "python")
    marker = os.path.join(target, ".ray_tpu_ok")
    if os.path.exists(marker):
        return python
    os.makedirs(base_dir, exist_ok=True)
    lock_path = os.path.join(base_dir, f".{key}.lock")
    with open(lock_path, "w", encoding="utf-8") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):  # raced: another worker built it
                return python
            venv.create(target, system_site_packages=True, with_pip=True,
                        clear=True)
            if packages:
                cmd = [python, "-m", "pip", "install",
                       "--disable-pip-version-check"]
                cmd += options + packages
                out = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=600)
                if out.returncode != 0:
                    raise RuntimeError(
                        f"pip install failed for {packages}: "
                        f"{out.stderr[-2000:]}")
            with open(marker, "w", encoding="utf-8") as f:
                f.write(json.dumps({"packages": packages,
                                    "options": options}))
            return python
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def maybe_reexec_into_pip_env():
    """Worker-startup hook: with RAY_TPU_PIP_SPEC set and not yet inside
    the target venv, build it and exec this process under its
    interpreter (env preserved; the reference instead launches workers
    through the agent with the materialized env's python)."""
    spec_json = os.environ.get("RAY_TPU_PIP_SPEC")
    if not spec_json:
        return
    spec = json.loads(spec_json)
    key = pip_env_hash(spec)
    if os.environ.get("RAY_TPU_PIP_ACTIVE") == key:
        return  # already re-exec'd
    try:
        python = ensure_pip_env(spec)
    except Exception as e:  # noqa: BLE001 — startup failure is terminal
        print(f"[ray_tpu_torch worker {os.getpid()}] runtime_env pip setup "
              f"failed: {e}", file=sys.stderr)
        raise SystemExit(1)
    env = dict(os.environ, RAY_TPU_PIP_ACTIVE=key)
    os.execve(python,
              [python, "-m", "ray_tpu_torch._private.worker_main"], env)

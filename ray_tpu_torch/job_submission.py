"""Job submission: run driver scripts against the cluster, supervised.

Reference: ``dashboard/modules/job/job_manager.py`` (jobs are driver
processes run by a supervisor on the cluster, logs streamed, status
tracked) + ``sdk.py:40 JobSubmissionClient``.  Condensed: the head hosts
a JobManager; each job is a subprocess whose environment carries the
cluster's client address (RAY_TPU_CLIENT_ADDRESS/AUTHKEY), so
``ray_tpu_torch.init()`` inside the entrypoint attaches to THIS cluster in
client mode.  ``JobSubmissionClient`` works in-process against the local
runtime or remotely over a client connection (the CLI path).
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

JOB_STATUSES = ("PENDING", "RUNNING", "SUCCEEDED", "FAILED", "STOPPED")


class JobInfo:
    def __init__(self, job_id: str, entrypoint: str, runtime_env: dict):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.runtime_env = runtime_env or {}
        self.status = "PENDING"
        self.proc: Optional[subprocess.Popen] = None
        self.log_path = ""
        self.start_time = time.time()
        self.end_time: Optional[float] = None

    def snapshot(self) -> Dict[str, Any]:
        return {"job_id": self.job_id, "entrypoint": self.entrypoint,
                "status": self.status, "start_time": self.start_time,
                "end_time": self.end_time, "log_path": self.log_path}


class JobManager:
    """Head-side supervisor (reference: JobManager, job_manager.py)."""

    def __init__(self, runtime):
        self._rt = runtime
        self._jobs: Dict[str, JobInfo] = {}
        self._lock = threading.Lock()
        self._log_dir = tempfile.mkdtemp(
            prefix=f"ray_tpu_jobs_{runtime.session_id}_")

    def submit(self, entrypoint: str, runtime_env: Optional[dict] = None,
               submission_id: Optional[str] = None) -> str:
        job_id = submission_id or f"job_{uuid.uuid4().hex[:12]}"
        info = JobInfo(job_id, entrypoint, runtime_env or {})
        info.log_path = os.path.join(self._log_dir, f"{job_id}.log")
        env = dict(os.environ)
        env.update((runtime_env or {}).get("env_vars", {}))
        env["RAY_TPU_CLIENT_ADDRESS"] = self._rt.tcp_address
        env["RAY_TPU_CLIENT_AUTHKEY"] = self._rt._authkey.hex()
        env["RAY_TPU_JOB_ID"] = job_id
        env["PYTHONPATH"] = (
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            + os.pathsep + env.get("PYTHONPATH", ""))
        cwd = (runtime_env or {}).get("working_dir") or os.getcwd()
        log = open(info.log_path, "wb")
        info.proc = subprocess.Popen(
            entrypoint if os.name == "nt" else shlex.split(entrypoint),
            env=env, cwd=cwd, stdout=log, stderr=subprocess.STDOUT)
        log.close()
        info.status = "RUNNING"
        with self._lock:
            self._jobs[job_id] = info
        self._rt._gcs_dirty += 1
        threading.Thread(target=self._wait, args=(info,), daemon=True,
                         name=f"job-{job_id}").start()
        return job_id

    def _wait(self, info: JobInfo):
        rc = info.proc.wait()
        with self._lock:
            if info.status == "RUNNING":
                info.status = "SUCCEEDED" if rc == 0 else "FAILED"
            info.end_time = time.time()
        self._rt._gcs_dirty += 1

    def status(self, job_id: str) -> str:
        with self._lock:
            info = self._jobs.get(job_id)
        return info.status if info else "NOT_FOUND"

    def logs(self, job_id: str) -> str:
        with self._lock:
            info = self._jobs.get(job_id)
        if info is None:
            return ""
        try:
            with open(info.log_path, "rb") as f:
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def stop(self, job_id: str) -> bool:
        with self._lock:
            info = self._jobs.get(job_id)
            if info is None or info.status != "RUNNING":
                return False
            info.status = "STOPPED"
        try:
            info.proc.terminate()
        except Exception:
            pass
        return True

    def list(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [i.snapshot() for i in self._jobs.values()]

    def snapshot_rows(self) -> List[Dict[str, Any]]:
        """Rows for the head's GCS snapshot (persistence across head
        restarts; reference: the GCS job table survives failover)."""
        return self.list()

    def adopt_rows(self, rows: List[Dict[str, Any]]):
        """Re-adopt job records from a pre-restart snapshot.  Their
        driver processes died with the old head: RUNNING/PENDING rows
        become FAILED with a restart note."""
        with self._lock:
            for row in rows:
                if row["job_id"] in self._jobs:
                    continue
                info = JobInfo(row["job_id"], row["entrypoint"], {})
                info.status = ("FAILED"
                               if row["status"] in ("PENDING", "RUNNING")
                               else row["status"])
                info.start_time = row.get("start_time", 0.0)
                info.end_time = row.get("end_time")
                info.log_path = row.get("log_path", "")
                self._jobs[row["job_id"]] = info


def _get_manager(runtime) -> JobManager:
    mgr = getattr(runtime, "_job_manager", None)
    if mgr is None:
        mgr = runtime._job_manager = JobManager(runtime)
        restored = getattr(runtime, "_restored_jobs", None)
        if restored:
            mgr.adopt_rows(restored)
    return mgr


class JobSubmissionClient:
    """reference: dashboard/modules/job/sdk.py:40 — same method names.
    With no address: drives the in-process runtime's JobManager.  With an
    address: sends job_* control messages over a client connection."""

    def __init__(self, address: Optional[str] = None,
                 _authkey: Optional[str] = None):
        from ray_tpu_torch._private import api_internal

        self._client = None
        if address is not None:
            from ray_tpu_torch._private.client import client_connect

            key = _authkey or os.environ.get("RAY_TPU_CLIENT_AUTHKEY")
            if not key:
                raise ValueError("remote JobSubmissionClient needs _authkey")
            self._client = client_connect(address, bytes.fromhex(key))
            self._mgr = None
        else:
            rt = api_internal.require_runtime()
            if getattr(rt, "is_client", False):
                self._client = rt
                self._mgr = None
            else:
                self._mgr = _get_manager(rt)

    def _req(self, builder):
        out = self._client.request(builder)
        if isinstance(out, Exception):
            raise out
        return out

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   submission_id: Optional[str] = None) -> str:
        if self._mgr is not None:
            return self._mgr.submit(entrypoint, runtime_env, submission_id)
        return self._req(lambda rid: ("job_submit", rid, entrypoint,
                                      runtime_env, submission_id))

    def get_job_status(self, job_id: str) -> str:
        if self._mgr is not None:
            return self._mgr.status(job_id)
        return self._req(lambda rid: ("job_status", rid, job_id))

    def get_job_logs(self, job_id: str) -> str:
        if self._mgr is not None:
            return self._mgr.logs(job_id)
        return self._req(lambda rid: ("job_logs", rid, job_id))

    def stop_job(self, job_id: str) -> bool:
        if self._mgr is not None:
            return self._mgr.stop(job_id)
        return self._req(lambda rid: ("job_stop", rid, job_id))

    def list_jobs(self) -> List[Dict[str, Any]]:
        if self._mgr is not None:
            return self._mgr.list()
        return self._req(lambda rid: ("job_list", rid))

    def tail_job_logs(self, job_id: str, timeout: float = 60.0):
        """Generator of log chunks until the job finishes."""
        seen = 0
        deadline = time.time() + timeout
        while time.time() < deadline:
            text = self.get_job_logs(job_id)
            if len(text) > seen:
                yield text[seen:]
                seen = len(text)
            if self.get_job_status(job_id) not in ("PENDING", "RUNNING"):
                text = self.get_job_logs(job_id)
                if len(text) > seen:
                    yield text[seen:]
                return
            time.sleep(0.3)

"""Standalone head process — the GCS-server-analog entry point.

Reference: ``src/ray/gcs/gcs_server/gcs_server_main.cc`` — the reference
runs its cluster metadata service as a dedicated process precisely so it
can die and restart under the cluster.  This entry boots a driverless
head (``ray_tpu_torch.init`` with env-provided resources/config), optionally
runs a bootstrap script in-process, and then parks; agents and clients
dial its fixed TCP port.  With ``gcs_snapshot_path`` + ``listen_port`` +
``authkey_hex`` configured, killing this process and re-running it with
``gcs_restore`` is the head-failover drill the chaos harness
(``Cluster(external_head=True)`` + ``ChaosController.kill_head``)
automates.

Env contract (all optional unless noted):

- ``RAY_TPU_HEAD_NUM_CPUS`` / ``RAY_TPU_HEAD_NUM_TPUS`` — head node
  resources (default 0: the head schedules only onto agents).
- ``RAY_TPU_HEAD_SYSTEM_CONFIG`` — JSON ``_system_config`` dict; the
  failover drill sets listen_port/authkey_hex/gcs_snapshot_path here.
- ``RAY_TPU_HEAD_SCRIPT`` — python source exec'd after init with
  ``ray``/``rt`` in scope (test bootstrap: deploy serve apps, create
  named actors in-head).
- ``RAY_TPU_CHAOS`` — ``head:<point>:<n>`` rules arm deterministic
  self-kills at head syncpoints (``head:snapshot:n``,
  ``head:dispatch:n``); workers and agents arm theirs too, and
  so does the head process.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time


def main():
    from ray_tpu_torch._private import recovery

    # Arm head-role chaos rules BEFORE the runtime boots so boot-path
    # syncpoints (snapshot/dispatch during restore) can fire too.
    recovery.maybe_arm_env_chaos("head")

    import ray_tpu_torch

    num_cpus = int(os.environ.get("RAY_TPU_HEAD_NUM_CPUS", "0") or 0)
    num_tpus = int(os.environ.get("RAY_TPU_HEAD_NUM_TPUS", "0") or 0)
    cfg = json.loads(os.environ.get("RAY_TPU_HEAD_SYSTEM_CONFIG") or "{}")
    rt = ray_tpu_torch.init(num_cpus=num_cpus, num_tpus=num_tpus,
                      _system_config=cfg)

    script = os.environ.get("RAY_TPU_HEAD_SCRIPT")
    if script:
        exec(compile(script, "<head-script>", "exec"),  # noqa: S102 -- operator-provided bootstrap, same trust domain as this process
             {"ray": ray_tpu_torch, "ray_tpu_torch": ray_tpu_torch, "rt": rt})

    def _term(*_sig):
        ray_tpu_torch.shutdown()
        sys.exit(0)

    signal.signal(signal.SIGTERM, _term)
    # The READY line is the spawn protocol: cluster_utils waits for it
    # before letting agents/clients dial in.
    print("RAY_TPU_HEAD_READY", rt.tcp_address, flush=True)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()

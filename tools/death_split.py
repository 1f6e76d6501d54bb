#!/usr/bin/env python3
"""Split the death of a trainer's worker that kills itself right after it
reports a large checkpoint, on the CPU.

    python3 tools/death_split.py [rows]

One in-process head (``ray_tpu_torch.init(num_cpus=4)``) and a
one-worker ``DataParallelTrainer`` with ``FailureConfig(max_failures=1)``.
At step 2 the loop reports a checkpoint of three trees of CPU tensors
(params and two moments: a 32000 x 512 embedding and 48 rows x 2048
matrices each; ``rows`` defaults to 1024, about 1.35 GB in all), writes
its pid and the time, and kills itself with SIGKILL; ``fit()`` restarts
the group from that checkpoint for steps 3-4.  From the kill, on
``time.time()``'s clock, it prints when the worker turned into a zombie
(a poller process reading ``/proc``), when the head's reader handed its
EOF to ``_on_worker_death`` and when that returned, when the driver's
drain took the checkpoint out of the node store, and every gap of more
than 10 ms in a thread of the driver's process that sleeps 1 ms at a
time (a gap is a hold of the GIL, or the host's load).  The numbers are
host seconds on whatever CPU runs it.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

POLLER = r"""
import json, os, sys, time
hold, out = sys.argv[1], {}
while not os.path.exists(hold):
    time.sleep(0.0005)
time.sleep(0.01)
pid = json.load(open(hold))["pid"]
while True:
    try:
        with open("/proc/%d/stat" % pid) as f:
            st = f.read().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        out["gone"] = time.time()
        break
    if st in "ZX":
        out.setdefault("zombie", time.time())
    time.sleep(0.0005)
print(json.dumps(out))
"""


def loop(config):
    import json
    import os
    import signal
    import time

    import torch

    from ray_tpu_torch.air import Checkpoint, session

    start = session.get_checkpoint()
    first = 0 if start is None else start.to_dict()["step"]
    for i in range(first, 4):
        ckpt = None
        if i + 1 == 2:
            g = torch.Generator().manual_seed(0)

            def tree():
                t = {"emb": torch.randn(32000, 512, generator=g)}
                for layer in range(12):
                    for n in ("wq", "wo", "w1", "w2"):
                        t[f"{layer}.{n}"] = torch.randn(
                            config["rows"], 2048, generator=g)
                return t

            ckpt = Checkpoint.from_dict({"step": 2, "params": tree(),
                                         "mu": tree(), "nu": tree()})
        session.report({"step": i + 1, "pid": os.getpid()},
                       checkpoint=ckpt)
        if ckpt is not None and start is None:
            with open(config["hold"], "w") as f:
                json.dump({"pid": os.getpid(), "t_kill": time.time()}, f)
            os.kill(os.getpid(), signal.SIGKILL)


def main(rows: int) -> None:
    import ray_tpu_torch as ray
    from ray_tpu_torch._private import segment_stream
    from ray_tpu_torch.air import FailureConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.train import DataParallelTrainer, TorchConfig

    hold = os.path.join(tempfile.mkdtemp(prefix="death-split-"), "held")
    marks = {"take": []}
    take = segment_stream.take

    def timed_take(descr, copy_out):
        t0 = time.time()
        out = take(descr, copy_out)
        marks["take"].append((t0, time.time()))
        return out

    segment_stream.take = timed_take
    gaps, stop = [], threading.Event()

    def sleeper():
        last = time.time()
        while not stop.is_set():
            time.sleep(0.001)
            now = time.time()
            if now - last > 0.01:
                gaps.append((last, now))
            last = now

    threading.Thread(target=sleeper, daemon=True).start()
    poller = subprocess.Popen([sys.executable, "-c", POLLER, hold],
                              stdout=subprocess.PIPE, text=True)
    rt = ray.init(num_cpus=4)
    on_death = rt._on_worker_death

    def stamped(worker):
        t0 = time.time()
        on_death(worker)
        if worker.proc is not None:
            marks.setdefault(worker.proc.pid, (t0, time.time()))

    rt._on_worker_death = stamped
    try:
        result = DataParallelTrainer(
            loop, train_loop_config={"hold": hold, "rows": rows},
            backend_config=TorchConfig(distributed=False),
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(
                failure_config=FailureConfig(max_failures=1))).fit()
    finally:
        stop.set()
        ray.shutdown()
    seen = json.loads(poller.communicate(timeout=60)[0])
    with open(hold) as f:
        killed = json.load(f)
    t_kill = killed["t_kill"]
    eof, processed = marks.get(killed["pid"], (None, None))

    def rel(t):
        return None if t is None else t - t_kill

    print(f"steps {[h['step'] for h in result.metrics_history]}, "
          f"error {result.error}")
    print(f"from the kill: zombie {rel(seen.get('zombie'))} s, the head's "
          f"EOF {rel(eof)} s, death processed {rel(processed)} s, reaped "
          f"{rel(seen.get('gone'))} s")
    for a, b in marks["take"]:
        print(f"the drain's take: {rel(a)} s to {rel(b)} s")
    print("gaps over 10 ms within 1 s of the kill: "
          f"{[(rel(a), b - a) for a, b in gaps if abs(a - t_kill) < 1]}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024)

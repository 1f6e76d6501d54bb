"""Trial + TrialRunner: the Tune event loop (a copy of
``ray_tpu/tune/trial_runner.py``).

Reference: ``python/ray/tune/experiment/trial.py`` (Trial state machine) and
``tune/execution/trial_runner.py:1140`` (``step`` :1315 — the loop that
starts trials as actors, collects results, consults the scheduler, handles
failures/retries, and checkpoints the experiment for resume).  The actor
execution path condenses ``RayTrialExecutor``
(``tune/execution/ray_trial_executor.py:185``).
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as ray
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.schedulers import (
    CONTINUE, PAUSE, STOP, FIFOScheduler)
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher

PENDING, RUNNING, PAUSED, TERMINATED, ERRORED = (
    "PENDING", "RUNNING", "PAUSED", "TERMINATED", "ERROR")


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any]):
        self.trial_id = trial_id
        self.config = config
        self.status = PENDING
        self.actor = None
        self.last_result: Dict[str, Any] = {}
        self.results: List[Dict[str, Any]] = []
        self.latest_checkpoint: Optional[bytes] = None
        self.error: Optional[str] = None
        self.retries = 0
        self.pending_restore: Optional[tuple] = None  # (blob, new_config)

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status})"


class TrialRunner:
    def __init__(self, trainable_cls: type, *,
                 searcher: Searcher,
                 scheduler=None,
                 num_concurrent: int = 8,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 max_failures: int = 0,
                 stop: Optional[Dict[str, Any]] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0):
        self._cls = trainable_cls
        self._remote_cls = ray.remote(trainable_cls)
        self._searcher = searcher
        self._scheduler = scheduler or FIFOScheduler()
        self._num_concurrent = num_concurrent
        self._resources = resources_per_trial or {"CPU": 1.0}
        self._max_failures = max_failures
        self._stop = stop or {}
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = checkpoint_every
        self.trials: List[Trial] = []
        self._future_to_trial: Dict[Any, Trial] = {}
        self._restore_futures: Dict[str, Any] = {}
        self._exhausted = False
        self._iterations = 0

    # ------------------------------------------------------------- helpers
    def get_trial(self, trial_id: str) -> Optional[Trial]:
        for t in self.trials:
            if t.trial_id == trial_id:
                return t
        return None

    def transfer_checkpoint(self, donor: Trial, target: Trial,
                            new_config: Dict[str, Any]):
        """PBT exploit/explore: restore donor's checkpoint into target with
        a mutated config at its next boundary."""
        target.pending_restore = (donor.latest_checkpoint, new_config)

    def unpause_trial(self, trial: Trial):
        """Resume a PAUSED trial from its checkpoint (synchronous
        HyperBand promotion; reference: trial PAUSED -> RUNNING via
        choose_trial_to_run)."""
        if trial.status != PAUSED:
            return
        self._start_trial(trial)

    def stop_trial(self, trial: Trial):
        """Scheduler-initiated stop of a trial that is not currently
        reporting (e.g. a paused rung loser)."""
        if trial.status in (TERMINATED, ERRORED):
            return
        self._searcher.on_trial_complete(trial.trial_id,
                                         trial.last_result)
        self._terminate(trial, TERMINATED)

    def _make_actor(self, trial: Trial):
        res = dict(self._resources)
        cpu = res.pop("CPU", 1.0)
        tpu = res.pop("TPU", 0.0)
        opts = {"num_cpus": cpu, "resources": res or None}
        if tpu:
            opts["num_tpus"] = int(tpu)
        return self._remote_cls.options(**opts).remote(trial.config)

    def _start_trial(self, trial: Trial):
        trial.actor = self._make_actor(trial)
        trial.status = RUNNING
        if trial.latest_checkpoint is not None:
            # Async submit: per-actor FIFO guarantees restore runs
            # before train.  A blocking get here would wedge the whole
            # runner loop whenever the new actor waits for a CPU that a
            # still-running trial holds (the trial that would free it is
            # serviced by THIS loop).  The future is kept so a failed
            # restore surfaces as a trial error instead of silently
            # training from scratch.
            self._restore_futures[trial.trial_id] = \
                trial.actor.restore.remote(trial.latest_checkpoint)
        self._future_to_trial[trial.actor.train.remote()] = trial

    def _maybe_add_trials(self):
        while (not self._exhausted
               and sum(1 for t in self.trials
                       if t.status in (PENDING, RUNNING))
               < self._num_concurrent):
            # suggest() is keyed by the SAME id later passed to
            # on_trial_complete — model-based searchers match the two to
            # attach the observation to the suggested config.
            trial_id = f"trial_{len(self.trials):04d}"
            cfg = self._searcher.suggest(trial_id)
            if cfg is None:
                self._exhausted = True
                break
            trial = Trial(trial_id, cfg)
            self.trials.append(trial)
            self._scheduler.on_trial_add(self, trial)
            self._start_trial(trial)

    def _should_stop_trial(self, result: Dict[str, Any]) -> bool:
        if result.get("done"):
            return True
        for key, bound in self._stop.items():
            if key == "training_iteration":
                if result.get(key, 0) >= bound:
                    return True
            elif key in result and result[key] >= bound:
                return True
        return False

    def _terminate(self, trial: Trial, status: str):
        trial.status = status
        if trial.actor is not None:
            try:
                # Graceful-then-force (reference: ray_trial_executor stop
                # sequence): wait briefly for Trainable.cleanup() to run
                # before the kill, or user teardown may never execute.
                stop_fut = trial.actor.stop.remote()
                try:
                    ray.get(stop_fut, timeout=5.0)
                except Exception:
                    pass
                ray.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None

    # ---------------------------------------------------------------- loop
    def step(self):
        """One event-loop turn (reference: trial_runner.py:1315)."""
        self._maybe_add_trials()
        # Synchronous schedulers promote paused rungs here; must run
        # even with no futures in flight (a fully parked bracket would
        # otherwise spin forever).
        self._scheduler.on_step(self)
        if not self._future_to_trial:
            return
        done, _ = ray.wait(list(self._future_to_trial),
                           num_returns=1, timeout=10.0)
        for fut in done:
            trial = self._future_to_trial.pop(fut)
            try:
                result = ray.get(fut)
            except Exception as e:
                self._on_trial_error(trial, e)
                continue
            self._on_trial_result(trial, result)
        self._iterations += 1
        if self._ckpt_dir and self._ckpt_every and \
                self._iterations % self._ckpt_every == 0:
            self.save_experiment()

    def _on_trial_result(self, trial: Trial, result: Dict[str, Any]):
        rf = self._restore_futures.pop(trial.trial_id, None)
        if rf is not None:
            # The result arrived AFTER the restore (per-actor FIFO), so
            # this future is done; surface a failed checkpoint load as a
            # trial error — the result came from an UNRESTORED model.
            try:
                ray.get(rf, timeout=5.0)
            except Exception as e:
                self._on_trial_error(trial, e)
                return
        trial.last_result = result
        trial.results.append(result)
        # Checkpoint after every boundary so ASHA-stops and PBT-exploits
        # always have state to clone (perf: make configurable).
        try:
            trial.latest_checkpoint = ray.get(trial.actor.save.remote())
        except Exception:
            pass
        decision = self._scheduler.on_trial_result(self, trial, result)
        if self._should_stop_trial(result) or decision == STOP:
            self._scheduler.on_trial_complete(self, trial, result)
            self._searcher.on_trial_complete(trial.trial_id, result)
            self._terminate(trial, TERMINATED)
            return
        if decision == PAUSE:
            # Checkpoint already saved above; release the actor — the
            # scheduler promotes (unpause_trial) or stops the trial on a
            # later on_step.
            self._terminate(trial, PAUSED)
            return
        if trial.pending_restore is not None:
            blob, new_config = trial.pending_restore
            trial.pending_restore = None
            trial.config = new_config
            # Reuse actor if reset_config supports it, else replace.
            ok = False
            try:
                ok = ray.get(trial.actor.reset.remote(new_config))
            except Exception:
                ok = False
            if not ok:
                self._terminate(trial, PENDING)
                trial.latest_checkpoint = blob
                self._start_trial(trial)
                return
            ray.get(trial.actor.restore.remote(blob))
        self._future_to_trial[trial.actor.train.remote()] = trial

    def _on_trial_error(self, trial: Trial, err: Exception):
        if trial.retries < self._max_failures:
            trial.retries += 1
            self._terminate(trial, PENDING)
            self._start_trial(trial)  # restores latest_checkpoint
            return
        trial.error = str(err)
        # Synchronous schedulers must learn the trial is gone, or a
        # bracket would wait forever for its rung report.
        self._scheduler.on_trial_complete(self, trial, trial.last_result)
        self._terminate(trial, ERRORED)

    def is_finished(self) -> bool:
        return self._exhausted and not self._future_to_trial and all(
            t.status in (TERMINATED, ERRORED) for t in self.trials)

    def run(self):
        while not self.is_finished():
            self.step()
        if self._ckpt_dir:
            self.save_experiment()

    # ------------------------------------------------------ exp checkpoint
    def save_experiment(self):
        """Experiment-level checkpoint for resume (reference:
        TrialRunner.checkpoint + tune resume)."""
        os.makedirs(self._ckpt_dir, exist_ok=True)
        state = []
        for t in self.trials:
            state.append({
                "trial_id": t.trial_id, "config": t.config,
                "status": t.status, "last_result": t.last_result,
                "results": t.results, "error": t.error,
                "checkpoint": t.latest_checkpoint,
            })
        tmp = os.path.join(self._ckpt_dir, ".experiment_state.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, os.path.join(self._ckpt_dir, "experiment_state.pkl"))
        with open(os.path.join(self._ckpt_dir, "experiment_meta.json"),
                  "w") as f:
            json.dump({"num_trials": len(self.trials),
                       "time": time.time()}, f)

    def restore_experiment(self) -> int:
        """Re-load trial states; unfinished trials restart from their last
        checkpoint.  Returns number of restored trials."""
        path = os.path.join(self._ckpt_dir, "experiment_state.pkl")
        if not os.path.exists(path):
            return 0
        with open(path, "rb") as f:
            state = pickle.load(f)
        for st in state:
            t = Trial(st["trial_id"], st["config"])
            t.last_result = st["last_result"]
            t.results = st["results"]
            t.error = st["error"]
            t.latest_checkpoint = st["checkpoint"]
            t.status = st["status"]
            self.trials.append(t)
            if t.status not in (TERMINATED, ERRORED):
                t.status = PENDING
                self._start_trial(t)
        return len(state)

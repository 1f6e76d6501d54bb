"""Trial schedulers: early stopping and population-based training (a copy of
``ray_tpu/tune/schedulers.py``).

Reference: ``python/ray/tune/schedulers/`` — FIFO (default), ASHA
(``async_hyperband.py``), PBT (``pbt.py``).  Interface mirrors
``TrialScheduler.on_trial_result -> CONTINUE | STOP`` plus PBT's
exploit/explore via trial checkpoints.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"
PAUSE = "PAUSE"


class TrialScheduler:
    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, runner, trial, result: Dict[str, Any]):
        pass

    def on_trial_add(self, runner, trial):
        """Called when the runner starts a new trial (reference:
        TrialScheduler.on_trial_add)."""

    def on_step(self, runner):
        """Called once per runner loop turn — synchronous schedulers
        promote paused trials here (reference: choose_trial_to_run)."""


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: schedulers/async_hyperband.py): successive-halving
    rungs; a trial reaching a rung survives only if in the top 1/rf of
    completed results at that rung."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4.0, brackets: int = 1):
        self._metric = metric
        self._mode = mode
        self._max_t = max_t
        self._grace = grace_period
        self._rf = reduction_factor
        # rung milestones: grace * rf^k below max_t
        self._milestones: List[int] = []
        t = grace_period
        while t < max_t:
            self._milestones.append(int(t))
            t *= reduction_factor
        self._rungs: Dict[int, List[float]] = {m: [] for m in self._milestones}

    def _val(self, result):
        v = result.get(self._metric)
        if v is None:
            return None
        return float(v) if self._mode == "max" else -float(v)

    def on_trial_result(self, runner, trial, result) -> str:
        t = result.get("training_iteration", 0)
        v = self._val(result)
        if v is None:
            return CONTINUE
        if t >= self._max_t:
            return STOP
        for m in self._milestones:
            if t == m:
                rung = self._rungs[m]
                rung.append(v)
                cutoff_idx = max(0, math.ceil(len(rung) / self._rf) - 1)
                cutoff = sorted(rung, reverse=True)[cutoff_idx]
                if v < cutoff:
                    return STOP
        return CONTINUE


class HyperBandScheduler(TrialScheduler):
    """Synchronous HyperBand (reference: schedulers/hyperband.py).

    Trials fill a bracket as they arrive; every bracket member PAUSES at
    the bracket's current milestone, and once the whole bracket is
    parked the top 1/eta are promoted (unpaused with an eta-times larger
    budget) while the rest stop — classic successive halving, but
    SYNCHRONOUS: promotion decisions see the complete rung, unlike
    ASHA's running cutoffs."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 81, reduction_factor: float = 3.0,
                 bracket_size: int = 9, grace_period: int = 1):
        self._metric = metric
        self._mode = mode
        self._max_t = max_t
        self._eta = reduction_factor
        self._bracket_size = bracket_size
        self._grace = grace_period
        # bracket: {"trials": {tid: score}, "milestone": int,
        #           "paused": set, "done": set}
        self._brackets: List[Dict[str, Any]] = []
        self._trial_bracket: Dict[str, int] = {}

    def _val(self, result):
        v = result.get(self._metric)
        if v is None:
            return None
        return float(v) if self._mode == "max" else -float(v)

    def _bracket_of(self, trial) -> Dict[str, Any]:
        bi = self._trial_bracket.get(trial.trial_id)
        if bi is None:
            if (not self._brackets
                    or len(self._brackets[-1]["trials"])
                    >= self._bracket_size):
                self._brackets.append({
                    "trials": {}, "milestone": self._grace,
                    "paused": set(), "done": set()})
            bi = len(self._brackets) - 1
            self._trial_bracket[trial.trial_id] = bi
            self._brackets[bi]["trials"][trial.trial_id] = None
        return self._brackets[bi]

    def on_trial_add(self, runner, trial):
        # Membership binds at START: a promotion decision must see the
        # whole bracket, not just the trials that happened to report
        # first (a fast trial would otherwise get promoted alone).
        self._bracket_of(trial)

    def on_trial_result(self, runner, trial, result) -> str:
        br = self._bracket_of(trial)
        v = self._val(result)
        if v is not None:
            br["trials"][trial.trial_id] = v
        t = result.get("training_iteration", 0)
        if t >= self._max_t:
            br["done"].add(trial.trial_id)
            return STOP
        if t >= br["milestone"]:
            br["paused"].add(trial.trial_id)
            return PAUSE
        return CONTINUE

    def on_trial_complete(self, runner, trial, result):
        bi = self._trial_bracket.get(trial.trial_id)
        if bi is not None:
            self._brackets[bi]["done"].add(trial.trial_id)

    def on_step(self, runner):
        for br in self._brackets:
            live = set(br["trials"]) - br["done"]
            if not live or not live <= br["paused"]:
                continue  # someone still running (or bracket finished)
            # Whole rung parked: promote the top 1/eta.
            ranked = sorted(
                live,
                key=lambda tid: (br["trials"][tid]
                                 if br["trials"][tid] is not None
                                 else float("-inf")),
                reverse=True)
            keep = ranked[:max(1, math.ceil(len(ranked) / self._eta))]
            br["milestone"] = min(self._max_t,
                                  int(br["milestone"] * self._eta))
            for tid in ranked:
                trial = runner.get_trial(tid)
                if trial is None:
                    br["done"].add(tid)
                    continue
                if tid in keep:
                    br["paused"].discard(tid)
                    runner.unpause_trial(trial)
                else:
                    br["done"].add(tid)
                    br["paused"].discard(tid)
                    runner.stop_trial(trial)


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result is worse than the median of other
    trials' running averages at the same step (reference:
    schedulers/median_stopping_rule.py)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 grace_period: int = 4, min_samples_required: int = 3):
        self._metric = metric
        self._mode = mode
        self._grace = grace_period
        self._min_samples = min_samples_required
        # trial_id -> list of values (one per reported iteration)
        self._histories: Dict[str, List[float]] = {}

    def _val(self, result):
        v = result.get(self._metric)
        if v is None:
            return None
        return float(v) if self._mode == "max" else -float(v)

    def on_trial_result(self, runner, trial, result) -> str:
        v = self._val(result)
        if v is None:
            return CONTINUE
        hist = self._histories.setdefault(trial.trial_id, [])
        hist.append(v)
        t = result.get("training_iteration", len(hist))
        if t < self._grace:
            return CONTINUE
        # Other trials may trail this one (async execution): compare
        # against their running means over whatever they have reported,
        # floored at the grace period so one fast trial can still be
        # judged (reference computes the mean at step t; requiring
        # len(h) >= t would exempt the fastest trial forever).
        others = [h for tid, h in self._histories.items()
                  if tid != trial.trial_id and len(h) >= self._grace]
        if len(others) < self._min_samples:
            return CONTINUE
        running_means = sorted(
            sum(h[:t]) / min(t, len(h)) for h in others)
        median = running_means[len(running_means) // 2]
        if max(hist) < median:
            return STOP
        return CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: schedulers/pbt.py): at each perturbation interval,
    bottom-quantile trials clone the checkpoint of a top-quantile trial
    (exploit) and perturb its hyperparameters (explore)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self._metric = metric
        self._mode = mode
        self._interval = perturbation_interval
        self._mutations = hyperparam_mutations or {}
        self._quantile = quantile_fraction
        self._resample_prob = resample_probability
        self._rng = random.Random(seed)
        self._last_scores: Dict[str, float] = {}
        self._last_perturb: Dict[str, int] = {}

    def _val(self, result):
        v = float(result[self._metric])
        return v if self._mode == "max" else -v

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        new = dict(config)
        for key, mut in self._mutations.items():
            if self._rng.random() < self._resample_prob or key not in new:
                if callable(mut):
                    new[key] = mut()
                elif isinstance(mut, list):
                    new[key] = self._rng.choice(mut)
            else:
                factor = self._rng.choice([0.8, 1.2])
                if isinstance(mut, list):
                    new[key] = self._rng.choice(mut)
                else:
                    new[key] = new[key] * factor
        return new

    def on_trial_result(self, runner, trial, result) -> str:
        if self._metric not in result:
            return CONTINUE
        t = result.get("training_iteration", 0)
        self._last_scores[trial.trial_id] = self._val(result)
        if t - self._last_perturb.get(trial.trial_id, 0) < self._interval:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        scores = self._last_scores
        if len(scores) < 2:
            return CONTINUE
        ranked = sorted(scores, key=scores.get, reverse=True)
        k = max(1, int(len(ranked) * self._quantile))
        top, bottom = ranked[:k], ranked[-k:]
        if trial.trial_id not in bottom or trial.trial_id in top:
            return CONTINUE
        donor_id = self._rng.choice(top)
        donor = runner.get_trial(donor_id)
        if donor is None or donor.latest_checkpoint is None:
            return CONTINUE
        # Exploit + explore: runner clones donor checkpoint into this trial
        # with a mutated config (reference: pbt.py _exploit).
        new_config = self._explore(donor.config)
        runner.transfer_checkpoint(donor, trial, new_config)
        return CONTINUE

"""ray_tpu_torch.tune — trial orchestration / HPO (Ray Tune equivalent; a
copy of ``ray_tpu/tune/__init__.py`` on the port's runtime and ``air``).

Reference: ``python/ray/tune/`` (SURVEY.md §2.3, 43k LoC) — ``tune.run``
(:185), ``Tuner`` (tuner.py:47), trials as Trainable actors, schedulers
(ASHA/PBT/...), searchers, experiment checkpointing.  Condensed here to the
same moving parts: search.py (spaces + variant generation), trainable.py
(class/function API), schedulers.py (FIFO/ASHA/PBT), trial_runner.py (event
loop + experiment checkpoint/resume).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.result import Result
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator, OptunaSearch, Searcher, TPESearcher, choice,
    grid_search, loguniform, randint, sample_from, uniform,
)
from ray_tpu_torch.tune.schedulers import (
    AsyncHyperBandScheduler, FIFOScheduler, HyperBandScheduler,
    MedianStoppingRule, PopulationBasedTraining, TrialScheduler,
)
from ray_tpu_torch.tune.trainable import Trainable, wrap_function
from ray_tpu_torch.tune.trial_runner import Trial, TrialRunner


class TuneConfig:
    """Reference: python/ray/tune/tune_config.py."""

    def __init__(self, metric: str = None, mode: str = "max",
                 num_samples: int = 1, scheduler=None, search_alg=None,
                 max_concurrent_trials: int = 8, seed=None):
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.scheduler = scheduler
        self.search_alg = search_alg
        self.max_concurrent_trials = max_concurrent_trials
        self.seed = seed


class ResultGrid:
    """Reference: python/ray/tune/result_grid.py."""

    def __init__(self, trials, metric=None, mode="max"):
        self.trials = trials
        self._metric = metric
        self._mode = mode

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        sign = 1 if mode == "max" else -1
        best = max(
            (t for t in self.trials if metric in t.last_result),
            key=lambda t: sign * t.last_result[metric])
        from ray_tpu_torch.air.checkpoint import Checkpoint
        ckpt = (Checkpoint.from_bytes(best.latest_checkpoint)
                if best.latest_checkpoint else None)
        return Result(metrics=best.last_result, checkpoint=ckpt,
                      metrics_history=best.results)

    @property
    def num_errors(self):
        return sum(1 for t in self.trials if t.error)

    def __len__(self):
        return len(self.trials)


class Tuner:
    """Reference: python/ray/tune/tuner.py:47."""

    def __init__(self, trainable, *, param_space: Optional[Dict] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config=None,
                 resources_per_trial: Optional[Dict[str, float]] = None):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config
        self._resources = resources_per_trial

    def fit(self) -> ResultGrid:
        tc = self._tune_config
        trainable = self._trainable
        restore_path = getattr(self, "_restore_path", None)
        if not (inspect.isclass(trainable)
                and issubclass(trainable, Trainable)):
            if hasattr(trainable, "as_trainable"):
                trainable = wrap_function(trainable.as_trainable())
            else:
                trainable = wrap_function(trainable)
        searcher = tc.search_alg or BasicVariantGenerator(
            self._param_space, num_samples=tc.num_samples, seed=tc.seed)
        stop = {}
        ckpt_dir = None
        max_failures = 0
        if self._run_config is not None:
            stop = self._run_config.stop or {}
            ckpt_dir = self._run_config.storage_path
            if self._run_config.failure_config:
                max_failures = self._run_config.failure_config.max_failures
        runner = TrialRunner(
            trainable, searcher=searcher, scheduler=tc.scheduler,
            num_concurrent=tc.max_concurrent_trials,
            resources_per_trial=self._resources,
            max_failures=max_failures, stop=stop,
            checkpoint_dir=restore_path or ckpt_dir, checkpoint_every=10)
        if restore_path:
            # Resume: reload trial states; finished trials stay terminated,
            # unfinished ones restart from their latest checkpoint.
            restored = runner.restore_experiment()
            if restored:
                runner._exhausted = True  # don't re-suggest restored configs
        runner.run()
        return ResultGrid(runner.trials, tc.metric, tc.mode)

    @classmethod
    def restore(cls, path: str, trainable, *,
                tune_config: Optional[TuneConfig] = None,
                run_config=None) -> "Tuner":
        """Resume a checkpointed experiment (reference: Tuner.restore)."""
        t = cls(trainable, tune_config=tune_config, run_config=run_config)
        t._restore_path = path
        return t


def run(trainable, *, config: Optional[Dict[str, Any]] = None,
        num_samples: int = 1, scheduler=None, search_alg=None, stop=None,
        metric: Optional[str] = None, mode: str = "max",
        max_concurrent_trials: int = 8,
        resources_per_trial: Optional[Dict[str, float]] = None,
        storage_path: Optional[str] = None, seed=None) -> ResultGrid:
    """Functional entry point (reference: tune.run, tune.py:185)."""
    from ray_tpu_torch.air.config import RunConfig
    tuner = Tuner(
        trainable, param_space=config,
        tune_config=TuneConfig(metric=metric, mode=mode,
                               num_samples=num_samples, scheduler=scheduler,
                               search_alg=search_alg,
                               max_concurrent_trials=max_concurrent_trials,
                               seed=seed),
        run_config=RunConfig(stop=stop, storage_path=storage_path),
        resources_per_trial=resources_per_trial)
    return tuner.fit()


__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "run", "Trainable",
    "wrap_function", "Trial",
    "TrialRunner", "choice", "uniform", "loguniform", "randint",
    "grid_search", "sample_from", "BasicVariantGenerator", "Searcher",
    "TPESearcher", "OptunaSearch", "TrialScheduler", "FIFOScheduler",
    "AsyncHyperBandScheduler", "HyperBandScheduler",
    "MedianStoppingRule", "PopulationBasedTraining",
]

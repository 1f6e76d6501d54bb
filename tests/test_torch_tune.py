"""The reference's Tune cases (``tests/test_tune.py``) run against the
port's copy of tune (``ray_tpu_torch.tune``: the trial runner, searchers,
schedulers, ``Tuner`` and ``run``), unchanged but for the package and
local fixtures; and, in the slow lane, ``tests/test_rllib.py``'s
``test_algorithm_is_tunable`` on the port's PPO (its learner on the CPU).

The trainables run in workers, which import this module to unpickle them:
it imports neither torch nor jax at its top.
"""

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch import tune
from ray_tpu_torch.tune import (
    AsyncHyperBandScheduler, PopulationBasedTraining, Trainable, Tuner,
    TuneConfig,
)
from ray_tpu_torch.air.config import RunConfig, FailureConfig


@pytest.fixture
def ray6():
    rt = ray.init(num_cpus=6)
    yield rt
    ray.shutdown()


class Quadratic(Trainable):
    """score converges to -(x - 3)^2 style optimum; iterative."""

    def setup(self, config):
        self.x = config["x"]
        self.lr = config.get("lr", 0.1)
        self.w = 0.0

    def step(self):
        # gradient ascent on -(w - x)^2: optimum score 0 at w == x
        self.w += self.lr * 2 * (self.x - self.w)
        return {"score": -((self.w - self.x) ** 2), "w": self.w}

    def save_checkpoint(self):
        return {"w": self.w, "x": self.x, "lr": self.lr}

    def load_checkpoint(self, state):
        self.w = state["w"]
        self.x = state["x"]
        self.lr = state["lr"]


def test_grid_and_random_search(ray6):
    grid = tune.run(
        Quadratic,
        config={"x": tune.grid_search([1.0, 2.0]),
                "lr": tune.uniform(0.05, 0.2)},
        num_samples=2, stop={"training_iteration": 3},
        metric="score", mode="max")
    assert len(grid) == 4  # 2 grid points x 2 samples
    best = grid.get_best_result()
    assert "score" in best.metrics
    assert grid.num_errors == 0


def test_function_trainable_generator(ray6):
    def my_fn(config):
        for i in range(4):
            yield {"value": config["a"] * (i + 1)}

    grid = tune.run(my_fn, config={"a": tune.grid_search([2, 5])},
                    stop={"training_iteration": 4},
                    metric="value", mode="max")
    best = grid.get_best_result()
    assert best.metrics["value"] == 20


def test_asha_rung_logic_deterministic():
    """Drive the scheduler directly with a fixed arrival order (ASHA's
    stop decision depends on arrival order, so the integration-level
    'someone was stopped' assertion is inherently racy)."""
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP
    scheduler = AsyncHyperBandScheduler(
        metric="score", mode="max", max_t=12, grace_period=2,
        reduction_factor=2)
    # Best-first arrival at the rung t=2: later, worse trials must stop.
    assert scheduler.on_trial_result(
        None, "t0", {"training_iteration": 2, "score": 10.0}) == CONTINUE
    assert scheduler.on_trial_result(
        None, "t1", {"training_iteration": 2, "score": 9.0}) == STOP
    assert scheduler.on_trial_result(
        None, "t2", {"training_iteration": 2, "score": 11.0}) == CONTINUE
    # Reaching max_t stops unconditionally.
    assert scheduler.on_trial_result(
        None, "t0", {"training_iteration": 12, "score": 10.0}) == STOP


def test_asha_integration_completes(ray6):
    scheduler = AsyncHyperBandScheduler(
        metric="score", mode="max", max_t=12, grace_period=2,
        reduction_factor=2)
    grid = tune.run(
        Quadratic,
        config={"x": tune.grid_search([0.1, 0.2, 4.0, 5.0]), "lr": 0.3},
        scheduler=scheduler, stop={"training_iteration": 12},
        metric="score", mode="max", max_concurrent_trials=4)
    iters = {t.trial_id: t.last_result.get("training_iteration", 0)
             for t in grid.trials}
    assert max(iters.values()) == 12           # someone ran to completion
    assert grid.num_errors == 0


def test_pbt_transfers_checkpoints(ray6):
    scheduler = PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.05, 0.1, 0.3]}, seed=0,
        quantile_fraction=0.34)
    grid = tune.run(
        Quadratic,
        config={"x": tune.grid_search([0.0, 2.0, 6.0]), "lr": 0.1},
        scheduler=scheduler, stop={"training_iteration": 10},
        metric="score", mode="max", max_concurrent_trials=3)
    assert grid.num_errors == 0
    assert len(grid) == 3
    # PBT must have cloned at least one good config into a bad trial:
    # trials' final x values need not match their initial grid x.
    final_x = sorted(t.last_result["w"] for t in grid.trials)
    assert all("score" in t.last_result for t in grid.trials)


def test_experiment_checkpoint_and_resume(ray6, tmp_path):
    grid = tune.run(
        Quadratic, config={"x": tune.grid_search([1.0, 2.0]), "lr": 0.2},
        stop={"training_iteration": 3}, metric="score", mode="max",
        storage_path=str(tmp_path))
    assert (tmp_path / "experiment_state.pkl").exists()
    # restore into a fresh runner: all trials come back terminated
    from ray_tpu_torch.tune.trial_runner import TrialRunner
    from ray_tpu_torch.tune.search import BasicVariantGenerator
    runner = TrialRunner(
        Quadratic, searcher=BasicVariantGenerator({}, num_samples=0),
        checkpoint_dir=str(tmp_path))
    n = runner.restore_experiment()
    assert n == 2
    assert all(t.status == "TERMINATED" for t in runner.trials)
    assert all(t.latest_checkpoint is not None for t in runner.trials)


class Flaky(Trainable):
    def setup(self, config):
        self.crash_at = config.get("crash_at", -1)

    def step(self):
        import os
        if self.iteration + 1 == self.crash_at and \
                not os.path.exists(self._flag_path()):
            open(self._flag_path(), "w").write("x")
            os._exit(1)
        return {"score": float(self.iteration)}

    def _flag_path(self):
        import tempfile
        return f"{tempfile.gettempdir()}/rtpu_torch_flaky_{self.config['tag']}"

    def save_checkpoint(self):
        return {}


def test_trial_failure_retry(ray6, tmp_path):
    import os, tempfile
    tag = os.path.basename(str(tmp_path))
    flag = f"{tempfile.gettempdir()}/rtpu_torch_flaky_{tag}"
    if os.path.exists(flag):
        os.remove(flag)
    grid = tune.run(
        Flaky, config={"crash_at": 2, "tag": tag},
        stop={"training_iteration": 4}, metric="score", mode="max")
    try:
        assert grid.num_errors == 0 or grid.trials[0].retries == 0
    finally:
        if os.path.exists(flag):
            os.remove(flag)
    # with retries enabled the trial must finish
    if os.path.exists(flag):
        os.remove(flag)
    tuner = Tuner(
        Flaky, param_space={"crash_at": 2, "tag": tag + "b"},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(stop={"training_iteration": 4},
                             failure_config=FailureConfig(max_failures=2)))
    grid2 = tuner.fit()
    assert grid2.num_errors == 0
    assert grid2.trials[0].last_result["training_iteration"] == 4


def test_tuner_restore_resumes(ray6, tmp_path):
    """Tuner.restore must reload saved trials instead of re-running."""
    tune.run(
        Quadratic, config={"x": tune.grid_search([1.0, 2.0]), "lr": 0.2},
        stop={"training_iteration": 3}, metric="score", mode="max",
        storage_path=str(tmp_path))
    tuner = Tuner.restore(str(tmp_path), Quadratic,
                          tune_config=TuneConfig(metric="score", mode="max"))
    grid = tuner.fit()
    assert len(grid) == 2
    assert all(t.status == "TERMINATED" for t in grid.trials)
    assert grid.get_best_result().metrics["score"] <= 0.0


def cartpole():
    import gymnasium
    return gymnasium.make("CartPole-v1")


@pytest.mark.slow  # as the reference's: tune.run wiring is tier-1 above
def test_algorithm_is_tunable(ray6):
    """Reference: every Algorithm inherits Tune's Trainable — tune.run(PPO)
    works (rllib/algorithms/algorithm.py:146)."""
    from ray_tpu_torch.rllib import PPO

    grid = tune.run(
        PPO,
        config={"env_maker": cartpole, "num_rollout_workers": 1,
                "rollout_fragment_length": 64, "learner_device": "cpu",
                "lr": tune.grid_search([1e-3, 3e-3])},
        stop={"training_iteration": 2}, metric="num_env_steps_sampled",
        mode="max", max_concurrent_trials=2)
    assert len(grid) == 2
    assert grid.num_errors == 0

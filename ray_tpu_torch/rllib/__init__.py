"""ray_tpu_torch.rllib — the RL training library's on-policy stack
(counterpart: ``ray_tpu.rllib``).

The new Learner stack of the reference (``rllib/core/learner``): CPU
rollout-worker actors (no card) feed a Learner whose update runs on the
card — in the driver, or in an actor granted the card
(``resources(remote_learner=True, learner_num_tpus=1)``).  Algorithms:
PPO (sync on-policy), IMPALA (async, V-trace, the pinned-memory
host->device learner queue) and APPO (IMPALA's pipeline with PPO's
clipped surrogate against a target network).

Not ported yet (ROADMAP.md Queue 1, item 7): DQN, SAC, the replay
buffers, offline RL (BC, MARWIL, CQL, the JSON reader/writer and the
importance-sampling estimators) and multi-agent (``MultiAgentEnv`` and
its workers, and PPO's multi-agent branch).
"""

import importlib as _importlib

# name -> submodule.  Loaded on first use: a CPU worker that unpickles a
# SampleBatch or an env imports no torch.
_NAMES = {
    "SampleBatch": "sample_batch", "concat_batches": "sample_batch",
    "ActorCriticMLP": "models", "RolloutWorker": "rollout_worker",
    "WorkerSet": "rollout_worker", "Learner": "learner",
    "LearnerGroup": "learner", "Algorithm": "algorithm",
    "AlgorithmConfig": "algorithm", "PPO": "ppo", "PPOConfig": "ppo",
    "Impala": "impala", "ImpalaConfig": "impala", "APPO": "appo",
    "APPOConfig": "appo", "VectorEnv": "env",
}


def __getattr__(name):
    if name in _NAMES:
        return getattr(_importlib.import_module(
            f"{__name__}.{_NAMES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_NAMES)

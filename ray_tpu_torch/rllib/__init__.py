"""ray_tpu_torch.rllib — the RL training library (counterpart:
``ray_tpu.rllib``).

The new Learner stack of the reference (``rllib/core/learner``): CPU
rollout-worker actors (no card) feed learners whose updates run on the
card — in the driver, or in an actor granted the card
(``resources(remote_learner=True, learner_num_tpus=1)``).  Algorithms:
PPO (sync on-policy, single- and multi-agent), IMPALA (async, V-trace,
the pinned-memory host->device learner queue), APPO (IMPALA's pipeline
with PPO's clipped surrogate against a target network), DQN and SAC
(off-policy, replay actors), and BC, MARWIL and CQL (offline, from the
JSON reader), with the IS/WIS off-policy estimators.
"""

import importlib as _importlib

# name -> submodule.  Loaded on first use: a CPU worker that unpickles a
# SampleBatch or an env (a MultiAgentEnv too) imports no torch.
_NAMES = {
    "SampleBatch": "sample_batch", "concat_batches": "sample_batch",
    "ActorCriticMLP": "models", "RolloutWorker": "rollout_worker",
    "WorkerSet": "rollout_worker", "Learner": "learner",
    "LearnerGroup": "learner", "Algorithm": "algorithm",
    "AlgorithmConfig": "algorithm", "PPO": "ppo", "PPOConfig": "ppo",
    "Impala": "impala", "ImpalaConfig": "impala", "APPO": "appo",
    "APPOConfig": "appo", "VectorEnv": "env", "DQN": "dqn",
    "DQNConfig": "dqn", "SAC": "sac", "SACConfig": "sac",
    "ReplayBuffer": "replay_buffers",
    "PrioritizedReplayBuffer": "replay_buffers",
    "ReplayActor": "replay_buffers", "MultiAgentEnv": "multi_agent",
    "MultiAgentBatch": "multi_agent",
    "MultiAgentRolloutWorker": "multi_agent",
    "MultiAgentWorkerSet": "multi_agent", "BC": "offline",
    "BCConfig": "offline", "MARWIL": "offline", "MARWILConfig": "offline",
    "CQL": "offline", "CQLConfig": "offline", "JsonReader": "offline",
    "JsonWriter": "offline", "ImportanceSampling": "offline",
    "WeightedImportanceSampling": "offline",
}


def __getattr__(name):
    if name in _NAMES:
        return getattr(_importlib.import_module(
            f"{__name__}.{_NAMES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_NAMES)

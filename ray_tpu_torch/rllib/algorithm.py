"""Algorithm base: every RL algorithm is a Tune Trainable (a copy of
``ray_tpu/rllib/algorithm.py`` on the port's ``tune.trainable``, with the
learner's device as a resource).

Reference: ``rllib/algorithms/algorithm.py:146`` (``Algorithm(Trainable)``,
``setup`` :478, ``step`` :731) + the 3239-LoC fluent ``AlgorithmConfig`` —
``config.build().train()`` and ``tune.run(PPO, config=...)`` both work, and
``train()`` is inherited from the Tune Trainable
(``python/ray/tune/trainable/trainable.py:343``).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.tune.trainable import Trainable


class AlgorithmConfig:
    """Fluent builder (reference: rllib/algorithms/algorithm_config.py)."""

    algo_class: Optional[type] = None

    def __init__(self):
        self.env_maker: Optional[Callable] = None
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 200
        self.gamma = 0.99
        self.lr = 3e-4
        self.train_batch_size = 4000
        self.model = {"hidden": (64, 64)}
        self.seed = 0
        self.learner_num_tpus = 0
        self.remote_learner = False
        self.num_learners = 0
        # The learner's device: None is the card (a remote learner's
        # granted card); "cpu" only when the caller names it.
        self.learner_device: Optional[str] = None
        # Multi-agent (reference: config.multi_agent(...)): empty =
        # single-agent.
        self.policies: Dict[str, Any] = {}
        self.policy_mapping_fn: Optional[Callable] = None

    # -- fluent sections (reference: .environment/.rollouts/.training) ----
    def environment(self, env_maker: Callable) -> "AlgorithmConfig":
        self.env_maker = env_maker
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None
                 ) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def multi_agent(self, *, policies: Optional[Dict[str, Any]] = None,
                    policy_mapping_fn: Optional[Callable] = None
                    ) -> "AlgorithmConfig":
        """Reference: AlgorithmConfig.multi_agent (algorithm_config.py) —
        ``policies`` maps policy_id -> model-config dict (or None to
        infer from the env's spaces); ``policy_mapping_fn(agent_id) ->
        policy_id`` routes agents."""
        if policies is not None:
            self.policies = policies
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def resources(self, *, learner_num_tpus: Optional[int] = None,
                  remote_learner: Optional[bool] = None,
                  num_learners: Optional[int] = None,
                  learner_device: Optional[str] = None
                  ) -> "AlgorithmConfig":
        if learner_device is not None:
            self.learner_device = learner_device
        if learner_num_tpus is not None:
            self.learner_num_tpus = learner_num_tpus
        if remote_learner is not None:
            self.remote_learner = remote_learner
        if num_learners is not None:
            # num_learners>1 data-parallelizes the update over N
            # replicas of the learner's params (learner_group.py:51
            # scaling config; see learner.py).
            self.num_learners = num_learners
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()}

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config class has no algo_class")
        return self.algo_class(config={"__algo_config__": self})


class Algorithm(Trainable):
    """config dict may carry {"__algo_config__": AlgorithmConfig} (built
    path) or plain keys overriding the default config (tune path)."""

    config_class: type = AlgorithmConfig

    def setup(self, config: Dict[str, Any]):
        ac = config.get("__algo_config__")
        if ac is None:
            ac = self.config_class()
            for k, v in config.items():
                if hasattr(ac, k):
                    setattr(ac, k, v)
        self.algo_config = ac
        self._setup(ac)

    def _setup(self, cfg: AlgorithmConfig):
        raise NotImplementedError

    def step(self) -> Dict[str, Any]:
        return self.training_step()

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

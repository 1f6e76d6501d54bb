"""Vectorized environment wrappers (a copy of ``ray_tpu/rllib/env.py``).

Reference: ``rllib/env/vector_env.py`` (VectorEnv / VectorEnvWrapper) — N
sub-environments stepped as one batched env with auto-reset, so policy
forward passes batch across envs (the rollout hot loop's vectorization).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np


class VectorEnv:
    """Synchronous vectorization over gymnasium-style envs with auto-reset.

    ``vector_step`` returns the *pre-reset* terminal observation in
    ``final_obs`` for bootstrapping (the gymnasium autoreset convention),
    while ``obs`` always holds the observation to act on next.
    """

    def __init__(self, env_maker: Callable[[], Any], num_envs: int,
                 seed: Optional[int] = None):
        self.envs: List[Any] = [env_maker() for _ in range(num_envs)]
        self.num_envs = num_envs
        first = self.envs[0]
        self.observation_space = first.observation_space
        self.action_space = first.action_space
        self._seed = seed

    def vector_reset(self) -> np.ndarray:
        obs = []
        for i, e in enumerate(self.envs):
            kw = {}
            if self._seed is not None:
                kw["seed"] = self._seed + i
            obs.append(e.reset(**kw)[0])
        return np.stack(obs).astype(np.float32)

    def vector_step(self, actions) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray, np.ndarray,
                                            np.ndarray, list]:
        """-> (next_obs [auto-reset], rewards, terminated, truncated,
        final_obs, infos).  Terminated and truncated stay separate — value
        bootstrapping must continue through time-limit truncations
        (the classic time-limit bias; the reference carries both flags)."""
        discrete = hasattr(self.action_space, "n")
        obs, rews, terms, truncs, finals, infos = [], [], [], [], [], []
        for e, a in zip(self.envs, actions):
            if discrete and (np.isscalar(a) or getattr(a, "ndim", 1) == 0):
                a = int(a)
            o, r, term, trunc, info = e.step(a)
            finals.append(o)
            if term or trunc:
                o = e.reset()[0]
            obs.append(o)
            rews.append(r)
            terms.append(bool(term))
            truncs.append(bool(trunc))
            infos.append(info)
        return (np.stack(obs).astype(np.float32),
                np.asarray(rews, np.float32),
                np.asarray(terms, bool),
                np.asarray(truncs, bool),
                np.stack(finals).astype(np.float32),
                infos)

    def close(self):
        for e in self.envs:
            if hasattr(e, "close"):
                try:
                    e.close()
                except Exception:
                    pass

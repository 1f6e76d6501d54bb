"""SampleBatch: dict-of-arrays experience container (a copy of
``ray_tpu/rllib/sample_batch.py``).

Reference: ``rllib/policy/sample_batch.py`` — same core surface (column
access, len, concat, minibatch iteration, shuffle).  Arrays are numpy on
the rollout side; the learner copies each column to its device once per
update.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "new_obs"
LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"


class SampleBatch(dict):
    def __len__(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @property
    def count(self) -> int:
        return len(self)

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        idx = rng.permutation(len(self))
        return SampleBatch({k: v[idx] for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = len(self)
        for start in range(0, n - size + 1, size):
            yield SampleBatch({k: v[start:start + size]
                               for k, v in self.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})


def concat_batches(batches: List[SampleBatch]) -> SampleBatch:
    keys = batches[0].keys()
    return SampleBatch({k: np.concatenate([b[k] for b in batches])
                        for k in keys})

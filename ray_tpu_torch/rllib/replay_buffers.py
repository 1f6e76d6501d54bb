"""Replay buffers: uniform + prioritized (proportional, sum-tree); a copy
of ``ray_tpu/rllib/replay_buffers.py`` (numpy only: ``ReplayActor`` runs in
a CPU actor and imports no torch).

Reference: ``rllib/utils/replay_buffers/replay_buffer.py`` and
``prioritized_replay_buffer.py`` (proportional prioritization per
Schaul et al. 2015, with a segment tree for O(log n) sampling) — same
semantics here with a numpy sum-tree.  ``ReplayActor`` hosts a buffer in
its own process so many rollout workers can push concurrently while the
learner samples (the Ape-X pattern, ``rllib/algorithms/apex_dqn``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

import ray_tpu_torch as ray
from ray_tpu_torch.rllib.sample_batch import SampleBatch, concat_batches

BATCH_INDEXES = "batch_indexes"
WEIGHTS = "weights"


class ReplayBuffer:
    """Uniform FIFO ring buffer over SampleBatch rows."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = capacity
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def _ensure(self, batch: SampleBatch):
        if self._cols:
            return
        for k, v in batch.items():
            v = np.asarray(v)
            self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                     v.dtype)

    def add(self, batch: SampleBatch):
        self._ensure(batch)
        n = len(batch)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, col in self._cols.items():
            col[idx] = np.asarray(batch[k])
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        return idx

    def sample(self, num_items: int) -> SampleBatch:
        if self._size == 0:
            raise ValueError("cannot sample from an empty replay buffer")
        idx = self._rng.integers(0, self._size, size=num_items)
        out = SampleBatch({k: col[idx] for k, col in self._cols.items()})
        out[BATCH_INDEXES] = idx.astype(np.int64)
        out[WEIGHTS] = np.ones(num_items, np.float32)
        return out


class _SumTree:
    """Flat-array segment tree: O(log n) prefix-sum sampling + updates.
    Leaf count is rounded up to a power of two so every leaf sits at the
    same depth — the vectorized descent steps all queries in lockstep."""

    def __init__(self, capacity: int):
        self.capacity = 1 << max(1, (capacity - 1)).bit_length()
        self._tree = np.zeros(2 * self.capacity, np.float64)

    def set(self, idx: np.ndarray, values: np.ndarray):
        i = np.asarray(idx) + self.capacity
        self._tree[i] = values
        i //= 2
        # Propagate level by level; duplicate parents collapse via unique.
        while np.any(i >= 1):
            i = np.unique(i[i >= 1])
            self._tree[i] = self._tree[2 * i] + self._tree[2 * i + 1]
            i //= 2

    def total(self) -> float:
        return float(self._tree[1])

    def find_prefix(self, prefix: np.ndarray) -> np.ndarray:
        """Vectorized descent: for each p in prefix, the leaf where the
        running sum crosses p."""
        idx = np.ones(len(prefix), np.int64)
        p = prefix.astype(np.float64).copy()
        while idx[0] < self.capacity:
            left = self._tree[2 * idx]
            go_right = p > left
            p = np.where(go_right, p - left, p)
            idx = 2 * idx + go_right
        return idx - self.capacity

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self._tree[np.asarray(idx) + self.capacity]


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    prioritized_replay_buffer.py): P(i) ∝ p_i^alpha, importance weights
    w_i = (N * P(i))^-beta / max_j w_j; new items enter at max priority."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self._tree = _SumTree(capacity)
        self._max_priority = 1.0

    def add(self, batch: SampleBatch):
        idx = super().add(batch)
        self._tree.set(idx, np.full(len(idx),
                                    self._max_priority ** self.alpha))
        return idx

    def sample(self, num_items: int, beta: float = 0.4) -> SampleBatch:
        if self._size == 0:
            raise ValueError("cannot sample from an empty replay buffer")
        total = self._tree.total()
        # Stratified prefixes (one per segment) like the reference.
        seg = total / num_items
        prefix = (np.arange(num_items) + self._rng.random(num_items)) * seg
        idx = np.clip(self._tree.find_prefix(prefix), 0, self._size - 1)
        probs = self._tree.get(idx) / max(total, 1e-12)
        weights = (self._size * np.maximum(probs, 1e-12)) ** (-beta)
        weights = (weights / weights.max()).astype(np.float32)
        out = SampleBatch({k: col[idx] for k, col in self._cols.items()})
        out[BATCH_INDEXES] = idx.astype(np.int64)
        out[WEIGHTS] = weights
        return out

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray):
        priorities = np.abs(np.asarray(priorities, np.float64)) + 1e-6
        self._max_priority = max(self._max_priority,
                                 float(priorities.max()))
        self._tree.set(np.asarray(idx), priorities ** self.alpha)


@ray.remote
class ReplayActor:
    """Buffer in its own process: rollout workers push, the learner pulls
    (reference: the replay shards of rllib/algorithms/apex_dqn)."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 prioritized: bool = True, seed: int = 0):
        self._buf = (PrioritizedReplayBuffer(capacity, alpha, seed)
                     if prioritized else ReplayBuffer(capacity, seed))

    def add(self, batch) -> int:
        self._buf.add(SampleBatch(batch))
        return len(self._buf)

    def sample(self, num_items: int, beta: float = 0.4):
        if len(self._buf) == 0:
            return None
        if isinstance(self._buf, PrioritizedReplayBuffer):
            return dict(self._buf.sample(num_items, beta))
        return dict(self._buf.sample(num_items))

    def update_priorities(self, idx, priorities):
        if isinstance(self._buf, PrioritizedReplayBuffer):
            self._buf.update_priorities(np.asarray(idx),
                                        np.asarray(priorities))
        return True

    def size(self) -> int:
        return len(self._buf)

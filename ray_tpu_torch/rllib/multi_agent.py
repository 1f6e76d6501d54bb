"""Multi-agent RL: env API, per-policy batches, policy-mapped rollouts
(counterpart: ``ray_tpu/rllib/multi_agent.py``).

Reference surface: ``rllib/env/multi_agent_env.py`` (MultiAgentEnv — dict
obs/action/reward keyed by agent id, ``__all__`` termination),
``rllib/policy/sample_batch.py`` (MultiAgentBatch — {policy_id:
SampleBatch} + env-step accounting), and the policy-mapping rollout in
``rllib/evaluation/rollout_worker.py:166`` (policy_mapping_fn routes each
agent's transition into its policy's batch).

The division of labor is the single-agent stack's: rollout workers are
CPU actors that run each policy's ``ActorCriticMLP.apply`` on the CPU
under ``no_grad``; each POLICY gets its own ``Learner`` on the card.
Agents sharing a policy share parameters — their transitions concatenate
into one batch (one big minibatch instead of N tiny per-agent updates).
The turn-based bookkeeping below is the reference's, unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch as ray
from ray_tpu_torch.rllib.models import ActorCriticMLP, sample_action
from ray_tpu_torch.rllib.rollout_worker import WorkerSet, compute_gae
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, DONES, LOGP, OBS, REWARDS, SampleBatch, VF_PREDS,
    concat_batches,
)

ALL_DONE = "__all__"


class MultiAgentEnv:
    """Dict-keyed multi-agent environment (reference:
    rllib/env/multi_agent_env.py).

    ``reset() -> (obs_dict, info_dict)``;
    ``step(action_dict) -> (obs, rewards, terminateds, truncateds, infos)``
    — all dicts keyed by agent id.  ``terminateds[ALL_DONE]`` ends the
    episode.  Only agents present in the obs dict act next step (supports
    turn-based and agents joining/leaving mid-episode)."""

    agent_ids: List[str] = []

    def reset(self, *, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError


class MultiAgentBatch:
    """{policy_id: SampleBatch} + env-step count (reference:
    rllib/policy/sample_batch.py MultiAgentBatch — agent steps accumulate
    per policy; env_steps counts environment transitions once)."""

    def __init__(self, policy_batches: Dict[str, SampleBatch],
                 env_steps: int):
        self.policy_batches = policy_batches
        self._env_steps = env_steps

    def env_steps(self) -> int:
        return self._env_steps

    def agent_steps(self) -> int:
        return sum(len(b) for b in self.policy_batches.values())

    def __len__(self) -> int:
        return self._env_steps

    def __getitem__(self, policy_id: str) -> SampleBatch:
        return self.policy_batches[policy_id]

    def items(self):
        return self.policy_batches.items()


def concat_ma_batches(batches: List["MultiAgentBatch"]) -> "MultiAgentBatch":
    pids = {p for b in batches for p in b.policy_batches}
    merged = {}
    for pid in pids:
        parts = [b.policy_batches[pid] for b in batches
                 if pid in b.policy_batches and len(b.policy_batches[pid])]
        if parts:
            merged[pid] = concat_batches(parts)
    return MultiAgentBatch(merged, sum(b.env_steps() for b in batches))


class _AgentBuffer:
    """One agent's in-flight trajectory, flushed (GAE'd) on episode end."""

    __slots__ = ("cols",)

    def __init__(self):
        self.cols = {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, LOGP,
                                     VF_PREDS)}

    def add(self, obs, act, rew, done, logp, vf):
        c = self.cols
        c[OBS].append(obs)
        c[ACTIONS].append(act)
        c[REWARDS].append(rew)
        c[DONES].append(done)
        c[LOGP].append(logp)
        c[VF_PREDS].append(vf)

    def __len__(self):
        return len(self.cols[OBS])

    def to_batch(self) -> SampleBatch:
        c = self.cols
        return SampleBatch({
            OBS: np.asarray(c[OBS], np.float32),
            ACTIONS: np.asarray(c[ACTIONS], np.int32),
            REWARDS: np.asarray(c[REWARDS], np.float32),
            DONES: np.asarray(c[DONES], bool),
            LOGP: np.asarray(c[LOGP], np.float32),
            VF_PREDS: np.asarray(c[VF_PREDS], np.float32),
        })


@ray.remote
class MultiAgentRolloutWorker:
    """CPU rollout actor with per-policy models and a policy-mapping fn
    (reference: rollout_worker.py:166 — the policy map + per-agent
    routing; sampler.py's _env_runner agent-to-policy bookkeeping)."""

    def __init__(self, env_maker: Callable[[], MultiAgentEnv],
                 policy_model_configs: Dict[str, Dict[str, Any]],
                 policy_mapping_fn: Callable[[str], str],
                 worker_index: int = 0, gamma: float = 0.99,
                 lam: float = 0.95, seed: Optional[int] = None):
        self._env = env_maker()
        self._models = {pid: ActorCriticMLP(**mc)
                        for pid, mc in policy_model_configs.items()}
        self._params: Dict[str, Any] = {}
        self._map = policy_mapping_fn
        self._gamma, self._lam = gamma, lam
        self._rng = np.random.default_rng(
            seed if seed is not None else worker_index)
        self._obs, _ = self._env.reset(
            seed=int(self._rng.integers(2**31)))
        self._bufs: Dict[str, _AgentBuffer] = {}
        # Rewards received BEFORE an agent's first action of the episode
        # (turn-based envs): accrued here, folded into its next
        # transition (already counted in the episode return).
        self._pending_rew: Dict[str, float] = {}
        # Sticky: set the first time a live agent sits a step out — i.e.
        # the env has turn-based dynamics, so off-turn rewards are
        # possible and horizon flushes must hold each agent's newest
        # transition back.  Simultaneous-action envs never set it and
        # keep the flush-everything path (no one-transition training
        # lag, sample(1) is never empty).
        self._turn_based = False
        # Agents terminated THIS episode (cleared at reset): their
        # absence from the action dict is early termination, not
        # turn-taking, and must not flip the flag.
        self._done_agents: set = set()
        # Agents observed/rewarded THIS episode — the roster fallback
        # for envs that don't declare ``agent_ids``: once an agent has
        # appeared, it sitting a later step out is turn-taking evidence
        # that survives horizon flushes (buffers may be empty).
        # Per-episode (reset re-seeds it) so variable-roster
        # simultaneous envs don't trip over last episode's cast.
        self._seen_agents: set = set(self._obs)
        # Summed-over-agents return of the CURRENT episode; persists
        # across sample() horizons so only true episode ends record a
        # completed return (the single-agent worker's _ep_returns).
        self._ep_reward_sum = 0.0
        self._completed_returns: List[float] = []

    def set_weights(self, weights: Dict[str, Any]):
        from ray_tpu_torch.train.pipeline_actors import to_device_tree

        # A CPU actor: it holds no grant and sees no card.
        self._params.update({pid: to_device_tree(w, "cpu")
                             for pid, w in weights.items()})
        return True

    def _apply(self, pid: str, obs: np.ndarray):
        """Policy ``pid`` on a (B, obs_dim) numpy batch -> numpy
        (logits, values)."""
        import torch

        with torch.no_grad():
            logits, values = self._models[pid].apply(
                self._params[pid], torch.from_numpy(obs))
        return logits.numpy(), values.numpy()

    def _values_of(self, obs_dict) -> Dict[str, float]:
        """Each live agent's value of its current obs under its policy
        (truncation/horizon bootstrap)."""
        out: Dict[str, float] = {}
        for agent_id in self._bufs:
            if agent_id in obs_dict:
                pid = self._map(agent_id)
                _, v = self._apply(
                    pid, np.asarray(obs_dict[agent_id], np.float32)[None, :])
                out[agent_id] = float(v[0])
        return out

    def _flush_trajectories(self,
                            done_batches: Dict[str, List[SampleBatch]],
                            last_values: Dict[str, float],
                            terminated: bool, hold_last: bool = False):
        """GAE each agent's trajectory into its policy's bucket.
        ``last_values`` bootstraps truncated/horizon-cut trajectories.
        ``hold_last`` (horizon cut mid-episode) keeps each agent's most
        recent transition buffered instead of shipping it: a turn-based
        env may pay that agent an off-turn reward on a LATER step (the
        opponent's move deciding the game), which must land on a real
        transition — the flushed prefix bootstraps from the held
        transition's own value prediction, and the held row rides out
        with the next flush.  Does NOT touch episode-return accounting —
        that belongs to true episode ends only."""
        kept: Dict[str, _AgentBuffer] = {}
        for agent_id, buf in self._bufs.items():
            if not len(buf):
                continue
            if hold_last:
                held = {k: v.pop() for k, v in buf.cols.items()}
                last_v = held[VF_PREDS]
                nb = _AgentBuffer()
                nb.add(held[OBS], held[ACTIONS], held[REWARDS],
                       held[DONES], held[LOGP], held[VF_PREDS])
                kept[agent_id] = nb
                if not len(buf):
                    continue
            else:
                last_v = 0.0 if terminated \
                    else last_values.get(agent_id, 0.0)
            b = buf.to_batch()
            b = compute_gae(b, last_v, self._gamma, self._lam)
            done_batches.setdefault(self._map(agent_id), []).append(b)
        self._bufs = kept

    def sample(self, num_env_steps: int) -> MultiAgentBatch:
        assert self._params, "set_weights first"
        done_batches: Dict[str, List[SampleBatch]] = {}
        env_steps = 0
        for _ in range(num_env_steps):
            # Group the agents awaiting actions by policy: ONE forward
            # pass per policy per step, not one per agent.
            by_policy: Dict[str, List[str]] = {}
            for agent_id in self._obs:
                by_policy.setdefault(self._map(agent_id), []).append(
                    agent_id)
            actions, logps, vfs = {}, {}, {}
            for pid, agent_ids in by_policy.items():
                obs_arr = np.stack([self._obs[a] for a in agent_ids]) \
                    .astype(np.float32)
                logits, values = self._apply(pid, obs_arr)
                acts, lp = sample_action(logits, self._rng)
                for i, a in enumerate(agent_ids):
                    actions[a] = int(acts[i])
                    logps[a] = float(lp[i])
                    vfs[a] = float(values[i])
            # A LIVE agent sitting a step out marks turn-based dynamics
            # — detected both from the env's declared roster (works from
            # step 1, before any buffer exists, so even sample(1)
            # horizons see it) and from buffered agents absent from the
            # action dict (envs without an ``agent_ids`` attribute).
            # An agent whose last transition is done (or in
            # _done_agents) merely terminated early (battle-royale style
            # simultaneous envs): it is finished, not waiting its turn,
            # and no further reward may arrive for it.  A live-but-idle
            # agent is deliberately NOT excluded — this worker has no
            # per-agent truncation, so an absent live agent may act (or
            # be paid off-turn) later and the hold-back lag is the price
            # of not dropping that reward.
            if not self._turn_based:
                roster = getattr(self._env, "agent_ids", None) \
                    or self._seen_agents
                if any(a not in actions and a not in self._done_agents
                       for a in roster) or \
                   any(a not in actions and a not in self._done_agents
                       and len(buf) and not buf.cols[DONES][-1]
                       for a, buf in self._bufs.items()):
                    self._turn_based = True
            nobs, rews, terms, truncs, _ = self._env.step(actions)
            env_steps += 1
            self._seen_agents.update(nobs)
            self._seen_agents.update(a for a in rews if a != ALL_DONE)
            all_term = terms.get(ALL_DONE, False)
            all_trunc = truncs.get(ALL_DONE, False)
            for a, act in actions.items():
                # GAE's done flag means TERMINATION (value of the next
                # state is zero); a truncated agent's trajectory instead
                # bootstraps from its final obs below.
                agent_term = terms.get(a, False) or all_term
                self._bufs.setdefault(a, _AgentBuffer()).add(
                    self._obs[a], act,
                    float(rews.get(a, 0.0)) + self._pending_rew.pop(a, 0.0),
                    bool(agent_term), logps[a], vfs[a])
                self._ep_reward_sum += float(rews.get(a, 0.0))
            # Turn-based envs reward agents on steps they did NOT act
            # (e.g. the opponent's move decides the game): credit those
            # rewards to the agent's buffered LAST transition — or accrue
            # them for its next one if it hasn't acted yet — so terminal
            # rewards reach both the trajectory (GAE sees them) and the
            # episode-return accounting, instead of being dropped with
            # the action dict.
            for a, r in rews.items():
                if a in actions or a == ALL_DONE or not r:
                    continue
                self._ep_reward_sum += float(r)
                if a not in self._done_agents:
                    # A reward paid to a live non-acting agent IS
                    # turn-based dynamics (the definitive signal for
                    # envs with no ``agent_ids`` roster); a posthumous
                    # reward to an early-terminated agent is not.
                    self._turn_based = True
                buf = self._bufs.get(a)
                if buf is not None and len(buf):
                    buf.cols[REWARDS][-1] += float(r)
                else:
                    self._pending_rew[a] = \
                        self._pending_rew.get(a, 0.0) + float(r)
            # Off-turn TERMINATION — with or without a reward riding the
            # same step — must mark the agent's buffered last transition
            # done (GAE must not bootstrap past the end of its
            # trajectory); a zero/absent reward skips the credit loop
            # above, so the done flag is handled here for all of them.
            for a, buf in self._bufs.items():
                if a in actions or not len(buf):
                    continue
                if terms.get(a, False) or all_term:
                    buf.cols[DONES][-1] = True
            for a, t in terms.items():
                if t and a != ALL_DONE:
                    self._done_agents.add(a)
            if all_term or all_trunc:
                if all_trunc and not all_term:
                    # Time-limit truncation: bootstrap from the final
                    # obs the env just returned.  A turn-based env only
                    # returns the next-turn agent's obs, so off-turn
                    # agents fall back to their last recorded value
                    # prediction (the same proxy hold_last uses) rather
                    # than a flat 0.0 that would bias their advantages.
                    vals = self._values_of(nobs)
                    for a, buf in self._bufs.items():
                        if a not in vals and len(buf):
                            vals[a] = float(buf.cols[VF_PREDS][-1])
                    self._flush_trajectories(done_batches, vals,
                                             terminated=False)
                else:
                    self._flush_trajectories(done_batches, {},
                                             terminated=True)
                self._completed_returns.append(self._ep_reward_sum)
                self._ep_reward_sum = 0.0
                # Accrued rewards of agents that never acted this episode
                # have no transition to land on; they were counted in the
                # return above and must not leak into the next episode.
                self._pending_rew.clear()
                self._done_agents.clear()
                nobs, _ = self._env.reset()
                self._seen_agents = set(nobs)
            self._obs = nobs
        # Sample horizon hit mid-episode: flush for training WITHOUT
        # recording an episode return (the episode continues into the
        # next sample() call).  Under turn-based dynamics each agent's
        # newest transition stays buffered (hold_last) so an off-turn
        # terminal reward arriving next sample() still reaches a
        # trajectory — the prefix bootstraps from that transition's
        # recorded value; simultaneous-action envs flush everything with
        # a current-obs bootstrap as before.
        if self._bufs:
            if self._turn_based:
                self._flush_trajectories(done_batches, {},
                                         terminated=False, hold_last=True)
            else:
                self._flush_trajectories(done_batches,
                                         self._values_of(self._obs),
                                         terminated=False)
        merged = {pid: concat_batches(parts)
                  for pid, parts in done_batches.items() if parts}
        return MultiAgentBatch(merged, env_steps)

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self._completed_returns)
        if clear:
            self._completed_returns.clear()
        return out


class MultiAgentWorkerSet(WorkerSet):
    """Fault-tolerant multi-agent rollout fleet: WorkerSet's recreate /
    sample_sync / episode_returns machinery with the multi-agent worker
    factory and batch merge swapped in."""

    def __init__(self, env_maker, policy_model_configs, policy_mapping_fn,
                 num_workers: int, gamma: float = 0.99, lam: float = 0.95,
                 recreate_failed: bool = True):
        self._make = lambda idx: MultiAgentRolloutWorker.options(
            num_cpus=1).remote(
                env_maker, policy_model_configs, policy_mapping_fn,
                worker_index=idx, gamma=gamma, lam=lam, seed=idx)
        self._workers = [self._make(i) for i in range(num_workers)]
        self._recreate = recreate_failed

    @staticmethod
    def _concat(batches):
        return concat_ma_batches(batches)

    @staticmethod
    def _empty():
        return MultiAgentBatch({}, 0)

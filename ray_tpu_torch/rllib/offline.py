"""Offline RL: logged-experience IO, behavior cloning, MARWIL, discrete
CQL, and off-policy estimators (counterpart: ``ray_tpu/rllib/offline.py``).

Reference surface: ``rllib/offline/json_reader.py`` / ``json_writer.py``
(JSON-lines SampleBatch IO), ``rllib/offline/estimators/
importance_sampling.py`` + ``weighted_importance_sampling.py`` (per-episode
IS/WIS value estimates from behavior-logged action probs), and the
algorithms ``rllib/algorithms/bc/``, ``rllib/algorithms/marwil/``,
``rllib/algorithms/cql/``.

The reader, writer and estimators are the reference's numpy code, and the
file format is the reference's: a file either package writes, the other
reads.  BC and MARWIL update through the port's ``Learner``; CQL carries
its own update; all three on ``learner_device`` (the card unless the CPU
is named).  Offline just swaps the rollout fleet for a file reader (the
reference does the same through its ``input_`` config).
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, DONES, LOGP, NEXT_OBS, OBS, REWARDS, SampleBatch,
    concat_batches,
)

_ARRAY_DTYPES = {OBS: np.float32, NEXT_OBS: np.float32,
                 ACTIONS: np.int32, REWARDS: np.float32,
                 LOGP: np.float32, DONES: bool}


class JsonWriter:
    """Append SampleBatches as JSON lines (reference: json_writer.py —
    one serialized batch per line, files rolled by size; we roll only on
    explicit ``new_file``)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def write(self, batch: SampleBatch):
        rec = {k: np.asarray(v).tolist() for k, v in batch.items()}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class JsonReader:
    """Cycle through logged batches (reference: json_reader.py:30 —
    ``next()`` returns one SampleBatch, looping over the input files
    forever; globs and directories accepted)."""

    def __init__(self, inputs: str, shuffle: bool = True, seed: int = 0):
        if os.path.isdir(inputs):
            paths = sorted(_glob.glob(os.path.join(inputs, "*.json")))
        else:
            paths = sorted(_glob.glob(inputs)) or [inputs]
        self._lines: List[str] = []
        for p in paths:
            with open(p, encoding="utf-8") as f:
                self._lines.extend(
                    ln for ln in f.read().splitlines() if ln.strip())
        if not self._lines:
            raise ValueError(f"No batches found in {inputs!r}")
        self._rng = np.random.default_rng(seed)
        self._shuffle = shuffle
        self._order: List[int] = []

    @staticmethod
    def _decode(line: str) -> SampleBatch:
        rec = json.loads(line)
        return SampleBatch({
            k: np.asarray(v, dtype=_ARRAY_DTYPES.get(k))
            for k, v in rec.items()})

    def next(self) -> SampleBatch:
        if not self._order:
            self._order = list(range(len(self._lines)))
            if self._shuffle:
                self._rng.shuffle(self._order)
            else:
                self._order.reverse()  # tail pops -> chronological order
        return self._decode(self._lines[self._order.pop()])

    def read_all(self) -> SampleBatch:
        return concat_batches([self._decode(ln) for ln in self._lines])

    def __iter__(self) -> Iterator[SampleBatch]:
        while True:
            yield self.next()


# --------------------------------------------------------------------------
# Off-policy estimators (reference: rllib/offline/estimators/*.py).
# --------------------------------------------------------------------------

def _episodes(batch: SampleBatch) -> List[SampleBatch]:
    """Split on done flags (reference: estimators operate per episode)."""
    dones = np.asarray(batch[DONES])
    ends = np.nonzero(dones)[0]
    out, start = [], 0
    for e in ends:
        out.append(batch.slice(start, int(e) + 1))
        start = int(e) + 1
    if start < len(dones):
        out.append(batch.slice(start, len(dones)))
    return out


class ImportanceSampling:
    """Ordinary importance sampling: V^pi ≈ mean_ep sum_t gamma^t
    (prod_{t'<=t} pi/mu) r_t (reference: importance_sampling.py)."""

    weighted = False

    def __init__(self, policy_logp_fn, gamma: float = 0.99):
        """``policy_logp_fn(obs, actions) -> logp`` under the TARGET
        policy; the batch's ``action_logp`` column is the behavior
        policy's logged prob."""
        self._logp = policy_logp_fn
        self._gamma = gamma

    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        eps = _episodes(batch)
        # Per-episode cumulative ratios, padded to the longest horizon so
        # WIS can normalize across episodes at each t.
        horizon = max(len(e) for e in eps)
        cumr = np.zeros((len(eps), horizon), np.float64)
        rews = np.zeros((len(eps), horizon), np.float64)
        for i, ep in enumerate(eps):
            target_logp = np.asarray(
                self._logp(ep[OBS], ep[ACTIONS]), np.float64)
            ratio = np.exp(target_logp - np.asarray(ep[LOGP], np.float64))
            cumr[i, :len(ep)] = np.cumprod(ratio)
            rews[i, :len(ep)] = ep[REWARDS]
        disc = self._gamma ** np.arange(horizon)
        if self.weighted:
            norm = cumr.mean(axis=0)
            norm = np.where(norm > 0, norm, 1.0)
            v = (disc * cumr / norm * rews).sum(axis=1)
        else:
            v = (disc * cumr * rews).sum(axis=1)
        behavior = (disc * rews).sum(axis=1)
        return {
            "v_behavior": float(behavior.mean()),
            "v_target": float(v.mean()),
            "v_gain": float(v.mean() / (abs(behavior.mean()) + 1e-8)),
            "episodes": len(eps),
        }


class WeightedImportanceSampling(ImportanceSampling):
    """WIS: cumulative ratios normalized by their cross-episode mean at
    each step — biased but far lower variance (reference:
    weighted_importance_sampling.py)."""

    weighted = True


# --------------------------------------------------------------------------
# The offline algorithms' shared config and learner plumbing.
# --------------------------------------------------------------------------

class OfflineAlgorithmConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.input_path: Optional[str] = None
        self.num_batches_per_step = 8

    def offline_data(self, *, input_path: str,
                     num_batches_per_step: Optional[int] = None
                     ) -> "OfflineAlgorithmConfig":
        self.input_path = input_path
        if num_batches_per_step is not None:
            self.num_batches_per_step = num_batches_per_step
        return self


def _infer_spaces_from_batch(batch: SampleBatch):
    obs_dim = int(np.asarray(batch[OBS]).shape[-1])
    num_actions = int(np.asarray(batch[ACTIONS]).max()) + 1
    return obs_dim, num_actions


def _probe_spaces(reader: JsonReader, scans: int = 5):
    """(obs_dim, num_actions) inferred from logged batches; several
    batches scanned so rare actions are not missed."""
    obs_dim, num_actions = _infer_spaces_from_batch(reader.next())
    for _ in range(scans - 1):
        _, n2 = _infer_spaces_from_batch(reader.next())
        num_actions = max(num_actions, n2)
    return obs_dim, num_actions


def _logp_of_actions(logits, actions):
    import torch
    import torch.nn.functional as F

    return torch.gather(F.log_softmax(logits, dim=-1), -1,
                        actions[:, None].long())[:, 0]


def bc_loss(params, module, batch):
    """-mean log pi(a_logged | obs)."""
    logits, _ = module.apply(params, batch[OBS])
    loss = -_logp_of_actions(logits, batch[ACTIONS]).mean()
    return loss, {"bc_loss": loss}


def marwil_loss(params, module, batch, *, beta: float, vf_coeff: float):
    """exp(beta * A)-weighted BC + value regression on the returns-to-go,
    the weights detached (marwil_torch_policy.py does the same)."""
    import torch

    logits, values = module.apply(params, batch[OBS])
    logp = _logp_of_actions(logits, batch[ACTIONS])
    adv = batch["returns"] - values
    w = torch.exp(torch.clamp(beta * adv.detach(), -10.0, 10.0))
    pi_loss = -(w * logp).mean()
    vf_loss = (adv ** 2).mean()
    return pi_loss + vf_coeff * vf_loss, {"policy_loss": pi_loss,
                                          "vf_loss": vf_loss}


class _ImitationAlgorithm(Algorithm):
    """BC and MARWIL: an ``ActorCriticMLP`` in a ``Learner`` (``adam``,
    no clip) fed from the reader."""

    def _make_learner(self, cfg, loss):
        from ray_tpu_torch.rllib.learner import Learner
        from ray_tpu_torch.rllib.models import ActorCriticMLP
        from ray_tpu_torch.train.core import adam

        self.reader = JsonReader(cfg.input_path, seed=cfg.seed)
        obs_dim, num_actions = _probe_spaces(self.reader)
        self.module = ActorCriticMLP(
            obs_dim, num_actions,
            hidden=tuple(cfg.model.get("hidden", (64, 64))))
        self.learner = Learner(self.module, loss, optimizer=adam(cfg.lr),
                               seed=cfg.seed, device=cfg.learner_device)

    def _prepare(self, batch: SampleBatch) -> SampleBatch:
        return batch

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        metrics: Dict[str, Any] = {}
        n = 0
        for _ in range(cfg.num_batches_per_step):
            batch = self._prepare(self.reader.next())
            metrics = self.learner.update(batch)
            n += len(batch)
        metrics["num_env_steps_trained"] = n
        return metrics

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        import torch

        with torch.no_grad():
            logits, _ = self.module.apply(
                self.learner.params,
                torch.as_tensor(np.asarray(obs, np.float32),
                                device=self.learner.device))
        return logits.argmax(dim=-1).cpu().numpy()

    def save_checkpoint(self):
        return self.learner.state()

    def load_checkpoint(self, state):
        self.learner.load_state(state)


# --------------------------------------------------------------------------
# BC — behavior cloning (reference: rllib/algorithms/bc/bc.py: MARWIL
# with beta=0, pure -logp supervised loss).
# --------------------------------------------------------------------------

class BCConfig(OfflineAlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.bc_logstd_coeff = 0.0

    @property
    def algo_class(self):
        return BC


class BC(_ImitationAlgorithm):
    config_class = BCConfig

    def _setup(self, cfg: BCConfig):
        self._make_learner(cfg, bc_loss)


# --------------------------------------------------------------------------
# MARWIL — monotonic advantage re-weighted imitation learning
# (reference: rllib/algorithms/marwil/marwil.py — exp(beta*A) weighted BC
# + value regression; BC is the beta=0 special case).
# --------------------------------------------------------------------------

class MARWILConfig(OfflineAlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.beta = 1.0
        self.vf_coeff = 1.0

    @property
    def algo_class(self):
        return MARWIL


class MARWIL(_ImitationAlgorithm):
    config_class = MARWILConfig

    def _setup(self, cfg: MARWILConfig):
        beta, vf_coeff = cfg.beta, cfg.vf_coeff
        self._make_learner(cfg, lambda p, m, b: marwil_loss(
            p, m, b, beta=beta, vf_coeff=vf_coeff))
        self._gamma = cfg.gamma

    def _with_returns(self, batch: SampleBatch) -> SampleBatch:
        """Discounted returns-to-go per episode (the advantage target)."""
        rews = np.asarray(batch[REWARDS], np.float32)
        dones = np.asarray(batch[DONES])
        ret = np.zeros_like(rews)
        acc = 0.0
        for t in reversed(range(len(rews))):
            acc = rews[t] + self._gamma * acc * (1.0 - float(dones[t]))
            ret[t] = acc
        out = SampleBatch(batch)
        out["returns"] = ret
        return out

    _prepare = _with_returns


# --------------------------------------------------------------------------
# CQL — conservative Q-learning, discrete variant (reference:
# rllib/algorithms/cql/cql.py; the conservative regularizer
# logsumexp(Q) - Q(a_logged) keeps unseen actions' Q-values down so the
# greedy policy stays inside the dataset's support).
# --------------------------------------------------------------------------

class CQLConfig(OfflineAlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.min_q_weight = 1.0
        self.target_update_freq = 8
        self.tau = 1.0

    @property
    def algo_class(self):
        return CQL


def cql_loss(params, target_params, module, batch, *, gamma: float,
             min_q_weight: float):
    """The double-Q TD term (through the online argmax, first maximum
    kept) plus ``min_q_weight`` x (logsumexp(Q) - Q(a_logged))."""
    import torch

    from ray_tpu_torch.rllib.dqn import _take

    q = module.apply(params, batch[OBS])
    q_a = _take(q, batch[ACTIONS])
    next_q_online = module.apply(params, batch[NEXT_OBS])
    next_q_target = module.apply(target_params, batch[NEXT_OBS])
    next_q = _take(next_q_target, next_q_online.argmax(dim=-1))
    not_done = 1.0 - batch[DONES].float()
    target = batch[REWARDS] + gamma * not_done * next_q.detach()
    td = ((q_a - target) ** 2).mean()
    conservative = (torch.logsumexp(q, dim=-1) - q_a).mean()
    return td + min_q_weight * conservative, {"td_loss": td,
                                              "cql_loss": conservative}


class CQL(Algorithm):
    config_class = CQLConfig

    def _setup(self, cfg: CQLConfig):
        import torch

        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.rllib.dqn import QNetworkMLP, _copy_tree
        from ray_tpu_torch.train.core import adam
        from ray_tpu_torch.train.pipeline_actors import to_device_tree

        self._dev = resolve_device(cfg.learner_device)
        self.reader = JsonReader(cfg.input_path, seed=cfg.seed)
        obs_dim, num_actions = _probe_spaces(self.reader)
        self.module = QNetworkMLP(
            obs_dim, num_actions,
            hidden=tuple(cfg.model.get("hidden", (64, 64))))
        self.params = to_device_tree(self.module.init(
            torch.Generator().manual_seed(cfg.seed)), self._dev)
        self.target_params = _copy_tree(self.params)
        self._opt = adam(cfg.lr)
        self._opt_state = self._opt.init(self.params)
        self._steps = 0

    def _update(self, batch) -> Dict[str, Any]:
        """One update on a batch of device tensors; the metrics detached
        on the device."""
        from ray_tpu_torch.rllib.learner import grad_step

        cfg: CQLConfig = self.algo_config
        loss, metrics = grad_step(
            self.params, self._opt_state, self._opt,
            lambda p: cql_loss(p, self.target_params, self.module, batch,
                               gamma=cfg.gamma,
                               min_q_weight=cfg.min_q_weight))
        return dict(metrics, total_loss=loss)

    def training_step(self) -> Dict[str, Any]:
        import torch

        from ray_tpu_torch.rllib.dqn import _copy_tree

        cfg = self.algo_config
        metrics: Dict[str, Any] = {}
        n = 0
        for _ in range(cfg.num_batches_per_step):
            batch = self.reader.next()
            metrics = self._update({
                k: torch.from_numpy(np.asarray(v)).to(self._dev)
                for k, v in batch.items()})
            self._steps += 1
            if self._steps % cfg.target_update_freq == 0:
                self.target_params = _copy_tree(self.params)
            n += len(batch)
        out = {k: float(v) for k, v in metrics.items()}
        out["num_env_steps_trained"] = n
        return out

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        import torch

        with torch.no_grad():
            q = self.module.apply(self.params, torch.as_tensor(
                np.asarray(obs, np.float32), device=self._dev))
        return q.argmax(dim=-1).cpu().numpy()

    def save_checkpoint(self):
        from ray_tpu_torch.train.pipeline_actors import to_numpy_tree

        return {"params": to_numpy_tree(self.params),
                "target": to_numpy_tree(self.target_params)}

    def load_checkpoint(self, state):
        from ray_tpu_torch.train.pipeline_actors import to_device_tree

        self.params = to_device_tree(state["params"], self._dev)
        self.target_params = to_device_tree(state["target"], self._dev)

"""Parity of the port's train step with the JAX reference on CPU.

The reference's ``make_train_step(cfg, default_optimizer(lr=1e-2,
warmup=1, decay_steps=10), donate=False)`` on ``LlamaConfig.tiny(
attn_impl="flash")`` (Pallas in interpret mode, its flash backward
included) runs 3 steps on one numpy token batch; the port starts from the
same params (``params_from_jax``) and takes the same steps on its CPU path
(the plain versions of K1-K3).  Tolerances, f32:

- loss and grad_norm within 1e-5 (observed: 5e-7);
- every param within 1e-4 after 1 and 3 steps, and at most 0.1% of the
  elements beyond 1e-5.  The first step is exact (its learning rate is 0).
  The rest is Adam's ``m / (sqrt(v) + eps)`` on elements whose grads are
  near eps = 1e-8: there the f32 summation-order noise of the two grads
  is a visible part of the grad.  Observed: 7.6e-5 on 3 of 110k elements,
  all with sqrt(nu) below 1e-7; every other element within 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu.train import core as jax_core
from ray_tpu_torch.models import (
    LlamaConfig, init_params, params_from_jax, train_state_from_jax)
from ray_tpu_torch.train import (
    default_optimizer, init_train_state, loss_and_grads, make_train_step,
    train_state_from_params, warmup_cosine_decay_schedule)
from ray_tpu_torch.train.core import tree_leaves

# Tiny shapes: more intra-op threads would only contend with the test
# files that pytest-xdist runs beside these.
torch.set_num_threads(1)

OPT = dict(lr=1e-2, warmup=1, decay_steps=10)


@pytest.fixture(scope="module")
def jax_run():
    """The reference's states after 0..3 steps (numpy leaves) and the
    metrics of steps 1..3, on one token batch."""
    jcfg = jax_llama.LlamaConfig.tiny(attn_impl="flash")
    opt = jax_core.default_optimizer(**OPT)
    state = jax_core.init_train_state(jax.random.PRNGKey(0), jcfg, opt)
    step = jax_core.make_train_step(jcfg, opt, donate=False)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, 33)).astype(np.int32)
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for _ in range(3):
        state, m = step(state, {"tokens": jnp.asarray(toks)})
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics, toks


def _assert_params_close(got, np_params, cfg):
    want = params_from_jax(np_params, cfg, "cpu")
    n_far = n = 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        d = (a - b).abs()
        assert float(d.max()) <= 1e-4
        n_far += int((d > 1e-5).sum())
        n += d.numel()
    assert n_far <= 1e-3 * n


def _assert_metrics_close(got, want):
    assert set(got) == {"loss", "aux_loss", "perplexity", "grad_norm"}
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - want[k]) <= 1e-5, k
    assert abs(float(got["perplexity"]) - want["perplexity"]) <= \
        1e-5 * want["perplexity"]
    assert float(got["aux_loss"]) == want["aux_loss"] == 0.0


def test_train_steps_match_jax(jax_run):
    """Loss, grad_norm and every param after 1 and after 3 steps."""
    states, metrics, toks = jax_run
    cfg = LlamaConfig.tiny(attn_impl="flash")
    opt = default_optimizer(**OPT)
    state = train_state_from_params(
        params_from_jax(states[0].params, cfg, "cpu"), opt)
    step = make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(toks)}
    for i in range(3):
        out, m = step(state, batch)
        assert out is state and state.step == i + 1
        _assert_metrics_close(m, metrics[i])
        if i in (0, 2):
            _assert_params_close(state.params, states[i + 1].params, cfg)
    assert state.opt_state["count"] == 3


def test_train_step_resumes_from_a_jax_state(jax_run):
    """One step from the reference's state after step 1, converted by
    ``train_state_from_jax`` (params, AdamW count and moments), equals
    the reference's step 2."""
    states, metrics, toks = jax_run
    cfg = LlamaConfig.tiny(attn_impl="flash")
    state = train_state_from_jax(states[1], cfg, "cpu")
    assert state.step == 1 and state.opt_state["count"] == 1
    adam = states[1].opt_state[1][0]                 # chain(clip, adamw)
    assert np.array_equal(state.opt_state["nu"]["layers"]["wq"].numpy(),
                          adam.nu["layers"]["wq"])
    opt = default_optimizer(**OPT)
    state, m = make_train_step(cfg, opt)(
        state, {"tokens": torch.from_numpy(toks)})
    _assert_metrics_close(m, metrics[1])
    _assert_params_close(state.params, states[2].params, cfg)


@pytest.mark.parametrize("init,peak,warmup,decay", [
    (0.0, 1e-2, 3, 10), (0.0, 3e-4, 1, 2), (1e-3, 1e-2, 0, 5)])
def test_schedule_matches_optax(init, peak, warmup, decay):
    want = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay)
    got = warmup_cosine_decay_schedule(init, peak, warmup, decay)
    for count in range(13):
        assert abs(got(count) - float(want(count))) <= 1e-6 * peak, count


def test_train_step_decreases_loss_single_device():
    """The analog of tests/test_model_parallel.py's test of the same
    name: 11 steps on one batch lower the loss."""
    cfg = LlamaConfig.tiny(attn_impl="flash")
    opt = default_optimizer(lr=1e-2, warmup=1, weight_decay=0.0)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                             "cpu")
    step = make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 33)))}
    state, m0 = step(state, batch)
    for _ in range(10):
        state, m = step(state, batch)
    assert float(m["loss"]) < float(m0["loss"])
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(
        state.params))


def test_remat_gives_the_same_grads():
    """``cfg.remat`` recomputes each layer in the backward: the same loss
    and bitwise the same grads as keeping the activations."""
    cfg = LlamaConfig.tiny(attn_impl="flash", num_kv_heads=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 21)))}
    loss0, _, g0 = loss_and_grads(params, batch, cfg)
    loss1, _, g1 = loss_and_grads(
        params, batch, LlamaConfig.tiny(attn_impl="flash", num_kv_heads=2,
                                        remat=True))
    assert float(loss0) == float(loss1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)

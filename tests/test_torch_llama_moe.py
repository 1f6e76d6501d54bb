"""Parity of the port's MoE Llama with the JAX reference on CPU.

``LlamaConfig.tiny(num_experts=4)`` (the reference's own MoE test size,
``tests/test_model_parallel.py``), f32, the reference's params handed
over by ``params_from_jax`` and one numpy token batch:

- the forward's logits within 1e-4 and its aux loss within 1e-6, and the
  loss within 1e-5, with the plain attention and with flash (the port's
  plain path; the reference's Pallas kernel in interpret mode);
- ``init_params``' layout: the reference's keys, shapes and dtypes, and
  its fan-in scale for the router and the experts;
- the train step of ``default_optimizer(lr=1e-2, warmup=1,
  decay_steps=10)`` after 1 and 3 steps, as ``test_torch_train.py``
  holds the dense step, and one step resumed from the reference's state
  (MoE moments included).  Loss, aux loss and grad_norm within 1e-5.
  The first step's grads are within 1e-6 of ``jax.grad`` (observed:
  2.2e-8).  Params: every element within 1e-4 where the reference's
  first grad is at least 1e-6, and at most 0.1% of all elements beyond
  1e-5.  Where a first grad is smaller, Adam's first update divides it by
  itself plus eps = 1e-8 while the two grads differ by f32 summation
  noise of ~2e-8: such an element's update is the sign of noise, so it
  is held only within the updates' own size, lr per step (observed:
  2.8e-4 on 1 element of 65536 after 2 steps; every element with a
  first grad of at least 1e-6 within 5e-7).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu.train import core as jax_core
from ray_tpu_torch.models import (
    LlamaConfig, forward, init_params, loss_fn, params_from_jax,
    train_state_from_jax)
from ray_tpu_torch.models.llama import _dense_layer_shapes
from ray_tpu_torch.train import (
    default_optimizer, loss_and_grads, make_train_step,
    train_state_from_params)
from ray_tpu_torch.train.core import tree_leaves

torch.set_num_threads(1)

OPT = dict(lr=1e-2, warmup=1, decay_steps=10)
MOE = dict(num_experts=4, attn_impl="flash")


def _tokens(cfg, rows=2):
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(rows, 33)).astype(np.int32)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_moe_forward_and_loss_match_jax(attn_impl):
    jcfg = jax_llama.LlamaConfig.tiny(num_experts=4, attn_impl=attn_impl)
    cfg = LlamaConfig.tiny(num_experts=4, attn_impl=attn_impl)
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = _tokens(cfg)
    want_logits, want_aux = jax_llama.forward(
        jparams, jnp.asarray(toks[:, :-1]), jcfg)
    got_logits, got_aux = forward(params, torch.from_numpy(toks[:, :-1]),
                                  cfg)
    assert np.max(np.abs(got_logits.numpy() - np.asarray(want_logits))) \
        < 1e-4
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6
    assert float(got_aux) > 0.0
    want_loss, want_m = jax_llama.loss_fn(
        jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    got_loss, got_m = loss_fn(params, {"tokens": torch.from_numpy(toks)},
                              cfg)
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5
    assert abs(float(got_m["aux_loss"]) - float(want_m["aux_loss"])) <= 1e-6


def test_moe_init_params_layout_and_scale():
    cfg = LlamaConfig.tiny(num_experts=4, embed_dim=128, mlp_dim=256)
    jcfg = jax_llama.LlamaConfig.tiny(num_experts=4, embed_dim=128,
                                      mlp_dim=256)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.eval_shape(
        lambda: jax_llama.init_params(jax.random.PRNGKey(0), jcfg))
    assert params["layers"].keys() == shapes["layers"].keys()
    # The draw order: the reference's layer order, MoE tensors last.
    assert list(_dense_layer_shapes(cfg)) == list(
        jax_llama._dense_layer_shapes(jcfg))
    for name, s in shapes["layers"].items():
        assert tuple(params["layers"][name].shape) == s.shape, name
        assert params["layers"][name].dtype == torch.float32
    for name, fan_in in (("router", 128), ("w_gate", 128), ("w_up", 128),
                         ("w_down", 256)):
        std = float(params["layers"][name].std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, name


@pytest.fixture(scope="module")
def jax_run():
    """The reference's states after 0..3 steps (numpy leaves), the
    metrics of steps 1..3, its first grads and the token batch."""
    jcfg = jax_llama.LlamaConfig.tiny(**MOE)
    opt = jax_core.default_optimizer(**OPT)
    state = jax_core.init_train_state(jax.random.PRNGKey(0), jcfg, opt)
    step = jax_core.make_train_step(jcfg, opt, donate=False)
    toks = _tokens(jcfg)
    batch = {"tokens": jnp.asarray(toks)}
    grads = jax.tree.map(np.asarray, jax.grad(
        lambda p: jax_llama.loss_fn(p, batch, jcfg)[0])(state.params))
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for _ in range(3):
        state, m = step(state, batch)
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics, grads, toks


def _assert_params_close(got, np_params, first_grads, cfg, steps):
    want = params_from_jax(np_params, cfg, "cpu")
    n_far = n = 0
    for a, b, g in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(first_grads)):
        d = (a - b).abs()
        sure = torch.from_numpy(np.abs(g) >= 1e-6)
        assert float(d.max()) <= OPT["lr"] * steps
        if bool(sure.any()):
            assert float(d[sure].max()) <= 1e-4
        n_far += int((d > 1e-5).sum())
        n += d.numel()
    assert n_far <= 1e-3 * n


def _assert_metrics_close(got, want):
    for k in ("loss", "aux_loss", "grad_norm"):
        assert abs(float(got[k]) - want[k]) <= 1e-5, k
    assert abs(float(got["perplexity"]) - want["perplexity"]) <= \
        1e-5 * want["perplexity"]


def test_moe_train_steps_match_jax(jax_run):
    states, metrics, grads, toks = jax_run
    cfg = LlamaConfig.tiny(**MOE)
    batch = {"tokens": torch.from_numpy(toks)}
    params = params_from_jax(states[0].params, cfg, "cpu")
    _, _, g = loss_and_grads(params, batch, cfg)
    for a, b in zip(tree_leaves(g), tree_leaves(grads)):
        assert float((a - torch.from_numpy(np.array(b))).abs().max()) \
            <= 1e-6
    opt = default_optimizer(**OPT)
    state = train_state_from_params(params, opt)
    step = make_train_step(cfg, opt)
    for i in range(3):
        state, m = step(state, batch)
        _assert_metrics_close(m, metrics[i])
        if i in (0, 2):
            _assert_params_close(state.params, states[i + 1].params, grads,
                                 cfg, i + 1)


def test_moe_train_step_resumes_from_a_jax_state(jax_run):
    states, metrics, grads, toks = jax_run
    cfg = LlamaConfig.tiny(**MOE)
    state = train_state_from_jax(states[1], cfg, "cpu")
    adam = states[1].opt_state[1][0]
    for name in ("router", "w_gate", "w_down"):
        assert np.array_equal(state.opt_state["mu"]["layers"][name].numpy(),
                              adam.mu["layers"][name])
    state, m = make_train_step(cfg, default_optimizer(**OPT))(
        state, {"tokens": torch.from_numpy(toks)})
    _assert_metrics_close(m, metrics[1])
    _assert_params_close(state.params, states[2].params, grads, cfg, 2)

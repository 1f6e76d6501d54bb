"""Parity of the port's MoE layer (``ray_tpu_torch.ops.moe``) with the
JAX reference (``ray_tpu.ops.moe``) on CPU, f32, inputs from
``numpy.random.default_rng``.

- ``route_topk`` for k = 1 and 2, with the capacity binding (tokens
  dropped) and not: dispatch bitwise, combine and the aux loss within
  1e-6.  The logits are continuous random numbers, so no two router
  probabilities tie (``jax.lax.top_k`` breaks ties to the lower index,
  ``torch.topk`` does not promise to).
- ``moe_ffn``: the output within 1e-5 and the aux loss within 1e-6, and
  the grads of a scalar of both against ``jax.grad`` within 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tpu.ops import moe as jax_moe
from ray_tpu_torch.ops import moe

torch.set_num_threads(1)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [5, 64])
def test_route_topk_matches_jax(k, capacity):
    logits = np.random.default_rng(k * 100 + capacity).normal(
        size=(48, 6)).astype(np.float32) * 2
    want = [np.asarray(x) for x in jax_moe.route_topk(
        jnp.asarray(logits), k, capacity)]
    got = [x.numpy() for x in moe.route_topk(torch.from_numpy(logits), k,
                                              capacity)]
    assert got[0].dtype == np.float32 and got[0].shape == (48, 6, capacity)
    assert np.array_equal(got[0], want[0])
    kept = want[0].sum()
    if capacity == 5:
        assert kept < 48 * k                      # over-capacity drops
    else:
        assert kept == 48 * k
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    assert abs(float(got[2]) - float(want[2])) <= 1e-6


def _moe_inputs(seed, t=40, d=16, e=4, m=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, d)).astype(np.float32)
    router = (rng.normal(size=(d, e)) / d ** 0.5).astype(np.float32)
    w_gate = (rng.normal(size=(e, d, m)) / d ** 0.5).astype(np.float32)
    w_up = (rng.normal(size=(e, d, m)) / d ** 0.5).astype(np.float32)
    w_down = (rng.normal(size=(e, m, d)) / m ** 0.5).astype(np.float32)
    return x, router, w_gate, w_up, w_down


@pytest.mark.parametrize("k,capacity_factor", [(2, 1.25), (1, 0.5)])
def test_moe_ffn_forward_and_grads_match_jax(k, capacity_factor):
    arrays = _moe_inputs(k)
    kw = dict(num_selected=k, capacity_factor=capacity_factor)
    want = jax_moe.moe_ffn(*map(jnp.asarray, arrays), **kw)
    tens = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = moe.moe_ffn(*tens, **kw)
    np.testing.assert_allclose(got.out.detach().numpy(),
                               np.asarray(want.out), rtol=0, atol=1e-5)
    assert abs(float(got.aux_loss.detach()) - float(want.aux_loss)) <= 1e-6
    np.testing.assert_allclose(got.router_probs.detach().numpy(),
                               np.asarray(want.router_probs), atol=1e-6)

    def scalar(out, aux):
        return (out * out).sum() * 0.5 + 3.0 * aux

    want_g = jax.grad(lambda *a: scalar(*jax_moe.moe_ffn(*a, **kw)[:2]),
                      argnums=tuple(range(5)))(*map(jnp.asarray, arrays))
    got_g = torch.autograd.grad(scalar(got.out, got.aux_loss), tens)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)

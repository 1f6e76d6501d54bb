"""Parity of the port's MoE layer (``ray_tpu_torch.ops.moe``) with the
JAX reference (``ray_tpu.ops.moe``) on CPU, f32, inputs from
``numpy.random.default_rng``.

- ``route_topk`` for k = 1 and 2, with the capacity binding (tokens
  dropped) and not: dispatch bitwise, combine and the aux loss within
  1e-6.  The logits are continuous random numbers, so no two router
  probabilities tie (``jax.lax.top_k`` breaks ties to the lower index,
  ``torch.topk`` does not promise to).
- The slot tables (``moe.assign``) against the one-hot running count
  that built the dense tensors before them: positions, kept set, slots
  and sources, and the dense dispatch and combine built from the tables
  bitwise those built by ``index_put``, for k = 1 and 2, with the
  capacity binding and not, and with empty slots.
- ``moe_ffn`` on local tensors (the slot tables and the plain versions
  of K6's gather and combine): the output within 1e-5 and the aux loss
  within 1e-6, and the grads of a scalar of both against ``jax.grad``
  within 1e-4; the same against the layer's dense (mesh) formulation, and
  with the dense builder made to raise (no (T, E, C) tensor on the local
  path).
- The plain gather and combine against a loop over rows.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

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


def _slots_by_cumsum(expert_idx, e, capacity):
    """Positions and kept set as the port computed them before the slot
    tables: a one-hot running count over the choice-major order."""
    t, k = expert_idx.shape
    onehot = F.one_hot(expert_idx, e)                             # (T, k, E)
    flat = onehot.transpose(0, 1).reshape(-1, e)                  # (k*T, E)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(k, t, e).transpose(0, 1)
    pos = (pos * onehot).sum(-1)
    return pos, pos < capacity


def _dense_by_index_put(expert_idx, gate_vals, pos, within, e, capacity):
    t, k = expert_idx.shape
    disp = torch.zeros((t, e, capacity))
    comb = torch.zeros_like(disp)
    tok = torch.arange(t)
    for c in range(k):
        idx = (tok, expert_idx[:, c], pos[:, c].clamp(0, capacity - 1))
        keep = within[:, c].float()
        disp = disp.index_put(idx, keep, accumulate=True)
        comb = comb.index_put(idx, keep * gate_vals[:, c], accumulate=True)
    return disp, comb


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [3, 11, 64])
def test_slot_tables_match_the_one_hot_running_count(k, capacity):
    t, e = 48, 6
    logits = torch.from_numpy(np.random.default_rng(7 * k + capacity).normal(
        size=(t, e)).astype(np.float32) * 2)
    r = moe.route(logits, k, capacity)
    pos, within = _slots_by_cumsum(r.experts, e, capacity)
    assert torch.equal(r.keep, within)
    assert r.slot.dtype == r.source.dtype == torch.int32
    assert torch.equal(r.slot.long(), torch.where(
        within, r.experts * capacity + pos, -1))
    # Each kept (token, choice) is the source of its slot; the rest of the
    # slots are empty.
    a = torch.arange(t * k).view(t, k)
    want = torch.full((e * capacity,), -1)
    want[r.slot[within].long()] = a[within]
    assert torch.equal(r.source.long(), want)
    assert int((r.source >= 0).sum()) == int(within.sum())
    if capacity == 64:
        assert bool(within.all()) and int((r.source < 0).sum()) > 0
    else:
        assert not bool(within.all())
    disp, comb = _dense_by_index_put(r.experts, r.gates, pos, within, e,
                                     capacity)
    got = moe.route_topk(logits, k, capacity)
    assert torch.equal(got[0], disp) and torch.equal(got[1], comb)
    assert torch.equal(got[2], r.aux)


@pytest.mark.parametrize("k,capacity_factor",
                         [(2, 1.25), (1, 0.5), (1, 0.25), (2, 0.5)])
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


def _scalar(out, aux):
    return (out.float() ** 2).sum() * 0.5 + 3.0 * aux


@pytest.mark.parametrize("k,capacity_factor", [(2, 1.25), (1, 0.5),
                                               (2, 0.5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_indexed_path_matches_the_dense_formulation(k, capacity_factor,
                                                    dtype):
    """The local path against the mesh path's dense einsums (taken here
    by a ``constrain`` that changes nothing): bf16 bit for bit, f32
    within rounding (the einsums' fused multiply-adds)."""
    arrays = [torch.from_numpy(a) for a in _moe_inputs(10 + k)]
    arrays[0] = arrays[0].to(dtype)
    kw = dict(num_selected=k, capacity_factor=capacity_factor)
    outs, grads = [], []
    for constrain in (None, lambda x, axes: x):
        tens = [a.clone().requires_grad_() for a in arrays]
        got = moe.moe_ffn(*tens, constrain=constrain, **kw)
        outs.append(got)
        grads.append(torch.autograd.grad(_scalar(got.out, got.aux_loss),
                                         tens))
    (a, b), tol = outs, 0 if dtype == torch.bfloat16 else 1e-6
    assert a.out.dtype == b.out.dtype == dtype
    assert torch.equal(a.aux_loss, b.aux_loss)
    assert torch.equal(a.router_probs, b.router_probs)
    torch.testing.assert_close(a.out, b.out, rtol=0, atol=tol)
    for ga, gb in zip(*grads):
        torch.testing.assert_close(ga, gb, rtol=0, atol=tol * 10)


def test_local_path_builds_no_dense_tensor(monkeypatch):
    def refuse(r):
        raise AssertionError("the local path built a (T, E, C) tensor")

    monkeypatch.setattr(moe, "dense", refuse)
    tens = [torch.from_numpy(a).requires_grad_() for a in _moe_inputs(3)]
    got = moe.moe_ffn(*tens, num_selected=2, capacity_factor=1.25)
    torch.autograd.grad(_scalar(got.out, got.aux_loss), tens)
    with pytest.raises(AssertionError, match="built a"):
        moe.route_topk(tens[0].detach() @ tens[1].detach(), 2, 8)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_plain_gather_and_combine_against_a_loop(k):
    gen = torch.Generator().manual_seed(k)
    t, d = 10, 8
    s = t * k + 4
    src = torch.randn(t, d, generator=gen)
    w = torch.rand(t, k, generator=gen)
    b = torch.randn(s, d, generator=gen)
    # Every (token, choice) in one slot, some of them dropped, 4 + more
    # slots empty.
    source = torch.cat([torch.randperm(t * k, generator=gen),
                        torch.full((4,), -1)])
    source[::3] = -1
    source = source[torch.randperm(s, generator=gen)].to(torch.int32)
    out, dot = moe.gather(src, source, k, w=w, b=b)
    for i, a in enumerate(source.tolist()):
        if a < 0:
            assert not out[i].any() and dot[i] == 0
        else:
            assert torch.equal(out[i], w.view(-1)[a] * src[a // k])
            torch.testing.assert_close(dot[i], src[a // k] @ b[i])
    assert torch.equal(moe.gather(src, source, k)[0][source >= 0],
                       src[source[source >= 0].long() // k])
    slot = torch.randint(-1, s, (t, k), generator=gen, dtype=torch.int32)
    got = moe.combine(b, slot, w)
    for i in range(t):
        want = torch.zeros(d)
        for c in range(k):
            if slot[i, c] >= 0:
                want = want + w[i, c] * b[slot[i, c]]
        assert torch.equal(got[i], want)
    assert torch.equal(moe.combine(b, slot), moe.combine(
        b, slot, torch.ones(t, k)))

"""Parity of the PyTorch port's ops with the JAX reference on CPU.

The same numpy inputs (``numpy.random.default_rng``) go through the JAX
function — Pallas kernels in interpret mode, as tests/test_ops.py and
tests/test_paged_attention.py run them — and through the port, whose CPU
tensors take each kernel's plain PyTorch version.  Tolerances are f32
rounding of differently ordered sums (1e-4 for attention outputs, lse and
gradients, 1e-5 for the paged decode, 1e-6 for elementwise layers); the
``window=1`` paged gather is exact in both.  In bf16 the flash gradients
are held to the reference's rounding points (see
``test_flash_grads_bf16_match_jax``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tpu.ops import attention as jax_attention
from ray_tpu.ops import layers as jax_layers
from ray_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_reference as jax_paged_reference)
from ray_tpu_torch.ops import (
    apply_rope, flash_attention, flash_attention_fwd, mha_reference,
    paged_attention, paged_attention_reference, rms_norm, rope)

# Tiny shapes: more intra-op threads would only contend with the test
# files that pytest-xdist runs beside these.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _qkv(seed, b, s, h, h_kv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, h_kv, d)).astype(np.float32),
            rng.normal(size=(b, s, h_kv, d)).astype(np.float32))


@pytest.mark.parametrize("causal,h_kv,s", [
    (True, 4, 128), (False, 4, 128), (True, 2, 96)])
def test_flash_attention_matches_jax(causal, h_kv, s):
    """o against ray_tpu.ops.flash_attention (Pallas, interpret), incl.
    GQA 4 -> 2 and a sequence the port's kernel tiles raggedly (96).
    Batch 1: the interpreted Pallas grid costs time in proportion to it."""
    q, k, v = _qkv(0, 1, s, 4, h_kv, 32)
    want = np.asarray(jax_attention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    assert np.max(np.abs(got - want)) < 1e-4


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_matches_jax_fwd_call(causal):
    """lse (b, h, s), log2 domain, against the reference kernel's
    lane-replicated lse ``_fwd_call(...)[1][..., 0]``."""
    q, k, v = _qkv(1, 1, 128, 4, 4, 32)
    scale = 32 ** -0.5
    qt, kt, vt = (jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))
                  for x in (q, k, v))
    qs = (qt * (scale * jax_attention._LOG2E)).astype(qt.dtype)
    o_t, lse = jax_attention._fwd_call(qs, kt, vt, causal, 64, 64, True)
    got_o, got_lse = flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal)
    assert got_lse.shape == (1, 4, 128) and got_lse.dtype == torch.float32
    assert np.max(np.abs(got_lse.numpy() - np.asarray(lse)[..., 0])) < 1e-4
    want_o = np.transpose(np.asarray(o_t), (0, 2, 1, 3))
    assert np.max(np.abs(got_o.numpy() - want_o)) < 1e-4


def test_mha_reference_matches_jax():
    q, k, v = _qkv(2, 1, 40, 2, 2, 16)
    want = np.asarray(jax_attention.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = mha_reference(_t(q), _t(k), _t(v), causal=True).numpy()
    assert np.max(np.abs(got - want)) < 1e-5


def _jax_flash_grads(q, k, v, do, causal, dtype):
    """dq, dk, dv of ray_tpu's flash_attention (Pallas, interpret) under
    the cotangent ``do``, as f32 numpy."""
    def f(q_, k_, v_):
        o = jax_attention.flash_attention(q_, k_, v_, causal=causal,
                                          interpret=True)
        return jnp.sum(o.astype(jnp.float32) * do)

    args = (jnp.asarray(x, dtype) for x in (q, k, v))
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _port_flash_grads(q, k, v, do, causal, dtype):
    qt, kt, vt = (_t(x).to(dtype).requires_grad_() for x in (q, k, v))
    o = flash_attention(qt, kt, vt, causal=causal)
    return [g.float().numpy() for g in torch.autograd.grad(
        o, (qt, kt, vt), _t(do).to(dtype))]


@pytest.mark.parametrize("causal,h_kv,s", [
    (True, 4, 128), (False, 4, 128), (True, 2, 96)])
def test_flash_grads_match_jax(causal, h_kv, s):
    """dq, dk, dv against jax.grad of ray_tpu's flash_attention (its
    custom VJP: the Pallas _dkdv_kernel and _dq_kernel, interpret mode)
    under a random cotangent, incl. GQA 4 -> 2 and a ragged length; f32,
    within 1e-4 (observed: 1.2e-6)."""
    q, k, v = _qkv(10, 1, s, 4, h_kv, 32)
    do = np.random.default_rng(11).normal(size=q.shape).astype(np.float32)
    want = _jax_flash_grads(q, k, v, do, causal, jnp.float32)
    got = _port_flash_grads(q, k, v, do, causal, torch.float32)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        assert np.max(np.abs(g - w)) < 1e-4, name


def test_flash_grads_bf16_match_jax():
    """In bf16 the port rounds where the reference rounds: the pre-scaled
    q (its scale a bf16 constant, as JAX's weak typing makes it), p
    before dv, ds before dk and dq, dk/dv per q head before the GQA sum.
    Each grad is within one bf16 ulp at its largest magnitude (2**-7 *
    max|ref|), and at most 15% of its elements differ at all (observed:
    0-7%, one ulp, from f32 sums taken in another order; a misplaced
    rounding point shows in 60-75%)."""
    q, k, v = _qkv(12, 1, 96, 4, 2, 32)
    do = np.random.default_rng(13).normal(size=q.shape).astype(np.float32)
    want = _jax_flash_grads(q, k, v, do, True, jnp.bfloat16)
    got = _port_flash_grads(q, k, v, do, True, torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        assert np.max(np.abs(g - w)) <= 2.0 ** -7 * np.max(np.abs(w)), name
        assert np.mean(g != w) <= 0.15, name


def test_plain_flash_path_is_differentiable_on_cpu():
    """The CPU path's backward (the plain versions of K2 and K3) gives
    the gradients autograd takes through ``mha_reference``."""
    q, k, v = (_t(x).requires_grad_() for x in _qkv(3, 1, 70, 2, 2, 16))
    (flash_attention(q, k, v) ** 2).sum().backward()
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
    (mha_reference(qr, kr, vr) ** 2).sum().backward()
    for a, b in ((q, qr), (k, kr), (v, vr)):
        assert torch.max(torch.abs(a.grad - b.grad)) < 1e-4


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    want = np.asarray(jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    got = rms_norm(_t(x), _t(w)).numpy()
    assert np.max(np.abs(got - want)) < 1e-6


def test_rope_with_offset_matches_jax():
    cos_w, sin_w = jax_layers.rope(32, 32, offset=32)
    cos, sin = rope(32, 32, offset=32)
    assert np.max(np.abs(cos.numpy() - np.asarray(cos_w))) < 1e-6
    assert np.max(np.abs(sin.numpy() - np.asarray(sin_w))) < 1e-6
    x = np.random.default_rng(5).normal(size=(1, 32, 2, 32)).astype(
        np.float32)
    want = np.asarray(jax_layers.apply_rope(jnp.asarray(x), cos_w, sin_w))
    got = apply_rope(_t(x), cos, sin).numpy()
    assert np.max(np.abs(got - want)) < 1e-6


def _random_paged(rng, B, h, d, bs, num_blocks, max_ctx):
    """Shuffled physical blocks, ragged lengths, arbitrary (valid)
    padding entries past each sequence's last page."""
    q = rng.normal(size=(B, h, d)).astype(np.float32)
    kc = rng.normal(size=(num_blocks, bs, h, d)).astype(np.float32)
    vc = rng.normal(size=(num_blocks, bs, h, d)).astype(np.float32)
    cls = rng.integers(1, max_ctx + 1, size=B).astype(np.int32)
    cls[0] = max_ctx
    width = -(-max_ctx // bs)
    bt = rng.permutation(num_blocks)[: B * width].reshape(B, width)
    bt = bt.astype(np.int32)
    for b in range(B):
        pages = -(-int(cls[b]) // bs)
        bt[b, pages:] = rng.integers(0, num_blocks, size=width - pages)
    return q, kc, vc, bt, cls


@pytest.mark.parametrize("h,d,bs", [(1, 32, 8), (4, 32, 8), (2, 64, 16)])
def test_paged_attention_matches_jax_kernel(h, d, bs):
    """Against ray_tpu.ops.paged_attention (Pallas, interpret) over
    windows 0 (all), 1 (exact gather) and 5 (trailing)."""
    rng = np.random.default_rng(6)
    q, kc, vc, bt, cls = _random_paged(rng, B=3, h=h, d=d, bs=bs,
                                       num_blocks=16, max_ctx=3 * bs - 2)
    for window in (0, 1, 5):
        want = np.asarray(jax_paged_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), bt, cls,
            window=window, interpret=True))
        got = paged_attention(_t(q), _t(kc), _t(vc), torch.from_numpy(bt),
                              torch.from_numpy(cls), window=window).numpy()
        if window == 1:
            assert np.array_equal(got, want), window
            for b in range(3):      # ... and both are the stored row
                n = int(cls[b])
                row = vc[bt[b, (n - 1) // bs], (n - 1) % bs]
                assert np.array_equal(got[b], row), b
        else:
            assert np.max(np.abs(got - want)) < 1e-5, window


def test_paged_attention_bf16_bitwise_jax_kernel():
    """In bf16 the plain K4 rounds where the reference kernel rounds (p to
    v's dtype before P.V, l from the f32 p, page by page): bitwise against
    ray_tpu.ops.paged_attention (Pallas, interpret) over windows 0, 1, 5,
    with ragged contexts and every pool page filled past them."""
    rng = np.random.default_rng(9)
    q, kc, vc, bt, cls = _random_paged(rng, B=3, h=4, d=64, bs=16,
                                       num_blocks=12, max_ctx=47)
    cls[1:] = [1, 23]
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, kc, vc))
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, kc, vc))
    for window in (0, 1, 5):
        want = np.asarray(jax_paged_attention(
            jq, jk, jv, bt, cls, window=window, interpret=True
        ).astype(jnp.float32))
        got = paged_attention(tq, tk, tv, torch.from_numpy(bt),
                              torch.from_numpy(cls), window=window)
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.float().numpy(), want), window


@pytest.mark.parametrize("window", [0, 1, 7])
def test_paged_attention_reference_matches_jax(window):
    rng = np.random.default_rng(7)
    q, kc, vc, bt, cls = _random_paged(rng, B=4, h=2, d=16, bs=8,
                                       num_blocks=32, max_ctx=29)
    want = np.asarray(jax_paged_reference(
        q, kc, vc, bt, cls, window=window))
    got = paged_attention_reference(_t(q), _t(kc), _t(vc), bt, cls,
                                    window=window).numpy()
    assert np.max(np.abs(got - want)) < 1e-5
    plain = paged_attention(_t(q), _t(kc), _t(vc), torch.from_numpy(bt),
                            torch.from_numpy(cls), window=window).numpy()
    assert np.max(np.abs(plain - want)) < 1e-5


def test_paged_padding_entries_never_leak():
    """Padding table entries may point at blocks full of inf/NaN: the
    plain version masks them (scores and values), as the kernel never
    reads them."""
    rng = np.random.default_rng(8)
    q, kc, vc, bt, cls = _random_paged(rng, B=2, h=1, d=16, bs=8,
                                       num_blocks=12, max_ctx=20)
    cls[1] = 3                                    # one page + 2 padding
    pages = [-(-int(n) // 8) for n in cls]
    live = {int(x) for b in range(2) for x in bt[b, : pages[b]]}
    dead = sorted(set(range(12)) - live)
    kc2, vc2, bt2 = kc.copy(), vc.copy(), bt.copy()
    kc2[dead], vc2[dead] = np.inf, np.nan
    bt2[1, pages[1]:] = dead[0]
    out = paged_attention(_t(q), _t(kc2), _t(vc2), torch.from_numpy(bt2),
                          torch.from_numpy(cls)).numpy()
    assert np.isfinite(out).all()
    ref = paged_attention_reference(_t(q), _t(kc), _t(vc), bt, cls).numpy()
    assert np.max(np.abs(out - ref)) < 1e-5

"""The port's CUDA kernels against their plain PyTorch versions on the
card, plus CPU tests of what surrounds them.

Tests marked ``gpu`` need a CUDA card: the ``cuda`` fixture decides that
when the test runs (never at import or collection, so every pytest-xdist
worker collects the same tests) and skips without one.  On the card:

    python -m pytest -m gpu tests/test_torch_kernels.py

Shapes are chip_smoke.py's: K1 at the flagship shape (b=4, s=512, h=6,
d=128, bf16, causal), one non-causal and one ragged GQA case, o within
2e-2 (bf16 output, f32 accumulation) and lse within 1e-3 (f32), and at
the edges of its tiling (lengths 1, 65, 127, 129, MQA, d = 32 and 64,
sq != sk, the long shape of llama2_7b's heads); K2 and
K3 at the same three shapes, dq, dk and dv within 2e-2 * max|plain| of
the plain backward on the same inputs (a few bf16 ulps at the largest
magnitude); K4 exact at the serving shape (f32, h=1, d=32, block 8,
window=1) and each element within 1e-3 + 1e-2 * |plain| at a general
bf16 shape, at f32 and bf16 with d = 32, 64, 128, 256, at the edges of
its pages and of its split plan, with poisoned pages, and bitwise at
window=1 at the long-batch shape (llama2_7b's heads, 32 x 2048).  The CPU
tests pin K4's split plan, ring and lane layout, its folded pre-scale and
the decoder's staging of tables.  The K4 card tests alone:

    python -m pytest -m gpu tests/test_torch_kernels.py -k paged

K6 (``moe_gather``/``moe_combine``) at d = 4096 in bf16 and d = 64 in
f32, on a token count that is no multiple of a block's 8 rows: the
kernels bitwise their plain versions (each output element is one product,
or a sum in the same order), the gates' dots within 1e-4 of the sum of
their terms' magnitudes (the f32 sums run in another order), empty slots
zero, two runs bitwise equal; the MoE layer's output and its grads of x,
the router and the expert weights against the layer on the plain
versions; the wrapper's refusals and its launch counts.
"""

import ctypes
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build, attention, moe
from ray_tpu_torch.ops.attention import flash_attention_fwd
from ray_tpu_torch.ops.layers import repeat_kv_heads
from ray_tpu_torch.ops.paged_attention import (
    _paged_attention_plain, paged_attention)

# The module (the package re-exports the function over its name).
paged_mod = importlib.import_module("ray_tpu_torch.ops.paged_attention")

# Tiny shapes: more intra-op threads would only contend with the test
# files that pytest-xdist runs beside these.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest -m gpu "
                    "tests/test_torch_kernels.py on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _bf16(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,h_kv,causal", [
    (4, 512, 6, 6, True), (2, 256, 6, 6, False), (2, 500, 6, 2, True)])
def test_flash_kernel_matches_plain(cuda, b, s, h, h_kv, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _bf16(gen, (b, s, h, 128), cuda)
    k = _bf16(gen, (b, s, h_kv, 128), cuda)
    v = _bf16(gen, (b, s, h_kv, 128), cuda)
    before = _build.launches["rtt_flash_fwd_bf16"]
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    assert _build.launches["rtt_flash_fwd_bf16"] == before + 1
    k2, v2 = repeat_kv_heads(q, k, v)
    o_p, lse_p = attention._flash_fwd_plain(
        attention._prescale(q, 128 ** -0.5), k2, v2, causal)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and lse.shape == (b, h, s)
    assert float((o.float() - o_p.float()).abs().max()) <= 2e-2
    assert float((lse - lse_p).abs().max()) <= 1e-3


def _check_flash_kernel(dev, b, sq, sk, h, h_kv, d, causal):
    gen = torch.Generator(device=dev).manual_seed(sq * 7 + sk)
    q = _bf16(gen, (b, sq, h, d), dev)
    k = _bf16(gen, (b, sk, h_kv, d), dev)
    v = _bf16(gen, (b, sk, h_kv, d), dev)
    qs = attention._prescale(q, d ** -0.5)
    o, lse = attention._flash_fwd_cuda(qs, k, v, causal)
    k2, v2 = repeat_kv_heads(q, k, v)
    o_p, lse_p = attention._flash_fwd_plain(qs, k2, v2, causal)
    torch.cuda.synchronize()
    assert o.shape == (b, sq, h, d) and lse.shape == (b, h, sq)
    assert float((o.float() - o_p.float()).abs().max()) <= 2e-2
    assert float((lse - lse_p).abs().max()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,h_kv,d,causal", [
    (2, 1, 1, 4, 4, 128, True), (2, 65, 65, 4, 4, 128, True),
    (2, 127, 127, 4, 4, 128, True), (2, 129, 129, 4, 4, 128, True),
    (2, 300, 300, 8, 1, 128, True),                      # MQA
    (2, 200, 200, 4, 2, 32, True), (2, 200, 200, 4, 2, 64, False),
    (2, 100, 300, 4, 4, 128, False), (2, 300, 100, 4, 4, 128, False),
    (2, 300, 100, 4, 4, 128, True),
    (1, 2048, 2048, 32, 32, 128, True)])                 # llama2_7b's heads
def test_flash_kernel_edges_match_plain(cuda, b, sq, sk, h, h_kv, d, causal):
    _check_flash_kernel(cuda, b, sq, sk, h, h_kv, d, causal)


@pytest.mark.gpu
def test_flash_kernel_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 128), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 8, 2, 80), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=cuda,
                    requires_grad=True)
    before = dict(_build.launches)
    flash_attention_fwd(q, q, q)[0].sum().backward()
    assert q.grad.shape == q.shape and bool(torch.isfinite(q.grad).all())
    for name in ("rtt_flash_dkdv_bf16", "rtt_flash_dq_bf16"):  # K2 + K3
        assert _build.launches[name] == before.get(name, 0) + 1


def _bwd_case(gen, b, sq, sk, h, h_kv, d, dev):
    """Inputs of the backward kernels: pre-scaled q, k, v, do."""
    q = _bf16(gen, (b, sq, h, d), dev)
    k = _bf16(gen, (b, sk, h_kv, d), dev)
    v = _bf16(gen, (b, sk, h_kv, d), dev)
    do = _bf16(gen, (b, sq, h, d), dev)
    return attention._prescale(q, d ** -0.5), k, v, do


def _check_flash_bwd(dev, b, sq, sk, h, h_kv, d, causal, seed):
    """K3 then K2 (as the backward launches them) against the plain
    versions on the same inputs, o and lse from K1: dq, dk, dv within
    2e-2 * max|plain| + 1e-5, and K3's delta within 1e-5 of ``_delta``'s
    (relative to its largest magnitude).  The 1e-5 floor is for sk = 1:
    a softmax over one key has no gradient in its score, so dq and dk are
    0 up to f32 rounding (dp - delta) on both sides (observed: 6.5e-7
    against a plain max of 2.5e-7)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qs, k, v, do = _bwd_case(gen, b, sq, sk, h, h_kv, d, dev)
    o, lse = attention._flash_fwd_cuda(qs, k, v, causal)
    before = dict(_build.launches)
    dq, delta = attention._flash_dq_cuda(qs, k, v, o, do, lse, causal,
                                         d ** -0.5)
    dk, dv = attention._flash_dkdv_cuda(qs, k, v, do, lse, delta, causal)
    for name in ("rtt_flash_dkdv_bf16", "rtt_flash_dq_bf16"):
        assert _build.launches[name] == before.get(name, 0) + 1
    delta_p = attention._delta(o, do)
    k2, v2 = repeat_kv_heads(qs, k, v)
    dk_p, dv_p = (attention._sum_kv_groups(x, h_kv) for x in
                  attention._flash_dkdv_plain(qs, k2, v2, do, lse, delta_p,
                                              causal))
    dq_p = attention._flash_dq_plain(qs, k2, v2, do, lse, delta_p, causal,
                                     d ** -0.5)
    torch.cuda.synchronize()
    assert delta.shape == (b, h, sq) and delta.dtype == torch.float32
    assert float((delta - delta_p).abs().max()) <= \
        1e-5 * float(delta_p.abs().max())
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2e-2 * float(want.float().abs().max()) + 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,h_kv,causal", [
    (4, 512, 6, 6, True), (2, 256, 6, 6, False), (2, 500, 6, 2, True)])
def test_flash_bwd_kernels_match_plain(cuda, b, s, h, h_kv, causal):
    _check_flash_bwd(cuda, b, s, s, h, h_kv, 128, causal, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,h_kv,d,causal", [
    (2, 1, 1, 4, 4, 128, True), (2, 65, 65, 4, 4, 128, True),
    (2, 127, 127, 4, 4, 128, True), (2, 129, 129, 4, 4, 128, True),
    (2, 300, 300, 8, 1, 128, True),                      # MQA
    (2, 200, 200, 4, 2, 32, True), (2, 200, 200, 4, 2, 64, False),
    (2, 100, 300, 4, 4, 128, False), (2, 300, 100, 4, 4, 128, False),
    (2, 300, 100, 4, 4, 128, True), (2, 100, 300, 4, 4, 128, True),
    (1, 2048, 2048, 32, 32, 128, True)])                 # llama2_7b's heads
def test_flash_bwd_kernel_edges_match_plain(cuda, b, sq, sk, h, h_kv, d,
                                            causal):
    _check_flash_bwd(cuda, b, sq, sk, h, h_kv, d, causal, seed=sq * 7 + sk)


@pytest.mark.gpu
def test_flash_bwd_launches_k3_first_with_its_delta(cuda, monkeypatch):
    """The backward of CUDA tensors launches K3, then K2 with K3's delta,
    and runs no PyTorch delta chain."""
    calls = []

    def spy(name, fn):
        def call(*args):
            out = fn(*args)
            calls.append((name, out))
            return out
        return call

    for name in ("_flash_dq_cuda", "_flash_dkdv_cuda", "_delta"):
        monkeypatch.setattr(attention, name,
                            spy(name, getattr(attention, name)))
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (_bf16(gen, (2, 200, 4, 64), cuda).requires_grad_()
               for _ in range(3))
    do = _bf16(gen, (2, 200, 4, 64), cuda)
    o, _ = flash_attention_fwd(q, k, v)
    o.backward(do)
    assert [name for name, _ in calls] == ["_flash_dq_cuda",
                                           "_flash_dkdv_cuda"]
    delta = calls[0][1][1]
    want = attention._delta(o.detach(), do)
    torch.cuda.synchronize()
    assert float((delta - want).abs().max()) <= \
        1e-5 * float(want.abs().max())


@pytest.mark.gpu
def test_flash_bwd_kernels_raise_on_what_they_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    qs, k, v, do = _bwd_case(gen, 1, 64, 64, 2, 2, 128, cuda)
    o = torch.zeros_like(qs)
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        attention._flash_dkdv_cuda(qs.float(), k, v, do, lse, lse, True)
    with pytest.raises(ValueError, match="do must be"):
        attention._flash_dq_cuda(qs, k, v, o, do.float(), lse, True, 1.0)
    with pytest.raises(ValueError, match="o must be"):
        attention._flash_dq_cuda(qs, k, v, o[:, :32], do, lse, True, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        attention._flash_dkdv_cuda(qs, k, v, do.transpose(1, 2)
                                   .contiguous().transpose(1, 2), lse, lse,
                                   True)
    with pytest.raises(ValueError, match="lse must be"):
        attention._flash_dq_cuda(qs, k, v, o, do, lse[:, :, :32], True, 1.0)
    with pytest.raises(ValueError, match="delta must be"):
        attention._flash_dkdv_cuda(qs, k, v, do, lse, lse.double(), True)
    q80 = torch.zeros((1, 64, 2, 80), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attention._flash_dq_cuda(q80, q80, q80, q80, q80, lse, True, 1.0)
    # What they do take runs.
    _, delta = attention._flash_dq_cuda(qs, k, v, o, do, lse, True, 1.0)
    attention._flash_dkdv_cuda(qs, k, v, do, lse, delta, True)


def _paged_case(seed, B, h, d, bs, max_ctx, dtype, dev, cl=None, extra=0):
    """q, a pool of B * width (+ ``extra``) pages, tables permuted over it,
    and context lengths (random in [1, max_ctx] unless given)."""
    rng = np.random.default_rng(seed)
    width = -(-max_ctx // bs)
    nb = B * width
    q = torch.from_numpy(rng.normal(size=(B, h, d))).to(dev, dtype)
    kc = torch.from_numpy(rng.normal(size=(nb + extra, bs, h, d))).to(dev,
                                                                      dtype)
    vc = torch.from_numpy(rng.normal(size=(nb + extra, bs, h, d))).to(dev,
                                                                      dtype)
    bt = rng.permutation(nb).reshape(B, width).astype(np.int32)
    if cl is None:
        cl = rng.integers(1, max_ctx + 1, size=B)
    return (q, kc, vc, torch.from_numpy(bt).to(dev),
            torch.from_numpy(np.asarray(cl, np.int32)).to(dev))


def _paged_plain(q, kc, vc, bt, cl, window):
    return _paged_attention_plain(attention._prescale(q, q.shape[-1] ** -0.5),
                                  kc, vc, bt, cl, window)


def _assert_paged_close(out, plain):
    """Each element within 1e-3 + 1e-2 * |plain|: one bf16 ulp of
    rounding passes, a lost or repeated page does not."""
    plain = plain.float()
    assert bool(((out.float() - plain).abs()
                 <= 1e-3 + 1e-2 * plain.abs()).all())


@pytest.mark.gpu
def test_paged_kernel_serving_shape_is_exact(cuda):
    q, kc, vc, bt, cl = _paged_case(0, 8, 1, 32, 8, 40, torch.float32, cuda)
    before = _build.launches["rtt_paged_decode"]
    out = paged_attention(q, kc, vc, bt, cl, window=1)
    assert _build.launches["rtt_paged_decode"] == before + 1
    plain = _paged_attention_plain(attention._prescale(q, 32 ** -0.5), kc,
                                   vc, bt, cl, 1)
    assert torch.equal(out, plain)
    pos = (cl.long() - 1)
    rows = vc[bt.long()[torch.arange(8, device=cuda), pos // 8], pos % 8]
    assert torch.equal(out, rows)                  # the stored last rows


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 64])
def test_paged_kernel_general_shape(cuda, window):
    q, kc, vc, bt, cl = _paged_case(1, 8, 6, 128, 16, 1024, torch.bfloat16,
                                    cuda)
    out = paged_attention(q, kc, vc, bt, cl, window=window)
    plain = _paged_attention_plain(attention._prescale(q, 128 ** -0.5), kc,
                                   vc, bt, cl, window).float()
    # One bf16 ulp of rounding passes; a lost or repeated page does not.
    assert bool(((out.float() - plain).abs()
                 <= 1e-3 + 1e-2 * plain.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_paged_kernel_dtypes_and_head_dims(cuda, dtype, d):
    q, kc, vc, bt, cl = _paged_case(d, 4, 4, d, 16, 300, dtype, cuda)
    for window in (0, 40):
        _assert_paged_close(paged_attention(q, kc, vc, bt, cl, window=window),
                            _paged_plain(q, kc, vc, bt, cl, window))
    assert torch.equal(paged_attention(q, kc, vc, bt, cl, window=1),
                       _paged_plain(q, kc, vc, bt, cl, 1))


@pytest.mark.gpu
def test_paged_kernel_split_edges(cuda):
    """Contexts at the edges of pages and of the split plan: 1, bs, bs + 1,
    one split's length, that + 1, and the whole table; one launch a call,
    split or not."""
    B, h, d, bs, width = 6, 16, 128, 16, 40
    nsplit, pps = paged_mod._split_plan(
        B, h, width, bs, 0, _build.sm_count(cuda.index))
    assert nsplit > 1 and pps > 1
    span = pps * bs
    q, kc, vc, bt, cl = _paged_case(
        5, B, h, d, bs, width * bs, torch.bfloat16, cuda,
        cl=[1, bs, bs + 1, span, span + 1, width * bs])
    for window in (0, 1, span, span + 1):
        before = _build.launches["rtt_paged_decode"]
        out = paged_attention(q, kc, vc, bt, cl, window=window)
        assert _build.launches["rtt_paged_decode"] == before + 1
        _assert_paged_close(out, _paged_plain(q, kc, vc, bt, cl, window))


@pytest.mark.gpu
def test_paged_kernel_poisoned_pages(cuda):
    """Table entries past the context point at a NaN page, and positions
    past the context inside the last live page are NaN: the output is
    finite and matches plain on the clean data."""
    B, h, d, bs, width = 4, 8, 128, 16, 32
    ctx = [1, 17, 250, 512]
    q, kc, vc, bt, cl = _paged_case(6, B, h, d, bs, width * bs,
                                    torch.bfloat16, cuda, cl=ctx, extra=1)
    assert paged_mod._split_plan(B, h, width, bs, 0, 132)[0] > 1
    nan_page = kc.shape[0] - 1
    clean_k, clean_v = kc.clone(), vc.clone()
    bad_bt = bt.clone()
    for b, c in enumerate(ctx):
        bad_bt[b, -(-c // bs):] = nan_page
        last = int(bt[b, (c - 1) // bs])
        for x in (kc, vc):
            x[last, c % bs if c % bs else bs:] = float("nan")
    kc[nan_page] = float("nan")
    vc[nan_page] = float("inf")
    for window in (0, 5):
        out = paged_attention(q, kc, vc, bad_bt, cl, window=window)
        assert bool(torch.isfinite(out).all())
        _assert_paged_close(out, _paged_plain(q, clean_k, clean_v, bt, cl,
                                              window))


@pytest.mark.gpu
def test_paged_kernel_window_one_is_exact_at_the_long_batch_shape(cuda):
    """window=1 at llama2_7b's heads (bf16, h=32, d=128, bs=16) for 32
    sequences of 2048 positions: bitwise the stored last rows."""
    B, h, d, bs, width = 32, 32, 128, 16, 128
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = _bf16(gen, (B, h, d), cuda)
    kc = _bf16(gen, (B * width, bs, h, d), cuda)
    vc = _bf16(gen, (B * width, bs, h, d), cuda)
    bt = torch.randperm(B * width, generator=gen, device=cuda).view(
        B, width).int()
    cl = torch.full((B,), width * bs, dtype=torch.int32, device=cuda)
    out = paged_attention(q, kc, vc, bt, cl, window=1)
    assert torch.equal(out, vc[bt[:, -1].long(), bs - 1])


@pytest.mark.gpu
def test_paged_kernel_raises_on_what_it_does_not_take(cuda):
    def call(q, kc, bt=None, cl=None):
        B = q.shape[0]
        bt = torch.zeros((B, 2), dtype=torch.int32, device=cuda) \
            if bt is None else bt
        cl = torch.ones(B, dtype=torch.int32, device=cuda) if cl is None \
            else cl
        return paged_attention(q, kc, kc, bt, cl)

    def zeros(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=cuda)

    with pytest.raises(TypeError, match="float32 or bfloat16"):
        call(zeros(2, 2, 64, dtype=torch.float16),
             zeros(4, 16, 2, 64, dtype=torch.float16))
    with pytest.raises(ValueError, match="head_dim"):       # 72 B rows
        call(zeros(2, 2, 36), zeros(4, 16, 2, 36))
    with pytest.raises(ValueError, match="head_dim"):       # 120 B rows
        call(zeros(2, 2, 30, dtype=torch.float32),
             zeros(4, 16, 2, 30, dtype=torch.float32))
    with pytest.raises(ValueError, match="head_dim"):
        call(zeros(2, 2, 264), zeros(4, 16, 2, 264))
    with pytest.raises(ValueError, match="block_size"):     # ring too big
        call(zeros(2, 2, 256, dtype=torch.float32),
             zeros(4, 80, 2, 256, dtype=torch.float32))
    base = zeros(2 * 2 * 64 + 1, dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte"):
        call(base[1:].view(2, 2, 64), zeros(4, 16, 2, 64,
                                            dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        call(zeros(2, 2, 64).transpose(0, 1), zeros(4, 16, 2, 64))
    with pytest.raises(TypeError, match="int32"):
        call(zeros(2, 2, 64), zeros(4, 16, 2, 64),
             bt=torch.zeros((2, 2), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="do not fit"):
        call(zeros(2, 2, 64), zeros(4, 16, 2, 32))
    # What it does take runs: f32 rows of 16 B, bf16 of 16 B and d = 256.
    for d, dtype in ((4, torch.float32), (8, torch.bfloat16),
                     (256, torch.bfloat16)):
        out = call(zeros(2, 2, d, dtype=dtype), zeros(4, 16, 2, d,
                                                      dtype=dtype))
        torch.cuda.synchronize()
        assert out.shape == (2, 2, d) and bool((out == 0).all())


@pytest.mark.gpu
def test_paged_decoder_chains_on_card(cuda):
    """Greedy chains on the card (first-max argmax, K4 gathers) are
    bitwise the host reference."""
    import threading

    from ray_tpu_torch.serve.continuous import _ContinuousBatcher
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    dec = MeshShardedDecoder(paged=True, kv_blocks=128, speculative_k=3)
    b = _ContinuousBatcher(dec._paged_step, None, 8, 0.0, continuous=True,
                           kv=dec.serve_kv_engine)
    reqs = [{"prompt": list(range(20)) + [i], "tokens": 3 + i % 10}
            for i in range(16)]
    out = [None] * len(reqs)
    before = _build.launches["rtt_paged_decode"]

    def client(i):
        out[i] = b.submit(reqs[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    for r, got in zip(reqs, out):
        assert got == dec.reference_decode(r["prompt"], r["tokens"])
    assert _build.launches["rtt_paged_decode"] > before
    assert b.stats()["prefix_hits"] > 0


# -- CPU tests of what surrounds the kernels --------------------------------

def test_port_and_chip_smoke_import_no_jax_or_reference():
    """Every module of ray_tpu_torch, and chip_smoke.py, import neither
    jax nor anything of ray_tpu (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_tpu_torch\n"
        "for m in pkgutil.walk_packages(ray_tpu_torch.__path__,\n"
        "                               'ray_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ray_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeshShardedDecoder()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_card():
    """No card: chip_smoke.py exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout


def test_cpu_tensors_take_the_plain_path_without_launching():
    before = dict(_build.launches)
    q = torch.randn(1, 10, 2, 16)
    o, lse = flash_attention_fwd(q, q, q)
    assert o.shape == q.shape and lse.shape == (1, 2, 10)
    kc = torch.randn(4, 8, 2, 16)
    out = paged_attention(torch.randn(2, 2, 16), kc, kc,
                          torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
                          torch.tensor([9, 3], dtype=torch.int32))
    assert out.shape == (2, 2, 16)
    assert dict(_build.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_fwd(q.to("meta"), q.to("meta"), q.to("meta"))


def test_cpu_backward_runs_the_plain_kernels_without_launching():
    """The backward of CPU tensors is K2's and K3's plain versions (the
    GQA grads summed back to the kv heads), with no launch counted."""
    before = dict(_build.launches)
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((1, 20, 4, 16), generator=gen, requires_grad=True)
    k, v = (torch.randn((1, 20, 2, 16), generator=gen, requires_grad=True)
            for _ in range(2))
    do = torch.randn((1, 20, 4, 16), generator=gen)
    o, lse = flash_attention_fwd(q, k, v)
    assert not lse.requires_grad
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    qs = attention._prescale(q.detach(), 16 ** -0.5)
    k2, v2 = repeat_kv_heads(q, k.detach(), v.detach())
    delta = attention._delta(o.detach(), do)
    dk_p, dv_p = attention._flash_dkdv_plain(qs, k2, v2, do, lse.detach(),
                                             delta, True)
    assert torch.equal(dq, attention._flash_dq_plain(
        qs, k2, v2, do, lse.detach(), delta, True, 16 ** -0.5))
    assert torch.equal(dk, attention._sum_kv_groups(dk_p, 2))
    assert torch.equal(dv, attention._sum_kv_groups(dv_p, 2))
    assert dict(_build.launches) == before


def test_build_target_follows_the_headers(tmp_path, monkeypatch):
    """An edit to a csrc/*.cuh header alone renames (so rebuilds) every
    kernel library, as a source may include it."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert first == _build._target("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _build._target("k") != first
    assert _build._target("k").name.startswith("k-")


def test_build_function_configures_each_symbol_once(monkeypatch):
    """function() sets restype/argtypes once per (library, symbol,
    argtypes) and hands back the same configured function after that; a
    caller with other argtypes gets its own function and leaves the
    first one's signature as it was."""
    looked_up = []

    class FakeLib:
        def __getitem__(self, symbol):
            looked_up.append(symbol)
            return type("Fn", (), {})()

    monkeypatch.setattr(_build, "_libs", {"fake": FakeLib()})
    monkeypatch.setattr(_build, "_fns", {})
    args = [ctypes.c_void_p, ctypes.c_int]
    fn = _build.function("fake", "rtt_a", args)
    assert fn.argtypes == args and fn.restype is ctypes.c_int
    assert _build.function("fake", "rtt_a", list(args)) is fn
    assert _build.function("fake", "rtt_b", args) is not fn
    other = _build.function("fake", "rtt_a", [ctypes.c_int])
    assert other is not fn and other.argtypes == [ctypes.c_int]
    assert fn.argtypes == args
    assert looked_up == ["rtt_a", "rtt_b", "rtt_a"]


@pytest.mark.gpu
def test_current_stream_is_torchs(cuda):
    """The launches' stream is the one PyTorch runs on, under a stream
    context too."""
    assert _build.current_stream(cuda) == \
        torch.cuda.current_stream(cuda).cuda_stream
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        assert _build.current_stream(cuda) == side.cuda_stream


@pytest.mark.parametrize("fault,t,exc,match", [
    ("device", torch.zeros(4, 4), ValueError, "is on cpu"),
    ("dtype", torch.zeros(4, 4, dtype=torch.int64), TypeError, "int32"),
    ("shape", torch.zeros(4, 2, dtype=torch.int32), ValueError,
     "of shape"),
    ("contiguity", torch.zeros(4, 4, dtype=torch.int32).t(), ValueError,
     "not contiguous"),
    ("alignment", torch.zeros(17, dtype=torch.int32)[1:].view(4, 4),
     ValueError, "16-byte"),
])
def test_check_operand_refuses_each_fault(fault, t, exc, match):
    """The shared operand check raises the type each wrapper raised for
    the fault before it: TypeError for the dtype, ValueError for the
    rest; a tensor it takes comes back as its address."""
    dev = torch.device("cuda", 0) if fault == "device" else t.device
    with pytest.raises(exc, match=match):
        _build.check_operand("k", "x", t, dev, torch.int32, (4, 4),
                             aligned=True)
    ok = torch.zeros(4, 4, dtype=torch.int32)
    assert _build.check_operand("k", "x", ok, ok.device, torch.int32,
                                (4, 4), aligned=True) == ok.data_ptr()
    if fault == "alignment":    # only a kernel of 16-byte reads asks
        assert _build.check_operand("k", "x", t, dev, torch.int32) \
            == t.data_ptr()


@pytest.mark.parametrize("current", [True, False])
def test_launch_counts_its_symbol_on_the_device_stream(monkeypatch,
                                                       current):
    """launch() passes the arguments and, last, the device's current
    stream; enters the device's context only when it is not current;
    counts the launch under its C symbol; raises on an error code."""
    calls, entered = [], []

    def fn(*args):
        calls.append(args)
        return len(calls) - 1           # the second call fails

    class Lib:
        rtt_error_string = staticmethod(lambda err: b"bad launch")

    class Device:
        def __init__(self, dev):
            entered.append(dev)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_build, "function", lambda *key: fn)
    monkeypatch.setattr(_build, "library", lambda name: Lib())
    monkeypatch.setattr(_build, "current_stream", lambda dev: 7)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: 0 if current else 1)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(_build, "launches", _build.collections.Counter())
    dev = torch.device("cuda", 0)
    _build.launch("lib", "rtt_sym", (), dev, 1, 2)
    assert calls == [(1, 2, 7)] and _build.launches == {"rtt_sym": 1}
    assert entered == ([] if current else [dev])
    with pytest.raises(RuntimeError, match="lib kernel launch failed"):
        _build.launch("lib", "rtt_sym", (), dev, 3, stream=9)
    assert calls[1] == (3, 9) and _build.launches == {"rtt_sym": 2}


def test_prescale_constant_is_cached():
    """The bf16-rounded pre-scale constant is computed once per (sm_scale,
    dtype), and the product keeps the reference's bits."""
    q = torch.randn(1, 4, 2, 16).to(torch.bfloat16)
    attention._prescale(q, 0.25)
    hits = attention._prescale_const.cache_info().hits
    got = attention._prescale(q, 0.25)
    assert attention._prescale_const.cache_info().hits == hits + 1
    c = float(torch.tensor(0.25 * attention._LOG2E, dtype=torch.bfloat16))
    assert torch.equal(got, (q * c).to(torch.bfloat16))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_backward_work_at_the_flagship_shape():
    """chip_smoke's bytes and flop of K2 and K3 (each input read once,
    each output written once; 8 d and 6 d flop per causal pair) at the
    flagship shape are the figures PERF.md states, and K3's delta
    prologue adds one read of o (2 d f32 flop per row)."""
    work = _chip_smoke().k23_work(4, 512, 6, True, 128)
    assert work["K2"] == (18_972_672, 3_227_516_928)
    assert work["K3"] == (15_826_944, 2_420_637_696)
    assert work["delta"] == (3_145_728, 3_145_728)
    assert _chip_smoke().k23_work(2, 256, 6, False)["K3"][1] == \
        6 * 128 * 256 * 256 * 2 * 6


def test_split_plan_window_one_gives_one_split():
    for B, h, max_pages, bs in ((8, 1, 5, 8), (1, 1, 4096, 16),
                                (32, 32, 128, 16), (1, 64, 1, 1)):
        assert paged_mod._split_plan(B, h, max_pages, bs, 1, 132) == (1, 1)


def test_split_plan_covers_every_live_position_once():
    """Over random shapes, windows and contexts, the splits as the kernel
    walks them (split s takes live pages [first + s*pps, first +
    (s+1)*pps)) hold every live position exactly once, every split a
    whole number of pages."""
    rng = np.random.default_rng(11)
    for _ in range(300):
        B, h = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        bs = int(rng.choice([1, 3, 8, 16, 32]))
        max_pages = int(rng.integers(1, 200))
        window = int(rng.choice([0, 1, 2, int(rng.integers(1, 3000))]))
        nsplit, pps = paged_mod._split_plan(B, h, max_pages, bs, window,
                                            132)
        assert 1 <= nsplit <= max_pages and pps >= 1
        for ctx in {1, bs, max_pages * bs,
                    int(rng.integers(1, max_pages * bs + 1))}:
            start = max(ctx - window, 0) if window else 0
            first, last = start // bs, (ctx - 1) // bs
            seen = []
            for sp in range(nsplit):
                p0 = first + sp * pps
                for page in range(p0, min(p0 + pps, last + 1)):
                    seen += [x for x in range(page * bs, page * bs + bs)
                             if start <= x < ctx]
            assert seen == list(range(start, ctx)), (B, h, max_pages, bs,
                                                     window, ctx)


def test_split_plan_fills_the_card_at_small_batch():
    """Long contexts at small B give at least one wave of blocks over the
    132 SMs; a batch that already fills the card is not split."""
    for B, h in ((1, 2), (1, 8), (4, 32), (2, 6)):
        nsplit, pps = paged_mod._split_plan(B, h, 128, 16, 0, 132)
        assert B * h * nsplit >= 132 and nsplit * pps >= 128
    assert paged_mod._split_plan(32, 32, 128, 16, 0, 132) == (1, 128)


def test_ring_stages_fit_shared_memory():
    """At least 3 ring slots (each a page's k or v rows), at most 8, about
    26 KB; a page whose 3-slot ring and scores do not fit a block's shared
    memory raises."""
    assert paged_mod._ring_stages(16, 128, 2) == 6      # bf16, d = 128
    assert paged_mod._ring_stages(8, 32, 4) == 8        # f32, d = 32
    assert paged_mod._ring_stages(32, 256, 4) == 3      # f32, d = 256
    with pytest.raises(ValueError, match="block_size"):
        paged_mod._ring_stages(80, 256, 4)


def test_lanes_per_row_fill_the_warp_and_bound_registers():
    """Every lane gets a row of a page (R = 32 / LPR <= bs) and holds at
    most 64 f32 of q (VPL * E <= 64) for any bs and d <= 256."""
    for bs in (1, 3, 8, 16, 17, 32, 64):
        for d in (4, 8, 32, 64, 128, 136, 256):
            for elem in (2, 4):
                lpr = 1 << paged_mod._lanes_per_row(bs, d)
                assert lpr <= 32 and 32 // lpr <= max(bs, 1)
                nv = -(-d * elem // 16)
                assert -(-nv // lpr) * (16 // elem) <= 64, (bs, d, elem)


def test_paged_kernel_prescale_formula_matches_prescale():
    """The kernel rounds float32(q) * float32(c) to bf16 (nearest, ties to
    even) with c = _prescale_const: over random bf16 q that is bitwise
    _prescale(q), for the scales of d = 32, 64, 128, 256."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(scale=3.0, size=(64, 4, 128)).astype(
        np.float32)).to(torch.bfloat16)
    qf = q.float().numpy()
    for d in (32, 64, 128, 256):
        c = np.float32(attention._prescale_const(d ** -0.5, torch.bfloat16))
        u = (qf * c).astype(np.float32).view(np.uint32)
        rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16).view(
            np.float32)
        want = attention._prescale(q, d ** -0.5)
        assert np.array_equal(rounded, want.float().numpy())
        c32 = attention._prescale_const(d ** -0.5, torch.float32)
        q32 = q.float()
        assert torch.equal(attention._prescale(q32, d ** -0.5),
                           torch.from_numpy(qf * np.float32(c32)))


def test_chip_smoke_paged_work_at_the_long_shapes():
    """chip_smoke's bytes K4 must move at llama2_7b's heads (bf16, h=32,
    d=128, bs=16, 2048 positions each, window 0), for 4 and for 32
    sequences: the figures PERF.md states."""
    mod = _chip_smoke()
    for B, want in ((4, 134_285_328), (32, 1_074_282_624)):
        q = torch.zeros((B, 32, 128), dtype=torch.bfloat16)
        nbytes, flops = mod.k4_work(q, np.full(B, 2048), 0, 16)
        assert nbytes == want
        assert flops == 4 * 32 * 128 * 2048 * B


def test_read_last_stages_tables_in_one_buffer_on_cpu():
    """The paged decoder's _read_last packs the context lengths and block
    tables into one reused host buffer and returns each live request's
    stored last row, as the batch and the table width change."""
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    dec = MeshShardedDecoder(paged=True, kv_blocks=16, kv_block_size=4,
                             device="cpu")
    gen = torch.Generator().manual_seed(0)
    dec._kv_cache.copy_(torch.randn(dec._kv_cache.shape, generator=gen))

    class Slot:
        def __init__(self, table, pos):
            self.table, self.state = table, {"pos": pos}

    class Engine:
        def block_table(self, s):
            return s.table

    dec._kv_engine = Engine()
    sizes = []
    for live in ([Slot([3, 7], 6), Slot([1], 1)],
                 [Slot([0, 2, 4, 6, 8], 20), Slot([5], 3), Slot([9, 10], 5)],
                 [Slot([11], 4)],
                 [Slot([i, 15 - i, 12, 13, 14], 17 + i % 4) for i in range(6)]):
        got = dec._read_last(live)
        want = np.stack([dec._kv_cache[s.table[(s.state["pos"] - 1) // 4],
                                       (s.state["pos"] - 1) % 4, 0].numpy()
                         for s in live])
        assert np.array_equal(got, want)
        sizes.append(dec._stage_host.numel())
    # MAX_BATCH x (1 + width): allocated for width 2, grown once for 5.
    assert sizes == [8 * 3, 8 * 3, 8 * 3, 8 * 6]
    assert set(dec._zero_q) == {1, 2, 3, 6}


def test_kernel_sources_carry_their_note():
    """Each CUDA source names the Pallas kernel it replaces (the
    optimizer's and the MoE layer's: why they replace none) and its
    bound; the build keys each library on its source."""
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        if src.stem in ("optim", "moe"):   # K5, K6: XLA in the reference
            assert "Replaces no Pallas kernel: " in text, src.name
        else:
            assert "Replaces: ray_tpu/ops/" in text, src.name
        assert "Bound:" in text, src.name
        assert _build._target(src.stem).name.startswith(src.stem + "-")
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == {
        "flash_bwd", "flash_fwd", "moe", "optim", "paged_decode"}


# -- K6: the MoE layer's gather and combine ---------------------------------

def _moe_layer(dev, dtype, t, d, e=8, m=64, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(t, d, generator=gen, device=dev).to(dtype)
    router = torch.randn(d, e, generator=gen, device=dev) * d ** -0.5 * 4
    w_gate = torch.randn(e, d, m, generator=gen, device=dev) * d ** -0.5
    w_up = torch.randn(e, d, m, generator=gen, device=dev) * d ** -0.5
    w_down = torch.randn(e, m, d, generator=gen, device=dev) * m ** -0.5
    return [x, router, w_gate, w_up, w_down]


def _plain_k6(monkeypatch):
    monkeypatch.setattr(moe, "gather", lambda src, source, k, w=None, b=None:
                        moe._gather_plain(src, source, k, w, b))
    monkeypatch.setattr(moe, "combine", lambda src, slot, w=None:
                        moe._combine_plain(src, slot, w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 4096),
                                     (torch.float32, 64)])
def test_moe_kernels_match_the_plain_versions(cuda, dtype, d):
    t, k, e = 1003, 2, 8
    x = _moe_layer(cuda, dtype, t, d)[0]
    gen = torch.Generator(device=cuda).manual_seed(1)
    logits = torch.randn(t, e, generator=gen, device=cuda) * 2
    logits[:, 0] += 1.5              # an expert over its capacity
    r = moe.route(logits, k, int(1.25 * t * k / e))
    assert 0 < int((r.source < 0).sum()) and not bool(r.keep.all())
    w = (r.keep * r.gates).to(dtype)
    y = torch.randn(r.source.numel(), d, generator=gen,
                    device=cuda).to(dtype)
    g = torch.randn(t, d, generator=gen, device=cuda).to(dtype)
    runs = []
    for _ in range(2):
        runs.append((moe.gather(x, r.source, k)[0],
                     *moe.gather(g, r.source, k, w=w, b=y),
                     moe.combine(y, r.slot, w), moe.combine(y, r.slot)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)                   # deterministic
    disp, grad_y, dot, comb, comb1 = runs[0]
    empty = r.source < 0
    assert not disp[empty].any() and not grad_y[empty].any()
    assert not dot[empty].any()
    assert torch.equal(disp, moe._gather_plain(x, r.source, k, None, None)[0])
    want_y, want_dot = moe._gather_plain(g, r.source, k, w, y)
    assert torch.equal(grad_y, want_y)
    rows = g.index_select(0, r.source.long().clamp(min=0) // k).float()
    scale = (rows * y.float()).abs().sum(-1)
    assert bool(((dot - want_dot).abs() <= 1e-4 * scale).all())
    assert torch.equal(comb, moe._combine_plain(y, r.slot, w))
    assert torch.equal(comb1, moe._combine_plain(y, r.slot, None))


@pytest.mark.gpu
def test_moe_layer_grads_on_the_kernels_match_the_plain_versions(
        cuda, monkeypatch):
    t, k = 1003, 2
    arrays = _moe_layer(cuda, torch.bfloat16, t, 4096)
    runs = []
    for plain in (False, True):
        if plain:
            _plain_k6(monkeypatch)
        _build.reset_launches()
        tens = [a.clone().requires_grad_() for a in arrays]
        got = moe.moe_ffn(*tens, num_selected=k, capacity_factor=1.25)
        loss = (got.out.float() ** 2).sum() * 0.5 + 3.0 * got.aux_loss
        grads = torch.autograd.grad(loss, tens)
        torch.cuda.synchronize()
        runs.append((got.out, grads, dict(_build.launches)))
    (out, grads, launches), (p_out, p_grads, p_launches) = runs
    assert launches["rtt_moe_gather"] == 2 and launches["rtt_moe_combine"] \
        == 2
    assert not p_launches.get("rtt_moe_gather") and \
        not p_launches.get("rtt_moe_combine")
    assert torch.equal(out, p_out)
    # The expert weights see the same slots and grads bit for bit; the
    # gates' grads (x's through the router, and the router's) come from
    # dots summed in another order, each rounded to bf16.
    for name, a, b in zip(("x", "router", "w_gate", "w_up", "w_down"),
                          grads, p_grads):
        if name in ("w_gate", "w_up", "w_down"):
            assert torch.equal(a, b), name
        else:
            rel = float((a.float() - b.float()).norm() / b.float().norm())
            assert rel <= 1e-2, (name, rel)


@pytest.mark.gpu
def test_moe_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    x = torch.randn(16, 64, device=cuda, dtype=torch.bfloat16)
    source = torch.arange(32, device=cuda, dtype=torch.int32) % 16
    slot = torch.zeros(16, 2, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="is on cpu"):
        moe.gather(x, source.cpu(), 2)
    with pytest.raises(ValueError, match="is on cpu"):
        moe.combine(x, slot.cpu())
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        moe.gather(x.half(), source, 2)
    with pytest.raises(TypeError, match="int32"):
        moe.combine(x, slot.long())
    with pytest.raises(ValueError, match="not contiguous"):
        moe.gather(x.t().contiguous().t(), source, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        moe.combine(x[:, :60].contiguous(), slot)
    with pytest.raises(TypeError, match="bfloat16"):
        moe.combine(x, slot, torch.ones(16, 2, device=cuda))
    _build.reset_launches()
    moe.gather(x, source, 2)
    moe.combine(x, slot)
    assert _build.launches["rtt_moe_gather"] == 1
    assert _build.launches["rtt_moe_combine"] == 1

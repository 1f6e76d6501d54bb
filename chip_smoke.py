#!/usr/bin/env python3
"""Build and drive the PyTorch port (``ray_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. The card: name, count, ``nvidia-smi`` name and power limit; TF32 off.
2. Build every CUDA kernel from ``ray_tpu_torch/ops/csrc`` (one ``nvcc``
   per source, in parallel); print ptxas' register and spill lines.
3. K1 (flash-attention forward) against its plain PyTorch version at the
   flagship shape, one non-causal, one ragged GQA shape and the long
   shape (b=2, s=2048, h=32, d=128: the heads of ``llama2_7b`` at its
   max_seq_len): o within 2e-2 (bf16 output, f32 accumulation), lse
   within 1e-3 (f32).  At the flagship and the long shape: the times of
   the kernel, the plain version and ``scaled_dot_product_attention``
   beside the bound, and at the flagship the wrapper's host time per call.
4. K3 (dq, and delta = rowsum(o * do) in its prologue) then K2 (dk/dv),
   as the backward launches them, at the same four shapes against the
   plain backward on the same inputs: delta within 1e-5 * max|delta| of
   the PyTorch rowsum, each of dq, dk, dv within 2e-2 * max|plain| (a few
   bf16 ulps at the largest magnitude), and no further from an f32
   ``mha_reference`` autograd gradient than 2x the plain version's
   distance + 1e-3.  At the flagship and the long shape: the times of K3,
   K2, the plain versions and the SDPA backward (which covers K2 + K3 +
   delta together), and the bounds from ``k23_work``.
5. K4 (paged decode attention) against its plain version: exact at the
   serving shape (f32, h=1, d=32, block 8, window=1), with the wrapper's
   time per call there; at a general bf16 shape (B=8, h=6, d=128, block
   16, ctx 1-1024, windows 0 and 64) and at two long shapes (llama2_7b's
   heads, h=32, d=128, block 16, 2048 positions, for 4 and for 32
   sequences) each element within 1e-3 + 1e-2 * |plain| (one bf16 ulp
   passes, a lost page does not); at the 32-sequence shape window=1 is
   bitwise plain and the stored rows.  Times from the profiler's kernel
   records, the bound from the bytes and flop these inputs need.
6. Main path 1: the flagship Llama forward through
   ``ray_tpu_torch.entry.entry()`` at full width (12 layers, 4 x 512,
   bf16): finite logits, K1 launched 12 times per forward, the loss of the
   K1 path within 2e-2 of the plain-attention path; ms per forward,
   tokens/s, peak memory; K1's device time per launch inside the forward
   and the forward's device busy time, from its profile.
7. Main path 2: 16 requests from threads through the paged decoder under
   the continuous batcher (paged_kv, prefix caching, speculative_k=3):
   every chain bitwise ``reference_decode``, K4 launched, prefix hits.
8. Main path 3: the flagship train step (``ray_tpu_torch.train``, remat
   on, batch 4 x 513 tokens, AdamW with a short warmup): K1/K2/K3
   launched 24/12/12 times per step; the first step's loss within 1e-3
   of ``loss_fn`` under no_grad; its grads against the plain-attention
   step's (grad_norm within 2e-2 relative, each leaf's relative L2 error
   within 5e-2); a falling, finite loss over the steps on one batch; ms
   per step, tokens/s, peak memory, the plain-attention step's time, and
   a profile of one step (K1's, K2's and K3's time per launch inside it,
   busy time).

Launch counts are set to 0 just before each main path and read just after
it.  Prints the kernels line, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when
there is no card or the port is not beside this script.
"""

import dataclasses
import json
import math
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOPS = 989e12           # dense tensor-core peak, bf16
F32_FLOPS = 67e12             # f32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters):
    """Mean ms per call by CUDA events over ``iters`` calls after 3 warm-up
    calls (warm L2)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _profile(torch, run, reps):
    """Run ``run`` ``reps`` times under torch.profiler: ({CUDA kernel or
    copy name: device us per run}, host wall us per run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    busy = {e.key: e.self_device_time_total / reps
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    return busy, wall_us


def device_ms(torch, run, reps, kernel=None):
    """Device time per call: the profiler's kernel times (only kernels
    whose name holds ``kernel`` when given).  Raises when two profiled
    runs record no such kernel: a host-clock time is no device time."""
    for _ in range(2):
        busy, _ = _profile(torch, run, reps)
        us = sum(t for k, t in busy.items() if kernel is None or kernel in k)
        if us:
            return us / 1e3
    raise RuntimeError(f"the profiler recorded no device time for "
                       f"{kernel or 'the call'}")


def bound(nbytes, flops, peak_flops, f32_flops=0):
    """Least ms for the work: bytes over the memory rate or operations
    over their peak rates (``f32_flops`` outside the tensor cores),
    whichever is longer, and which."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops + f32_flops / F32_FLOPS
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def k1_work(b, s, h, causal, d=128):
    """Bytes K1 must move (q, k, v read once, o and lse written once) and
    its flop (4 d per (q, k) pair that the causal mask keeps)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * s * h * d * 2 + b * h * s * 4, 4 * d * pairs * b * h


def host_ms(torch, fn, iters=200):
    """Host time per call: the enqueue alone (no synchronize inside the
    clock), after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return dt


def k1_phase(torch, dev):
    """K1 against its plain version at four shapes (the flagship, one
    non-causal, one ragged GQA, and the long shape: the heads of
    LlamaConfig.llama2_7b at its max_seq_len); at the flagship and the
    long shape also the times of the kernel, the plain version and SDPA
    beside the bound."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops.layers import repeat_kv_heads

    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"name": "K1_flash_fwd", "route": "cuda",
              "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
              "replaces": "ray_tpu/ops/attention.py:100"}
    for b, s, h, h_kv, causal, what in (
            (4, 512, 6, 6, True, "flagship"), (2, 256, 6, 6, False, None),
            (2, 500, 6, 2, True, None), (2, 2048, 32, 32, True, "long")):
        q, k, v = (torch.randn((b, s, hh, 128), generator=gen, device=dev)
                   .to(torch.bfloat16) for hh in (h, h_kv, h_kv))
        o, lse = attention.flash_attention_fwd(q, k, v, causal=causal)
        qs = attention._prescale(q, 128 ** -0.5)
        k2, v2 = repeat_kv_heads(q, k, v)
        o_p, lse_p = attention._flash_fwd_plain(qs, k2, v2, causal)
        torch.cuda.synchronize()
        err_o = float((o.float() - o_p.float()).abs().max())
        err_l = float((lse - lse_p).abs().max())
        log(f"K1 b={b} s={s} h={h}->{h_kv} causal={causal}: "
            f"o max_abs_err={err_o} (<=2e-2) lse max_abs_err={err_l} "
            f"(<=1e-3)")
        check(err_o <= 2e-2 and err_l <= 1e-3, "K1 disagrees with plain")
        if what is None:
            continue
        sfx = "" if what == "flagship" else "_long"

        def run():
            return attention.flash_attention_fwd(q, k, v, causal=causal)

        ms = device_ms(torch, run, 20, kernel="flash_fwd_kernel")
        plain_ms = device_ms(torch, lambda: attention._flash_fwd_plain(
            qs, k2, v2, causal), 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = device_ms(torch, lambda: sdpa(qt, kt, vt,
                                               is_causal=causal), 20)
        nbytes, flops = k1_work(b, s, h, causal)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        log(f"K1 {what} shape b={b} s={s} h={h} (device time per call): "
            f"kernel {ms} ms ({flops / ms / 1e9} TFLOP/s), plain "
            f"{plain_ms} ms, sdpa {lib_ms} ms, bound {b_ms} ms ({b_by}: "
            f"{nbytes} B, {flops} flop)")
        result.update({"max_abs_err" + sfx: err_o,
                       "lse_max_abs_err" + sfx: err_l, "ms" + sfx: ms,
                       "plain_ms" + sfx: plain_ms, "bound_ms" + sfx: b_ms,
                       "bound_by" + sfx: b_by, "library_ms" + sfx: lib_ms})
        if what == "flagship":
            result["call_ms"] = cuda_ms(run, 50)
            result["wrapper_host_ms"] = host_ms(torch, run)
            result["kernel_wrapper_host_ms"] = host_ms(
                torch, lambda: attention._flash_fwd_cuda(qs, k, v, causal))
            log(f"K1 wrapper at the flagship shape: call {result['call_ms']}"
                f" ms (CUDA events, back to back); host time per call "
                f"{result['wrapper_host_ms']} ms (flash_attention_fwd), "
                f"{result['kernel_wrapper_host_ms']} ms (_flash_fwd_cuda)")
    return result


def k23_work(b, s, h, causal, d=128):
    """Bytes and flop of the backward's kernels at a (b, s, h, d) shape
    with as many kv heads as q heads.  K2 reads q, k, v, do, lse and delta
    once and writes dk and dv, 8 d flop per (q, k) pair the causal mask
    keeps (four products); K3 reads q, k, v, do and lse, writes dq and
    delta, 6 d flop per pair (three products); its delta prologue adds
    one read of o and 2 d f32 flop per row."""
    pairs = s * (s + 1) // 2 if causal else s * s
    t_b = b * s * h * d * 2          # each of q, k, v, o, do, dq, dk, dv
    row_b = b * h * s * 4            # each of lse, delta
    return {"K2": (6 * t_b + 2 * row_b, 8 * d * pairs * b * h),
            "K3": (5 * t_b + 2 * row_b, 6 * d * pairs * b * h),
            "delta": (t_b, 2 * d * b * h * s)}


def k23_phase(torch, dev):
    """K3 (dq, with delta in its prologue) then K2 (dk, dv), as the
    backward launches them, against the plain backward at K1's four
    shapes; at the flagship and the long shape the times of K3, K2, the
    plain versions and the SDPA backward (which covers K2 + K3 + delta
    together) beside the bounds."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops.layers import repeat_kv_heads

    gen = torch.Generator(device=dev).manual_seed(2)
    scale = 128 ** -0.5
    k2 = {"name": "K2_flash_dkdv", "route": "cuda",
          "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
          "replaces": "ray_tpu/ops/attention.py:181"}
    k3 = {"name": "K3_flash_dq", "route": "cuda",
          "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
          "replaces": "ray_tpu/ops/attention.py:227"}
    for b, s, h, h_kv, causal, what in (
            (4, 512, 6, 6, True, "flagship"), (2, 256, 6, 6, False, None),
            (2, 500, 6, 2, True, None), (2, 2048, 32, 32, True, "long")):
        q, k, v, do = (torch.randn((b, s, hh, 128), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for hh in (h, h_kv, h_kv, h))
        qs = attention._prescale(q, scale)
        o, lse = attention._flash_fwd_cuda(qs, k, v, causal)
        dq, delta = attention._flash_dq_cuda(qs, k, v, o, do, lse, causal,
                                             scale)
        dk, dv = attention._flash_dkdv_cuda(qs, k, v, do, lse, delta, causal)
        delta_p = attention._delta(o, do)
        k2r, v2r = repeat_kv_heads(q, k, v)
        dk_p, dv_p = (attention._sum_kv_groups(x, h_kv) for x in
                      attention._flash_dkdv_plain(qs, k2r, v2r, do, lse,
                                                  delta_p, causal))
        dq_p = attention._flash_dq_plain(qs, k2r, v2r, do, lse, delta_p,
                                         causal, scale)
        # The f32 gradient of the same function, by autograd.
        qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
        of = attention.mha_reference(qf, *repeat_kv_heads(qf, kf, vf),
                                     causal=causal)
        ref = torch.autograd.grad(of, (qf, kf, vf), do.float())
        del of
        torch.cuda.synchronize()
        err_d = float((delta - delta_p).abs().max())
        lim_d = 1e-5 * float(delta_p.abs().max())
        log(f"K3 delta b={b} s={s} h={h}->{h_kv} causal={causal}: "
            f"max_abs_err to rowsum(o*do) {err_d} (<= {lim_d})")
        check(err_d <= lim_d, "K3's delta disagrees with rowsum(o*do)")
        errs = {}
        for name, got, plain, r in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                       (dq_p, dk_p, dv_p), ref):
            diff = float((got.float() - plain.float()).abs().max())
            lim = 2e-2 * float(plain.float().abs().max())
            e_k = float((got.float() - r).abs().max())
            e_p = float((plain.float() - r).abs().max())
            log(f"K2/K3 b={b} s={s} h={h}->{h_kv} causal={causal} {name}: "
                f"max_abs_err to plain {diff} (<= {lim}, 2e-2*max|plain|); "
                f"to f32 reference: kernel {e_k}, plain {e_p} (kernel <= "
                f"{2 * e_p + 1e-3})")
            check(diff <= lim, f"{name} disagrees with the plain backward")
            check(e_k <= 2 * e_p + 1e-3, f"{name} is further from the f32 "
                  f"gradient than the plain backward allows")
            errs[name] = diff
        del ref, qf, kf, vf
        if what is None:
            continue
        sfx = "" if what == "flagship" else "_long"
        ms3 = device_ms(torch, lambda: attention._flash_dq_cuda(
            qs, k, v, o, do, lse, causal, scale), 20,
            kernel="flash_dq_kernel")
        ms2 = device_ms(torch, lambda: attention._flash_dkdv_cuda(
            qs, k, v, do, lse, delta, causal), 20, kernel="flash_dkdv_kernel")
        plain2 = device_ms(torch, lambda: attention._flash_dkdv_plain(
            qs, k2r, v2r, do, lse, delta_p, causal), 3)
        plain3 = device_ms(torch, lambda: attention._flash_dq_plain(
            qs, k2r, v2r, do, lse, delta_p, causal, scale), 3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        ot = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2)
        lib_ms = device_ms(torch, lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), 20)
        del ot
        work = k23_work(b, s, h, causal)
        b2 = bound(*work["K2"], BF16_FLOPS)
        n3 = work["K3"][0] + work["delta"][0]
        b3 = bound(n3, work["K3"][1], BF16_FLOPS, f32_flops=work["delta"][1])
        port_ms = ms2 + ms3
        log(f"K2/K3 {what} shape b={b} s={s} h={h} (device time per call): "
            f"K3 (with delta) {ms3} ms, K2 {ms2} ms, K2+K3 {port_ms} ms "
            f"({port_ms / lib_ms} x the SDPA backward); plain K2 {plain2} "
            f"ms, plain K3 {plain3} ms; SDPA backward (K2+K3+delta "
            f"together) {lib_ms} ms; bound K2 {b2[0]} ms ({b2[1]}: "
            f"{work['K2'][0]} B, {work['K2'][1]} flop), K3 {b3[0]} ms "
            f"({b3[1]}: {n3} B, {work['K3'][1]} flop + {work['delta'][1]} "
            f"f32 flop)")
        joint = {"library_covers" + sfx: "K2+K3+delta (SDPA backward)",
                 "port_bwd_ms" + sfx: port_ms, "library_ms" + sfx: lib_ms}
        k2.update({"max_abs_err" + sfx: max(errs["dk"], errs["dv"]),
                   "ms" + sfx: ms2, "plain_ms" + sfx: plain2,
                   "bound_ms" + sfx: b2[0], "bound_by" + sfx: b2[1]},
                  **joint)
        k3.update({"max_abs_err" + sfx: errs["dq"],
                   "delta_max_abs_err" + sfx: err_d, "ms" + sfx: ms3,
                   "plain_ms" + sfx: plain3, "bound_ms" + sfx: b3[0],
                   "bound_by" + sfx: b3[1]}, **joint)
    return k2, k3


def _paged_inputs(torch, dev, seed, B, h, d, bs, max_ctx, dtype):
    import numpy as np

    rng = np.random.default_rng(seed)
    width = -(-max_ctx // bs)
    nb = B * width
    q = torch.from_numpy(rng.normal(size=(B, h, d))).to(dev, dtype)
    kc = torch.from_numpy(rng.normal(size=(nb, bs, h, d))).to(dev, dtype)
    vc = torch.from_numpy(rng.normal(size=(nb, bs, h, d))).to(dev, dtype)
    bt = torch.from_numpy(rng.permutation(nb).reshape(B, width)
                          .astype(np.int32)).to(dev)
    cl = rng.integers(1, max_ctx + 1, size=B).astype(np.int32)
    return q, kc, vc, bt, torch.from_numpy(cl).to(dev), cl


def k4_work(q, cl_np, window, bs):
    """Bytes K4 must move and the flop it does on these inputs: q and o
    once, and per sequence the k and v rows of ``[max(ctx - window, 0),
    ctx)``, the block-table entries of the pages that hold them, and its
    context length."""
    B, h, d = q.shape
    rows = pages = 0
    for c in (int(c) for c in cl_np):
        lo = max(c - window, 0) if window else 0
        rows += c - lo
        pages += (c - 1) // bs - lo // bs + 1
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * rows * h * d * q.element_size() + 4 * pages + 4 * B)
    return nbytes, 4 * h * d * rows


def k4_phase(torch, dev):
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops.paged_attention import (
        _paged_attention_plain, paged_attention)

    def plain(q, kc, vc, bt, cl, window):
        qs = attention._prescale(q, q.shape[-1] ** -0.5)
        return _paged_attention_plain(qs, kc, vc, bt, cl, window)

    # The serving shape (what the decoder's _read_last launches).
    q, kc, vc, bt, cl, cl_np = _paged_inputs(torch, dev, 0, 8, 1, 32, 8, 40,
                                             torch.float32)
    out = paged_attention(q, kc, vc, bt, cl, window=1)
    ref = plain(q, kc, vc, bt, cl, 1)
    torch.cuda.synchronize()
    exact = torch.equal(out, ref)
    err = float((out - ref).abs().max())
    log(f"K4 serving shape (f32, B=8, h=1, d=32, bs=8, window=1): "
        f"exact={exact} max_abs_err={err}")
    check(exact, "K4 is not exact at window=1")
    def run():
        return paged_attention(q, kc, vc, bt, cl, window=1)

    ms = device_ms(torch, run, 50, kernel="paged_decode_kernel")
    call_ms = cuda_ms(run, 200)
    wrapper_host_ms = host_ms(torch, run)
    plain_ms = device_ms(torch, lambda: plain(q, kc, vc, bt, cl, 1), 20)
    nbytes, flops = k4_work(q, cl_np, 1, 8)
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
    log(f"K4 serving shape (device time per call): kernel {ms} ms, plain "
        f"{plain_ms} ms, bound {b_ms} ms ({b_by}: {nbytes} B, {flops} "
        f"flop); wrapper call {call_ms} ms (CUDA events, back to back), "
        f"host time per call {wrapper_host_ms} ms")
    result = {"name": "K4_paged_decode", "route": "cuda",
              "source": "ray_tpu_torch/ops/csrc/paged_decode.cu",
              "replaces": "ray_tpu/ops/paged_attention.py:85",
              "max_abs_err": err, "ms": ms, "call_ms": call_ms,
              "wrapper_host_ms": wrapper_host_ms,
              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": None}
    # A general shape: bf16, long ragged contexts, two windows.  Each
    # element within 1e-3 + 1e-2 * |plain|: a one-ulp bf16 rounding
    # difference passes, a dropped or repeated page of 16 rows does not.
    q, kc, vc, bt, cl, cl_np = _paged_inputs(torch, dev, 1, 8, 6, 128, 16,
                                             1024, torch.bfloat16)
    for window in (0, 64):
        out = paged_attention(q, kc, vc, bt, cl, window=window)
        ref = plain(q, kc, vc, bt, cl, window).float()
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        n_out = int((diff > 1e-3 + 1e-2 * ref.abs()).sum())
        ms = device_ms(torch, lambda: paged_attention(
            q, kc, vc, bt, cl, window=window), 20, kernel="paged_decode")
        plain_ms = device_ms(torch, lambda: plain(q, kc, vc, bt, cl,
                                                  window), 5)
        nbytes, flops = k4_work(q, cl_np, window, 16)
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        log(f"K4 general shape (bf16, B=8, h=6, d=128, bs=16, ctx "
            f"{int(cl_np.min())}-{int(cl_np.max())}, window={window}): "
            f"max_abs_err={err}, {n_out} elements outside 1e-3 + "
            f"1e-2*|plain|; kernel {ms} ms, plain {plain_ms} ms, bound "
            f"{b_ms} ms ({b_by}: {nbytes} B, {flops} flop)")
        check(n_out == 0, f"K4 disagrees with plain at window={window}")
        sfx = f"_general_w{window}"
        result.update({"max_abs_err" + sfx: err, "ms" + sfx: ms,
                       "plain_ms" + sfx: plain_ms, "bound_ms" + sfx: b_ms})
    # The long shapes: llama2_7b's heads (h=32, d=128, bf16, vLLM's block
    # of 16) at its max_seq_len of 2048, for 4 and for 32 sequences, made
    # on the card (the batch shape's pool is 1 GB of bf16).
    for B, what in ((4, "long_few"), (32, "long_batch")):
        q, kc, vc, bt, cl = _paged_long_inputs(torch, dev, 3 + B, B)
        cl_np = cl.cpu().numpy()
        out = paged_attention(q, kc, vc, bt, cl)
        ref = plain(q, kc, vc, bt, cl, 0).float()
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        n_out = int((diff > 1e-3 + 1e-2 * ref.abs()).sum())
        del ref, diff
        ms = device_ms(torch, lambda: paged_attention(q, kc, vc, bt, cl), 20,
                       kernel="paged_decode")
        plain_ms = device_ms(torch, lambda: plain(q, kc, vc, bt, cl, 0), 3)
        nbytes, flops = k4_work(q, cl_np, 0, 16)
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        log(f"K4 {what} shape (bf16, B={B}, h=32, d=128, bs=16, ctx 2048, "
            f"window=0): max_abs_err={err}, {n_out} elements outside 1e-3 + "
            f"1e-2*|plain|; kernel {ms} ms (bound / kernel {b_ms / ms}), "
            f"plain {plain_ms} ms, bound {b_ms} ms ({b_by}: {nbytes} B, "
            f"{flops} flop)")
        check(n_out == 0, f"K4 disagrees with plain at the {what} shape")
        result.update({"max_abs_err_" + what: err, "ms_" + what: ms,
                       "plain_ms_" + what: plain_ms,
                       "bound_ms_" + what: b_ms, "bound_by_" + what: b_by})
        if what == "long_batch":
            out = paged_attention(q, kc, vc, bt, cl, window=1)
            ref = plain(q, kc, vc, bt, cl, 1)
            rows = vc[bt[:, -1].long(), 15]
            torch.cuda.synchronize()
            exact = torch.equal(out, ref) and torch.equal(out, rows)
            log(f"K4 {what} shape, window=1: bitwise plain and the stored "
                f"rows: {exact}")
            check(exact, f"K4 is not exact at window=1 at the {what} shape")
        del q, kc, vc, out
        torch.cuda.empty_cache()
    return result


def _paged_long_inputs(torch, dev, seed, B, h=32, d=128, bs=16, ctx=2048):
    """q, a pool of B * ctx / bs pages with tables permuted over it, and
    every context at ``ctx``, from a seeded generator on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    width = ctx // bs
    q, kc, vc = (torch.randn(shape, generator=gen, device=dev)
                 .to(torch.bfloat16)
                 for shape in ((B, h, d), (B * width, bs, h, d),
                               (B * width, bs, h, d)))
    bt = torch.randperm(B * width, generator=gen, device=dev).view(
        B, width).int()
    cl = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    return q, kc, vc, bt, cl


def llama_phase(torch):
    from ray_tpu_torch.entry import _flagship_cfg, entry
    from ray_tpu_torch.models import forward, loss_fn
    from ray_tpu_torch.ops import _build

    fn, (params, tokens) = entry()
    cfg = _flagship_cfg()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()                       # main path 1 starts
    with torch.no_grad():
        logits = fn(params, tokens)
        torch.cuda.synchronize()
        first = _build.launches["flash_fwd"]
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            fn(params, tokens)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
    launches = _build.launches["flash_fwd"]       # main path 1 ends
    peak = torch.cuda.max_memory_allocated()
    check(first == cfg.num_layers, f"K1 launched {first} times in one "
          f"forward, expected {cfg.num_layers}")
    check(launches == cfg.num_layers * (n + 1), "K1 launches per forward")
    check(tuple(logits.shape) == (4, 512, cfg.vocab_size)
          and logits.dtype == torch.float32, "logits shape")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    with torch.no_grad():
        loss_k1, _ = loss_fn(params, {"tokens": tokens}, cfg)
        loss_ref, _ = loss_fn(params, {"tokens": tokens},
                              dataclasses.replace(cfg,
                                                  attn_impl="reference"))
    d_loss = abs(float(loss_k1) - float(loss_ref))
    log(f"flagship forward (12 layers, 4 x 512, bf16): {dt * 1e3} ms per "
        f"forward, {4 * 512 / dt} tokens/s, peak memory {peak} B, "
        f"K1 launches {launches} ({first} per forward)")
    log(f"flagship loss: K1 path {float(loss_k1)}, plain-attention path "
        f"{float(loss_ref)}, |diff| {d_loss} (<=2e-2)")
    check(math.isfinite(float(loss_k1)) and d_loss <= 2e-2,
          "flash and reference losses disagree")
    # End to end with the plain attention in K1's place, for comparison.
    cfg_ref = dataclasses.replace(cfg, attn_impl="reference")

    def ref_fn():
        return forward(params, tokens, cfg_ref)

    with torch.no_grad():
        ref_fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ref_fn()
        torch.cuda.synchronize()
        dt_ref = (time.perf_counter() - t0) / n
    log(f"flagship forward with plain mha_reference attention: "
        f"{dt_ref * 1e3} ms per forward")
    with torch.no_grad():
        busy = profile_run(torch, lambda: fn(params, tokens), "forward")
    return launches, kernels_in_path(busy, {"flash_fwd_kernel": first},
                                     "forward")


def kernels_in_path(busy, per_run, what):
    """Device ms per launch inside a profiled main path of each kernel in
    ``per_run`` ({kernel name: launches per run}), as {kernel name:
    {"ms_in_<what>": ms}}, and the path's device busy ms per run."""
    out = {}
    for kernel, n in per_run.items():
        us = sum(t for name, t in busy.items() if kernel in name)
        out[kernel] = {f"ms_in_{what}": us / n / 1e3}
        log(f"{kernel} inside the {what}: {us / n / 1e3} ms per launch "
            f"({n} launches per {what})")
    busy_ms = sum(busy.values()) / 1e3
    log(f"{what} device busy {busy_ms} ms")
    return out, busy_ms


def profile_run(torch, run, what, reps=3, top=10):
    """Device busy time per ``what`` (a forward, a step) and the kernels
    that take it, under torch.profiler; the rest of the wall time is the
    device's idle share (the profiler's own host cost included)."""
    busy, wall_us = _profile(torch, run, reps)
    total = sum(busy.values())
    check(total > 0, f"{what} profile: the profiler recorded no device time")
    log(f"{what} profile (per {what}, {reps} runs): device busy "
        f"{total} us of {wall_us} us wall, idle share "
        f"{1 - total / wall_us}, {len(busy)} kernel names")
    for name, us in sorted(busy.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {us} us ({us / total:.3f} of busy)  {name[:100]}")
    return busy


def train_phase(torch, n=8):
    from ray_tpu_torch.entry import _flagship_cfg
    from ray_tpu_torch.models import loss_fn
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.train import (
        default_optimizer, init_train_state, loss_and_grads, make_train_step)
    from ray_tpu_torch.train.core import global_norm, tree_leaves

    dev = torch.device("cuda:0")
    cfg = _flagship_cfg()
    cfg_ref = dataclasses.replace(cfg, attn_impl="reference")
    check(cfg.remat, "the flagship trains with remat")
    opt = default_optimizer(lr=1e-3, warmup=2, decay_steps=100)
    state = init_train_state(cfg, opt, torch.Generator(device=dev)
                             .manual_seed(0), dev)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (4, 513), dtype=torch.int64, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))}
    # Grads of the K1-K3 step against the plain-attention step on the same
    # params; each leaf's relative L2 error within 5e-2 (bf16 rounding
    # points differ between the two attentions).
    _, _, g = loss_and_grads(state.params, batch, cfg)
    _, _, g_ref = loss_and_grads(state.params, batch, cfg_ref)
    norm = float(global_norm(tree_leaves(g)))
    norm_ref = float(global_norm(tree_leaves(g_ref)))
    rel = [float((a - r).norm() / r.norm())
           for a, r in zip(tree_leaves(g), tree_leaves(g_ref))]
    del g, g_ref
    log(f"flagship grads, K1-K3 step vs plain-attention step: grad_norm "
        f"{norm} vs {norm_ref} (relative {abs(norm - norm_ref) / norm_ref}, "
        f"<= 2e-2); per-leaf relative L2 error max {max(rel)} (<= 5e-2), "
        f"all {rel}")
    check(abs(norm - norm_ref) <= 2e-2 * norm_ref, "grad_norm disagrees")
    check(max(rel) <= 5e-2, "a leaf's grads disagree")
    with torch.no_grad():
        loss0, _ = loss_fn(state.params, batch, cfg)
    step = make_train_step(cfg, opt)
    keys = ("flash_fwd", "flash_dkdv", "flash_dq")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()                       # main path 3 starts
    state, m0 = step(state, batch)
    first = [_build.launches[k] for k in keys]
    metrics = [m0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    launches = [_build.launches[k] for k in keys]  # main path 3 ends
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    L = cfg.num_layers
    log(f"flagship train step (12 layers, 4 x 512 tokens, remat, bf16): "
        f"{dt * 1e3} ms per step, {4 * 512 / dt} tokens/s, peak memory "
        f"{peak} B; launches K1/K2/K3 {launches} in {n + 1} steps ({first} "
        f"in the first)")
    log(f"train losses {losses}; first step's loss {losses[0]} vs loss_fn "
        f"under no_grad {float(loss0)} (<= 1e-3); its grad_norm "
        f"{float(m0['grad_norm'])}")
    check(first == [2 * L, L, L], f"K1/K2/K3 launched {first} times in one "
          f"step, expected {[2 * L, L, L]}")
    check(launches == [x * (n + 1) for x in first], "launches per step")
    check(abs(losses[0] - float(loss0)) <= 1e-3, "step loss != loss_fn")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(losses[-1] < losses[0], "the loss did not fall")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(
        state.params)), "non-finite params")
    # The same step with the plain mha_reference attention, for comparison.
    step_ref = make_train_step(cfg_ref, opt)
    step_ref(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step_ref(state, batch)
    torch.cuda.synchronize()
    log(f"flagship train step with plain mha_reference attention: "
        f"{(time.perf_counter() - t0) / n * 1e3} ms per step")
    busy = profile_run(torch, lambda: step(state, batch), "step", top=12)
    return dict(zip(keys, launches)), kernels_in_path(
        busy, {"flash_fwd_kernel": 2 * L, "flash_dkdv_kernel": L,
               "flash_dq_kernel": L}, "step")


def serve_phase(torch):
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    GLOBAL_CONFIG.paged_kv = True
    GLOBAL_CONFIG.prefix_caching = True
    GLOBAL_CONFIG.speculative_k = 3
    dec = MeshShardedDecoder(kv_blocks=128)
    system = list(range(20))
    reqs = [{"prompt": system + [32 + i % 32, i], "tokens": 3 + i % 10}
            for i in range(16)]
    out = [None] * len(reqs)

    def client(i):
        out[i] = dec(reqs[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    _build.reset_launches()                       # main path 2 starts
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    launches = _build.launches["paged_decode"]    # main path 2 ends
    check(not any(t.is_alive() for t in threads), "requests hung")
    for r, got in zip(reqs, out):
        check(got == dec.reference_decode(r["prompt"], r["tokens"]),
              f"chain differs from reference_decode for {r}")
    stats = dec.__dict__["__serve_batcher__decode"].stats()
    log(f"served {len(reqs)} requests, {sum(len(o) for o in out)} tokens, "
        f"tokens_per_step {stats['tokens_per_step']}, steps "
        f"{stats['steps']}, prefix_hits {stats['prefix_hits']}, "
        f"spec accepted {stats['spec_accepted']}/{stats['spec_proposed']}, "
        f"K4 launches {launches}, wall {wall} s; every chain bitwise "
        f"reference_decode")
    check(launches > 0, "K4 never launched while serving")
    check(stats["prefix_hits"] > 0, "no prefix hits")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build   # the port must sit beside us

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"device: {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("allow_tf32: matmul=False cudnn=False")
    dev = torch.device("cuda:0")

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0} s")
    for lib in libs.values():
        report = lib.with_suffix(".so.log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "entry function" in line or "registers" in line or \
                        "spill" in line or "wgmma" in line:
                    log(f"  ptxas {lib.stem}: {line.strip()}")

    k1 = k1_phase(torch, dev)
    k2, k3 = k23_phase(torch, dev)
    k4 = k4_phase(torch, dev)
    k1["launches"], (in_forward, k1["forward_busy_ms"]) = llama_phase(torch)
    k4["launches"] = serve_phase(torch)
    train, (in_step, step_busy) = train_phase(torch)
    k1.update(in_forward["flash_fwd_kernel"],
              **in_step["flash_fwd_kernel"], step_busy_ms=step_busy)
    k2.update(in_step["flash_dkdv_kernel"], launches=train["flash_dkdv"])
    k3.update(in_step["flash_dq_kernel"], launches=train["flash_dq"])
    log(json.dumps({"kernels": [k1, k2, k3, k4]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

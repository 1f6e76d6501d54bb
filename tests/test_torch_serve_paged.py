"""The cases of ``tests/test_serve_paged.py``, run unchanged against the
port's copy of the serve control plane and its decoder (``import
ray_tpu_torch as ray``; decoders built in-process on ``device="cpu"``,
deployments bound to ``device=["cpu"] * 8``: 8 projection shards, as the
reference's decoder runs on its 8-device CPU mesh).

Serving memory plane: paged KV admission, shared-prefix reuse, and
speculative decoding over the continuous batcher.

The battery pins the acceptance contract: block-gated admission
PARKS on exhaustion (never errors) and packs skewed-length batches past
the dense slot cap at equal simulated HBM; prefix sharing and
copy-on-write divergence keep decoded chains bitwise-identical to the
uncached host reference; exact-match speculative acceptance retires >1
token/step with greedy output bitwise-unchanged; and with every knob
off the engine is the byte-identical dense batcher with every new
counter zero (the knob-off pin)."""

import threading
import time

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch import serve
from ray_tpu_torch.serve.continuous import _ContinuousBatcher
from ray_tpu_torch.serve.kv_cache import (
    BlockAllocator, PagedKVEngine, PrefixCache, RequestTooLarge)


def _drive(batcher, requests, timeout=60):
    """Submit every request from its own thread; results/errors by id."""
    results, errors = {}, {}

    def client(req):
        try:
            results[req["id"]] = batcher.submit(req)
        except BaseException as e:  # noqa: BLE001 — recorded for asserts
            errors[req["id"]] = e

    threads = [threading.Thread(target=client, args=(r,))
               for r in requests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    return results, errors


def _paced_step(step_s):
    """Step fn over paged slots: request["tokens"] iterations each, one
    fixed sleep per step (occupancy-independent device-step model)."""

    def stepfn(slots):
        time.sleep(step_s)
        for s in slots:
            if s.state is None:
                s.state = {"n": 0, "need": s.request["tokens"]}
            s.state["n"] += 1
            if s.state["n"] >= s.state["need"]:
                s.finish(s.state["n"])

    return stepfn


def _sizing_engine(num_blocks, block_size, **kw):
    """Engine sized off request["tokens"] alone (no prompt)."""
    kw.setdefault("prefix_caching", False)
    return PagedKVEngine(num_blocks, block_size,
                         tokens_for=lambda r: ((), r["tokens"]), **kw)


# -- allocator / prefix-cache units -----------------------------------------

def test_block_allocator_refcounts_and_all_or_nothing():
    a = BlockAllocator(4, 8)
    assert a.alloc(5) is None and a.available == 4  # all-or-nothing
    blks = a.alloc(3)
    assert len(blks) == 3 and a.used == 3
    a.incref(blks[0])
    a.free(blks)                  # blks[0] survives its shared ref
    assert a.used == 1 and a.ref(blks[0]) == 1
    a.free([blks[0]])
    assert a.used == 0
    with pytest.raises(ValueError, match="double free"):
        a.free([blks[0]])
    with pytest.raises(ValueError, match="incref of free"):
        a.incref(blks[1])


def test_prefix_cache_block_boundary_reuse_and_reclaim():
    a = BlockAllocator(16, 8)
    c = PrefixCache(a)
    prompt = tuple(range(20))          # 3 blocks, last one partial
    chain = a.alloc(3)
    c.insert(prompt, chain)            # keys: len 8, 16, 20
    # A longer prompt sharing the 16-token boundary reuses 2 blocks.
    got, n = c.lookup(tuple(range(16)) + (99, 98))
    assert n == 16 and got == chain[:2]
    assert all(a.ref(b) > 1 for b in got)
    a.free(got)
    # A sub-block prefix (< block_size) has no boundary entry.
    assert c.lookup((0, 1, 2)) == ([], 0)
    # Reclaim drops LRU entries until the need is met.
    a.free(chain)                      # cache refs keep blocks alive
    used_before = a.used
    assert used_before > 0
    c.reclaim(a.available + used_before)
    assert a.used == 0 and len(c) == 0


# -- admission: parking and fast-fail ---------------------------------------

def test_allocator_exhaustion_parks_admission_then_completes():
    """6 requests whose budgets each take the WHOLE pool serialize
    through admission: parks (not errors), FIFO completion, pool fully
    freed at the end."""
    eng = _sizing_engine(4, 4)                  # 16-token pool
    b = _ContinuousBatcher(_paced_step(0.001), None, 8, 0.0,
                           continuous=True, kv=eng)
    reqs = [{"id": i, "tokens": 16} for i in range(6)]
    results, errors = _drive(b, reqs)
    assert not errors and len(results) == 6
    s = b.stats()
    assert s["mode"] == "continuous+paged"
    # Park EPISODES, not boundary re-checks: the 5 waiting requests
    # park once each, not once per scheduler boundary they waited out.
    assert 1 <= s["admission_parks"] <= len(reqs)
    assert s["retired"] == 6 and s["step_errors"] == 0
    assert s["kv_blocks_used"] == 0             # alloc-on-admit/free-on-retire


def test_oversized_request_fails_fast_and_queue_keeps_flowing():
    """A budget larger than the TOTAL pool can never fit: it must raise
    RequestTooLarge to ITS caller while the requests queued behind it
    still complete (parking it would wedge the FIFO head forever)."""
    eng = _sizing_engine(4, 4)
    b = _ContinuousBatcher(_paced_step(0.001), None, 8, 0.0,
                           continuous=True, kv=eng)
    reqs = [{"id": 0, "tokens": 8}, {"id": 1, "tokens": 999},
            {"id": 2, "tokens": 8}]
    results, errors = _drive(b, reqs)
    assert set(results) == {0, 2} and set(errors) == {1}
    assert isinstance(errors[1], RequestTooLarge)
    assert b.stats()["admission_rejects"] == 1


def test_malformed_request_dooms_slot_not_scheduler():
    """A request the sizing hook cannot even size (poison pill) must
    fail ITS caller — not kill the scheduler thread with the bad slot
    still at the queue head, where every respawned scheduler would die
    on it again."""
    eng = _sizing_engine(4, 4)          # tokens_for does len+arith -> TypeError
    b = _ContinuousBatcher(_paced_step(0.001), None, 8, 0.0,
                           continuous=True, kv=eng)
    reqs = [{"id": 0, "tokens": 8}, {"id": 1, "tokens": None},
            {"id": 2, "tokens": 8}]
    results, errors = _drive(b, reqs)
    assert set(results) == {0, 2} and set(errors) == {1}
    assert isinstance(errors[1], TypeError)
    # The surviving scheduler keeps draining fresh submissions.
    assert b.submit({"id": 3, "tokens": 4}) == 4
    assert b.stats()["step_errors"] == 0


def test_paged_packs_past_dense_slot_cap():
    """Equal simulated HBM (128 tokens): the dense engine fits
    128/max_seq_len(16) = 8 slots; block-granular admission packs the
    same short (4-token) requests past that cap in one live batch."""
    eng = _sizing_engine(32, 4, max_slots=64)   # 128-token pool
    peak = {"live": 0}

    def stepfn(slots):
        peak["live"] = max(peak["live"], len(slots))
        time.sleep(0.002)
        for s in slots:
            s.state = (s.state or 0) + 1
            if s.state >= s.request["tokens"]:
                s.finish(s.state)

    b = _ContinuousBatcher(stepfn, None, 8, 0.0, continuous=True, kv=eng)
    reqs = [{"id": i, "tokens": 4} for i in range(48)]
    results, errors = _drive(b, reqs)
    assert not errors and len(results) == 48
    assert peak["live"] > 8, peak                # past the dense HBM cap
    assert b.stats()["batch_occupancy"] > 8


# -- the paged decoder: bitwise pins ----------------------------------------

def _decoder_batcher(dec):
    return _ContinuousBatcher(dec._paged_step, None, 8, 0.0,
                              continuous=True, kv=dec.serve_kv_engine)


def test_paged_decoder_prefix_reuse_cow_bitwise():
    """Shared system prompt across clients: prefix blocks are mapped
    (hits + shared blocks), divergence copies-on-write, and every chain
    is bitwise the host reference — identical to the UNCACHED run."""
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    sys_prompt = list(range(20))                 # spans 2 full blocks
    reqs = [{"id": i, "prompt": sys_prompt + [i], "tokens": 3 + i % 4}
            for i in range(8)]

    def run(prefix_caching):
        dec = MeshShardedDecoder(paged=True, kv_blocks=64,
                                 kv_block_size=8,
                                 prefix_caching=prefix_caching,
                                 device="cpu")
        b = _decoder_batcher(dec)
        results, errors = _drive(b, reqs)
        assert not errors
        return results, b.stats()

    cached, cs = run(True)
    uncached, us = run(False)
    assert cached == uncached                    # bitwise A/B
    ref = MeshShardedDecoder(device="cpu")
    for r in reqs:
        assert cached[r["id"]] == ref.reference_decode(r["prompt"],
                                                       r["tokens"])
    assert cs["prefix_hits"] > 0 and cs["prefix_blocks_shared"] > 0
    assert cs["cow_copies"] > 0                  # divergence after share
    assert us["prefix_hits"] == us["prefix_blocks_shared"] == 0


def test_speculative_battery_bitwise_greedy():
    """Exact-match acceptance: for every draft length k the decoded
    chains are bitwise the host reference; a mostly-agreeing draft
    accepts >0 proposals and retires >1 token/step, a garbage draft
    accepts ~none — output unchanged either way."""
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    reqs = [{"id": i, "prompt": [i], "tokens": 5 + i % 6}
            for i in range(8)]
    ref = MeshShardedDecoder(device="cpu")
    expected = {r["id"]: ref.reference_decode(r["prompt"], r["tokens"])
                for r in reqs}
    for k in (0, 1, 3, 7):
        dec = MeshShardedDecoder(paged=True, kv_blocks=64,
                                 kv_block_size=8, speculative_k=k,
                                 device="cpu")
        b = _decoder_batcher(dec)
        results, errors = _drive(b, reqs)
        assert not errors and results == expected, f"k={k}"
        s = b.stats()
        if k == 0:
            assert s["spec_proposed"] == s["spec_accepted"] == 0
        else:
            assert s["spec_proposed"] >= s["spec_accepted"] > 0, f"k={k}"
    assert s["tokens_per_step"] > 1.0            # k=7 retires multi-token
    # Garbage draft: rejects dominate, greedy output still bitwise.
    dec = MeshShardedDecoder(paged=True, kv_blocks=64, kv_block_size=8,
                             speculative_k=3, device="cpu")
    dec._wd_host = -dec._wd_host                 # anti-correlated draft
    b = _decoder_batcher(dec)
    results, errors = _drive(b, reqs)
    assert not errors and results == expected
    s = b.stats()
    assert s["spec_accepted"] < s["spec_proposed"]


def test_paged_instance_with_knob_off_falls_back_dense():
    """A paged=True decoder driven by a DENSE batcher (paged_kv knob
    off, the process default: the batching decorator ignores
    serve_kv_engine, so slots carry no kv plan) must fall back to the
    dense decode path — both prompt forms decode correctly and every
    engine counter stays zero."""
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    dec = MeshShardedDecoder(paged=True, device="cpu")
    ref = MeshShardedDecoder(device="cpu")
    assert dec({"prompt": 3, "tokens": 4}) == ref.reference_decode(3, 4)
    assert dec({"prompt": [2, 9], "tokens": 3}) \
        == ref.reference_decode([2, 9], 3)
    s = dec.serve_kv_engine.stats_locked()
    assert all(v == 0 for k, v in s.items()
               if k not in ("kv_blocks_total",)), s


# -- knob plumbing through serve + the knob-off pin -------------------------

def test_paged_serve_e2e_knobs_on():
    """_system_config{paged_kv, speculative_k} reaches replica workers
    (rides _worker_config_env): the stock MeshShardedDecoder deployment
    comes up paged+speculative, chains stay bitwise, and the controller
    rollup reports the memory-plane observables."""
    ray.init(num_cpus=4,
             _system_config={"paged_kv": True, "speculative_k": 2})
    try:
        from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

        dep = serve.deployment(MeshShardedDecoder, name="paged",
                               max_concurrency=16)
        handle = serve.run(dep.bind(device=["cpu"] * 8), name="paged")
        shared = list(range(16))                 # 2 shared blocks
        reqs = [{"prompt": shared + [i], "tokens": 1 + i % 5}
                for i in range(10)]
        outs = ray.get([handle.remote(r) for r in reqs], timeout=120)
        ref = MeshShardedDecoder(device="cpu")
        for r, out in zip(reqs, outs):
            assert out == ref.reference_decode(r["prompt"], r["tokens"])
        stats = serve.serving_stats("paged")
        assert stats["mode"] == "continuous+paged"
        assert stats["kv_blocks_total"] > 0
        assert 0.0 <= stats["kv_occupancy"] <= 1.0
        assert stats["prefix_hits"] > 0
        assert stats["spec_accepted"] > 0
        assert stats["tokens_per_step"] > 1.0
        assert stats["retired"] == 10
    finally:
        serve.shutdown()
        ray.shutdown()


def test_knob_off_dense_engine_zero_counters_pin():
    """All three switches off (the defaults): the stock deployment runs
    the dense engine — mode has no paged flag and EVERY
    serving-memory counter in the rollup is zero."""
    ray.init(num_cpus=4)
    try:
        from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

        dep = serve.deployment(MeshShardedDecoder, name="dense",
                               max_concurrency=16)
        handle = serve.run(dep.bind(device=["cpu"] * 8), name="dense")
        outs = ray.get([handle.remote({"prompt": i, "tokens": 2})
                        for i in range(6)], timeout=120)
        ref = MeshShardedDecoder(device="cpu")
        for i, out in enumerate(outs):
            assert out == ref.reference_decode(i, 2)
        stats = serve.serving_stats("dense")
        assert stats["mode"] == "continuous"
        for key in ("kv_blocks_total", "kv_blocks_used", "prefix_hits",
                    "prefix_blocks_shared", "cow_copies",
                    "spec_proposed", "spec_accepted", "tokens_emitted",
                    "admission_parks", "admission_rejects"):
            assert stats[key] == 0, key
        assert stats["kv_occupancy"] == 0.0
        assert stats["tokens_per_step"] == 0.0
    finally:
        serve.shutdown()
        ray.shutdown()


# -- the perf A/B (bench-shaped; slow tier) ---------------------------------

@pytest.mark.slow
def test_acceptance_paged_1_5x_req_s_at_equal_hbm():
    """THE acceptance micro: skewed-length requests (most short, some
    at max_seq_len) at EQUAL simulated HBM (1024 tokens).  Dense: 8
    slots of max_seq_len=128.  Paged: 128 blocks of 8 tokens.  Paced
    steps; >= 1.5x req/s, best-of-3 per engine."""
    step_s = 0.004
    reqs = [{"id": i, "tokens": 128 if i % 16 == 0 else 16}
            for i in range(96)]

    def req_rate(paged):
        best, samples = 0.0, []
        for _ in range(3):
            kv = _sizing_engine(128, 8, max_slots=64) if paged else None
            b = _ContinuousBatcher(_paced_step(step_s), None, 8, 0.0,
                                   continuous=True, kv=kv)
            t0 = time.perf_counter()
            results, errors = _drive(b, reqs, timeout=120)
            dt = time.perf_counter() - t0
            assert not errors and len(results) == len(reqs)
            samples.append(round(len(reqs) / dt, 1))
            best = max(best, len(reqs) / dt)
        return best, samples

    paged, ps = req_rate(True)
    dense, ds = req_rate(False)
    assert paged >= 1.5 * dense, (
        f"paged {paged:.0f} req/s vs dense {dense:.0f} req/s "
        f"(samples: {ps} vs {ds})")

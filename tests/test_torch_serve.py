"""Parity of the PyTorch port's paged serving decoder with the JAX
reference on CPU.

The port's ``MeshShardedDecoder`` takes the JAX decoder's own
integer-valued weight arrays (``_w_host``/``_emb_host``/``_wd_host``), so
every greedy chain must be BITWISE the JAX ``reference_decode`` and the
JAX paged decoder's own chains (run once per module through its Pallas
kernel in interpret mode): prefix reuse with copy-on-write, speculative
drafts of every length, and the dense fallback with the knob off.
"""

import threading

import pytest
import torch

from ray_tpu.serve.continuous import _ContinuousBatcher as JaxBatcher
from ray_tpu.serve.tpu_replica import MeshShardedDecoder as JaxDecoder
from ray_tpu_torch.serve.continuous import _ContinuousBatcher
from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

# Tiny shapes: more intra-op threads would only contend with the test
# files that pytest-xdist runs beside these.
torch.set_num_threads(1)

SYS_PROMPT = list(range(20))            # spans 2 full blocks of 8
REQS = [{"id": i, "prompt": SYS_PROMPT + [i], "tokens": 3 + i % 6}
        for i in range(8)]


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
    assert not any(t.is_alive() for t in threads)
    return results, errors


@pytest.fixture(scope="module")
def jax_side():
    """The JAX paged decoder (Pallas kernel, speculative k=3, prefix
    caching): its weights and its own chains for REQS."""
    dec = JaxDecoder(paged=True, kv_blocks=64, kv_block_size=8,
                     speculative_k=3)
    b = JaxBatcher(dec._paged_step, None, 8, 0.0, continuous=True,
                   kv=dec.serve_kv_engine)
    chains, errors = _drive(b, REQS)
    assert not errors
    weights = {"w": dec._w_host, "emb": dec._emb_host, "wd": dec._wd_host}
    return dec, weights, chains


def _port_run(weights, **kw):
    dec = MeshShardedDecoder(paged=True, kv_blocks=64, kv_block_size=8,
                             weights=weights, device="cpu", **kw)
    b = _ContinuousBatcher(dec._paged_step, None, 8, 0.0, continuous=True,
                           kv=dec.serve_kv_engine)
    results, errors = _drive(b, REQS)
    assert not errors
    return results, b.stats()


def test_jax_chains_are_the_reference(jax_side):
    dec, _, chains = jax_side
    for r in REQS:
        assert chains[r["id"]] == dec.reference_decode(r["prompt"],
                                                       r["tokens"])


@pytest.mark.parametrize("prefix_caching", [True, False])
def test_prefix_reuse_cow_bitwise(jax_side, prefix_caching):
    dec, weights, chains = jax_side
    results, s = _port_run(weights, prefix_caching=prefix_caching)
    assert results == chains
    for r in REQS:
        assert results[r["id"]] == dec.reference_decode(r["prompt"],
                                                        r["tokens"])
    if prefix_caching:
        assert s["prefix_hits"] > 0 and s["prefix_blocks_shared"] > 0
        assert s["cow_copies"] > 0               # divergence after share
    else:
        assert s["prefix_hits"] == s["prefix_blocks_shared"] == 0


@pytest.mark.parametrize("k", [0, 1, 3, 7])
def test_speculative_bitwise_greedy(jax_side, k):
    _, weights, chains = jax_side
    results, s = _port_run(weights, speculative_k=k)
    assert results == chains, f"k={k}"
    if k == 0:
        assert s["spec_proposed"] == s["spec_accepted"] == 0
    else:
        assert s["spec_proposed"] >= s["spec_accepted"] > 0
    if k == 7:
        assert s["tokens_per_step"] > 1.0        # multi-token retirement


def test_plain_gather_matches_reference_oracle_path(jax_side):
    """use_kernel=False reads last rows through the plain oracle
    ``paged_attention_reference``: the same chains."""
    _, weights, chains = jax_side
    results, _ = _port_run(weights, speculative_k=3, use_kernel=False)
    assert results == chains


def test_knob_off_dense_fallback(jax_side):
    """A paged=True decoder under a dense batcher (paged_kv knob off, the
    default) decodes on the dense path; every engine counter stays 0."""
    dec, weights, _ = jax_side
    port = MeshShardedDecoder(paged=True, weights=weights, device="cpu")
    assert port({"prompt": 3, "tokens": 4}) == dec.reference_decode(3, 4)
    assert port({"prompt": [2, 9], "tokens": 3}) \
        == dec.reference_decode([2, 9], 3)
    s = port.serve_kv_engine.stats_locked()
    assert all(v == 0 for key, v in s.items() if key != "kv_blocks_total"), s


def test_seeded_weights_are_integer_and_deterministic():
    a = MeshShardedDecoder(device="cpu", seed=5, paged=True)
    b = MeshShardedDecoder(device="cpu", seed=5, paged=True)
    for x, y in ((a._w_host, b._w_host), (a._emb_host, b._emb_host),
                 (a._wd_host, b._wd_host)):
        assert (x == y).all() and (x == x.round()).all()
    assert a.reference_decode(7, 6) == b.reference_decode(7, 6)
    assert a({"prompt": 7, "tokens": 6}) == a.reference_decode(7, 6)


def test_serving_knobs_keep_reference_defaults_and_env_override(monkeypatch):
    from ray_tpu._private.config import Config as JaxConfig
    from ray_tpu_torch._private.config import Config

    ref = JaxConfig()
    for name in ("continuous_batching", "paged_kv", "prefix_caching",
                 "speculative_k"):
        assert getattr(Config(), name) == getattr(ref, name), name
    monkeypatch.setenv("RAY_TPU_PAGED_KV", "1")
    monkeypatch.setenv("RAY_TPU_SPECULATIVE_K", "5")
    cfg = Config.from_env()
    assert cfg.paged_kv is True and cfg.speculative_k == 5

"""The disaggregated prefill/decode handoff of the port's serving replica
(``ray_tpu_torch.serve.gpu_replica``) against the reference's, on CPU.

- The chain image a port replica exports (``prefill_export``, no runtime:
  an inline descriptor) is bitwise the reference's
  ``MeshShardedDecoder(paged=True)`` image for the same prompts, with the
  reference's integer weights handed across by ``weights=``: ``pages``,
  ``src_bs``, ``n_tokens``, ``last`` and ``pos``.
- The port's adoption of the reference's chain decodes bitwise
  ``reference_decode`` and the reference decoder's own adoption
  (``_decode({"_import": ...})``); so does its adoption of its own chain.
- A ``_timing`` request finishes with the reference's shape.
- Under ``ray_tpu_torch.init``: ``_stream_chain`` into the local node
  store and ``_open_chain`` give back the same payload, and the store's
  used bytes return to where they were.
- ``serve.run`` with ``disaggregated_serving`` on and both pools on the
  CPU: 4 requests bitwise ``reference_decode``; each replica's
  ``kv_debug`` (not ``serve.serving_stats()``) shows the chains imported
  on the decode side, streamed over the store, and no export left.
- On a card (``gpu`` marker): the in-process handoff of chip_smoke's
  phase 10, K4 launched on the imported pages.

The reference runs its plain gather (``use_kernel=False``), as the
reference's own tests may.
"""

import threading
import time

import numpy as np
import pytest
import torch

SYS_PROMPT = list(range(20))            # 2 full blocks of 8, then 4 tokens
REQS = [{"prompt": SYS_PROMPT + [i], "tokens": 3 + i} for i in range(4)]
PAGED = dict(paged=True, kv_blocks=64, kv_block_size=8, speculative_k=3)
DISAGG_CONF = {"paged_kv": True, "disaggregated_serving": True,
               "speculative_k": 3}
FIELDS = ("src_bs", "n_tokens", "last", "pos")

# Tiny shapes: more intra-op threads would only contend with the test
# files that pytest-xdist runs beside these.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def paged_knob():
    """``paged_kv`` on in both packages' in-process config (the batch
    decorator wires the paged engine only then)."""
    from ray_tpu._private.config import GLOBAL_CONFIG as ref_cfg
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as port_cfg

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_cfg, "paged_kv", True)
        mp.setattr(port_cfg, "paged_kv", True)
        yield


@pytest.fixture(scope="module")
def ref_side(paged_knob):
    """The reference's weights, its exported chains for REQS and its
    decode replica's chains adopted from them."""
    from ray_tpu.serve.tpu_replica import MeshShardedDecoder as RefDecoder

    pre = RefDecoder(use_kernel=False, **PAGED)
    exports = [pre.prefill_export(r) for r in REQS]
    dec = RefDecoder(use_kernel=False, **PAGED)
    chains = [dec._decode({**r, "_import": dec._open_chain(d)})
              for r, (d, _) in zip(REQS, exports)]
    weights = {"w": pre._w_host, "emb": pre._emb_host, "wd": pre._wd_host}
    return weights, exports, chains, dec


def _port(weights, **kw):
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    return MeshShardedDecoder(weights=weights, **{**PAGED, **kw})


def test_exported_chain_image_is_the_reference(ref_side):
    weights, exports, _, _ = ref_side
    pre = _port(weights, device="cpu")
    for r, (want, want_s) in zip(REQS, exports):
        got, got_s = pre.prefill_export(r)
        assert got[0] == want[0] == "inline"
        assert got_s == want_s
        g, w = got[1], want[1]
        assert isinstance(g["pages"], np.ndarray)
        assert g["pages"].dtype == w["pages"].dtype == np.float32
        assert g["pages"].shape == w["pages"].shape == (3, 8, 1, 32)
        assert np.array_equal(g["pages"], w["pages"])
        assert all(g[k] == w[k] for k in FIELDS)
    dbg = pre.kv_debug()
    assert dbg["exports_outstanding"] == 0
    assert dbg["kv_chains_exported"] == len(REQS)
    assert dbg["chain"]["inline_fallbacks"] == len(REQS)


def test_adopted_chains_decode_bitwise(ref_side):
    weights, exports, ref_chains, ref_dec = ref_side
    dec = _port(weights, device="cpu")
    for r, (descr, _), want in zip(REQS, exports, ref_chains):
        got = dec._decode({**r, "_import": dec._open_chain(descr)})
        assert got == want == ref_dec.reference_decode(r["prompt"],
                                                       r["tokens"])
    assert dec.kv_debug()["kv_chains_imported"] == len(REQS)
    # The port's own chains, adopted by a fresh port replica.
    pre, dec = _port(weights, device="cpu"), _port(weights, device="cpu")
    for r, want in zip(REQS, ref_chains):
        descr, _ = pre.prefill_export(r)
        assert dec._decode({**r, "_import": dec._open_chain(descr)}) == want


def test_timing_probe_has_the_reference_shape(ref_side):
    weights, _, _, ref_dec = ref_side
    dec = _port(weights, device="cpu")
    body = {"prompt": SYS_PROMPT + [9], "tokens": 5, "_timing": True}
    got = dec._decode({**body, "_t0": time.time()})
    want = ref_dec._decode({**body, "_t0": time.time()})
    assert set(got) == set(want) == {"tokens", "ttft"}
    assert got["tokens"] == want["tokens"] == ref_dec.reference_decode(
        body["prompt"], body["tokens"])
    assert isinstance(got["ttft"], float) and got["ttft"] >= 0.0


# -- through the port's runtime ---------------------------------------------

@pytest.fixture(scope="module")
def runtime():
    import ray_tpu_torch as ray

    ray.init(num_cpus=4, _system_config=DISAGG_CONF)
    yield ray
    from ray_tpu_torch import serve

    serve.shutdown()
    ray.shutdown()


def test_stream_and_open_chain_through_the_local_store(ref_side, runtime):
    from ray_tpu_torch._private import api_internal

    weights, exports, _, _ = ref_side
    rt = api_internal.require_runtime()
    dec = _port(weights, device="cpu")
    ingest = dec.kv_ingest_info()
    assert ingest == {"store": rt.store_id}
    payload = exports[0][0][1]
    before = rt.shm._node_used()
    descr = dec._stream_chain(payload, ingest)
    assert descr[0] == "shm" and descr[2] > payload["pages"].nbytes
    assert rt.shm._node_used() > before
    got = dec._open_chain(descr)
    assert rt.shm._node_used() == before
    assert np.array_equal(got["pages"], payload["pages"])
    assert all(got[k] == payload[k] for k in FIELDS)


def test_disaggregated_serve_run_bitwise(ref_side, runtime):
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.api import CONTROLLER_NAME, PREFILL_SUFFIX
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    ray = runtime
    weights, _, ref_chains, ref_dec = ref_side
    dep = serve.deployment(MeshShardedDecoder, name="port-disagg",
                           max_concurrency=16, prefill_replicas=1)
    handle = serve.run(dep.bind(device="cpu", weights=weights,
                                kv_blocks=64, kv_block_size=8),
                       name="port-disagg")
    got = [None] * len(REQS)

    def client(i):
        got[i] = ray.get(handle.remote(REQS[i]), timeout=120)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(REQS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(150)
    assert not any(t.is_alive() for t in threads)
    for r, chain, want in zip(REQS, got, ref_chains):
        assert chain == want == ref_dec.reference_decode(r["prompt"],
                                                         r["tokens"])
    ctrl = ray.get_actor(CONTROLLER_NAME)

    def kv_debug(name):
        _, reps, _ = ray.get(ctrl.handle_snapshot.remote(name), timeout=60)
        assert len(reps) == 1
        return ray.get(reps[0].call_method.remote("kv_debug", (), {}),
                       timeout=60)

    dec = kv_debug("port-disagg")
    pre = kv_debug("port-disagg" + PREFILL_SUFFIX)
    assert dec["role"] == "decode" and pre["role"] == "prefill"
    assert dec["kv_chains_imported"] == len(REQS)
    assert dec["used"] + dec["available"] == dec["kv_blocks_total"] == 64
    assert dec["tokens_emitted"] == sum(r["tokens"] for r in REQS)
    assert pre["kv_chains_exported"] == len(REQS)
    assert pre["exports_outstanding"] == 0
    assert pre["tokens_emitted"] == 0
    # Every chain rode the node store, none inline.
    assert pre["chain"]["inline_fallbacks"] == 0
    assert pre["kv_chain_bytes_streamed"] > 0


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest -m gpu "
                    "tests/test_torch_disagg.py on the H100)")
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    monkeypatch.setattr(GLOBAL_CONFIG, "paged_kv", True)


@pytest.mark.gpu
def test_handoff_on_the_card_launches_k4_on_imported_pages(cuda):
    """chip_smoke's phase 10 in-process: a prefill and a decode replica
    on cuda:0, 16 chains over 4 shared 20-token prefixes."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    pre = MeshShardedDecoder(kv_blocks=128, speculative_k=3, paged=True)
    dec = MeshShardedDecoder(kv_blocks=128, speculative_k=3, paged=True)
    systems = [[(20 * j + t) % 64 for t in range(20)] for j in range(4)]
    reqs = [{"prompt": systems[i % 4] + [32 + i, i], "tokens": 3 + i % 10}
            for i in range(16)]
    _build.reset_launches()
    for r in reqs:
        descr, _ = pre.prefill_export(r)
        assert descr[0] == "inline"
        got = dec._decode({**r, "_import": dec._open_chain(descr)})
        assert got == dec.reference_decode(r["prompt"], r["tokens"])
    assert _build.launches["rtt_paged_decode"] > 0
    dbg = dec.kv_debug()
    assert dbg["kv_chains_imported"] == len(reqs)
    assert dbg["used"] + dbg["available"] == 128
    assert pre.kv_debug()["exports_outstanding"] == 0

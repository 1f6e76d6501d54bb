"""The port's serving decoder with its projection sharded over n devices,
against the reference's decoder on its 8-device ``"model"`` mesh, on CPU.

``tests/conftest.py`` gives JAX 8 CPU devices, so the reference's
``MeshShardedDecoder`` shards its projection 8 ways.  The port's decoder
takes the reference's integer weights (``_w_host``/``_emb_host``/
``_wd_host``) and keeps one column block of ``w`` per entry of
``device=["cpu"] * n``.  For n in {1, 2, 4, 8}, every greedy chain is
bitwise the reference's own: dense, paged with ``speculative_k`` 0 and 3,
prefix caching on.  CPU tensors take K4's plain version; the kernel is
never launched here.

Also: hand-built integer weights whose global maximum is tied between two
blocks (the lower token wins, as ``np.argmax`` on the whole row picks
it); drawn weights pad the vocab to a multiple of n, as the reference
pads it; given weights whose vocab n does not divide raise; a chain
exported by a replica of one shard count and adopted by a replica of
another decodes bitwise; and ``resolve_devices``' rules that need no
card.  The reference runs its plain gather (``use_kernel=False``), as the
reference's own tests may.
"""

import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.serve.continuous import _ContinuousBatcher
from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

# Tiny shapes: more intra-op threads would only contend with the test
# files that pytest-xdist runs beside these.
torch.set_num_threads(1)

SHARDS = [1, 2, 4, 8]
DENSE_REQS = [{"id": i, "prompt": i, "tokens": 1 + i % 6}
              for i in range(12)]
SYS_PROMPT = list(range(20))            # 2 full blocks of 8, then 4 tokens
PAGED_REQS = [{"id": i, "prompt": SYS_PROMPT + [i], "tokens": 3 + i % 6}
              for i in range(8)]
PAGED = dict(paged=True, kv_blocks=64, kv_block_size=8, prefix_caching=True)


def _drive(submit, requests, timeout=60):
    """Submit every request from its own thread; results by id."""
    results, errors = {}, {}

    def client(req):
        try:
            results[req["id"]] = submit(req)
        except BaseException as e:  # noqa: BLE001 — recorded for asserts
            errors[req["id"]] = e

    threads = [threading.Thread(target=client, args=(r,))
               for r in requests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


def _paged_chains(dec, requests, batcher=_ContinuousBatcher):
    """The first request alone (it registers the shared prefix), then the
    rest together."""
    b = batcher(dec._paged_step, None, 8, 0.0, continuous=True,
                kv=dec.serve_kv_engine)
    out = _drive(b.submit, requests[:1])
    out.update(_drive(b.submit, requests[1:]))
    return out, b.stats()


@pytest.fixture(scope="module")
def ref():
    """The reference decoder on the 8-device mesh: its weights, its dense
    chains served through its batcher, and its paged chains at k 0 and 3."""
    import jax

    from ray_tpu.serve.continuous import _ContinuousBatcher as RefBatcher
    from ray_tpu.serve.tpu_replica import MeshShardedDecoder as RefDecoder

    assert len(jax.devices()) == 8
    dense = RefDecoder()
    assert dense._mesh.shape["model"] == 8
    weights = {"w": dense._w_host, "emb": dense._emb_host}
    dense_chains = _drive(dense, DENSE_REQS)
    paged = {}
    for k in (0, 3):
        dec = RefDecoder(use_kernel=False, speculative_k=k, **PAGED)
        paged[k], _ = _paged_chains(dec, PAGED_REQS, RefBatcher)
        weights["wd"] = dec._wd_host
    return dense, weights, dense_chains, paged


@pytest.mark.parametrize("n", SHARDS)
def test_dense_chains_bitwise_the_8_device_reference(ref, n):
    dense, weights, want, _ = ref
    dec = MeshShardedDecoder(weights=weights, device=["cpu"] * n)
    assert len(dec._devices) == len(dec._w) == n
    got = _drive(dec, DENSE_REQS)
    assert got == want
    for r in DENSE_REQS:
        assert got[r["id"]] == dense.reference_decode(r["prompt"],
                                                      r["tokens"])


@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize("n", SHARDS)
def test_paged_chains_bitwise_the_8_device_reference(ref, n, k):
    dense, weights, _, want = ref
    before = _build.launches["rtt_paged_decode"]
    dec = MeshShardedDecoder(weights=weights, device=["cpu"] * n,
                             speculative_k=k, **PAGED)
    got, s = _paged_chains(dec, PAGED_REQS)
    assert got == want[k]
    for r in PAGED_REQS:
        assert got[r["id"]] == dense.reference_decode(r["prompt"],
                                                      r["tokens"])
    assert s["prefix_hits"] > 0
    if k:
        assert s["spec_proposed"] >= s["spec_accepted"] > 0
    # CPU tensors take K4's plain version.
    assert _build.launches["rtt_paged_decode"] == before


def _tied_weights():
    """vocab 16, embed 4: token t embeds as the one-hot of ``t % 4``, and
    row r of w has its maximum 7 at two tokens in different blocks for n
    in {2, 4, 8} ((5, 13), (3, 10), (0, 15), (6, 14)), the lower one in a
    block that is not the first for some n.  From prompt 0 the chain is
    5, 3, 6, 0, 5, ... (the lower token of each pair)."""
    w = np.full((4, 16), -5.0, np.float32)
    for row, pair in enumerate([(5, 13), (3, 10), (0, 15), (6, 14)]):
        w[row, list(pair)] = 7.0
        w[row, (pair[0] + 1) % 16] = 6.0           # a runner-up
    emb = np.zeros((16, 4), np.float32)
    emb[np.arange(16), np.arange(16) % 4] = 1.0
    return {"w": w, "emb": emb, "wd": w.copy()}


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_tie_across_blocks_picks_the_lower_token(n, paged):
    weights = _tied_weights()
    want = [5, 3, 6, 0, 5, 3]
    x, chain = weights["emb"][0], []
    for _ in range(len(want)):                  # np.argmax on whole rows
        chain.append(int(np.argmax(x @ weights["w"])))
        x = weights["emb"][chain[-1]]
    assert chain == want
    if paged:
        dec = MeshShardedDecoder(weights=weights, device=["cpu"] * n,
                                 speculative_k=3, **PAGED)
        got, _ = _paged_chains(dec, [{"id": 0, "prompt": [0],
                                      "tokens": len(want)}])
        got = got[0]
    else:
        dec = MeshShardedDecoder(weights=weights, device=["cpu"] * n)
        got = dec({"prompt": 0, "tokens": len(want)})
    assert got == want == dec.reference_decode(0, len(want))


def test_drawn_weights_pad_the_vocab_like_the_reference():
    dec = MeshShardedDecoder(device=["cpu"] * 3, paged=True)
    assert len(dec._devices) == 3
    # The reference's rule: ((vocab + n - 1) // n) * n.
    assert dec._vocab == 66 == ((64 + 3 - 1) // 3) * 3
    assert dec._w_host.shape == (32, 66) and dec._emb_host.shape == (66, 32)
    assert [tuple(w.shape) for w in dec._w] == [(32, 22)] * 3
    assert dec._tokens_for({"prompt": 65, "tokens": 2}) == ((65,), 2)
    assert dec._tokens_for({"prompt": 66}) == ((0,), 1)
    x, want = dec._emb_host[65], []
    for _ in range(5):
        want.append(int(np.argmax(x @ dec._w_host)))
        x = dec._emb_host[want[-1]]
    assert dec.reference_decode(65, 5) == want
    assert dec({"prompt": 65, "tokens": 5}) == want


def test_given_weights_whose_vocab_the_shards_do_not_divide_raise(ref):
    _, weights, _, _ = ref
    with pytest.raises(ValueError, match=r"vocab 64 .* 3 shards"):
        MeshShardedDecoder(weights=weights, device=["cpu"] * 3)


@pytest.mark.parametrize("src,dst", [(1, 4), (4, 1)])
def test_chain_moves_between_shard_counts_bitwise(ref, monkeypatch, src,
                                                   dst):
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    # The batch decorator wires the paged engine only with the knob on.
    monkeypatch.setattr(GLOBAL_CONFIG, "paged_kv", True)
    _, weights, _, want = ref
    pre = MeshShardedDecoder(weights=weights, device=["cpu"] * src,
                             speculative_k=3, **PAGED)
    dec = MeshShardedDecoder(weights=weights, device=["cpu"] * dst,
                             speculative_k=3, **PAGED)
    for r in PAGED_REQS[:4]:
        descr, _ = pre.prefill_export(r)
        assert descr[0] == "inline"
        got = dec._decode({**r, "_import": dec._open_chain(descr)})
        assert got == want[3][r["id"]]
    assert pre.kv_debug()["exports_outstanding"] == 0
    assert dec.kv_debug()["kv_chains_imported"] == 4


@pytest.mark.parametrize("device,want", [
    ("cpu", ["cpu"]),
    (torch.device("cpu"), ["cpu"]),
    (["cpu", "cpu"], ["cpu", "cpu"]),
    (["cpu"] * 8, ["cpu"] * 8),
    (("cpu",), ["cpu"]),
])
def test_resolve_devices_takes_what_it_is_given(device, want):
    from ray_tpu_torch._private.device import resolve_devices

    assert resolve_devices(device) == [torch.device(d) for d in want]


@pytest.mark.parametrize("device", [["cpu", "cuda:0"], []])
def test_resolve_devices_refuses_a_mixed_or_empty_list(device):
    from ray_tpu_torch._private.device import resolve_devices

    with pytest.raises(ValueError):
        resolve_devices(device)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("device", [None, "cuda:0", ["cuda:0", "cuda:0"]])
def test_resolve_devices_raises_without_a_card(device):
    from ray_tpu_torch._private.device import resolve_devices

    with pytest.raises(RuntimeError, match="none is available"):
        resolve_devices(device)

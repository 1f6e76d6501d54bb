"""Ring and Ulysses sequence parallelism of the port
(``ray_tpu_torch.ops.{ring_attention,ulysses}``), the collectives of a
manual region (``parallel.collectives``) and ``manual_shard_map``'s
gradients, against the reference on CPU.

- 2 gloo ranks (sp=2), spawned once for the module, while the reference
  runs here on its 8 virtual devices:
  - ``ring_attention`` and ``ulysses_attention`` (``use_flash`` False and
    True: True takes the plain flash path on the CPU), causal and full,
    and GQA, on the reference's ``qkv`` shapes (``tests/test_ops.py``):
    forward within 1e-4 and grads within 1e-3 of ``mha_reference`` and
    ``jax.grad`` (the reference's bounds), forward within 1e-5 of the
    reference's own ``ring_attention``/``ulysses_attention`` on a JAX
    mesh with sp=2;
  - the tiny Llama's loss with ring and Ulysses attention on the sp=2
    mesh within 1e-4 of the reference's single-device ``loss_fn``, and
    one train step within ``test_torch_sharding``'s step limits;
  - on a pp=2 mesh, ``manual_shard_map``'s input gradient where the
    body's ranks use a replicated input differently: ``x * 3`` on rank 0
    and ``x * 0`` on rank 1 under a ``psum`` give ``[3, 3, 3, 3]`` on both
    ranks, as ``jax.grad`` of the reference's region does (and ``x * 2``
    and a bare ``psum`` give its 2).
- One rank in this process: every collective is the identity at size 1
  and calls no group; an unbound axis raises.
- Slow lane: 8 ranks with the reference's own layout (sp=4, tp=2,
  ``tests/test_ops.py::test_sequence_parallel_attention``).

The ranks run ``_rank_main`` in spawned processes, which import this
module to unpickle it: it imports neither torch nor jax at its top.
"""

import multiprocessing

import numpy as np
import pytest

from test_torch_sharding import (
    OPT, _assert_loss, _assert_step, _free_port, _gather, _reference)

B, S, H, D = 2, 128, 4, 32
# name -> (impl, use_flash, causal, kv heads)
ATTN_CASES = {
    f"{impl}{'_flash' if flash else ''}_{'causal' if causal else 'full'}":
        (impl, flash, causal, H)
    for impl, flash in (("ring", False), ("ulysses", False),
                        ("ulysses", True))
    for causal in (False, True)}
ATTN_CASES["ring_gqa"] = ("ring", False, True, 2)
ATTN_CASES["ulysses_gqa"] = ("ulysses", False, True, 2)
LLAMA_CASES = ("ring", "ulysses")
PROBES = ("x*2", "probe", "psum")


def _qkv(kv_heads):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, kv_heads, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _probe_body(name, psum, factor):
    """The probe's bodies; ``factor()`` is 3 on pp rank 0, else 0."""
    if name == "x*2":
        return lambda x: x * 2
    if name == "probe":
        return lambda x: psum(x * factor(), "pp")
    return lambda x: psum(x, "pp")


def _rank_main(rank, world, port, sp_mesh, cases, out):
    """One rank: the attention cases on ``sp_mesh``, the tiny Llama's loss
    and a step per case, and (world 2) the probes on a pp=2 mesh; puts
    (rank, {name: results}) on ``out``."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import (
        LlamaConfig, loss_fn, param_logical_axes, params_from_jax)
    from ray_tpu_torch.ops import ring_attention, ulysses_attention
    from ray_tpu_torch.parallel import (
        MeshConfig, make_mesh, shard_pytree, use_mesh)
    from ray_tpu_torch.parallel.collectives import axis_index, psum
    from ray_tpu_torch.parallel.sharding import P, manual_shard_map
    from ray_tpu_torch.train import (
        default_optimizer, make_train_step, train_state_from_params)
    from ray_tpu_torch.train.core import tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        res = {}
        mesh = make_mesh(MeshConfig(**sp_mesh), "cpu")
        for name, (impl, flash, causal, kvh) in cases["attn"].items():
            q, k, v = (torch.from_numpy(a).requires_grad_()
                       for a in _qkv(kvh))
            fn = ring_attention if impl == "ring" else ulysses_attention
            kw = {} if impl == "ring" else {"use_flash": flash}
            o = fn(q, k, v, causal=causal, mesh=mesh, **kw)
            (o ** 2).sum().full_tensor().backward()
            res[name] = {"out": o.full_tensor().detach().numpy(),
                         "grads": [t.grad.numpy() for t in (q, k, v)]}
        for name, (np_params, toks) in cases["llama"].items():
            cfg = LlamaConfig.tiny(attn_impl=name)
            params = shard_pytree(params_from_jax(np_params, cfg, "cpu"),
                                  param_logical_axes(cfg), mesh)
            batch = {"tokens": torch.from_numpy(toks)}
            with torch.no_grad():
                loss, metrics = loss_fn(params, batch, cfg, mesh=mesh)
            opt = default_optimizer(**OPT)
            state = train_state_from_params(params, opt)
            state, m = make_train_step(cfg, opt, mesh=mesh)(state, batch)
            res[f"llama_{name}"] = {
                "loss": float(loss), "aux_loss": float(metrics["aux_loss"]),
                "step": {key: float(x) for key, x in m.items()},
                "params": tree_map(lambda t: t.full_tensor().numpy(),
                                   state.params)}
        if cases["probes"]:
            pp_mesh = make_mesh(MeshConfig(dp=1, pp=2), "cpu")
            for name in cases["probes"]:
                x = torch.ones(4, requires_grad=True)
                with use_mesh(pp_mesh):
                    y = manual_shard_map(
                        _probe_body(name, psum, lambda: (
                            3.0 if axis_index("pp") == 0 else 0.0)), {"pp"},
                        in_specs=(P(),), out_specs=P())(x)
                total = y.sum().full_tensor()
                total.backward()
                res[f"probe_{name}"] = (float(total.detach()),
                                        x.grad.numpy())
        out.put((rank, res))
    finally:
        dist.destroy_process_group()


def _jax_attention_reference(cases, sp_mesh):
    """{name: (mha_reference out, its jax.grad, the reference's own
    sequence-parallel out on a mesh with ``sp_mesh``)}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from ray_tpu.ops import mha_reference
    from ray_tpu.ops import ring_attention as jring
    from ray_tpu.ops import ulysses_attention as julysses
    from ray_tpu.parallel import MeshConfig, make_mesh, use_mesh

    mesh = make_mesh(MeshConfig(**sp_mesh))
    sh = NamedSharding(mesh, JP(None, "sp", None, None))
    out = {}
    for name, (impl, flash, causal, kvh) in cases.items():
        q, k, v = map(jnp.asarray, _qkv(kvh))
        rep = H // kvh
        kr, vr = jnp.repeat(k, rep, 2), jnp.repeat(v, rep, 2)
        want = mha_reference(q, kr, vr, causal=causal)
        grads = jax.grad(lambda a, b, c: (mha_reference(
            a, jnp.repeat(b, rep, 2), jnp.repeat(c, rep, 2),
            causal=causal) ** 2).sum(), (0, 1, 2))(q, k, v)
        fn = jring if impl == "ring" else julysses
        kw = {} if impl == "ring" else {"use_flash": flash}
        qs, ks, vs = (jax.device_put(a, sh) for a in (q, k, v))
        with use_mesh(mesh):
            own = fn(qs, ks, vs, causal=causal, mesh=mesh, **kw)
        out[name] = (np.asarray(want), [np.asarray(g) for g in grads],
                     np.asarray(own))
    return out


def _jax_probes():
    """The reference's region over pp=2 (of its 8 devices): {name:
    (value, grad of x)}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.parallel import MeshConfig, make_mesh, use_mesh
    from ray_tpu.parallel.sharding import manual_shard_map

    mesh = make_mesh(MeshConfig(dp=4, pp=2))
    x = jnp.ones(4)
    out = {}
    for name in PROBES:
        body = _probe_body(name, jax.lax.psum, lambda: jnp.where(
            jax.lax.axis_index("pp") == 0, 3.0, 0.0))
        f = jax.jit(lambda a, body=body: manual_shard_map(
            body, {"pp"}, in_specs=(JP(),), out_specs=JP(),
            mesh=mesh)(a).sum())
        with use_mesh(mesh):
            out[name] = (float(f(x)), np.asarray(jax.jit(jax.grad(f))(x)))
    return out


def _spawn(world, sp_mesh, attn, llama, probes, batch_rows=4):
    """Spawn ``world`` gloo ranks once; the reference runs here meanwhile.
    Returns (reference attention, reference llama, reference probes,
    [each rank's results])."""
    import jax

    from ray_tpu.models import llama as jax_llama

    toks = np.random.default_rng(0).integers(
        0, 256, size=(batch_rows, 33)).astype(np.int32)
    np_params = {name: jax.tree.map(np.asarray, jax_llama.init_params(
        jax.random.PRNGKey(0), jax_llama.LlamaConfig.tiny(attn_impl=name)))
        for name in llama}
    cases = {"attn": attn,
             "llama": {name: (np_params[name], toks) for name in llama},
             "probes": probes}
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, sp_mesh, cases, out))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        ref_attn = _jax_attention_reference(attn, {**sp_mesh, "dp": -1})
        ref_llama = {}
        for name in llama:
            ref_llama[name] = _reference({"attn_impl": name}, batch_rows)
            assert np.array_equal(ref_llama[name]["tokens"], toks)
        ref_probes = _jax_probes() if probes else {}
        got = _gather(procs, out, world)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    return ref_attn, ref_llama, ref_probes, [got[r] for r in range(world)]


def _assert_attention(ref, got):
    want, grads, own = ref
    assert np.max(np.abs(got["out"] - want)) < 1e-4
    assert np.max(np.abs(got["out"] - own)) < 1e-5
    for a, b in zip(got["grads"], grads):
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) < 1e-3


# -- 2 gloo ranks, spawned once ---------------------------------------------

@pytest.fixture(scope="module")
def two_ranks():
    return _spawn(2, {"sp": 2}, ATTN_CASES, LLAMA_CASES, PROBES)


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_two_rank_attention_matches_reference(two_ranks, name):
    ref, _, _, ranks = two_ranks
    for got in ranks:
        _assert_attention(ref[name], got[name])


@pytest.mark.parametrize("impl", LLAMA_CASES)
def test_two_rank_llama_loss_matches_single_device(two_ranks, impl):
    _, ref, _, ranks = two_ranks
    _assert_loss(ref[impl], ranks[0][f"llama_{impl}"])


@pytest.mark.parametrize("impl", LLAMA_CASES)
def test_two_rank_llama_train_step_matches_single_device(two_ranks, impl):
    _, ref, _, ranks = two_ranks
    _assert_step(ref[impl], ranks[0][f"llama_{impl}"])


@pytest.mark.parametrize("name", PROBES)
def test_manual_region_grads_match_jax(two_ranks, name):
    """The input gradient of a region over pp=2 is the reference's on
    both ranks: summed over the axis where the ranks use the replicated
    input differently (the probe: [3, 3, 3, 3], where taking each rank's
    own gradient gave [3, 3, 3, 3] and [0, 0, 0, 0])."""
    _, _, ref, ranks = two_ranks
    want_value, want_grad = ref[name]
    for got in ranks:
        value, grad = got[f"probe_{name}"]
        assert value == want_value
        assert np.array_equal(grad, want_grad)
    if name == "probe":
        assert want_grad.tolist() == [3.0, 3.0, 3.0, 3.0]


# -- one rank, in this process ----------------------------------------------

@pytest.fixture
def world1():
    import torch.distributed as dist

    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collectives_are_the_identity_at_size_one(world1, monkeypatch):
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.parallel import collectives as C
    from ray_tpu_torch.parallel.sharding import P, manual_shard_map

    with pytest.raises(NameError, match="unbound axis"):
        C.axis_index("sp")
    mesh = make_mesh(MeshConfig(), "cpu")

    def no_call(*a, **k):
        raise AssertionError("a collective called its group at size 1")

    for name in ("all_reduce", "all_to_all_single", "batch_isend_irecv"):
        monkeypatch.setattr(dist, name, no_call)
    seen = {}

    def body(x):
        seen["index"] = (C.axis_index("sp"), C.axis_size("sp"),
                         C.axis_index("pp"))
        assert C.ppermute(x, "sp", [(0, 0)]) is x
        pair = (x, x * 2)
        assert all(a is b for a, b in zip(C.ppermute(pair, "sp", [(0, 0)]),
                                          pair))
        assert C.all_to_all(x, "sp", 1, 0) is x
        assert C.psum(x, "pp") is x
        return x

    x = torch.arange(8.0).reshape(2, 4)
    y = manual_shard_map(body, {"sp", "pp"}, in_specs=(P(None, "sp"),),
                         out_specs=P(None, "sp"), mesh=mesh)(x)
    assert seen["index"] == (0, 1, 0)
    assert torch.equal(y.full_tensor(), x)


# -- 8 gloo ranks: the reference's own layout -------------------------------

SLOW_ATTN = {name: case for name, case in ATTN_CASES.items()
             if not case[1] and case[3] == H}


@pytest.fixture(scope="module")
def eight_ranks():
    return _spawn(8, {"dp": 1, "sp": 4, "tp": 2}, SLOW_ATTN, (), ())


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SLOW_ATTN))
def test_sequence_parallel_attention(eight_ranks, name):
    ref, _, _, ranks = eight_ranks
    _assert_attention(ref[name], ranks[0][name])

"""The port's mesh and logical-axis sharding (``ray_tpu_torch.parallel``)
and the sharded Llama path, against the reference on CPU.

- ``logical_to_mesh_axes`` gives the reference's ``PartitionSpec`` entries
  for every rule, for repeated axes and for axes an earlier dimension
  consumed (pure, fast).
- ``make_mesh`` on a gloo group of world size 1 in this process: the six
  names, their sizes, one ``DeviceMesh`` dimension of size 1, and the
  sharded forward and loss of ``LlamaConfig.tiny`` bitwise the unsharded
  ones.
- 2 gloo ranks, spawned once for the module: the tiny model under each
  2-rank layout (``dp``, ``fsdp`` and ``tp`` dense with flash attention
  through the manual region, on its plain path; ``ep`` with 4 experts).
  Each layout's loss equals the reference's single-device ``loss_fn``
  within 1e-4 (the reference's bound, ``tests/test_model_parallel.py``),
  and one sharded train step gives the reference's single-device step's
  loss and grad_norm within 1e-5 and its params within 1e-4 where the
  reference's grad is at least 1e-6, with at most 0.1% of the elements
  beyond 1e-5 (``test_torch_llama_moe.py`` gives the reasons).
- Slow lane: 8 gloo ranks with the reference's own shapes
  (``dp_fsdp_tp`` (2, 2, 2), ``flash_shmap`` (dp=4, tp=2),
  ``moe_ring_sp`` (dp=2, sp=2, ep=2), ``moe_ulysses`` (sp=4, ep=2), MoE
  over dp=2, ep=2, tp=2 with the reference attention, and the train step
  at (2, 2, 2)).

The ranks run ``_rank_main`` in spawned processes, which import this
module to unpickle it: it imports neither torch nor jax at its top.
"""

import multiprocessing
import socket

import numpy as np
import pytest

# AdamW at its full rate from the first step (the default warmup makes
# the first update 0), as the reference's default_optimizer.
OPT = dict(lr=1e-2, warmup=0, decay_steps=10)

# name -> (LlamaConfig.tiny kwargs, MeshConfig kwargs)
LAYOUTS_2 = {
    "dp": ({"attn_impl": "flash"}, dict(dp=2)),
    "fsdp": ({"attn_impl": "flash"}, dict(dp=1, fsdp=2)),
    "tp": ({"attn_impl": "flash"}, dict(dp=1, tp=2)),
    "ep_moe": ({"num_experts": 4}, dict(dp=1, ep=2)),
}
LAYOUTS_8 = {
    "dp_fsdp_tp": ({}, dict(dp=2, fsdp=2, tp=2)),
    "flash_shmap": ({"attn_impl": "flash"}, dict(dp=4, tp=2)),
    # MoE beside tensor parallelism (not a layout of the reference's).
    "moe_dp_ep_tp": ({"num_experts": 4}, dict(dp=2, ep=2, tp=2)),
    "moe_ring_sp": ({"num_experts": 4, "attn_impl": "ring"},
                    dict(dp=2, sp=2, ep=2)),
    "moe_ulysses": ({"num_experts": 4, "attn_impl": "ulysses"},
                    dict(dp=1, sp=4, ep=2)),
}


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _gather(procs, out, n, timeout=600):
    """{rank: result} of the ``n`` ``(rank, result)`` pairs the ranks put
    on ``out``; fails as soon as a rank has died, not at the timeout."""
    import queue
    import time

    got, deadline = {}, time.monotonic() + timeout
    while len(got) < n:
        try:
            rank, res = out.get(timeout=2)
            got[rank] = res
        except queue.Empty:
            dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            assert not dead, f"a rank exited with {dead}"
            assert time.monotonic() < deadline, "the ranks timed out"
    return got


def _rank_main(rank, world, port, cases, out):
    """One rank: for each case, the sharded loss and one sharded train
    step of the tiny model from the reference's params; rank 0 puts
    {name: results} on ``out``."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import (
        LlamaConfig, loss_fn, param_logical_axes, params_from_jax)
    from ray_tpu_torch.parallel import (
        MeshConfig, make_mesh, shard_pytree)
    from ray_tpu_torch.train import (
        default_optimizer, make_train_step, train_state_from_params)
    from ray_tpu_torch.train.core import tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        results = {}
        for name, (cfg_kw, mesh_kw, np_params, toks) in cases.items():
            cfg = LlamaConfig.tiny(**cfg_kw)
            mesh = make_mesh(MeshConfig(**mesh_kw), "cpu")
            params = shard_pytree(params_from_jax(np_params, cfg, "cpu"),
                                  param_logical_axes(cfg), mesh)
            batch = {"tokens": torch.from_numpy(toks)}
            with torch.no_grad():
                loss, metrics = loss_fn(params, batch, cfg, mesh=mesh)
            opt = default_optimizer(**OPT)
            state = train_state_from_params(params, opt)
            state, m = make_train_step(cfg, opt, mesh=mesh)(state, batch)
            results[name] = {
                "mesh": (mesh.shape,
                         mesh.device_mesh.mesh_dim_names),
                "wq_placements": [str(p) for p in
                                  state.params["layers"]["wq"].placements],
                "loss": float(loss), "aux_loss": float(metrics["aux_loss"]),
                "step": {k: float(v) for k, v in m.items()},
                "params": tree_map(lambda t: t.full_tensor().numpy(),
                                   state.params)}
        if rank == 0:
            out.put((rank, results))
    finally:
        dist.destroy_process_group()


def _reference(cfg_kw, batch_rows=4):
    """A numpy token batch and the reference's single-device loss, its
    grads, and its params and metrics after one step (numpy leaves)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jax_llama
    from ray_tpu.train import core as jax_core

    jcfg = jax_llama.LlamaConfig.tiny(**cfg_kw)
    opt = jax_core.default_optimizer(**OPT)
    state = jax_core.init_train_state(jax.random.PRNGKey(0), jcfg, opt)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(batch_rows, 33)).astype(np.int32)
    loss, metrics = jax_llama.loss_fn(state.params,
                                      {"tokens": jnp.asarray(toks)}, jcfg)
    grads = jax.grad(lambda p: jax_llama.loss_fn(
        p, {"tokens": jnp.asarray(toks)}, jcfg)[0])(state.params)
    state, m = jax_core.make_train_step(jcfg, opt, donate=False)(
        state, {"tokens": jnp.asarray(toks)})
    return {"tokens": toks, "loss": float(loss),
            "aux_loss": float(metrics["aux_loss"]),
            "step": {k: float(v) for k, v in m.items()},
            "grads": jax.tree.map(np.asarray, grads),
            "after": jax.tree.map(np.asarray, state.params)}


def _spawn(world, layouts, batch_rows=4):
    """Spawn ``world`` gloo ranks once for every layout; the reference
    runs here meanwhile.  Returns {name: (reference, ranks' results)}."""
    import jax

    from ray_tpu.models import llama as jax_llama

    np_params, refs = {}, {}
    toks = np.random.default_rng(0).integers(
        0, 256, size=(batch_rows, 33)).astype(np.int32)
    for cfg_kw, _ in layouts.values():
        key = tuple(sorted(cfg_kw.items()))
        if key not in np_params:
            np_params[key] = jax.tree.map(np.asarray, jax_llama.init_params(
                jax.random.PRNGKey(0), jax_llama.LlamaConfig.tiny(**cfg_kw)))
    cases = {name: (cfg_kw, mesh_kw, np_params[tuple(sorted(cfg_kw.items()))],
                    toks)
             for name, (cfg_kw, mesh_kw) in layouts.items()}
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, cases, out))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for cfg_kw, _ in layouts.values():
            key = tuple(sorted(cfg_kw.items()))
            if key not in refs:
                refs[key] = _reference(cfg_kw, batch_rows)
                assert np.array_equal(refs[key]["tokens"], toks)
        got = _gather(procs, out, 1)[0]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    return {name: (refs[tuple(sorted(cfg_kw.items()))], got[name])
            for name, (cfg_kw, _) in layouts.items()}


def _assert_layout(name, got, mesh_kw):
    shape, dim_names = got["mesh"]
    assert {a: n for a, n in shape.items() if n > 1} == {
        a: n for a, n in mesh_kw.items() if n > 1}, name
    assert dim_names == tuple(a for a in shape if shape[a] > 1), name


def _assert_loss(ref, got):
    assert abs(got["loss"] - ref["loss"]) < 1e-4
    assert abs(got["aux_loss"] - ref["aux_loss"]) < 1e-4


def _assert_step(ref, got):
    """``test_torch_llama_moe.py``'s limits for one step: loss and
    grad_norm within 1e-5; every param within 1e-4 where the reference's
    grad is at least 1e-6 (elsewhere Adam's first update is the sign of
    f32 noise: within lr); at most 0.1% of the elements beyond 1e-5."""
    from ray_tpu_torch.train.core import tree_leaves

    for k in ("loss", "grad_norm"):
        assert abs(got["step"][k] - ref["step"][k]) <= 1e-5, k
    n_far = n = 0
    for a, b, g in zip(tree_leaves(got["params"]), tree_leaves(ref["after"]),
                       tree_leaves(ref["grads"])):
        assert a.shape == b.shape
        d = np.abs(a - b)
        assert float(d.max()) <= OPT["lr"]
        sure = np.abs(g) >= 1e-6
        if sure.any():
            assert float(d[sure].max()) <= 1e-4
        n_far += int((d > 1e-5).sum())
        n += d.size
    assert n_far <= 1e-3 * n


# -- pure: the rules --------------------------------------------------------

_RULE_CASES = [
    ("batch", "seq", "embed"), ("batch", "seq", "heads", "head_dim"),
    ("batch", "seq", "kv_heads", "head_dim"), ("batch", "seq", "vocab"),
    ("vocab", "kernel_in"), ("kernel_in", "vocab"), ("layer", "embed"),
    ("layer", "kernel_in", "heads"), ("layer", "heads", "kernel_in"),
    ("layer", "expert", "kernel_in", "mlp"),
    ("layer", "expert", "mlp", "kernel_in"), ("expert", None, "embed"),
    ("stage", "layer", "mlp"), ("heads", "mlp"), ("mlp", "vocab", "heads"),
    ("batch", "kernel_in"), ("kernel_in", "batch"), ("batch", "batch"),
    (None, "unknown", "seq"), (),
]


@pytest.mark.parametrize("axes", _RULE_CASES, ids=str)
def test_logical_to_mesh_axes_matches_reference(axes):
    from ray_tpu.parallel import sharding as ref
    from ray_tpu_torch.parallel import sharding

    assert sharding.DEFAULT_RULES == ref.DEFAULT_RULES
    got = sharding.logical_to_mesh_axes(axes)
    assert tuple(got) == tuple(ref.logical_to_mesh_axes(axes))
    rules = {"batch": ("fsdp", "tp"), "embed": "tp", "heads": ("tp",),
             "mlp": ("dp", "fsdp", "tp")}
    assert tuple(sharding.logical_to_mesh_axes(axes, rules)) == tuple(
        ref.logical_to_mesh_axes(axes, rules))


def test_param_logical_axes_match_reference():
    from ray_tpu.models import llama as jax_llama
    from ray_tpu_torch.models import LlamaConfig, param_logical_axes

    for kw in ({}, {"num_experts": 4}):
        assert param_logical_axes(LlamaConfig.tiny(**kw)) == \
            jax_llama.param_logical_axes(jax_llama.LlamaConfig.tiny(**kw))


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


def test_make_mesh_needs_a_group_and_a_card():
    import torch

    from ray_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device_type="cpu")
    assert not torch.cuda.is_available()


def test_make_mesh_on_cuda_needs_nccl(world1, monkeypatch):
    """A card asked for over a gloo group raises; no CPU mesh stands in."""
    import torch

    from ray_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="NCCL process group"):
        make_mesh()


def test_make_mesh_world_one(world1):
    from ray_tpu_torch.parallel import (
        MESH_AXES, MeshConfig, make_mesh, mesh_axis_size, use_mesh)
    from ray_tpu_torch.parallel.mesh import current_mesh
    from ray_tpu_torch.parallel.sharding import placements, sharding_tree

    with pytest.raises(RuntimeError, match="CUDA device"):
        make_mesh(MeshConfig())
    mesh = make_mesh(MeshConfig(), "cpu")
    assert mesh.axis_names == MESH_AXES
    assert all(mesh_axis_size(mesh, a) == 1 for a in MESH_AXES)
    assert [mesh.dim(a) for a in MESH_AXES] == [None] * 6
    assert mesh.device_mesh.ndim == 1 and mesh.device_mesh.size() == 1
    assert mesh.device_type == "cpu"
    assert [str(p) for p in placements(mesh, "batch", "seq", "embed")] == \
        ["R"]
    tree = sharding_tree({"w": ("kernel_in", "vocab"), "n": {"b": ()}}, mesh)
    assert {k: str(v) for k, v in tree.items() if k == "w"} == \
        {"w": "(Replicate(),)"} and tree["n"]["b"] == placements(mesh)
    assert current_mesh() is None
    with use_mesh(mesh):
        assert current_mesh() is mesh
    assert current_mesh() is None
    with pytest.raises(ValueError, match="wants 2 devices"):
        make_mesh(MeshConfig(dp=2), "cpu")


@pytest.mark.parametrize("num_experts", [0, 4])
def test_world_one_mesh_forward_is_the_unsharded_forward(world1,
                                                        num_experts,
                                                        monkeypatch):
    """Sharded over a world of one, the forward and the loss are bitwise
    the unsharded ones (the one-hot embedding picks exact rows), and
    flash attention runs inside the manual region.  The mesh's MoE layer
    is the dense one-hot formulation, so the unsharded side runs it too
    (local tensors take it under a ``constrain``); the local path's slot
    gathers are held to it in ``test_torch_moe.py``."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import (
        LlamaConfig, forward, init_params, loss_fn, param_logical_axes)
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.moe import moe_ffn
    from ray_tpu_torch.parallel import MeshConfig, make_mesh, shard_pytree

    def dense_moe(*args, constrain=None, **kw):
        return moe_ffn(*args, constrain=constrain or (lambda x, axes: x),
                       **kw)

    monkeypatch.setattr(llama, "moe_ffn", dense_moe)
    torch.set_num_threads(1)
    cfg = LlamaConfig.tiny(attn_impl="flash", num_experts=num_experts,
                           num_kv_heads=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 17)))
    mesh = make_mesh(MeshConfig(), "cpu")
    sharded = shard_pytree(params, param_logical_axes(cfg), mesh)
    logits, aux = forward(sharded, toks[:, :-1], cfg, mesh=mesh)
    want, want_aux = forward(params, toks[:, :-1], cfg)
    assert isinstance(logits, DTensor)
    assert torch.equal(logits.full_tensor(), want)
    assert torch.equal(aux.full_tensor(), want_aux)
    got, _ = loss_fn(sharded, {"tokens": toks}, cfg, mesh=mesh)
    assert not isinstance(got, DTensor)
    assert torch.equal(got, loss_fn(params, {"tokens": toks}, cfg)[0])


def test_manual_shard_map_specs(world1):
    import torch

    from ray_tpu_torch.parallel import MeshConfig, make_mesh, use_mesh
    from ray_tpu_torch.parallel.sharding import (
        P, manual_shard_map, with_logical_constraint)

    x = torch.arange(6.0).reshape(2, 3)
    assert with_logical_constraint(x, ("batch", "embed")) is x
    with pytest.raises(ValueError, match="outside the manual axes"):
        manual_shard_map(lambda a: a, {"dp"}, in_specs=(P("tp", None),),
                         out_specs=P("tp", None))
    double = manual_shard_map(lambda a: (a * 2, a.sum()), {"dp"},
                              in_specs=(P("dp", None),),
                              out_specs=(P("dp", None), P()))
    with pytest.raises(ValueError, match="ambient mesh"):
        double(x)
    mesh = make_mesh(MeshConfig(), "cpu")
    with use_mesh(mesh):
        y, total = double(x)
    assert torch.equal(y.full_tensor(), x * 2)
    assert float(total.full_tensor()) == 15.0


# -- 2 gloo ranks, spawned once ---------------------------------------------

@pytest.fixture(scope="module")
def two_ranks():
    return _spawn(2, LAYOUTS_2)


@pytest.mark.parametrize("name", sorted(LAYOUTS_2))
def test_two_rank_loss_matches_single_device(two_ranks, name):
    ref, got = two_ranks[name]
    _assert_layout(name, got, LAYOUTS_2[name][1])
    _assert_loss(ref, got)


@pytest.mark.parametrize("name", sorted(LAYOUTS_2))
def test_two_rank_train_step_matches_single_device(two_ranks, name):
    ref, got = two_ranks[name]
    _assert_step(ref, got)


def test_two_rank_params_are_sharded_by_the_rules(two_ranks):
    """wq is ('layer', 'kernel_in', 'heads'): Shard(1) over fsdp,
    Shard(2) over tp, replicated over dp and ep."""
    placements = {name: got["wq_placements"]
                  for name, (_, got) in two_ranks.items()}
    assert placements == {"dp": ["R"], "fsdp": ["S(1)"], "tp": ["S(2)"],
                          "ep_moe": ["R"]}


# -- 8 gloo ranks: the reference's own shapes --------------------------------

@pytest.fixture(scope="module")
def eight_ranks():
    return _spawn(8, LAYOUTS_8, batch_rows=8)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(LAYOUTS_8))
def test_sharded_loss_matches_single_device(eight_ranks, name):
    ref, got = eight_ranks[name]
    _assert_layout(name, got, LAYOUTS_8[name][1])
    _assert_loss(ref, got)


@pytest.mark.slow
def test_train_step_sharded_matches_single_device(eight_ranks):
    ref, got = eight_ranks["dp_fsdp_tp"]
    _assert_step(ref, got)

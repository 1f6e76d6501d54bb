"""The port's GPipe pipeline (``ray_tpu_torch.parallel.pipeline``),
``forward_pipelined`` and the pipelined train step, against the
reference on CPU.

- In this process: ``split_stages`` against the reference's, and the
  divisibility error.
- 2 gloo ranks (pp=2), spawned once for the module, while the reference
  runs here on its 8 virtual devices:
  - ``pipeline_apply`` of a toy stage (``x @ W`` on integer-valued f32,
    4 microbatches): the output and the grads of W and x bitwise the
    reference's ``pipeline_apply`` at pp=2;
  - ``forward_pipelined`` of ``LlamaConfig.tiny(num_layers=4)`` with the
    plain and the flash attention (its plain path on the CPU) within 5e-4
    of the reference's single-device ``forward`` (the reference's bound,
    ``tests/test_model_parallel.py``);
  - the pipelined train step: every grad (embedding and head included)
    within 1e-5 of ``jax.grad`` of the reference's single-device
    ``loss_fn``, and the step within ``test_torch_sharding``'s limits.
- 4 gloo ranks (pp=2 x sp=2): ring and Ulysses attention inside the
  pipeline stages, the forward within 5e-4 of the reference's.
- Slow lane: 8 ranks with the reference's own layouts
  (``test_pipelined_forward_matches``: dp=2, pp=2, tp=2 with the plain
  attention; dp=2, pp=2, sp=2 with ring attention).

The ranks run ``_rank_main`` in spawned processes, which import this
module to unpickle it: it imports neither torch nor jax at its top.
"""

import functools
import multiprocessing

import numpy as np
import pytest

from test_torch_sharding import (
    OPT, _assert_step, _free_port, _gather, _reference)

M = 4                       # microbatches
TOY_D = 8
# name -> (LlamaConfig.tiny kwargs, MeshConfig kwargs, with a train step)
LAYOUTS_2 = {
    "reference": ({"num_layers": 4}, dict(dp=1, pp=2), True),
    "flash": ({"num_layers": 4, "attn_impl": "flash"}, dict(dp=1, pp=2),
              False),
}
LAYOUTS_4 = {
    "ring": ({"num_layers": 4, "attn_impl": "ring"}, dict(dp=1, pp=2, sp=2),
             False),
    "ulysses": ({"num_layers": 4, "attn_impl": "ulysses"},
                dict(dp=1, pp=2, sp=2), False),
}
LAYOUTS_8 = {
    "reference": ({"num_layers": 4}, dict(dp=2, pp=2, tp=2), False),
    "ring": ({"num_layers": 4, "attn_impl": "ring"}, dict(dp=2, pp=2, sp=2),
             False),
}


def _toy():
    """Integer-valued stage weights (pp=2), input and loss weights: every
    product and sum below is exact in f32."""
    rng = np.random.default_rng(3)
    w = rng.integers(-2, 3, size=(2, TOY_D, TOY_D)).astype(np.float32)
    x = rng.integers(-3, 4, size=(8, TOY_D)).astype(np.float32)
    c = rng.integers(-2, 3, size=(8, TOY_D)).astype(np.float32)
    return w, x, c


def _rank_main(rank, world, port, cases, toy, out):
    """One rank: the toy pipeline (when ``toy``), then for each case the
    pipelined forward and, when asked, the pipelined grads and one
    pipelined step; puts (rank, {name: results}) on ``out``."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import (
        LlamaConfig, param_logical_axes, params_from_jax)
    from ray_tpu_torch.models.llama import forward_pipelined
    from ray_tpu_torch.parallel import (
        MeshConfig, make_mesh, pipeline_apply, shard_pytree)
    from ray_tpu_torch.train import (
        default_optimizer, make_train_step, train_state_from_params)
    from ray_tpu_torch.train.core import loss_and_grads, tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        res = {}
        if toy:
            mesh = make_mesh(MeshConfig(dp=1, pp=2), "cpu")
            w, x, c = (torch.from_numpy(a) for a in _toy())
            w.requires_grad_()
            x.requires_grad_()
            y = pipeline_apply(lambda p, a: a @ p, w, x, mesh=mesh,
                               num_microbatches=M).full_tensor()
            (y * c).sum().backward()
            res["toy"] = [t.detach().numpy() for t in (y, w.grad, x.grad)]
        for name, (cfg_kw, mesh_kw, step, np_params, toks) in cases.items():
            cfg = LlamaConfig.tiny(**cfg_kw)
            mesh = make_mesh(MeshConfig(**mesh_kw), "cpu")
            params = shard_pytree(params_from_jax(np_params, cfg, "cpu"),
                                  param_logical_axes(cfg), mesh)
            t = torch.from_numpy(toks)
            with torch.no_grad():
                logits, aux = forward_pipelined(
                    params, t[:, :-1], cfg, mesh=mesh, num_microbatches=M)
            got = {"logits": logits.full_tensor().numpy(),
                   "aux": float(aux.full_tensor())}
            if step:
                fwd = functools.partial(forward_pipelined, cfg=cfg,
                                        mesh=mesh, num_microbatches=M)
                _, _, grads = loss_and_grads(params, {"tokens": t}, cfg,
                                             mesh=mesh, forward_fn=fwd)
                got["grads"] = tree_map(lambda g: g.full_tensor().numpy(),
                                        grads)
                opt = default_optimizer(**OPT)
                state = train_state_from_params(params, opt)
                state, m = make_train_step(
                    cfg, opt, mesh=mesh, pipelined=True,
                    num_microbatches=M)(state, {"tokens": t})
                got["step"] = {k: float(v) for k, v in m.items()}
                got["params"] = tree_map(lambda p: p.full_tensor().numpy(),
                                         state.params)
            res[name] = got
        out.put((rank, res))
    finally:
        dist.destroy_process_group()


def _jax_toy():
    """The reference's pipeline_apply of the toy at pp=2 (of its 8
    devices): (y, grad W, grad x)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import MeshConfig, make_mesh, use_mesh
    from ray_tpu.parallel.pipeline import pipeline_apply

    mesh = make_mesh(MeshConfig(dp=4, pp=2))
    w, x, c = map(jnp.asarray, _toy())

    def run(w_, x_):
        return pipeline_apply(lambda p, a: a @ p, w_, x_, mesh=mesh,
                              num_microbatches=M)

    with use_mesh(mesh):
        y = jax.jit(run)(w, x)
        gw, gx = jax.jit(jax.grad(lambda a, b: (run(a, b) * c).sum(),
                                  (0, 1)))(w, x)
    return [np.asarray(a) for a in (y, gw, gx)]


def _jax_forward(cfg_kw, np_params, toks):
    import jax.numpy as jnp

    from ray_tpu.models import llama as jax_llama

    cfg = jax_llama.LlamaConfig.tiny(**cfg_kw)
    logits, _ = jax_llama.forward(np_params, jnp.asarray(toks[:, :-1]), cfg)
    return np.asarray(logits)


def _spawn(world, layouts, toy, batch_rows=8):
    """Spawn ``world`` gloo ranks once for every layout; the reference
    runs here meanwhile.  Returns ({name: reference}, reference toy,
    [each rank's results])."""
    import jax

    from ray_tpu.models import llama as jax_llama

    toks = np.random.default_rng(0).integers(
        0, 256, size=(batch_rows, 33)).astype(np.int32)
    cases = {}
    for name, (cfg_kw, mesh_kw, step) in layouts.items():
        np_params = jax.tree.map(np.asarray, jax_llama.init_params(
            jax.random.PRNGKey(0), jax_llama.LlamaConfig.tiny(**cfg_kw)))
        cases[name] = (cfg_kw, mesh_kw, step, np_params, toks)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, cases, toy, out))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        refs = {}
        for name, (cfg_kw, _, step, np_params, _) in cases.items():
            refs[name] = {"logits": _jax_forward(cfg_kw, np_params, toks)}
            if step:
                refs[name].update(_reference(cfg_kw, batch_rows))
                assert np.array_equal(refs[name]["tokens"], toks)
        ref_toy = _jax_toy() if toy else None
        got = _gather(procs, out, world)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    return refs, ref_toy, [got[r] for r in range(world)]


def _assert_forward(ref, got):
    assert got["logits"].shape == ref["logits"].shape
    assert np.max(np.abs(got["logits"] - ref["logits"])) < 5e-4
    assert got["aux"] == 0.0


# -- in this process ---------------------------------------------------------

def test_split_stages_matches_reference():
    import jax.numpy as jnp
    import torch

    from ray_tpu.parallel.pipeline import split_stages as jsplit
    from ray_tpu_torch.parallel import split_stages

    layers = {"w": np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2),
              "n": {"b": np.arange(4, dtype=np.float32)}}
    want = jsplit({"w": jnp.asarray(layers["w"]),
                   "n": {"b": jnp.asarray(layers["n"]["b"])}}, 2)
    got = split_stages({"w": torch.from_numpy(layers["w"]),
                        "n": {"b": torch.from_numpy(layers["n"]["b"])}}, 2)
    assert np.array_equal(got["w"].numpy(), np.asarray(want["w"]))
    assert np.array_equal(got["n"]["b"].numpy(), np.asarray(want["n"]["b"]))
    assert got["w"].shape == (2, 2, 3, 2)
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        split_stages({"w": torch.zeros(4, 2)}, 3)


def test_pipeline_batch_must_split_into_microbatches():
    """The reference's order: the one-stage shortcut first, then the
    batch's divisibility (a region over pp and sp takes no shortcut)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshConfig, make_mesh, pipeline_apply

    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(MeshConfig(), "cpu")
        w, x = torch.ones(1, 2, 2), torch.ones(6, 2)
        y = pipeline_apply(lambda p, a: a @ p, w, x, mesh=mesh,
                           num_microbatches=4)
        assert torch.equal(y, x @ w[0])
        with pytest.raises(ValueError, match="batch 6 % microbatches 4"):
            pipeline_apply(lambda p, a: a @ p, w, x, mesh=mesh,
                           num_microbatches=4, manual_axes={"pp", "sp"})
    finally:
        dist.destroy_process_group()


# -- 2 gloo ranks, spawned once ---------------------------------------------

@pytest.fixture(scope="module")
def two_ranks():
    return _spawn(2, LAYOUTS_2, toy=True)


def test_two_rank_toy_pipeline_is_bitwise_the_reference(two_ranks):
    _, want, ranks = two_ranks
    for got in ranks:
        for a, b in zip(got["toy"], want):
            assert a.shape == b.shape
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(LAYOUTS_2))
def test_two_rank_forward_pipelined_matches_forward(two_ranks, name):
    refs, _, ranks = two_ranks
    for got in ranks:
        _assert_forward(refs[name], got[name])


def test_two_rank_pipelined_grads_match_jax_grad(two_ranks):
    from ray_tpu_torch.train.core import tree_leaves

    refs, _, ranks = two_ranks
    ref = refs["reference"]
    for got in ranks:
        leaves = tree_leaves(got["reference"]["grads"])
        want = tree_leaves(ref["grads"])
        assert len(leaves) == len(want)
        for a, b in zip(leaves, want):
            assert a.shape == b.shape
            assert np.max(np.abs(a - b)) <= 1e-5
        for key in ("embed", "lm_head"):
            g = got["reference"]["grads"][key]
            assert np.max(np.abs(g - ref["grads"][key])) <= 1e-5
            assert np.abs(g).max() > 0


def test_two_rank_pipelined_train_step_matches_single_device(two_ranks):
    refs, _, ranks = two_ranks
    for got in ranks:
        _assert_step(refs["reference"], got["reference"])


# -- 4 gloo ranks: sequence parallelism inside the stages --------------------

@pytest.fixture(scope="module")
def four_ranks():
    return _spawn(4, LAYOUTS_4, toy=False)


@pytest.mark.parametrize("name", sorted(LAYOUTS_4))
def test_four_rank_seq_parallel_pipeline_matches_forward(four_ranks, name):
    refs, _, ranks = four_ranks
    _assert_forward(refs[name], ranks[0][name])


# -- 8 gloo ranks: the reference's own layouts -------------------------------

@pytest.fixture(scope="module")
def eight_ranks():
    return _spawn(8, LAYOUTS_8, toy=False)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(LAYOUTS_8))
def test_pipelined_forward_matches(eight_ranks, name):
    refs, _, ranks = eight_ranks
    _assert_forward(refs[name], ranks[0][name])

"""The train step's optimizer (``ray_tpu_torch.ops.optim``): the global
norm and the clipped AdamW update, as the kernels K5 on the card and their
plain versions on the CPU.

CPU cases: the launch planner's pointer tables (at most a table's leaves
each, every element covered once, as few launches as the tables allow); CPU leaves take the plain version, which is the port's optimizer
as it was written before the kernels, bit for bit; the clip engages only
when the norm reaches the clip; the update's arithmetic against an f64
computation; the optimizer state keeps its tree of per-leaf tensors.

Card cases (``gpu``; the ``cuda`` fixture of ``test_torch_kernels.py``):
the kernels against the plain version on the card, on the two benchmark
cells' leaf shapes scaled down, on sizes that are not a multiple of 4 (one
leaf a view that is not 16-byte aligned, one grad an expanded view) and
on a tree of 500 leaves
(several launches), with the clip engaged and idle, at count 0 (a warmup's
lr of 0) and at ``adam()``'s settings: p, m and v within 1e-6 of the plain
version relative to each leaf's largest magnitude, the norm within 1e-6
relative and bitwise equal across two calls; and the train step's
launches.

    python -m pytest -m gpu tests/test_torch_fused_optim.py
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build, optim
from ray_tpu_torch.train.core import (
    AdamW, _constant, adam, default_optimizer, global_norm)
from ray_tpu_torch.train.trees import tree_leaves, tree_map
from ray_tpu_torch.util import tracing
from test_torch_kernels import cuda  # noqa: F401  (the card fixture)

torch.set_num_threads(1)


# -- the optimizer as the port wrote it before the kernels (the oracle) ----

def _global_norm_before(leaves):
    sq = [g.float().square().sum() for g in leaves]
    return torch.sqrt(sum(sq))


def _update_before(opt, grads, opt_state, params, grad_norm):
    b1, b2, eps = opt.b1, opt.b2, opt.eps
    count = opt_state["count"]
    lr = opt.schedule(count)
    bc1 = 1.0 - b1 ** (count + 1)
    bc2 = 1.0 - b2 ** (count + 1)
    gs = list(tree_leaves(grads))
    if opt.grad_clip is not None:
        keep = grad_norm < opt.grad_clip
        gs = [torch.where(keep, g, g / grad_norm * opt.grad_clip)
              for g in gs]
    for p, g, m, v in zip(tree_leaves(params), gs,
                          tree_leaves(opt_state["mu"]),
                          tree_leaves(opt_state["nu"])):
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        upd = (m / bc1) / ((v / bc2).sqrt() + eps)
        if opt.weight_decay:
            upd.add_(p, alpha=opt.weight_decay)
        p.add_(upd, alpha=-lr)
    opt_state["count"] = count + 1


# -- trees -----------------------------------------------------------------

def _tree(shapes, gen, device="cpu", std=1.0):
    """A tensor for each shape of the dict ``shapes`` (nested dicts)."""
    if isinstance(shapes, dict):
        return {k: _tree(shapes[k], gen, device, std) for k in sorted(shapes)}
    return (torch.randn(shapes, generator=gen) * std).to(device)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


TINY = {"embed": (37, 8), "final_norm": (5,),
        "layers": {"wq": (2, 8, 8), "norm": (2, 8), "w_up": (2, 3, 8, 7)}}


def _cells_scaled(kind):
    """The benchmark cells' trees (13 leaves, layers stacked) at width 256
    in place of 4096, MLP 896 in place of 14336, vocab 2000."""
    d, m, v, kv = 256, 896, 2000, 64
    layers = 1 if kind == "mixtral" else 8
    lay = {"attn_norm": (layers, d), "wq": (layers, d, d),
           "wk": (layers, d, kv), "wv": (layers, d, kv),
           "wo": (layers, d, d), "mlp_norm": (layers, d)}
    if kind == "mixtral":
        lay.update(router=(layers, d, 8), w_gate=(layers, 8, d, m),
                   w_up=(layers, 8, d, m), w_down=(layers, 8, m, d))
    else:
        lay.update(w_gate=(layers, d, m), w_up=(layers, d, m),
                   w_down=(layers, m, d))
    return {"embed": (v, d), "layers": lay, "final_norm": (d,),
            "lm_head": (d, v)}


ODD = {"a": (1,), "b": (7,), "c": (1023,), "d": (4097, 3), "e": (3, 5, 11),
       "f": (2049,)}


# -- the launch planner ----------------------------------------------------

def _sizes(n_leaves):
    rng = np.random.default_rng(n_leaves)
    sizes = [int(x) for x in rng.integers(1, 20000, n_leaves) | 1]
    if n_leaves > 1:
        sizes[1] = 0                      # an empty leaf takes no slot
        sizes[-1] = 3 * 2 ** 20 + 7       # many chunks, an odd tail
    return sizes


# csrc/optim.cu's chunk and table sizes (``optim.limits()`` on the card).
TABLES = {"sumsq": (4096, 160), "adamw": (2048, 80)}


def _walk(launch, sizes, chunk):
    """The elements each chunk of ``launch`` covers, as csrc/optim.cu
    walks them: {leaf: [(start, stop)]}, one range per chunk."""
    out = {i: [] for i in launch.leaves}
    leaf = 0
    for c in range(launch.chunk0[-1]):
        while c >= launch.chunk0[leaf + 1]:
            leaf += 1
        i, start = launch.leaves[leaf], (c - launch.chunk0[leaf]) * chunk
        out[i].append((start, min(start + chunk, sizes[i])))
    return out


@pytest.mark.parametrize("kind", ["sumsq", "adamw"])
@pytest.mark.parametrize("n_leaves", [1, 13, 500])
def test_plan_covers_every_element_once_within_the_parameter_limit(
        kind, n_leaves):
    sizes = _sizes(n_leaves)
    chunk, most = TABLES[kind]
    launches = optim.plan(sizes, chunk, most)
    live = [i for i, n in enumerate(sizes) if n]
    assert len(launches) == -(-len(live) // most)
    assert [i for lo in launches for i in lo.leaves] == live
    for lo in launches:
        assert 1 <= len(lo.leaves) <= most
        assert len(lo.chunk0) == len(lo.leaves) + 1 and lo.chunk0[0] == 0
        for i, ranges in _walk(lo, sizes, chunk).items():
            assert all(a < b for a, b in ranges)
            assert ranges[0][0] == 0 and ranges[-1][1] == sizes[i]
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


# -- the plain version on the CPU ------------------------------------------

CASES = {
    "clip_engaged": (lambda: default_optimizer(lr=1e-2, warmup=2,
                                               decay_steps=50), 10.0),
    "clip_idle": (lambda: default_optimizer(lr=1e-2, warmup=2,
                                            decay_steps=50,
                                            grad_clip=1e3), 1.0),
    "no_clip": (lambda: AdamW(_constant(1e-2), weight_decay=0.1,
                              grad_clip=None), 10.0),
    "no_decay": (lambda: AdamW(_constant(1e-2), weight_decay=0.0,
                               grad_clip=1.0), 10.0),
    "adam": (lambda: adam(3e-4, grad_clip=0.5), 1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_leaves_take_the_plain_update_bitwise(case):
    make, std = CASES[case]
    opt, gen = make(), torch.Generator().manual_seed(1)
    params = _tree(TINY, gen)
    ref = tree_map(torch.clone, params)
    state, ref_state = opt.init(params), opt.init(ref)
    before = dict(_build.launches)
    tracing.reset()
    tracing.enable()
    try:
        for _ in range(3):
            grads = _tree(TINY, gen, std=std)
            norm = global_norm(tree_leaves(grads))
            ref_norm = _global_norm_before(tree_leaves(grads))
            assert torch.equal(norm, ref_norm)
            opt.update_(grads, state, params, norm)
            _update_before(opt, grads, ref_state, ref, ref_norm)
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
        tracing.reset()
    for a, b in zip(tree_leaves((params, state["mu"], state["nu"])),
                    tree_leaves((ref, ref_state["mu"], ref_state["nu"]))):
        assert torch.equal(a, b)
    assert state["count"] == ref_state["count"] == 3
    # The plain path launched no K5 kernel and counted nothing.
    assert dict(_build.launches) == before
    assert not _build.launches["rtt_optim_sumsq"]
    assert not _build.launches["rtt_optim_adamw"]
    assert counters == {}


@pytest.mark.parametrize("where", ["below", "at", "above"])
def test_clip_engages_only_when_the_norm_reaches_it(where):
    """The clipped update is the unclipped one of g / norm * clip when
    norm >= clip, and of g itself below it."""
    clip = 0.3
    norm = {"below": 0.15, "at": 0.3, "above": 1.2}[where]
    gen = torch.Generator().manual_seed(2)
    params, grads = _tree(TINY, gen), _tree(TINY, gen)
    clipped = AdamW(_constant(1e-2), weight_decay=0.1, grad_clip=clip)
    plain = AdamW(_constant(1e-2), weight_decay=0.1, grad_clip=None)
    ref = tree_map(torch.clone, params)
    state, ref_state = clipped.init(params), plain.init(ref)
    nt = torch.tensor(norm)
    clipped.update_(grads, state, params, nt)
    took = grads if where == "below" else tree_map(
        lambda g: g / nt * clip, grads)
    if where == "at":   # the clip's rounding shows in some elements
        assert not all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(took), tree_leaves(grads)))
    plain.update_(took, ref_state, ref, nt)
    for a, b in zip(tree_leaves((params, state["mu"], state["nu"])),
                    tree_leaves((ref, ref_state["mu"], ref_state["nu"]))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("clip,wd", [(None, 0.0), (None, 0.1), (0.5, 0.0),
                                     (0.5, 0.1)])
def test_update_follows_the_adamw_formula(clip, wd):
    """Two steps against the same arithmetic in f64 (numpy)."""
    gen = torch.Generator().manual_seed(3)
    opt = AdamW(_constant(1e-2), weight_decay=wd, grad_clip=clip)
    params = _tree(TINY, gen)
    state = opt.init(params)
    p = [x.double().numpy() for x in tree_leaves(params)]
    m = [np.zeros_like(x) for x in p]
    v = [np.zeros_like(x) for x in p]
    for count in range(2):
        grads = _tree(TINY, gen)
        norm = global_norm(tree_leaves(grads))
        opt.update_(grads, state, params, norm)
        gs = [g.double().numpy() for g in tree_leaves(grads)]
        n = np.sqrt(sum((g * g).sum() for g in gs))
        if clip is not None and n >= clip:
            gs = [g / n * clip for g in gs]
        bc1, bc2 = 1 - opt.b1 ** (count + 1), 1 - opt.b2 ** (count + 1)
        for i, g in enumerate(gs):
            m[i] = opt.b1 * m[i] + (1 - opt.b1) * g
            v[i] = opt.b2 * v[i] + (1 - opt.b2) * g * g
            upd = (m[i] / bc1) / (np.sqrt(v[i] / bc2) + opt.eps) + wd * p[i]
            p[i] = p[i] - 1e-2 * upd
    for got, want in zip(tree_leaves((params, state["mu"], state["nu"])),
                         p + m + v):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_opt_state_keeps_its_tree_of_per_leaf_tensors():
    gen = torch.Generator().manual_seed(4)
    opt = default_optimizer(lr=1e-2, warmup=0, decay_steps=10)
    params = _tree(TINY, gen)
    state = opt.init(params)
    ids = [id(t) for t in tree_leaves((state["mu"], state["nu"]))]
    grads = _tree(TINY, gen)
    opt.update_(grads, state, params, global_norm(tree_leaves(grads)))
    assert sorted(state) == ["count", "mu", "nu"] and state["count"] == 1
    for moment in (state["mu"], state["nu"]):
        assert _shapes(moment) == TINY
    assert [id(t) for t in tree_leaves((state["mu"], state["nu"]))] == ids


# -- the kernels on the card -----------------------------------------------

def _card_tree(kind, gen, dev, std=1.0):
    if kind == "many":
        rng = np.random.default_rng(5)
        shapes = {f"l{i:03d}": (int(n),)
                  for i, n in enumerate(rng.integers(1, 3000, 500))}
        return _tree(shapes, gen, dev, std)
    if kind == "odd":
        tree = _tree(ODD, gen, dev, std)
        # A leaf that does not start on 16 bytes: the element-wise path.
        tree["f"] = _tree({"x": (2050,)}, gen, dev, std)["x"][1:]
        return tree
    return _tree(_cells_scaled(kind), gen, dev, std)


CARD_CASES = {
    "clip_engaged": (lambda: default_optimizer(lr=1e-2, warmup=2,
                                               decay_steps=50), 5, 10.0),
    "clip_idle": (lambda: default_optimizer(lr=1e-2, warmup=2,
                                            decay_steps=50,
                                            grad_clip=1e6), 5, 1.0),
    "count0": (lambda: default_optimizer(), 0, 10.0),
    "adam": (lambda: adam(3e-4, grad_clip=0.5), 3, 1.0),
}


def _close(got, want, what):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= 1e-6 * scale, f"{what}: {err} over {scale}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("tree", ["mixtral", "mistral", "odd", "many"])
def test_kernels_match_the_plain_version_on_the_card(cuda, tree, case):
    make, count, std = CARD_CASES[case]
    opt, gen = make(), torch.Generator().manual_seed(6)
    params = _card_tree(tree, gen, cuda)
    state = opt.init(params)
    for moment in (state["mu"], state["nu"]):
        for t in tree_leaves(moment):
            t.copy_(torch.randn(t.shape, generator=gen).abs().to(cuda) * 1e-3)
    state["count"] = count
    ref = tree_map(torch.clone, params)
    ref_state = dict(state, mu=tree_map(torch.clone, state["mu"]),
                     nu=tree_map(torch.clone, state["nu"]))
    grads = _card_tree(tree, gen, cuda, std)
    if tree == "odd":   # autograd's grad of a leaf used only by sum()
        grads["b"] = grads["b"][:1].expand(7)
    gs = tree_leaves(grads)
    before = dict(_build.launches)
    norm = global_norm(gs)
    assert torch.equal(norm, global_norm(gs))
    want = optim._global_norm_plain([g.contiguous() for g in gs])
    assert abs(norm.item() - want.item()) <= 1e-6 * want.item()
    opt.update_(grads, state, params, norm)
    launches = {k: _build.launches[k] - before.get(k, 0)
                for k in ("rtt_optim_sumsq", "rtt_optim_adamw")}
    lim = optim.limits()
    assert TABLES == {"sumsq": (lim.sumsq_chunk, lim.sumsq_leaves),
                      "adamw": (lim.adamw_chunk, lim.adamw_leaves)}
    tables = {k: len(optim.plan([g.numel() for g in gs], *TABLES[k]))
              for k in ("sumsq", "adamw")}
    assert launches == {"rtt_optim_sumsq": 2 * tables["sumsq"],
                        "rtt_optim_adamw": tables["adamw"]}
    lr = opt.schedule(count)
    optim._adamw_plain_(
        tree_leaves(ref), gs, tree_leaves(ref_state["mu"]),
        tree_leaves(ref_state["nu"]), want, grad_clip=opt.grad_clip,
        b1=opt.b1, b2=opt.b2, eps=opt.eps, weight_decay=opt.weight_decay,
        lr=lr, bc1=1 - opt.b1 ** (count + 1), bc2=1 - opt.b2 ** (count + 1))
    for name, a, b in (("p", params, ref), ("m", state["mu"],
                                             ref_state["mu"]),
                       ("v", state["nu"], ref_state["nu"])):
        for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
            _close(x, y, f"{name}[{i}]")
    if lr == 0.0:
        for x, y in zip(tree_leaves(params), tree_leaves(ref)):
            assert torch.equal(x, y)


@pytest.mark.gpu
def test_train_step_launches_each_kernel_once_a_step(cuda):
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train.core import init_train_state, make_train_step

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16, head_dim=64,
                           attn_impl="flash", remat=True, max_seq_len=256)
    opt = default_optimizer(lr=1e-3, warmup=1, decay_steps=10)
    state = init_train_state(
        cfg, opt, torch.Generator(device=cuda).manual_seed(0), cuda)
    step = make_train_step(cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (2, 129), device=cuda)
    _build.reset_launches()
    tracing.reset()
    tracing.enable()
    try:
        for _ in range(2):
            state, metrics = step(state, {"tokens": tokens})
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
        tracing.reset()
    assert _build.launches["rtt_optim_sumsq"] == 2
    assert _build.launches["rtt_optim_adamw"] == 2
    assert counters == {}   # the launch counts show the kernels' path
    assert torch.isfinite(metrics["grad_norm"])

"""Flagship model family: Llama-style decoder LM, dense or MoE, on one
device or sharded over a mesh (counterpart: ``ray_tpu/models/llama.py``).

Params are a plain dict of tensors with the reference's layout: layers are
STACKED on a leading ``(L, ...)`` dim and every projection is ``x @ W``,
so converting the reference's param pytree is a plain copy
(``models.convert``).  Params live in ``cfg.param_dtype`` and are cast to
``cfg.dtype`` (bf16 on the flagship) at use; RMSNorm statistics, logits
and the loss are f32.  Attention goes to the flash kernels K1-K3
(``attn_impl="flash"``) or the plain ``mha_reference``; the large matmuls
stay ``torch.matmul``, as the reference leaves them to XLA.  With
``cfg.remat`` and grad enabled, each layer runs under activation
checkpointing, as the reference wraps its layer in ``jax.checkpoint``: the
backward recomputes the layer's forward (K1 included) instead of keeping
its activations.

MoE layers (``cfg.num_experts > 0``) use the dense-dispatch router of
``ops/moe.py``; the expert tensors carry the logical axis 'expert', which
the rules put on ``ep``.

Under a mesh (``forward(..., mesh=...)``) every param carries the logical
axes of ``param_logical_axes`` and the forward is the reference's global
view in DTensor: the embedding is a one-hot matmul, activations are
redistributed to their logical axes at the reference's constraint points,
attention runs per shard in a region manual over (dp, fsdp, tp), or over
'sp' for ring and Ulysses attention, and the MoE router routes the whole
batch on every rank.  The loss is that of the global batch, and the grads
of a step come back reduced.  Without a mesh, ring and Ulysses attention
are the plain attention, as in the reference.

``forward_pipelined`` splits the layers into 'pp' stages
(``parallel.pipeline``): a region manual over 'pp', or over 'pp' and 'sp'
when ring or Ulysses attention run over an 'sp' above 1 (seq sharded in
the region, RoPE offset by the rank's chunk).  The actor pipeline
(``train.pipeline_actors``) takes the stage helpers
``pipeline_stage_params``, ``make_pipeline_stage_fn`` and
``make_pipeline_loss_fn``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import (
    flash_attention, mha_reference, per_shard)
from ray_tpu_torch.ops.layers import (
    apply_rope, repeat_kv_heads, rms_norm, rope, swiglu)
from ray_tpu_torch.ops.moe import moe_ffn
from ray_tpu_torch.ops.ring_attention import (
    _ring_attention_sharded, ring_attention)
from ray_tpu_torch.ops.ulysses import _ulysses_sharded, ulysses_attention
from ray_tpu_torch.parallel.collectives import axis_index
from ray_tpu_torch.parallel.mesh import (
    AXIS_DP, AXIS_FSDP, AXIS_PP, AXIS_SP, AXIS_TP, Mesh, current_mesh,
    use_mesh)
from ray_tpu_torch.parallel.pipeline import pipeline_apply, split_stages
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, LogicalAxisRules, P, manual_shard_map, shard_pytree,
    with_logical_constraint)
from ray_tpu_torch.util import tracing


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    embed_dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    mlp_dim: int = 11008
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attn_impl: str = "flash"          # flash | ring | ulysses | reference
    num_experts: int = 0              # 0 = dense FFN
    num_selected: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    remat: bool = True

    @property
    def qkv_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        return LlamaConfig(embed_dim=5120, num_layers=40, num_heads=40,
                           num_kv_heads=40, mlp_dim=13824, **kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """CI-sized config: runs on one CPU in well under a second."""
        defaults = dict(vocab_size=256, embed_dim=64, num_layers=2,
                        num_heads=4, num_kv_heads=4, head_dim=16, mlp_dim=128,
                        max_seq_len=64, dtype=torch.float32, remat=False,
                        attn_impl="reference")
        defaults.update(kw)
        return LlamaConfig(**defaults)


def _dense_layer_shapes(cfg: LlamaConfig
                        ) -> Dict[str, Tuple[Tuple[int, ...], Tuple]]:
    """name -> (shape per layer, logical axes with the stacked 'layer'
    dim), in the reference's order: ``init_params`` draws in it."""
    d, h, kvd, m = cfg.embed_dim, cfg.qkv_dim, cfg.kv_dim, cfg.mlp_dim
    shapes = {
        "attn_norm": ((d,), ("layer", "embed")),
        "wq": ((d, h), ("layer", "kernel_in", "heads")),
        "wk": ((d, kvd), ("layer", "kernel_in", "kv_heads")),
        "wv": ((d, kvd), ("layer", "kernel_in", "kv_heads")),
        "wo": ((h, d), ("layer", "heads", "kernel_in")),
        "mlp_norm": ((d,), ("layer", "embed")),
    }
    if cfg.num_experts:
        e = cfg.num_experts
        shapes.update({
            "router": ((d, e), ("layer", "kernel_in", None)),
            "w_gate": ((e, d, m), ("layer", "expert", "kernel_in", "mlp")),
            "w_up": ((e, d, m), ("layer", "expert", "kernel_in", "mlp")),
            "w_down": ((e, m, d), ("layer", "expert", "mlp", "kernel_in")),
        })
    else:
        shapes.update({
            "w_gate": ((d, m), ("layer", "kernel_in", "mlp")),
            "w_up": ((d, m), ("layer", "kernel_in", "mlp")),
            "w_down": ((m, d), ("layer", "mlp", "kernel_in")),
        })
    return shapes


def param_logical_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """The logical axes of every param, in the params' tree."""
    layers = {k: ax for k, (_, ax) in _dense_layer_shapes(cfg).items()}
    return {
        "embed": ("vocab", "kernel_in"),
        "layers": layers,
        "final_norm": ("embed",),
        "lm_head": ("kernel_in", "vocab"),
    }


def check_supported(cfg: LlamaConfig) -> None:
    """Raise for an unknown attention implementation."""
    if cfg.attn_impl not in ("flash", "reference", "ring", "ulysses"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def _attend(q, k, v, cfg: LlamaConfig):
    """Flash attention, else the plain one (ring and Ulysses on one
    device, as the reference)."""
    if cfg.attn_impl == "flash":
        # The kernel takes contiguous (b, s, h, d) tensors: a head shard
        # of a reshaped DTensor may be a strided view.
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    k, v = repeat_kv_heads(q, k, v)
    return mha_reference(q, k, v, causal=True)


def _attention(q, k, v, cfg: LlamaConfig, mesh):
    """Attention of the configured impl.  Under a mesh, ring and Ulysses
    attention take their own region manual over 'sp'; the others run per
    shard, manual over (dp, fsdp, tp): batch over (dp, fsdp), heads over
    tp, seq whole, with k/v repeated to q's heads first, as the reference
    runs its flash kernel (which has no partitioning rule).  The plain
    attention takes the same region: its masks are plain tensors."""
    if mesh is None:
        return _attend(q, k, v, cfg)
    if cfg.attn_impl == "ring":
        return ring_attention(q, k, v, causal=True, mesh=mesh)
    if cfg.attn_impl == "ulysses":
        return ulysses_attention(q, k, v, causal=True, mesh=mesh)
    k, v = repeat_kv_heads(q, k, v)
    spec = P((AXIS_DP, AXIS_FSDP), None, AXIS_TP, None)
    return manual_shard_map(
        lambda q_, k_, v_: per_shard(
            lambda a, b, c: _attend(a, b, c, cfg), q_, k_, v_),
        {AXIS_DP, AXIS_FSDP, AXIS_TP}, in_specs=(spec, spec, spec),
        out_specs=spec, mesh=mesh)(q, k, v)


def _attention_sp_manual(q, k, v, cfg: LlamaConfig):
    """Attention inside a region already manual over 'sp' (the pipeline):
    the sharded bodies inline, no region of their own; Ulysses with the
    plain attention, as the reference's."""
    k, v = repeat_kv_heads(q, k, v)
    sm_scale = cfg.head_dim ** -0.5
    if cfg.attn_impl == "ulysses":
        return _ulysses_sharded(q, k, v, sm_scale, True, AXIS_SP,
                                use_flash=False)
    return _ring_attention_sharded(q, k, v, sm_scale, True, AXIS_SP)


def _make_cst(mesh, rules):
    if mesh is None:
        return lambda x, ax: x
    return lambda x, ax: with_logical_constraint(x, ax, mesh, rules)


def _layer(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: LlamaConfig,
           cos: torch.Tensor, sin: torch.Tensor, mesh, rules,
           sp_manual: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One transformer layer (the reference's ``_make_layer_fn`` body):
    ``(x, this layer's router aux loss)``, None for a dense FFN.
    ``sp_manual``: inside a region manual over 'sp' (the pipeline), where
    ring or Ulysses attention run inline over the bound axis."""
    cst = _make_cst(mesh, rules)
    b, s = x.shape[0], x.shape[1]
    h = rms_norm(x, lp["attn_norm"])
    q = (h @ lp["wq"].to(cfg.dtype)).reshape(b, s, cfg.num_heads,
                                             cfg.head_dim)
    k = (h @ lp["wk"].to(cfg.dtype)).reshape(b, s, cfg.num_kv_heads,
                                             cfg.head_dim)
    v = (h @ lp["wv"].to(cfg.dtype)).reshape(b, s, cfg.num_kv_heads,
                                             cfg.head_dim)
    q = cst(apply_rope(q, cos, sin), ("batch", "seq", "heads", "head_dim"))
    k = cst(apply_rope(k, cos, sin), ("batch", "seq", "kv_heads", "head_dim"))
    o = (_attention_sp_manual(q, k, v, cfg) if sp_manual
         else _attention(q, k, v, cfg, mesh)).reshape(b, s, cfg.qkv_dim)
    x = x + cst(o @ lp["wo"].to(cfg.dtype), ("batch", "seq", "embed"))
    h = rms_norm(x, lp["mlp_norm"])
    if cfg.num_experts:
        moe = moe_ffn(h.reshape(b * s, cfg.embed_dim), lp["router"],
                      lp["w_gate"], lp["w_up"], lp["w_down"],
                      num_selected=cfg.num_selected,
                      capacity_factor=cfg.capacity_factor,
                      constrain=cst if mesh is not None else None)
        ff, aux = moe.out.reshape(b, s, cfg.embed_dim), moe.aux_loss
    else:
        gate = h @ lp["w_gate"].to(cfg.dtype)
        up = h @ lp["w_up"].to(cfg.dtype)
        ff = swiglu(gate, up) @ lp["w_down"].to(cfg.dtype)
        aux = None
    return x + cst(ff, ("batch", "seq", "embed")), aux


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            *, mesh: Optional[Mesh] = None,
            rules: Optional[LogicalAxisRules] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (batch, seq) int -> (logits f32 (b, s, vocab), aux_loss),
    the router loss averaged over the layers (0 for dense layers).

    Under ``mesh`` the params are DTensors (``shard_pytree`` of
    ``param_logical_axes``, or ``train.init_train_state(mesh=...)``) and
    ``tokens`` is the global batch: a DTensor, or a plain tensor that
    holds it on every rank.  Logits and aux come back as DTensors."""
    check_supported(cfg)
    cst = _make_cst(mesh, rules)
    s = tokens.shape[1]
    cos, sin = rope(s, cfg.head_dim, cfg.rope_theta, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if mesh is None:
        x = params["embed"][tokens].to(cfg.dtype)
    else:
        tokens = shard_pytree(tokens, ("batch", "seq"), mesh, rules)
        cos, sin, aux = (shard_pytree(t, (None,) * t.dim(), mesh)
                         for t in (cos, sin, aux))
        # One-hot matmul instead of a gather: with a ('vocab', 'embed')
        # sharded table it is a local matmul and a sum over 'tp'.
        onehot = F.one_hot(tokens.long(), cfg.vocab_size).to(cfg.dtype)
        x = onehot @ params["embed"].to(cfg.dtype)
    x = cst(x, ("batch", "seq", "embed"))
    x, a = _run_layers(x, params["layers"], cfg, cos, sin, mesh, rules)
    if a is not None:
        aux = aux + a
    x = rms_norm(x, params["final_norm"])
    logits = (x @ params["lm_head"].to(cfg.dtype)).float()
    return cst(logits, ("batch", "seq", "vocab")), aux / cfg.num_layers


def _run_layers(x, layers, cfg: LlamaConfig, cos, sin, mesh, rules,
                sp_manual: bool = False):
    """x through the stacked ``layers`` (each (L, ...)), each layer under
    activation checkpointing when ``cfg.remat`` and grad are on:
    ``(x, summed aux loss or None)``."""
    # One unbind per stacked param: its backward stacks the layers' grads
    # in one pass, where indexing w[i] per layer would add L zero-padded
    # (L, ...) grads together.
    unbound = {n: w.unbind(0) for n, w in layers.items()}
    n_layers = len(next(iter(unbound.values())))
    remat = cfg.remat and torch.is_grad_enabled()
    remat_kw = tracing.remat_kwargs() if remat else {}
    aux = None
    for i in range(n_layers):
        lp = {n: w[i] for n, w in unbound.items()}
        if remat:
            x, a = checkpoint(_layer, x, lp, cfg, cos, sin, mesh, rules,
                              sp_manual, use_reentrant=False, **remat_kw)
        else:
            x, a = _layer(x, lp, cfg, cos, sin, mesh, rules, sp_manual)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def forward_pipelined(params: Dict[str, Any], tokens: torch.Tensor,
                      cfg: LlamaConfig, *, mesh: Mesh,
                      num_microbatches: int,
                      rules: Optional[LogicalAxisRules] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pipeline-parallel forward: the layers split into ``pp`` stages
    (``parallel.pipeline``), the embedding and the head on every stage.

    Sequence parallelism composes: with ring or Ulysses attention over an
    'sp' above 1 the pipeline region is manual over 'pp' and 'sp' (the
    reference cannot nest manual regions): activations enter
    seq-sharded, RoPE is offset by the 'sp' rank's chunk, and attention
    runs inline over the bound axis.

    The MoE aux loss is dropped inside the stages (a stage's output is
    the activation alone), as in the reference: the aux returned is 0.
    Params, tokens and results as for ``forward`` under a mesh."""
    check_supported(cfg)
    cst = _make_cst(mesh, rules)
    tokens = shard_pytree(tokens, ("batch", "seq"), mesh, rules)
    onehot = F.one_hot(tokens.long(), cfg.vocab_size).to(cfg.dtype)
    x = cst(onehot @ params["embed"].to(cfg.dtype), ("batch", "seq", "embed"))

    sp_manual = (cfg.attn_impl in ("ring", "ulysses")
                 and mesh.shape[AXIS_SP] > 1)
    if sp_manual:
        # Inside the region 'seq' is rank-local and 'sp' is bound: strip
        # it from the rules the stages see.
        inner_rules = dict(rules if rules is not None else DEFAULT_RULES)
        inner_rules["seq"] = None
        x_spec = P(None, AXIS_SP, None)
        manual_axes = {AXIS_PP, AXIS_SP}
    else:
        inner_rules, x_spec, manual_axes = rules, P(), {AXIS_PP}

    def stage_fn(stage_params, x_mb):
        inner = current_mesh()      # the region's free axes, or None
        s = x_mb.shape[1]
        offset = axis_index(AXIS_SP) * s if sp_manual else 0
        cos, sin = rope(s, cfg.head_dim, cfg.rope_theta, offset=offset,
                        device=x_mb.device)
        if inner is not None:
            cos, sin = (shard_pytree(t, (None, None), inner)
                        for t in (cos, sin))
        return _run_layers(x_mb, stage_params, cfg, cos, sin, inner,
                           inner_rules, sp_manual)[0]

    stages = split_stages(params["layers"], mesh.shape[AXIS_PP])
    with use_mesh(mesh):
        x = pipeline_apply(stage_fn, stages, x, mesh=mesh,
                           num_microbatches=num_microbatches,
                           manual_axes=manual_axes, x_spec=x_spec)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ params["lm_head"].to(cfg.dtype)).float()
    aux = shard_pytree(torch.zeros((), dtype=torch.float32,
                                   device=logits.device), (), mesh)
    return cst(logits, ("batch", "seq", "vocab")), aux


def pipeline_stage_params(params: Dict[str, Any],
                          num_stages: int) -> list:
    """The params of each stage of the ACTOR pipeline
    (``train.pipeline_actors``): the stacked layers cut into
    ``num_stages`` contiguous slices, the embedding on stage 0, the final
    norm and the LM head on the last stage, so each stage holds only its
    own tensors.  The slices are views of ``params``."""
    layers = params["layers"]
    n_layers = next(iter(layers.values())).shape[0]
    if n_layers % num_stages:
        raise ValueError(
            f"{n_layers} layers not divisible by {num_stages} stages")
    per = n_layers // num_stages
    out = []
    for s in range(num_stages):
        sp: Dict[str, Any] = {
            "layers": {k: v[s * per:(s + 1) * per]
                       for k, v in layers.items()}}
        if s == 0:
            sp["embed"] = params["embed"]
        if s == num_stages - 1:
            sp["final_norm"] = params["final_norm"]
            sp["lm_head"] = params["lm_head"]
        out.append(sp)
    return out


def make_pipeline_stage_fn(cfg: LlamaConfig) -> Callable:
    """The one stage function of the actor pipeline: embeds on the stage
    holding ``embed`` (its input is then the tokens), runs the stage's
    layers (``_run_layers``: flash attention K1-K3 on the card, each
    layer under activation checkpointing when ``cfg.remat`` and grad are
    on), and projects to f32 logits on the stage holding ``lm_head``."""
    check_supported(cfg)

    def stage_fn(sp: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        if "embed" in sp:
            x = sp["embed"][x].to(cfg.dtype)
        cos, sin = rope(x.shape[1], cfg.head_dim, cfg.rope_theta,
                        device=x.device)
        x, _ = _run_layers(x, sp["layers"], cfg, cos, sin, None, None)
        if "lm_head" in sp:
            x = rms_norm(x, sp["final_norm"])
            x = (x @ sp["lm_head"].to(cfg.dtype)).float()
        return x

    return stage_fn


def make_pipeline_loss_fn(cfg: LlamaConfig) -> Callable:
    """``(logits, targets) -> mean next-token NLL``: ``loss_fn``'s loss
    for the actor pipeline's last stage."""

    def pipeline_loss(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets[..., None].long()).mean()

    return pipeline_loss


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: LlamaConfig, *, mesh: Optional[Mesh] = None,
            rules: Optional[LogicalAxisRules] = None,
            forward_fn: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy.  batch: {"tokens": (b, s+1)} or
    {"inputs": (b, s), "targets": (b, s)}; returns (loss, metrics).
    ``forward_fn(params, inputs) -> (logits, aux)`` overrides the forward
    pass so there is one loss definition.  Under ``mesh`` the loss and
    the metrics are those of the global batch, as plain tensors with the
    same value on every rank."""
    if "tokens" in batch:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    else:
        inputs, targets = batch["inputs"], batch["targets"]
    if forward_fn is None:
        logits, aux = forward(params, inputs, cfg, mesh=mesh, rules=rules)
    else:
        logits, aux = forward_fn(params, inputs)
    if mesh is not None:
        targets = shard_pytree(targets, ("batch", "seq"), mesh, rules)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    loss = nll.mean()
    if mesh is not None:
        loss, aux = loss.full_tensor(), aux.full_tensor()
    total = loss + cfg.aux_loss_coef * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "perplexity": torch.exp(loss)}

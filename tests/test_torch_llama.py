"""Parity of the PyTorch port's Llama with the JAX reference on CPU.

The reference's own params (``ray_tpu.models.init_params``) are handed to
the port as numpy arrays (``params_from_jax``), the same token batch from
``numpy.random.default_rng`` goes through both forwards, and logits agree
within 1e-4, the loss within 1e-5 (f32, ``LlamaConfig.tiny``; the JAX
flash path runs its Pallas kernel in interpret mode, the port's CPU path
the kernel's plain version).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu_torch.entry import _flagship_cfg
from ray_tpu_torch.models import (
    LlamaConfig, forward, init_params, loss_fn, params_from_jax)

# Tiny shapes: more intra-op threads would only contend with the test
# files that pytest-xdist runs beside these.
torch.set_num_threads(1)


@pytest.mark.parametrize("attn_impl", ["flash", "reference"])
def test_tiny_forward_and_loss_match_jax(attn_impl):
    jcfg = jax_llama.LlamaConfig.tiny(attn_impl=attn_impl)
    cfg = LlamaConfig.tiny(attn_impl=attn_impl)
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    want_loss, want_m = jax_llama.loss_fn(jparams,
                                          {"tokens": jnp.asarray(toks)}, jcfg)
    got_loss, got_m = loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert abs(float(got_loss) - float(want_loss)) < 1e-5
    assert abs(float(got_m["perplexity"]) - float(want_m["perplexity"])) \
        < 1e-3
    assert float(got_m["aux_loss"]) == float(want_m["aux_loss"]) == 0.0
    want_logits, _ = jax_llama.forward(jparams, jnp.asarray(toks[:, :-1]),
                                       jcfg)
    got_logits, _ = forward(params, torch.from_numpy(toks[:, :-1]), cfg)
    assert got_logits.dtype == torch.float32
    assert np.max(np.abs(got_logits.numpy() - np.asarray(want_logits))) < 1e-4


def test_flash_and_reference_paths_agree_with_gqa():
    """Port against itself: the flash path (K1's plain version, GQA heads
    mapped) and the reference path give the same logits."""
    cfg = LlamaConfig.tiny(num_kv_heads=2, attn_impl="flash")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 20)))
    a, _ = forward(params, toks, cfg)
    b, _ = forward(params, toks, LlamaConfig.tiny(num_kv_heads=2,
                                                  attn_impl="reference"))
    assert torch.max(torch.abs(a - b)) < 1e-4


def test_init_params_layout_and_scale():
    """Same stacked layout, dtypes and fan-in scale as the reference's
    init (the draws differ: torch and jax.random are different RNGs)."""
    cfg = LlamaConfig.tiny(num_layers=3, embed_dim=256, mlp_dim=512)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jcfg = jax_llama.LlamaConfig.tiny(num_layers=3, embed_dim=256,
                                      mlp_dim=512)
    shapes = jax.eval_shape(
        lambda: jax_llama.init_params(jax.random.PRNGKey(0), jcfg))
    assert params["layers"].keys() == shapes["layers"].keys()
    for name, s in shapes["layers"].items():
        assert tuple(params["layers"][name].shape) == s.shape, name
        assert params["layers"][name].dtype == torch.float32
    assert tuple(params["embed"].shape) == shapes["embed"].shape
    assert tuple(params["lm_head"].shape) == shapes["lm_head"].shape
    wq = params["layers"]["wq"]
    assert abs(float(wq.std()) * 256 ** 0.5 - 1.0) < 0.05
    assert torch.equal(params["layers"]["attn_norm"],
                       torch.ones_like(params["layers"]["attn_norm"]))


@pytest.mark.parametrize("kw", [{"attn_impl": "ring"},
                                {"attn_impl": "ulysses"},
                                {"num_experts": 4}])
def test_unported_parts_raise(kw):
    cfg = LlamaConfig.tiny(**kw)
    params = init_params(LlamaConfig.tiny(), torch.Generator().manual_seed(0),
                         "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        forward(params, torch.zeros((1, 4), dtype=torch.int64), cfg)


def test_flagship_config_mirrors_graft_entry():
    """The port's entry() builds the same flagship as __graft_entry__
    (compared field by field, dtypes by name)."""
    import __graft_entry__

    want = __graft_entry__._flagship_cfg()
    got = _flagship_cfg()
    for f in ("vocab_size", "embed_dim", "num_layers", "num_heads",
              "num_kv_heads", "head_dim", "mlp_dim", "max_seq_len",
              "attn_impl", "remat", "num_experts"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16

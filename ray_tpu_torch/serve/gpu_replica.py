"""Device-resident greedy decode replica on one CUDA card (counterpart:
``ray_tpu/serve/tpu_replica.py``).

The same deployment the reference serves, with the card in place of the
``"model"`` mesh (sharding the projection over several cards waits for
the mesh slice).  Weights are integer-valued float32, so every matmul
below float32's 2^24 integer window is exact and the decoded chains are
bitwise comparable with ``reference_decode``, a plain host loop.  Greedy
picks take the FIRST maximum (``torch.argmax``, like ``jnp.argmax`` and
``np.argmax``): integer logits tie often.

Dense mode: the ``(MAX_BATCH, embed)`` hidden matrix stays on the card
between steps; joiners' rows go up before the previous step's tokens are
forced, and tokens are forced one step late, as in the reference.

Paged mode (``paged_kv`` knob): each position's value row (the emitted
token's embedding) lives in a block pool managed by
``kv_cache.PagedKVEngine``; every step reads the live requests' LAST rows
back through the block tables with the paged-attention kernel K4
(``window=1``: an exact gather), then drafts ``speculative_k`` tokens on
the host and verifies them in one batched forward.  Prefix reuse and
copy-on-write come from the engine.  The cache is updated in place (index
writes on the card), which keeps one pool instead of a copy per step.

Host syncs happen only where the reference forced values to the host:
the previous step's tokens (dense), the gathered last rows and the verify
step's argmax (paged).  All launches go to the current stream of the
scheduler thread.

Request format: ``{"prompt": int | [int, ...], "tokens": int}`` -> list of
``tokens`` greedily decoded ids (the dense path continues from the LAST
prompt token).  The disaggregated prefill/decode methods need the object
plane and are a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.kv_cache import PagedKVEngine

MAX_BATCH = 8


def _integer_weights(embed: int, vocab: int, seed: int):
    """Integer-valued f32 (w, emb, wd) from a seeded generator; wd is the
    draft model, a perturbed integer copy of w (mostly agrees with it)."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.round(torch.randn(embed, vocab, generator=gen) * 4.0)
    emb = torch.round(torch.randn(vocab, embed, generator=gen) * 4.0)
    wd = w + torch.round(torch.randn(embed, vocab, generator=gen) * 0.7)
    return w.numpy(), emb.numpy(), wd.numpy()


class MeshShardedDecoder:
    """Deployment-ready greedy decoder with card-resident weights.

    ``weights={"w", "emb", "wd"}`` (numpy; ``wd`` needed in paged mode)
    takes given weights, e.g. the reference decoder's ``_w_host`` /
    ``_emb_host`` / ``_wd_host``; without it integer weights are drawn
    from ``seed``.  ``device`` defaults to ``cuda:0``."""

    def __init__(self, embed: int = 32, vocab: int = 64, seed: int = 0,
                 paged: Optional[bool] = None, kv_blocks: int = 32,
                 kv_block_size: int = 8, max_slots: int = 16,
                 speculative_k: Optional[int] = None,
                 prefix_caching: Optional[bool] = None,
                 use_kernel: bool = True,
                 weights: Optional[Dict[str, Any]] = None,
                 device=None):
        self._dev = resolve_device(device)
        if weights is None:
            w, emb, wd = _integer_weights(embed, vocab, seed)
        else:
            # Copies: callers may hand read-only views (jax arrays).
            w = np.array(weights["w"], np.float32)
            emb = np.array(weights["emb"], np.float32)
            wd = weights.get("wd")
            wd = None if wd is None else np.array(wd, np.float32)
        # Host mirrors for slot-state init, drafts and the reference loop.
        self._w_host, self._emb_host, self._wd_host = w, emb, wd
        self._embed, self._vocab = w.shape
        if emb.shape != (self._vocab, self._embed):
            raise ValueError(f"emb {emb.shape} does not fit w {w.shape}")
        self._w = torch.from_numpy(w).to(self._dev)
        self._emb = torch.from_numpy(emb).to(self._dev)
        # Card-resident hidden states, one row per batch slot.
        self._dev_x = torch.zeros((MAX_BATCH, self._embed),
                                  dtype=torch.float32, device=self._dev)
        self._rows: List[Optional[Any]] = [None] * MAX_BATCH
        # Last dispatched dense step: (tokens on the card, [(row, slot)]).
        self._pending = None

        self._paged = GLOBAL_CONFIG.paged_kv if paged is None else paged
        self._spec_k = max(0, (GLOBAL_CONFIG.speculative_k
                               if speculative_k is None else speculative_k))
        self._use_kernel = use_kernel
        if self._paged:
            if wd is None:
                raise ValueError("paged mode needs the draft weights 'wd'")
            self._kv_engine = PagedKVEngine(
                kv_blocks, kv_block_size, tokens_for=self._tokens_for,
                prefix_caching=(GLOBAL_CONFIG.prefix_caching
                                if prefix_caching is None
                                else prefix_caching),
                max_slots=max_slots)
            # The batching decorator picks this attribute up and wires
            # block-gated admission into the continuous batcher.
            self.serve_kv_engine = self._kv_engine
            # One (block_size, 1, embed) page of value rows per block.
            self._kv_cache = torch.zeros(
                (kv_blocks, kv_block_size, 1, self._embed),
                dtype=torch.float32, device=self._dev)
            # _read_last's host staging buffer and zero queries, reused
            # across steps.
            self._stage_host: Optional[torch.Tensor] = None
            self._zero_q: Dict[int, torch.Tensor] = {}

    # -- paged-mode helpers -------------------------------------------------
    def _tokens_for(self, request) -> Any:
        """Admission sizing hook: (prompt token tuple, max new tokens)."""
        body = request or {}
        prompt = body.get("prompt", 0)
        if isinstance(prompt, (list, tuple)):
            ids = tuple(int(t) % self._vocab for t in prompt) or (0,)
        else:
            ids = (int(prompt) % self._vocab,)
        return ids, max(1, int(body.get("tokens", 1)))

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self._dev)

    # -- dense decode step --------------------------------------------------
    def _step(self, join_x: torch.Tensor, join_mask: torch.Tensor):
        x = torch.where(join_mask, join_x, self._dev_x)
        tok = torch.argmax(x @ self._w, dim=-1)   # first max on ties
        return tok, self._emb[tok]

    def _force_pending(self):
        """Force the previously dispatched step's tokens (card -> host),
        append them to their slots and finish slots that reached their
        requested length."""
        if self._pending is None:
            return
        tok_dev, rows = self._pending
        self._pending = None
        tok = tok_dev.cpu().numpy()
        for r, slot in rows:
            if slot.finished:
                continue  # speculative overshoot for a retired slot
            st = slot.state
            st["out"].append(int(tok[r]))
            if len(st["out"]) >= st["need"]:
                slot.finish(list(st["out"][:st["need"]]))

    # -- paged decode step --------------------------------------------------
    def _apply_cache_writes(self, cow_pairs, blocks, offs, vals):
        """Card updates for one phase: copy-on-write block copies FIRST
        (they preserve shared content before private writes land), then
        one indexed write of the new value rows."""
        if cow_pairs:
            olds = self._to_dev(np.asarray([o for o, _ in cow_pairs],
                                           np.int64))
            news = self._to_dev(np.asarray([n for _, n in cow_pairs],
                                           np.int64))
            self._kv_cache[news] = self._kv_cache[olds]
        if blocks:
            self._kv_cache[self._to_dev(np.asarray(blocks, np.int64)),
                           self._to_dev(np.asarray(offs, np.int64)), 0] = \
                self._to_dev(np.stack(vals))

    def _staging(self, n: int, width: int) -> torch.Tensor:
        """The first ``n * (1 + width)`` entries of a host int32 buffer for
        the context lengths and block tables, pinned on CUDA and kept
        between steps (sized for MAX_BATCH requests, grown with the
        table width)."""
        buf = self._stage_host
        if buf is None or buf.numel() < n * (1 + width):
            buf = torch.empty(max(n, MAX_BATCH) * (1 + width),
                              dtype=torch.int32)
            if self._dev.type == "cuda":
                buf = buf.pin_memory()
            self._stage_host = buf
        return buf[: n * (1 + width)]

    def _read_last(self, live):
        """Gather every live request's LAST value row back through the
        paged cache with K4 (``window=1``: softmax over one position is
        exactly 1.0, so the result is bitwise the stored row)."""
        eng = self._kv_engine
        n = len(live)
        tables = [eng.block_table(s) for s in live]
        width = max(len(t) for t in tables)
        # Context lengths, then the (n, width) tables, in one host buffer
        # and one copy.  It is rewritten on the next step only because
        # out.cpu() below synchronises the stream, so this step's copy has
        # read it by then.
        staged = self._staging(n, width)
        host = staged.numpy()
        host[:n] = [s.state["pos"] for s in live]
        bt = host[n:].reshape(n, width)
        bt.fill(0)
        for i, t in enumerate(tables):
            bt[i, : len(t)] = t
        dev = staged.to(self._dev, non_blocking=True)
        q = self._zero_q.get(n)
        if q is None:
            q = self._zero_q[n] = torch.zeros(
                (n, 1, self._embed), dtype=torch.float32, device=self._dev)
        fn = paged_attention if self._use_kernel \
            else paged_attention_reference
        out = fn(q, self._kv_cache, self._kv_cache,
                 dev[n:].view(n, width), dev[:n], window=1)
        return out[:, 0, :].cpu().numpy()

    def _paged_step(self, slots):
        """One iteration of the paged engine: prefill joiners into their
        blocks (skipping shared-prefix positions), read last rows via
        K4, draft + verify ``spec_k`` tokens in one batched forward, and
        retire the accepted prefix."""
        eng = self._kv_engine
        k = self._spec_k
        # Phase 1: join + prefill.  Positions [0, n_cached) are mapped
        # from the prefix cache and never rewritten.
        cow, wb, wo, wv = [], [], [], []
        joiners = []
        for s in slots:
            if s.state is not None:
                continue
            kvp = s.kv
            s.state = {"pos": len(kvp.prompt), "out": [],
                       "need": kvp.max_new, "last": kvp.prompt[-1]}
            lo = kvp.n_cached
            if lo < len(kvp.prompt):
                writes, cw = eng.plan_writes(s, lo, len(kvp.prompt) - lo)
                cow += cw
                for (blk, off), tok in zip(writes, kvp.prompt[lo:]):
                    wb.append(blk)
                    wo.append(off)
                    wv.append(self._emb_host[tok])
            joiners.append(s)
        self._apply_cache_writes(cow, wb, wo, wv)
        for s in joiners:
            # Publish AFTER the prefill writes: a prefix-cache entry must
            # never alias unwritten blocks.
            eng.register_prefix(s)
        live = [s for s in slots if not s.finished]
        if not live:
            return
        # Phase 2: last rows through the paged cache (bitwise gather).
        last = self._read_last(live)                       # (B, embed)
        # Phase 3: draft k tokens per request on the host (integer-exact),
        # then verify them all in ONE batched target forward: position j's
        # logits come from token j-1's value row.
        drafts = []
        for s in live:
            t = s.state["last"]
            chain = []
            for _ in range(k):
                t = int(np.argmax(self._emb_host[t] @ self._wd_host))
                chain.append(t)
            drafts.append(chain)
        verify = np.empty((len(live), k + 1, self._embed), np.float32)
        verify[:, 0, :] = last
        for i, chain in enumerate(drafts):
            for j, t in enumerate(chain):
                verify[i, j + 1] = self._emb_host[t]
        logits = self._to_dev(verify) @ self._w
        target = torch.argmax(logits, dim=-1).cpu().numpy()   # (B, k+1)
        # Phase 4: exact-match acceptance: the matching draft prefix plus
        # the target's correction token, i.e. the plain greedy chain.
        cow, wb, wo, wv = [], [], [], []
        for i, s in enumerate(live):
            st = s.state
            room = st["need"] - len(st["out"])
            usable = min(k, room - 1)
            m = 0
            while m < usable and drafts[i][m] == int(target[i, m]):
                m += 1
            emit = drafts[i][:m] + [int(target[i, m])]
            if k:
                eng.note_spec(usable, m)
            writes, cw = eng.plan_writes(s, st["pos"], len(emit))
            cow += cw
            for (blk, off), tok in zip(writes, emit):
                wb.append(blk)
                wo.append(off)
                wv.append(self._emb_host[tok])
            st["out"] += emit
            st["pos"] += len(emit)
            st["last"] = emit[-1]
            eng.note_tokens(len(emit))
            if len(st["out"]) >= st["need"]:
                s.finish(list(st["out"][: st["need"]]))
        self._apply_cache_writes(cow, wb, wo, wv)

    @batch(mode="continuous", max_batch_size=MAX_BATCH,
           batch_wait_timeout_s=0.002)
    def _decode(self, slots):
        # Paged dispatch needs the batcher to have wired the engine (slots
        # then carry SlotKV plans); with the paged_kv knob off admission
        # is dense and a paged=True instance falls back to the dense path.
        if self._paged and slots and slots[0].kv is not None:
            return self._paged_step(slots)
        # Retired slots free their rows at the boundary.
        for r, s in enumerate(self._rows):
            if s is not None and s.finished:
                self._rows[r] = None
        join_x = np.zeros((MAX_BATCH, self._embed), np.float32)
        join_mask = np.zeros((MAX_BATCH, 1), np.bool_)
        for s in slots:
            if s.state is None:
                body = s.request or {}
                prompt = body.get("prompt", 0)
                if isinstance(prompt, (list, tuple)):
                    prompt = prompt[-1] if prompt else 0
                s.state = {"row": None, "out": [],
                           "need": max(1, int(body.get("tokens", 1))),
                           "prompt": int(prompt) % self._vocab}
            if s.state["row"] is None:
                r = self._rows.index(None)  # capacity == max_batch_size
                self._rows[r] = s
                s.state["row"] = r
                join_x[r] = self._emb_host[s.state["prompt"]]
                join_mask[r] = True
        # 1. Joiners' hidden states go up before the previous step's
        #    tokens are forced.
        dev_join, dev_mask = self._to_dev(join_x), self._to_dev(join_mask)
        # 2. Previous step's tokens.
        self._force_pending()
        # 3. Dispatch this step; its tokens are forced on the NEXT call.
        live = [(r, s) for r, s in enumerate(self._rows)
                if s is not None and not s.finished]
        if live:
            tok, self._dev_x = self._step(dev_join, dev_mask)
            self._pending = (tok, live)

    def __call__(self, body: Dict[str, Any]) -> List[int]:
        return self._decode(body)

    # -- disaggregated serving: a later slice -------------------------------
    def prefill_export(self, body, ingest=None):
        raise NotImplementedError(
            "disaggregated prefill needs the object plane, not ported yet "
            "(ROADMAP.md Queue 1)")

    def disagg_generate(self, body, prefill=None, pool: str = ""):
        raise NotImplementedError(
            "disaggregated decode needs the object plane, not ported yet "
            "(ROADMAP.md Queue 1)")

    # -- host-side reference (tests pin numerics against this) -------------
    def reference_decode(self, prompt, tokens: int) -> List[int]:
        """Plain sequential greedy decode on the host — exact-integer
        arithmetic makes it bitwise comparable to the card's chain.
        ``prompt`` may be an id or a token list (decode continues from
        the LAST prompt token)."""
        if isinstance(prompt, (list, tuple)):
            prompt = prompt[-1] if prompt else 0
        x = self._emb_host[int(prompt) % self._vocab]
        out = []
        for _ in range(tokens):
            t = int(np.argmax(x @ self._w_host))
            out.append(t)
            x = self._emb_host[t]
        return out

"""Device-resident greedy decode replica on CUDA cards (counterpart:
``ray_tpu/serve/tpu_replica.py``).

The same deployment the reference serves.  Where the reference shards
the projection ``w`` by columns over a 1-D ``"model"`` mesh of every
visible device, this replica keeps one column block of ``w`` on each
device of its list (``device=None``: every visible card; a list may
repeat a device, e.g. ``["cpu"] * 8``), from one process and with no
process group.  The first device is the primary: it holds the embedding
table, the hidden rows, the paged cache and K4's launches, as the
reference replicates them.  Drawn weights pad the vocab to a multiple of
the shard count, as the reference does.  Each step's rows go to every
block's device, each block gives its max and first argmax, and the
primary picks the first block that holds the global max.

Weights are integer-valued float32, so every matmul below float32's 2^24
integer window is exact and the decoded chains are bitwise comparable
with ``reference_decode``, a plain host loop.  Greedy picks take the
FIRST maximum (``torch.argmax``, like ``jnp.argmax`` and ``np.argmax``),
across blocks too: integer logits tie often.

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

Disaggregated serving (``disaggregated_serving`` knob): the same class
serves both halves of a split tier, as in the reference.  A prefill
replica admits a request tagged ``_prefill_only``: its prompt blocks are
written, the chain registered, and the slot finishes in the same step
with a pinned ``ChainExport``.  ``prefill_export`` gathers the chain's
pages from the card in one indexed read and one copy to the host, and
``_stream_chain`` lands them (numpy) in the decode replica's node store
over the copied object plane (``put_local`` on the same node, the pusher
to a peer store, an ``("inline", payload)`` descriptor when neither is
reachable).  A decode replica (``disagg_generate``) opens the chain and
adopts it: the join writes the exported page rows, not recomputed
embeddings, into normally admitted blocks, so the decoded chain stays
bitwise the monolithic one.

Request format: ``{"prompt": int | [int, ...], "tokens": int}`` -> list of
``tokens`` greedily decoded ids (the dense path continues from the LAST
prompt token).  A request carrying ``"_timing": True`` (and a client
``"_t0"`` wall clock) finishes with ``{"tokens": [...], "ttft":
seconds}`` instead: the time-to-first-token probe.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private import segment_stream
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.device import resolve_devices
from ray_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.kv_cache import ChainExport, PagedKVEngine

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
    ``_emb_host`` / ``_wd_host``, whose vocab must divide over the
    shards; without it integer weights are drawn from ``seed``.
    ``device`` is one device or a list of them, one projection shard
    each (``resolve_devices``); it defaults to every visible card."""

    def __init__(self, embed: int = 32, vocab: int = 64, seed: int = 0,
                 paged: Optional[bool] = None, kv_blocks: int = 32,
                 kv_block_size: int = 8, max_slots: int = 16,
                 speculative_k: Optional[int] = None,
                 prefix_caching: Optional[bool] = None,
                 use_kernel: bool = True,
                 weights: Optional[Dict[str, Any]] = None,
                 device=None, prefill_ms_per_token: float = 0.0):
        # The shards' devices (the reference's mesh); the first is the
        # primary.
        self._devices = resolve_devices(device)
        self._dev = self._devices[0]
        n = len(self._devices)
        if weights is None:
            vocab = -(-vocab // n) * n           # divisible over the shards
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
        if self._vocab % n:
            raise ValueError(f"vocab {self._vocab} does not divide over "
                             f"{n} shards")
        # Column block k of the projection on device k.
        cols = self._vocab // n
        self._w = [torch.from_numpy(np.ascontiguousarray(
            w[:, k * cols:(k + 1) * cols])).to(d)
            for k, d in enumerate(self._devices)]
        self._emb = torch.from_numpy(emb).to(self._dev)
        # Card-resident hidden states, one row per batch slot.
        self._dev_x = torch.zeros((MAX_BATCH, self._embed),
                                  dtype=torch.float32, device=self._dev)
        self._rows: List[Optional[Any]] = [None] * MAX_BATCH
        # Last dispatched dense step: (tokens on the card, [(row, slot)]).
        self._pending = None
        # Synthetic prefill cost (ms per prompt token written by
        # recomputed prefill; imported chains paid theirs on the prefill
        # replica).  0 = off.
        self._prefill_ms = max(0.0, float(prefill_ms_per_token))
        # Control-plane state (set_serve_role, kv_ingest_info, kv_debug)
        # and the handoff's fallback/retry counters.
        self._serve_role: Optional[str] = None
        self._ingest_info: Optional[Dict[str, Any]] = None
        self._chain_stats = {"inline_fallbacks": 0, "handoff_retries": 0}
        self._chain_lock = threading.Lock()  # lock-order: leaf

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
        """Admission sizing hook: (prompt token tuple, max new tokens).
        Prefill-only requests (the disaggregated handoff) reserve zero
        decode tokens: their slot finishes in its own join step."""
        body = request or {}
        prompt = body.get("prompt", 0)
        if isinstance(prompt, (list, tuple)):
            ids = tuple(int(t) % self._vocab for t in prompt) or (0,)
        else:
            ids = (int(prompt) % self._vocab,)
        if body.get("_prefill_only"):
            return ids, 0
        return ids, max(1, int(body.get("tokens", 1)))

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self._dev)

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        """Greedy pick over the vocab of ``x @ w`` for rows ``x`` on the
        primary, with ``w`` in column blocks: each block's max and first
        argmax on its device, then on the primary the first block whose
        max is the global max (``jnp.argmax``'s first-maximum rule across
        the blocks).  The result stays on the primary: no host sync."""
        if len(self._w) == 1:
            return torch.argmax(x @ self._w[0], dim=-1)
        vals, idxs = [], []
        for w in self._w:
            logits = x.to(w.device, non_blocking=True) @ w
            i = torch.argmax(logits, dim=-1, keepdim=True)
            vals.append(logits.gather(-1, i).to(self._dev))
            idxs.append(i.to(self._dev))
        vals, idxs = torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)
        block = torch.argmax(vals, dim=-1, keepdim=True)
        cols = self._w[0].shape[1]
        return (block * cols + idxs.gather(-1, block)).squeeze(-1)

    # -- dense decode step --------------------------------------------------
    def _step(self, join_x: torch.Tensor, join_mask: torch.Tensor):
        x = torch.where(join_mask, join_x, self._dev_x)
        tok = self._project(x)                    # first max on ties
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
        n_prefill_toks = 0
        for s in slots:
            if s.state is not None:
                continue
            kvp = s.kv
            imp = (s.request or {}).get("_import")
            s.state = {"pos": len(kvp.prompt), "out": [],
                       "need": kvp.max_new,
                       "last": (int(imp["last"]) if imp is not None
                                else kvp.prompt[-1])}
            lo = kvp.n_cached
            if lo < len(kvp.prompt):
                writes, cw = eng.plan_writes(s, lo, len(kvp.prompt) - lo)
                cow += cw
                if imp is not None:
                    # Streamed-chain adoption: the value rows come from
                    # the prefill replica's exported pages, not from
                    # recomputed embeddings.
                    pages, sbs = imp["pages"], int(imp["src_bs"])
                    for (blk, off), p in zip(
                            writes, range(lo, len(kvp.prompt))):
                        wb.append(blk)
                        wo.append(off)
                        wv.append(pages[p // sbs, p % sbs, 0])
                    eng.note_chain_imported()
                else:
                    for (blk, off), tok in zip(writes, kvp.prompt[lo:]):
                        wb.append(blk)
                        wo.append(off)
                        wv.append(self._emb_host[tok])
                    n_prefill_toks += len(kvp.prompt) - lo
            joiners.append(s)
        if n_prefill_toks and self._prefill_ms:
            # Synthetic prefill compute: the whole step stalls behind it.
            time.sleep(self._prefill_ms * n_prefill_toks / 1000.0)
        self._apply_cache_writes(cow, wb, wo, wv)
        for s in joiners:
            # Publish AFTER the prefill writes: a prefix-cache entry must
            # never alias unwritten blocks.
            eng.register_prefix(s)
            if (s.request or {}).get("_prefill_only") and not s.finished:
                # A prefill-only slot finishes now with its chain pinned
                # for streaming: prefill replicas run prompt-only steps.
                s.finish(eng.export_chain(s))
        live = [s for s in slots if not s.finished]
        if not live:
            return
        # Phase 2: last rows through the paged cache (bitwise gather).
        last = self._read_last(live)                       # (B, embed)
        # Phase 3: draft k tokens per request on the host (integer-exact),
        # then verify them all in ONE batched target forward: position j's
        # logits come from token j-1's value row; target is (B, k+1).
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
        target = self._project(self._to_dev(verify)).cpu().numpy()
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
            timing = (s.request or {}).get("_timing")
            if not st["out"] and timing:
                st["t_first"] = time.time()
            st["out"] += emit
            st["pos"] += len(emit)
            st["last"] = emit[-1]
            eng.note_tokens(len(emit))
            if len(st["out"]) >= st["need"]:
                toks = list(st["out"][: st["need"]])
                if timing:
                    t0 = float(s.request.get("_t0", st["t_first"]))
                    s.finish({"tokens": toks, "ttft": st["t_first"] - t0})
                else:
                    s.finish(toks)
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

    # -- control plane ------------------------------------------------------
    def set_serve_role(self, role: Optional[str]) -> None:
        """Pool tag from the controller (``ReplicaWrapper`` calls this
        at replica construction): ``"prefill"`` / ``"decode"`` / None
        (monolithic)."""
        self._serve_role = role

    def kv_ingest_info(self) -> Optional[Dict[str, Any]]:
        """Where prefill replicas should stream chains for THIS
        replica: the node store id.  None outside a runtime (plain-process
        tests)."""
        with self._chain_lock:
            if self._ingest_info is not None:
                return dict(self._ingest_info)
        try:
            from ray_tpu_torch._private import api_internal

            rt = api_internal.require_runtime()
            info = {"store": rt.store_id}
        except Exception:
            return None
        with self._chain_lock:
            self._ingest_info = info
            return dict(info)

    def kv_debug(self) -> Dict[str, Any]:
        """Allocator + handoff gauges for tests: live block count,
        unreleased exports, and the fallback/retry bookkeeping."""
        with self._chain_lock:
            chain = dict(self._chain_stats)
        eng = getattr(self, "_kv_engine", None)
        if eng is None:
            return {"paged": False, "role": self._serve_role,
                    "chain": chain}
        with eng._guard:
            st = eng.stats_locked()
        st.update({"paged": True, "role": self._serve_role,
                   "used": eng.allocator.used,
                   "available": eng.allocator.available,
                   "exports_outstanding": eng.exports_outstanding,
                   "chain": chain})
        return st

    # -- disaggregated serving: the streamed-chain handoff -----------------
    def prefill_export(self, body: Dict[str, Any],
                       ingest: Optional[Dict[str, Any]] = None) -> tuple:
        """Prompt-only admission of ``body`` on this (prefill) replica,
        then the chain handoff: the chain's pages and its table metadata
        laid out as one segment image and streamed into ``ingest``'s node
        store, or an inline descriptor when no put path is reachable.
        Returns ``(block_chain_descr, sampler_state)``."""
        if not self._paged:
            raise RuntimeError(
                "disaggregated prefill requires the paged KV engine "
                "(paged_kv knob)")
        exp = self._decode({**(body or {}), "_prefill_only": True})
        if not isinstance(exp, ChainExport):
            raise RuntimeError(
                f"prefill produced no chain (got {type(exp).__name__}: "
                "paged admission not wired?)")
        eng = self._kv_engine
        try:
            # One indexed read of the chain's blocks and one copy to the
            # host: the pages cross the object plane as numpy.
            idx = torch.as_tensor(exp.blocks, dtype=torch.int64,
                                  device=self._dev)
            pages = self._kv_cache[idx].cpu().numpy()
            sampler = {"last": int(exp.prompt[-1]),
                       "pos": len(exp.prompt)}
            payload = {"src_bs": eng.block_size,
                       "n_tokens": len(exp.prompt),
                       "pages": pages, **sampler}
            descr = self._stream_chain(payload, ingest)
            if descr[0] == "inline":
                with self._chain_lock:
                    self._chain_stats["inline_fallbacks"] += 1
            else:
                eng.note_chain_streamed(int(descr[2]))
            return descr, sampler
        finally:
            eng.release_export(exp)

    def _stream_chain(self, payload: Dict[str, Any],
                      ingest: Optional[Dict[str, Any]]) -> tuple:
        """Land one chain image in the ingest store.  Returns the
        descriptor ``_open_chain`` takes: ``(kind, ident, total)`` for a
        committed segment in the decode replica's node store (kind
        ``"shm"`` or ``"spilled"``; ``put_local`` on the same node, the
        pusher to a peer), or ``("inline", payload)`` when no put path is
        reachable (no runtime, or a peer without the put verbs): the
        reference's own protocol."""
        descr = segment_stream.land(payload, (ingest or {}).get("store"))
        return ("inline", payload) if descr is None else descr

    def _open_chain(self, descr: tuple) -> Dict[str, Any]:
        """Adopt a streamed chain on this (decode) replica: attach the
        committed segment in the local node store, copy the pages out,
        and free the segment (``unlink`` returns the node byte
        accounting that the put charged).  Inline descriptors
        short-cut."""
        if descr[0] == "inline":
            payload = dict(descr[1])
            payload["pages"] = np.asarray(payload["pages"])
            return payload
        # The deserialized pages alias the mapping: copy them out before
        # the segment goes away.
        return segment_stream.take(descr, lambda p: dict(
            p, pages=np.array(p["pages"], copy=True)))

    def disagg_generate(self, body: Dict[str, Any], prefill=None,
                        pool: str = "") -> Any:
        """Decode-side orchestration of one disaggregated request:
        prefill on the routed prefill replica, stream the chain here,
        adopt it and decode locally.  A dead or failing prefill replica
        is retried once against the pool's current membership (from the
        controller's ``handle_snapshot``), counted in
        ``handoff_retries``."""
        import ray_tpu_torch as ray

        ingest = self.kv_ingest_info()
        handoff = None
        last_err: Optional[BaseException] = None
        cands = [prefill] if prefill is not None else []
        for attempt in range(2):
            for actor in cands:
                try:
                    handoff = ray.get(actor.call_method.remote(
                        "prefill_export", (body, ingest), {}))
                    break
                except Exception as e:  # noqa: BLE001 -- retried below
                    last_err = e
            if handoff is not None or not pool or attempt:
                break
            # Membership may have changed under us (a killed replica):
            # re-fetch the prefill pool and re-prefill on a live one.
            try:
                from ray_tpu_torch.serve.api import CONTROLLER_NAME

                ctrl = ray.get_actor(CONTROLLER_NAME)
                _, reps, _ = ray.get(ctrl.handle_snapshot.remote(pool))
                cands = list(reps)
                with self._chain_lock:
                    self._chain_stats["handoff_retries"] += 1
            except Exception as e:  # noqa: BLE001 -- surfaced below
                last_err = e
                break
        if handoff is None:
            raise RuntimeError(
                f"disaggregated prefill failed: {last_err!r}")
        descr, _sampler = handoff
        imp = self._open_chain(descr)
        return self._decode({**(body or {}), "_import": imp})

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

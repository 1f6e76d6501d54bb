"""Host-side serving memory plane: block allocator, prefix cache, and
the paged-KV admission engine for the continuous batcher.

A copy of ``ray_tpu/serve/kv_cache.py`` for the PyTorch port (the port
imports nothing of ``ray_tpu``).

Reference: vLLM's PagedAttention block manager (SOSP'23).  Device KV
memory is carved into fixed-size blocks; every live request owns a
*block table* (its ordered list of physical block ids) instead of a
``max_seq_len`` reservation, so a replica's admission capacity is
bounded by tokens actually resident, not by the worst-case sequence
length.  Three cooperating pieces:

``BlockAllocator``
    A free-list of physical block ids with per-block refcounts.
    ``alloc`` is all-or-nothing (admission either fully fits or parks);
    a block returns to the free list when its last reference drops.

``PrefixCache``
    Prompt-prefix hash -> block-chain map with refcounts: N requests
    sharing a system prompt map the SAME physical blocks.  Entries are
    registered only AFTER the owning request's prefill materialized the
    block contents (an entry must never point at unfilled blocks), keyed
    at every block boundary of the prompt plus its full length so a
    longer prompt can reuse a shorter prompt's chain.  Entries hold
    their own references; LRU entries are reclaimed when admission runs
    dry.  Divergence inside a shared partial block is handled by
    copy-on-write: the uniform rule is "a write into a block with
    refcount > 1 moves to a fresh copy" (``plan_writes``), which is
    sound because canonical prefill always lands in refcount-1 blocks.

``PagedKVEngine``
    Glues both into the ``_ContinuousBatcher`` admission path and keeps
    the serving-memory counters (prefix_hits / prefix_blocks_shared /
    cow_copies / spec_proposed / spec_accepted / tokens_emitted /
    admission_parks).

LOCK ORDER: the engine is EXTERNALLY SYNCHRONIZED by the batcher's
documented leaf lock.  ``*_locked`` methods assume the caller (the
batcher's admission/retire/stats paths) already holds it; the public
step-side methods (``plan_writes`` / ``register_prefix`` /
``note_tokens`` / ``note_spec``) acquire the SAME lock via ``bind()``.
The engine never creates a lock of its own and never calls out while
the guard is held, so the batcher lock keeps its zero-outgoing-edge
leaf pin (the reference's copy: tests/test_lockcheck.py).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple


class RequestTooLarge(ValueError):
    """A request's whole block budget exceeds the TOTAL pool: it could
    never be admitted even against an empty cache, so parking it would
    wedge the FIFO queue head forever.  Raised to the submitting caller;
    the batcher keeps draining the requests behind it."""


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size KV blocks.

    Externally synchronized (see module docstring).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("num_blocks and block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: recently freed blocks are re-used first (their
        # device pages are the warmest).
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.num_blocks - len(self._free)

    def ref(self, block: int) -> int:
        return self._ref[block]

    def alloc(self, n: int) -> Optional[List[int]]:
        """All-or-nothing: ``n`` fresh blocks (refcount 1) or ``None``."""
        if n < 0:
            raise ValueError("negative block request")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise ValueError(f"incref of free block {block}")
        self._ref[block] += 1

    def free(self, blocks) -> None:
        """Drop one reference per block; refcount 0 returns it to the
        free list."""
        for b in blocks:
            r = self._ref[b] - 1
            if r < 0:
                raise ValueError(f"double free of block {b}")
            self._ref[b] = r
            if r == 0:
                self._free.append(b)


class _PrefixEntry:
    __slots__ = ("blocks", "n_tokens")

    def __init__(self, blocks: Tuple[int, ...], n_tokens: int):
        self.blocks = blocks
        self.n_tokens = n_tokens


class PrefixCache:
    """Prompt-prefix -> block-chain map (see module docstring).

    Keys are the prefix token tuples themselves (python hashing); an
    entry covering ``L`` tokens holds ``ceil(L / block_size)`` block
    references, the last block possibly partial.
    """

    def __init__(self, allocator: BlockAllocator):
        self._alloc = allocator
        self._entries: "OrderedDict[tuple, _PrefixEntry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt: Tuple[int, ...]) -> Tuple[List[int], int]:
        """Longest cached prefix of ``prompt``: ``(blocks, n_tokens)``
        with references ALREADY taken on the returned blocks (the
        caller's admission owns them), or ``([], 0)``."""
        bs = self._alloc.block_size
        n = len(prompt)
        # Candidate lengths, longest first: the full prompt, then every
        # block boundary below it (registration inserts exactly these
        # forms, plus foreign prompts' full lengths — probed implicitly
        # when they sit at our boundaries; a non-boundary foreign match
        # is found via the full-prompt probe of ITS length only when
        # lengths coincide, which is fine: boundary-granular reuse is
        # the contract, the full-length probe is opportunistic).
        cands = [n] + list(range((n // bs) * bs - (0 if n % bs else bs),
                                 0, -bs))
        for L in cands:
            e = self._entries.get(tuple(prompt[:L]))
            if e is None:
                continue
            self._entries.move_to_end(tuple(prompt[:L]))
            for b in e.blocks:
                self._alloc.incref(b)
            return list(e.blocks), e.n_tokens
        return [], 0

    def insert(self, prompt: Tuple[int, ...], blocks: List[int]) -> int:
        """Register the (already prefilled) chain for ``prompt`` under
        its full length and every block boundary.  Existing keys are
        kept (first writer wins — identical prefix tokens imply
        identical block contents).  Returns entries added."""
        bs = self._alloc.block_size
        n = len(prompt)
        added = 0
        lengths = list(range(bs, n + 1, bs))
        if not lengths or lengths[-1] != n:
            lengths.append(n)
        for L in lengths:
            key = tuple(prompt[:L])
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            chain = tuple(blocks[: -(-L // bs)])
            for b in chain:
                self._alloc.incref(b)
            self._entries[key] = _PrefixEntry(chain, L)
            added += 1
        return added

    def reclaim(self, need: int) -> int:
        """Drop LRU entries (releasing their block references) until the
        allocator can satisfy ``need`` free blocks or the cache is
        empty.  Returns entries dropped."""
        dropped = 0
        while self._alloc.available < need and self._entries:
            _, e = self._entries.popitem(last=False)
            self._alloc.free(e.blocks)
            dropped += 1
        return dropped

    def clear(self) -> None:
        while self._entries:
            _, e = self._entries.popitem(last=False)
            self._alloc.free(e.blocks)


class SlotKV:
    """Per-admitted-request paged-memory plan, attached as ``slot.kv``."""

    __slots__ = ("blocks", "prompt", "max_new", "n_cached", "spares",
                 "registered", "freed")

    def __init__(self, blocks: List[int], prompt: Tuple[int, ...],
                 max_new: int, n_cached: int,
                 spares: Optional[List[int]] = None):
        self.blocks = blocks          # physical chain, mutated by CoW
        self.prompt = prompt
        self.max_new = max_new
        self.n_cached = n_cached      # positions [0, n_cached) shared
        # Copy-on-write reserve, allocated WITH the admission budget so
        # a divergence inside a shared partial block can never fail
        # mid-decode (the pool may be fully committed to other slots).
        self.spares = spares or []
        self.registered = False
        self.freed = False


class ChainExport:
    """A finished prefill's block chain pinned for streaming.

    Created by ``PagedKVEngine.export_chain`` AT retirement time on the
    prefill side of a disaggregated tier: the export takes its OWN
    reference on every prompt block (shared-prefix blocks export by
    reference-into-the-chain — no copy, the incref alone keeps them),
    so the chain's device pages stay immutable while the pusher streams
    them even after the slot itself retires.  Copy-on-write preserves
    the content guarantee: any later writer into one of these blocks
    sees refcount > 1 and diverges to a fresh copy, never mutating the
    exported pages.  ``release_export`` drops the references
    (idempotent — the streaming path releases in a ``finally`` and the
    chaos path may release again on teardown).
    """

    __slots__ = ("blocks", "prompt", "released")

    def __init__(self, blocks: Tuple[int, ...], prompt: Tuple[int, ...]):
        self.blocks = blocks
        self.prompt = prompt
        self.released = False


class PagedKVEngine:
    """Admission gate + memory accounting for one paged batcher.

    ``tokens_for(request) -> (prompt_tokens, max_new_tokens)`` is the
    deployment's sizing hook: admission reserves
    ``ceil((len(prompt) + max_new + spec_slack) / block_size)`` blocks
    up front (alloc on admit / free on retire — a mid-decode request can
    therefore never run out), counting cached prefix blocks as free
    reuse, plus one copy-on-write reserve block whenever prefix caching
    is on.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 tokens_for: Callable[[Any], Tuple[tuple, int]],
                 prefix_caching: bool = True,
                 max_slots: Optional[int] = None,
                 spec_slack: int = 0):
        self.allocator = BlockAllocator(num_blocks, block_size)
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.allocator) if prefix_caching else None)
        self._tokens_for = tokens_for
        self.block_size = block_size
        self.spec_slack = max(0, int(spec_slack))
        # Hard cap on live slots; blocks are the real bound, this keeps
        # padded device batches sane.
        self.max_slots = max_slots if max_slots else num_blocks
        # Guard: REPLACED by the owning batcher's leaf lock at bind().
        self._guard = threading.Lock()  # lock-order: leaf
        # Counters (mutated under the guard; int reads are GIL-atomic).
        self.prefix_hits = 0
        self.prefix_blocks_shared = 0
        self.cow_copies = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.tokens_emitted = 0
        self.admission_parks = 0
        self.admission_rejects = 0
        # Disaggregation counters: chains exported/imported by THIS
        # engine plus the bytes its exports streamed over the put path.
        # All three stay zero when disaggregated_serving is off (the
        # export/import verbs are only driven by the split tier).
        self.kv_chains_exported = 0
        self.kv_chains_imported = 0
        self.kv_chain_bytes_streamed = 0
        # Live (unreleased) ChainExports — the chaos tests' leak gauge.
        self.exports_outstanding = 0
        # Park EPISODES, not boundary re-checks: the continuous loop
        # re-tries the parked queue head every boundary, and counting
        # each retry would inflate the counter by ~steps-parked.
        self._last_parked: Any = None

    # -- batcher-side (caller holds the batcher leaf lock) ----------------
    def bind(self, lock) -> None:
        """Adopt the owning batcher's leaf lock as the step-side guard:
        one lock then covers admission, retirement, and step-side write
        planning — the 'admission re-checks availability under the
        batcher leaf lock' convention."""
        self._guard = lock

    def try_admit_locked(self, slot) -> bool:
        """Reserve the request's whole block budget.  On exhaustion,
        reclaim idle prefix-cache entries; if still short, PARK (return
        False).  The one exception: a budget larger than the TOTAL pool
        can never fit and raises ``RequestTooLarge`` (parking it would
        wedge the FIFO head forever)."""
        prompt, max_new = self._tokens_for(slot.request)
        prompt = tuple(prompt)
        total = len(prompt) + max_new + self.spec_slack
        n_blocks = -(-max(1, total) // self.block_size)
        # Worst-case FRESH need across cache states: no hit costs
        # n_blocks (+1 spare for a partial prompt block); a mid-block
        # hit adds the second spare but always offsets it with >= 1
        # shared (non-allocated) block.  If even a fully drained pool
        # could not hold that, fail fast to the caller.
        worst = n_blocks + (1 if self.prefix is not None
                            and len(prompt) % self.block_size else 0)
        if worst > self.allocator.num_blocks:
            self.admission_rejects += 1
            raise RequestTooLarge(
                f"request needs {worst} KV blocks "
                f"({total} tokens @ block_size={self.block_size}) but "
                f"the pool holds {self.allocator.num_blocks}")
        shared: List[int] = []
        n_cached = 0
        if self.prefix is not None:
            shared, n_cached = self.prefix.lookup(prompt)
        # Slot-owned CoW reserve: one spare per potential divergence —
        # the prefill write into a shared PARTIAL prefix block, and the
        # first generated-token write into the slot's own partial
        # prompt block after registration re-shares it.  Reserved with
        # the admission budget (the pool may be fully committed to
        # other slots by the time the write happens) so plan_writes is
        # failure-free mid-decode.
        bs = self.block_size
        n_spares = 0
        if self.prefix is not None:
            if n_cached % bs and n_cached < len(prompt):
                n_spares += 1
            if len(prompt) % bs:
                n_spares += 1
        n_fresh = n_blocks - len(shared)
        need = n_fresh + n_spares
        if self.allocator.available < need and self.prefix is not None:
            self.prefix.reclaim(need)
        fresh = self.allocator.alloc(need)
        if fresh is None:
            if shared:
                self.allocator.free(shared)
            if slot is not self._last_parked:
                self.admission_parks += 1
                self._last_parked = slot
            return False
        self._last_parked = None
        if shared:
            self.prefix_hits += 1
            self.prefix_blocks_shared += len(shared)
        slot.kv = SlotKV(shared + fresh[:n_fresh], prompt, max_new,
                         n_cached, spares=fresh[n_fresh:])
        return True

    def retire_locked(self, slot) -> None:
        kv = getattr(slot, "kv", None)
        if kv is None or kv.freed:
            return
        kv.freed = True
        self.allocator.free(kv.blocks)
        if kv.spares:
            self.allocator.free(kv.spares)

    def stats_locked(self) -> Dict[str, Any]:
        total = self.allocator.num_blocks
        used = self.allocator.used
        return {
            "kv_blocks_total": total,
            "kv_blocks_used": used,
            "kv_occupancy": round(used / total, 3) if total else 0.0,
            "prefix_hits": self.prefix_hits,
            "prefix_blocks_shared": self.prefix_blocks_shared,
            "cow_copies": self.cow_copies,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "tokens_emitted": self.tokens_emitted,
            "admission_parks": self.admission_parks,
            "admission_rejects": self.admission_rejects,
            "kv_chains_exported": self.kv_chains_exported,
            "kv_chains_imported": self.kv_chains_imported,
            "kv_chain_bytes_streamed": self.kv_chain_bytes_streamed,
        }

    # -- step-side (called from the step function, no lock held) ----------
    def plan_writes(self, slot, start: int,
                    count: int) -> Tuple[List[Tuple[int, int]],
                                         List[Tuple[int, int]]]:
        """Physical ``(block, offset)`` targets for token positions
        ``[start, start + count)`` of this slot, applying copy-on-write:
        a target block with refcount > 1 (shared through the prefix
        cache) is swapped for a fresh block first.  Returns
        ``(writes, cow_pairs)``; for every ``(old, new)`` in
        ``cow_pairs`` the caller must copy the device block old -> new
        BEFORE issuing the writes."""
        bs = self.block_size
        with self._guard:
            kv = slot.kv
            writes: List[Tuple[int, int]] = []
            cow: List[Tuple[int, int]] = []
            for p in range(start, start + count):
                j = p // bs
                blk = kv.blocks[j]
                if self.allocator.ref(blk) > 1:
                    if kv.spares:
                        new = kv.spares.pop()
                    else:
                        # Admission reserves one spare per potential
                        # divergence, so this fallback is only for
                        # engines driven outside that contract.
                        repl = self.allocator.alloc(1)
                        if repl is None:
                            raise MemoryError(
                                "paged KV: copy-on-write with no free "
                                "block (admission reserve accounting "
                                "bug)")
                        new = repl[0]
                    self.allocator.free([blk])
                    kv.blocks[j] = new
                    cow.append((blk, new))
                    self.cow_copies += 1
                    blk = new
                writes.append((blk, p % bs))
            return writes, cow

    def block_table(self, slot) -> List[int]:
        with self._guard:
            return list(slot.kv.blocks)

    def register_prefix(self, slot) -> None:
        """Publish this slot's (fully prefilled) prompt chain into the
        prefix cache.  Call AFTER the prefill writes landed on device —
        an entry must never alias unwritten blocks."""
        if self.prefix is None:
            return
        with self._guard:
            kv = slot.kv
            if kv.registered or not kv.prompt or kv.freed:
                return
            kv.registered = True
            self.prefix.insert(kv.prompt, kv.blocks)

    # -- disaggregated chain handoff (step-side, no lock held) ------------
    def export_chain(self, slot) -> Optional[ChainExport]:
        """Pin this slot's prompt block chain for streaming to a decode
        replica.  Takes one export-owned reference per prompt block, so
        the chain survives the slot's retirement (retire frees the
        SLOT's references; the export's keep the pages resident and,
        via the CoW rule, immutable).  Returns ``None`` when the slot
        has no live paged state.  Call after the prefill writes landed
        (same ordering contract as ``register_prefix``)."""
        with self._guard:
            kv = getattr(slot, "kv", None)
            if kv is None or kv.freed or not kv.prompt:
                return None
            chain = tuple(kv.blocks[: -(-len(kv.prompt)
                                        // self.block_size)])
            for b in chain:
                self.allocator.incref(b)
            self.kv_chains_exported += 1
            self.exports_outstanding += 1
            return ChainExport(chain, kv.prompt)

    def release_export(self, exp: Optional[ChainExport]) -> None:
        """Drop an export's block references (idempotent)."""
        if exp is None:
            return
        with self._guard:
            if exp.released:
                return
            exp.released = True
            self.exports_outstanding -= 1
            self.allocator.free(exp.blocks)

    def note_chain_streamed(self, nbytes: int) -> None:
        """Account one export's segment image leaving this replica."""
        with self._guard:
            self.kv_chain_bytes_streamed += nbytes

    def note_chain_imported(self) -> None:
        """Account one streamed chain adopted under THIS allocator (the
        decode-side join path wrote its pages into normally-admitted
        blocks, so ownership/CoW rules apply unchanged)."""
        with self._guard:
            self.kv_chains_imported += 1

    def note_tokens(self, n: int) -> None:
        with self._guard:
            self.tokens_emitted += n

    def note_spec(self, proposed: int, accepted: int) -> None:
        with self._guard:
            self.spec_proposed += proposed
            self.spec_accepted += accepted

"""Content-addressed KV block cache: the bookkeeping half of automatic
prefix caching.

:class:`BlockCache` maps the HASH CHAIN of a prompt's full
``block_size``-token blocks to cached KV payloads. Key ``i`` is
``blake2b(key_{i-1} || tokens[i*bs:(i+1)*bs])`` seeded with the
engine's live ``weights_version`` — so two prompts sharing a head share
cache entries automatically (no registration), a hash describes the
ENTIRE token prefix up to its block (never just the block's own
tokens), and a weight hot-swap invalidates every cached block BY
CONSTRUCTION: post-swap chains hash differently, old-version entries
simply stop matching and age out of the LRU. This is the
content-addressed core of vLLM's automatic prefix caching /
SGLang's RadixAttention, with the chain flattened into per-block keys
instead of a radix tree (a chain walk IS the radix descent for
fixed-size blocks).

The payload is opaque to the cache. The paged
:class:`~elephas_tpu.serving_engine.DecodeEngine` stores POOL BLOCK IDS
(a hit installs table pointers — zero copy, zero recompute — so entries
are REFCOUNTED while any slot's block table points at them, and parked
on an LRU free list when unreferenced: pool pressure reclaims cold
prefixes instead of failing admission). The host-mode cache (contiguous
engines, disaggregated prefill workers) stores host numpy block arrays
— a hit pays one host-to-device copy instead of the prefix's prefill
FLOPs — and uses plain LRU capacity eviction (host arrays are copied
out, so there is nothing to refcount).

Only FULL blocks are ever cached: the partial tail block of a prompt —
and every block past it — is written by decode, so it is private to its
request; full prompt blocks are read-only after prefill (decode's first
write lands at position ``prompt_len``, past every full block), which
is why sharing them needs no copy-on-write. The same argument covers
SPECULATIVE serving: the verify pass's writes (including rejected
positions, up to ``gamma`` past the emitted sequence) all land at or
beyond ``prompt_len``, so the TARGET model's KV is cached exactly as
in plain mode — draft KV is never cached at all (it is proposer-
private, recomputed at admission), so no key ever involves the draft
or its version.

``pinned`` entries (:meth:`pin`) have a refcount floor of one: they are
never parked and never evicted —
:meth:`~elephas_tpu.serving_engine.DecodeEngine.register_prefix` is
this pinning layer on top of the automatic cache.

Copied into the port from ``elephas_tpu/models/block_cache.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["BlockCache", "BlockEntry", "chain_keys"]


def chain_keys(tokens: np.ndarray, block_size: int,
               weights_version: int) -> List[bytes]:
    """The hash chain of ``tokens``' full blocks: one 16-byte blake2b
    digest per FULL ``block_size`` block, each hashing (previous digest,
    this block's token bytes) with ``weights_version`` seeding the
    chain root. ``len(result) == len(tokens) // block_size``."""
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    bs = int(block_size)
    prev = b"v%d" % int(weights_version)
    keys: List[bytes] = []
    for b in range(tokens.size // bs):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(tokens[b * bs:(b + 1) * bs].tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


class BlockEntry:
    """One cached full block: chain key -> payload, plus the sharing
    state (refcount/pin) the pooled mode needs."""

    __slots__ = ("key", "payload", "refcount", "pinned", "tokens")

    def __init__(self, key: bytes, payload, tokens: int):
        self.key = key
        self.payload = payload
        self.refcount = 0
        self.pinned = False
        #: prompt tokens this entry's CHAIN covers (= (i+1) * block_size
        #: for chain position i) — the tokens-reused accounting on a hit
        self.tokens = int(tokens)


class BlockCache:
    """Chain-keyed block store with refcounts, an LRU park list for
    unreferenced entries, and pinning. See the module docstring for the
    two usage modes (pooled block ids vs host arrays).

    :param capacity: host-mode bound on TOTAL entries (pinned entries
        exempt); inserting past it evicts the LRU parked entry first.
        ``None`` (pooled mode) leaves eviction to the caller's
        allocator via :meth:`evict_lru`.
    :param on_evict: callback ``(entry)`` run when an entry is evicted
        (capacity or :meth:`evict_lru`) — the pooled engine returns the
        entry's block id to its free list counter here.
    """

    def __init__(self, capacity: Optional[int] = None, on_evict=None):
        self.capacity = None if capacity is None else int(capacity)
        self._on_evict = on_evict
        self._pinned = 0          # maintained incrementally: readers
        # (check_admissible / stats on HTTP handler threads) must never
        # iterate _entries while the engine loop mutates it
        self._entries: Dict[bytes, BlockEntry] = {}
        # zero-ref unpinned entries, least-recently-released first: the
        # reclaimable pool — eviction pops from the front
        self._lru: "OrderedDict[bytes, BlockEntry]" = OrderedDict()
        self.hits = 0            # chain walks that reused >= 1 block
        self.misses = 0          # walks over >= 1 full block, 0 reused
        self.evictions = 0

    # ------------------------------------------------------------- walk
    def match_chain(self, keys: Sequence[bytes]) -> List[BlockEntry]:
        """The longest PREFIX of ``keys`` present in the cache, in
        chain order. The walk stops at the first absent key: a chain
        with an evicted middle block is unusable past the gap (the KV
        at block ``i`` is only valid under blocks ``0..i-1``). Pure
        read — no refcounts move; callers :meth:`acquire` the entries
        they decide to use."""
        out: List[BlockEntry] = []
        for k in keys:
            e = self._entries.get(k)
            if e is None:
                break
            out.append(e)
        return out

    def record_walk(self, reused: int, had_full_blocks: bool) -> None:
        """Hit/miss accounting for one admission-time walk: a walk that
        reused no block over a prompt that HAD at least one full block
        is a miss; prompts shorter than one block are neither."""
        if reused > 0:
            self.hits += 1
        elif had_full_blocks:
            self.misses += 1

    # ------------------------------------------------------ ref lifecycle
    def acquire(self, entry: BlockEntry) -> None:
        """Take a reference (a slot's block table now points at the
        entry's block) — unparks it from the LRU list."""
        entry.refcount += 1
        self._lru.pop(entry.key, None)

    def release(self, entry: BlockEntry) -> None:
        """Drop a reference; the last release parks the entry at the
        MRU end of the reclaim list (pinned entries never park — the
        refcount floor register_prefix buys)."""
        entry.refcount -= 1
        if entry.refcount <= 0:
            entry.refcount = 0
            if entry.pinned:
                return
            if entry.key in self._entries:
                self._lru[entry.key] = entry
                self._lru.move_to_end(entry.key)

    def touch(self, entry: BlockEntry) -> None:
        """Host-mode hit: refresh the entry's LRU position without
        taking a reference (host payloads are copied out, not shared)."""
        if entry.key in self._lru:
            self._lru.move_to_end(entry.key)

    # --------------------------------------------------------- insert/pin
    def get(self, key: bytes) -> Optional[BlockEntry]:
        return self._entries.get(key)

    def insert(self, key: bytes, payload, tokens: int,
               acquire: bool = False) -> BlockEntry:
        """Add a new entry (caller guarantees ``key`` is absent —
        content-addressing makes a duplicate a bookkeeping bug).
        ``acquire=True`` (pooled mode) births it referenced by the
        inserting slot; otherwise it parks immediately (host mode),
        evicting past ``capacity``."""
        if key in self._entries:
            raise ValueError("duplicate block-cache insert")
        e = BlockEntry(key, payload, tokens)
        self._entries[key] = e
        if acquire:
            e.refcount = 1
        else:
            self._lru[key] = e
        if self.capacity is not None:
            while (len(self._entries) - self.pinned_count() > self.capacity
                   and self._lru):
                self.evict_lru()
        return e

    def pin(self, entry: BlockEntry) -> None:
        """Refcount floor of one: never parked, never evicted (the
        explicit ``register_prefix`` layer)."""
        if not entry.pinned:
            self._pinned += 1
        entry.pinned = True
        self._lru.pop(entry.key, None)

    def unpin(self, entry: BlockEntry) -> None:
        if entry.pinned:
            self._pinned -= 1
        entry.pinned = False
        if entry.refcount <= 0 and entry.key in self._entries:
            self._lru[entry.key] = entry
            self._lru.move_to_end(entry.key)

    def unpin_all(self) -> None:
        """Lift every pin (clear_prefixes, or a weight hot-swap making
        the old version's pins unreachable) — zero-ref entries park
        and become reclaimable. Engine-loop only (iterates the map)."""
        if not self._pinned:
            return
        for entry in list(self._entries.values()):
            if entry.pinned:
                self.unpin(entry)

    # ----------------------------------------------------------- eviction
    def evict_lru(self) -> BlockEntry:
        """Reclaim the coldest parked entry (pool pressure — or host
        capacity — chose reclaim over failing admission). Raises
        ``KeyError`` when nothing is reclaimable; pooled callers check
        :meth:`reclaimable_count` inside their admission math first."""
        key, entry = self._lru.popitem(last=False)
        del self._entries[key]
        self.evictions += 1
        if self._on_evict is not None:
            self._on_evict(entry)
        return entry

    # ------------------------------------------------------------ queries
    def reclaimable_count(self) -> int:
        """Zero-ref unpinned entries — blocks an admission may reclaim."""
        return len(self._lru)

    def is_parked(self, entry: BlockEntry) -> bool:
        return entry.key in self._lru

    def pinned_count(self) -> int:
        return self._pinned

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "cached_blocks": len(self._entries),
                "reclaimable_blocks": len(self._lru),
                "pinned_blocks": self.pinned_count()}

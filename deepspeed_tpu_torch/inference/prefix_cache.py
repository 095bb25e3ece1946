"""Copy-on-write prefix cache over the paged block pool (host side).

Multi-tenant agent/chat traffic re-prefills the same system prompt for
every request. The block pool already makes KV rows position-addressable;
this module adds the HOST index that lets requests share them: completed
prefills publish their blocks under a **chained content hash** (one hash
per FULL block of the token stream, each chained on its predecessor so a
block is only reachable through its exact prefix), and a new request whose
prompt walks the same chain maps the SAME physical blocks into its table
instead of recomputing them.

Sharing is refcounted in the ``BlockAllocator``: the cache holds one
reference per indexed block, every consumer request holds another, and
``free`` decrements — a block returns to the pool only when the last
reader drops it. Two sharing grades:

  * **Full blocks** are immutable the moment a prefill fills them (decode
    appends only ever write PAST them), so they are indexed as soon as a
    request's prefill completes and shared by reference, never copied.
  * The **partially-filled boundary block** is still append-target for its
    owner, so it is only donated to the cache when the owning request
    FINISHES (the cache takes over the reference; the recorded row tokens
    say how far a future prompt may trust it). A consumer that matches it
    maps it read-only and the scheduler **forks on first write**: the
    boundary block is copied into a fresh block before the consumer's own
    rows land (full shared blocks are referenced, never copied — the
    copy-on-write contract).

Eviction is LRU under pool pressure: the scheduler asks the cache to
release references when an allocation would otherwise fail, so cached
prefixes act as best-effort free space — a cache hit is a latency win,
a cache MISS can never be an admission loss. Evicting a full block also
drops every descendant entry (they are unreachable without their prefix).

Pure Python/numpy like the scheduler: prefix matching runs on every
admission and must never touch the device.

Copied from ``deepspeed_tpu/inference/prefix_cache.py`` (pure Python and
numpy; nothing to adapt but this note). The port's serving engine forks a
shared boundary block with an in-place block copy of the pools.
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PrefixMatch:
    """Result of a cache lookup: ``blocks`` are the full shared blocks
    (``rows == len(blocks) * block_size`` rows of trusted KV), plus at
    most one partially-valid boundary block whose first ``partial_rows``
    rows extend the match. ``total_rows`` is what the consumer may set its
    prefill cursor to."""
    blocks: List[int] = dataclasses.field(default_factory=list)
    rows: int = 0
    partial_block: Optional[int] = None
    partial_rows: int = 0

    @property
    def total_rows(self) -> int:
        return self.rows + self.partial_rows


@dataclasses.dataclass
class _Full:
    block: int
    parent: Optional[int]          # chain hash of the preceding block
    # the block's row tokens, kept for VERIFICATION: the chain hash is
    # Python's 64-bit hash() (an index, not a guarantee) — a collision
    # must never map another tenant's KV into a consumer's table, so a
    # match only counts when the recorded tokens compare equal (the same
    # rule the partial boundary always had)
    tokens: Optional[Tuple[int, ...]] = None
    lru: int = 0


@dataclasses.dataclass
class _Partial:
    block: int
    tokens: Tuple[int, ...]        # row tokens actually in the block
    lru: int = 0


def _chain(prev: Optional[int], block_tokens: np.ndarray) -> int:
    """Chained content hash: a block is keyed by its tokens AND its exact
    prefix, so equal blocks under different histories never collide."""
    return hash((prev, np.asarray(block_tokens, np.int32).tobytes()))


class PrefixCache:
    """Host index of shareable pool blocks. Owns one allocator reference
    per indexed block; ``clear()`` releases them all (the engine calls it
    whenever the device pool is rebuilt — cached rows die with the pool).

    ``max_blocks`` caps the cache's held references; inserting past it
    evicts LRU first. ``None`` = bounded only by pool pressure (the
    scheduler's ``evict`` calls)."""

    def __init__(self, allocator, block_size: int,
                 max_blocks: Optional[int] = None):
        self.allocator = allocator
        self.block_size = int(block_size)
        self.max_blocks = max_blocks
        self._full: Dict[int, _Full] = {}
        self._partial: Dict[Optional[int], _Partial] = {}
        self._tick = 0
        self.reset_stats()

    # ---- stats -------------------------------------------------------

    def reset_stats(self) -> None:
        # forks are the ENGINE's counter (stats()["cow_forks"]) — the
        # cache only indexes; counting the same event twice would drift
        self.stats = {"lookups": 0, "hits": 0, "hit_rows": 0,
                      "partial_hits": 0, "inserted_blocks": 0,
                      "evicted_blocks": 0}

    @property
    def held_blocks(self) -> int:
        return len(self._full) + len(self._partial)

    @property
    def reclaimable_blocks(self) -> int:
        """Cached blocks held by NOBODY else (refcount 1 = just the
        cache's reference): one eviction away from the free list. The
        admission watermark subtracts these — a warm cache is best-effort
        free space and must never read as pool pressure."""
        n = 0
        for e in self._full.values():
            n += self.allocator.refcount(e.block) == 1
        for pe in self._partial.values():
            n += self.allocator.refcount(pe.block) == 1
        return n

    # ---- lookup ------------------------------------------------------

    def match(self, tokens: np.ndarray) -> PrefixMatch:
        """Longest cached prefix of ``tokens``, capped at ``len - 1`` rows:
        at least one token is always left to prefill, because the request
        needs a forward pass to sample its first output token. Read-only
        and STAT-FREE — ``acquire`` takes the references and the scheduler
        calls ``record_lookup`` only when the admission actually lands
        (a blocked admission re-matches every round; counting each retry
        would inflate the hit metrics the bench gates on)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        cap = tokens.size - 1
        m = PrefixMatch()
        h: Optional[int] = None
        for i in range(max(0, cap // bs)):
            blk_toks = tokens[i * bs:(i + 1) * bs]
            h2 = _chain(h, blk_toks)
            e = self._full.get(h2)
            if e is None:
                break
            if e.tokens is not None and not np.array_equal(
                    np.asarray(e.tokens, np.int32), blk_toks):
                break       # 64-bit hash collision: never trust it
            self._tick += 1
            e.lru = self._tick
            m.blocks.append(e.block)
            h = h2
        m.rows = len(m.blocks) * bs
        pe = self._partial.get(h) if cap - m.rows > 0 else None
        if pe is not None:
            rem = tokens[m.rows:cap]
            pt = np.asarray(pe.tokens, np.int32)
            n = min(rem.size, pt.size)
            eq = rem[:n] == pt[:n]
            k = int(eq.argmin()) if not eq.all() else n
            if k > 0:
                self._tick += 1
                pe.lru = self._tick
                m.partial_block = pe.block
                m.partial_rows = k
        return m

    def record_lookup(self, m: PrefixMatch) -> None:
        """Count one ADMISSION's lookup outcome (hit or miss) — called by
        the scheduler when the request actually lands, so hit-rate stats
        are per admission, never per blocked-and-retried round."""
        self.stats["lookups"] += 1
        if m.total_rows:
            self.stats["hits"] += 1
            self.stats["hit_rows"] += m.total_rows
            if m.partial_rows:
                self.stats["partial_hits"] += 1

    def acquire(self, m: PrefixMatch, owner=None) -> None:
        """Take the consumer's references on a match's blocks (full blocks
        AND the boundary block — the boundary ref is what keeps the block
        alive until the scheduler's copy-on-write fork replaces it)."""
        if m.blocks:
            self.allocator.share(m.blocks, owner=owner)
        if m.partial_block is not None:
            self.allocator.share([m.partial_block], owner=owner)

    # ---- publication -------------------------------------------------

    def insert_full(self, tokens: np.ndarray, block_ids: List[int],
                    rows: int) -> None:
        """Index every FULL block of ``tokens[:rows]`` (a completed
        prefill, or prompt+generated at finish). Full blocks are immutable
        — decode appends only write past them — so sharing them while the
        owner keeps running is safe. First writer wins: a chain hash
        already indexed keeps its existing block (dedup)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        n_full = min(rows, tokens.size) // bs
        h: Optional[int] = None
        for i in range(n_full):
            blk_toks = tokens[i * bs:(i + 1) * bs]
            h2 = _chain(h, blk_toks)
            e = self._full.get(h2)
            if e is None:
                if not self._make_room(1):
                    return
                self.allocator.share([block_ids[i]])
                self._tick += 1
                self._full[h2] = _Full(block_ids[i], parent=h,
                                       tokens=tuple(int(t)
                                                    for t in blk_toks),
                                       lru=self._tick)
                self.stats["inserted_blocks"] += 1
            else:
                self._tick += 1
                e.lru = self._tick
            h = h2

    def donate_boundary(self, tokens: np.ndarray, block_ids: List[int],
                        rows: int) -> None:
        """Record a FINISHED request's partially-filled boundary block
        (its owner will never append again). Keyed by the chain of the
        preceding full blocks; a longer donation under the same chain
        replaces a shorter one."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        valid = min(rows, tokens.size)
        n_full, part = valid // bs, valid % bs
        if part == 0 or n_full >= len(block_ids):
            return
        h: Optional[int] = None
        for i in range(n_full):
            h = _chain(h, tokens[i * bs:(i + 1) * bs])
        pe = self._partial.get(h)
        if pe is not None and len(pe.tokens) >= part:
            return
        if pe is None and not self._make_room(1):
            return
        self.allocator.share([block_ids[n_full]])
        if pe is not None:
            self.allocator.free([pe.block])
        self._tick += 1
        self._partial[h] = _Partial(block_ids[n_full],
                                    tuple(int(t) for t in
                                          tokens[n_full * bs:valid]),
                                    lru=self._tick)
        self.stats["inserted_blocks"] += 1

    # ---- eviction ----------------------------------------------------

    def _descendants(self, h: int) -> List[int]:
        out = [k for k, e in self._full.items() if e.parent == h]
        for k in list(out):
            out.extend(self._descendants(k))
        return out

    def _drop_full(self, h: int) -> int:
        """Remove a full entry AND its (unreachable) descendants; returns
        blocks whose refcount reached 0 (actually reclaimed)."""
        freed = 0
        for k in self._descendants(h) + [h]:
            e = self._full.pop(k, None)
            if e is None:
                continue
            self.allocator.free([e.block])
            freed += self.allocator.refcount(e.block) == 0
            self.stats["evicted_blocks"] += 1
            pe = self._partial.pop(k, None)
            if pe is not None:
                self.allocator.free([pe.block])
                freed += self.allocator.refcount(pe.block) == 0
                self.stats["evicted_blocks"] += 1
        return freed

    def _drop_partial(self, h: Optional[int]) -> int:
        pe = self._partial.pop(h, None)
        if pe is None:
            return 0
        self.allocator.free([pe.block])
        self.stats["evicted_blocks"] += 1
        return int(self.allocator.refcount(pe.block) == 0)

    def _drop_lru(self) -> int:
        """Drop the least-recently-used entry (a full entry takes its
        unreachable descendants with it); returns blocks actually
        reclaimed to the free list."""
        lru_full = min(self._full.items(), key=lambda kv: kv[1].lru,
                       default=None)
        lru_part = min(self._partial.items(), key=lambda kv: kv[1].lru,
                       default=None)
        if lru_part is not None and (
                lru_full is None or lru_part[1].lru <= lru_full[1].lru):
            return self._drop_partial(lru_part[0])
        return self._drop_full(lru_full[0])

    def evict(self, want_blocks: int) -> int:
        """Release LRU entries until ``want_blocks`` blocks actually
        returned to the free list (a cached block still mapped by a
        running request is dropped from the index but frees nothing yet).
        Returns the number reclaimed — the scheduler retries its
        allocation with exactly that much more room."""
        freed = 0
        while freed < want_blocks and (self._full or self._partial):
            freed += self._drop_lru()
        return freed

    def _make_room(self, n: int) -> bool:
        """The ``max_blocks`` cap bounds HELD references, so make room by
        entries dropped (held_blocks delta), NOT by blocks reclaimed to
        the free list — under running consumers (refcount > 1 after the
        cache's drop) ``evict``'s reclaimed count stays 0 and a
        reclaim-counting loop would flush the entire index, hot chains
        included, to admit one block."""
        if self.max_blocks is None:
            return True
        while self.held_blocks + n > self.max_blocks:
            if not (self._full or self._partial):
                return False
            self._drop_lru()
        return True

    def clear(self) -> None:
        """Drop every reference (device pool rebuilt — cached rows are
        gone). Stats survive; the window is reset_stats()'s job."""
        for e in self._full.values():
            self.allocator.free([e.block])
        for pe in self._partial.values():
            self.allocator.free([pe.block])
        self._full.clear()
        self._partial.clear()

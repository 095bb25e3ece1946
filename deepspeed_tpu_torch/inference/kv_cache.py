"""Paged KV-cache management: a host-side free list over the device block
pool, and the LoRA adapter slot pool's accounting. Copied from
``deepspeed_tpu/inference/kv_cache.py`` (pure Python, no framework
imports).

The device half lives in ``models/transformer``: fixed-size blocks in
preallocated pools ``[L, NB, n_kv, block_size, head_dim]``, per-sequence
block tables, attention reads through the tables (``decode_step_paged``).
This module is the HOST half — which physical block holds which
sequence's tokens. Block accounting runs at every scheduling boundary and
must never wait on the device.

Block 0 is RESERVED as the trash block: null table entries point at it and
inactive slots write their lockstep rows into it, so the decode step needs
no scatter masking and freed blocks never need zeroing (stale contents are
masked by the per-slot length — pinned by the garbage tests).
"""

from typing import Dict, List, Optional


class BlockPoolExhausted(Exception):
    """Raised by ``alloc`` when the free list can't cover a request — the
    scheduler catches this and queues/preempts instead of OOMing."""


class InvalidBlock(ValueError):
    """A block id outside the pool's range reached ``free`` — a table/
    cursor accounting bug. Typed (vs the bare index error Python would
    raise, or the silent corruption a NEGATIVE id would cause through
    list wraparound) and names both the block and the owning sequence so
    the broken bookkeeping is attributable from the traceback alone."""

    def __init__(self, block: int, num_blocks: int, owner=None):
        self.block = block
        self.num_blocks = num_blocks
        self.owner = owner
        who = f" freed by sequence {owner}" if owner is not None else ""
        super().__init__(
            f"block id {block} outside pool range [1, {num_blocks}){who}")


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` pool blocks (block 0
    reserved), with PER-BLOCK REFCOUNTS so the prefix cache can map one
    physical block into many requests' tables (copy-on-write sharing).
    ``alloc`` hands out blocks at refcount 1; ``share``
    increments; ``free`` DECREMENTS and only returns a block to the free
    list when its count reaches 0 — so a request releasing its table
    never yanks a block other readers still map. O(1) alloc/free;
    decrementing past 0 (the old double free), freeing the trash block
    and out-of-range ids raise — an accounting bug here silently corrupts
    another request's cache.

    A block with ``refcount(b) > 1`` has other readers: it must NEVER be
    written in place. Writers fork first (allocate a fresh block, copy
    the rows, swap the table entry, decrement the shared block) — the
    scheduler/engine own that barrier; the allocator owns the counts.

    ``set_reserve(n)`` hides n free blocks from ``can_alloc``/``alloc``
    without touching ownership: the fault injector's ``pool_exhaust``
    storms squeeze the visible pool so the scheduler's queue/preempt
    paths run under REAL exhaustion pressure while every held block
    stays accounted."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"num_blocks={num_blocks}: need >= 2 "
                             "(block 0 is the reserved trash block)")
        self.num_blocks = num_blocks
        # LIFO: recently freed (cache-warm) blocks are reused first
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = [0] * num_blocks
        self._reserve = 0

    @property
    def free_blocks(self) -> int:
        return max(0, len(self._free) - self._reserve)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def used_fraction(self) -> float:
        """Held fraction of the usable pool (trash block excluded) — the
        admission pool-watermark's measure."""
        usable = self.num_blocks - 1
        return self.used_blocks / usable if usable else 1.0

    def set_reserve(self, n: int) -> None:
        """Hide n free blocks from allocation (0 restores the full pool)."""
        self._reserve = max(0, int(n))

    def can_alloc(self, n: int) -> bool:
        return n <= self.free_blocks

    def alloc(self, n: int) -> List[int]:
        if n > self.free_blocks:
            raise BlockPoolExhausted(
                f"need {n} blocks, {self.free_blocks} free "
                f"(pool {self.num_blocks}"
                + (f", {self._reserve} squeezed" if self._reserve else "")
                + ")")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def refcount(self, block: int) -> int:
        """Readers mapping this block (0 = free). ``> 1`` means shared:
        writing it in place would corrupt another reader — fork first."""
        if not 0 <= block < self.num_blocks:
            raise InvalidBlock(block, self.num_blocks)
        return self._ref[block]

    def share(self, blocks: List[int], owner: Optional[int] = None) -> None:
        """Add one reference to each (already-held) block — the prefix
        cache mapping a cached block into another request's table. Sharing
        a free block is the same accounting bug as double-freeing one."""
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise InvalidBlock(b, self.num_blocks, owner=owner)
            if b == 0:
                raise ValueError("sharing the reserved trash block 0")
            if self._ref[b] <= 0:
                raise ValueError(f"sharing free block {b} (nothing holds "
                                 "it — stale prefix-cache entry?)")
            self._ref[b] += 1

    def free(self, blocks: List[int], owner: Optional[int] = None) -> None:
        """Drop one reference per block; a block returns to the free list
        only when its LAST reference drops (shared prefix blocks survive
        any single request's eviction)."""
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise InvalidBlock(b, self.num_blocks, owner=owner)
            if b == 0:
                raise ValueError("freeing the reserved trash block 0")
            if self._ref[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)


class AdapterSlotPool:
    """Host-side slot accounting for the device LoRA adapter pool — the
    ``BlockAllocator`` idea generalized to READ-ONLY shared pages
    (multi-tenancy). Each resident adapter occupies one slot of
    the device tables ``[L, NS, ...]``; slot 0 is RESERVED for the
    all-zero null adapter (base-model requests index it — the exact
    mirror of the trash block: no masking in the compiled program).

    The lifecycle differs from KV blocks in one load-bearing way: an
    adapter's page is still VALID after its last reader finishes (the
    device rows don't rot), so releasing to refcount 0 keeps the slot
    RESIDENT as an LRU eviction candidate instead of freeing it — the
    next request for that adapter is a hit (no page-in). Only slot
    pressure evicts: ``acquire`` for a non-resident adapter takes a
    never-used slot first, then the least-recently-released refcount-0
    resident; if every slot is pinned by in-flight requests it raises
    ``BlockPoolExhausted`` and the scheduler queues the request like any
    pool exhaustion.

    Pure host bookkeeping (no torch): ``acquire`` returns ``(slot,
    page_in)`` and the ENGINE owns the device copy when ``page_in`` is
    True. Counters feed ``stats()``: hits (resident acquire), page_ins
    (host->device table uploads), evictions (resident adapter displaced).
    """

    def __init__(self, num_slots: int):
        if num_slots < 2:
            raise ValueError(f"num_slots={num_slots}: need >= 2 (slot 0 "
                             "is the reserved null adapter)")
        self.num_slots = num_slots
        self._free: List[int] = list(range(num_slots - 1, 0, -1))
        self._slot: Dict[int, int] = {}     # adapter_id -> slot
        self._ref: Dict[int, int] = {}      # adapter_id -> in-flight readers
        self._lru: List[int] = []           # refcount-0 residents, oldest first
        self.hits = 0
        self.evictions = 0
        self.page_ins = 0

    @property
    def resident(self) -> int:
        return len(self._slot)

    def slot_of(self, adapter_id: int) -> Optional[int]:
        return self._slot.get(adapter_id)

    def acquire(self, adapter_id: int):
        """Pin ``adapter_id`` to a slot for one in-flight request.

        Returns ``(slot, page_in)``; ``page_in`` True means the caller
        must upload the adapter's tables into that slot before the next
        dispatch. adapter_id 0 is the null adapter: always slot 0, never
        paged, never counted."""
        if adapter_id == 0:
            return 0, False
        if adapter_id in self._slot:
            if self._ref[adapter_id] == 0 and adapter_id in self._lru:
                self._lru.remove(adapter_id)
            self._ref[adapter_id] += 1
            self.hits += 1
            return self._slot[adapter_id], False
        if self._free:
            slot = self._free.pop()
        elif self._lru:
            victim = self._lru.pop(0)
            slot = self._slot.pop(victim)
            del self._ref[victim]
            self.evictions += 1
        else:
            raise BlockPoolExhausted(
                f"adapter slots exhausted: {self.num_slots - 1} usable, "
                "all pinned by in-flight requests")
        self._slot[adapter_id] = slot
        self._ref[adapter_id] = 1
        self.page_ins += 1
        return slot, True

    def release(self, adapter_id: int, owner: Optional[int] = None) -> None:
        """Drop one reader. At refcount 0 the slot stays resident (warm)
        and joins the LRU eviction queue — it is NOT freed."""
        if adapter_id == 0:
            return
        if adapter_id not in self._slot or self._ref[adapter_id] <= 0:
            raise ValueError(
                f"release of adapter {adapter_id} with no in-flight "
                f"reader" + (f" (request {owner})" if owner is not None
                             else ""))
        self._ref[adapter_id] -= 1
        if self._ref[adapter_id] == 0:
            self._lru.append(adapter_id)

    def refcount(self, adapter_id: int) -> int:
        return self._ref.get(adapter_id, 0)

    def reset(self) -> None:
        """Forget all residency (the device pool was re-initialized).
        Counters survive; ``stats`` owns their lifecycle."""
        self._free = list(range(self.num_slots - 1, 0, -1))
        self._slot.clear()
        self._ref.clear()
        self._lru.clear()


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks covering n_tokens rows (0 tokens -> 0 blocks)."""
    return -(-n_tokens // block_size)


def pool_bytes(cfg, num_blocks: int, block_size: int, dtype=None) -> int:
    """Resident bytes of the block pools for a transformer config: ``rows =
    L * NB * n_kv * block_size``. int8 (``cfg.kv_cache_bits == 8``): one
    byte an element of the payload plus one f32 scale a row, twice (k and
    v); float: ``rows * head_dim`` elements twice at the itemsize of the
    POOL dtype (a torch dtype; default cfg.dtype)."""
    L, nkv, hd = cfg.num_layers, cfg.kv_heads, cfg.dim_per_head
    rows = L * num_blocks * nkv * block_size
    if cfg.kv_cache_bits == 8:
        return rows * hd * 2 + rows * 4 * 2
    itemsize = (dtype if dtype is not None else cfg.dtype).itemsize
    return rows * hd * itemsize * 2


def kv_payload_nbytes(data: Dict[str, "object"]) -> int:
    """Host bytes of an exported KV payload's per-leaf buffers (the
    ``data`` dict of a ``ServingEngine.export_kv`` payload: k/v blocks
    plus int8 scales when present). Shared by the serving engine's
    staging accounting — in-flight handoff buffers count against
    ``stats()["pool_bytes"]`` until consumed — and by the tests that pin
    that accounting."""
    return sum(int(getattr(a, "nbytes", 0)) for a in data.values())

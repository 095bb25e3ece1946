"""Paged KV-cache management: a host-side free list over the device block
pool. Copied from ``deepspeed_tpu/inference/kv_cache.py`` (pure Python,
no framework imports); the LoRA ``AdapterSlotPool`` arrives with multi-LoRA
serving (ROADMAP A6g).

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

from typing import List, Optional


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

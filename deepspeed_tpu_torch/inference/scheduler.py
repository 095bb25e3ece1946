"""Continuous-batching request scheduler (host side, pure Python), copied
from ``deepspeed_tpu/inference/scheduler.py``. The port's serving engine
passes it the prefix cache (``inference/prefix_cache.PrefixCache``) when
``enable_prefix_cache`` is on, and its token budget to ``schedule``.

Reference capability bar: the SURVEY §6 InferenceEngine serves ONE batch
per generate() call — every request in a batch shares a shape bucket and
the whole batch finishes together. Continuous (in-flight) batching admits
and evicts sequences at DECODE-STEP boundaries instead: the compiled step
is shaped by the block pool and the slot count only, so membership changes
are pure data (block-table contents, active mask) — never a recompile.

Policy (the vLLM shape):
  - FIFO admission: waiting requests admit in arrival order whenever a slot
    AND enough pool blocks (prompt + one scheduling quantum of growth) are
    free. Pool exhaustion queues gracefully — never an error.
  - Admission control: optional watermarks bound the queue. With
    ``max_queue`` / ``pool_watermark`` set, ``submit`` sheds load with a
    TYPED ``AdmissionRejected`` (never silent unbounded queue growth — the
    ``serving-unbounded-queue`` corpus entry pins the failure mode of NOT
    setting one). Both default off for API compatibility.
  - Growth: before each quantum every running sequence gets blocks covering
    its next `quantum` tokens. If the pool can't cover it, the running
    sequence with the NEWEST *first admission* is preempted (blocks freed,
    request re-queued at the FRONT with its generated tokens kept) until
    growth fits — latest-admitted-first keeps the oldest requests making
    progress, bounding tail latency instead of deadlocking the whole pool.
  - Anti-starvation aging: a preempted request KEEPS its original
    admission sequence number when it resumes. Without this, the resumed
    request is always the newest admission and sustained growth pressure
    re-preempts it forever (livelock); with it, a fresher arrival becomes
    the next victim, so the same request is never preempted twice in a row
    while any younger tenant is running (regression-pinned).
  - Deadlines: ``cancel`` evicts a request mid-decode (slot and blocks
    return to the pool immediately); the serving engine drives it from
    per-request TTFT/total deadlines at round boundaries.
  - Eviction: a finished sequence frees its slot and blocks at the next
    boundary; freed blocks admit the queue head immediately.

Preempted requests resume by RE-PREFILLING prompt+generated (recompute, the
vLLM default): cheap at serving contexts and needs zero extra pool state.
"""

import collections
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.kv_cache import (BlockAllocator, blocks_for)


class AdmissionRejected(Exception):
    """Typed load-shed: the queue or pool watermark refused a submission.
    The caller sees WHY (queue_full | pool_pressure | draining) plus the
    measurements behind the decision — never a silently growing queue."""

    def __init__(self, reason: str, **detail):
        self.reason = reason
        self.detail = detail
        extra = " ".join(f"{k}={v}" for k, v in detail.items())
        super().__init__(f"admission rejected ({reason})"
                         + (f": {extra}" if extra else ""))


@dataclasses.dataclass
class Request:
    """One generation request and its full serving lifecycle."""
    rid: int
    prompt: np.ndarray                     # [P] int32 (original prompt)
    max_new_tokens: int
    submit_t: float = 0.0
    # lifecycle: waiting -> running -> finished (preempt: back to waiting;
    # a missed deadline or shed: -> cancelled)
    state: str = "waiting"
    slot: Optional[int] = None
    block_ids: List[int] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)
    # KV rows actually in the pool (a (re-)prefill sets it to the context
    # length; each decode step adds one) — the serving engine's masks and
    # the scheduler's block-growth math both read THIS, not len(context)
    cached_rows: int = 0
    # set the moment an eos token is appended (O(1) finish checks — a
    # membership scan of `generated` per token would be quadratic)
    eos_seen: bool = False
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    preemptions: int = 0
    # deadlines (ms from submit_t; None = unbounded). TTFT applies until
    # the first token reaches the host, total until completion — the
    # serving engine enforces both at round boundaries and cancels past-
    # deadline requests, returning their blocks to the pool mid-decode.
    ttft_deadline_ms: Optional[float] = None
    deadline_ms: Optional[float] = None
    # anti-starvation aging: assigned at FIRST admission and kept across
    # preemptions, so a resumed request ages as its original admission
    # (newest-first victim selection can then never livelock it while a
    # fresher tenant is running)
    admission_seq: Optional[int] = None
    cancel_reason: Optional[str] = None
    # --- latency tier --------------------------------------------------
    # prefill phase: False from admission until the LAST prefill chunk's
    # sampled token commits (chunked prefill spreads the prompt across
    # rounds under the token budget; a mid-prefill request never decodes)
    prefill_done: bool = False
    # rows served from the prefix cache at (this) admission — the hit-rate
    # stat, and how far the first prefill chunk may skip
    prefix_rows: int = 0
    # copy-on-write fork, armed at admission when the match reached into a
    # donor's partially-filled boundary block: cow_src is the SHARED block
    # (cache-pinned until the fork copies it), cow_dst the fresh block at
    # the same table index the copy lands in — the engine dispatches the
    # device copy before the request's first write and drops the pin
    # (forks are counted once, on the engine: stats()["cow_forks"])
    cow_src: Optional[int] = None
    cow_dst: Optional[int] = None
    # wall time the request last received tokens at the host (ITL stats)
    last_token_t: Optional[float] = None
    # --- multi-tenancy -----------------------------------------------
    # which registered LoRA adapter serves this request (0 = base model /
    # the null adapter). Pure routing data to the scheduler; the serving
    # engine pins a device slot at admission and releases it when the
    # request leaves the running set.
    adapter_id: int = 0
    # device slot the adapter is paged into while running (None when not
    # pinned) — engine-owned, mirrored here so _tables_device can build
    # the per-round adapter-index vector without a lookup
    adapter_slot: Optional[int] = None
    # --- disaggregated serving --------------------------------------
    # KV rows arriving as imported BYTES instead of recompute: set by
    # accept_migration's kv= fast path after restore(). Admission then
    # starts cached_rows at kv_rows (like a prefix-cache hit) and skips
    # prefix matching — the engine scatters the payload into the fresh
    # blocks before the tail span runs. Cleared on preemption (the
    # payload is dropped; resume re-prefills — the fallback is always
    # the recompute path, never stale bytes).
    kv_rows: int = 0

    @property
    def context(self) -> np.ndarray:
        """Tokens to (re-)prefill: prompt + everything generated so far."""
        if not self.generated:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.generated, np.int32)])

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)

    @property
    def output(self) -> np.ndarray:
        """Final result ids — identical to `context` by design: what would
        be re-prefilled on preemption IS what the caller receives."""
        return self.context


# each preemption ages a request by this many admission slots in the
# victim ordering. 2 (not 1): a single preemption must push the resumed
# request STRICTLY below the tenant it lost to, so the next victim under
# sustained pressure is someone else — never the same request twice in a
# row (1 would tie and the tie-break would re-pick it)
AGING_BONUS = 2


class RequestScheduler:
    """Admission/eviction/preemption over a BlockAllocator + slot set.

    Pure host logic: `schedule()` returns the decisions (admitted /
    preempted requests); the serving engine turns them into prefill
    dispatches and table updates. `prompt_blocks(n_tokens)` maps a
    (re-)prefill context length to the blocks its padded bucket occupies —
    injected so the scheduler stays ignorant of shape-bucketing policy.
    """

    def __init__(self, allocator: BlockAllocator, max_seqs: int,
                 block_size: int, quantum: int,
                 prompt_blocks: Callable[[int], int],
                 max_blocks_per_seq: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 pool_watermark: Optional[float] = None,
                 prefix_cache=None):
        self.allocator = allocator
        self.max_seqs = max_seqs
        self.block_size = block_size
        self.quantum = quantum
        self.prompt_blocks = prompt_blocks
        # optional CoW prefix cache (inference/prefix_cache.PrefixCache):
        # admissions map cached prefix blocks by reference, finishes
        # publish their blocks, allocation pressure evicts LRU entries
        self.prefix_cache = prefix_cache
        # block-table width: growth clamps here — a sequence at its context
        # cap whose budget ran out mid-quantum writes its (discarded)
        # overshoot rows into its own last block, never past the table
        self.max_blocks_per_seq = max_blocks_per_seq or (1 << 30)
        # admission watermarks (None = unbounded, the pre-reliability
        # behavior): queue length cap and held-pool-fraction cap beyond
        # which submit() sheds with a typed AdmissionRejected
        self.max_queue = max_queue
        self.pool_watermark = pool_watermark
        self.waiting: Deque[Request] = collections.deque()
        self.running: List[Request] = []   # admission order (oldest first)
        self._free_slots = list(range(max_seqs - 1, -1, -1))
        self._next_rid = 0
        self._next_seq = 0                 # first-admission counter (aging)

    # ---- request lifecycle -------------------------------------------

    def _effective_used_fraction(self) -> float:
        """Held-pool fraction for the admission watermark, EXCLUDING
        blocks held only by the prefix cache: those are one LRU eviction
        from free (``_can_alloc`` reclaims them before any queue or
        preemption), so a warm cache must never shed arrivals as
        pool_pressure — a cache hit is a latency win, a full cache never
        an admission loss."""
        used = self.allocator.used_blocks
        if self.prefix_cache is not None:
            used -= self.prefix_cache.reclaimable_blocks
        usable = self.allocator.num_blocks - 1
        return used / usable if usable else 1.0

    def submit(self, prompt, max_new_tokens: int,
               rid: Optional[int] = None,
               ttft_deadline_ms: Optional[float] = None,
               deadline_ms: Optional[float] = None,
               adapter_id: int = 0) -> Request:
        if self.max_queue is not None and len(self.waiting) >= self.max_queue:
            raise AdmissionRejected("queue_full",
                                    queue_len=len(self.waiting),
                                    max_queue=self.max_queue)
        # fast path: the effective fraction only SUBTRACTS from the raw
        # one, so below the raw watermark there is nothing to compute —
        # the O(cache-entries) reclaimable scan runs only under apparent
        # pressure, never on the ordinary admission hot path
        if self.pool_watermark is not None \
                and self.allocator.used_fraction >= self.pool_watermark:
            eff = self._effective_used_fraction()
            if eff >= self.pool_watermark:
                raise AdmissionRejected(
                    "pool_pressure", pool_used=round(eff, 3),
                    pool_watermark=self.pool_watermark)
        req = Request(rid=self._next_rid if rid is None else rid,
                      prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=int(max_new_tokens),
                      submit_t=time.perf_counter(),
                      ttft_deadline_ms=ttft_deadline_ms,
                      deadline_ms=deadline_ms,
                      adapter_id=int(adapter_id))
        self._next_rid = max(self._next_rid, req.rid) + 1
        self.waiting.append(req)
        return req

    def restore(self, req: Request) -> None:
        """Re-enqueue a deserialized request (drain/resume path): bypasses
        the admission watermarks — the request was already admitted once,
        shedding it on resume would drop accepted work. Appended in call
        order; the resume path replays the drained engine's order."""
        req.state = "waiting"
        req.submit_t = time.perf_counter()
        req.cached_rows = 0
        req.slot = None
        req.block_ids = []
        req.admission_seq = None
        req.prefill_done = False
        req.prefix_rows = 0
        req.cow_src = req.cow_dst = None
        req.last_token_t = None
        req.adapter_slot = None
        req.kv_rows = 0
        self._next_rid = max(self._next_rid, req.rid) + 1
        self.waiting.append(req)

    def _release_cow(self, req: Request) -> None:
        """Drop an un-forked request's pin on its shared boundary block
        (the engine normally releases it when the fork copy dispatches;
        this covers eviction/recovery between admission and the fork)."""
        if req.cow_src is not None:
            self.allocator.free([req.cow_src], owner=req.rid)
            req.cow_src = req.cow_dst = None

    def _publish(self, req: Request) -> None:
        """Offer a leaving request's KV to the prefix cache: full blocks
        indexed (immutable, shared by reference), the partial boundary
        block donated (the owner will never append again — a future
        consumer copy-on-write forks it). Rows past the real context
        (quantum overshoot / rejected speculation) are never published."""
        if self.prefix_cache is None or not req.block_ids:
            return
        if req.adapter_id:
            # adapter KV rows are adapter-SPECIFIC (the LoRA delta flows
            # into k/v): publishing them under a content-only hash would
            # alias another tenant's cache — adapter requests neither
            # publish nor match (base-model traffic still shares)
            return
        ctx = req.context
        valid = min(req.cached_rows, ctx.size)
        self.prefix_cache.insert_full(ctx, req.block_ids, valid)
        self.prefix_cache.donate_boundary(ctx, req.block_ids, valid)

    def finish(self, req: Request) -> None:
        """Evict a completed sequence: its prefix publishes to the cache,
        then slot and blocks return to the pool (shared blocks decrement —
        the cache's references keep them alive)."""
        assert req.state == "running", req.state
        req.state = "finished"
        req.finish_t = time.perf_counter()
        self.running.remove(req)
        self._free_slots.append(req.slot)
        self._release_cow(req)
        self._publish(req)
        if req.block_ids:
            self.allocator.free(req.block_ids, owner=req.rid)
        req.block_ids = []
        req.slot = None

    def cancel(self, req: Request, reason: str = "cancelled") -> None:
        """Evict a request wherever it is in its lifecycle (deadline miss /
        shed): a running request's slot and blocks return to the pool
        MID-decode, a waiting one leaves the queue. Its partial output
        (prompt + whatever was generated) stays readable."""
        if req.state == "running":
            self.running.remove(req)
            self._free_slots.append(req.slot)
            self._release_cow(req)
            self._publish(req)
            if req.block_ids:
                self.allocator.free(req.block_ids, owner=req.rid)
            req.block_ids = []
            req.slot = None
        elif req.state == "waiting":
            try:
                self.waiting.remove(req)
            except ValueError:
                pass
        elif req.state in ("finished", "cancelled"):
            return
        req.state = "cancelled"
        req.cancel_reason = reason
        req.finish_t = time.perf_counter()

    # ---- the per-quantum decision ------------------------------------

    @staticmethod
    def _effective_seq(req: Request) -> int:
        """Victim-ordering key: first-admission order minus the aging
        bonus earned per preemption (higher = fresher = preempted first)."""
        return (req.admission_seq or 0) - AGING_BONUS * req.preemptions

    def preempt(self, req: Request) -> Request:
        """Preempt a SPECIFIC running request back to the queue head:
        slot and blocks return to the pool, host cursors stay
        authoritative (resume re-prefills). The victim-selection policy
        lives in ``_preempt_newest``; this is the mechanism — also used
        by the serving engine when an admission cannot pin its adapter
        slot (every slot held by another in-flight adapter)."""
        self.running.remove(req)
        req.state = "waiting"
        req.preemptions += 1
        req.cached_rows = 0                    # resumes by re-prefilling
        req.prefill_done = False
        req.prefix_rows = 0
        req.kv_rows = 0                        # imported KV never survives
        #                                        eviction: re-admission
        #                                        recomputes (the engine
        #                                        drops the staged payload)
        self._free_slots.append(req.slot)
        self._release_cow(req)
        self.allocator.free(req.block_ids, owner=req.rid)
        req.block_ids = []
        req.slot = None
        self.waiting.appendleft(req)           # resumes before new arrivals
        return req

    def _preempt_newest(self) -> Optional[Request]:
        """Preempt the running request with the newest EFFECTIVE admission:
        ``admission_seq - AGING_BONUS * preemptions``. A resumed request
        keeps its original admission_seq AND earns a bonus per preemption,
        so it is never the victim while any younger tenant runs, and even
        in a 2-slot pool the victim ROTATES instead of livelocking — the
        pre-aging ``running.pop()`` always took the resumed request (it
        was always the newest list entry), re-preempting it forever under
        sustained growth (regression-pinned)."""
        if not self.running:
            return None
        return self.preempt(max(self.running, key=self._effective_seq))

    def preempt_all(self) -> int:
        """Evict every running request back to the queue (fault recovery:
        the device pool is being rebuilt, host cursors are authoritative).
        Victims are taken newest-first, so the queue ends oldest-first and
        FIFO re-admission preserves the original service order."""
        n = 0
        while self.running:
            self._preempt_newest()
            n += 1
        return n

    def _can_alloc(self, n: int) -> bool:
        """can_alloc with cache pressure: when the free list is short, ask
        the prefix cache to evict LRU entries first — cached prefixes are
        best-effort free space, never a reason to queue or preempt."""
        if self.allocator.can_alloc(n):
            return True
        if self.prefix_cache is not None:
            self.prefix_cache.evict(n - self.allocator.free_blocks)
        return self.allocator.can_alloc(n)

    def _grow(self, req: Request, target_len: int) -> bool:
        want = min(blocks_for(target_len, self.block_size),
                   self.max_blocks_per_seq)
        need = want - len(req.block_ids)
        if need <= 0:
            return True
        if not self._can_alloc(need):
            return False
        req.block_ids.extend(self.allocator.alloc(need))
        return True

    def schedule(self, token_budget: Optional[int] = None) -> Dict[str, Any]:
        """One step-boundary decision. Returns {"admitted": [...],
        "preempted": [...], "prefill": [(req, start, n), ...]}; admitted
        requests have slot + prompt blocks assigned (and any cached prefix
        mapped — ``cached_rows`` starts at the shared rows), running
        requests are guaranteed block coverage for the next quantum.

        ``prefill`` spans are what the engine must compute this round.
        With ``token_budget=None`` each request still prefilling gets its
        whole remaining prompt in one span (the pre-budget behavior). With
        a budget, spans are sliced so one round's prefill work — SHARED
        with the decode quantum's ``quantum * n_decoding`` token
        reservation — never exceeds the budget: a 4k-prompt admission
        spreads across rounds instead of stalling every running request's
        inter-token latency. Progress guarantee: when nothing is decoding,
        the oldest prefilling request always gets at least one block-worth
        of tokens, so a budget below the block size cannot wedge."""
        preempted: List[Request] = []
        # 1. growth for the already-running, oldest EFFECTIVE admission
        #    first (aging order, not list order — a resumed request
        #    regrows before fresher tenants); exhaustion preempts from the
        #    newest effective end until the oldest fit
        for req in sorted(self.running, key=self._effective_seq):
            if req.state != "running":
                continue                        # lost its slot this round
            # the quantum writes rows cached_rows .. cached_rows+quantum-1
            target = req.cached_rows + self.quantum
            while not self._grow(req, target):
                victim = self._preempt_newest()
                if victim is None or victim is req:
                    # req itself was the newest: it stays preempted (its
                    # re-admission below or later will retry smaller)
                    if victim is req:
                        preempted.append(req)
                    break
                preempted.append(victim)
        # 2. FIFO admission while a slot AND blocks are free. With a
        #    prefix cache, the prompt's cached full blocks are mapped by
        #    REFERENCE (refcount++), a matched partial boundary block arms
        #    the copy-on-write fork, and only the uncovered tail allocates
        #    fresh blocks.
        admitted: List[Request] = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            ctx_arr = req.context
            ctx = len(ctx_arr)
            # the request holds its padded prompt bucket's blocks plus the
            # first quantum's growth, whichever covers more — position-
            # ordered (block_ids[i] covers rows [i*bs, (i+1)*bs))
            need = min(max(self.prompt_blocks(ctx),
                           blocks_for(ctx + self.quantum, self.block_size)),
                       self.max_blocks_per_seq)
            m = (self.prefix_cache.match(ctx_arr)
                 if self.prefix_cache is not None
                 and not req.adapter_id and not req.kv_rows else None)
            if m is not None and len(m.blocks) > max(0, need - 1):
                # never map more shared blocks than the table needs minus
                # one fresh write target (match caps at ctx-1 rows, so
                # this only trims pathological max_blocks_per_seq clamps)
                m.blocks = m.blocks[:max(0, need - 1)]
                m.rows = len(m.blocks) * self.block_size
                m.partial_block, m.partial_rows = None, 0
            shared = list(m.blocks) if m is not None else []
            # take the match's references BEFORE any eviction/allocation:
            # _can_alloc may LRU-evict the matched entries themselves, and
            # without our refs their blocks would hit the free list and
            # could be handed right back as this request's fresh write
            # targets (silent KV aliasing). Pinned, eviction only drops
            # the INDEX entries; the rows stay ours.
            if m is not None:
                self.prefix_cache.acquire(m, owner=req.rid)
            if not self._can_alloc(need - len(shared)):
                if m is not None:               # un-acquire: back to the
                    if shared:                  # cache(-only) refs
                        self.allocator.free(shared, owner=req.rid)
                    if m.partial_block is not None:
                        self.allocator.free([m.partial_block],
                                            owner=req.rid)
                break                           # graceful queuing, no OOM
            self.waiting.popleft()
            fresh = self.allocator.alloc(need - len(shared))
            if m is not None:
                self.prefix_cache.record_lookup(m)   # per-ADMISSION stats
                req.prefix_rows = m.total_rows
                req.cached_rows = m.total_rows
                if m.partial_block is not None:
                    # the boundary block stays the DONOR's: the table gets
                    # the fresh block at that index and the engine copies
                    # src -> dst (the fork) before the request's first
                    # write, then drops the src pin acquire() took
                    req.cow_src = m.partial_block
                    req.cow_dst = fresh[0]
            req.block_ids = shared + fresh
            if req.kv_rows:
                # imported KV (accept_migration kv= fast path) covers rows
                # [0, kv_rows): the engine scatters the payload into these
                # fresh blocks before the tail span runs, so the prefill
                # spans start PAST the shipped rows — a handoff costs one
                # scatter + a tail span, not a prompt-length recompute.
                # Prefix matching was skipped above: the bytes already
                # carry the prefix, and a by-reference match would alias
                # the scatter's write targets.
                req.cached_rows = req.kv_rows
            req.prefill_done = False
            req.slot = self._free_slots.pop()
            req.state = "running"
            if req.admission_seq is None:      # aging: resumed requests
                req.admission_seq = self._next_seq  # keep their first seq
                self._next_seq += 1
            self.running.append(req)
            admitted.append(req)
        return {"admitted": admitted, "preempted": preempted,
                "prefill": self._prefill_spans(token_budget)}

    def _prefill_spans(self, token_budget: Optional[int]
                       ) -> List[Tuple[Request, int, int]]:
        """Slice this round's prefill work. Every running request with
        ``prefill_done=False`` needs rows ``[cached_rows, len(context))``
        computed; the budget (minus the decode quantum's reservation) is
        handed out oldest-effective-admission first in block-size
        granules, so long prompts chunk across rounds."""
        todo = [r for r in sorted(self.running, key=self._effective_seq)
                if r.state == "running" and not r.prefill_done]
        spans: List[Tuple[Request, int, int]] = []
        if token_budget is None:
            for req in todo:
                rem = len(req.context) - req.cached_rows
                if rem > 0:
                    spans.append((req, req.cached_rows, rem))
            return spans
        n_decoding = sum(1 for r in self.running
                         if r.state == "running" and r.prefill_done)
        budget = max(0, token_budget - self.quantum * n_decoding)
        for req in todo:
            rem = len(req.context) - req.cached_rows
            if rem <= 0:
                continue
            take = min(rem, (budget // self.block_size) * self.block_size)
            if take <= 0:
                if n_decoding == 0 and not spans:
                    take = min(rem, self.block_size)   # progress guarantee
                else:
                    break
            spans.append((req, req.cached_rows, take))
            budget -= take
        return spans

    # ---- introspection -----------------------------------------------

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    @property
    def done(self) -> bool:
        return not self.waiting and not self.running

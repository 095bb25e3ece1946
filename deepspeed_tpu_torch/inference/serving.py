"""Serving engine: continuous batching over a paged KV cache, PyTorch port
of ``deepspeed_tpu/inference/serving.py``.

  1. **Paged KV cache** — fixed-size blocks in preallocated pools, per-
     sequence block tables (``models/transformer.decode_step_paged``).
     Admitting and evicting sequences changes table contents only.
  2. **Continuous batching** — the ``RequestScheduler`` admits, evicts and
     preempts at round boundaries. A round dispatches the copy-on-write
     forks of the admitted requests, then their prefills (or prefill
     chunks), then ``decode_quantum`` decode steps of every decoding slot,
     with no host sync between them; the only sync is ONE fetch of the
     round's sampled tokens (plus the first tokens of the requests whose
     prefill completed).
  3. **Reliability tier** — per-request TTFT / total deadlines enforced
     at round boundaries (a missed request is cancelled and its blocks
     return mid-decode), admission watermarks (``max_queue``,
     ``pool_watermark``) that shed with a typed ``AdmissionRejected``, a
     dispatch watchdog, and the robustness events drained into a JSONL
     sink at the end of every round.
  4. **Latency tier** — token-budget chunked prefill
     (``prefill_token_budget``: long prompts slice across rounds on the
     span path, ``decode_span_paged``), the copy-on-write prefix cache
     (``enable_prefix_cache``: full prompt blocks shared by reference, a
     matched partial boundary block forked by a block copy before the
     request's first write) and greedy speculative decoding
     (``spec_tokens``: a round whose requests decode runs ONE verify step
     of the pending token plus K proposals instead of the decode quantum,
     ``inference/spec_decode``).
  5. **Quantized decode** — an int8 KV pool (``kv_cache_bits``, by
     default on from a 1024-token serving cap, as JAX's) and int8 weights
     (``weight_bits`` / ``quantize_bits``), through the InferenceEngine.
  6. **Multi-LoRA** (``adapter_slots`` / ``lora_rank`` / ``lora_targets``)
     — registered adapters' A/B tables live in host RAM
     (``inference/lora.AdapterStore``) and page into a fixed device slot
     pool (``kv_cache.AdapterSlotPool``: refcount, LRU, slot 0 the
     all-zero null adapter) by an in-place copy; every decode step, verify
     step and prefill chunk adds each slot's gathered low-rank delta
     (``models/transformer._lora_delta``), so requests of different
     adapters share one pass. A LoRA-armed engine sends every prefill
     through the span path (it carries the delta), as JAX does.
  7. **Drain, resume, migration and the KV handoff** — ``drain`` stops
     admission and writes every unfinished request through the integrity
     chain (``robustness/integrity``: state, manifest, COMMITTED last);
     ``resume`` / ``accept_migration`` re-enqueue drained records on this
     or another engine (re-prefill: byte-identical greedy
     continuations); ``export_kv`` / ``release_requests`` /
     ``accept_migration(kv=)`` move a request's KV rows as bytes, checked
     by geometry and crc32, so the receiver computes only the tail span.
     ``attach_preemption`` drains on a latched SIGTERM. Drain-state tags
     and KV payloads follow JAX's schemas (``inference/schemas``): either
     package reads the other's.
  8. **Sharded serving** — tensor and expert parallelism over a
     ``torch.distributed`` group (``InferenceConfig.tensor_parallel`` /
     ``expert_parallel``, or ``mesh=``): each rank holds its shard of the
     weights and pools (``kv_heads / tp`` heads a rank; ``pool_bytes`` is
     per rank, ``pool_bytes_logical`` the whole pool) and the model
     reduces over the mesh. Rank 0 is the one controller, as JAX keeps
     one host state over its mesh: it runs the scheduler, allocator,
     prefix cache, deadlines, watchdog, drains and adapters, and every
     device call goes through one seam (``inference/seam``) that
     broadcasts it to the other ranks, which replay it on their shards in
     ``run_worker`` until rank 0's ``close()`` sends the stop. Only rank 0
     samples; its tokens travel in the next call. Drains record tp / ep
     and a resume at another degree is refused; a KV payload carries all
     kv heads (gathered to rank 0 on export, each rank's slice scattered
     on import), so payloads move between degrees.

Attention runs through the two hand-written CUDA kernels: the flash
forward in every whole-prompt prefill (a re-prefill after preemption,
resume or migration too), the paged decode kernel in every decode step
on a float pool. Prefill chunks, prefix-cache and KV-import tails, every
prefill of a LoRA-armed engine, verify steps and every decode step on an
int8 pool run plain torch ops, as JAX runs them on XLA (its kernel reads
float pools and single tokens only); ``decode_backend`` /
``backend_bench`` record which route the decode step takes and why. The
LoRA delta and the KV gather / scatter of the handoff are plain torch
ops (``index_select``, ``bmm``, ``index_copy_``), as JAX's are XLA ops
outside any Pallas kernel.

Round recovery (``round_retries``, 2 by default as in JAX): an error in a
round — a failed or hung dispatch (the watchdog raises
``DecodeDispatchHang`` when a round overruns ``dispatch_timeout_s``), a
kernel error, an injected fault — preempts every running request back to
the queue (host cursors are authoritative), drops the prefix cache and
zeroes the pools in place, then retries the round; the requests re-prefill,
so greedy streams continue token for token. The retry runs the same two
kernels: JAX's engine answers a ``BackendFault`` by swapping its Pallas
decode for an XLA gather mid-serve, and the port has no such second
path, so a ``BackendFault`` recovers like any other failure and
``degraded`` stays 0. Recovery cannot stop work already queued on the
card: a round thread the watchdog gave up on bails out at its next device
call (the recovery epoch), and whatever it issued before that writes the
old pools; only while such a thread is alive are fresh pools allocated,
and the old stay referenced until it returns (the card holds both
meanwhile). On a sharded engine recovery is one more seam call, so every
rank zeroes its pools; if the abandoned thread is stuck inside a seam
call (a collective that never completes), recovery gives up after
``dispatch_timeout_s`` and the hang reaches the caller. An error still
raised after the retries reaches the caller as raised (JAX wraps it in a
``RuntimeError``), and the engine refuses every later ``step()`` /
``run()``, naming it.

Fleet hooks: ``role`` (a ``prefill`` engine never runs a decode quantum:
its requests wait, first token committed, for the router's handoff),
``obs_meta`` (the heartbeat's rollup payload), the round-phase ring
(``phase_decomposition``, the ``serving_phase_stall`` event) and
per-request tracing (``request_trace`` / ``enable_request_trace``: host
clock spans only, no device sync; a drain or a handoff record carries the
request's trace context, drain-state v3). The fault seams of
``robustness/faults`` sit where JAX's do: ``serving_round_seam`` at the
top of each round attempt, ``dispatch_seam`` inside the watchdog guard.

Token/row bookkeeping (as in the JAX engine): ``req.cached_rows`` = KV rows
in the pool for the request. A (re-)prefill sets it to ``len(context)`` and
leaves the NEXT sampled token pending in the device token vector; each
decode step writes the pending token's row and samples a new pending
token. Host-side ``generated`` absorbs the pending chain at the round
boundary from the one token fetch.

What this port leaves out raises ``NotImplementedError`` naming its
ROADMAP item: a block-sparse model on a mesh (A10b). A block-sparse
model serves as JAX's does: its whole-prompt prefills run the block-sparse
kernel (B5) over the bucket, a multiple of the layout's block; its decode
steps and spans (chunked and warm prefills) attend densely. The port
samples from a ``torch.Generator`` where JAX folds a counter into a key:
a drain records the port's count of sampling calls as the schema's
``rng_counter``, and a migration keeps the larger of the two counts, as
JAX's does; only greedy streams carry over token for token.
"""

import collections
import contextlib
import dataclasses
import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.inference.kv_cache import (AdapterSlotPool,
                                                    BlockAllocator,
                                                    BlockPoolExhausted,
                                                    blocks_for,
                                                    kv_payload_nbytes,
                                                    pool_bytes)
from deepspeed_tpu_torch.inference.lora import (AdapterStore,
                                                adapter_pool_bytes,
                                                init_adapter_pool,
                                                shard_tables)
from deepspeed_tpu_torch.inference.prefix_cache import PrefixCache
from deepspeed_tpu_torch.inference.schemas import (DRAIN_STATE_VERSION,
                                                   KV_PAYLOAD_SCHEMA)
from deepspeed_tpu_torch.inference.scheduler import (AdmissionRejected,
                                                     Request,
                                                     RequestScheduler)
from deepspeed_tpu_torch.inference.seam import DeviceSeam
from deepspeed_tpu_torch.inference.spec_decode import (greedy_accept_len,
                                                       make_proposer)
from deepspeed_tpu_torch.models.transformer import paged_cache_logical_axes
from deepspeed_tpu_torch.monitor.monitor import JSONLMonitor
from deepspeed_tpu_torch.parallel.context import all_reduce, parallel_context
from deepspeed_tpu_torch.parallel.partitioning import (shard_leaf,
                                                       sharded_bytes,
                                                       spec_tree)
from deepspeed_tpu_torch.robustness import events as rb_events
from deepspeed_tpu_torch.robustness import faults as rb_faults
from deepspeed_tpu_torch.robustness import integrity
from deepspeed_tpu_torch.robustness.preemption import Preempted
from deepspeed_tpu_torch.telemetry.exposition import (DEFAULT_EDGES_MS,
                                                      Histogram)
from deepspeed_tpu_torch.telemetry.request_trace import (RequestTracer,
                                                         merge_chrome_trace)


class DecodeDispatchHang(RuntimeError):
    """The watchdog timed out a decode round: the dispatch (or its token
    fetch) never came back within ``dispatch_timeout_s``."""


class ResumeIncompatible(ValueError):
    """A drained request (or a whole foreign drain, or a KV payload)
    cannot be restored on THIS engine: its context cap, adapter
    registration, geometry or payload does not fit. Typed so a migration
    can try the next engine (or the re-prefill path) instead of
    corrupting — past the table width the growth clamp would silently
    overwrite the last block."""


def load_drain_state(save_dir: str, tag: Optional[str] = None
                     ) -> Dict[str, Any]:
    """Read a serving drain snapshot through the integrity chain.
    ``tag=None`` resolves the newest tag under ``save_dir`` that passes
    integrity validation — a torn drain is skipped, not loaded; an
    explicit tag is validated and refused loudly when torn. Returns the
    state dict with ``"tag"`` added."""
    if tag is None:
        tag = integrity.newest_valid_tag(save_dir)
        if tag is None:
            raise FileNotFoundError(
                f"no integrity-valid serving drain tag under {save_dir}")
    tag_dir = os.path.join(save_dir, tag)
    ok, reason = integrity.validate_tag(tag_dir)
    if not ok:
        raise ValueError(
            f"serving drain tag '{tag}' failed integrity: {reason}")
    with open(os.path.join(tag_dir, "state.json")) as f:
        state = json.load(f)
    state["tag"] = tag
    return state


def kv_payload_crc(data: Dict[str, Any]) -> int:
    """crc32 of an exported KV payload's buffers, their raw bytes in
    key-sorted order (JAX's ``kv_payload_crc``: an f32 payload of either
    package checks in the other). A torn payload must be DETECTED at
    import and fall back to re-prefill — decoding garbage KV would emit
    wrong tokens silently."""
    crc = 0
    for name in sorted(data):
        # the buffer itself, not a bytes copy of it
        raw = np.ascontiguousarray(data[name]).view(np.uint8)
        crc = zlib.crc32(raw, crc)
    return crc


def _dtype_name(dtype: torch.dtype) -> str:
    """JAX's name for a pool dtype ("float32", "bfloat16", "int8")."""
    return str(dtype).rsplit(".", 1)[-1]


def _host_leaf(t: torch.Tensor) -> np.ndarray:
    """A pool slice as a host numpy array; bf16 (which numpy lacks)
    travels as its raw 2-byte view."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _device_leaf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A payload leaf back as a tensor of ``like``'s dtype and device:
    same-width raw views are reinterpreted (bf16 shipped as int16, or an
    ml_dtypes bfloat16 array from JAX), never converted."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind not in "biuf":
        arr = arr.view(f"i{arr.dtype.itemsize}")
    t = torch.from_numpy(arr)
    if t.dtype != like.dtype:
        t = t.view(like.dtype)
    return t.to(like.device)


@dataclasses.dataclass
class ServingConfig:
    """Knobs of the serving tier. ``num_blocks`` defaults to full
    residency — every slot can hold ``max_model_len`` tokens — plus the
    trash block; shrink it to oversubscribe (the scheduler queues and
    preempts instead of running out of memory)."""
    max_seqs: int = 8                  # concurrent sequences (slots)
    block_size: int = 64               # tokens per KV block
    num_blocks: Optional[int] = None   # pool blocks incl. trash block 0
    max_model_len: Optional[int] = None  # per-request context cap
    decode_quantum: int = 8            # decode steps per scheduling round
    temperature: float = 0.0           # 0 = greedy
    eos_token_id: Optional[int] = None
    # the decode backend: the port has one, the paged decode kernel (B4).
    # "auto" and "pallas" (JAX's name for its kernel) select it; "xla",
    # JAX's gather path, is refused: it would serve the card through a
    # plain path
    decode_backend: str = "auto"
    prompt_bucket: int = 64            # prompt pad granularity
    # --- reliability tier (all off by default) -------------------------
    # default per-request deadlines (ms from submit; add_request overrides
    # per request); a missed request is cancelled at a round boundary
    ttft_deadline_ms: Optional[float] = None
    deadline_ms: Optional[float] = None
    # admission watermarks: queue-length cap and held-pool-fraction cap
    # ((0, 1]) past which add_request sheds with AdmissionRejected
    max_queue: Optional[int] = None
    pool_watermark: Optional[float] = None
    # a round (decode quantum + token fetch) longer than this raises
    # DecodeDispatchHang, which recovery handles; None = no watchdog
    dispatch_timeout_s: Optional[float] = None
    # round recovery attempts (preempt all, zeroed pools, retry) before a
    # round's error reaches the caller
    round_retries: int = 2
    telemetry_jsonl: Optional[str] = None   # robustness events sink
    # --- latency tier (all off by default) -----------------------------
    enable_prefix_cache: bool = False
    prefix_cache_blocks: Optional[int] = None   # cache-held block cap
    # per-round token budget shared by prefill chunks and the decode
    # quantum's reservation; None = whole-prompt prefill at admission
    prefill_token_budget: Optional[int] = None
    # speculative decoding (greedy only): K proposals verified per round
    # in one span pass; 0 = off. The proposer is the self-drafting n-gram
    # lookup unless spec_proposer, a callable (context, k) -> ids, is set
    spec_tokens: int = 0
    spec_ngram: int = 3
    spec_proposer: Optional[Any] = None
    # --- multi-LoRA serving (0 = off) ----------------------------------
    # device adapter slot pool size INCLUDING the reserved all-zero null
    # slot 0 (base-model requests index it); registered adapters page in
    # on demand, LRU-evicted under slot pressure
    adapter_slots: int = 0
    lora_rank: int = 0                 # shared by all adapters (one shape)
    lora_targets: tuple = ("q", "k", "v", "o")
    # --- fleet ---------------------------------------------------------
    # per-request tracing: host-clock spans only (no device sync; streams
    # are bit-identical traced or not). enable_request_trace() arms a
    # warm engine
    request_trace: bool = False
    trace_replica: str = "r0"          # process row in the merged trace
    trace_events: int = 65536          # tracer ring bound
    # the fleet tier this engine serves: a "prefill" engine prefills and
    # commits each request's first token but never runs a decode quantum
    # (the router hands its requests to a "decode" / "both" replica)
    role: str = "both"                 # prefill | decode | both

    def __post_init__(self):
        self.lora_targets = tuple(self.lora_targets)
        if self.role not in ("prefill", "decode", "both"):
            raise ValueError(f"role={self.role!r}: one of prefill | decode "
                             "| both")
        if self.decode_backend == "xla":
            raise ValueError(
                "decode_backend='xla': the port serves decode through the "
                "paged decode kernel only (no gather path on the card)")
        if self.decode_backend not in ("auto", "pallas"):
            raise ValueError(f"decode_backend={self.decode_backend!r}: "
                             "auto | pallas")


# JAX ServingConfig fields outside this port: (their default, why a value
# away from it is refused)
_DEFERRED = {
    # JAX times its two decode backends against each other at init
    "backend_bench_iters": (10, "the port has one decode backend, the "
                                "paged decode kernel: nothing to time"),
}


def serving_config(fields: Optional[Dict[str, Any]] = None) -> ServingConfig:
    """ServingConfig from JAX-style field names; a field of the JAX config
    that this port does not serve raises when set away from its default."""
    fields = dict(fields or {})
    for name, (default, why) in _DEFERRED.items():
        if name not in fields:
            continue
        value = fields.pop(name)
        if value != default:
            raise NotImplementedError(f"serving {name}={value!r}: {why}")
    return ServingConfig(**fields)


def _slots_or_null(aidx, like):
    """Each slot's adapter slot, or the null adapter's 0 for every slot
    (the seam of a sharded engine carries a tensor, never None)."""
    return (torch.zeros(like.shape, dtype=torch.long, device=like.device)
            if aidx is None else aidx)


# the seam's op codes: every device call of a round, the pools' rebuild
# of a round recovery, and the stop
(_STOP, _PREFILL, _SPAN, _DECODE, _FORK, _ADAPTER, _KV_IMPORT, _KV_EXPORT,
 _RECOVER) = range(9)


class _Abandoned(RuntimeError):
    """A round thread's device call after a recovery began: the thread
    the watchdog gave up on stops there instead of making it."""


class ServingEngine:
    """Continuous-batching server over an InferenceEngine's params.

    >>> srv = init_serving(model, serving=dict(max_seqs=16))
    >>> outs = srv.run([(prompt_ids, 64), ...])   # {rid: output ids}
    >>> srv.stats()                               # TTFT p50/p99, tok/s

    On a mesh of more than one rank every rank builds the engine with the
    same arguments; rank 0 drives it (``run``, ``step``, ...) and the
    others call ``run_worker()``, which returns at rank 0's ``close()``.
    ``tp`` / ``ep`` are the engine's resolved degrees, recorded in drains
    and checked on resume.
    """

    def __init__(self, engine, config: Optional[ServingConfig] = None,
                 seed: int = 0):
        self.engine = engine
        self.config = c = config or ServingConfig()
        self.model = engine.model
        self.device = engine.device
        mcfg = self.model.config
        # the engine's resolved degrees (a dense model on an expert mesh
        # serves at ep = 1), as JAX's serving engine reads them
        self.mesh = engine.mesh
        _refuse_data_axis(self.mesh.plan)
        self.tp, self.ep = int(engine.tp), int(engine.ep)
        self.rank = self.mesh.rank
        self._seam = (DeviceSeam(self.mesh, self.device)
                      if self.mesh.world_size > 1 else None)
        self._stopped = False
        # close() gave up on a round: its thread sends the stop
        self._stop_pending = threading.Event()
        # one device call at a time on the seam: a round thread and the
        # recovery (or the stop) never interleave their broadcasts
        self._seam_lock = threading.RLock()
        # the round in flight: its recovery epoch and the pools it writes,
        # on the thread that runs it. A round thread the watchdog gave up
        # on stops at its next device call once a recovery moved the
        # epoch; until it returns, its closure keeps the old pools alive,
        # and whatever it queued runs on the caller's stream before any
        # later use of their memory
        self._local = threading.local()
        self._epoch = 0
        if c.block_size < 1 or c.decode_quantum < 1 or c.max_seqs < 1:
            raise ValueError(f"block_size={c.block_size}, decode_quantum="
                             f"{c.decode_quantum}, max_seqs={c.max_seqs}: "
                             "all must be >= 1")
        if c.pool_watermark is not None and not 0 < c.pool_watermark <= 1:
            raise ValueError(f"pool_watermark={c.pool_watermark}: a held-"
                             "pool fraction in (0, 1]")
        if c.prefill_token_budget is not None and c.prefill_token_budget < 1:
            raise ValueError(
                f"prefill_token_budget={c.prefill_token_budget}: a "
                "positive per-round token budget (None disables chunking)")
        if c.spec_tokens < 0:
            raise ValueError(f"spec_tokens={c.spec_tokens}: >= 0 "
                             "(0 disables speculation)")
        if c.spec_tokens > 0 and c.temperature:
            raise ValueError(
                f"spec_tokens={c.spec_tokens} with temperature="
                f"{c.temperature}: speculation is greedy-only (the accept "
                "rule's output-parity argument needs argmax sampling)")
        self._lora = c.adapter_slots > 0
        if self._lora:
            if c.adapter_slots < 2:
                raise ValueError(
                    f"adapter_slots={c.adapter_slots}: need >= 2 (slot 0 "
                    "is the reserved all-zero null adapter)")
            if c.lora_rank < 1:
                raise ValueError(
                    f"lora_rank={c.lora_rank}: adapter serving needs a "
                    "positive shared rank (one device pool shape)")
        model_cap = mcfg.max_seq_len
        want = int(c.max_model_len or model_cap or 2048)
        want = -(-want // c.block_size) * c.block_size
        if model_cap:
            # never admit positions the model can't represent: clamp DOWN
            # to the model cap, block-aligned
            want = min(want, (model_cap // c.block_size) * c.block_size)
        if want < c.block_size:
            raise ValueError(
                f"max_model_len/model max_seq_len ({c.max_model_len} / "
                f"{model_cap}) leaves no room for one "
                f"{c.block_size}-token block")
        self.max_model_len = want
        self.MB = self.max_model_len // c.block_size     # table width
        num_blocks = c.num_blocks or (c.max_seqs * self.MB + 1)
        if num_blocks - 1 < self.MB:
            raise ValueError(
                f"num_blocks={num_blocks}: one sequence at "
                f"max_model_len={self.max_model_len} needs {self.MB} "
                "blocks + the trash block")
        self.num_blocks = num_blocks
        # prompt buckets are block-aligned (prefill writes whole blocks)
        self._bucket = -(-max(c.prompt_bucket, c.block_size)
                         // c.block_size) * c.block_size
        self.allocator = BlockAllocator(num_blocks)
        self._prefix_cache = (PrefixCache(self.allocator, c.block_size,
                                          max_blocks=c.prefix_cache_blocks)
                              if c.enable_prefix_cache else None)
        # the scheduler's per-round row guarantee covers a verify step's
        # K + 1 writes as well as the decode quantum's
        self.scheduler = RequestScheduler(
            self.allocator, c.max_seqs, c.block_size,
            max(c.decode_quantum, c.spec_tokens + 1),
            prompt_blocks=lambda n: self._pad_prompt(n) // c.block_size,
            max_blocks_per_seq=self.MB, max_queue=c.max_queue,
            pool_watermark=c.pool_watermark,
            prefix_cache=self._prefix_cache)
        self._proposer = (make_proposer(c.spec_proposer, c.spec_ngram)
                          if c.spec_tokens > 0 else None)
        # int8 pools carry k_scale / v_scale beside k / v; a rank's pools
        # hold its kv_heads / tp heads
        with parallel_context(self.mesh):
            self.pools = self.model.init_paged_cache(
                num_blocks, c.block_size, dtype=engine.dtype,
                device=self.device)
        self._pool_specs = spec_tree(paged_cache_logical_axes(mcfg))
        # per rank (what this rank holds) and the whole pool: the memory
        # law is pool_bytes * tp == pool_bytes_logical
        self.pool_bytes = sharded_bytes(self.pools)
        self.pool_bytes_logical = pool_bytes(mcfg, num_blocks, c.block_size,
                                             dtype=engine.dtype)
        # the adapter slot pool: host refcount / LRU accounting, host
        # tables of every registered adapter, and the device pool that
        # page-ins write in place (allocated once: fixed addresses)
        self.adapter_store = self.adapter_slots = self.adapter_pool = None
        if self._lora:
            self.adapter_store = AdapterStore(mcfg, c.lora_rank,
                                              c.lora_targets)
            self.adapter_slots = AdapterSlotPool(c.adapter_slots)
            self.adapter_pool = init_adapter_pool(
                mcfg, c.adapter_slots, c.lora_rank, c.lora_targets,
                dtype=engine.dtype, device=self.device, mesh=self.mesh)
            self.pool_bytes += sharded_bytes(self.adapter_pool)
            self.pool_bytes_logical += adapter_pool_bytes(
                mcfg, c.adapter_slots, c.lora_rank, c.lora_targets,
                engine.dtype)
        self._tokens = torch.zeros((c.max_seqs,), dtype=torch.long,
                                   device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # sampling calls so far: a drain's rng_counter (JAX folds its
        # counter into the key; the port draws from _gen)
        self._rng_counter = 0
        self._requests: Dict[int, Request] = {}
        # host bytes of KV payloads in flight: exported and not yet
        # released, or imported and not yet scattered (priced in
        # stats()["pool_bytes"])
        self._kv_staging: Dict[int, int] = {}
        self._draining = False
        self._preemption = None            # attach_preemption()
        self._drain_dir: Optional[str] = None
        self._jsonl = (JSONLMonitor(c.telemetry_jsonl)
                       if c.telemetry_jsonl else None)
        # the watchdog arms once the decode quantum has run once (its
        # first round is warm-up time, not a hang)
        self._quantum_warm = False
        self._round_thread: Optional[threading.Thread] = None
        self._failed: Optional[BaseException] = None
        # the round-phase ring: one entry per round with the host ms of
        # each phase (schedule / housekeeping / prefill dispatch / decode
        # dispatch / token fetch / commit), a few perf_counter reads
        self._phases: "collections.deque[Dict[str, float]]" = \
            collections.deque(maxlen=256)
        self._round_tokens = 0
        self._tracer: Optional[RequestTracer] = None
        if c.request_trace:
            self.enable_request_trace(replica=c.trace_replica)
        self.decode_backend, self.backend_bench = self._select_backend()
        self.reset_stats()

    def _select_backend(self):
        """The decode route and why, as JAX's ``_select_backend`` records
        it (and its ``decode_backend_selected`` event): an int8 pool reads
        the gathered view in plain torch ops ("xla", JAX's name for that
        route), whatever ``decode_backend`` asks; a float pool runs the
        paged decode kernel, the port's one kernel backend ("pallas")."""
        forced = self.config.decode_backend
        if self.model.config.kv_cache_bits == 8:
            unavailable = "int8 KV pool (fused-dequant XLA read)"
            bench = {"backend": "xla",
                     "reason": (f"pallas unavailable ({unavailable})"
                                if forced == "pallas" else unavailable)}
        else:
            bench = {"backend": "pallas",
                     "reason": ("forced by config" if forced == "pallas"
                                else "the paged decode kernel: the port's "
                                     "one decode backend")}
        rb_events.emit("decode_backend_selected", **bench)
        return bench["backend"], bench

    # ---- fleet observability -----------------------------------------

    def enable_request_trace(self, replica: Optional[str] = None,
                             on_span=None) -> RequestTracer:
        """Arm per-request tracing on a (possibly warm) engine: host-clock
        spans only, so streams stay bit-identical. Returns the tracer
        (``on_span`` is its per-span hook)."""
        self._tracer = RequestTracer(
            replica=replica or self.config.trace_replica,
            max_events=self.config.trace_events, on_span=on_span)
        return self._tracer

    def disable_request_trace(self) -> None:
        self._tracer = None

    @property
    def tracer(self) -> Optional[RequestTracer]:
        return self._tracer

    def _rspan(self, rid: int, name: str, **args):
        """A span of request ``rid`` (a no-op context without tracing)."""
        if self._tracer is None:
            return contextlib.nullcontext()
        return self._tracer.span(rid, name, **args)

    def export_trace(self, path: Optional[str] = None):
        """This replica's trace stream (``RequestTracer.export``); with
        ``path``, also written as Chrome-trace JSON. Several replicas
        merge through ``telemetry.merge_chrome_trace``."""
        if self._tracer is None:
            return None
        stream = self._tracer.export()
        if path:
            merge_chrome_trace([stream], path=path)
        return stream

    def phase_decomposition(self) -> Dict[str, float]:
        """The round-phase ring summed over the stats window: host ms per
        phase, rounds, tokens, and the tracer's self-reported syncs."""
        out: Dict[str, float] = {
            "serve_rounds": float(len(self._phases)),
            "serve_schedule_ms": 0.0, "serve_housekeeping_ms": 0.0,
            "serve_prefill_dispatch_ms": 0.0,
            "serve_decode_dispatch_ms": 0.0, "serve_fetch_ms": 0.0,
            "serve_commit_ms": 0.0, "serve_round_ms": 0.0,
            "serve_tokens": 0.0,
            "serve_phase_stall_events": float(self._phase_stall_events),
            "trace_armed": float(self._tracer is not None),
            "trace_device_syncs": float(self._tracer.device_syncs
                                        if self._tracer else 0),
        }
        for entry in self._phases:
            out["serve_schedule_ms"] += entry["schedule_ms"]
            out["serve_housekeeping_ms"] += entry["housekeeping_ms"]
            out["serve_prefill_dispatch_ms"] += entry["prefill_ms"]
            out["serve_decode_dispatch_ms"] += entry["decode_ms"]
            out["serve_fetch_ms"] += entry["fetch_ms"]
            out["serve_commit_ms"] += entry["commit_ms"]
            out["serve_round_ms"] += entry["round_ms"]
            out["serve_tokens"] += entry["tokens"]
        return {k: (round(v, 3) if k.endswith("_ms") else v)
                for k, v in out.items()}

    # a phase must be both absolutely slow and dominant, in a warm
    # engine, before the stall event fires
    _STALL_MIN_ROUND_MS = 50.0
    _STALL_FRACTION = 0.6

    def _note_phases(self, entry: Dict[str, float]) -> None:
        """Append one round's phases; emit (at most once a stats window)
        ``serving_phase_stall`` when a non-fetch phase takes most of a
        round that ran 3x the window's median with >= 8 warm rounds
        before it. The fetch is exempt: the round's one sync waits on the
        device by design."""
        self._phases.append(entry)
        if (not self._quantum_warm or self._phase_stall_events
                or len(self._phases) < 9
                or entry["round_ms"] < self._STALL_MIN_ROUND_MS):
            return
        prior = sorted(e["round_ms"] for e in list(self._phases)[:-1])
        if entry["round_ms"] < 3.0 * max(prior[len(prior) // 2], 1e-9):
            return
        for phase in ("schedule", "housekeeping", "prefill", "decode",
                      "commit"):
            ms = entry[f"{phase}_ms"]
            if ms > self._STALL_FRACTION * entry["round_ms"]:
                self._phase_stall_events += 1
                rb_events.emit("serving_phase_stall", phase=phase,
                               phase_ms=round(ms, 2),
                               round_ms=round(entry["round_ms"], 2))
                break

    def obs_meta(self) -> Dict[str, Any]:
        """The heartbeat's rollup payload: mergeable fixed-edge TTFT and
        ITL histograms over this stats window and the occupancy gauges.
        A dead replica's last heartbeat keeps its final numbers."""
        ttft = Histogram(DEFAULT_EDGES_MS)
        ttft.observe_many((r.first_token_t - r.submit_t) * 1e3
                          for r in self._finished
                          if r.first_token_t is not None)
        itl = Histogram(DEFAULT_EDGES_MS)
        itl.observe_many(self._itl_ms)
        meta: Dict[str, Any] = {
            "ttft_ms_hist": ttft.to_dict(),
            "itl_ms_hist": itl.to_dict(),
            "pool_occupancy": round(float(self.allocator.used_fraction), 4),
            "completed": len(self._finished),
            "cancelled": len(self._cancelled),
            "generated_tokens": sum(len(r.generated)
                                    for r in self._finished),
        }
        if self._lora:
            usable = max(1, self.adapter_slots.num_slots - 1)
            meta["adapter_occupancy"] = round(
                self.adapter_slots.resident / usable, 4)
            meta["adapter_page_ins"] = self.adapter_slots.page_ins
        return meta

    # ---- the seam: every device call, on every rank -------------------

    def _call(self, op: int, ints=(), tensors=()):
        """Make one device call: on a mesh, rank 0 first broadcasts it
        (``inference/seam``) so every rank makes it on its shards. A round
        thread whose round a recovery abandoned raises ``_Abandoned``
        here instead of calling."""
        if self._seam is None:
            self._check_epoch()
            return self._OPS[op](self, list(ints), list(tensors))
        if self.rank != 0:
            raise RuntimeError("only rank 0 drives a sharded serving "
                               "engine; the other ranks run_worker()")
        with self._seam_lock:
            if self._stop_pending.is_set():
                # close() gave up on this round: stop the other ranks
                # here, between two calls, instead of making this one
                self._send_stop()
                raise RuntimeError("the serving engine is closed")
            self._check_epoch()
            self._seam.send(op, ints, tensors)
            with parallel_context(self.mesh):
                return self._OPS[op](self, list(ints), list(tensors))

    def _check_epoch(self) -> None:
        epoch = getattr(self._local, "epoch", None)
        if epoch is not None and epoch != self._epoch:
            raise _Abandoned("round abandoned by a recovery")

    @property
    def _pools(self):
        """The pools this thread's device calls read and write: the
        round's own (bound when it started) inside a round, else the
        engine's."""
        return getattr(self._local, "pools", None) or self.pools

    def _send_stop(self) -> None:
        """Send the other ranks the stop, once: their ``run_worker``
        returns."""
        with self._seam_lock:
            if self._seam is not None and self.rank == 0 \
                    and not self._stopped:
                self._stopped = True
                self._seam.send(_STOP)

    def run_worker(self) -> None:
        """A rank > 0's part of a sharded engine: replay rank 0's device
        calls on this rank's shards until rank 0's ``close()``."""
        if self._seam is None or self.rank == 0:
            raise RuntimeError("run_worker() is for the ranks > 0 of a "
                               "sharded serving engine")
        while True:
            op, ints, tensors = self._seam.recv()
            if op == _STOP:
                with self._seam_lock:
                    self._stopped = True
                return
            with parallel_context(self.mesh):
                self._OPS[op](self, ints, tensors)

    def _op_prefill(self, ints, t):
        ids, block_ids = t
        return self.model.prefill_paged(self.engine.params, ids, self._pools,
                                        block_ids, length=ints[0])

    def _op_span(self, ints, t):
        tokens, tables, lens, active, n_rows, aidx = t
        return self.model.decode_span_paged(
            self.engine.params, tokens, self._pools, tables, lens,
            active=active, n_rows=n_rows, lora=self._lora_args(aidx))

    def _op_decode(self, ints, t):
        tokens, tables, lens, active, aidx = t
        return self.model.decode_step_paged(
            self.engine.params, tokens, self._pools, tables, lens,
            active=active, lora=self._lora_args(aidx))

    def _op_fork(self, ints, t):
        src, dst = ints
        for pool in self._pools.values():
            pool[:, dst] = pool[:, src]

    def _op_adapter(self, ints, t):
        """Page one adapter's tables (whole, f32, in target order) into
        slot ``ints[0]``: this rank's slice, in place."""
        at = torch.tensor([ints[0]], dtype=torch.long, device=self.device)
        targets = self.config.lora_targets
        tabs = {proj: {"a": t[2 * i], "b": t[2 * i + 1]}
                for i, proj in enumerate(targets)}
        for proj, ab in shard_tables(tabs, targets, self.mesh).items():
            for name, src in ab.items():
                dst = self.adapter_pool[proj][name]
                dst.index_copy_(1, at, src.to(dst.dtype)[:, None])

    def _op_kv_import(self, ints, t):
        """Scatter a payload's leaves (all kv heads, in pool order) into
        blocks ``t[0]``: this rank's heads."""
        ids = t[0]
        for (name, pool), leaf in zip(self._pools.items(), t[1:]):
            part = shard_leaf(leaf, self._pool_specs[name], self.mesh, name)
            pool.index_copy_(1, ids, part)

    def _op_kv_export(self, ints, t):
        """Blocks ``t[0]`` of every pool with all kv heads: this rank's
        heads in a zero-filled buffer at its offset, summed over the
        tensor axis as raw bytes (one non-zero term a byte: exact)."""
        ids = t[0]
        out = {}
        for name, pool in self._pools.items():
            part = pool.index_select(1, ids)
            if self.tp > 1:
                n = part.shape[2]
                shape = list(part.shape)
                shape[2] *= self.tp
                full = part.new_zeros(shape)
                i = self.mesh.index("tensor")
                full[:, :, i * n:(i + 1) * n] = part
                all_reduce(full.view(torch.uint8), "tensor")
                part = full
            out[name] = part
        return out

    def _op_recover(self, ints, t):
        """This rank's pools zeroed in place, as fresh ones are: what was
        queued before runs first on the stream, and the card never holds
        a second pool. Only while a round thread the watchdog gave up on
        is still alive (rank 0's; it may still be issuing into the old
        pools) are fresh ones allocated, and the thread's closure holds
        the old until it returns."""
        t = self._round_thread
        if t is None or not t.is_alive():
            for pool in self.pools.values():
                pool.zero_()
            return
        with parallel_context(self.mesh):
            self.pools = self.model.init_paged_cache(
                self.num_blocks, self.config.block_size,
                dtype=self.engine.dtype, device=self.device)

    _OPS = {_PREFILL: _op_prefill, _SPAN: _op_span, _DECODE: _op_decode,
            _FORK: _op_fork, _ADAPTER: _op_adapter,
            _KV_IMPORT: _op_kv_import, _KV_EXPORT: _op_kv_export,
            _RECOVER: _op_recover}

    # ---- device programs ---------------------------------------------

    def _pad_prompt(self, n: int) -> int:
        return max(self._bucket,
                   min(-(-n // self._bucket) * self._bucket,
                       self.max_model_len))

    def _pad_chunk(self, n: int) -> int:
        bs = self.config.block_size
        return -(-n // bs) * bs

    def _sample(self, logits):
        """[S, V] f32 logits -> [S] token ids, counted in
        ``_rng_counter``."""
        self._rng_counter += 1
        return self._draw(logits)

    def _draw(self, logits):
        """``_sample`` without the count: a round thread touches no host
        state (the round counts its decode quantum's draws). Greedy ties
        take the first index, as jnp.argmax does."""
        t = self.config.temperature
        if t and t > 0:
            probs = torch.softmax(logits / t, dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    def _dispatch_prefill(self, req: Request) -> None:
        """Dispatch (no sync) the request's whole-context (re-)prefill
        through the flash kernel: writes its context rows into its blocks
        and leaves the next sampled token pending in the device token
        vector and on the request, fetched at the round boundary."""
        ctx = req.context
        P = self._pad_prompt(ctx.size)
        buf = np.zeros((1, P), np.int64)
        buf[0, :ctx.size] = ctx
        nblk = P // self.config.block_size
        block_ids = torch.as_tensor(req.block_ids[:nblk], dtype=torch.long)
        last = self._call(_PREFILL, (ctx.size,),
                          (torch.from_numpy(buf).to(self.device),
                           block_ids.to(self.device)))
        self._dispatches["prefills"] += 1
        req.cached_rows = ctx.size
        self._publish_prefill(req, ctx)
        self._set_first(req, self._sample(last))

    def _dispatch_chunk(self, req: Request, start: int, n: int) -> None:
        """Dispatch (no sync) one prefill chunk on the span path: rows
        ``[start, start + n)`` of the request's context computed against
        the rows already in its blocks (an earlier chunk or a prefix-cache
        hit), pad rows to the trash block. The final chunk samples the
        request's first token (the whole-prompt prefill's protocol)."""
        ctx = req.context
        C = self._pad_chunk(n)
        buf = np.zeros((1, C), np.int64)
        buf[0, :n] = ctx[start:start + n]
        tab = np.zeros((1, self.MB), np.int32)
        tab[0, :len(req.block_ids)] = req.block_ids
        dev = self.device
        aidx = torch.tensor([req.adapter_slot or 0], dtype=torch.long,
                            device=dev)
        logits = self._call(_SPAN, (), (
            torch.from_numpy(buf).to(dev), torch.from_numpy(tab).to(dev),
            torch.tensor([start], dtype=torch.int32, device=dev),
            torch.ones((1,), dtype=torch.bool, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev), aidx))
        req.cached_rows = start + n
        self._lat["prefill_chunks"] += 1
        self._lat["prefill_chunk_tokens"] += n
        self._publish_prefill(req, ctx)        # full blocks so far
        if start + n == ctx.size:
            self._set_first(req, self._sample(logits[0, n - 1][None]))

    def _set_first(self, req: Request, first) -> None:
        self._tokens[req.slot] = first[0]
        req.prefill_done = True
        req._first_dev = first                 # fetched at round boundary

    def _publish_prefill(self, req: Request, ctx) -> None:
        """Index a prefill's FULL blocks in the prefix cache as soon as
        they are dispatched: appends only write past them, so tenants with
        the same prefix share them while this request still runs (every
        later dispatch reads the pools in stream order). The partial
        boundary block waits for ``finish`` (its owner still appends).
        Adapter KV is adapter-specific: never published under the
        content-only hash."""
        if self._prefix_cache is not None and not req.adapter_id:
            self._prefix_cache.insert_full(ctx, req.block_ids,
                                           req.cached_rows)

    def _dispatch_fork(self, req: Request) -> None:
        """Copy-on-write fork (dispatch, no sync): the shared boundary
        block a prefix-cache match reached into is copied, every layer's K
        and V, to the fresh block the scheduler put at the same table
        index, then the match's pin on the shared block is dropped. Runs
        before any of the request's own writes."""
        src, dst = req.cow_src, req.cow_dst
        self._call(_FORK, (src, dst))
        self.allocator.free([src], owner=req.rid)
        req.cow_src = req.cow_dst = None
        self._lat["cow_forks"] += 1

    def _tables_device(self):
        """Block tables, lengths, the decoding mask and each slot's
        adapter slot (0, the null adapter, for free slots and base-model
        requests), on the device."""
        S = self.config.max_seqs
        ids = np.zeros((S, self.MB), np.int32)
        lens = np.zeros((S,), np.int32)
        act = np.zeros((S,), bool)
        aidx = np.zeros((S,), np.int64)
        for req in self.scheduler.running:
            ids[req.slot, :len(req.block_ids)] = req.block_ids
            lens[req.slot] = req.cached_rows
            # a request still prefilling (chunks landing) holds its slot
            # but does not decode yet
            act[req.slot] = req.prefill_done
            aidx[req.slot] = req.adapter_slot or 0
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (ids, lens, act, aidx))

    def _lora_args(self, aidx):
        """The model's ``lora`` argument: the slot pool and the per-row
        adapter slots (None without LoRA)."""
        return (self.adapter_pool, aidx) if self._lora else None

    def _quantum(self, tokens, tables, seq_lens, active, aidx=None
                 ) -> List[torch.Tensor]:
        """``decode_quantum`` decode steps of every slot, dispatched back
        to back from ``tokens``; returns each step's sampled tokens (still
        on device). Touches no engine state but the pools."""
        lens = seq_lens
        step = active.to(torch.int32)
        if self._seam is not None:
            aidx = _slots_or_null(aidx, seq_lens)
        outs = []
        for _ in range(self.config.decode_quantum):
            logits = self._call(_DECODE, (),
                                (tokens, tables, lens, active, aidx))
            tokens = torch.where(active, self._draw(logits), tokens)
            lens = lens + step
            outs.append(tokens)
        return outs

    def _spec_step(self, tok_mat, tables, seq_lens, active, aidx=None):
        """The speculation verify step (dispatch, no sync): ONE
        ``decode_span_paged`` pass over the pending token plus the K
        proposals of every slot, the greedy accept rule on the device, and
        each slot's next pending token and cursor (accepted + 1 rows).
        Rows written for rejected proposals stay behind the cursor until
        overwritten. Returns (argmax [S, K+1], accepted [S], pending [S],
        new lengths [S])."""
        n_rows = torch.full_like(seq_lens, tok_mat.shape[1])
        if self._seam is not None:
            aidx = _slots_or_null(aidx, seq_lens)
        logits = self._call(_SPAN, (), (tok_mat, tables, seq_lens, active,
                                        n_rows, aidx))
        nxt = torch.argmax(logits, dim=-1)
        acc = greedy_accept_len(nxt, tok_mat[:, 1:])
        pend = nxt.gather(1, acc[:, None])[:, 0]
        pend = torch.where(active, pend, tok_mat[:, 0])
        lens = seq_lens + torch.where(active, acc + 1,
                                      torch.zeros_like(acc)).to(
                                          seq_lens.dtype)
        return nxt, acc, pend, lens

    def _proposals_device(self) -> torch.Tensor:
        """Host-side drafting: one proposal row per decoding slot (the
        n-gram lookup or the draft hook), padded to K with zeros (pads
        verify as ordinary wrong guesses). Returns [S, K] on the device;
        the pending-token column joins it there, so the round keeps its
        one host sync."""
        c = self.config
        props = np.zeros((c.max_seqs, c.spec_tokens), np.int64)
        for req in self.scheduler.running:
            if not req.prefill_done:
                continue
            got = np.asarray(self._proposer(req.context, c.spec_tokens),
                             np.int64).reshape(-1)[:c.spec_tokens]
            props[req.slot, :got.size] = got
        return torch.from_numpy(props).to(self.device)

    # ---- request API -------------------------------------------------

    def register_adapter(self, adapter_id: int, tables,
                         alpha: Optional[float] = None) -> None:
        """Register a LoRA adapter's host A/B stacks (``{proj: (A [L, In,
        r], B [L, r, Out])}``) under ``adapter_id``; requests can route to
        it at once. ``alpha``: PEFT scaling, folded into B at registration
        (None = tables already scaled). Host RAM only — the device slot
        pool pages it in on first demand."""
        if not self._lora:
            raise ValueError("adapter_slots=0: LoRA serving is off — set "
                             "ServingConfig.adapter_slots/lora_rank")
        self.adapter_store.register(adapter_id, tables, alpha=alpha)

    def _acquire_adapter(self, req: Request) -> bool:
        """Pin the request's adapter to a device slot, paging it in on a
        miss: its tables are copied in place into the slot
        (``index_copy_``; the pool is never reallocated). False = every
        slot is pinned by other in-flight adapters: the caller bounces the
        request back to the queue instead of failing the round."""
        if not self._lora or req.adapter_id == 0:
            req.adapter_slot = 0 if self._lora else None
            return True
        try:
            slot, page_in = self.adapter_slots.acquire(req.adapter_id)
        except BlockPoolExhausted:
            return False
        req.adapter_slot = slot
        if page_in:
            with self._rspan(req.rid, "adapter_page_in",
                             adapter=req.adapter_id, slot=int(slot)):
                tabs = self.adapter_store.table_for_slot(req.adapter_id)
                self._call(_ADAPTER, (slot,), [
                    torch.from_numpy(tabs[proj][name]).to(self.device)
                    for proj in self.config.lora_targets
                    for name in ("a", "b")])
        return True

    def _release_adapter(self, req: Request) -> None:
        """Drop the request's pin when it leaves the running set (finish /
        cancel / preempt / release). The slot stays resident at refcount
        0 — the next request for the same adapter is a hit. A second
        release of the same request is a no-op (the slot is cleared)."""
        if self._lora and req.adapter_id and req.adapter_slot is not None:
            self.adapter_slots.release(req.adapter_id, owner=req.rid)
        req.adapter_slot = None

    def add_request(self, prompt_ids, max_new_tokens: int = 64,
                    request_id: Optional[int] = None,
                    ttft_deadline_ms: Optional[float] = None,
                    deadline_ms: Optional[float] = None,
                    adapter_id: int = 0) -> int:
        """Submit one request. The deadlines override the config's for
        this request. ``adapter_id`` routes it through a registered LoRA
        adapter (0 = base model); an unknown id refuses here, not at
        dispatch. Raises ``AdmissionRejected`` when a watermark sheds it
        or the engine is draining: counted in ``stats()["shed"]`` and
        evented, never silently queued."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if adapter_id:
            if not self._lora:
                raise ValueError(
                    f"adapter_id={adapter_id} with adapter_slots=0: "
                    "LoRA serving is off")
            if adapter_id not in self.adapter_store:
                raise ValueError(
                    f"adapter_id={adapter_id} is not registered "
                    "(register_adapter first)")
        if max_new_tokens < 1:
            # the prefill inherently samples one token
            raise ValueError(f"max_new_tokens={max_new_tokens}: must be "
                             ">= 1")
        if prompt.size + max_new_tokens > self.max_model_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_model_len "
                f"{self.max_model_len}")
        if self._draining:
            self._counters["shed"] += 1
            rb_events.emit("request_shed", reason="draining")
            raise AdmissionRejected("draining")
        c = self.config
        try:
            req = self.scheduler.submit(
                prompt, max_new_tokens, rid=request_id,
                ttft_deadline_ms=(ttft_deadline_ms
                                  if ttft_deadline_ms is not None
                                  else c.ttft_deadline_ms),
                deadline_ms=(deadline_ms if deadline_ms is not None
                             else c.deadline_ms),
                adapter_id=adapter_id)
        except AdmissionRejected as e:
            self._counters["shed"] += 1
            rb_events.emit("request_shed", reason=e.reason, **e.detail)
            raise
        self._requests[req.rid] = req
        if self._tracer is not None:
            self._tracer.begin(req.rid)
            self._tracer.instant(req.rid, "admitted",
                                 prompt_tokens=int(prompt.size),
                                 adapter=adapter_id)
        # the queue-wait clock: from here (or the latest preemption) to
        # the request's next admission
        req._trace_wait_t0 = req.submit_t
        if self._stats_t0 is None:
            self._stats_t0 = req.submit_t
        return req.rid

    def step(self) -> List[Request]:
        """One scheduling round: enforce deadlines; evict / admit /
        preempt at the boundary; the admitted requests' forks, then the
        prefills and prefill chunks, then one decode quantum and one token
        fetch; drain the events into the JSONL sink. Returns the requests
        finished this round. A round that fails recovers (every running
        request preempted, pools zeroed) and is retried up to
        ``round_retries`` times; an error that outlasts the retries
        reaches the caller as raised and the engine refuses every later
        round. A latched SIGTERM (``attach_preemption``) drains the engine
        first and raises ``Preempted``."""
        if self._preemption is not None and self._preemption.requested:
            path = self.drain(self._drain_dir)
            raise Preempted("serving engine drained on SIGTERM",
                            ckpt_path=path)
        if self._failed is not None:
            raise RuntimeError(
                "serving engine failed in an earlier round ("
                f"{type(self._failed).__name__}: {self._failed}) after "
                f"{self.config.round_retries} recovery retries: build a "
                "new engine") from self._failed
        try:
            self._enforce_deadlines()
            for attempt in range(max(0, self.config.round_retries) + 1):
                try:
                    return self._round()
                except (Preempted, KeyboardInterrupt):
                    raise
                except Exception as e:  # noqa: BLE001 — any round failure
                    # (injected or real): preempt-all and zeroed pools make
                    # the retry re-prefill from the host cursors
                    recovered = self._recover(
                        "backend_fault"
                        if isinstance(e, rb_faults.BackendFault)
                        else type(e).__name__)
                    if not recovered \
                            or attempt == max(0, self.config.round_retries):
                        self._failed = e
                        raise
        finally:
            self._drain_events()

    def _round(self) -> List[Request]:
        # the phase ring: host perf_counter reads only
        t_round0 = time.perf_counter()
        self._round_tokens = 0
        ph = {"schedule_ms": 0.0, "housekeeping_ms": 0.0, "prefill_ms": 0.0,
              "decode_ms": 0.0, "fetch_ms": 0.0, "commit_ms": 0.0}
        info = rb_faults.serving_round_seam()
        keep = info.get("squeeze")
        if keep is not None:
            # pool_exhaust storm: hide all but `keep` free blocks for this
            # round, so the scheduler queues and preempts under a real
            # exhaustion; the reserve lifts at the end of the round
            self.allocator.set_reserve(
                max(0, self.allocator.free_blocks - int(keep)))
        try:
            out = self._round_body(ph, t_round0)
        finally:
            if keep is not None:
                self.allocator.set_reserve(0)
        if out is None:
            return []
        pending, commit = out
        t0 = time.perf_counter()
        finished = commit()
        ph["commit_ms"] = (time.perf_counter() - t0) * 1e3
        ph["round_ms"] = (time.perf_counter() - t_round0) * 1e3
        self._note_phases({**ph, "tokens": float(self._round_tokens)})
        if self._tracer is not None:
            for req in finished:
                self._tracer.instant(req.rid, "finish",
                                     tokens=len(req.generated))
                self._tracer.end(req.rid)
        return finished

    def _round_body(self, ph, t_round0):
        """Schedule, dispatch and fetch one round; returns (pending first
        tokens, the commit) or None when nothing runs."""
        t0 = time.perf_counter()
        decisions = self.scheduler.schedule(
            token_budget=self.config.prefill_token_budget)
        ph["schedule_ms"] = (time.perf_counter() - t0) * 1e3
        if self._tracer is not None:
            now = time.perf_counter()
            for req in decisions["preempted"]:
                self._tracer.instant(req.rid, "preempted",
                                     preemptions=req.preemptions)
                req._trace_wait_t0 = now        # queue wait restarts
            for req in decisions["admitted"]:
                # begin() is idempotent; restored or migrated requests
                # that never passed add_request get their id here
                self._tracer.begin(req.rid)
                w0 = getattr(req, "_trace_wait_t0", req.submit_t)
                self._tracer.add_span(
                    req.rid, "queue_wait", self._tracer.epoch(w0),
                    self._tracer.epoch(now), preemptions=req.preemptions)
        t0 = time.perf_counter()
        if self._lora:
            # adapter pins track the running set: the scheduler's victims
            # drop theirs first (their slots become LRU candidates), then
            # each admission pins; an admission that finds every slot
            # pinned bounces back to the queue head
            for req in decisions["preempted"]:
                self._release_adapter(req)
            for req in decisions["admitted"]:
                if not self._acquire_adapter(req):
                    self.scheduler.preempt(req)
                    self._drop_kv_payload(req)
                    rb_events.emit("adapter_slots_exhausted", rid=req.rid,
                                   adapter=req.adapter_id)
        for req in decisions["preempted"]:
            # an eviction drops an unscattered import payload: the
            # re-admission recomputes (the scheduler zeroed kv_rows)
            self._drop_kv_payload(req)
        for req in decisions["admitted"]:
            if req.state != "running":
                continue                    # bounced by the adapter pin
            if req.cow_src is not None:
                # the fork runs before any of the request's own writes
                # can reach the shared boundary block
                self._dispatch_fork(req)
            if getattr(req, "_kv_payload", None) is not None:
                # imported KV bytes land in the admission's fresh blocks
                # before the tail span below reads them
                with self._rspan(req.rid, "kv_import",
                                 rows=int(req.kv_rows)):
                    self._dispatch_kv_import(req)
        ph["housekeeping_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for req, start, n in decisions["prefill"]:
            if req.state != "running":
                continue
            if start == 0 and n == len(req.context) and not self._lora:
                with self._rspan(req.rid, "prefill", tokens=int(n),
                                 reprefill=req.preemptions > 0):
                    self._dispatch_prefill(req)     # whole prompt: B1
            else:
                # chunks, cache and import tails, and every prefill of a
                # LoRA-armed engine (the span path carries the delta)
                with self._rspan(req.rid, "prefill_chunk",
                                 start=int(start), tokens=int(n)):
                    self._dispatch_chunk(req, start, n)
        ph["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        running = self.scheduler.running
        if not running:
            ph["round_ms"] = (time.perf_counter() - t_round0) * 1e3
            self._note_phases({**ph, "tokens": 0.0})
            return None
        t_dec0 = time.perf_counter()
        pending = [(req, req._first_dev) for req in running
                   if getattr(req, "_first_dev", None) is not None]
        # a prefill-role engine never runs a decode quantum: its requests
        # wait, first token committed, for the router's handoff
        decode = (self.config.role != "prefill"
                  and any(r.prefill_done for r in running))
        # speculation: ONE verify step replaces the decode quantum
        spec = decode and self.config.spec_tokens > 0
        tables = self._tables_device() if decode else None
        tokens = self._tokens
        tok_mat = (torch.cat([tokens[:, None], self._proposals_device()],
                             dim=1) if spec else None)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        # sampling calls counted here, not on the round thread
        self._rng_counter += (self.config.decode_quantum
                              if decode and not spec else 0)
        epoch, pools = self._epoch, self.pools

        def quantum_and_fetch():
            # the round thread issues on the caller's stream (a thread's
            # current stream is its own), after the prefills in order;
            # its device calls carry this round's epoch and pools
            self._local.epoch, self._local.pools = epoch, pools
            try:
                # the fault seam lives INSIDE the watchdog guard: a hang
                # here is what the watchdog times out
                rb_faults.dispatch_seam()
                with self._on_stream(stream):
                    verdict = []
                    if spec:
                        nxt, acc, t, _ = self._spec_step(tok_mat, *tables)
                        outs, verdict = [], [nxt.reshape(-1), acc]
                    else:
                        outs = (self._quantum(tokens, *tables) if decode
                                else [])
                        t = outs[-1] if outs else tokens
                    tq1 = time.perf_counter()
                    # the ONE sync of the round: every decode step's tokens
                    # (or the verify step's argmaxes and accept lengths)
                    # and every pending first token in one copy
                    parts = ([o.reshape(-1) for o in outs] + verdict
                             + [f.reshape(-1) for _, f in pending])
                    host = (torch.cat(parts).cpu().numpy() if parts
                            else np.zeros((0,), np.int64))
                return t, host, len(outs), (tq1, time.perf_counter())
            finally:
                self._local.epoch = self._local.pools = None

        tokens, host, n_steps, (tq1, tq2) = self._with_watchdog(
            quantum_and_fetch, armed=self._quantum_warm)
        ph["decode_ms"] = (tq1 - t_dec0) * 1e3
        ph["fetch_ms"] = (tq2 - tq1) * 1e3
        if self._tracer is not None and decode:
            for req in running:
                if req.prefill_done:
                    self._tracer.add_span(
                        req.rid, "decode_quantum",
                        self._tracer.epoch(t_dec0), self._tracer.epoch(tq2),
                        steps=1 if spec else self.config.decode_quantum)
        self._tokens = tokens
        if decode:
            self._quantum_warm = True
            self._dispatches["decode_steps"] += n_steps
        S = self.config.max_seqs
        if spec:
            self._dispatches["verify_steps"] += 1
            K1 = self.config.spec_tokens + 1
            nxt = host[:S * K1].reshape(S, K1)
            acc = host[S * K1:S * K1 + S]
            return pending, lambda: self._commit_round(
                pending, host[S * K1 + S:], self._verified(nxt, acc))
        toks = host[:n_steps * S].reshape(n_steps, S)
        return pending, lambda: self._commit_round(
            pending, host[n_steps * S:],
            lambda req: (toks[:, req.slot], n_steps))

    @contextlib.contextmanager
    def _on_stream(self, stream):
        if stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            yield

    def _with_watchdog(self, fn, armed: bool = True):
        """Run ``fn`` on a thread and raise ``DecodeDispatchHang`` when it
        outlives ``dispatch_timeout_s`` (no timeout, or not armed: call it
        here). A thread the watchdog gives up on is left running: the
        recovery that follows moves the epoch, so it stops at its next
        device call, and what it issued before writes only the pools its
        round started with."""
        timeout = self.config.dispatch_timeout_s
        if not timeout or not armed:
            return fn()
        box: Dict[str, Any] = {}

        def run():
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 — relayed below
                box["error"] = e
            finally:
                if self._stop_pending.is_set():   # close() gave up on it
                    self._send_stop()

        t = threading.Thread(target=run, daemon=True, name="serving-round")
        self._round_thread = t
        t.start()
        t.join(timeout)
        if t.is_alive():
            raise DecodeDispatchHang(
                f"decode round exceeded dispatch_timeout_s={timeout}")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _recover(self, reason: str) -> bool:
        """Round recovery: every running request preempts back to the
        queue (prompt + generated, the host cursors, are authoritative),
        the prefix cache lets go of its blocks, and the pools are zeroed
        (``_RECOVER``, on every rank of a mesh); the requests re-prefill
        at their next admission, so greedy continuations are token for
        token the unfailed run's. Adapter slots are forgotten (each
        re-pins and pages in again into the same slot pool, which no
        round writes). The epoch moves first: a round thread the watchdog
        gave up on stops at its next device call. On a sharded engine
        that thread may be stuck inside a seam call (a collective that
        never completes) and hold the seam: recovery waits
        ``dispatch_timeout_s`` for it, then gives up and returns False
        (the caller latches the engine), so the watchdog still bounds
        the hang."""
        t0 = time.perf_counter()
        self._epoch += 1
        if not self._seam_lock.acquire(
                timeout=self.config.dispatch_timeout_s or -1):
            return False
        try:
            self.allocator.set_reserve(0)
            n = self.scheduler.preempt_all()
            for req in self._requests.values():
                req._first_dev = None
                req.adapter_slot = None
                if req.cow_src is not None:     # admitted, fork not run
                    self.scheduler._release_cow(req)
                if getattr(req, "_kv_payload", None) is not None \
                        and req.kv_rows == 0:
                    # preempt_all zeroed kv_rows before the import scattered:
                    # the re-admission recomputes (a still-waiting import
                    # keeps its rows and its payload)
                    self._drop_kv_payload(req)
            if self._lora:
                self.adapter_slots.reset()
            if self._prefix_cache is not None:
                self._prefix_cache.clear()
            self._tokens = torch.zeros_like(self._tokens)
            self._call(_RECOVER)
            ms = (time.perf_counter() - t0) * 1e3
            self._counters["recoveries"] += 1
            self._counters["recovery_ms"] += ms
            rb_events.emit("serving_recovered", reason=reason, preempted=n,
                           ms=round(ms, 2))
        finally:
            self._seam_lock.release()
        return True

    def _note_tokens(self, req: Request, m: int, now: float) -> None:
        """Inter-token latency: a burst of ``m`` tokens arriving ``gap``
        after the request's previous ones records m samples of gap/m. The
        first token starts the clock (it is TTFT's, not ITL's)."""
        if m <= 0:
            return
        self._round_tokens += m        # the phase ring's token count
        if req.last_token_t is not None:
            per_tok = (now - req.last_token_t) * 1e3 / m
            self._itl_ms.extend([per_tok] * m)
        req.last_token_t = now

    def _commit_round(self, pending, firsts, emitted) -> List[Request]:
        """Commit a round's fetched tokens: each request's pending first
        token, then, for each decoding request, ``emitted(req)`` = (its
        new tokens in order, the rows its cache grew by), cut at its
        budget or eos."""
        first_tok = {req.rid: int(f) for (req, _), f in zip(pending, firsts)}
        now = time.perf_counter()
        finished: List[Request] = []
        eos = self.config.eos_token_id
        for req in list(self.scheduler.running):
            got = 0
            if req.rid in first_tok:
                # prefill's pending token: its KV row was written by the
                # quantum's step 0, so it is part of the sequence now
                self._append(req, first_tok[req.rid], eos)
                req._first_dev = None
                got += 1
                if req.first_token_t is None:
                    req.first_token_t = now
            if not req.prefill_done:
                # chunked prompt still landing: the quantum skipped it
                self._note_tokens(req, got, now)
                continue
            new, rows = emitted(req)
            for tok in new:
                if self._done(req):
                    break
                self._append(req, int(tok), eos)
                got += 1
            req.cached_rows += rows
            self._note_tokens(req, got, now)
            if self._done(req):
                self.scheduler.finish(req)
                self._release_adapter(req)
                self._finished.append(req)
                finished.append(req)
        return finished

    def _verified(self, nxt, acc):
        """``emitted`` of a verify round: a slot's accepted proposals plus
        the model's own token at the first mismatch (1..K+1 tokens, all
        the model's argmaxes: the unspeculated stream). Its cursor moved
        by accepted + 1 on the device; rejected rows sit beyond it, stale
        until overwritten."""
        K = self.config.spec_tokens

        def emitted(req):
            a = int(acc[req.slot])
            self._lat["spec_steps"] += 1
            self._lat["spec_proposed"] += K
            self._lat["spec_accepted"] += a
            return nxt[req.slot, :a + 1], a + 1
        return emitted

    @staticmethod
    def _append(req: Request, token: int, eos) -> None:
        req.generated.append(token)
        if eos is not None and token == eos:
            req.eos_seen = True      # generated ends AT the eos token

    @staticmethod
    def _done(req: Request) -> bool:
        return req.remaining <= 0 or req.eos_seen

    def run(self, requests, max_new_tokens: int = 64,
            max_rounds: int = 100000) -> Dict[int, np.ndarray]:
        """Submit-and-drain: requests is a list of prompt-id arrays or
        (prompt, max_new[, adapter_id]) tuples. Returns {rid: output ids} (prompt +
        generated) for this call's requests that finished (a request
        cancelled by its deadline is on ``cancelled``)."""
        rids = []
        for r in requests:
            aid = 0
            if isinstance(r, tuple):
                prompt, n = r[0], r[1]
                if len(r) > 2:             # (prompt, max_new, adapter_id)
                    aid = int(r[2])
            else:
                prompt, n = r, max_new_tokens
            rids.append(self.add_request(prompt, n, adapter_id=aid))
        rounds = 0
        while not self.scheduler.done:
            self.step()
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError("serving run did not converge "
                                   f"({rounds} rounds)")
        mine = set(rids)
        return {r.rid: r.output for r in self._finished if r.rid in mine}

    # ---- reliability -------------------------------------------------

    def _enforce_deadlines(self) -> None:
        """Round-boundary deadline sweep: TTFT deadlines apply until the
        first token reached the host, total deadlines until completion.
        A missed request is CANCELLED — a running one returns its slot and
        blocks to the pool mid-decode — and its partial output stays
        readable on ``cancelled``."""
        now = time.perf_counter()
        for req in (list(self.scheduler.waiting)
                    + list(self.scheduler.running)):
            elapsed_ms = (now - req.submit_t) * 1e3
            if req.deadline_ms is not None and elapsed_ms > req.deadline_ms:
                kind, budget = "total", req.deadline_ms
            elif (req.ttft_deadline_ms is not None
                  and req.first_token_t is None
                  and elapsed_ms > req.ttft_deadline_ms):
                kind, budget = "ttft", req.ttft_deadline_ms
            else:
                continue
            self.scheduler.cancel(req, reason=f"{kind}_deadline")
            self._release_adapter(req)   # no-op for never-pinned waiters
            self._drop_kv_payload(req, count=False)   # died, not fell back
            if self._tracer is not None:
                self._tracer.instant(req.rid, "cancelled",
                                     reason=f"{kind}_deadline")
                self._tracer.end(req.rid)
            self._cancelled.append(req)
            self._counters["deadline_misses"] += 1
            rb_events.emit("deadline_miss", rid=req.rid, kind=kind,
                           budget_ms=budget,
                           elapsed_ms=round(elapsed_ms, 1),
                           generated=len(req.generated))

    def _drain_events(self) -> None:
        """Round-boundary drain of pending robustness events into the
        configured JSONL sink. Without a sink the queue is left pending
        (another engine's sink may own the drain)."""
        if self._jsonl is None or not self._jsonl.enabled:
            return
        recs = rb_events.drain()
        if recs:
            self._jsonl.write_records(recs)

    @property
    def cancelled(self) -> List[Request]:
        """Requests cancelled by deadline enforcement (partial outputs
        kept)."""
        return list(self._cancelled)

    def close(self, timeout: Optional[float] = None) -> bool:
        """Stop admission (``add_request`` then sheds as ``draining``) and
        join the latest watchdog round thread, bounded by ``timeout``
        (default ``dispatch_timeout_s``, else 5 s). Returns False when that
        thread outlived the budget. On a mesh, rank 0 then sends the
        other ranks the stop (once): their ``run_worker`` returns. A round
        thread that outlived the budget sends it as soon as its current
        device call returns, and makes no further call."""
        self._draining = True
        # a round thread that outlives the budget sends the stop itself
        # when its current device call returns (the seam carries one
        # call at a time: a stop sent from here could cut into it)
        self._stop_pending.set()
        if timeout is None:
            timeout = self.config.dispatch_timeout_s or 5.0
        t = self._round_thread
        if t is not None and t.is_alive():
            t.join(timeout)
            if t.is_alive():
                return False
        self._round_thread = None
        self._send_stop()
        return True

    # ---- drain, resume, migration and the KV handoff -----------------

    def attach_preemption(self, handler, save_dir: Optional[str]) -> None:
        """SIGTERM contract (``robustness.preemption.PreemptionHandler``):
        the handler latches the signal; the next ``step()`` drains the
        engine into ``save_dir`` and raises ``Preempted``. A restarted
        engine picks the work back up with ``resume(save_dir)``."""
        self._preemption = handler
        self._drain_dir = save_dir

    @property
    def mesh_desc(self) -> str:
        """JAX's mesh label: "tensor=2", "expert=4", "single"."""
        return self.mesh.describe()

    def _check_geometry(self, eng: Optional[Dict[str, Any]],
                        source: Optional[str] = None) -> None:
        """Refuse restoring work drained at another tensor / expert
        parallel degree: a different degree regroups the out-projection
        sums, so the continuation would not be the drained engine's own.
        Records without the fields (drains that predate them) pass."""
        if eng is None:
            return
        want_tp, want_ep = eng.get("tp"), eng.get("ep")
        src = f" (drained by {source})" if source else ""
        if want_tp is not None and int(want_tp) != self.tp or \
                want_ep is not None and int(want_ep) != self.ep:
            raise ResumeIncompatible(
                f"drained state{src} came from a tp={want_tp} ep={want_ep} "
                f"engine; this engine is tp={self.tp} ep={self.ep} — "
                "byte-identical continuation is only guaranteed on a "
                "matching geometry")

    def _kv_geometry(self) -> Dict[str, Any]:
        """The pool geometry a KV payload must match to be scattered in,
        with JAX's names and dtype names."""
        k = self.pools["k"]
        return {"num_layers": int(k.shape[0]),
                "kv_heads": int(k.shape[2]) * self.tp,
                "head_dim": int(k.shape[4]),
                "block_size": int(self.config.block_size),
                "kv_bits": int(self.model.config.kv_cache_bits or 0),
                "dtype": _dtype_name(k.dtype)}

    def export_kv(self, request_ids: List[int]
                  ) -> Dict[int, Dict[str, Any]]:
        """Serialize running requests' pool blocks into dense host
        payloads — the KV-byte half of a handoff: one gather and one
        device-to-host copy a leaf, not a recompute. Each payload carries
        its geometry (typed refusal at import) and a crc32 over its
        buffers (a torn payload falls back to re-prefill, never decodes
        garbage); int8 pools ship ``k``, ``v``, ``k_scale`` and
        ``v_scale``, bf16 leaves as their raw 2-byte view. Requests
        without pool rows (waiting, unknown) are skipped: the caller's
        fallback is the re-prefill migration. The bytes count as staging
        (``stats()``) until ``release_requests`` hands the request
        away. At tp > 1 a payload carries all kv heads, as JAX's: each
        rank's heads are summed into place on every rank (a collective
        call), and rank 0 copies the whole to the host."""
        bs = self.config.block_size
        out: Dict[int, Dict[str, Any]] = {}
        for rid in request_ids:
            req = self._requests.get(rid)
            if req is None or req.state != "running" \
                    or req.cached_rows <= 0 or not req.block_ids:
                continue
            rows = int(req.cached_rows)
            n = blocks_for(rows, bs)
            ids = torch.as_tensor(req.block_ids[:n], dtype=torch.long,
                                  device=self.device)
            data = {name: _host_leaf(leaf) for name, leaf in
                    self._call(_KV_EXPORT, (), (ids,)).items()}
            payload = {"schema": KV_PAYLOAD_SCHEMA, "rows": rows,
                       "blocks": n, "geometry": self._kv_geometry(),
                       "data": data, "crc": kv_payload_crc(data)}
            nbytes = kv_payload_nbytes(data)
            self._kv_staging[rid] = nbytes
            self._counters["handoffs"] += 1
            self._counters["handoff_bytes"] += nbytes
            if self._tracer is not None:
                self._tracer.instant(rid, "kv_export", bytes=nbytes,
                                     rows=rows)
            out[rid] = payload
        return out

    def _validate_kv_payload(self, req: Request, payload: Dict[str, Any],
                             source: Optional[str] = None) -> None:
        """Typed refusal (``ResumeIncompatible``, counted as a fallback)
        of any payload this engine cannot scatter bit-faithfully:
        geometry, bits or dtype mismatch, another pool tree, leaves of
        the wrong shape or width, rows outside the pending-token protocol,
        or a checksum failure (torn payload)."""
        src = f" (exported by {source})" if source else ""

        def refuse(why: str) -> None:
            self._counters["handoff_fallbacks"] += 1
            raise ResumeIncompatible(
                f"kv payload for request {req.rid}{src}: {why} — "
                "falling back to the re-prefill migration path keeps the "
                "continuation correct (just slower)")

        geom, local = payload.get("geometry") or {}, self._kv_geometry()
        for key, want in local.items():
            got = geom.get(key)
            if got is not None and got != want:
                refuse(f"pool geometry mismatch on {key!r} "
                       f"(payload {got!r}, this engine {want!r})")
        data = payload.get("data") or {}
        if set(data) != set(self.pools):
            refuse(f"payload tree {sorted(data)} != pool tree "
                   f"{sorted(self.pools)} (kv-bits mismatch ships/omits "
                   "the scale leaves)")
        rows, n = int(payload.get("rows", 0)), int(payload.get("blocks", 0))
        ctx = len(req.context)
        if not 0 < rows < ctx:
            # pending-token protocol: the row at cached_rows is computed
            # by the receiver's tail span, so a full-context payload is
            # as malformed as an empty one
            refuse(f"rows={rows} outside (0, {ctx}) for a context of "
                   f"{ctx} tokens")
        if n != blocks_for(rows, self.config.block_size) or n > self.MB:
            refuse(f"blocks={n} does not cover rows={rows} at block_size="
                   f"{self.config.block_size} (table width {self.MB})")
        for name, pool in self.pools.items():
            leaf = data[name]
            # the payload's kv heads are all of them: tp times this rank's
            want = (pool.shape[0], n, pool.shape[2] * self.tp) \
                + tuple(pool.shape[3:])
            shape = tuple(getattr(leaf, "shape", ()))
            width = getattr(getattr(leaf, "dtype", None), "itemsize", None)
            if shape != want or width != pool.element_size():
                refuse(f"{name} payload shape {shape} x {width} B != "
                       f"{want} x {pool.element_size()} B")
        if kv_payload_crc(data) != payload.get("crc"):
            refuse("checksum failure (torn/corrupt payload)")

    def import_kv(self, request_id: int, payload: Dict[str, Any]) -> None:
        """Attach an exported KV payload to a WAITING request on this
        engine (``accept_migration``'s ``kv=`` path does this per
        record). Validation is typed, and a refused request is left
        untouched for the re-prefill fallback. The scatter happens at
        admission, into the blocks the allocator hands out, before the
        request's tail span runs."""
        req = self._requests.get(request_id)
        if req is None or req.state != "waiting":
            raise ResumeIncompatible(
                f"import_kv: request {request_id} is not waiting on this "
                "engine (accept_migration enqueues it; its kv= argument "
                "does both in one call)")
        self._validate_kv_payload(req, payload)
        self._attach_kv_payload(req, payload)

    def _attach_kv_payload(self, req: Request,
                           payload: Dict[str, Any]) -> None:
        req._kv_payload = payload
        req.kv_rows = int(payload["rows"])
        self._kv_staging[req.rid] = kv_payload_nbytes(payload["data"])

    def _dispatch_kv_import(self, req: Request) -> None:
        """Scatter an imported payload into the request's freshly admitted
        blocks (``index_copy_`` a leaf, in stream order before the tail
        span that reads them). The tail span then computes only rows
        [kv_rows, ctx)."""
        payload, req._kv_payload = req._kv_payload, None
        n = int(payload["blocks"])
        ids = torch.as_tensor(req.block_ids[:n], dtype=torch.long,
                              device=self.device)
        self._call(_KV_IMPORT, (), [ids] + [
            _device_leaf(payload["data"][name], pool)
            for name, pool in self.pools.items()])
        nbytes = self._kv_staging.pop(req.rid, 0)
        self._counters["handoffs"] += 1
        self._counters["handoff_bytes"] += nbytes

    def _drop_kv_payload(self, req: Request, count: bool = True) -> None:
        """Forget an unscattered import payload (preemption, adapter
        bounce, cancel, release): the request falls back to re-prefill —
        stale bytes must never land in blocks of a LATER admission.
        ``count=False`` for exits that are not fallbacks."""
        if getattr(req, "_kv_payload", None) is None:
            return
        req._kv_payload = None
        req.kv_rows = 0
        self._kv_staging.pop(req.rid, None)
        if count:
            self._counters["handoff_fallbacks"] += 1

    def _record(self, req: Request) -> Dict[str, Any]:
        """A request as a drain-state (v3) record, with its trace context
        (id and spans so far) when tracing is on."""
        return {"rid": req.rid,
                "prompt": np.asarray(req.prompt).tolist(),
                "generated": [int(t) for t in req.generated],
                "max_new_tokens": req.max_new_tokens,
                "preemptions": req.preemptions,
                "cached_rows": req.cached_rows,
                "block_ids": [int(b) for b in req.block_ids],
                "slot": req.slot,
                "state": req.state,
                "ttft_deadline_ms": req.ttft_deadline_ms,
                "deadline_ms": req.deadline_ms,
                "adapter_id": req.adapter_id,
                "trace": (self._tracer.context(req.rid)
                          if self._tracer is not None else None)}

    def release_requests(self, request_ids: List[int]
                         ) -> List[Dict[str, Any]]:
        """Extract live requests for a handoff: returns drain-schema
        records (plus ``submit_t`` / ``first_token_t`` / ``last_token_t``
        so TTFT, ITL and deadlines stay honest across an in-process hop)
        and removes the requests from this engine — slot and blocks back
        to the pool, the prefix cache offered the KV first, adapter pins
        dropped, nothing counted as cancelled. Call ``export_kv`` BEFORE
        this (the gather reads the rows this frees)."""
        recs: List[Dict[str, Any]] = []
        for rid in request_ids:
            req = self._requests.get(rid)
            if req is None or req.state not in ("running", "waiting"):
                continue
            if self._tracer is not None:
                self._tracer.instant(req.rid, "handoff_out")
            recs.append(dict(self._record(req), submit_t=req.submit_t,
                             first_token_t=req.first_token_t,
                             last_token_t=req.last_token_t))
            self._drop_kv_payload(req, count=False)  # moving, not falling
            self._kv_staging.pop(req.rid, None)      # export consumed
            if req.state == "running":
                sched = self.scheduler
                sched.running.remove(req)
                sched._free_slots.append(req.slot)
                sched._release_cow(req)
                sched._publish(req)
                if req.block_ids:
                    self.allocator.free(req.block_ids, owner=req.rid)
                req.block_ids = []
                req.slot = None
            else:
                self.scheduler.waiting.remove(req)
            self._release_adapter(req)
            req._first_dev = None
            req.state = "migrated"
            del self._requests[req.rid]
            if self._tracer is not None:
                self._tracer.end(req.rid)
        return recs

    def drain(self, save_dir: Optional[str] = None,
              tag: str = "serving_drain",
              source: Optional[str] = None) -> Optional[str]:
        """Stop admission and checkpoint every unfinished request —
        host cursors (prompt, generated, budget) with the block table /
        slot / cached_rows snapshot for post-mortems — through the
        integrity chain: ``state.json``, then the manifest, then the
        COMMITTED marker LAST, so a torn drain reads as torn. Returns the
        tag dir (None without ``save_dir``: admission stops, nothing
        persists). The engine's geometry is recorded (``max_model_len``,
        block size, table width, tp / ep), so a foreign engine refuses a
        drain it cannot hold (``ResumeIncompatible``). ``source`` names
        the draining replica."""
        self._draining = True
        live = (sorted(self.scheduler.running,
                       key=lambda r: r.admission_seq or 0)
                + list(self.scheduler.waiting))
        if save_dir is None:
            rb_events.emit("serving_drained", requests=len(live), tag=None)
            self._drain_events()
            return None
        tag_dir = os.path.join(save_dir, tag)
        os.makedirs(tag_dir, exist_ok=True)
        integrity.invalidate(tag_dir)      # rewriting in place: torn-able
        if self._tracer is not None:
            # before the records take their trace contexts: the drain
            # point itself rides the migrated trace
            for req in live:
                self._tracer.instant(req.rid, "drained", tag=tag)
        state = {
            "version": DRAIN_STATE_VERSION,
            "rng_counter": self._rng_counter,
            "source": source,
            "engine": {
                "max_model_len": self.max_model_len,
                "block_size": self.config.block_size,
                "table_width": self.MB,
                "max_seqs": self.config.max_seqs,
                "tp": self.tp,
                "ep": self.ep,
            },
            "requests": [self._record(req) for req in live],
        }
        integrity.atomic_write(os.path.join(tag_dir, "state.json"),
                               json.dumps(state, indent=1),
                               what="serving drain state write")
        integrity.write_manifest(tag_dir)
        integrity.write_commit_marker(tag_dir)
        rb_events.emit("serving_drained", requests=len(live), tag=tag,
                       path=tag_dir)
        self._drain_events()
        return tag_dir

    def accept_migration(self, recs: List[Dict[str, Any]],
                         rng_counter: Optional[int] = None,
                         source: Optional[str] = None,
                         geometry: Optional[Dict[str, Any]] = None,
                         kv: Optional[Dict[int, Dict[str, Any]]] = None
                         ) -> List[int]:
        """Restore drained request records (the ``state.json`` schema) onto
        THIS engine, all or nothing: every record is checked before
        anything is enqueued — the drained geometry (tp / ep), the
        adapter's registration, the context cap (a request whose context
        + budget exceeds this engine's table raises
        ``ResumeIncompatible``), then each ``kv`` payload (``{rid:
        payload}`` from the source's ``export_kv``: geometry, bits,
        protocol and checksum). Admission watermarks are bypassed
        (``scheduler.restore``): this work was already admitted once.
        Accepted payloads make the hop one scatter plus a tail span
        instead of a prompt-length recompute, token-identically; after a
        refusal the caller retries without ``kv`` (re-prefill)."""
        self._check_geometry(geometry, source)
        kv = kv or {}
        src = f" (drained by {source})" if source else ""
        reqs: List[Any] = []   # (Request, rec, payload or None)
        for rec in recs:
            aid = int(rec.get("adapter_id", 0))
            if aid and (not self._lora or aid not in self.adapter_store):
                raise ResumeIncompatible(
                    f"migrated request {rec.get('rid')}{src} routes to "
                    f"LoRA adapter {aid}, which this engine "
                    + ("has LoRA serving disabled for"
                       if not self._lora else "has no registration for")
                    + " — register the adapter here first, or place the "
                    "request on a replica that serves it")
            req = Request(rid=int(rec["rid"]),
                          prompt=np.asarray(rec["prompt"], np.int32),
                          max_new_tokens=int(rec["max_new_tokens"]),
                          generated=[int(x) for x in rec.get("generated",
                                                             [])],
                          preemptions=int(rec.get("preemptions", 0)),
                          ttft_deadline_ms=rec.get("ttft_deadline_ms"),
                          deadline_ms=rec.get("deadline_ms"),
                          adapter_id=aid)
            if req.prompt.size + req.max_new_tokens > self.max_model_len:
                raise ResumeIncompatible(
                    f"migrated request {req.rid}{src}: prompt "
                    f"({req.prompt.size}) + max_new_tokens "
                    f"({req.max_new_tokens}) exceeds this engine's "
                    f"max_model_len {self.max_model_len} "
                    f"(block-table width {self.MB} x "
                    f"{self.config.block_size}-token blocks) — place it "
                    "on an engine at least as large as the drained one")
            payload = kv.get(req.rid)
            if payload is not None:
                self._validate_kv_payload(req, payload, source)
            reqs.append((req, rec, payload))
        if rng_counter is not None:
            self._rng_counter = max(self._rng_counter, int(rng_counter))
        rids: List[int] = []
        for req, rec, payload in reqs:
            self.scheduler.restore(req)
            self._requests[req.rid] = req
            if payload is not None:
                self._attach_kv_payload(req, payload)
            if self._tracer is not None:
                # stitch: the drained trace id and spans (a v3 record), so
                # a merged export shows one trace across replicas
                self._tracer.adopt(req.rid, rec.get("trace"))
                self._tracer.instant(req.rid, "migrated_in",
                                     source=source or "",
                                     kv=payload is not None)
            req._trace_wait_t0 = req.submit_t    # restore() re-stamped it
            # live-handoff stamps (release_requests records only)
            for key in ("submit_t", "first_token_t", "last_token_t"):
                if rec.get(key) is not None:
                    setattr(req, key, float(rec[key]))
            rids.append(req.rid)
        if self._stats_t0 is None and rids:
            self._stats_t0 = time.perf_counter()
        return rids

    def resume(self, save_dir: str, tag: Optional[str] = None) -> List[int]:
        """Re-enqueue the requests a drained engine checkpointed: each
        resumes by re-prefilling prompt + generated, so its greedy
        continuation is byte-identical to the uninterrupted run.
        ``tag=None`` resolves the newest tag that passes integrity
        validation — a torn drain is skipped. A foreign drain is held to
        the drained engine's capacity in TOKENS (a smaller
        ``max_model_len`` refuses with ``ResumeIncompatible`` even if
        every request would fit; bigger blocks with a narrower table do
        not); ``accept_migration`` applies the per-request check."""
        state = load_drain_state(save_dir, tag)
        tag = state["tag"]
        eng = state.get("engine")
        if eng is not None:        # version-1 drains predate the geometry
            drained_cap = int(eng.get("max_model_len")
                              or (int(eng.get("table_width", 0))
                                  * int(eng.get("block_size", 0))))
            if drained_cap > self.max_model_len:
                src = state.get("source")
                raise ResumeIncompatible(
                    "drain tag "
                    f"'{tag}'{f' (replica {src})' if src else ''} came "
                    f"from an engine with max_model_len {drained_cap} "
                    f"(table width {eng.get('table_width')} x "
                    f"{eng.get('block_size')}-token blocks); this engine "
                    f"caps at max_model_len {self.max_model_len} (width "
                    f"{self.MB}) — resume into an engine at least as "
                    "large, or migrate per-request via accept_migration")
        rids = self.accept_migration(state["requests"],
                                     rng_counter=state.get("rng_counter"),
                                     source=state.get("source"),
                                     geometry=eng)
        rb_events.emit("serving_resumed", requests=len(rids), tag=tag)
        self._drain_events()
        return rids

    # ---- stats -------------------------------------------------------

    def reset_stats(self) -> None:
        """Start a fresh measurement window: finished and cancelled
        records, the counters and the throughput clock (pool, scheduler
        and cache contents untouched)."""
        self._finished: List[Request] = []
        self._cancelled: List[Request] = []
        self._stats_t0: Optional[float] = None
        self._itl_ms: List[float] = []
        self._dispatches = {"prefills": 0, "decode_steps": 0,
                            "verify_steps": 0}
        self._counters = {"shed": 0, "deadline_misses": 0, "degraded": 0,
                          "recoveries": 0, "recovery_ms": 0.0,
                          "handoffs": 0, "handoff_bytes": 0,
                          "handoff_fallbacks": 0}
        self._lat = {"spec_steps": 0, "spec_proposed": 0, "spec_accepted": 0,
                     "prefill_chunks": 0, "prefill_chunk_tokens": 0,
                     "cow_forks": 0}
        if self._prefix_cache is not None:
            self._prefix_cache.reset_stats()
        if self._lora:
            p = self.adapter_slots
            p.hits = p.evictions = p.page_ins = 0
        # the phase ring, the stall latch and the tracer's sync count are
        # window-scoped too
        self._phases.clear()
        self._round_tokens = 0
        self._phase_stall_events = 0
        if self._tracer is not None:
            self._tracer.device_syncs = 0

    def stats(self) -> Dict[str, float]:
        """TTFT p50/p99 (ms, measured at the round boundary where the first
        token reached the host), inter-token latency p50/p99, aggregate
        generated-token throughput, the dispatch counts the kernels'
        launch counts are checked against (whole-prompt prefills, decode
        steps, verify steps), the pool's resident bytes with the KV and
        weight quantization it serves (``kv_cache_bits``,
        ``weight_bits``), the reliability counters (shed,
        deadline_misses, cancelled, queue_depth, recoveries, recovery_ms,
        and degraded, 0 by design: no second decode backend), the
        speculation counters
        (``spec_steps`` per decoding request and round, ``spec_proposed``,
        ``spec_accepted``, ``spec_accept_rate``), the chunking and fork
        counters (prefill_chunks, prefill_chunk_tokens, cow_forks), the
        adapter slot pool's traffic (``adapter_hits``,
        ``adapter_page_ins``, ``adapter_evictions``), the handoff counters
        (``handoffs``, ``handoff_bytes``, ``handoff_fallbacks``) and
        ``kv_staging_bytes`` (payload bytes in flight, priced into
        ``pool_bytes`` with the KV and adapter pools) and, with the
        prefix cache on, its ``prefix_*`` counters, ``prefix_hit_rate``
        and ``prefix_held_blocks``."""
        done = [r for r in self._finished if r.first_token_t is not None]
        staging = sum(self._kv_staging.values())
        slots = self.adapter_slots
        out: Dict[str, float] = {
            "completed": float(len(self._finished)),
            "preemptions": float(sum(r.preemptions for r in self._finished)),
            "pool_bytes": float(self.pool_bytes + staging),
            "pool_bytes_logical": float(self.pool_bytes_logical),
            "tp": float(self.tp),
            "ep": float(self.ep),
            "kv_staging_bytes": float(staging),
            "adapter_hits": float(slots.hits if slots else 0),
            "adapter_page_ins": float(slots.page_ins if slots else 0),
            "adapter_evictions": float(slots.evictions if slots else 0),
            "kv_cache_bits": float(self.model.config.kv_cache_bits),
            "weight_bits": float(self.engine.config.weight_bits or 0),
            "queue_depth": float(self.scheduler.num_waiting),
            "cancelled": float(len(self._cancelled)),
        }
        for group in (self._dispatches, self._counters, self._lat):
            out.update({k: float(v) for k, v in group.items()})
        if self._lat["spec_proposed"]:
            out["spec_accept_rate"] = float(round(
                self._lat["spec_accepted"] / self._lat["spec_proposed"], 4))
        if done:
            ttft = np.asarray([(r.first_token_t - r.submit_t) * 1e3
                               for r in done])
            out["p50_ttft_ms"] = float(np.percentile(ttft, 50))
            out["p99_ttft_ms"] = float(np.percentile(ttft, 99))
        if self._itl_ms:
            itl = np.asarray(self._itl_ms)
            out["p50_itl_ms"] = float(np.percentile(itl, 50))
            out["p99_itl_ms"] = float(np.percentile(itl, 99))
        if self._prefix_cache is not None:
            cs = self._prefix_cache.stats
            out.update({f"prefix_{k}": float(v) for k, v in cs.items()})
            if cs["lookups"]:
                out["prefix_hit_rate"] = float(round(
                    cs["hits"] / cs["lookups"], 4))
            out["prefix_held_blocks"] = float(
                self._prefix_cache.held_blocks)
        if self._finished and self._stats_t0 is not None:
            total = sum(len(r.generated) for r in self._finished)
            span = max(r.finish_t for r in self._finished) - self._stats_t0
            out["tok_per_sec"] = float(total / span) if span > 0 else 0.0
            out["generated_tokens"] = float(total)
        return out


def _refuse_data_axis(plan) -> None:
    """A serving engine runs tensor and expert meshes: JAX's
    ``ServingEngine`` has no data-split path (its block pools shard over
    ``tensor`` only and its slots are one host state,
    ``deepspeed_tpu/inference/serving.py:440-457``)."""
    if plan is not None and (plan.data > 1 or plan.fsdp > 1):
        raise NotImplementedError(
            f"serving on a mesh with data={plan.data}, fsdp={plan.fsdp}: "
            "JAX's ServingEngine has no data-split path (its block pools "
            "shard over tensor only and its slots are one host state: "
            "deepspeed_tpu/inference/serving.py:440-457); replicas, one "
            "engine each, serve behind inference.router, and "
            "InferenceEngine.generate splits a batch over data")


def init_serving(model, config=None, serving: Optional[dict] = None,
                 params=None, device=None, dtype=None, seed: int = 0,
                 mesh=None, **kwargs) -> ServingEngine:
    """One-call constructor: ``init_inference`` + ``ServingEngine``.
    ``serving`` takes ServingConfig field names. The engine's context
    budget ``max_tokens``, which sets the int8 KV default, defaults to
    the serving cap (``max_model_len``, else the model's ``max_seq_len``,
    else 2048, clamped to ``max_seq_len``), as JAX's; an explicit setting
    (a config dict entry, a keyword, an InferenceConfig) wins. Runs on
    the card: ``device=None`` means "cuda" and raises when CUDA is
    missing. ``mesh``: as ``init_inference``'s; on a mesh of more than one
    rank every rank calls this, rank 0 drives the engine and the others
    ``run_worker()``."""
    sc = serving_config(serving)
    model_cap = getattr(getattr(model, "config", None), "max_seq_len", None)
    max_len = sc.max_model_len or model_cap or 2048
    if model_cap:
        max_len = min(max_len, model_cap)
    if (config is None or isinstance(config, dict)) \
            and "max_tokens" not in kwargs:
        config = dict(config or {})
        config.setdefault("max_tokens", max_len)
    eng = init_inference(model, config=config, dtype=dtype, params=params,
                         device=device, seed=seed, mesh=mesh, **kwargs)
    return ServingEngine(eng, sc, seed=seed)

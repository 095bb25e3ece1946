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

Attention runs through the two hand-written CUDA kernels: the flash
forward in every whole-prompt prefill, the paged decode kernel in every
decode step on a float pool. Prefill chunks, prefix-cache tails, verify
steps and every decode step on an int8 pool run plain torch ops, as JAX
runs them on XLA (its kernel reads float pools and single tokens only);
``decode_backend`` / ``backend_bench`` record which route the decode
step takes and why.

There is no backend pick and no recovery: on the card a kernel error
reaches the caller. The watchdog raises ``DecodeDispatchHang`` when a
round overruns ``dispatch_timeout_s``. The pools are updated in place, so
a round thread the watchdog gave up on may still write them; the engine
then marks itself failed and every later ``step()`` / ``run()`` raises,
naming the first error (any error escaping a round does the same: the
pools may hold part of its writes).

Token/row bookkeeping (as in the JAX engine): ``req.cached_rows`` = KV rows
in the pool for the request. A (re-)prefill sets it to ``len(context)`` and
leaves the NEXT sampled token pending in the device token vector; each
decode step writes the pending token's row and samples a new pending
token. Host-side ``generated`` absorbs the pending chain at the round
boundary from the one token fetch.

What this port leaves out raises ``NotImplementedError`` naming its
ROADMAP item: LoRA adapters (A6g), drain / resume / migration and the KV
handoff (A6i), tensor / expert parallel serving (A6h), round recovery and
its fault seams, request tracing and fleet roles (A7), and serving a
block-sparse model (A10b).
"""

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.inference.kv_cache import BlockAllocator, pool_bytes
from deepspeed_tpu_torch.inference.prefix_cache import PrefixCache
from deepspeed_tpu_torch.inference.scheduler import (AdmissionRejected,
                                                     Request,
                                                     RequestScheduler)
from deepspeed_tpu_torch.inference.spec_decode import (greedy_accept_len,
                                                       make_proposer)
from deepspeed_tpu_torch.models.transformer import check_servable
from deepspeed_tpu_torch.monitor.monitor import JSONLMonitor
from deepspeed_tpu_torch.robustness import events as rb_events


class DecodeDispatchHang(RuntimeError):
    """The watchdog timed out a decode round: the dispatch (or its token
    fetch) never came back within ``dispatch_timeout_s``."""


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
    # DecodeDispatchHang to the caller; None = no watchdog
    dispatch_timeout_s: Optional[float] = None
    # round recovery (preempt all, rebuild the pool, retry) is not ported:
    # only 0 is accepted
    round_retries: int = 0
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

    def __post_init__(self):
        if self.round_retries != 0:
            raise NotImplementedError(
                f"round_retries={self.round_retries}: round recovery is not "
                "ported yet: ROADMAP A7 (fleet host layer: the fault seams "
                "that drive recovery)")
        if self.decode_backend == "xla":
            raise ValueError(
                "decode_backend='xla': the port serves decode through the "
                "paged decode kernel only (no gather path on the card)")
        if self.decode_backend not in ("auto", "pallas"):
            raise ValueError(f"decode_backend={self.decode_backend!r}: "
                             "auto | pallas")


_LORA = "not ported yet: ROADMAP A6g (multi-LoRA serving)"
_TRACE = "not ported yet: ROADMAP A7 (fleet host layer: request tracing)"

# JAX ServingConfig fields outside this port: (their default, why a value
# away from it is refused)
_DEFERRED = {
    "adapter_slots": (0, _LORA),
    "lora_rank": (0, _LORA),
    "lora_targets": (("q", "k", "v", "o"), _LORA),
    "request_trace": (False, _TRACE),
    "trace_replica": ("r0", _TRACE),
    "trace_events": (65536, _TRACE),
    "role": ("both", "not ported yet: ROADMAP A7 (fleet host layer: "
                     "disaggregated roles)"),
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
        if isinstance(default, tuple) and isinstance(value, list):
            value = tuple(value)
        if value != default:
            raise NotImplementedError(f"serving {name}={value!r}: {why}")
    return ServingConfig(**fields)


class ServingEngine:
    """Continuous-batching server over an InferenceEngine's params.

    >>> srv = init_serving(model, serving=dict(max_seqs=16))
    >>> outs = srv.run([(prompt_ids, 64), ...])   # {rid: output ids}
    >>> srv.stats()                               # TTFT p50/p99, tok/s
    """

    def __init__(self, engine, config: Optional[ServingConfig] = None,
                 seed: int = 0):
        self.engine = engine
        self.config = c = config or ServingConfig()
        self.model = engine.model
        self.device = engine.device
        mcfg = self.model.config
        check_servable(mcfg)
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
        # int8 pools carry k_scale / v_scale beside k / v
        self.pools = self.model.init_paged_cache(
            num_blocks, c.block_size, dtype=engine.dtype, device=self.device)
        self.pool_bytes = pool_bytes(mcfg, num_blocks, c.block_size,
                                     dtype=engine.dtype)
        self._tokens = torch.zeros((c.max_seqs,), dtype=torch.long,
                                   device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._requests: Dict[int, Request] = {}
        self._jsonl = (JSONLMonitor(c.telemetry_jsonl)
                       if c.telemetry_jsonl else None)
        # the watchdog arms once the decode quantum has run once (its
        # first round is warm-up time, not a hang)
        self._quantum_warm = False
        self._round_thread: Optional[threading.Thread] = None
        self._failed: Optional[BaseException] = None
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

    # ---- device programs ---------------------------------------------

    def _pad_prompt(self, n: int) -> int:
        return max(self._bucket,
                   min(-(-n // self._bucket) * self._bucket,
                       self.max_model_len))

    def _pad_chunk(self, n: int) -> int:
        bs = self.config.block_size
        return -(-n // bs) * bs

    def _sample(self, logits):
        """[S, V] f32 logits -> [S] token ids. Greedy ties take the first
        index, as jnp.argmax does."""
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
        last = self.model.prefill_paged(
            self.engine.params, torch.from_numpy(buf).to(self.device),
            self.pools, block_ids.to(self.device), length=ctx.size)
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
        logits = self.model.decode_span_paged(
            self.engine.params, torch.from_numpy(buf).to(dev), self.pools,
            torch.from_numpy(tab).to(dev),
            torch.tensor([start], dtype=torch.int32, device=dev),
            n_rows=torch.tensor([n], dtype=torch.int32, device=dev))
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
        boundary block waits for ``finish`` (its owner still appends)."""
        if self._prefix_cache is not None:
            self._prefix_cache.insert_full(ctx, req.block_ids,
                                           req.cached_rows)

    def _dispatch_fork(self, req: Request) -> None:
        """Copy-on-write fork (dispatch, no sync): the shared boundary
        block a prefix-cache match reached into is copied, every layer's K
        and V, to the fresh block the scheduler put at the same table
        index, then the match's pin on the shared block is dropped. Runs
        before any of the request's own writes."""
        src, dst = req.cow_src, req.cow_dst
        for pool in self.pools.values():
            pool[:, dst] = pool[:, src]
        self.allocator.free([src], owner=req.rid)
        req.cow_src = req.cow_dst = None
        self._lat["cow_forks"] += 1

    def _tables_device(self):
        S = self.config.max_seqs
        ids = np.zeros((S, self.MB), np.int32)
        lens = np.zeros((S,), np.int32)
        act = np.zeros((S,), bool)
        for req in self.scheduler.running:
            ids[req.slot, :len(req.block_ids)] = req.block_ids
            lens[req.slot] = req.cached_rows
            # a request still prefilling (chunks landing) holds its slot
            # but does not decode yet
            act[req.slot] = req.prefill_done
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (ids, lens, act))

    def _quantum(self, tokens, tables, seq_lens, active
                 ) -> List[torch.Tensor]:
        """``decode_quantum`` decode steps of every slot, dispatched back
        to back from ``tokens``; returns each step's sampled tokens (still
        on device). Touches no engine state but the pools."""
        lens = seq_lens
        step = active.to(torch.int32)
        outs = []
        for _ in range(self.config.decode_quantum):
            logits = self.model.decode_step_paged(
                self.engine.params, tokens, self.pools, tables, lens,
                active=active)
            tokens = torch.where(active, self._sample(logits), tokens)
            lens = lens + step
            outs.append(tokens)
        return outs

    def _spec_step(self, tok_mat, tables, seq_lens, active):
        """The speculation verify step (dispatch, no sync): ONE
        ``decode_span_paged`` pass over the pending token plus the K
        proposals of every slot, the greedy accept rule on the device, and
        each slot's next pending token and cursor (accepted + 1 rows).
        Rows written for rejected proposals stay behind the cursor until
        overwritten. Returns (argmax [S, K+1], accepted [S], pending [S],
        new lengths [S])."""
        logits = self.model.decode_span_paged(
            self.engine.params, tok_mat, self.pools, tables, seq_lens,
            active=active)
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

    def add_request(self, prompt_ids, max_new_tokens: int = 64,
                    request_id: Optional[int] = None,
                    ttft_deadline_ms: Optional[float] = None,
                    deadline_ms: Optional[float] = None) -> int:
        """Submit one request. The deadlines override the config's for
        this request. Raises ``AdmissionRejected`` when a watermark sheds
        it: counted in ``stats()["shed"]`` and evented, never silently
        queued."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if max_new_tokens < 1:
            # the prefill inherently samples one token
            raise ValueError(f"max_new_tokens={max_new_tokens}: must be "
                             ">= 1")
        if prompt.size + max_new_tokens > self.max_model_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_model_len "
                f"{self.max_model_len}")
        c = self.config
        try:
            req = self.scheduler.submit(
                prompt, max_new_tokens, rid=request_id,
                ttft_deadline_ms=(ttft_deadline_ms
                                  if ttft_deadline_ms is not None
                                  else c.ttft_deadline_ms),
                deadline_ms=(deadline_ms if deadline_ms is not None
                             else c.deadline_ms))
        except AdmissionRejected as e:
            self._counters["shed"] += 1
            rb_events.emit("request_shed", reason=e.reason, **e.detail)
            raise
        self._requests[req.rid] = req
        if self._stats_t0 is None:
            self._stats_t0 = req.submit_t
        return req.rid

    def step(self) -> List[Request]:
        """One scheduling round: enforce deadlines; evict / admit /
        preempt at the boundary; the admitted requests' forks, then the
        prefills and prefill chunks, then one decode quantum and one token
        fetch; drain the events into the JSONL sink. Returns the requests
        finished this round. An error inside the round reaches the caller
        as raised, and the engine refuses every later round."""
        if self._failed is not None:
            raise RuntimeError(
                "serving engine failed in an earlier round ("
                f"{type(self._failed).__name__}: {self._failed}); its "
                "pools may hold that round's partial writes: build a new "
                "engine") from self._failed
        try:
            self._enforce_deadlines()
            return self._round()
        except BaseException as e:
            self._failed = e
            raise
        finally:
            self._drain_events()

    def _round(self) -> List[Request]:
        decisions = self.scheduler.schedule(
            token_budget=self.config.prefill_token_budget)
        for req in decisions["admitted"]:
            if req.cow_src is not None:
                # the fork runs before any of the request's own writes
                # can reach the shared boundary block
                self._dispatch_fork(req)
        for req, start, n in decisions["prefill"]:
            if start == 0 and n == len(req.context):
                self._dispatch_prefill(req)     # whole prompt: B1
            else:
                self._dispatch_chunk(req, start, n)
        running = self.scheduler.running
        if not running:
            return []
        pending = [(req, req._first_dev) for req in running
                   if getattr(req, "_first_dev", None) is not None]
        decode = any(r.prefill_done for r in running)
        # speculation: ONE verify step replaces the decode quantum
        spec = decode and self.config.spec_tokens > 0
        tables = self._tables_device() if decode else None
        tokens = self._tokens
        tok_mat = (torch.cat([tokens[:, None], self._proposals_device()],
                             dim=1) if spec else None)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def quantum_and_fetch():
            # the round thread issues on the caller's stream (a thread's
            # current stream is its own), after the prefills in order
            with self._on_stream(stream):
                verdict = []
                if spec:
                    nxt, acc, t, _ = self._spec_step(tok_mat, *tables)
                    outs, verdict = [], [nxt.reshape(-1), acc]
                else:
                    outs = self._quantum(tokens, *tables) if decode else []
                    t = outs[-1] if outs else tokens
                # the ONE sync of the round: every decode step's tokens (or
                # the verify step's argmaxes and accept lengths) and every
                # pending first token in one device-to-host copy
                parts = ([o.reshape(-1) for o in outs] + verdict
                         + [f.reshape(-1) for _, f in pending])
                host = (torch.cat(parts).cpu().numpy() if parts
                        else np.zeros((0,), np.int64))
            return t, host, len(outs)

        tokens, host, n_steps = self._with_watchdog(
            quantum_and_fetch, armed=self._quantum_warm)
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
            return self._commit_round(pending, host[S * K1 + S:],
                                      self._verified(nxt, acc))
        toks = host[:n_steps * S].reshape(n_steps, S)
        return self._commit_round(pending, host[n_steps * S:],
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
        here). The thread is left running: it may still write the pools,
        which is why the caller marks the engine failed."""
        timeout = self.config.dispatch_timeout_s
        if not timeout or not armed:
            return fn()
        box: Dict[str, Any] = {}

        def run():
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 — relayed below
                box["error"] = e

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

    def _note_tokens(self, req: Request, m: int, now: float) -> None:
        """Inter-token latency: a burst of ``m`` tokens arriving ``gap``
        after the request's previous ones records m samples of gap/m. The
        first token starts the clock (it is TTFT's, not ITL's)."""
        if m <= 0:
            return
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
        (prompt, max_new) tuples. Returns {rid: output ids} (prompt +
        generated) for this call's requests that finished (a request
        cancelled by its deadline is on ``cancelled``)."""
        rids = []
        for r in requests:
            if isinstance(r, tuple):
                if len(r) > 2 and r[2]:
                    raise NotImplementedError(
                        "per-request LoRA adapters are not ported yet: "
                        "ROADMAP A6g")
                prompt, n = r[0], r[1]
            else:
                prompt, n = r, max_new_tokens
            rids.append(self.add_request(prompt, n))
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
        """Join the latest watchdog round thread, bounded by ``timeout``
        (default ``dispatch_timeout_s``, else 5 s). Returns False when that
        thread outlived the budget."""
        if timeout is None:
            timeout = self.config.dispatch_timeout_s or 5.0
        t = self._round_thread
        if t is not None and t.is_alive():
            t.join(timeout)
            if t.is_alive():
                return False
        self._round_thread = None
        return True

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
        self._counters = {"shed": 0, "deadline_misses": 0}
        self._lat = {"spec_steps": 0, "spec_proposed": 0, "spec_accepted": 0,
                     "prefill_chunks": 0, "prefill_chunk_tokens": 0,
                     "cow_forks": 0}
        if self._prefix_cache is not None:
            self._prefix_cache.reset_stats()

    def stats(self) -> Dict[str, float]:
        """TTFT p50/p99 (ms, measured at the round boundary where the first
        token reached the host), inter-token latency p50/p99, aggregate
        generated-token throughput, the dispatch counts the kernels'
        launch counts are checked against (whole-prompt prefills, decode
        steps, verify steps), the pool's resident bytes with the KV and
        weight quantization it serves (``kv_cache_bits``,
        ``weight_bits``), the reliability counters (shed,
        deadline_misses, cancelled, queue_depth), the speculation counters
        (``spec_steps`` per decoding request and round, ``spec_proposed``,
        ``spec_accepted``, ``spec_accept_rate``), the chunking and fork
        counters (prefill_chunks, prefill_chunk_tokens, cow_forks) and,
        with the prefix cache on, its ``prefix_*`` counters,
        ``prefix_hit_rate`` and ``prefix_held_blocks``."""
        done = [r for r in self._finished if r.first_token_t is not None]
        out: Dict[str, float] = {
            "completed": float(len(self._finished)),
            "preemptions": float(sum(r.preemptions for r in self._finished)),
            "pool_bytes": float(self.pool_bytes),
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


def init_serving(model, config=None, serving: Optional[dict] = None,
                 params=None, device=None, dtype=None, seed: int = 0,
                 **kwargs) -> ServingEngine:
    """One-call constructor: ``init_inference`` + ``ServingEngine``.
    ``serving`` takes ServingConfig field names. The engine's context
    budget ``max_tokens``, which sets the int8 KV default, defaults to
    the serving cap (``max_model_len``, else the model's ``max_seq_len``,
    else 2048, clamped to ``max_seq_len``), as JAX's; an explicit setting
    (a config dict entry, a keyword, an InferenceConfig) wins. Runs on
    the card: ``device=None`` means "cuda" and raises when CUDA is
    missing."""
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
                         device=device, seed=seed, **kwargs)
    return ServingEngine(eng, sc, seed=seed)

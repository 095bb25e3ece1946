"""Serving engine: continuous batching over a paged KV cache, PyTorch port
of the core of ``deepspeed_tpu/inference/serving.py``.

  1. **Paged KV cache** — fixed-size blocks in preallocated pools, per-
     sequence block tables (``models/transformer.decode_step_paged``).
     Admitting and evicting sequences changes table contents only.
  2. **Continuous batching** — the ``RequestScheduler`` admits, evicts and
     preempts at round boundaries. A round dispatches the prefills of the
     admitted requests and ``decode_quantum`` decode steps of every running
     slot with no host sync between them; the only sync is ONE fetch of the
     round's sampled tokens (plus the admitted requests' first tokens).

Attention runs through the two hand-written CUDA kernels: the flash
forward in every prefill, the paged decode kernel in every decode step.
There is no backend pick and no recovery loop: on the card a kernel error
reaches the caller.

Token/row bookkeeping (as in the JAX engine): ``req.cached_rows`` = KV rows
in the pool for the request. A (re-)prefill sets it to ``len(context)`` and
leaves the NEXT sampled token pending in the device token vector; each
decode step writes the pending token's row and samples a new pending
token. Host-side ``generated`` absorbs the pending chain at the round
boundary from the one token fetch.

What this slice leaves out raises ``NotImplementedError`` naming its
ROADMAP item (deadlines, watermarks, prefix cache, chunked prefill,
speculative decoding, LoRA, drain/migration, tracing, fleet roles, a
block-sparse model).
"""

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.inference.kv_cache import BlockAllocator, pool_bytes
from deepspeed_tpu_torch.inference.scheduler import Request, RequestScheduler
from deepspeed_tpu_torch.models.transformer import check_servable


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
    prompt_bucket: int = 64            # prompt pad granularity


# JAX ServingConfig fields outside this slice: (their default, ROADMAP item)
_DEFERRED = {
    "ttft_deadline_ms": (None, "A6c (serving reliability tier)"),
    "deadline_ms": (None, "A6c (serving reliability tier)"),
    "max_queue": (None, "A6c (serving reliability tier)"),
    "pool_watermark": (None, "A6c (serving reliability tier)"),
    "dispatch_timeout_s": (None, "A6c (serving reliability tier)"),
    "telemetry_jsonl": (None, "A6c (serving reliability tier)"),
    "enable_prefix_cache": (False, "A6d (prefix cache)"),
    "prefix_cache_blocks": (None, "A6d (prefix cache)"),
    "prefill_token_budget": (None, "A6e (chunked prefill)"),
    "spec_tokens": (0, "A6f (speculative decoding)"),
    "spec_proposer": (None, "A6f (speculative decoding)"),
    "adapter_slots": (0, "A6g (multi-LoRA serving)"),
    "lora_rank": (0, "A6g (multi-LoRA serving)"),
    "request_trace": (False, "A7 (fleet host layer: request tracing)"),
    "role": ("both", "A7 (fleet host layer: disaggregated roles)"),
}


def serving_config(fields: Optional[Dict[str, Any]] = None) -> ServingConfig:
    """ServingConfig from JAX-style field names; a field of the JAX config
    that this slice does not serve raises when set away from its default."""
    fields = dict(fields or {})
    for name, (default, item) in _DEFERRED.items():
        if name in fields and fields.pop(name) != default:
            raise NotImplementedError(f"serving {name} is not ported yet: "
                                      f"ROADMAP {item}")
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
        self.scheduler = RequestScheduler(
            self.allocator, c.max_seqs, c.block_size, c.decode_quantum,
            prompt_blocks=lambda n: self._pad_prompt(n) // c.block_size,
            max_blocks_per_seq=self.MB)
        self.pools = self.model.init_paged_cache(
            num_blocks, c.block_size, dtype=engine.dtype, device=self.device)
        self.pool_bytes = pool_bytes(mcfg, num_blocks, c.block_size,
                                     dtype=engine.dtype)
        self._tokens = torch.zeros((c.max_seqs,), dtype=torch.long,
                                   device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._finished: List[Request] = []
        self._stats_t0: Optional[float] = None
        self._itl_ms: List[float] = []
        self._dispatches = {"prefills": 0, "decode_steps": 0}

    # ---- device programs ---------------------------------------------

    def _pad_prompt(self, n: int) -> int:
        return max(self._bucket,
                   min(-(-n // self._bucket) * self._bucket,
                       self.max_model_len))

    def _sample(self, logits):
        """[S, V] f32 logits -> [S] token ids. Greedy ties take the first
        index, as jnp.argmax does."""
        t = self.config.temperature
        if t and t > 0:
            probs = torch.softmax(logits / t, dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    def _dispatch_prefill(self, req: Request) -> None:
        """Dispatch (no sync) the request's (re-)prefill: writes its
        context rows into its blocks and leaves the next sampled token
        pending in the device token vector and on the request, fetched at
        the round boundary."""
        ctx = req.context
        P = self._pad_prompt(ctx.size)
        buf = np.zeros((1, P), np.int64)
        buf[0, :ctx.size] = ctx
        nblk = P // self.config.block_size
        block_ids = torch.as_tensor(req.block_ids[:nblk], dtype=torch.long)
        last = self.model.prefill_paged(
            self.engine.params, torch.from_numpy(buf).to(self.device),
            self.pools, block_ids.to(self.device), length=ctx.size)
        first = self._sample(last)
        self._tokens[req.slot] = first[0]
        req.cached_rows = ctx.size
        req.prefill_done = True
        req._first_dev = first
        self._dispatches["prefills"] += 1

    def _tables_device(self):
        S = self.config.max_seqs
        ids = np.zeros((S, self.MB), np.int32)
        lens = np.zeros((S,), np.int32)
        act = np.zeros((S,), bool)
        for req in self.scheduler.running:
            ids[req.slot, :len(req.block_ids)] = req.block_ids
            lens[req.slot] = req.cached_rows
            act[req.slot] = req.prefill_done
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (ids, lens, act))

    def _quantum(self, tables, seq_lens, active) -> List[torch.Tensor]:
        """``decode_quantum`` decode steps of every slot, dispatched back
        to back; returns each step's sampled tokens (still on device)."""
        tokens, lens = self._tokens, seq_lens
        step = active.to(torch.int32)
        outs = []
        for _ in range(self.config.decode_quantum):
            logits = self.model.decode_step_paged(
                self.engine.params, tokens, self.pools, tables, lens,
                active=active)
            tokens = torch.where(active, self._sample(logits), tokens)
            lens = lens + step
            outs.append(tokens)
        self._tokens = tokens
        self._dispatches["decode_steps"] += len(outs)
        return outs

    # ---- request API -------------------------------------------------

    def add_request(self, prompt_ids, max_new_tokens: int = 64,
                    request_id: Optional[int] = None) -> int:
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
        req = self.scheduler.submit(prompt, max_new_tokens, rid=request_id)
        if self._stats_t0 is None:
            self._stats_t0 = req.submit_t
        return req.rid

    def step(self) -> List[Request]:
        """One scheduling round: evict/admit/preempt at the boundary, the
        admitted requests' prefills, one decode quantum, one token fetch.
        Returns the requests finished this round."""
        decisions = self.scheduler.schedule()
        for req, start, n in decisions["prefill"]:
            # no prefix cache and no token budget: every admission
            # prefills its whole context at once
            self._dispatch_prefill(req)
        running = self.scheduler.running
        if not running:
            return []
        pending = [(req, req._first_dev) for req in running
                   if getattr(req, "_first_dev", None) is not None]
        outs = self._quantum(*self._tables_device())
        # the ONE sync of the round: every decode step's tokens and every
        # pending prefill token in a single device-to-host copy
        S = self.config.max_seqs
        flat = torch.cat([t.reshape(-1) for t in outs]
                         + [f.reshape(-1) for _, f in pending])
        host = flat.cpu().numpy()
        toks = host[:len(outs) * S].reshape(len(outs), S)
        firsts = host[len(outs) * S:]
        return self._commit_round(toks, pending, firsts)

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

    def _commit_round(self, toks, pending, firsts) -> List[Request]:
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
            for i in range(toks.shape[0]):
                if self._done(req):
                    break
                self._append(req, int(toks[i, req.slot]), eos)
                got += 1
            req.cached_rows += toks.shape[0]
            self._note_tokens(req, got, now)
            if self._done(req):
                self.scheduler.finish(req)
                self._finished.append(req)
                finished.append(req)
        return finished

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
        generated) for this call's requests."""
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

    # ---- stats -------------------------------------------------------

    def reset_stats(self) -> None:
        """Start a fresh measurement window (pool and scheduler state
        untouched)."""
        self._finished = []
        self._stats_t0 = None
        self._itl_ms = []
        self._dispatches = {"prefills": 0, "decode_steps": 0}

    def stats(self) -> Dict[str, float]:
        """TTFT p50/p99 (ms, measured at the round boundary where the first
        token reached the host), inter-token latency p50/p99, aggregate
        generated-token throughput, and the dispatch counts (prefills and
        decode steps) the kernels' launch counts are checked against."""
        done = [r for r in self._finished if r.first_token_t is not None]
        out: Dict[str, float] = {
            "completed": float(len(self._finished)),
            "preemptions": float(sum(r.preemptions for r in self._finished)),
            "pool_bytes": float(self.pool_bytes),
            "queue_depth": float(self.scheduler.num_waiting),
        }
        out.update({k: float(v) for k, v in self._dispatches.items()})
        if done:
            ttft = np.asarray([(r.first_token_t - r.submit_t) * 1e3
                               for r in done])
            out["p50_ttft_ms"] = float(np.percentile(ttft, 50))
            out["p99_ttft_ms"] = float(np.percentile(ttft, 99))
        if self._itl_ms:
            itl = np.asarray(self._itl_ms)
            out["p50_itl_ms"] = float(np.percentile(itl, 50))
            out["p99_itl_ms"] = float(np.percentile(itl, 99))
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
    ``serving`` takes ServingConfig field names. Runs on the card:
    ``device=None`` means "cuda" and raises when CUDA is missing."""
    sc = serving_config(serving)
    eng = init_inference(model, config=config, dtype=dtype, params=params,
                         device=device, seed=seed, **kwargs)
    return ServingEngine(eng, sc, seed=seed)

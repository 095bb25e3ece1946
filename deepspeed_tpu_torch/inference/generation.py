"""One-shot decode loops (one batch, rows in lockstep), PyTorch port of
``deepspeed_tpu/inference/generation.py``.

Primary path — the contiguous KV cache: one prefill (the flash kernel,
B1) seeds per-layer K/V buffers, then ``n_steps`` decode steps each
write one row per layer in place. Shape buckets as in JAX: the prompt
padded to 64, the token budget to 32, both clamped to the model's
``max_seq_len``.

The decode loop runs single-level. JAX's two-level suffix scheme
(``init_suffix`` / ``decode_step_suffix`` / ``merge_suffix``) keeps the
ring buffer out of its scan carry, which XLA double-buffered: a copy of
the whole buffer every token. Eager PyTorch writes the row in place and
copies nothing, so the scheme would only add a suffix term to every
step's softmax. It keeps JAX's segmented read windows: each segment's
steps read a prefix of the buffer that just covers the rows written so
far, rounded up to ``SEGMENT``.

An int8 cache (``kv_cache_bits=8``) quantizes each step's rows as they
are written, as the paged int8 pool does. JAX does the same below a
1024-row buffer; from 1024 rows its two-level loop keeps the current
segment's rows unquantized in the suffix until the segment ends, so there
the two read those rows differently (the int8 parity bar, first tokens
equal and near-total agreement, covers both).

JAX's full-recompute fallback (``_generate_recompute``) serves a model
without the cache protocol; every model of the port (``make_model``)
carries it, so the fallback is not ported.

Sampling: greedy ties take the first index, as ``jnp.argmax``; at
``temperature > 0`` tokens are drawn from an explicit ``torch.Generator``
(``rng``; seeded 0 when not given), so they cannot match JAX's draws bit
for bit. Multi-tenant serving lives in ``inference/serving.py``.
"""

from typing import Optional

import torch

SEGMENT = 256  # decode read-window granularity (read_len buckets)


def _round_up(n: int, m: int = 64) -> int:
    return ((n + m - 1) // m) * m


def _sampler(temperature: float, rng: torch.Generator):
    def sample(logits):
        if temperature and temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=rng)[:, 0]
        return torch.argmax(logits, dim=-1)
    return sample


def generate(engine, input_ids, max_new_tokens: int = 32,
             temperature: float = 0.0, rng: Optional[torch.Generator] = None):
    """``input_ids``: [B, P] or [P] ids (array or tensor) -> [B, P +
    max_new_tokens] long tensor on the engine's device."""
    ids = torch.as_tensor(input_ids).long().to(engine.device)
    if ids.dim() == 1:
        ids = ids[None]
    if rng is None:
        rng = torch.Generator(device=engine.device).manual_seed(0)
    with torch.no_grad():
        return _generate_cached(engine, ids, max_new_tokens, temperature,
                                rng)


def _generate_cached(engine, ids, max_new_tokens, temperature, rng):
    B, prompt_len = ids.shape
    pad_prompt = _round_up(prompt_len)
    n_steps = _round_up(max_new_tokens, 32)
    max_len = pad_prompt + n_steps
    limit = getattr(engine.model.config, "max_seq_len", None)
    if limit:
        if prompt_len + max_new_tokens > limit:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the model's max_seq_len {limit}")
        # stay within the position range; decode steps past it only touch
        # rows whose tokens are discarded
        pad_prompt = min(pad_prompt, limit)
        max_len = min(max_len, limit)
    buf = torch.zeros((B, pad_prompt), dtype=ids.dtype, device=ids.device)
    buf[:, :prompt_len] = ids
    model = engine.model
    cache = model.init_cache(B, max_len, dtype=engine.dtype,
                             device=engine.device)
    last, cache = model.prefill(engine.params, buf, cache, length=prompt_len)
    loop = make_decode_loop(model, n_steps, temperature, start_len=pad_prompt,
                            max_len=max_len)
    tokens = loop(engine.params, last, cache, rng)
    return torch.cat([ids, tokens[:, :max_new_tokens].to(ids.dtype)], dim=1)


def make_decode_loop(model, n_steps: int, temperature: float,
                     start_len: int, max_len: int):
    """The whole decode as one function ``loop(params, first_logits, cache,
    rng) -> tokens [B, n_steps]``: the first token comes from the
    prefill's logits, each step feeds the previous token and samples the
    next (the last step's sample is dropped, as in JAX). The cache holds
    ``start_len`` rows and ``max_len`` in all; steps read a static prefix
    window of the buffer, segment by segment; no host sync inside the
    loop."""

    def loop(params, first_logits, cache, rng):
        sample = _sampler(temperature, rng)
        tok = sample(first_logits)
        out = []
        done = 0
        while done < n_steps:
            seg = min(SEGMENT, n_steps - done)
            # rows touched in this segment: < start_len + done + seg
            read_len = min(max_len,
                           -(-(start_len + done + seg) // SEGMENT) * SEGMENT)
            for _ in range(seg):
                logits, cache = model.decode_step(params, tok, cache,
                                                  read_len=read_len)
                out.append(tok)
                tok = sample(logits)
            done += seg
        return torch.stack(out, dim=1)

    return loop


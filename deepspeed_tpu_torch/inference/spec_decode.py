"""Speculative decoding: cheap proposals, one paged verify, greedy accept.
PyTorch port of ``deepspeed_tpu/inference/spec_decode.py``.

A proposer guesses the next K tokens of a decoding request; the target
model scores the pending token plus the K guesses in ONE
``decode_span_paged`` pass, and the accept rule keeps the longest prefix
of guesses the model itself would have produced, plus the model's own
token at the first divergence: every verify step nets at least one token
and at most K + 1.

Greedy acceptance preserves the output by induction: position 0's
logits depend only on committed state, so its argmax is greedy decoding's
token; a guess is accepted only when it equals that argmax, which makes
position 1's inputs the sequential ones, and so on. Emitted tokens are
always the target model's argmaxes, so the stream is the unspeculated
stream (the engine refuses temperature > 0 while speculation is on).

Rejected guesses cost only their verify FLOPs: the per-slot cursor does
not advance past the accepted prefix and the stale rows are overwritten
by later writes; no block is freed, so shared blocks are untouched.

The default proposer is self-drafting n-gram lookup (prompt lookup): the
most recent earlier occurrence of the context's last n tokens proposes
what followed it. A draft model drops into the same hook
(``ServingConfig.spec_proposer``): any callable ``(context: np.ndarray,
k: int) -> array of <= k token ids``.
"""

from typing import Callable, Optional

import numpy as np
import torch

# a draft hook: (host context token ids, k) -> up to k proposed ids
Proposer = Callable[[np.ndarray, int], np.ndarray]


class NgramProposer:
    """Self-drafting proposer: match the trailing ``n``-gram of the
    context against its own history (the rightmost earlier occurrence
    wins) and propose the tokens that followed it. No match proposes
    zeros, which the verify step simply rejects (a pad is accepted only
    when it is the model's own argmax, the right token by definition)."""

    def __init__(self, n: int = 3):
        if n < 1:
            raise ValueError(f"ngram n={n}: need >= 1")
        self.n = int(n)

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        ctx = np.asarray(context, np.int64).reshape(-1)
        out = np.zeros((k,), np.int32)
        n = min(self.n, ctx.size - 1)
        if n < 1 or ctx.size <= n:
            return out
        gram = ctx[ctx.size - n:]
        win = np.lib.stride_tricks.sliding_window_view(ctx, n)
        hits = np.flatnonzero((win[:-1] == gram).all(axis=1))
        if hits.size:
            s = int(hits[-1])
            cont = ctx[s + n:s + n + k].astype(np.int32)
            out[:cont.size] = cont
        return out


def greedy_accept_len(next_tokens, proposals):
    """Length of the accepted proposal prefix, on the device (no host
    round trip in the accept decision). next_tokens: [..., K+1] the
    model's argmax at each verified position; proposals: [..., K].
    Accepted = the leading run where ``next_tokens[i] == proposals[i]``.
    Returns [...] longs in [0, K]."""
    k = proposals.shape[-1]
    match = (next_tokens[..., :k] == proposals).long()
    return torch.cumprod(match, dim=-1).sum(dim=-1)


def make_proposer(spec_proposer: Optional[Proposer],
                  ngram: int) -> Proposer:
    """The engine's hook resolution: an explicit draft callable wins,
    otherwise the self-drafting n-gram proposer."""
    if spec_proposer is not None:
        return spec_proposer
    return NgramProposer(ngram).propose

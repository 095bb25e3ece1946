"""Mixture-of-experts gating, capacity and the expert FFN, the port of
``deepspeed_tpu/moe/sharded_moe.py``.

Gating is JAX's (the reference's top1/top2 gating): softmax of the f32
gate logits, k argmax choices, each token's position in its expert by
sequence order, the second choice placed after the FULL pre-drop count of
the first (slots freed by dropped first choices are not reused), tokens
past the capacity dropped, the kept gates normalized over the k choices,
and the switch aux loss from the first choice. Capacity comes from the
number of tokens routed together: ``ceil(T / E * factor)``, at least
``min_capacity``, with ``eval_capacity_factor`` when not training; with
``drop_tokens=False`` it is T (nothing drops).

Under expert parallelism each rank holds ``E / ep`` consecutive experts
(``moe_w_*`` [E_local, ...]), and under tensor parallelism a slice of
their FFN width. Tokens are NOT split: every rank routes all T tokens
(the same gating on the same inputs), computes its experts' outputs at
their capacity slots and its part of each token's combine, and one
``all_reduce`` over the tensor and expert axes sums the parts. JAX
reaches the same function through GSPMD's all-to-alls; ``moe/mappings``'s
token split under TP is a sharding constraint with no numeric effect
there, and is not copied: splitting tokens before gating would change T,
hence the capacity and the drops. The combine is summed over the k
choices in f32 in choice order, so with k <= 2 the expert-parallel sum
equals the unsharded one bit for bit (two non-zero terms; adding zeros
is exact).

JAX computes the dispatch and the expert products as einsums outside any
Pallas kernel; here they are a scatter, ``bmm`` and a gather: there is no
kernel to port.
"""

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.parallel.context import all_reduce, axis_index


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    cap = int(math.ceil(num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


def _noisy(logits, noise_policy, train, generator):
    """The gate noise of training (JAX's ``Jitter``: a multiplicative
    uniform in [0.99, 1.01]; ``RSample``: additive Gumbel), drawn from
    ``generator``. Serving routes without noise."""
    if not train or generator is None or noise_policy is None:
        return logits
    u = torch.empty(logits.shape, dtype=logits.dtype, device=logits.device)
    if noise_policy == "Jitter":
        return logits * u.uniform_(1.0 - 1e-2, 1.0 + 1e-2,
                                   generator=generator)
    if noise_policy == "RSample":
        u.uniform_(torch.finfo(u.dtype).tiny, 1.0, generator=generator)
        return logits - torch.log(-torch.log(u))
    raise ValueError(f"noisy_gate_policy={noise_policy!r}: None, Jitter "
                     "or RSample")


def route(logits, k: int, capacity: int, *, generator=None,
          noise_policy: Optional[str] = None, train: bool = True):
    """The gating decisions per choice: ``(idx [T], pos [T], weight [T],
    keep [T])`` for each of the k choices (expert, slot in its expert,
    normalized combine weight, 0 when dropped; kept or not), the aux loss
    and the metrics. ``top_k_gating`` lays the same decisions out as
    JAX's dense tensors."""
    T, E = logits.shape
    logits = _noisy(logits, noise_policy, train, generator)
    gates = torch.softmax(logits.float(), dim=-1)                # [T, E]
    masked = gates
    gate_sum = torch.zeros((T,), dtype=torch.float32, device=gates.device)
    claimed = torch.zeros((E,), dtype=torch.long, device=gates.device)
    aux = gates.new_zeros(())
    metrics: Dict[str, torch.Tensor] = {}
    picks = []
    for choice in range(k):
        idx = torch.argmax(masked, dim=-1)        # first index on ties
        onehot = F.one_hot(idx, E).float()                       # [T, E]
        if choice == 0:           # the aux loss reads the first choice
            ce = onehot.mean(0)
            aux = (gates.mean(0) * ce).sum() * E
            metrics["expert_load"] = ce
        # sequence priority within the expert, after the earlier choices'
        # full (pre-drop) claims
        pos = ((torch.cumsum(onehot, 0) - 1.0) * onehot).sum(-1).long() \
            + claimed[idx]
        keep = pos < capacity
        gate_val = torch.where(keep, gates.gather(1, idx[:, None])[:, 0],
                               torch.zeros_like(gate_sum))
        gate_sum = gate_sum + gate_val
        claimed = claimed + onehot.sum(0).long()
        masked = masked * (1.0 - onehot)
        picks.append((idx, pos, gate_val, keep))
    if k > 1:                 # normalize the kept gates over the k choices
        safe = torch.where(gate_sum > 0, gate_sum, torch.ones_like(gate_sum))
        picks = [(i, p, g / safe, kp) for i, p, g, kp in picks]
    kept = sum(kp.sum() for _, _, _, kp in picks)     # no host sync
    metrics["dropped_fraction"] = 1.0 - kept / (T * k)
    return picks, aux, metrics


def top_k_gating(logits, k: int, capacity: int, *, generator=None,
                 noise_policy: Optional[str] = None, train: bool = True):
    """JAX's ``top_k_gating``: logits [T, E] -> (combine [T, E, C] f32,
    dispatch [T, E, C] bool, aux loss, metrics). ``generator`` draws the
    training noise of ``noise_policy``."""
    T, E = logits.shape
    picks, aux, metrics = route(logits, k, capacity, generator=generator,
                                noise_policy=noise_policy, train=train)
    combine = torch.zeros((T, E, capacity), dtype=torch.float32,
                          device=logits.device)
    rows = torch.arange(T, device=logits.device)
    for idx, pos, w, keep in picks:
        combine[rows[keep], idx[keep], pos[keep]] = w[keep]
    dispatch = combine > 0
    return combine, dispatch, aux, metrics


def moe_ffn(moe_params, x, cfg, *, generator=None, train: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE feed-forward over x [B, S, H] (all B * S tokens routed
    together); ``moe_params``: {"wg": [H, E], "w_in": [E_l, H, F_l],
    "w_out": [E_l, F_l, H], optional "w_gate": [E_l, H, F_l]} with this
    rank's experts and FFN slice. Returns (y [B, S, H], aux loss)."""
    B, S, H = x.shape
    T = B * S
    tokens = x.reshape(T, H)
    wg = moe_params["wg"]
    E = wg.shape[-1]
    cf = cfg.capacity_factor if train else cfg.eval_capacity_factor
    C = _capacity(T, E, cf, cfg.min_capacity)
    if not cfg.drop_tokens:
        C = T
    picks, aux, _ = route(tokens.float() @ wg.float(), cfg.top_k, C,
                          generator=generator,
                          noise_policy=cfg.noisy_gate_policy, train=train)
    w_in = moe_params["w_in"]
    E_l = w_in.shape[0]
    e0 = axis_index("expert") * E_l
    # each local (expert, slot) holds at most one token: a scatter is
    # JAX's one-hot dispatch product, exactly. Tokens routed elsewhere
    # (another rank's expert, or dropped) land in one trash row past the
    # slots, so no step depends on how many there are (no host sync)
    slots = E_l * C
    expert_in = x.new_zeros((slots + 1, H))
    flat = []
    for idx, pos, _, keep in picks:
        mine = keep & (idx >= e0) & (idx < e0 + E_l)
        at = (idx - e0) * C + pos
        expert_in[torch.where(mine, at, torch.full_like(at, slots))] = tokens
        flat.append((torch.where(mine, at, torch.zeros_like(at)), mine))
    expert_in = expert_in[:slots].view(E_l, C, H)
    up = torch.bmm(expert_in, w_in.to(x.dtype))
    if "w_gate" in moe_params:
        act = F.silu(torch.bmm(expert_in, moe_params["w_gate"].to(x.dtype))
                     ) * up
    else:
        act = F.gelu(up, approximate="tanh")        # jax.nn.gelu's default
    out = torch.bmm(act, moe_params["w_out"].to(x.dtype)).view(E_l * C, H)
    # the combine in f32, choice by choice: each product of the weight
    # (in x's dtype, as JAX casts the combine) and the slot's output
    y = torch.zeros((T, H), dtype=torch.float32, device=x.device)
    for (f, mine), (_, _, w, _) in zip(flat, picks):
        wk = torch.where(mine, w, torch.zeros_like(w)).to(x.dtype).float()
        y = y + wk[:, None] * out[f].float()
    all_reduce(y, "tensor", "expert")
    return y.to(x.dtype).reshape(B, S, H), aux

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

Serving (no batch split): under expert parallelism each rank holds ``E /
ep`` consecutive experts (``moe_w_*`` [E_local, ...]), and under tensor
parallelism a slice of their FFN width. Tokens are NOT split: every rank
routes all T tokens (the same gating on the same inputs), computes its
experts' outputs at their capacity slots and its part of each token's
combine, and one in-place ``all_reduce`` over the tensor and expert axes
sums the parts. The combine is summed over the k choices in f32 in choice
order, so with k <= 2 the expert-parallel sum equals the unsharded one bit
for bit (two non-zero terms; adding zeros is exact).

Training (``train=True``; ``parallel.context.batch_rows`` says each
rank of the batch axes holds its own rows; autograd records where the
params need grads): JAX's ``moe_ffn``
sees the global batch through GSPMD, so T, the capacity and each token's
place in the cumsum order are those of the whole micro-batch. The port
gathers the micro-batch's tokens over the batch axes (data, fsdp,
expert) in rank order, which is the global order, before the gate
(``gather_along``; its backward sums the grads onto each rank's rows),
routes them all on every rank, runs its experts over their slots, and
combines only the rows of its expert group (the ranks that differ only
along ``expert``); a ``reduce_scatter`` over ``expert`` sums the group's
partial outputs onto each rank's own rows (``scatter_along``). Under a
tensor axis the dispatched tokens and the combine weights enter through
``copy_to_tensor`` (each rank's FFN slice gives a partial grad) and the
partial outputs are summed onto the rank's sequence piece and gathered
back (``moe/mappings``). The aux loss is the whole micro-batch's on every
rank: the engine averages the ranks' losses and grads, so it counts
once. The gate noise (``Jitter`` / ``RSample``) is drawn from a
``torch.Generator`` the model seeds by (seed, step, micro-batch, layer),
so the remat replay redraws it exactly; it cannot match ``jax.random``
value for value.

JAX computes the dispatch and the expert products as einsums outside any
Pallas kernel; here they are a scatter, ``bmm`` and a gather: there is no
kernel to port.
"""

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

import contextlib

from deepspeed_tpu_torch.moe.mappings import gather_tokens
from deepspeed_tpu_torch.parallel.context import (all_reduce, axis_index,
                                                  axis_size, copy_to_tensor,
                                                  gather_along, scatter_along,
                                                  seq_offset,
                                                  seq_parallel_degree,
                                                  split_axes)

_RECORD: Optional[list] = None
# a ``frozen_routing`` block's expert choices ({layer: [idx [T] per
# choice]}), and the layer ``layer_scope`` says is running
_FROZEN: Optional[dict] = None
_LAYER: Optional[int] = None


@contextlib.contextmanager
def record_routing():
    """Collect each ``moe_ffn`` call's aux loss and dropped fraction (0-dim
    tensors, detached, in call order) for the block: ``with
    record_routing() as rec: ...``; ``rec`` is a list of dicts."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


@contextlib.contextmanager
def frozen_routing():
    """Inside the block each MoE layer keeps the expert choices of its
    first call there (its capacity slots and drops follow from them), so
    the loss is smooth in the params around that call's: the function
    whose derivatives JAX takes through its gate (an argmax has none).
    MoQ's probe differentiates by a central difference of two gradient
    passes, which a routing flip between them would break."""
    global _FROZEN
    prev, _FROZEN = _FROZEN, {}
    try:
        yield
    finally:
        _FROZEN = prev


@contextlib.contextmanager
def layer_scope(i: int):
    """Layer ``i`` of the stack runs in the block (``frozen_routing``'s
    key; a rematerialized layer replays under its own scope)."""
    global _LAYER
    prev, _LAYER = _LAYER, i
    try:
        yield
    finally:
        _LAYER = prev


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
          noise_policy: Optional[str] = None, train: bool = True,
          choices=None):
    """The gating decisions per choice: ``(idx [T], pos [T], weight [T],
    keep [T])`` for each of the k choices (expert, slot in its expert,
    normalized combine weight, 0 when dropped; kept or not), the aux loss
    and the metrics. ``choices``: each choice's experts, given instead
    of the argmax (``frozen_routing``). ``top_k_gating`` lays the same
    decisions out as JAX's dense tensors."""
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
        idx = (torch.argmax(masked, dim=-1)       # first index on ties
               if choices is None else choices[choice])
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
    together, or on the training path the whole micro-batch's: see the
    module note); ``moe_params``: {"wg": [H, E], "w_in": [E_l, H, F_l],
    "w_out": [E_l, F_l, H], optional "w_gate": [E_l, H, F_l]} with this
    rank's experts and FFN slice. ``generator`` draws the gate noise of
    training. Returns (y [B, S, H], aux loss)."""
    graph = torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in moe_params.values()))
    axes = split_axes()
    tp = axis_size("tensor")
    # over ``seq`` the rank holds a piece of each sequence: the layer
    # routes the whole sequences (JAX's gate sees the global tokens) and
    # keeps its piece of the output; each rank's aux is 1 / sp of the
    # whole's, so the sum over ``seq`` counts it once
    sp, Sl = seq_parallel_degree(), x.shape[1]
    if sp > 1:
        x = gather_along(x, "seq", dim=1)
    B, S, H = x.shape
    xs = gather_along(x, axes, dim=0) if axes else x
    Bg = xs.shape[0]
    T = Bg * S
    tokens = xs.reshape(T, H)
    wg = moe_params["wg"]
    E = wg.shape[-1]
    cf = cfg.capacity_factor if train else cfg.eval_capacity_factor
    C = _capacity(T, E, cf, cfg.min_capacity)
    if not cfg.drop_tokens:
        C = T
    frozen = None if _FROZEN is None else _FROZEN.get(_LAYER)
    picks, aux, metrics = route(tokens.float() @ wg.float(), cfg.top_k, C,
                                generator=generator,
                                noise_policy=cfg.noisy_gate_policy,
                                train=train, choices=frozen)
    if _FROZEN is not None and frozen is None:
        _FROZEN[_LAYER] = [idx.detach() for idx, _, _, _ in picks]
    if _RECORD is not None:
        _RECORD.append({"aux": aux.detach(),
                        "dropped_fraction": metrics["dropped_fraction"]})
    if graph and tp > 1:
        tokens = copy_to_tensor(tokens)
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
    # the rows this rank combines: its expert group's (the whole batch
    # when the rows are not split)
    grp = Bg
    if axes:
        grp = Bg // math.prod(axis_size(a) for a in axes if a != "expert")
    t0 = (axis_index("data") * axis_size("fsdp") + axis_index("fsdp")) \
        * grp * S if axes else 0
    rows = slice(t0, t0 + grp * S)
    # the combine in f32, choice by choice: each product of the weight
    # (in x's dtype, as JAX casts the combine) and the slot's output
    y = torch.zeros((grp * S, H), dtype=torch.float32, device=x.device)
    for (f, mine), (_, _, w, _) in zip(flat, picks):
        wk = torch.where(mine, w, torch.zeros_like(w))[rows]
        if graph and tp > 1:
            wk = copy_to_tensor(wk)
        y = y + wk.to(x.dtype).float()[:, None] * out[f[rows]].float()
    y = y.view(grp, S, H)
    if "expert" in axes:
        y = scatter_along(y, "expert", dim=0)
    elif not axes and axis_size("expert") > 1:
        if graph:
            raise ValueError(
                "moe_ffn with a graph over an expert axis needs the rows "
                "split over the batch axes (parallel.context.batch_rows), "
                "as the engine's training step gives them")
        all_reduce(y, "expert")
    if tp > 1:
        if graph:
            y = gather_tokens(scatter_along(y, "tensor", dim=1), dim=1)
        else:
            all_reduce(y, "tensor")
    if sp > 1:
        y, aux = y.narrow(1, seq_offset(Sl), Sl), aux / sp
    return y.to(x.dtype), aux

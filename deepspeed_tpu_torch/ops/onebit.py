"""The 1-bit optimizers, a port of ``deepspeed_tpu/ops/onebit.py``:
``onebit_adam`` (the reference's ``onebit/adam.py``), ``onebit_lamb``
(``onebit/lamb.py``) and ``zero_one_adam`` (``onebit/zoadam.py``).

Each is a ``PhasedOptimizer``: the engine owns the count of applied
updates and picks the phase (``phase_for``), and ``update_phase`` runs it
with the data axis to communicate over:

- warm-up ("warm"; 0/1 Adam's "dense"): the dense mean of the grads over
  the axis, then the optimizer's own update;
- compressed ("comp"; 0/1 Adam's "sync"): each rank's momentum from its
  local grads, plus its error feedback, crosses the wire as packed signs
  and one scale (``comm/compressed.py``); the variance is frozen (1-bit
  LAMB also freezes its trust ratios);
- 0/1 Adam's "local": momentum from local grads, no collective, params
  untouched (the sync after applies the interval-scaled update once, as
  JAX's SPMD adaptation does).

``update`` is the dense single-program form the engine takes off the
compressed path (grads already reduced, ZeRO-sharded state): warm-up
below the freeze step, then the compressed update with no wire (the
local sign x scale of the momentum plus error).

Rank-varying state (``rank_varying``: the error feedback; 0/1 Adam's
momentum too) is each rank's own; a checkpoint stacks it over the data
axis, as JAX's leading ``[dp]`` dim does. Plain torch, in place, as the
port's other optimizers; ``step`` and ``local_steps`` are host ints.
"""

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.compressed import compressed_allreduce_1bit
from deepspeed_tpu_torch.ops.lamb import trust_ratio
from deepspeed_tpu_torch.ops.optimizers import (ScalarOrSchedule, _grads32,
                                                _lr_at, _master_init,
                                                _resolve_master, _writeback,
                                                _zeros32, leaf_sum,
                                                tree_leaves, tree_map)


class PhasedOptimizer(NamedTuple):
    """An optimizer with per-phase updates for the compressed path, plus
    the dense single-program ``update``."""
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]
    update_phase: Callable[..., Any]   # (grads, state, params, *, phase, axis)
    phase_for: Callable[[int], str]    # applied-update count -> phase
    rank_varying: Tuple[str, ...]      # state keys each rank keeps its own


def _bias(b: float, step: int) -> float:
    return float(np.float32(1) - np.float32(b) ** np.float32(step))


def _mean_over(gs, axis: Optional[str]):
    """The dense mean of every grad leaf over ``axis`` (in place)."""
    if axis is not None:
        for g in gs:
            comm.all_reduce(g, axis, op="mean")
    return gs


def _compress(i: int, m: torch.Tensor, err: torch.Tensor,
              axis: Optional[str]):
    """Error-feedback compression of leaf ``i``'s momentum, in place:
    corrected = m + err; m <- the mean over ``axis`` of every rank's
    sign x scale (no axis: this rank's own); err <- corrected - this
    rank's sign x scale. The sign is JAX's (x >= 0 is +), so an exact 0
    carries no bias the error feedback never sees."""
    corrected = m + err
    stats = leaf_sum(i, torch.stack([corrected.abs().sum(), torch.tensor(
        float(corrected.numel()), device=m.device)]))
    scale = stats[0] / stats[1]
    local = torch.where(corrected >= 0, scale, -scale)
    synced = (local if axis is None
              else compressed_allreduce_1bit(corrected, axis, scale))
    err.copy_(corrected - local)
    m.copy_(synced)


def _state(params, use_master_weights: bool, **extra):
    return {"step": 0, "exp_avg": tree_map(_zeros32, params),
            "exp_avg_sq": tree_map(_zeros32, params),
            "error": tree_map(_zeros32, params), **extra,
            "master": _master_init(params, use_master_weights)}


def _coupled_decay(gs, master, weight_decay: float):
    """JAX's coupled decay of the 1-bit Adams: g + wd * p, before the
    momentum and the compression (the decay term rides the 1-bit
    stream)."""
    if not weight_decay:
        return gs
    return [g + weight_decay * p for g, p in zip(gs, tree_leaves(master))]


def _adam_apply(master, state, step: int, lr, b1, b2, eps,
                scale: float = 1.0):
    """p <- p - lr * scale * (m / c1) / (sqrt(v / c2) + eps), JAX's order
    of operations."""
    lr_t = _lr_at(lr, step) * scale
    c1, c2 = _bias(b1, step), _bias(b2, step)
    for p, m, v in zip(tree_leaves(master), tree_leaves(state["exp_avg"]),
                       tree_leaves(state["exp_avg_sq"])):
        p.sub_(lr_t * (m / c1) / ((v / c2).sqrt() + eps))


def _momentum(state, gs, b1):
    for m, g in zip(tree_leaves(state["exp_avg"]), gs):
        m.mul_(b1).add_((1 - b1) * g)


def _variance(state, gs, b2):
    for v, g in zip(tree_leaves(state["exp_avg_sq"]), gs):
        v.mul_(b2).add_((1 - b2) * g * g)


def _compress_tree(state, axis):
    for i, (m, e) in enumerate(zip(tree_leaves(state["exp_avg"]),
                                   tree_leaves(state["error"]))):
        _compress(i, m, e, axis)


def onebit_adam(lr: ScalarOrSchedule = 1e-3, betas=(0.9, 0.999),
                eps: float = 1e-8, weight_decay: float = 0.0,
                freeze_step: int = 100,
                use_master_weights: bool = True) -> PhasedOptimizer:
    """1-bit Adam: dense Adam for ``freeze_step`` updates, then the
    variance freezes and the momentum crosses the wire sign-compressed
    with error feedback."""
    b1, b2 = betas

    def init(params):
        return _state(params, use_master_weights)

    @torch.no_grad()
    def update_phase(grads, state, params, *, phase: str,
                     axis: Optional[str] = None):
        step = state["step"] + 1
        master = _resolve_master(params, state.get("master"))
        gs = _coupled_decay(_grads32(grads), master, weight_decay)
        if phase == "warm":
            gs = _mean_over(gs, axis)
            _momentum(state, gs, b1)
            _variance(state, gs, b2)
        else:
            _momentum(state, gs, b1)
            _compress_tree(state, axis)
        _adam_apply(master, state, step, lr, b1, b2, eps)
        _writeback(master, params, state.get("master"))
        state["step"] = step
        return params, state

    def update(grads, state, params):
        phase = "warm" if state["step"] < freeze_step else "comp"
        return update_phase(grads, state, params, phase=phase)

    return PhasedOptimizer(
        init=init, update=update, update_phase=update_phase,
        phase_for=lambda step: "warm" if step < freeze_step else "comp",
        rank_varying=("error",))


def onebit_lamb(lr: ScalarOrSchedule = 1e-3, betas=(0.9, 0.999),
                eps: float = 1e-6, weight_decay: float = 0.0,
                freeze_step: int = 100, min_trust: float = 0.01,
                max_trust: float = 10.0,
                use_master_weights: bool = True) -> PhasedOptimizer:
    """1-bit LAMB: LAMB for ``freeze_step`` updates, keeping each leaf's
    trust ratio; then the momentum goes 1-bit and the frozen ratios scale
    the update."""
    b1, b2 = betas

    def init(params):
        return _state(params, use_master_weights, frozen_ratio=tree_map(
            lambda p: torch.ones((), dtype=torch.float32, device=p.device),
            params))

    @torch.no_grad()
    def update_phase(grads, state, params, *, phase: str,
                     axis: Optional[str] = None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        c1, c2 = _bias(b1, step), _bias(b2, step)
        master = _resolve_master(params, state.get("master"))
        gs = _grads32(grads)
        if phase == "warm":
            gs = _mean_over(gs, axis)
            _momentum(state, gs, b1)
            _variance(state, gs, b2)
        else:
            _momentum(state, gs, b1)
            _compress_tree(state, axis)
        for i, (p, m, v, r) in enumerate(zip(
                tree_leaves(master), tree_leaves(state["exp_avg"]),
                tree_leaves(state["exp_avg_sq"]),
                tree_leaves(state["frozen_ratio"]))):
            upd = (m / c1) / ((v / c2).sqrt() + eps)
            if weight_decay:
                upd = upd + weight_decay * p
            if phase == "warm":
                r.copy_(trust_ratio(i, p, upd, min_trust, max_trust))
            p.sub_(lr_t * r * upd)
        _writeback(master, params, state.get("master"))
        state["step"] = step
        return params, state

    def update(grads, state, params):
        phase = "warm" if state["step"] < freeze_step else "comp"
        return update_phase(grads, state, params, phase=phase)

    return PhasedOptimizer(
        init=init, update=update, update_phase=update_phase,
        phase_for=lambda step: "warm" if step < freeze_step else "comp",
        rank_varying=("error",))


def zero_one_adam(lr: ScalarOrSchedule = 1e-3, betas=(0.9, 0.999),
                  eps: float = 1e-8, weight_decay: float = 0.0,
                  var_freeze_step: int = 100, local_step_scaler: int = 100,
                  local_step_clipper: int = 16,
                  use_master_weights: bool = True) -> PhasedOptimizer:
    """0/1 Adam: variance freezing plus local steps. After the freeze the
    ranks synchronize every k-th update (k doubling every
    ``local_step_scaler`` updates up to ``local_step_clipper``), and the
    sync itself is 1-bit. As in JAX's SPMD adaptation, a local step
    accumulates momentum from local grads without touching the params,
    and each sync applies the interval-scaled update once, so the params
    stay identical across ranks."""
    b1, b2 = betas

    def init(params):
        return _state(params, use_master_weights, local_steps=0)

    def interval_for(step: int) -> int:
        if step < var_freeze_step:
            return 1
        k = 2 ** ((step - var_freeze_step) // max(1, local_step_scaler))
        return min(int(k), local_step_clipper)

    @torch.no_grad()
    def update_phase(grads, state, params, *, phase: str,
                     axis: Optional[str] = None):
        step = state["step"] + 1
        master = _resolve_master(params, state.get("master"))
        gs = _coupled_decay(_grads32(grads), master, weight_decay)
        local_steps = state["local_steps"]
        if phase == "dense":
            gs = _mean_over(gs, axis)
            _momentum(state, gs, b1)
            _variance(state, gs, b2)
            _adam_apply(master, state, step, lr, b1, b2, eps)
            local_steps = 0
        elif phase == "local":
            _momentum(state, gs, b1)
            local_steps += 1
        else:
            _momentum(state, gs, b1)
            _compress_tree(state, axis)
            _adam_apply(master, state, step, lr, b1, b2, eps,
                        scale=float(np.float32(local_steps + 1)))
            local_steps = 0
        if phase != "local":
            _writeback(master, params, state.get("master"))
        state["step"], state["local_steps"] = step, local_steps
        return params, state

    def phase_for(step: int) -> str:
        if step < var_freeze_step:
            return "dense"
        k = interval_for(step)
        return "sync" if (step - var_freeze_step) % k == k - 1 else "local"

    def update(grads, state, params):
        """Dense fallback: the variance freeze only (grads are already
        reduced, so a skipped sync would skip real work)."""
        phase = "dense" if state["step"] < var_freeze_step else "sync"
        return update_phase(grads, state, params, phase=phase)

    return PhasedOptimizer(
        init=init, update=update, update_phase=update_phase,
        phase_for=phase_for, rank_varying=("exp_avg", "error"))

"""Optimizer core, a port of ``deepspeed_tpu/ops/optimizers.py``: an
optimizer is a pair of functions over a parameter tree (nested dicts of
tensors), ``init(params) -> state`` and ``update(grads, state, params) ->
(params, state)``; with it ``sgd``, ``adagrad`` and ``lion`` (Adam is
``ops/adam.py``, LAMB ``ops/lamb.py``). JAX's ``from_optax`` has no
counterpart: a client passes its own ``Optimizer`` pair to
``initialize(optimizer=...)``.

The JAX functions are pure. Here ``update`` writes in place: the state's
tensors, the f32 master weights, and the params (cast back from the
masters). It returns the same objects, so a step allocates no second copy
of the model. The update is plain torch over the tree's leaves (a llama
has about a dozen stacked leaves); the JAX package leaves it to XLA, so
no kernel is owed.

Master weights: when the params are bf16, the state carries an f32 copy
("master"); the update runs on it and is written back into the params.
"""

import contextlib
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

Schedule = Callable[[int], Any]
ScalarOrSchedule = Union[float, Schedule]


class Optimizer(NamedTuple):
    """init(params) -> state; update(grads, state, params) -> (params,
    state), in place."""
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts (``rest``: trees of the same
    structure, passed leaf for leaf). Keys are visited in sorted order, as
    JAX flattens a dict, so trees built in another order still pair up."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of nested dicts (and lists), in ``tree_map``'s order."""
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _lr_at(lr: ScalarOrSchedule, step: int) -> float:
    """The learning rate of update number ``step``, as an f32 value (the
    schedules are host functions of the host step count: no device work)."""
    return float(np.float32(lr(step) if callable(lr) else lr))


def cast_tree(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def _master_init(params, use_master: bool):
    if not use_master:
        return None
    return tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)


def _resolve_master(params, master):
    """f32 tensors the update writes: the masters, or else the params
    themselves when they are f32 (a temporary f32 copy otherwise)."""
    if master is not None:
        return master
    return tree_map(lambda p: p.detach().float(), params)


def _writeback(new_master, params, master):
    """Cast the updated f32 values back into the params, in place."""
    for p, m in zip(tree_leaves(params), tree_leaves(new_master)):
        if m is not p:
            p.detach().copy_(m)
    return params, master


def _zeros32(p, fill: float = 0.0):
    return torch.full(p.shape, fill, dtype=torch.float32, device=p.device)


def _grads32(grads):
    """The gradient leaves as f32 (the update never writes them)."""
    return tree_leaves(cast_tree(grads, torch.float32))


def sgd(lr: ScalarOrSchedule = 1e-2, momentum: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False,
        use_master_weights: bool = True) -> Optimizer:
    """SGD with optional (Nesterov) momentum and L2 weight decay folded
    into the gradient, as JAX's ``sgd``: state ``step``, ``momentum``
    (f32, only with momentum) and ``master``."""
    def init(params):
        state = {"step": 0}
        if momentum:
            state["momentum"] = tree_map(_zeros32, params)
        state["master"] = _master_init(params, use_master_weights)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        master = _resolve_master(params, state.get("master"))
        bufs = (tree_leaves(state["momentum"]) if momentum
                else [None] * len(tree_leaves(master)))
        for m, g, b in zip(tree_leaves(master), _grads32(grads),
                           bufs):
            if weight_decay:
                g = g + weight_decay * m
            if momentum:
                b.mul_(momentum).add_(g)
                u = g + momentum * b if nesterov else b
            else:
                u = g
            m.sub_(lr_t * u)
        _writeback(master, params, state.get("master"))
        state["step"] = step
        return params, state

    return Optimizer(init, update)


def adagrad(lr: ScalarOrSchedule = 1e-2, eps: float = 1e-10,
            weight_decay: float = 0.0, initial_accumulator: float = 0.0,
            use_master_weights: bool = True) -> Optimizer:
    """Adagrad, as JAX's ``adagrad``: state ``step``, ``accum`` (the f32
    sum of squared gradients) and ``master``."""
    def init(params):
        return {"step": 0,
                "accum": tree_map(lambda p: _zeros32(p, initial_accumulator),
                                  params),
                "master": _master_init(params, use_master_weights)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        master = _resolve_master(params, state.get("master"))
        for m, g, a in zip(tree_leaves(master), _grads32(grads),
                           tree_leaves(state["accum"])):
            if weight_decay:
                g = g + weight_decay * m
            a.add_(g * g)
            m.sub_(lr_t * g / (a.sqrt() + eps))
        _writeback(master, params, state.get("master"))
        state["step"] = step
        return params, state

    return Optimizer(init, update)


def lion(lr: ScalarOrSchedule = 1e-4, beta1: float = 0.9, beta2: float = 0.99,
         weight_decay: float = 0.0,
         use_master_weights: bool = True) -> Optimizer:
    """Lion (sign of the interpolated momentum, decoupled decay), as JAX's
    ``lion``: state ``step``, ``mu`` (f32) and ``master``."""
    def init(params):
        return {"step": 0, "mu": tree_map(_zeros32, params),
                "master": _master_init(params, use_master_weights)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        master = _resolve_master(params, state.get("master"))
        for m, g, mu in zip(tree_leaves(master), _grads32(grads),
                            tree_leaves(state["mu"])):
            u = torch.sign(beta1 * mu + (1 - beta1) * g)
            mu.copy_(beta2 * mu + (1 - beta2) * g)
            m.sub_(lr_t * (u + weight_decay * m))
        _writeback(master, params, state.get("master"))
        state["step"] = step
        return params, state

    return Optimizer(init, update)


def chain_clip_by_global_norm(optimizer: Optimizer,
                              max_norm: float) -> Optimizer:
    """Global-norm clipping before the update. The scale stays on the
    device (no host fetch)."""
    if not max_norm or max_norm <= 0:
        return optimizer

    def update(grads, state, params):
        g32 = cast_tree(grads, torch.float32)
        scale = torch.clamp(max_norm / (global_grad_norm(g32) + 1e-6),
                            max=1.0)
        return optimizer.update(tree_map(lambda g: g * scale, g32), state,
                                params)

    return Optimizer(optimizer.init, update)


# the CPU path's row length: an f32 sum of squares over this many values
# is exact to ~1e-7 relative; the rows are then summed in f64
_ROW = 4096


def sum_of_squares(x: torch.Tensor) -> torch.Tensor:
    """The sum of squares of ``x`` as a 0-dim f32 tensor. On the card an
    f32 reduction (exact to ~1e-7 over any leaf, as XLA's). On the CPU
    two levels: f32 over rows of ``_ROW`` values, the rows summed in f64:
    torch's CPU f32 sum over tens of millions of values drifts (0.6 % low
    on 65.5M normal values, ROADMAP C3), where this stays within 1e-8."""
    if x.device.type != "cpu":
        return torch.linalg.vector_norm(x, dtype=torch.float32).square()
    flat = x.detach().reshape(-1)
    m = flat.numel() - flat.numel() % _ROW
    rows = torch.linalg.vector_norm(flat[:m].view(-1, _ROW), dim=1,
                                    dtype=torch.float32)
    total = rows.double().square().sum() + flat[m:].double().square().sum()
    return total.float()


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """||x|| in f32 (0-dim): one f32 reduction on the card, the root of
    ``sum_of_squares`` on the CPU."""
    if x.device.type != "cpu":
        return torch.linalg.vector_norm(x, dtype=torch.float32)
    return sum_of_squares(x).sqrt()


def global_grad_norm(grads) -> torch.Tensor:
    """The norm of every leaf's ``l2_norm``, in f32, as a 0-d tensor."""
    return torch.linalg.vector_norm(torch.stack([l2_norm(g) for g in
                                                 tree_leaves(grads)]))


# --------------------------------------------------------------------------
# per-leaf reductions under ZeRO
# --------------------------------------------------------------------------

_LEAF_REDUCE: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None


@contextlib.contextmanager
def leaf_reduction(fn: Optional[Callable[[int, torch.Tensor],
                                         torch.Tensor]]):
    """For the block, ``fn(i, t)`` sums a small tensor of per-leaf
    statistics of leaf ``i`` (``tree_leaves`` order) over the ranks that
    hold shards of it: the ZeRO engine publishes it around an update on
    sharded optimizer state, so a per-leaf norm or mean (LAMB's trust
    ratio, the 1-bit scale) covers the whole leaf, as a global array's
    does in JAX."""
    global _LEAF_REDUCE
    prev, _LEAF_REDUCE = _LEAF_REDUCE, fn
    try:
        yield
    finally:
        _LEAF_REDUCE = prev


def leaf_sum(i: int, t: torch.Tensor) -> torch.Tensor:
    """``t`` (statistics of this rank's part of leaf ``i``) summed over
    the leaf's shards; ``t`` itself when the leaf is whole here."""
    return t if _LEAF_REDUCE is None else _LEAF_REDUCE(i, t)

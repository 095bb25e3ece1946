"""Optimizer core, a port of ``deepspeed_tpu/ops/optimizers.py``: an
optimizer is a pair of functions over a parameter tree (nested dicts of
tensors), ``init(params) -> state`` and ``update(grads, state, params) ->
(params, state)``.

The JAX functions are pure. Here ``update`` writes in place: the state's
tensors, the f32 master weights, and the params (cast back from the
masters). It returns the same objects, so a step allocates no second copy
of the model. The update is plain torch over the tree's leaves (a llama
has about a dozen stacked leaves); the JAX package leaves it to XLA, so
no kernel is owed.

Master weights: when the params are bf16, the state carries an f32 copy
("master"); the update runs on it and is written back into the params.
"""

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


def global_grad_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, as a 0-d tensor."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in tree_leaves(grads)]
    return torch.linalg.vector_norm(torch.stack(norms))

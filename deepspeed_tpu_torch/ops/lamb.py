"""LAMB (layer-wise adaptive moments), a port of
``deepspeed_tpu/ops/lamb.py``: Adam's moments, then each leaf's update
scaled by the trust ratio ||w|| / ||update||, clipped to [min_trust,
max_trust] and 1 where either norm is 0.

Plain torch over the leaves, in place, as ``ops/adam.py``: the JAX module
leaves the update to XLA, so no kernel is owed. The trust ratio stays on
the device (a ``torch.where`` of two f32 norms, as JAX's): the update
never waits on the host. The norms come from ``ops/optimizers.
sum_of_squares`` (exact on the CPU too, ROADMAP C3), summed over a
leaf's shards under ZeRO (``leaf_sum``) so the ratio is the whole
leaf's. The state has JAX's names: ``step`` (a host int), ``exp_avg``,
``exp_avg_sq`` and the f32 ``master``.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.ops.optimizers import (Optimizer, ScalarOrSchedule,
                                                _grads32, _lr_at,
                                                _master_init, _resolve_master,
                                                _writeback, _zeros32, leaf_sum,
                                                sum_of_squares, tree_leaves,
                                                tree_map)


def trust_ratio(i: int, p, upd, min_trust: float, max_trust: float):
    """JAX's clipped ||p|| / ||upd|| of leaf ``i`` (1 where either norm is
    0), as a 0-dim device tensor; both sums of squares summed over the
    leaf's shards in one reduction."""
    sq = leaf_sum(i, torch.stack([sum_of_squares(p), sum_of_squares(upd)]))
    w_norm, u_norm = sq.sqrt().unbind()
    return torch.where((w_norm > 0) & (u_norm > 0),
                       (w_norm / u_norm).clamp(min_trust, max_trust),
                       torch.ones_like(w_norm))


def lamb(lr: ScalarOrSchedule = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
         weight_decay: float = 0.0, min_trust: float = 0.01,
         max_trust: float = 10.0, use_master_weights: bool = True) -> Optimizer:
    b1, b2 = betas

    def init(params):
        return {"step": 0,
                "exp_avg": tree_map(_zeros32, params),
                "exp_avg_sq": tree_map(_zeros32, params),
                "master": _master_init(params, use_master_weights)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        t = np.float32(step)
        c1 = float(np.float32(1) - np.float32(b1) ** t)
        c2 = float(np.float32(1) - np.float32(b2) ** t)
        master = _resolve_master(params, state.get("master"))
        for i, (p, g, m, v) in enumerate(zip(
                tree_leaves(master), _grads32(grads),
                tree_leaves(state["exp_avg"]),
                tree_leaves(state["exp_avg_sq"]))):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            upd = (m / c1) / ((v / c2).sqrt() + eps)
            if weight_decay:
                upd = upd + weight_decay * p
            p.sub_(lr_t * trust_ratio(i, p, upd, min_trust, max_trust) * upd)
        _writeback(master, params, state.get("master"))
        state["step"] = step
        return params, state

    return Optimizer(init, update)

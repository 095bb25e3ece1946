"""Adam and AdamW, a port of ``deepspeed_tpu/ops/adam.py`` (``adam``,
``adamw``, ``fused_adam_update``; the 1-bit variants are
``ops/onebit.py``, the host update ``ops/cpu_adam.py``).

The state has the JAX names: ``step``, ``exp_avg``, ``exp_avg_sq`` and the
f32 ``master`` (None when the params are f32 and masters are off), so a
test can compare it leaf for leaf. ``step`` is a host int: the bias
corrections and the learning rate are host values of it, and the update
never waits on the device.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.ops.optimizers import (Optimizer, ScalarOrSchedule,
                                                _lr_at, _master_init,
                                                _resolve_master, _writeback,
                                                cast_tree, tree_leaves,
                                                tree_map)


def fused_adam_update(master, m, v, g, lr_t, step, *, b1, b2, eps, wd, awm,
                      bc, v_max=None):
    """The flat AdamW core over one f32 leaf, IN PLACE on ``master``,
    ``m`` and ``v`` (and ``v_max`` for amsgrad). ``g`` arrives already
    scaled (clip / accumulation folded in by the caller). Returns
    (master, m, v)."""
    if wd and not awm:
        g = g + wd * master
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    if v_max is not None:
        torch.maximum(v_max, v, out=v_max)
    c1 = c2 = 1.0
    if bc:
        t = np.float32(step)
        c1 = float(np.float32(1) - np.float32(b1) ** t)
        c2 = float(np.float32(1) - np.float32(b2) ** t)
    upd = (m / c1).div_((v if v_max is None else v_max).div(c2).sqrt_()
                        .add_(eps))
    if awm and wd:
        upd.add_(master, alpha=wd)
    master.add_(upd, alpha=-lr_t)
    return master, m, v


def adam(lr: ScalarOrSchedule = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0, adam_w_mode: bool = False,
         bias_correction: bool = True, use_master_weights: bool = True,
         amsgrad: bool = False) -> Optimizer:
    """Adam / AdamW (adam_w_mode=True: decoupled decay), as JAX."""
    b1, b2 = betas

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        state = {"step": 0,
                 "exp_avg": tree_map(zeros, params),
                 "exp_avg_sq": tree_map(zeros, params),
                 "master": _master_init(params, use_master_weights)}
        if amsgrad:
            state["max_exp_avg_sq"] = tree_map(zeros, params)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        master = _resolve_master(params, state.get("master"))
        vmax = (tree_leaves(state["max_exp_avg_sq"]) if amsgrad
                else [None] * len(tree_leaves(params)))
        for p, m, v, g, vm in zip(tree_leaves(master),
                                  tree_leaves(state["exp_avg"]),
                                  tree_leaves(state["exp_avg_sq"]),
                                  tree_leaves(cast_tree(grads,
                                                        torch.float32)),
                                  vmax):
            fused_adam_update(p, m, v, g, lr_t, step, b1=b1, b2=b2, eps=eps,
                              wd=weight_decay, awm=adam_w_mode,
                              bc=bias_correction, v_max=vm)
        _writeback(master, params, state.get("master"))
        state["step"] = step
        return params, state

    return Optimizer(init, update)


def adamw(lr: ScalarOrSchedule = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                adam_w_mode=True, **kw)

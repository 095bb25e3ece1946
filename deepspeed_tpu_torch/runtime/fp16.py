"""Mixed precision: the dynamic loss scaler for fp16, a port of
``deepspeed_tpu/runtime/fp16.py``.

The scaler state is three 0-dim device tensors (``scale`` f32,
``good_steps`` and ``hysteresis`` int32) carried in the training state.
``update_loss_scale`` is ``torch.where`` on the device, as JAX's
``jnp.where``: scale x ``scale_factor`` after ``scale_window``
consecutive good steps, / ``scale_factor`` on an overflow once the
hysteresis is used up (never below ``min_scale``); the hysteresis refills
at a growth boundary (the reference's default) or, with
``consecutive_hysteresis``, after every good step. bf16 needs no scaling
(the engine skips all of this).
"""

from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops.optimizers import tree_leaves


class LossScaleState(NamedTuple):
    scale: torch.Tensor          # f32 scalar
    good_steps: torch.Tensor     # int32 scalar
    hysteresis: torch.Tensor     # int32 scalar (overflows still tolerated)


def init_loss_scale(initial_scale_power: int = 16, hysteresis: int = 2,
                    device=None) -> LossScaleState:
    return LossScaleState(
        scale=torch.tensor(2.0 ** initial_scale_power, dtype=torch.float32,
                           device=device),
        good_steps=torch.zeros((), dtype=torch.int32, device=device),
        hysteresis=torch.tensor(hysteresis, dtype=torch.int32,
                                device=device))


def static_loss_scale(value: float, device=None) -> LossScaleState:
    return LossScaleState(
        scale=torch.tensor(value, dtype=torch.float32, device=device),
        good_steps=torch.zeros((), dtype=torch.int32, device=device),
        hysteresis=torch.zeros((), dtype=torch.int32, device=device))


def has_overflow(grads) -> torch.Tensor:
    """A 0-dim bool tensor: True if any grad leaf holds an inf or a NaN."""
    flags = [~torch.isfinite(g).all() for g in tree_leaves(grads)]
    return torch.stack(flags).any()


def update_loss_scale(state: LossScaleState, overflow: torch.Tensor,
                      dynamic: bool = True, scale_window: int = 1000,
                      scale_factor: float = 2.0, min_scale: float = 1.0,
                      max_hysteresis: int = 2,
                      consecutive_hysteresis: bool = False) -> LossScaleState:
    if not dynamic:
        return state
    scale, good, hys = state
    # an overflow uses up hysteresis; the scale shrinks once it is spent
    # (the shrink itself does not refill it)
    shrink = overflow & (hys <= 1)
    hys = torch.where(overflow & ~shrink, hys - 1, hys)
    new_scale = torch.where(
        shrink, torch.clamp_min(scale / scale_factor, min_scale), scale)
    good = torch.where(overflow, torch.zeros_like(good), good + 1)
    grow = good >= scale_window
    new_scale = torch.where(grow, new_scale * scale_factor, new_scale)
    good = torch.where(grow, torch.zeros_like(good), good)
    full = torch.full_like(hys, max_hysteresis)
    if consecutive_hysteresis:
        hys = torch.where(overflow, hys, full)
    else:
        hys = torch.where(grow, full, hys)
    return LossScaleState(new_scale, good, hys)


def scale_loss(loss, state: LossScaleState):
    return loss * state.scale.to(loss.dtype)


def unscale_grads(grads, state: LossScaleState):
    """Each grad leaf as f32 times 1 / scale (a list of leaves stays a
    list)."""
    inv = 1.0 / state.scale
    if isinstance(grads, dict):
        return {k: unscale_grads(v, state) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return [g.float() * inv for g in grads]
    return grads.float() * inv

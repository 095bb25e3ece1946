"""LR schedules as pure functions step -> lr, a port of
``deepspeed_tpu/runtime/lr_schedules.py`` (the same names and parameter
keys: LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR, CosineAnnealing).

The port's step count is a host int, so every schedule is numpy math in
f32 on the host: the JAX functions' host path, with no device work.
"""

import math
from typing import Callable, Optional

import numpy as np

Schedule = Callable[[int], np.ndarray]

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
COSINE = "CosineAnnealing"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR,
                      COSINE]


def _f32(step):
    return np.asarray(step, np.float32)


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> Schedule:
    def schedule(step):
        interval = _f32(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = np.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)
    return schedule


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_) -> Schedule:
    def schedule(step):
        step = _f32(step)
        frac = np.clip(step / max(1, warmup_num_steps), 0.0, 1.0)
        if warmup_type == "log":
            gamma = np.log1p(frac * (math.e - 1.0))
        else:
            gamma = frac
        warm = warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma
        return np.where(step < warmup_num_steps, warm, warmup_max_lr)
    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001,
                    warmup_num_steps: int = 1000, warmup_type: str = "log",
                    **_) -> Schedule:
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)

    def schedule(step):
        step = _f32(step)
        decay_frac = np.clip(
            (total_num_steps - step)
            / max(1.0, total_num_steps - warmup_num_steps), 0.0, 1.0)
        return np.where(step < warmup_num_steps, warm(step),
                        warmup_max_lr * decay_frac)
    return schedule


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_) -> Schedule:
    second = (cycle_second_step_size if cycle_second_step_size is not None
              else cycle_first_step_size)
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        step = _f32(step)
        up = np.clip(step / cycle_first_step_size, 0.0, 1.0)
        down = np.clip((step - cycle_first_step_size) / max(1, second),
                       0.0, 1.0)
        in_cycle_lr = np.where(
            step <= cycle_first_step_size,
            cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up,
            cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down)
        if decay_step_size > 0:
            decay_steps = np.maximum(0.0, (step - total_cycle)
                                     / decay_step_size)
            decayed = cycle_min_lr / (1.0 + decay_steps * decay_lr_rate)
            return np.where(step > total_cycle, decayed, in_cycle_lr)
        return in_cycle_lr
    return schedule


def cosine_annealing(max_lr: float, total_num_steps: int,
                     warmup_num_steps: int = 0, min_lr: float = 0.0,
                     **_) -> Schedule:
    def schedule(step):
        step = _f32(step)
        warm = max_lr * step / max(1, warmup_num_steps)
        progress = np.clip((step - warmup_num_steps)
                           / max(1, total_num_steps - warmup_num_steps),
                           0.0, 1.0)
        cos = min_lr + 0.5 * (max_lr - min_lr) * (1.0 + np.cos(np.pi
                                                               * progress))
        return np.where(step < warmup_num_steps, warm, cos)
    return schedule


_FACTORIES = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    COSINE: cosine_annealing,
}


def get_scheduler(name: Optional[str], params: dict) -> Optional[Schedule]:
    if name is None:
        return None
    if name not in _FACTORIES:
        raise ValueError(f"unknown scheduler '{name}'; valid: "
                         f"{VALID_LR_SCHEDULES}")
    return _FACTORIES[name](**params)

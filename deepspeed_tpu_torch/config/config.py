"""The training config tree, reduced to what the single-card training
slice runs: a port of ``deepspeed_tpu/config/config.py``.

The JSON surface is the JAX package's, so one config dict drives both.
What this slice runs: the batch triad (``resolve_batch_size``, the same
solve), ``optimizer``, ``scheduler``, ``bf16``, ``zero_optimization.stage``
(one device: every stage is the same program), ``gradient_clipping``,
``transformer.fused_backward``, ``seed`` and ``steps_per_print``. Unknown
keys warn, as in JAX. The JAX sections this slice lacks are known: each
raises ``NotImplementedError`` naming its ROADMAP item when the config
turns it on, and is ignored while it is off.
"""

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.config.config_utils import (ConfigError, ConfigModel,
                                                     config_field)
from deepspeed_tpu_torch.ops.registry import SUPPORTED_OPTIMIZERS


@dataclasses.dataclass
class OptimizerConfig(ConfigModel):
    ALIASES = {"type": "name"}
    name: str = "adamw"
    params: Dict[str, Any] = config_field({})

    def validate(self):
        if self.name.lower() not in SUPPORTED_OPTIMIZERS:
            raise ConfigError(f"optimizer '{self.name}' not supported; "
                              f"choose from {sorted(SUPPORTED_OPTIMIZERS)}")


@dataclasses.dataclass
class SchedulerConfig(ConfigModel):
    ALIASES = {"type": "name"}
    name: Optional[str] = None
    params: Dict[str, Any] = config_field({})


@dataclasses.dataclass
class FP16Config(ConfigModel):
    """Enabling fp16 raises (ROADMAP A3); its loss-scaler keys warn."""
    enabled: bool = False


@dataclasses.dataclass
class BF16Config(ConfigModel):
    enabled: bool = True   # the JAX default: bf16 on


@dataclasses.dataclass
class ZeroConfig(ConfigModel):
    """``zero_optimization``: the stage (0..3), and the offload sections,
    which raise when set (ROADMAP A8). On one device the stages differ
    only in how state would be sharded, so they run the same program; the
    JAX section's bucket and prefetch knobs warn as unknown keys."""
    stage: int = 0
    offload_param: Dict[str, Any] = config_field({})
    offload_optimizer: Dict[str, Any] = config_field({})

    def validate(self):
        if self.stage not in (0, 1, 2, 3):
            raise ConfigError(f"zero_optimization.stage must be 0..3, got "
                              f"{self.stage}")
        for name in ("offload_param", "offload_optimizer"):
            if (getattr(self, name) or {}).get("device", "none") \
                    not in ("none", None):
                _deferred(f"zero_optimization.{name}",
                          "A8 (ZeRO-Offload / Infinity)")


@dataclasses.dataclass
class TransformerTuningConfig(ConfigModel):
    """``transformer``: model-level levers the engine applies by
    rebuilding the model config (``dataclasses.replace``)."""
    fused_backward: bool = False
    tp_overlap_chunks: int = 0

    def validate(self):
        if self.tp_overlap_chunks > 1:
            _deferred("transformer.tp_overlap_chunks",
                      "A9 (tensor-parallel overlap)")


def _deferred(what: str, item: str):
    raise NotImplementedError(f"config {what} is not ported yet: ROADMAP "
                              f"{item}")


def _enabled(s: Dict[str, Any]) -> bool:
    return bool(s.get("enabled", False))


def _any_size(*keys):
    return lambda s: any((s.get(k) or 1) > 1 for k in keys)


# JAX sections this slice does not run: (on(section dict), ROADMAP item)
_DEFERRED = {
    "pipeline": (lambda s: (s.get("stages") or 1) > 1
                 or (s.get("fuse_steps") or 1) > 1,
                 "A4 / A9 (pipeline stages, fused multi-step dispatch)"),
    "tensor_parallel": (lambda s: _any_size("tp_size", "size", "tp")(s)
                        or bool(s.get("seq_parallel")),
                        "A9 (tensor parallelism)"),
    "sequence_parallel": (_any_size("sp_size", "size"),
                          "A9 (ring attention)"),
    "mesh": (lambda s: bool(s.get("axes")), "A4 (device meshes)"),
    "comm": (lambda s: any(bool(v) for v in s.values()),
             "A4 (comm scheduling)"),
    "comms_logger": (_enabled, "A9 (comm logging)"),
    "moe": (_enabled, "A9 (MoE)"),
    "telemetry": (_enabled, "A11 (telemetry)"),
    "flops_profiler": (_enabled, "A11 (profiling)"),
    "tensorboard": (_enabled, "A11 (monitor)"),
    "wandb": (_enabled, "A11 (monitor)"),
    "csv_monitor": (_enabled, "A11 (monitor)"),
    "json_monitor": (_enabled, "A11 (monitor)"),
    "curriculum_learning": (_enabled, "A11 (data pipeline)"),
    "progressive_layer_drop": (_enabled, "A11 (progressive layer drop)"),
    "data_efficiency": (_enabled, "A11 (data pipeline)"),
    "elasticity": (_enabled, "A11 (elasticity)"),
    "autotuning": (_enabled, "A11 (autotuning)"),
    "quantize_training": (_enabled, "A11 (MoQ)"),
    "compression_training": (
        lambda s: any(isinstance(v, dict) and (
            v.get("enabled") or (v.get("shared_parameters") or {})
            .get("enabled")) for v in s.values()),
        "A11 (compression)"),
    "robustness": (lambda s: _enabled(s.get("faults") or {}),
                   "A7 (fault injection)"),
}

@dataclasses.dataclass
class Config(ConfigModel):
    # batch triad (train = micro x gas x dp world)
    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None

    # the engine fetches nothing per step, so it prints nothing; the key
    # is kept for callers that log at this interval
    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    seed: int = 42

    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = config_field(FP16Config)
    bf16: BF16Config = config_field(BF16Config)
    zero_optimization: ZeroConfig = config_field(ZeroConfig)
    transformer: TransformerTuningConfig = config_field(
        TransformerTuningConfig)

    @classmethod
    def load(cls, source) -> "Config":
        """Accept a dict, a JSON path, or an existing Config."""
        if isinstance(source, Config):
            return source
        if isinstance(source, str):
            if not os.path.exists(source):
                raise ConfigError(f"config file not found: {source}")
            with open(source) as f:
                source = json.load(f)
        return cls.from_dict(source or {})

    @classmethod
    def from_dict(cls, data, path: str = ""):
        data = dict(data or {})
        for name, (on, item) in _DEFERRED.items():
            section = data.pop(name, None)
            if isinstance(section, dict) and on(section):
                _deferred(name, item)
        return super().from_dict(data, path)

    def validate(self):
        if self.fp16.enabled:
            _deferred("fp16", "A3 (fp16 with a dynamic loss scaler; the "
                      "attention kernels take no float16)")

    def resolve_batch_size(self, dp_world_size: int) -> None:
        """Solve the batch triad train = micro x gas x dp, as JAX does."""
        train, micro, gas = (self.train_batch_size,
                             self.train_micro_batch_size_per_gpu,
                             self.gradient_accumulation_steps)
        if train is not None and micro is not None and gas is not None:
            if train != micro * gas * dp_world_size:
                raise ConfigError(
                    f"batch mismatch: train_batch_size={train} != "
                    f"micro({micro}) * gas({gas}) * dp({dp_world_size})")
        elif train is not None and micro is not None:
            gas = train // (micro * dp_world_size)
        elif train is not None and gas is not None:
            micro = train // (gas * dp_world_size)
        elif micro is not None and gas is not None:
            train = micro * gas * dp_world_size
        elif train is not None:
            gas = 1
            micro = train // dp_world_size
        elif micro is not None:
            gas = 1
            train = micro * dp_world_size
        else:
            micro, gas = 1, 1
            train = dp_world_size
        if micro is None or micro <= 0 or gas is None or gas <= 0:
            raise ConfigError(f"cannot solve batch triad: train={train} "
                              f"micro={micro} gas={gas} dp={dp_world_size}")
        if train != micro * gas * dp_world_size:
            raise ConfigError(
                f"batch triad unsolvable: train_batch_size={train} not "
                f"divisible into micro({micro}) * gas({gas}) * "
                f"dp({dp_world_size})")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.bf16.enabled else torch.float32

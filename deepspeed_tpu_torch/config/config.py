"""The training config tree, a port of ``deepspeed_tpu/config/config.py``
for the sections the port runs.

The JSON surface is the JAX package's, so one config dict drives both.
What the port runs: the batch triad (``resolve_batch_size``, the same
solve against the data-parallel degree), ``optimizer``, ``scheduler``,
``bf16``, ``fp16`` (the loss scaler), ``zero_optimization`` (the stage
and ``stage3_param_persistence_threshold``), ``gradient_clipping``,
``transformer.fused_backward``, ``pipeline`` (``stages``,
``in_flight``, ``prefetch``, ``fuse_steps``), ``comm`` (the
gradient-reduction schedule), ``comms_logger``, ``mesh`` (explicit
axes), ``checkpoint``, ``seed`` and ``steps_per_print``, the capacity
tier's ``zero_optimization.offload_param`` / ``offload_optimizer`` and
``aio`` (at one rank), and model parallelism: ``tensor_parallel.
tp_size``, ``sequence_parallel.sp_size``, ``moe`` (its
``expert_parallel_size`` lays out the ``expert`` axis) and
``transformer.tp_overlap_chunks``, and the training extras:
``compression_training``, ``quantize_training`` (MoQ),
``curriculum_learning``, ``data_efficiency.data_routing.random_ltd`` and
``progressive_layer_drop``.
Unknown keys warn, as in JAX. The JAX sections the
port lacks are known: each raises ``NotImplementedError`` naming its
ROADMAP item when the config turns it on, and is ignored while it is
off.
"""

import dataclasses
import json
import logging
import os
from typing import Any, Dict, List, Optional

import torch

from deepspeed_tpu_torch.config.config_utils import (ConfigError, ConfigModel,
                                                     config_field)
from deepspeed_tpu_torch.ops.registry import SUPPORTED_OPTIMIZERS

logger = logging.getLogger("deepspeed_tpu_torch")


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
    """fp16 with a loss scaler, JAX's keys (``runtime/fp16.py``):
    ``loss_scale`` 0 means dynamic (from 2^``initial_scale_power``, x2
    after ``loss_scale_window`` good steps, /2 once ``hysteresis``
    overflows are used up, never below ``min_loss_scale``), else a static
    scale. ``auto_cast`` is kept for the JSON surface."""
    enabled: bool = False
    loss_scale: float = 0.0            # 0 = dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    auto_cast: bool = True

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == 0.0


@dataclasses.dataclass
class BF16Config(ConfigModel):
    enabled: bool = True   # the JAX default: bf16 on


@dataclasses.dataclass
class OffloadDeviceConfig(ConfigModel):
    """``offload_param`` / ``offload_optimizer`` (JAX's keys): ``device``
    none | cpu | nvme; ``nvme_path`` where the nvme tier writes;
    ``buffer_size`` the optimizer swap's chunk in bytes;
    ``pipeline_read`` / ``pipeline_write`` (both off: the drained swapper
    and executor, for bit-for-bit bisection); ``max_in_cpu`` the bytes of
    the layer executor's host cache of param chunks; ``use_cpu_adam`` the
    optimizer on the host's cores (``ops/cpu_adam.py``).
    ``buffer_count``, ``pin_memory``, ``fast_init`` and ``ratio`` are kept
    for the JSON surface (the port's tiers pin host memory where CUDA is
    there and size their own rings)."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    pin_memory: bool = False
    pipeline_read: bool = True
    pipeline_write: bool = True
    fast_init: bool = False
    max_in_cpu: int = 1_000_000_000
    ratio: float = 1.0
    use_cpu_adam: bool = False

    @property
    def enabled(self) -> bool:
        return self.device not in ("none", None)

    def validate(self):
        if self.device not in ("none", None, "cpu", "nvme"):
            raise ConfigError(f"offload device must be none, cpu or nvme, "
                              f"got {self.device!r}")
        if self.buffer_size < 4:
            raise ConfigError("offload buffer_size must be >= 4 bytes")


@dataclasses.dataclass
class AIOConfig(ConfigModel):
    """``aio``: the native IO handles of the nvme tiers. The tiers open
    two, one ring for prefetch reads and one for write-behind;
    ``read_queue_depth`` / ``write_queue_depth`` size them (None:
    ``queue_depth``). ``single_submit`` and ``overlap_events`` are kept
    for the JSON surface."""
    block_size: int = 1_048_576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True
    read_queue_depth: Optional[int] = None
    write_queue_depth: Optional[int] = None


@dataclasses.dataclass
class ZeroConfig(ConfigModel):
    """``zero_optimization``: the stage (0..3, ``runtime/zero.py``), the
    stage-3 persistence threshold (a leaf of at most that many values
    stays whole on every rank), ``stage3_max_live_parameters`` (the layer
    executor's live cache on the card, read only when the key is set, as
    in JAX), and the offload sections (``runtime/swap_tensor.py``,
    ``runtime/infinity.py``). JAX's bucket and prefetch knobs
    warn as unknown keys: XLA sizes its collectives, and so does the
    eager port's per-leaf schedule."""
    stage: int = 0
    stage3_param_persistence_threshold: int = 100_000
    stage3_max_live_parameters: int = 1_000_000_000
    offload_param: OffloadDeviceConfig = config_field(OffloadDeviceConfig)
    offload_optimizer: OffloadDeviceConfig = config_field(
        OffloadDeviceConfig)

    def validate(self):
        if self.stage not in (0, 1, 2, 3):
            raise ConfigError(f"zero_optimization.stage must be 0..3, got "
                              f"{self.stage}")
        if self.stage3_param_persistence_threshold < 0:
            raise ConfigError("zero_optimization."
                              "stage3_param_persistence_threshold must be "
                              ">= 0")
        if self.offload_param.enabled and self.stage != 3:
            raise ConfigError("offload_param requires zero stage 3")

    @property
    def offloaded(self) -> bool:
        return self.offload_param.enabled or self.offload_optimizer.enabled


@dataclasses.dataclass
class TransformerTuningConfig(ConfigModel):
    """``transformer``: model-level levers the engine applies by
    rebuilding the model config (``dataclasses.replace``)."""
    fused_backward: bool = False
    # the row-parallel projections' tensor-axis sum cut into this many
    # all_reduce calls along the sequence (0 / 1: one;
    # ``parallel/partitioning.row_parallel_matmul``)
    tp_overlap_chunks: int = 0

    def validate(self):
        if self.tp_overlap_chunks < 0:
            raise ConfigError("transformer.tp_overlap_chunks must be >= 0")


@dataclasses.dataclass
class TensorParallelConfig(ConfigModel):
    """``tensor_parallel``: the ``tensor`` axis's degree. ``seq_parallel``
    is accepted as in JAX, whose config declares it and no code reads
    it."""
    ALIASES = {"size": "tp_size", "tp": "tp_size"}
    tp_size: int = 1
    seq_parallel: bool = False

    def validate(self):
        if self.tp_size < 1:
            raise ConfigError("tensor_parallel.tp_size must be >= 1")


@dataclasses.dataclass
class SequenceParallelConfig(ConfigModel):
    """``sequence_parallel``: the ``seq`` axis's degree (each rank holds a
    piece of every sequence; attention runs as a ring,
    ``ops/ring_attention.py``). ``mode`` is kept for the JSON surface:
    JAX's routing runs the ring whatever it says."""
    ALIASES = {"size": "sp_size"}
    sp_size: int = 1
    mode: str = "ring"

    def validate(self):
        if self.sp_size < 1:
            raise ConfigError("sequence_parallel.sp_size must be >= 1")


@dataclasses.dataclass
class MoEConfig(ConfigModel):
    """``moe``, JAX's fields. As in JAX, the engine reads
    ``expert_parallel_size`` (the ``expert`` axis of ``plan_from_config``,
    when ``enabled``); the model's own config carries the gating fields."""
    enabled: bool = False
    expert_parallel_size: int = 1
    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None
    drop_tokens: bool = True
    use_residual: bool = False
    aux_loss_weight: float = 0.01


@dataclasses.dataclass
class PipelineConfig(ConfigModel):
    """``pipeline``: ``stages`` is the ``pipe`` axis's degree (the 1F1B
    schedule of ``parallel/pipeline.py``, with
    ``gradient_accumulation_steps`` micro-batches); ``partition_method``,
    ``micro_batches``, ``activation_checkpoint_interval`` and
    ``schedule`` are accepted as in JAX, whose config declares them and
    no code reads them (layers split evenly; the schedule is 1F1B).
    The async step loop of ``Engine.train_batches``: ``in_flight`` bounds
    how many steps the host issues ahead of the card; ``prefetch`` copies
    batch N+1 to the device (from pinned memory, on a side stream) while
    step N runs; ``fuse_steps`` is accepted and has no effect (JAX fuses
    K steps into one program; the eager port has no single-dispatch step
    until ROADMAP S2)."""
    stages: int = 1
    partition_method: str = "parameters"
    micro_batches: Optional[int] = None
    activation_checkpoint_interval: int = 0
    schedule: str = "1f1b"
    in_flight: int = 2
    prefetch: bool = True
    fuse_steps: int = 1

    def validate(self):
        if self.stages < 1:
            raise ConfigError("pipeline.stages must be >= 1")
        if self.in_flight < 1:
            raise ConfigError("pipeline.in_flight must be >= 1")
        if self.fuse_steps < 1:
            raise ConfigError("pipeline.fuse_steps must be >= 1")


@dataclasses.dataclass
class CheckpointConfig(ConfigModel):
    """``checkpoint``, as in JAX: ``async_save`` (the write runs on a
    thread after a host copy), the integrity chain (``integrity``:
    manifest + commit marker; ``integrity_checksums``: re-hash on
    validate), ``keep_last_k`` retention (0 = keep all; the tag `latest`
    names is never pruned) and ``tag_validation`` (kept for the JSON
    surface: rank 0 writes every tag). ``load_universal`` and
    ``use_node_local_storage`` are accepted and change nothing, as in JAX,
    where no code reads them: every save is universal (each leaf whole,
    ``Engine.save_checkpoint``), so any world size and ZeRO stage loads
    it."""
    tag_validation: str = "Warn"      # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    async_save: bool = False
    integrity: bool = True
    integrity_checksums: bool = True
    keep_last_k: int = 0

    def validate(self):
        if self.keep_last_k < 0:
            raise ConfigError("checkpoint.keep_last_k must be >= 0")
        if self.tag_validation.lower() not in ("ignore", "warn", "fail"):
            raise ConfigError("checkpoint.tag_validation must be Ignore, "
                              f"Warn or Fail, got {self.tag_validation!r}")


@dataclasses.dataclass
class CommConfig(ConfigModel):
    """``comm``: the gradient-reduction schedule (``comm/schedule.py``).
    ``deferred_grad_sync``: accumulate local grads over the micro-batches
    and reduce once at the boundary; ``hierarchical_grad_reduce``: on a
    data x fsdp plan, reduce-scatter over fsdp, then all-reduce the shard
    over data; ``microbatch_unroll``: accepted (an eager loop has no scan
    to unroll)."""
    deferred_grad_sync: bool = False
    hierarchical_grad_reduce: bool = False
    microbatch_unroll: int = 0

    def validate(self):
        if self.microbatch_unroll < 0:
            raise ConfigError("comm.microbatch_unroll must be >= 0")


@dataclasses.dataclass
class CommsLoggerConfig(ConfigModel):
    """``comms_logger``, JAX's fields: the engine configures
    ``comm.comms_logger`` from it (``prof_all`` records every op, else
    only ``prof_ops``); ``debug`` is accepted."""
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = config_field([])


@dataclasses.dataclass
class MeshConfig(ConfigModel):
    """``mesh``: explicit axes (``{"data": 2, "fsdp": 2}``) instead of the
    plan ``parallel.mesh.plan_from_config`` derives;
    ``allow_split_physical_axes`` is kept for the JSON surface (a process
    group has no physical torus to split)."""
    axes: Dict[str, int] = config_field({})
    allow_split_physical_axes: bool = False


@dataclasses.dataclass
class CurriculumConfig(ConfigModel):
    """``curriculum_learning`` (JAX's keys and defaults): the seqlen
    curriculum's schedule (``runtime/data_pipeline.CurriculumScheduler``)."""
    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 8
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"
    schedule_config: Dict[str, Any] = config_field({})


@dataclasses.dataclass
class PLDConfig(ConfigModel):
    """``progressive_layer_drop``: theta(t) = (1 - theta) exp(-gamma t) +
    theta, ``theta`` the keep-probability floor."""
    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


@dataclasses.dataclass
class DataEfficiencyConfig(ConfigModel):
    """``data_efficiency``: ``data_routing.random_ltd`` drives random-LTD
    (``RandomLTDScheduler``'s keys); ``data_sampling`` and ``seed`` are
    kept for the JSON surface, as in JAX's engine."""
    enabled: bool = False
    seed: int = 1234
    data_sampling: Dict[str, Any] = config_field({})
    data_routing: Dict[str, Any] = config_field({})


@dataclasses.dataclass
class CompressionConfig(ConfigModel):
    """``compression_training``: weight / activation quantization, the
    sparse, row, head and channel pruning masks and layer reduction, each
    a section of the reference's schema (``compression/compress.py``)."""
    weight_quantization: Dict[str, Any] = config_field({})
    activation_quantization: Dict[str, Any] = config_field({})
    sparse_pruning: Dict[str, Any] = config_field({})
    row_pruning: Dict[str, Any] = config_field({})
    head_pruning: Dict[str, Any] = config_field({})
    channel_pruning: Dict[str, Any] = config_field({})
    layer_reduction: Dict[str, Any] = config_field({})

    def any_enabled(self) -> bool:
        return any(isinstance(v, dict) and (
            v.get("enabled") or (v.get("shared_parameters") or {})
            .get("enabled")) for v in dataclasses.asdict(self).values())


def _deferred(what: str, item: str):
    raise NotImplementedError(f"config {what} is not ported yet: ROADMAP "
                              f"{item}")


def _enabled(s: Dict[str, Any]) -> bool:
    return bool(s.get("enabled", False))


# JAX sections this slice does not run: (on(section dict), ROADMAP item)
_DEFERRED = {
    "telemetry": (_enabled, "A11 (telemetry)"),
    "flops_profiler": (_enabled, "A11 (profiling)"),
    "tensorboard": (_enabled, "A11 (monitor)"),
    "wandb": (_enabled, "A11 (monitor)"),
    "csv_monitor": (_enabled, "A11 (monitor)"),
    "json_monitor": (_enabled, "A11 (monitor)"),
    "elasticity": (_enabled, "A11 (elasticity)"),
    "autotuning": (_enabled, "A11 (autotuning)"),
}


@dataclasses.dataclass
class FaultsConfig(ConfigModel):
    """Deterministic fault injection (``robustness/faults.py``), JAX's
    keys: entries fire at exact step / operation indices and ``seed``
    feeds the rate-based ones, so a schedule replays identically."""
    enabled: bool = False
    seed: int = 0
    # fault dicts {"kind": ..., ...}: see robustness.FaultSchedule for the
    # kinds and their keys
    entries: List[Dict[str, Any]] = config_field([])

    def validate(self):
        if self.enabled:
            from deepspeed_tpu_torch.robustness.faults import FaultSchedule
            try:
                FaultSchedule(self.entries, self.seed)
            except ValueError as e:   # the config surface raises ConfigError
                raise ConfigError(f"robustness.faults: {e}") from e


@dataclasses.dataclass
class RobustnessConfig(ConfigModel):
    """Fault-tolerance knobs without a reference analogue (checkpoint
    integrity lives under ``checkpoint``)."""
    faults: FaultsConfig = config_field(FaultsConfig)

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
    pipeline: PipelineConfig = config_field(PipelineConfig)
    checkpoint: CheckpointConfig = config_field(CheckpointConfig)
    comm: CommConfig = config_field(CommConfig)
    mesh: MeshConfig = config_field(MeshConfig)
    tensor_parallel: TensorParallelConfig = config_field(
        TensorParallelConfig)
    sequence_parallel: SequenceParallelConfig = config_field(
        SequenceParallelConfig)
    comms_logger: CommsLoggerConfig = config_field(CommsLoggerConfig)
    moe: MoEConfig = config_field(MoEConfig)
    robustness: RobustnessConfig = config_field(RobustnessConfig)
    aio: AIOConfig = config_field(AIOConfig)
    # the training extras (``runtime/engine``)
    curriculum_learning: CurriculumConfig = config_field(CurriculumConfig)
    progressive_layer_drop: PLDConfig = config_field(PLDConfig)
    data_efficiency: DataEfficiencyConfig = config_field(DataEfficiencyConfig)
    compression_training: CompressionConfig = config_field(CompressionConfig)
    # MoQ: start_bits -> target_bits over quantize_period steps, optionally
    # eigenvalue-scheduled per layer (``runtime/quantize.py``)
    quantize_training: Dict[str, Any] = config_field({})

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
        if self.fp16.enabled and self.bf16.enabled:
            # JAX's rule: the reference errors on both; fp16 wins here
            logger.warning("config: fp16 and bf16 both enabled — using fp16 "
                           "(disable one explicitly to silence)")
            self.bf16 = BF16Config(enabled=False)

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
        if self.fp16.enabled:
            return torch.float16
        return torch.bfloat16 if self.bf16.enabled else torch.float32

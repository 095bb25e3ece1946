"""The training engine, a port of the main path of
``deepspeed_tpu/runtime/engine.py``: ``initialize`` -> ``Engine`` ->
``train_batch`` / ``train_batches`` / ``forward``-``backward``-``step``,
with checkpoints a run can resume from, on one card or on every rank of
a ``torch.distributed`` group (ZeRO stages 0-3 over the ``data`` and
``fsdp`` axes, below).

What it runs, in the JAX engine's order:

- ``_init_state``: f32 params from the model's seeded init (or a JAX tree
  given as ``params=``), the optimizer state built on them (f32 masters
  when the compute dtype is not f32), then the params cast to the compute
  dtype;
- ``_accum_micro_grads``: ``gradient_accumulation_steps`` micro-batches,
  the 1/gas mean folded into the accumulate;
- ``micro_grads`` / ``apply_grads`` / ``batch_grads``: grads cast to f32,
  the global norm, clipping, the optimizer update and the write-back of
  the updated masters into the params; under fp16 (``runtime/fp16.py``)
  the loss is scaled before the backward, the grads unscaled to f32 and
  checked for inf / NaN, a step that overflowed is skipped (params,
  masters and optimizer state untouched, the applied-update count
  ``state["step"]`` held, ``skipped_steps`` counted) and the scaler
  updates on the device. The skip needs the overflow flag on the host
  before the in-place update: one sync a step that JAX, whose update is
  a pure ``where(overflow, old, new)``, avoids (fp16 only);
- ``train_batch``, ``eval_batch``, ``get_lr``, ``global_steps``,
  ``params``;
- ``train_batches``: the async loop (``pipeline.in_flight`` steps issued
  ahead at most, ``pipeline.prefetch`` copies batch N+1 from pinned host
  memory on a side stream while step N runs; ``pipeline.fuse_steps`` is
  accepted and has no effect in the eager port), and the 3-call ``forward`` / ``backward`` / ``step``
  API (grads buffered until the accumulation boundary, the update
  ``train_batch`` applies);
- ``attach_dataloader`` (or ``initialize(training_data=...)``), whose
  position every checkpoint carries;
- ``save_checkpoint`` / ``wait_checkpoint`` / ``load_checkpoint``
  (``runtime/checkpointing.py``: one ``.npy`` per leaf, the integrity
  chain, walk-back), ``save_16bit_model`` and ``load_16bit_model``.

JAX compiles the step into one program and never fetches a metric per
step; here the step is eager PyTorch and ``train_batch`` returns its
metrics as 0-dim device tensors, again without a host fetch (under fp16
but for the overflow flag, above).

Dropout (a model with ``dropout_rate > 0``): the loss function gets a
mask seed fixed by (``config.seed``, the step, the micro-batch), from
which each layer's masks are drawn (``models/transformer._dropout``);
``eval_batch`` drops nothing.

More than one rank (the default group of more than one process, or
``initialize(mesh=...)``): the plan comes from ``parallel.mesh.
plan_from_config`` (``tensor_parallel.tp_size`` on ``tensor``,
``moe.expert_parallel_size`` on ``expert``, the rest on ``data`` at stage
<= 2 or ``fsdp`` at stage 3) and ``runtime/zero.Partition`` keeps each
rank's slice of params, grads and optimizer state. The ranks of a batch
axis (data, fsdp, expert) take their own rows; a tensor group's ranks
share theirs and run Megatron's column and row cuts of every layer (the
model's ``copy_to_tensor`` / ``reduce_from_tensor``); a MoE layer gathers
the micro-batch over the batch axes before its gate, as JAX's gates the
global batch (``moe/sharded_moe.py``). ``train_batch`` takes the global batch on every rank;
each rank computes the grads of its contiguous rows (JAX's batch
sharding over ``BATCH_AXES``), reduced when the schedule says
(``comm/schedule.py``); the global norm counts every element once, LAMB's
trust ratios and the 1-bit scales are the whole leaf's, and the fp16
overflow flag is a max over the ranks, so every rank skips the same step.
Each rank divides its summed token losses by the label count of the
whole micro-batch over the data-parallel degree, so the mean over the
ranks is JAX's global token mean also where rows carry different counts
of -100 labels; under ``deferred_grad_sync`` and on the 1-bit compressed
path each rank takes the mean over its own rows, as JAX's manual-over-
``data`` regions do. The 1-bit optimizers take the compressed path where
JAX does (pure data parallel at stage 0): local grads, the phase's own
wire.
A checkpoint is universal: each leaf is gathered whole and rank 0 writes
what a one-rank save writes, and a load keeps each rank's slice, so any
world size and stage loads it.

The capacity tier (``zero_optimization.offload_optimizer`` /
``offload_param``, at one rank; JAX's routing, ``_offload_route``):

- ``offload_optimizer.device=nvme`` (Adam family): the f32 state in
  chunk files, streamed through the card each step
  (``runtime/swap_tensor.NVMeOptimizerSwapper``);
- ``device=cpu`` with ``use_cpu_adam`` (Adam family or Adagrad): the
  state in pinned host memory, updated by the host C++
  (``HostAdamSwapper``);
- ``device=cpu`` (Adam family): the chunk-streamed swapper over pinned
  host buffers ("pinned"; "host" on the CPU);
- ``device=cpu`` with any other optimizer (or a client one): the state
  kept in pinned host memory and moved to the card for the update and
  back (JAX's eager round trip);
- any ``offload_param``: the layer-streamed executor
  (``runtime/infinity.InfinityExecutor``), which then owns the params and
  the optimizer state; ``train_batch``, ``eval_batch`` and the
  checkpoints go through it (mixed cpu / nvme tiers keep their chunks on
  nvme, as in JAX).

Under the swappers ``state["opt"]`` is None and a checkpoint carries the
swapped state as ``optswap.npz`` inside the tag (the integrity manifest
covers it); an executor's tag holds its chunks, ``infinity_shapes.json``,
``infinity_small.npz`` and ``infinity_meta.json``. Over ranks the
swappers hold each rank's ZeRO partition and the executor each rank's
shard of the layer chunks (``runtime/infinity.py``); their checkpoints
keep the one-rank layout.

Pipeline and sequence parallelism (JAX's ``pipe`` and ``seq`` axes):

- ``pipeline.stages`` > 1 wraps the model (``models/pipeline_wrapper``):
  each stage holds its layers, ``gradient_accumulation_steps`` is the
  number of micro-batches, and one call of the pipelined loss takes the
  whole batch through the 1F1B schedule (``parallel/pipeline.py``); the
  ranks of the batch axes take their rows of every micro-batch, each
  micro-batch's CE over its whole label count;
- ``sequence_parallel.sp_size`` > 1: each rank of a ``seq`` group takes
  its piece of every sequence (labels shifted on the whole sequences
  first), attention runs as a ring (``ops/ring_attention.py``), each
  rank's loss is its tokens over the whole count, and the grads and the
  loss are summed over ``seq``.

JAX's errors are raised as JAX raises them: pipe with seq, a model that
is not a transformer under pipe, layers the stages do not divide, and
the layer-streamed offload with pipe, seq or expert. The
``comms_logger`` section switches ``comm.comms_logger`` on.

The training extras, JAX's wiring (``_init_extras``, ``_step_extras``):
``compression_training`` (the ``compression`` transform applied to the
params inside each micro-batch's loss and in ``eval_batch`` at the
applied-update count, the activation-quantized model from its offset,
the layer-reduced student built at init), ``quantize_training`` (MoQ's
per-layer bits inside each loss, its eigenvalue probe refreshed on the
step's batch), ``curriculum_learning`` (the batch cut to the step's
difficulty), ``data_efficiency.data_routing.random_ltd`` and
``progressive_layer_drop``. Their random choices are host draws keyed by
(``config.seed``, the step, the global micro-batch, the layer, the global
row: ``_ltd_draw``, ``_pld_draw``), so a rank of a data-parallel world
draws what one rank draws and no draw waits on the card; the last
step's are in ``step_draws``. The masks and scales are the whole leaf's,
as JAX's GSPMD program computes them: at ZeRO-3 on the leaves gathered
over ``fsdp`` (once a micro-batch), and where the model axes cut a leaf
(``tensor``, ``expert``, ``pipe``) on the whole leaf gathered detached,
each rank applying its slice (``compression/compress.py``; MoQ's
per-layer amax by a max over the ranks); MoQ's probe draws the one-rank
direction and adds every norm and dot over the slices. Compression and
MoQ run on the 1-bit compressed path too, inside each rank's loss at
the applied-update count, as JAX's ``shard_map`` step runs them. Over
``seq`` random-LTD keeps tokens of the whole sequence and runs the ring
over the kept tokens (``runtime/data_pipeline.random_ltd_layer``). Under
the layer-streamed executor compression and MoQ run inside each
streamed layer and the curriculum cuts the batch before it, as in JAX;
PLD and random-LTD, which JAX's executor never reads, raise
``NotImplementedError`` (ROADMAP A11, the extras JAX's executor
ignores); MoQ, PLD and random-LTD under pipeline parallelism raise
JAX's ValueErrors.

The model families (biases, learned positions and token types, ALiBi,
windows, post-LN, the parallel block, a head bias) train on every axis
of the mesh, each rank on its rows, its piece of the sequence or its
slice of the leaves, as JAX's GSPMD program does; over ``pipe`` what
JAX's pipeline drops (token types, the embedding norm,
``final_norm=False``, windows) raises naming ROADMAP A11 (the leaves
JAX's pipeline drops).

Runs on the card: ``device=None`` means "cuda" and raises without CUDA;
``device="cpu"`` runs the plain PyTorch versions of the kernels. What the
port leaves out raises ``NotImplementedError`` naming its ROADMAP item:
the config sections ``config/config.py`` lists.
"""

import collections
import contextlib
import dataclasses
import itertools
import json
import logging
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.schedule import GradSchedule, reduce_grad
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                state_from_numpy)
from deepspeed_tpu_torch.models.pipeline_wrapper import make_pipelined_model
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    check_family_mesh,
                                                    lm_labels, logical_axes,
                                                    ltd_draws, make_model,
                                                    mask_seed, pld_coins)
from deepspeed_tpu_torch.moe.sharded_moe import frozen_routing
from deepspeed_tpu_torch.ops.onebit import PhasedOptimizer
from deepspeed_tpu_torch.ops.optimizers import (Optimizer, cast_tree,
                                                global_grad_norm,
                                                leaf_reduction,
                                                sum_of_squares, tree_leaves,
                                                tree_map)
from deepspeed_tpu_torch.ops.registry import get_optimizer_builder
from deepspeed_tpu_torch.parallel import context as par_ctx
from deepspeed_tpu_torch.parallel.mesh import (BATCH_AXES, Mesh, build_mesh,
                                               plan_from_config)
from deepspeed_tpu_torch.parallel.partitioning import (from_entries,
                                                       model_split)
from deepspeed_tpu_torch.robustness import faults as rb_faults
from deepspeed_tpu_torch.runtime import checkpointing as ckpt_mod
from deepspeed_tpu_torch.runtime import fp16 as fp16_mod
from deepspeed_tpu_torch.runtime import zero as zero_mod
from deepspeed_tpu_torch.runtime.dataloader import DataLoader, PrefetchLoader
from deepspeed_tpu_torch.runtime.lr_schedules import get_scheduler
from deepspeed_tpu_torch.runtime.swap_tensor import (NVMeOptimizerSwapper,
                                                     chunk_planes)

logger = logging.getLogger("deepspeed_tpu_torch")

_ADAM_FAMILY = ("adam", "adamw", "cpuadam", "fusedadam")


def _opt_name(config) -> str:
    return (config.optimizer.name if config.optimizer else "adamw").lower()


def _move_tree(tree, fn):
    """``fn`` over a nested dict's tensors (other leaves kept)."""
    if isinstance(tree, dict):
        return {k: _move_tree(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _copy_back(host, dev):
    """The updated state ``dev`` written back into its host residence
    ``host`` (tensors in place; the step count and other leaves taken)."""
    if isinstance(dev, dict):
        return {k: _copy_back(host[k], v) for k, v in dev.items()}
    if isinstance(host, torch.Tensor) and host is not dev:
        host.copy_(dev, non_blocking=True)
        return host
    return dev


def _to_host(tree):
    """An optimizer state in host memory, pinned where CUDA is there (the
    eager round trip's residence)."""
    pin = torch.cuda.is_available()
    return _move_tree(tree, lambda t: t.detach().to(
        "cpu").pin_memory() if pin and t.device.type != "cpu" else t)


def initialize(args=None, model=None, config=None, config_params=None,
               optimizer=None, lr_scheduler=None, params=None, state=None,
               device=None, training_data=None, mesh=None, mpu=None,
               **kwargs):
    """Build an Engine. ``model``: a ModelSpec (``models.make_model``);
    ``config``: a dict, a JSON path or a Config; ``params``: a JAX-layout
    tree (numpy arrays) instead of the seeded init; ``state``: the JAX
    engine's whole training state as numpy (``models.state_from_numpy``)
    to continue from; ``training_data``: an indexable dataset of rows,
    batched by a ``DataLoader`` of ``train_batch_size`` rows that is
    attached (checkpoints carry its position); ``mesh``: a
    ``parallel.Mesh`` over a process group (None: the plan of
    ``plan_from_config`` over the default group, one rank without one);
    ``mpu``: accepted and unused, as in JAX. Returns (engine, optimizer,
    dataloader, lr_scheduler); dataloader is None without
    training_data."""
    cfg = Config.load(config if config is not None else config_params)
    if args is not None and getattr(args, "deepspeed_config", None):
        cfg = Config.load(args.deepspeed_config)
    engine = Engine(model=model, config=cfg, optimizer=optimizer,
                    lr_scheduler=lr_scheduler, params=params, state=state,
                    device=device, mesh=mesh)
    dataloader = None
    if training_data is not None:
        # train_batch consumes GLOBAL batches (train_batch_size rows)
        dataloader = DataLoader(training_data,
                                batch_size=engine.config.train_batch_size)
        engine.attach_dataloader(dataloader)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler


class _Staged(dict):
    """A batch already on the card, copied on the prefetch stream:
    ``event`` marks the end of its copies."""

    def __init__(self, tensors, event):
        super().__init__(tensors)
        self.event = event


class Engine:
    def __init__(self, model, config: Config,
                 optimizer: Optional[Optimizer] = None, lr_scheduler=None,
                 params=None, state=None, device=None,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.config = config
        if mesh is None:
            mesh = build_mesh(plan_from_config(config,
                                               comm.get_world_size()))
        self.mesh, self.plan = mesh, mesh.plan
        if isinstance(getattr(model, "config", None), TransformerConfig):
            check_family_mesh(model.config, self.plan)
        config.resolve_batch_size(self.plan.dp_world_size)
        if self.plan.world_size > 1:
            logger.info(zero_mod.describe(config.zero_optimization,
                                          self.plan))

        # the `transformer` section rebuilds the model config, as in JAX
        tcfg = config.transformer
        if tcfg.fused_backward or tcfg.tp_overlap_chunks > 1:
            if isinstance(getattr(model, "config", None), TransformerConfig):
                model = make_model(dataclasses.replace(
                    model.config, fused_backward=tcfg.fused_backward,
                    tp_overlap_chunks=int(tcfg.tp_overlap_chunks)),
                    name=model.name)
            else:
                logger.warning("`transformer` config section ignored: model "
                               "is not a transformer ModelSpec")
        self.model = model
        self._init_extras(config)

        # pipeline wrapping (JAX: the PipelineEngine construction); the
        # micro-batches are the accumulation steps, consumed by one call
        self._pp_mode = self.plan.pipe > 1
        if self._pp_mode and self.plan.seq > 1:
            raise ValueError("pipe>1 with seq>1 is not supported: ring "
                             "attention cannot nest inside the pipelined "
                             "manual mesh region")
        if self._pp_mode:
            if not isinstance(getattr(model, "config", None),
                              TransformerConfig):
                raise ValueError("pipeline parallelism requires a transformer "
                                 "ModelSpec (stacked-layer params)")
            self.model = make_pipelined_model(
                model.config, self.mesh,
                num_microbatches=config.gradient_accumulation_steps,
                name=f"{model.name}-pp{self.plan.pipe}")
            logger.info(f"pipeline mode: {self.plan.pipe} stages, "
                        f"{config.gradient_accumulation_steps} microbatches")
        # comms-logger wiring (JAX: the comms_logger section configures the
        # logger at engine init)
        if config.comms_logger.enabled:
            cl = config.comms_logger
            comm.configure(enabled=True, verbose=cl.verbose,
                           prof_ops=() if cl.prof_all else cl.prof_ops)

        # deterministic fault injection armed from the config: the
        # injector is process-global, so a rebuilt engine with the same
        # schedule keeps its counters (robustness/faults.py)
        self.fault_injector = None
        if config.robustness.faults.enabled:
            self.fault_injector = rb_faults.install_from_config(
                config.robustness.faults)

        self.compute_dtype = config.compute_dtype
        self._fp16 = config.fp16.enabled
        use_master = self.compute_dtype != torch.float32

        self.lr_scheduler = lr_scheduler
        self._schedule = None
        if lr_scheduler is None and config.scheduler is not None:
            self._schedule = get_scheduler(config.scheduler.name,
                                           config.scheduler.params)
            self.lr_scheduler = self._schedule
        elif callable(lr_scheduler):
            self._schedule = lr_scheduler
        if optimizer is not None:
            if not (callable(getattr(optimizer, "init", None))
                    and callable(getattr(optimizer, "update", None))):
                raise TypeError("optimizer must be an init/update pair "
                                "(ops.optimizers.Optimizer), got "
                                f"{type(optimizer).__name__}")
            self.optimizer = optimizer
        else:
            opt_cfg = config.optimizer
            name = opt_cfg.name if opt_cfg else "adamw"
            opt_params = dict(opt_cfg.params) if opt_cfg else {}
            if self._schedule is not None:
                opt_params["lr"] = self._schedule
            opt_params.setdefault("use_master_weights", use_master)
            self.optimizer = get_optimizer_builder(name)(**opt_params)
        self._base_lr = None
        if config.optimizer and "lr" in config.optimizer.params:
            self._base_lr = config.optimizer.params["lr"]

        # the 1-bit optimizers' compressed path: where JAX takes it (a pure
        # data-parallel plan at stage 0); elsewhere their dense update
        self._onebit = False
        if isinstance(self.optimizer, PhasedOptimizer) \
                and self.plan.data > 1:
            if self.plan.world_size == self.plan.data \
                    and config.zero_optimization.stage == 0:
                self._onebit = True
                logger.info("1-bit optimizer: compressed communication over "
                            f"the data axis ({self.plan.data} ranks), "
                            "packed sign all-gather in the compressed phase")
            else:
                logger.warning(
                    "1-bit optimizer: compressed communication requires a "
                    "pure data-parallel mesh and zero stage 0; falling back "
                    "to dense (error-feedback sign update semantics are "
                    "preserved, bytes are not reduced)")
        self._sched = GradSchedule.resolve(config.comm, self.plan,
                                           onebit=self._onebit)
        self._part = None
        if self.plan.world_size > 1:
            if not isinstance(getattr(model, "config", None),
                              TransformerConfig):
                raise ValueError("training on more than one rank needs a "
                                 "transformer ModelSpec (its logical axes "
                                 "lay the leaves out over the mesh)")
            self._part = zero_mod.Partition(
                logical_axes(model.config), self.plan, self.mesh,
                config.zero_optimization,
                hierarchical=self._sched.hierarchical)
        self.last_grad_bytes = 0

        # each leaf's cut by the model axes (``_model_split``), and the
        # masks of the compression transform when a dict is set here
        self._splits = None
        self.mask_record = None
        self._swapper = self._infinity = None
        self._offload = self._offload_route(optimizer is not None)
        self._refuse_extras()
        if self._offload == "infinity":
            if state is not None:
                raise ValueError("initialize(state=...) with offload_param: "
                                 "the layer executor loads a checkpoint "
                                 "(load_checkpoint) instead")
            self.state = None
            self._infinity = self._build_infinity(params)
        elif state is None:
            self.state = self._init_state(params)
        else:
            if self._offload in ("nvme", "pinned", "host", "cpu_adam"):
                raise ValueError("initialize(state=...) with a swapped "
                                 "optimizer state: load a checkpoint")
            self.state = self._adopt_state(state)
        # train_batch calls, as JAX counts them (skipped steps included;
        # state["step"] is the applied-update count)
        self.global_steps = (0 if self.state is None
                             else self.state["step"] + self.skipped_steps)
        self.micro_steps = (self.global_steps
                            * config.gradient_accumulation_steps)
        self._dataloader = None
        self._ckpt_engine = None
        self._copy_stream = None
        # 3-call API: grads and losses buffered until the boundary
        self._pending = None
        self._grad_buffer = None
        self._losses = []
        # the 1-bit phase is a host decision on the applied-update count
        self._onebit_applied = (self.state["opt"]["step"] if self._onebit
                                else 0)

    # --- the training extras ----------------------------------------------
    def _init_extras(self, config: Config) -> None:
        """JAX's wiring of the five sections (``engine.py:486-563,
        644-698``), with its refusals: compression (the transform, the
        activation-quant switch, the layer-reduced student), MoQ, the
        seqlen curriculum, progressive layer drop and random-LTD."""
        def transformer(what):
            if not isinstance(getattr(self.model, "config", None),
                              TransformerConfig):
                raise ValueError(f"{what} requires a transformer ModelSpec")

        pipe = self.plan.pipe > 1
        self._compression = None
        self._act_quant, self._act_quant_on = None, False
        if config.compression_training.any_enabled():
            from deepspeed_tpu_torch.compression import init_compression
            comp = init_compression(
                dataclasses.asdict(config.compression_training))
            self._compression = comp if comp.rules else None
            self._act_quant = comp.activation_quant
            lr = comp.layer_reduction
            if self._act_quant or lr:
                transformer("activation_quantization/layer_reduction")
            if lr is not None:
                keep = lr["keep_number"]
                self.model = make_model(dataclasses.replace(
                    self.model.config, num_layers=keep),
                    name=f"{self.model.name}-student{keep}")
                logger.info(f"layer reduction: student keeps {keep} layers")
                if lr["teacher_layer"]:
                    logger.warning(
                        "layer_reduction.teacher_layer is informational "
                        "here: initialize the student from a trained "
                        "teacher with compression.student_params_from_"
                        "teacher(...) (initialize(params=...))")
            if self._act_quant and self._act_quant[1] <= 0:
                self._rebuild_act_quant()
        self._moq = None
        if config.quantize_training.get("enabled"):
            transformer("quantize_training (MoQ)")
            if pipe:
                raise ValueError("quantize_training (MoQ) with pipeline "
                                 "parallelism is not supported")
            from deepspeed_tpu_torch.runtime.quantize import build_moq
            self._moq = build_moq(config.quantize_training,
                                  self.model.config.num_layers)
        self._curriculum = None
        if config.curriculum_learning.enabled:
            from deepspeed_tpu_torch.runtime.data_pipeline import (
                CurriculumScheduler)
            if config.curriculum_learning.curriculum_type != "seqlen":
                raise ValueError("curriculum_type must be 'seqlen' (the "
                                 "reference's only in-engine curriculum)")
            self._curriculum = CurriculumScheduler(dataclasses.asdict(
                config.curriculum_learning))
        self._pld = None
        if config.progressive_layer_drop.enabled:
            transformer("progressive_layer_drop")
            if pipe:
                raise ValueError("progressive_layer_drop with pipeline "
                                 "parallelism is not supported")
            if not self.model.config.progressive_layer_drop:
                self.model = make_model(dataclasses.replace(
                    self.model.config, progressive_layer_drop=True),
                    name=self.model.name)
            self._pld = (config.progressive_layer_drop.theta,
                         config.progressive_layer_drop.gamma)
        self._ltd = None
        self._ltd_keep = None
        routing = config.data_efficiency.data_routing or {}
        if config.data_efficiency.enabled and \
                routing.get("random_ltd", {}).get("enabled"):
            from deepspeed_tpu_torch.runtime.data_pipeline import (
                RandomLTDScheduler)
            transformer("random_ltd")
            if pipe:
                raise ValueError("random_ltd with pipeline parallelism is "
                                 "not supported")
            self._ltd = RandomLTDScheduler(routing)
        # this step's host decisions (``_step_extras``); None between steps
        self._extras = None
        # the draws of the last train_batch, one dict a micro-batch
        self.step_draws = []

    def _refuse_extras(self) -> None:
        """The extras under the layer-streamed offload executor, as JAX's
        executor runs them: compression and MoQ inside each streamed layer
        (MoQ's eigenvalue probe off: the params are not resident), the
        curriculum on the batch before the executor, activation
        quantization from step 0 (JAX's executor is built on the rebuilt
        model). PLD, random-LTD and activation quantization switched on
        later raise: JAX's executor never reads them (ROADMAP C20)."""
        if self._offload != "infinity":
            return
        on = [n for n, v in (("progressive_layer_drop", self._pld),
                             ("random_ltd", self._ltd)) if v]
        if on:
            raise NotImplementedError(
                f"{', '.join(on)} with the layer-streamed offload executor: "
                "ROADMAP A11 (the extras JAX's executor ignores): JAX's "
                "executor trains the model without it (ROADMAP C20)")
        if self._act_quant and self._act_quant[1] > 0:
            raise NotImplementedError(
                "activation_quantization with a schedule_offset > 0 under "
                "the layer-streamed offload executor: ROADMAP A11 (the "
                "extras JAX's executor ignores): JAX rebuilds its model at "
                "the offset, but its executor keeps the model it was built "
                "with (ROADMAP C20)")
        if self._moq is not None and self._moq.ev_enabled:
            logger.warning(
                "MoQ eigenvalue scheduling requires resident params; "
                "layer-streamed offload uses the uniform quantize_period "
                "for every layer")

    def _rebuild_act_quant(self) -> None:
        """The activation-quantized model (JAX's one rebuild)."""
        bits = self._act_quant[0]
        self.model = make_model(dataclasses.replace(
            self.model.config, activation_quant_bits=bits),
            name=self.model.name)
        self._act_quant_on = True
        logger.info(f"activation quantization active: {bits}-bit STE on "
                    "post-norm activations")

    def _step_extras(self, batch):
        """JAX's per-step host work (``engine.py:1484-1513``), before the
        grads: the activation-quant switch at its offset, the curriculum's
        truncation, LTD's kept tokens, PLD's theta(t) = (1 - theta_min)
        exp(-gamma t) + theta_min, MoQ's eigenvalue refresh and bits.
        Returns the (truncated) batch; the decisions wait in
        ``self._extras`` for ``_micro_grads``."""
        t = self.global_steps
        if self._act_quant and not self._act_quant_on \
                and t + 1 >= self._act_quant[1]:
            self._rebuild_act_quant()
        if self._curriculum is not None:
            from deepspeed_tpu_torch.runtime.data_pipeline import (
                apply_seqlen_curriculum)
            batch = apply_seqlen_curriculum(
                batch, self._curriculum.update_difficulty(t + 1))
        ex = {}
        if self._ltd is not None:
            S = batch["input_ids"].shape[1]
            self._ltd_keep = self._ltd.kept_tokens(t + 1, S)
            if self._ltd_keep < S:
                ex["ltd_keep"] = self._ltd_keep
        if self._pld is not None:
            theta_min, gamma = self._pld
            ex["pld_theta"] = float(np.float32(
                (1.0 - theta_min) * np.exp(-gamma * t) + theta_min))
        if self._moq is not None:
            if self._moq.wants_eigenvalues(t) and self.state is not None:
                self._moq.update_eigenvalues(self._moq_probe(batch), t)
            ex["moq_bits"] = self._moq.bits(t)
        self._extras = ex
        self.step_draws = []
        return batch

    def _pld_draw(self, theta: float, micro: int):
        """PLD's keep vector of micro-batch ``micro`` of this step: host
        coins keyed by (config seed, step, micro-batch)."""
        return pld_coins(theta, self.model.config.num_layers,
                         (self.config.seed, self.global_steps, micro))

    def _ltd_draw(self, rows: int, seq_len: int, keep: int, micro: int,
                  row0: int):
        """Random-LTD's kept tokens of this rank's ``rows`` rows (global
        rows ``row0``..) of micro-batch ``micro``, keyed by (config seed,
        step, micro-batch, layer, global row)."""
        return ltd_draws(self.model.config, rows, seq_len, keep,
                         (self.config.seed, self.global_steps, micro),
                         self.device, row0=row0)

    def _extras_kw(self, mb, micro: int, row: Optional[int]):
        """The loss's keywords for this step's LTD or PLD draws (LTD wins,
        as in JAX), recorded in ``step_draws``."""
        ex = self._extras
        if not ex:
            return {}
        kw, draw = {}, {}
        if "ltd_keep" in ex:
            # over ``seq`` the ids are this rank's piece: the kept tokens
            # are drawn from the whole sequence
            ids = mb["input_ids"]
            kw["ltd_select"] = self._ltd_draw(
                ids.shape[0], ids.shape[1] * self.plan.seq, ex["ltd_keep"],
                micro, row or 0)
            draw["ltd_keep"] = ex["ltd_keep"]
        elif "pld_theta" in ex:
            kw["pld_theta"] = ex["pld_theta"]
            kw["pld_keep"] = self._pld_draw(ex["pld_theta"], micro)
            draw["pld_keep"] = list(kw["pld_keep"])
        if kw:
            kw["train"] = True
            self.step_draws.append(draw)
        return kw

    def _whole_params(self, params):
        """At ZeRO-3, the param tree gathered whole (differentiable: the
        grads go back to the shards through the gathers); else itself."""
        if self._part is None or self._part.stage < 3:
            return params
        gather = self._part.gatherer()
        whole = gather(params)
        whole["layers"] = gather(params["layers"], "layers/")
        return whole

    def _model_split(self, path: str):
        """How the model axes cut leaf ``path`` on this rank
        (``parallel.partitioning.model_split``; None: the rank holds it
        whole)."""
        if self._part is None:
            return None
        if self._splits is None:
            self._splits = {p: model_split(lay.shape, lay.pspec, self.mesh)
                            for p, lay in self._part.layouts.items()}
        return self._splits.get(path)

    def _forward_params(self, params, moq: bool = True):
        """The params the loss sees: the compression transform at the
        applied-update count, then MoQ at this step's bits (JAX's
        ``micro_grads``); at ZeRO-3 on the leaves gathered over ``fsdp``,
        and where the model axes cut a leaf with the whole leaf's masks
        and scales (as JAX's GSPMD program computes them). The masks each
        rank applies go into ``mask_record`` when it is a dict. Returns
        (params, whole): ``whole`` when the model must not gather
        again."""
        bits = (self._extras or {}).get("moq_bits") if moq else None
        if self._compression is None and bits is None:
            return params, False
        p = self._whole_params(params)
        if self._compression is not None:
            p = self._compression.apply(p, self.state["step"],
                                        split=self._model_split,
                                        record=self.mask_record)
        if bits is not None:
            p = self._moq.apply(p, bits, split=self._model_split)
        return p, p is not params and self._part is not None \
            and self._part.stage >= 3

    def _moq_probe(self, batch):
        """MoQ's per-layer curvature on this step's batch (JAX probes the
        global batch with the model's eval loss): each rank probes its
        rows (over ``seq`` its piece of them, each piece's token losses
        over the whole count), and each difference pass's grads are
        reduced as the step's are (``comm.schedule.reduce_grad`` of the
        leaf as the model sees it); at ZeRO-3 on the whole layers; where
        the model axes cut a leaf, the direction, norms and dots are the
        whole leaf's; a MoE layer keeps the probed params' expert choices
        in every pass (``moe.sharded_moe.frozen_routing``), as JAX's jvp
        does."""
        params = self.state["params"]
        if self._part is None:
            local, kw, reduce, splits, row = batch, {}, None, None, None
        else:
            batch = self._seq_labels(batch)
            local = self._local_rows(batch)
            kw = {}
            if self.plan.seq > 1:
                kw["label_count"] = self._denominators(
                    (batch["labels"] != -100).sum())
            row = self._dp_index() * local["input_ids"].shape[0]
            layers = sorted(params["layers"])
            splits = {k: self._model_split("layers/" + k) for k in layers}
            # the probe's leaves are whole but for the model axes' cuts
            specs = [() if splits[k] is None
                     else from_entries(splits[k].dims) for k in layers]
            dtypes = [params["layers"][k].dtype for k in layers]

            def reduce(grads):
                return [reduce_grad(g, s, s, None, self.plan, self.mesh,
                                    self._part.inv_dp, d)
                        for g, s, d in zip(grads, specs, dtypes)]
        gen = torch.Generator(self.device).manual_seed(
            mask_seed(self.config.seed, self.global_steps, 0x6D6F71))
        with self._step_context(), contextlib.ExitStack() as ctx:
            if row is not None:
                # a MoE layer gathers the rows over the batch axes
                ctx.enter_context(par_ctx.batch_rows(row))
            if self._part is not None and self._part.stage >= 3:
                with torch.no_grad():
                    params = self._whole_params(params)
                ctx.enter_context(par_ctx.param_gather(None))

            def loss_fn(p, b):
                return self.model.loss_fn(p, b, **kw)
            if "wg" in params["layers"]:
                # every pass routes the tokens as the probed params do
                # (one forward records it)
                ctx.enter_context(frozen_routing())
                with torch.no_grad():
                    loss_fn(params, local)
            return self._moq.layer_eigenvalues(
                loss_fn, params, local, generator=gen, reduce=reduce,
                splits=splits)

    # --- the capacity tier ------------------------------------------------
    def _offload_route(self, client_optimizer: bool) -> Optional[str]:
        """JAX's routing of the offload sections (``engine.py:247-421``):
        "infinity", "nvme", "cpu_adam", "pinned" / "host" (the chunk-
        streamed swapper's storage), "eager" or None."""
        zc = self.config.zero_optimization
        off_o, off_p = zc.offload_optimizer, zc.offload_param
        if not (off_o.enabled or off_p.enabled):
            return None
        if off_p.enabled and (self.plan.pipe > 1 or self.plan.seq > 1
                              or self.plan.expert > 1):
            raise ValueError("layer-streamed offload shards over "
                             "data/fsdp/tensor (pipe/seq/expert must be 1)")
        if off_p.enabled and self.plan.world_size > 1 \
                and not self.config.mesh.axes:
            # JAX's rule on hardware: never one rank's executor per rank
            raise ValueError("multi-device layer-streamed offload requires "
                             "an explicit mesh config: set mesh.axes "
                             "{'data': N} and/or {'fsdp': N}")
        name = _opt_name(self.config)
        if off_p.enabled:
            if not isinstance(getattr(self.model, "config", None),
                              TransformerConfig):
                raise ValueError("offload_param requires a transformer "
                                 "ModelSpec (layer streaming)")
            nvme = "nvme" in (off_p.device, off_o.device)
            if nvme and not (off_p.nvme_path or off_o.nvme_path):
                raise ValueError("offload_param.device=nvme requires "
                                 "nvme_path")
            if name not in ("adam", "adamw"):
                raise ValueError("layer-streamed offload supports the Adam "
                                 f"family only (got '{name}')")
            if client_optimizer:
                raise ValueError("layer-streamed offload requires a "
                                 "config-built optimizer, not a client one")
            return "infinity"
        if off_o.device == "nvme":
            if not off_o.nvme_path:
                raise ValueError("offload_optimizer.device=nvme requires "
                                 "offload_optimizer.nvme_path")
            if name not in _ADAM_FAMILY:
                raise ValueError("offload_optimizer.device=nvme supports the "
                                 f"Adam family only (got '{name}'): the "
                                 "flat-chunk swap update is AdamW")
            if client_optimizer:
                raise ValueError("offload_optimizer.device=nvme requires a "
                                 "config-built optimizer, not a client one")
            return "nvme"
        if off_o.use_cpu_adam:
            if (name not in _ADAM_FAMILY + ("adagrad", "cpuadagrad")
                    or client_optimizer):
                raise ValueError(
                    "offload_optimizer.use_cpu_adam requires a config-built "
                    f"Adam-family or Adagrad optimizer (got '{name}'"
                    f"{', client-supplied' if client_optimizer else ''})")
            return "cpu_adam"
        if name in _ADAM_FAMILY and not client_optimizer:
            return "pinned" if self.device.type == "cuda" else "host"
        return "eager"

    def _swap_layout(self):
        """[(leaf layout, the shape of the rank's optimizer slice)]: the
        swapped state's layout over ranks, leaf by leaf."""
        part, params = self._part, self.state["params"]
        return [(lay, tuple(part.opt_view(lay, p).shape))
                for lay, p in zip(part.in_order(params), tree_leaves(params))]

    def _swap_export(self) -> Dict[str, np.ndarray]:
        """The swapped state in the one-rank layout: over ranks every
        leaf's planes gathered whole from the partitions (collective)."""
        state = self._swapper.export_state()
        if self._part is None:
            return state
        local = torch.from_numpy(self._swapper.planes(state))
        P, off, whole = local.shape[0], 0, []
        for lay, shape in self._swap_layout():
            n = math.prod(shape)
            piece = local[:, off:off + n].reshape((P,) + shape)
            off += n
            whole.append(torch.stack([
                self._part.whole(piece[j].contiguous(), lay.ospec)
                for j in range(P)]).reshape(P, -1))
        return self._one_rank_swapper_state(torch.cat(whole, 1).numpy())

    def _one_rank_swapper_state(self, planes):
        """Whole planes in the layout a one-rank swapper exports."""
        if isinstance(self._swapper, NVMeOptimizerSwapper):
            return chunk_planes(planes, self._swapper.chunk)
        return self._swapper.state_from_planes(planes)

    def _swap_import(self, state: Dict[str, np.ndarray]) -> None:
        """A one-rank layout's swapped state: over ranks each rank keeps
        its partition of every leaf's planes."""
        if self._part is None:
            self._swapper.import_state(state)
            return
        layout = self._swap_layout()
        planes = self._swapper.planes(
            state, sum(math.prod(lay.shape) for lay, _ in layout))
        off, mine = 0, []
        for lay, _ in layout:
            n = math.prod(lay.shape)
            piece = planes[:, off:off + n].reshape((-1,) + tuple(lay.shape))
            off += n
            mine.append(np.stack([self._part.slice_of(piece[j], lay.ospec)
                                  for j in range(piece.shape[0])]).reshape(
                piece.shape[0], -1))
        self._swapper.import_state(self._swapper.state_from_planes(
            np.ascontiguousarray(np.concatenate(mine, 1))))

    def _opt_params(self):
        """(name, the optimizer section's params with JAX's defaults)."""
        p = dict(self.config.optimizer.params) if self.config.optimizer \
            else {}
        name = _opt_name(self.config)
        adagrad = name in ("adagrad", "cpuadagrad")
        return name, dict(
            betas=tuple(p.get("betas", (0.9, 0.999))),
            eps=p.get("eps", 1e-10 if adagrad else 1e-8),
            weight_decay=p.get("weight_decay",
                               0.01 if name in ("adamw", "cpuadam") else 0.0),
            adam_w_mode=(name in ("adamw", "cpuadam")
                         or p.get("adam_w_mode", False)),
            bias_correction=p.get("bias_correction", True))

    def _build_swapper(self, leaves):
        from deepspeed_tpu_torch.runtime.swap_tensor import (
            HostAdamSwapper, NVMeOptimizerSwapper)
        off = self.config.zero_optimization.offload_optimizer
        name, kw = self._opt_params()
        if self._offload == "cpu_adam":
            return HostAdamSwapper(
                leaves, device=self.device, compute_dtype=self.compute_dtype,
                optim="adagrad" if name in ("adagrad", "cpuadagrad")
                else "adam", **kw)
        return NVMeOptimizerSwapper(
            leaves, device=self.device, nvme_path=off.nvme_path,
            storage=self._offload, chunk_elems=max(1, off.buffer_size // 4),
            pipeline=bool(off.pipeline_read or off.pipeline_write),
            aio_config=self.config.aio, betas=kw["betas"], eps=kw["eps"],
            weight_decay=kw["weight_decay"], adam_w_mode=kw["adam_w_mode"],
            bias_correction=kw["bias_correction"])

    def _build_infinity(self, params):
        from deepspeed_tpu_torch.runtime.infinity import InfinityExecutor
        zc = self.config.zero_optimization
        off_p, off_o = zc.offload_param, zc.offload_optimizer
        if "nvme" in (off_p.device, off_o.device):
            backend = "nvme"
        else:
            backend = "pinned" if self.device.type == "cuda" else "host"
        _, kw = self._opt_params()
        lr = (self._schedule if self._schedule is not None
              else (self._base_lr if self._base_lr is not None else 1e-3))
        f = self.config.fp16
        # the live cache only when the key is set, as in JAX (its default
        # would keep ~1e9 params' bits on the card unasked)
        live = (zc.stage3_max_live_parameters
                if zc.was_set("stage3_max_live_parameters") else 0)
        return InfinityExecutor(
            dataclasses.replace(self.model.config, dtype=self.compute_dtype),
            device=self.device, seed=self.config.seed, params=params,
            mesh=self.mesh if self.plan.world_size > 1 else None,
            compression=self._compression, moq=self._moq is not None,
            max_live_params=live,
            nvme_path=off_p.nvme_path or off_o.nvme_path, lr=lr,
            grad_clip=self.config.gradient_clipping or 0.0, backend=backend,
            param_cache_bytes=off_p.max_in_cpu,
            gas=self.config.gradient_accumulation_steps,
            fp16=dataclasses.asdict(f) if f.enabled else None,
            use_cpu_adam=off_o.use_cpu_adam,
            pipeline=bool((off_p.pipeline_read or off_p.pipeline_write)
                          and (off_o.pipeline_read or off_o.pipeline_write)),
            aio_config=self.config.aio, **kw)

    def offload_bytes(self) -> Dict[str, int]:
        """Bytes of training state by tier: on the card (params, and
        optimizer state where it stays there), in host memory and on
        disk."""
        if self._infinity is not None:
            ex = self._infinity
            return {"device": ex.device_bytes(),
                    "host": ex.store.host_bytes()
                    + sum(t.numel() * t.element_size()
                          for t in ex._param_cache.values()),
                    "disk": ex.store.disk_bytes()}
        params = sum(t.numel() * t.element_size()
                     for t in tree_leaves(self.state["params"]))
        opt = [t for t in tree_leaves(self.state["opt"] or {})
               if isinstance(t, torch.Tensor)]
        on_card = sum(t.numel() * t.element_size() for t in opt
                      if t.device.type == self.device.type)
        host = sum(t.numel() * t.element_size() for t in opt) - on_card
        if self._swapper is not None:
            host += self._swapper.host_bytes()
        return {"device": params + on_card, "host": host,
                "disk": self._swapper.disk_bytes() if self._swapper else 0}

    def close(self) -> None:
        """Stop the offload tiers' threads and delete their files."""
        for tier in (self._swapper, self._infinity):
            if tier is not None:
                tier.close()

    @property
    def world_size(self) -> int:
        return self.plan.world_size

    def _layouts(self):
        return self._part.in_order(self.state["params"])

    def _step_context(self):
        """The contexts of a step: the mesh (the comm facade's axes) and,
        at stage 3, the model's parameter gatherer."""
        ctx = contextlib.ExitStack()
        ctx.enter_context(par_ctx.parallel_context(self.mesh))
        if self._part is not None and self._part.stage >= 3:
            ctx.enter_context(par_ctx.param_gather(self._part.gatherer()))
        return ctx

    # ------------------------------------------------------------------
    def _init_state(self, params):
        """f32 params -> optimizer state (masters copied from them) ->
        params in the compute dtype, each an autograd leaf. On more than
        one rank each leaf is cut to this rank's param slice as it is
        drawn, and the optimizer state is built on the optimizer's slices
        of those."""
        part = self._part
        keep = None if part is None else part.param_shard
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.config.seed)
            params32 = self.model.init(gen, self.device, dtype=torch.float32,
                                       **({} if keep is None
                                          else {"keep": keep}))
        else:
            params32 = params_from_numpy(params, self.model.config,
                                         device=self.device,
                                         dtype=torch.float32)
            if keep is not None:
                params32 = self._map_paths(params32, keep)
        if self._offload in ("nvme", "pinned", "host", "cpu_adam"):
            opt_state = None
        elif part is None:
            opt_state = self.optimizer.init(params32)
            if self._offload == "eager":
                opt_state = _to_host(opt_state)
        else:
            views = iter([part.opt_view(lay, p) for lay, p in zip(
                part.in_order(params32), tree_leaves(params32))])
            opt_state = self.optimizer.init(
                tree_map(lambda _: next(views), params32))
            if self._offload == "eager":
                opt_state = _to_host(opt_state)
        params = cast_tree(params32, self.compute_dtype)
        del params32
        for p in tree_leaves(params):
            p.requires_grad_(True)
        if opt_state is None:
            # the swapped masters start from the compute-dtype params, as
            # JAX's swappers do; over ranks each rank swaps its ZeRO
            # partition (every leaf's optimizer slice)
            held = self._swap_leaves(params)
            self._swapper = self._build_swapper(held)
            self._swapper.initialize(held)
        return {"params": params, "opt": opt_state, "step": 0,
                **self._fp16_state()}

    def _fp16_state(self):
        """JAX's fp16 leaves of the training state: the scaler
        (``loss_scale``: scale, good_steps, hysteresis) and the count of
        skipped steps, all 0-dim on the device. Empty without fp16."""
        if not self._fp16:
            return {}
        f = self.config.fp16
        ls = (fp16_mod.init_loss_scale(f.initial_scale_power, f.hysteresis,
                                       device=self.device) if f.dynamic
              else fp16_mod.static_loss_scale(f.loss_scale,
                                              device=self.device))
        return {"loss_scale": ls._asdict(),
                "skipped": torch.zeros((), dtype=torch.int32,
                                       device=self.device)}

    @staticmethod
    def _map_paths(tree, fn, prefix: str = ""):
        """``fn(path, leaf)`` over a nested dict's leaves."""
        return {k: (Engine._map_paths(v, fn, f"{prefix}{k}/")
                    if isinstance(v, dict) else fn(prefix + k, v))
                for k, v in tree.items()}

    def _adopt_state(self, state):
        """A JAX training state (numpy) as this engine's, checked against
        the structure this engine's optimizer builds (on more than one
        rank, each leaf cut to this rank's slice)."""
        adopted = state_from_numpy(state, self.model.config,
                                   device=self.device,
                                   compute_dtype=self.compute_dtype)
        meta = tree_map(lambda p: torch.empty_like(p, device="meta"),
                        adopted["params"])
        want = {"params": meta, "opt": self.optimizer.init(meta), "step": 0,
                **self._fp16_state()}
        _check_structure(ckpt_mod.flatten(adopted), ckpt_mod.flatten(want),
                         "state")
        if self._part is not None:
            for path, p in ckpt_mod.flatten(adopted["params"]).items():
                self._part.layout(path, p.shape)
            adopted = self._map_paths(adopted, lambda key, leaf: (
                self._local_of(key, leaf).clone()
                if isinstance(leaf, torch.Tensor) else leaf))
        for p in tree_leaves(adopted["params"]):
            p.requires_grad_(True)
        return adopted

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        if isinstance(batch, _Staged):
            # staged on the prefetch stream: order this stream after its
            # copies, and tell the allocator the tensors are used here
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(batch.event)
            for t in batch.values():
                t.record_stream(stream)
            return dict(batch)
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    def _stage_batch(self, batch):
        """The prefetch placement: on CUDA, each host leaf is pinned and
        copied on a side stream (the copy of batch N+1 overlaps step N);
        on the CPU, the plain placement."""
        if self.device.type != "cuda":
            return self._device_batch(batch)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        host = {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.asarray(v)))
                for k, v in batch.items()}
        host = {k: (v if v.is_cuda else v.pin_memory())
                for k, v in host.items()}
        with torch.cuda.stream(self._copy_stream):
            dev = {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return _Staged(dev, done)

    def _dropout_kw(self, micro: int) -> Dict[str, int]:
        """The loss function's training keywords for micro-batch ``micro``
        of this step: a MoE model routes with the training capacity
        (``train``); a model with ``dropout_rate > 0`` or a MoE model with
        gate noise gets the seed of its masks and noise, fixed by (config
        seed, step, micro-batch), so a replayed layer, a repeated run and
        a resumed one draw the same masks and noise."""
        mcfg = getattr(self.model, "config", None)
        kw = {}
        moe = getattr(mcfg, "num_experts", 1) > 1
        if moe:
            kw["train"] = True
        if getattr(mcfg, "dropout_rate", 0.0) or (
                moe and getattr(mcfg, "noisy_gate_policy", None)):
            if self._pp_mode:
                # the pipeline's micro-batches draw what the one-stage
                # run's micro-batches draw
                kw["micro_seeds"] = [
                    mask_seed(self.config.seed, self.global_steps, i)
                    for i in range(self.config.gradient_accumulation_steps)]
            else:
                kw["dropout_seed"] = mask_seed(self.config.seed,
                                               self.global_steps, micro)
        return kw

    def _micro_grads(self, mb, micro: int = 0, row: Optional[int] = None,
                     label_count=None):
        """(loss, f32 grads as a list over the param leaves) of one
        micro-batch; under fp16 the grads are those of the scaled loss
        (the loss itself comes back unscaled). On more than one rank the
        grads are this rank's, unreduced (a ZeRO-3 shard's summed over
        ``fsdp`` by its gather's backward); ``row``: where this rank's
        rows start in micro-batch ``micro`` of the one-rank run, for
        dropout; ``label_count``: the loss's denominator
        (``_label_counts``; None: this micro-batch's own count)."""
        leaves = tree_leaves(self.state["params"])
        kw = self._dropout_kw(micro)
        kw.update(self._extras_kw(mb, micro, row))
        with contextlib.ExitStack() as ctx:
            if row is not None:
                # the rows are this rank's (a MoE layer gathers the
                # micro-batch's); the backward's remat replay redraws the
                # masks: both passes run in the rows' context
                ctx.enter_context(par_ctx.batch_rows(row))
            if label_count is not None:
                kw["label_count"] = label_count
            params, whole = self._forward_params(self.state["params"])
            if whole:
                # the leaves are whole already: no gather in the layers
                ctx.enter_context(par_ctx.param_gather(None))
            loss = self.model.loss_fn(params, mb, **kw)
            target = loss
            if self._fp16:
                target = fp16_mod.scale_loss(
                    loss, fp16_mod.LossScaleState(**self.state["loss_scale"]))
            grads = torch.autograd.grad(target, leaves,
                                        materialize_grads=True)
        return loss.detach(), [g.float() for g in grads]

    def _accumulate(self, acc, grads):
        """Add one micro-batch's grads into ``acc`` (None: the first), the
        1/gas mean folded into the accumulate, as JAX's
        ``_accum_micro_grads``; with gas = 1 the grads themselves."""
        gas = self.config.gradient_accumulation_steps
        if gas == 1:
            return grads
        if acc is None:
            acc = [torch.zeros_like(g) for g in grads]
        inv_gas = float(np.float32(1.0 / gas))
        for a, g in zip(acc, grads):
            a.add_(g * inv_gas)
        return acc

    @staticmethod
    def _mean_loss(losses):
        return losses[0] if len(losses) == 1 else torch.stack(losses).mean()

    def _seq_labels(self, batch):
        """Over ``seq``: the batch with its labels made explicit, shifted
        on the whole sequences before each rank takes its piece (JAX's
        labels are the global ids shifted)."""
        if self.plan.seq > 1 and "labels" not in batch:
            batch = dict(batch, labels=lm_labels(batch))
        return batch

    def _local_rows(self, batch):
        """This rank's contiguous rows of the global batch (the batch dim
        sharded over ``BATCH_AXES``, as JAX shards it), and over ``seq``
        its piece of every sequence (JAX's ``P(BATCH_AXES, "seq")``)."""
        if self._part is None:
            return batch
        spec = (BATCH_AXES, "seq") if self.plan.seq > 1 else (BATCH_AXES,)
        return {k: self._part.slice_of(v, spec[:v.dim()])
                for k, v in self._seq_labels(batch).items()}

    def _pipe_rows(self, batch):
        """Pipeline mode: this rank's rows of each of the batch's M
        micro-batches (micro-batch i is rows [i * mb, (i + 1) * mb) of the
        global batch, as JAX's pipelined loss cuts it; the batch axes
        split each micro-batch's rows), as M * mb / dp rows."""
        M = self.config.gradient_accumulation_steps
        dp, d = self.plan.dp_world_size, self._dp_index()
        out = {}
        for k, v in batch.items():
            mb = v.reshape((M, v.shape[0] // M) + v.shape[1:])
            n = mb.shape[1] // dp
            out[k] = mb[:, d * n:(d + 1) * n].reshape(
                (M * n,) + v.shape[1:])
        return out

    def _pipe_grads(self, batch):
        """Pipeline mode: loss and grads of this rank's rows of all M
        micro-batches from one call of the pipelined loss (the 1F1B
        schedule), each micro-batch's CE over its whole label count (every
        data-parallel rank's rows) over dp; reduced over the batch
        axes."""
        M = self.config.gradient_accumulation_steps
        counts = self._denominators(
            (lm_labels(batch) != -100).reshape(M, -1).sum(1))
        local = self._pipe_rows(batch)
        rows = local["input_ids"].shape[0] // M
        loss, grads = self._micro_grads(local,
                                        row=self._dp_index() * rows,
                                        label_count=counts)
        grads = self._part.reduce_grads(grads, self.state["params"])
        return grads, self._part.mean_over_ranks(loss)

    def _dp_index(self) -> int:
        """This rank's piece of the batch dim (``BATCH_AXES`` raveled)."""
        i = 0
        for a in BATCH_AXES:
            i = i * self.mesh.size(a) + self.mesh.index(a)
        return i

    def _denominators(self, counts):
        """A data-parallel rank's loss denominators: each count of labels
        of a whole micro-batch (every rank's rows), at least 1, over the
        data-parallel degree. A rank's summed token losses over this,
        averaged over the ranks, is the micro-batch's token mean."""
        return counts.clamp_min(1).float() / self.plan.dp_world_size

    def _rank_accum_grads(self, batch):
        """Grads of this rank's rows of the global ``batch`` over ``gas``
        micro-batches, each reduced as it is made (the default schedule)
        or reduced once at the boundary (deferred), and the loss averaged
        over the ranks. The 1-bit compressed path leaves the grads
        unreduced. Micro-batch i of this rank's rows is global micro-batch
        (d * gas + i) // dp of the one-rank run, at row offset
        ((d * gas + i) % dp) * micro (d: this rank's dp index): dropout
        draws that, and on the eager schedule its loss is divided by that
        micro-batch's label count (JAX's global token mean; without
        explicit labels every rank's count is the same)."""
        if self._pp_mode:
            return self._pipe_grads(batch)
        gas = self.config.gradient_accumulation_steps
        dp, d = self.plan.dp_world_size, self._dp_index()
        batch = self._seq_labels(batch)
        local = self._local_rows(batch)
        micro_rows = local["input_ids"].shape[0] // gas
        mbs = {k: v.reshape((gas, v.shape[0] // gas) + v.shape[1:])
               for k, v in local.items()}
        eager = not (self._sched.deferred or self._onebit)
        counts = None
        if eager and "labels" in batch:
            counts = self._denominators(
                (lm_labels(batch) != -100).reshape(gas, -1).sum(1))
        acc, losses = None, []
        for i in range(gas):
            n = d * gas + i
            loss, grads = self._micro_grads(
                {k: v[i] for k, v in mbs.items()}, micro=n // dp,
                row=(n % dp) * micro_rows,
                label_count=None if counts is None else counts[n // dp])
            if eager:
                grads = self._part.reduce_grads(grads, self.state["params"])
            acc = self._accumulate(acc, grads)
            losses.append(loss)
        if self._sched.deferred:
            acc = self._part.reduce_grads(acc, self.state["params"])
        return acc, self._part.mean_over_ranks(self._mean_loss(losses))

    def _accum_micro_grads(self, batch):
        """Grads averaged over ``gas`` micro-batches and the mean loss."""
        if self._part is not None:
            return self._rank_accum_grads(batch)
        gas = self.config.gradient_accumulation_steps
        if gas == 1:
            loss, grads = self._micro_grads(batch)
            return grads, loss
        mbs = {k: v.reshape((gas, v.shape[0] // gas) + v.shape[1:])
               for k, v in batch.items()}
        acc, losses = None, []
        for i in range(gas):
            loss, grads = self._micro_grads({k: v[i] for k, v in mbs.items()},
                                            micro=i)
            acc = self._accumulate(acc, grads)
            losses.append(loss)
        return acc, self._mean_loss(losses)

    def _global_norm(self, grads):
        """The global grad norm: on more than one rank each element
        counted once (``Partition.grad_norm``); on the 1-bit compressed
        path JAX's RMS over the ranks of the local norms (an upper bound
        of the averaged gradient's norm, identical on every rank)."""
        if self._part is None:
            return global_grad_norm(grads)
        if self._onebit:
            gsq = torch.stack([sum_of_squares(g) for g in grads]).sum()
            return comm.all_reduce(gsq.reshape(1), "data",
                                   op="mean")[0].sqrt()
        return self._part.grad_norm(grads, self._layouts(), sum_of_squares)

    def _update(self, grads):
        """The optimizer update, in place. On more than one rank on the
        optimizer's slices (params seen through views, so the masters'
        write-back lands in the params), per-leaf statistics summed over
        the shards, then the updated params gathered; on the 1-bit
        compressed path the phase's own update over the data axis."""
        params = self.state["params"]
        if self._onebit:
            it = iter(grads)
            self.optimizer.update_phase(
                tree_map(lambda _: next(it), params), self.state["opt"],
                params, phase=self.optimizer.phase_for(self._onebit_applied),
                axis="data")
            self._onebit_applied += 1
            return
        if self._part is None:
            it = iter(grads)
            opt = self.state["opt"]
            if self._offload == "eager":
                # JAX's eager round trip: the state lives in pinned host
                # memory and comes to the card for the update
                opt = _move_tree(opt, lambda t: t.to(self.device,
                                                     non_blocking=True))
            self.optimizer.update(tree_map(lambda _: next(it), params), opt,
                                  params)
            if self._offload == "eager":
                self.state["opt"] = _copy_back(self.state["opt"], opt)
            return
        part, layouts = self._part, self._layouts()
        leaves = tree_leaves(params)
        g_it = iter([part.grad_view(lay, g)
                     for lay, g in zip(layouts, grads)])
        p_it = iter([part.opt_view(lay, p)
                     for lay, p in zip(layouts, leaves)])
        opt = self.state["opt"]
        if self._offload == "eager":
            # each rank's optimizer slices round-trip as at one rank
            opt = _move_tree(opt, lambda t: t.to(self.device,
                                                 non_blocking=True))
        with leaf_reduction(part.leaf_reducer(layouts)):
            self.optimizer.update(tree_map(lambda _: next(g_it), params),
                                  opt, tree_map(lambda _: next(p_it), params))
        if self._offload == "eager":
            self.state["opt"] = _copy_back(self.state["opt"], opt)
        part.gather_updated(leaves, layouts)

    @torch.no_grad()
    def _apply_grads(self, grads, mean_loss):
        """JAX's ``apply_grads``: under fp16 unscale and the overflow
        check (on more than one rank, true on every rank when true on
        any), then the global norm, clipping, the optimizer update (in
        place, masters written back into the params) unless the step
        overflowed, and the scaler's update."""
        if self._swapper is not None:
            return self._swap_apply(grads, mean_loss)
        ls = None
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        if self._fp16:
            ls = fp16_mod.LossScaleState(**self.state["loss_scale"])
            grads = fp16_mod.unscale_grads(grads, ls)
            overflow = fp16_mod.has_overflow(grads)
            if self._part is not None:
                overflow = self._part.any_rank(overflow)
        self.last_grad_bytes = sum(g.numel() * g.element_size()
                                   for g in grads)
        gnorm = self._global_norm(grads)
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            scale = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale)
        # fp16: the one host sync a step (the update below writes in place)
        if not (self._fp16 and bool(overflow)):
            self._update(grads)
            self.state["step"] += 1
        metrics = {"loss": mean_loss, "grad_norm": gnorm,
                   "overflow": overflow}
        if self._fp16:
            f = self.config.fp16
            new = fp16_mod.update_loss_scale(
                ls, overflow, dynamic=f.dynamic,
                scale_window=f.loss_scale_window,
                min_scale=f.min_loss_scale, max_hysteresis=f.hysteresis,
                consecutive_hysteresis=f.consecutive_hysteresis)
            self.state["loss_scale"] = new._asdict()
            self.state["skipped"] += overflow.to(torch.int32)
            metrics["loss_scale"] = ls.scale
        return metrics

    def _swap_leaves(self, params):
        """The param slices the swapper holds: every leaf, or over ranks
        each leaf's optimizer slice (a view into the rank's param)."""
        if self._part is None:
            return tree_leaves(params)
        return [self._part.opt_view(lay, p) for lay, p in zip(
            self._part.in_order(params), tree_leaves(params))]

    def _swap_apply(self, grads, mean_loss):
        """JAX's ``_nvme_apply``: the swapper's step (the norm, clip and
        overflow over what it holds; over ranks the norm over every rank,
        the update on the rank's partition, the params gathered after),
        then the scaler's update on the host's overflow flag. An
        overflowed step writes nothing."""
        self.last_grad_bytes = sum(g.numel() * g.element_size()
                                   for g in grads)
        ls = None
        scale = 1.0
        if self._fp16:
            ls = fp16_mod.LossScaleState(**self.state["loss_scale"])
            scale = float(ls.scale)
        leaves = tree_leaves(self.state["params"])
        held, sq, part = leaves, None, self._part
        if part is not None:
            layouts = self._layouts()
            sq = float(self._global_norm(grads)) ** 2
            grads = [part.grad_view(lay, g).contiguous()
                     for lay, g in zip(layouts, grads)]
            views = self._swap_leaves(self.state["params"])
            held = [v.detach().contiguous() for v in views]
        gnorm, overflow = self._swapper.step(
            grads, held, lr=self.get_lr(),
            step_num=self.state["step"] + 1,
            clip=self.config.gradient_clipping, grad_scale=scale,
            sq_total=sq)
        if part is not None and not overflow:
            with torch.no_grad():
                for v, h in zip(views, held):
                    if h.data_ptr() != v.data_ptr():
                        v.copy_(h)
            part.gather_updated(leaves, layouts)
        if not overflow:
            self.state["step"] += 1
        flag = torch.tensor(overflow, device=self.device)
        metrics = {"loss": mean_loss,
                   "grad_norm": torch.tensor(gnorm, dtype=torch.float32,
                                             device=self.device),
                   "overflow": flag}
        if self._fp16:
            f = self.config.fp16
            new = fp16_mod.update_loss_scale(
                ls, flag, dynamic=f.dynamic,
                scale_window=f.loss_scale_window,
                min_scale=f.min_loss_scale, max_hysteresis=f.hysteresis,
                consecutive_hysteresis=f.consecutive_hysteresis)
            self.state["loss_scale"] = new._asdict()
            self.state["skipped"] += flag.to(torch.int32)
            metrics["loss_scale"] = ls.scale
        return metrics

    def train_batch(self, batch) -> Dict[str, Any]:
        """One global batch (train_batch_size rows) -> one optimizer step.
        Returns {"loss", "grad_norm", "overflow"} (and "loss_scale" under
        fp16) as 0-dim device tensors. Nothing is fetched to the host,
        except under fp16 the overflow flag: one read a step, before the
        in-place update."""
        if self._infinity is not None:
            # host-driven: the executor's metrics are host values already;
            # the curriculum cuts the batch and MoQ's bits of the step ride
            # along, as in JAX
            batch = self._step_extras(batch)
            try:
                metrics = self._infinity.train_batch(
                    batch, moq_bits=self._extras.get("moq_bits"))
            finally:
                self._extras = None
            self.global_steps += 1
            self.micro_steps += self.config.gradient_accumulation_steps
            return metrics
        batch = self._device_batch(batch)
        rows = batch["input_ids"].shape[0]
        if rows != self.config.train_batch_size:
            raise ValueError(f"train_batch takes a global batch of "
                             f"{self.config.train_batch_size} rows, got "
                             f"{rows}")
        batch = self._step_extras(batch)
        try:
            with self._step_context():
                grads, mean_loss = self._accum_micro_grads(batch)
                metrics = self._apply_grads(grads, mean_loss)
        finally:
            self._extras = None
        self.global_steps += 1
        self.micro_steps += self.config.gradient_accumulation_steps
        return metrics

    @torch.no_grad()
    def eval_batch(self, batch):
        """The loss of a batch of any size, without gradients (and without
        dropout). On more than one rank every rank evaluates the whole
        batch (collective at stage 3, whose layers gather)."""
        if self._infinity is not None:
            return self._infinity.eval_batch(batch)
        batch = self._device_batch(batch)
        with self._step_context():
            # JAX's eval step applies the compression transform (not MoQ)
            params, whole = self._forward_params(self.state["params"],
                                                 moq=False)
            with par_ctx.param_gather(None) if whole \
                    else contextlib.nullcontext():
                if self.plan.seq > 1:
                    # each rank its piece of every sequence, over the
                    # whole count of labels; the pieces' losses add up
                    # over seq
                    batch = self._seq_labels(batch)
                    count = (batch["labels"] != -100).sum().clamp_min(
                        1).float()
                    local = {k: self._part.slice_of(v, (None, "seq"))
                             for k, v in batch.items()}
                    loss = self.model.loss_fn(params, local,
                                              label_count=count)
                    return comm.all_reduce(loss.reshape(1).clone(),
                                           "seq")[0]
                return self.model.loss_fn(params, batch)

    # ------------------------------------------------------------------
    def get_lr(self) -> float:
        """The learning rate of the next update (the schedule at the
        applied-update count + 1, as JAX)."""
        if self._schedule is not None:
            return float(self._schedule(self.global_steps
                                        - self.skipped_steps + 1))
        if isinstance(self._base_lr, (int, float)):
            return float(self._base_lr)
        return 0.0

    @property
    def params(self):
        if self._infinity is not None:
            raise ValueError("offload_param: the layers live in the "
                             "executor's store (engine._infinity), not in "
                             "one param tree")
        return self.state["params"]

    @property
    def skipped_steps(self) -> int:
        """Steps skipped on an fp16 overflow (a read of the device
        counter; 0 without fp16)."""
        if self._infinity is not None:
            return self._infinity.skipped_steps
        if "skipped" not in self.state:
            return 0
        return int(self.state["skipped"])

    def get_loss_scale(self) -> float:
        if self._infinity is not None:
            return self._infinity._scale if self._fp16 else 1.0
        if self._fp16:
            return float(self.state["loss_scale"]["scale"])
        return 1.0

    # --- the async loop and the 3-call API ----------------------------
    def train_batches(self, data_iter, num_steps: int):
        """Consume ``num_steps`` global batches from ``data_iter``, one
        ``train_batch`` each, with at most ``pipeline.in_flight`` steps
        issued ahead of the card: before issuing further, the host waits
        on the event of step i - in_flight. With ``pipeline.prefetch`` the
        copy of batch N+1 overlaps step N (``PrefetchLoader``).
        ``pipeline.fuse_steps`` is accepted and has no effect: JAX
        compiles K steps into one program, and the eager port has no
        single-dispatch form of a step until ROADMAP S2 (CUDA graphs).
        Nothing is fetched to the host but fp16's overflow flag, read once
        a step (which leaves no step in flight under fp16); returns the
        last step's metrics."""
        pcfg = self.config.pipeline
        in_flight = max(1, int(pcfg.in_flight))
        it = itertools.islice(iter(data_iter), num_steps)
        if pcfg.prefetch:
            it = iter(PrefetchLoader(it, put_fn=self._stage_batch))
        window = collections.deque()
        metrics, done = None, 0
        for batch in it:
            metrics = self.train_batch(batch)
            done += 1
            if self.device.type == "cuda":
                issued = torch.cuda.Event()
                issued.record()
                window.append(issued)
                if len(window) > in_flight:
                    window.popleft().synchronize()
        if done < num_steps:
            logger.warning(f"train_batches: iterator exhausted after {done} "
                           f"of {num_steps} steps")
        return metrics

    def forward(self, batch):
        """Loss and grads of one micro-batch (train_micro_batch_size_per_gpu
        rows; on more than one rank, this rank's, and the loss divided by
        the label count of every rank's micro-batch together: with
        explicit labels, one all-reduce of the count; over ``seq`` the
        rank's rows are whole sequences, of which it takes its piece);
        the grads wait for ``backward``. In pipeline mode the whole
        global batch, all its micro-batches in one call, as JAX's.
        Returns the loss."""
        if self._infinity is not None:
            raise ValueError("offload_param: the layer executor steps "
                             "through train_batch (the 3-call API needs "
                             "the whole param tree)")
        n = len(self._losses)
        batch = self._device_batch(batch)
        row = count = None
        with self._step_context():
            if self._pp_mode:
                # the pipelined loss takes the whole global batch (its M
                # micro-batches) in one call, as JAX's
                self._pending = self._pipe_grads(batch)
                return self._pending[1]
            if self.plan.seq > 1:
                batch = self._seq_labels(batch)
                batch = {k: self._part.slice_of(v, (None, "seq"))
                         for k, v in batch.items()}
                local = (batch["labels"] != -100).sum().reshape(1)
                count = self._denominators(par_ctx.all_reduce(
                    local, *BATCH_AXES, "seq"))[0]
                row = self._dp_index() * batch["input_ids"].shape[0]
            elif self._part is not None:
                row = self._dp_index() * batch["input_ids"].shape[0]
                if "labels" in batch:
                    local = (batch["labels"] != -100).sum().reshape(1)
                    count = self._denominators(
                        par_ctx.all_reduce(local, *BATCH_AXES))[0]
            loss, grads = self._micro_grads(batch, micro=n, row=row,
                                            label_count=count)
        self._pending = (loss, grads)
        return loss

    def backward(self, loss=None):
        """Accumulate the pending grads (``forward`` already
        differentiated; this keeps the reference's call order), reduced
        over the ranks now unless the schedule defers them to ``step``."""
        if self._pending is None:
            raise RuntimeError("backward() called without forward()")
        if self._pp_mode:
            # reduced and averaged over the ranks already (_pipe_grads)
            grads, loss = self._pending
            self._pending = None
            self._grad_buffer, self._losses = grads, [loss]
            self.micro_steps += self.config.gradient_accumulation_steps
            return loss
        loss, grads = self._pending
        self._pending = None
        if self._part is not None and not (self._sched.deferred
                                           or self._onebit):
            with self._step_context():
                grads = self._part.reduce_grads(grads, self.state["params"])
        self._grad_buffer = self._accumulate(self._grad_buffer, grads)
        self._losses.append(loss)
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        # pipeline mode: one forward consumes all the micro-batches
        needed = (1 if self._pp_mode
                  else self.config.gradient_accumulation_steps)
        return len(self._losses) >= needed

    def step(self):
        """At the accumulation boundary, the update ``train_batch``
        applies (returns its metrics); otherwise None."""
        if not self.is_gradient_accumulation_boundary():
            return None
        grads, loss = self._grad_buffer, self._mean_loss(self._losses)
        with self._step_context():
            if self._part is not None and not self._pp_mode:
                if self._sched.deferred:
                    grads = self._part.reduce_grads(grads,
                                                    self.state["params"])
                loss = self._part.mean_over_ranks(loss)
            metrics = self._apply_grads(grads, loss)
        self._grad_buffer, self._losses = None, []
        self.global_steps += 1
        return metrics

    # --- checkpointing -------------------------------------------------
    def attach_dataloader(self, loader) -> None:
        """Register the training loader so checkpoints carry its position
        (epoch, batch in epoch, seed) and a resume neither replays nor
        skips data. Anything with state_dict / load_state_dict works
        (DataLoader and RepeatingLoader both do)."""
        self._dataloader = loader

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None,
                        save_latest: bool = True) -> str:
        """Save every leaf of ``state`` under ``save_dir/tag`` (default tag
        ``global_step{n}``). ``client_state`` gains the step counters and
        the attached loader's position. With ``checkpoint.async_save`` this
        returns once the state is copied to host memory; the write runs on
        a thread and is published at ``wait_checkpoint`` (or the next
        save). On more than one rank the save is collective: each leaf is
        gathered whole (``_whole_state``), rank 0 writes what a one-rank
        save writes, and the other ranks wait at a barrier (for an async
        save, at ``wait_checkpoint``, which is collective too). Returns
        the tag's directory."""
        tag = tag if tag is not None else f"global_step{self.global_steps}"
        client_state = dict(client_state or {})
        client_state.update({"global_steps": self.global_steps,
                             "skipped_steps": self.skipped_steps,
                             "micro_steps": self.micro_steps})
        if self._dataloader is not None and \
                hasattr(self._dataloader, "state_dict"):
            client_state.setdefault("data_position",
                                    self._dataloader.state_dict())
        ck = self.config.checkpoint
        if self._infinity is not None:
            return self._save_infinity_checkpoint(save_dir, str(tag),
                                                  client_state, save_latest)
        if self._swapper is not None:
            # the swapped state is part of the training state: written
            # before the save finalizes, so the manifest covers it
            tag_dir = os.path.join(save_dir, str(tag))
            os.makedirs(tag_dir, exist_ok=True)
            swapped = self._swap_export()
            if comm.get_rank() == 0 or self._part is None:
                np.savez(os.path.join(tag_dir, "optswap.npz"), **swapped)
        engine = None
        if ck.async_save:
            if self._ckpt_engine is None:
                self._ckpt_engine = ckpt_mod.CheckpointEngine(async_save=True)
            engine = self._ckpt_engine
        state = self.state
        if self._part is not None:
            self.wait_checkpoint()
            state = self._whole_state()
        path = os.path.join(save_dir, str(tag))
        if comm.get_rank() == 0 or self._part is None:
            path = ckpt_mod.save_checkpoint(
                save_dir, tag, state, client_state=client_state,
                config_dict=self.config.to_dict(), engine=engine,
                save_latest=save_latest, write_integrity=ck.integrity,
                checksums=ck.integrity_checksums, keep_last_k=ck.keep_last_k)
        if self._part is not None and not ck.async_save:
            comm.barrier()
        return path

    def wait_checkpoint(self) -> None:
        """Block until an in-flight async save is durable and published
        (its `latest` written). No-op without one. On more than one rank
        collective: every rank returns once rank 0's save is published."""
        if self._ckpt_engine is not None:
            self._ckpt_engine.wait()
        if self._part is not None:
            comm.barrier()

    # --- universal checkpoints: whole leaves on disk, slices in memory --
    def _leaf_spec(self, key: str, leaf: torch.Tensor):
        """(spec, stacked) of a state leaf on this mesh: a param leaf's
        param spec, a per-param optimizer leaf's optimizer spec (stacked
        over ``data`` when it is rank-varying state of the 1-bit
        compressed path, JAX's leading [dp] dim), else replicated."""
        parts = key.split("/")
        if parts[0] == "params":
            return self._part.layouts["/".join(parts[1:])].pspec, False
        lay = (self._part.layouts.get("/".join(parts[2:]))
               if parts[0] == "opt" and len(parts) > 2 else None)
        if lay is None or leaf.dim() != len(lay.shape):
            return (), False
        if self._onebit and parts[1] in self.optimizer.rank_varying:
            return ("data",), True
        return lay.ospec, False

    def _whole_shape(self, key: str, leaf: torch.Tensor):
        """The whole shape of the state leaf this rank holds ``leaf`` of."""
        spec, stacked = self._leaf_spec(key, leaf)
        if stacked:
            return (self.plan.data,) + tuple(leaf.shape)
        parts = key.split("/")
        lay = self._part.layouts.get("/".join(parts[1 if parts[0] ==
                                                    "params" else 2:]))
        return lay.shape if spec else tuple(leaf.shape)

    def _local_of(self, key: str, whole, leaf=None):
        """This rank's slice of a whole state leaf (array or tensor);
        ``leaf``: this rank's current one (default: ``whole`` is laid out
        as a one-rank engine's)."""
        spec, stacked = self._leaf_spec(
            key, leaf if leaf is not None else whole)
        if stacked:
            return whole[self.mesh.index("data")]
        return self._part.slice_of(whole, spec)

    def _whole_state(self):
        """The state with every leaf gathered whole, as a one-rank engine
        holds it (collective; the whole leaves are kept on rank 0 only, in
        host memory)."""
        rank0 = comm.get_rank() == 0
        out = {}
        for key, leaf in ckpt_mod.flatten(self.state).items():
            if isinstance(leaf, torch.Tensor):
                spec, stacked = self._leaf_spec(key, leaf)
                whole = self._part.whole(
                    leaf.detach()[None] if stacked else leaf.detach(),
                    ("data",) if stacked else spec)
                leaf = whole.cpu() if rank0 else None
            if leaf is not None:
                _set_leaf(out, key, leaf, make=True)
        return out

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True):
        """Restore every leaf of ``state`` in place, the step counters and
        the attached loader's position. An explicit tag is honoured
        verbatim; tag=None validates `latest` and walks back to the newest
        valid tag. ``load_optimizer_states=False`` keeps this engine's
        optimizer state (masters included), as JAX does. The schedule is
        a function of ``global_steps``, so it always continues where the
        save stopped. Returns (load_dir, client_state)."""
        self.wait_checkpoint()
        if self._infinity is not None:
            return ckpt_mod.load_with_walk_back(
                load_dir, tag,
                lambda t: self._load_infinity_checkpoint(load_dir, t))
        return ckpt_mod.load_with_walk_back(
            load_dir, tag,
            lambda t: self._load_resolved(load_dir, t, load_optimizer_states))

    def _save_infinity_checkpoint(self, save_dir, tag, client_state,
                                  save_latest):
        """The executor's chunks copied into the tag, its small state (the
        embedding / head params and optimizer state) as
        ``infinity_small.npz`` with a dtype manifest
        (``infinity_meta.json``: bf16 as uint16 bits), then the integrity
        chain. Over ranks the chunks' save is collective (each gathered
        whole) and rank 0 writes the rest while the others wait."""
        from deepspeed_tpu_torch.robustness import integrity
        path = os.path.join(save_dir, tag)
        rank0 = comm.get_rank() == 0 or self.plan.world_size == 1
        if rank0:
            os.makedirs(path, exist_ok=True)
            integrity.invalidate(path)
        if self.plan.world_size > 1:
            comm.barrier()
        small = self._infinity.save_checkpoint(path)
        if not rank0:
            comm.barrier()
            return path
        client_state["applied_steps"] = small.pop("applied_steps")
        if "loss_scale" in small:
            client_state["loss_scale"] = small.pop("loss_scale")
        flat = ckpt_mod.flatten({"nl_params": small["nl_params"],
                                 "nl_opt": small["nl_opt"]})
        dtypes = {k: ckpt_mod.dtype_name(v.dtype) for k, v in flat.items()}
        np.savez(os.path.join(path, "infinity_small.npz"),
                 **{k.replace("/", "__"): ckpt_mod.to_numpy_bits(v)
                    for k, v in flat.items()})
        integrity.atomic_write(
            os.path.join(path, "infinity_meta.json"),
            json.dumps({"schema": ckpt_mod.META_SCHEMA, "dtypes": dtypes,
                        "client_state": client_state}, default=str),
            what="infinity meta write")
        ck = self.config.checkpoint
        ckpt_mod.finalize_tag(save_dir, tag, save_latest=save_latest,
                              write_integrity=ck.integrity,
                              checksums=ck.integrity_checksums,
                              keep_last_k=ck.keep_last_k)
        if self.plan.world_size > 1:
            comm.barrier()
        return path

    def _load_infinity_checkpoint(self, load_dir, tag):
        path = os.path.join(load_dir, str(tag))
        with open(os.path.join(path, "infinity_meta.json")) as f:
            meta = json.load(f)
        small = {}
        with np.load(os.path.join(path, "infinity_small.npz")) as z:
            for k in z.files:
                key = k.replace("__", "/")
                _set_leaf(small, key, ckpt_mod.from_numpy_bits(
                    z[k], meta["dtypes"][key]), make=True)
        cs = meta["client_state"]
        small["applied_steps"] = cs.get("applied_steps", 0)
        if "loss_scale" in cs:
            small["loss_scale"] = cs["loss_scale"]
        self._infinity.load_checkpoint(path, small)
        self._infinity.skipped_steps = int(cs.get("skipped_steps", 0))
        self.global_steps = int(cs.get("global_steps", 0))
        self.micro_steps = int(cs.get("micro_steps", 0))
        if self._dataloader is not None and "data_position" in cs \
                and hasattr(self._dataloader, "load_state_dict"):
            self._dataloader.load_state_dict(cs["data_position"])
        return load_dir, cs

    def _load_resolved(self, load_dir: str, tag: str,
                       load_optimizer_states: bool):
        """Load one resolved tag. Everything is checked before the first
        leaf is written, so a tag that fails leaves the engine as it was
        (and the walk-back can try the next)."""
        ckpt_path = os.path.join(load_dir, tag)
        sharded = self._part is not None
        arrays, dtypes = ckpt_mod.read_payload(
            os.path.join(ckpt_path, "state"), mmap=sharded)
        client_state = ckpt_mod.read_meta(ckpt_path).get("client_state", {})
        saved = {k: (arrays[k], dtypes[k]) for k in arrays}
        have = ckpt_mod.flatten(self.state)
        if not load_optimizer_states:
            saved = {k: v for k, v in saved.items() if not k.startswith("opt/")}
            have = {k: v for k, v in have.items() if not k.startswith("opt/")}
        want = have if not sharded else {
            k: ((_Shape(self._whole_shape(k, v)), ckpt_mod.dtype_name(v.dtype))
                if isinstance(v, torch.Tensor) else v)
            for k, v in have.items()}
        _check_structure(saved, want, f"checkpoint {ckpt_path}")
        with torch.no_grad():
            for name, leaf in have.items():
                arr = arrays[name]
                if sharded and isinstance(leaf, torch.Tensor):
                    arr = self._local_of(name, arr, leaf)
                src = ckpt_mod.from_numpy_bits(arr, dtypes[name])
                if isinstance(leaf, torch.Tensor):
                    leaf.copy_(src)
                else:
                    _set_leaf(self.state, name, int(src))
        if self._swapper is not None and load_optimizer_states:
            with np.load(os.path.join(ckpt_path, "optswap.npz")) as z:
                self._swap_import({k: z[k] for k in z.files})
        if self._onebit:
            self._onebit_applied = self.state["opt"]["step"]
        self.global_steps = int(client_state.get("global_steps", 0))
        self.micro_steps = int(client_state.get("micro_steps", 0))
        self._pending, self._grad_buffer, self._losses = None, None, []
        if self._dataloader is not None and "data_position" in client_state \
                and hasattr(self._dataloader, "load_state_dict"):
            self._dataloader.load_state_dict(client_state["data_position"])
        logger.info(f"loaded checkpoint {ckpt_path}")
        return load_dir, client_state

    def save_16bit_model(self, save_dir: str,
                         name: str = "model_fp16.ckpt") -> str:
        """The params in the compute dtype as one ``.npz`` of JAX's
        flattened names; bf16 leaves stored as their uint16 bits, with a
        ``.dtypes.json`` manifest beside (JAX's ``save_16bit_model``
        format: each package reads the other's). On more than one rank
        collective: the params gathered whole, rank 0 writes. Returns the
        path."""
        path = os.path.join(save_dir, name)
        if not path.endswith(".npz"):
            path += ".npz"
        params = ckpt_mod.flatten(self.params)
        if self._part is not None:
            with par_ctx.parallel_context(self.mesh):
                params = {k: self._part.whole(
                    t.detach(), self._part.layouts[k].pspec)
                    for k, t in params.items()}
            if comm.get_rank() != 0:
                comm.barrier()
                return path
        os.makedirs(save_dir, exist_ok=True)
        arrays, dtypes = {}, {}
        for key, t in params.items():
            t = t.detach().cpu()
            dtypes[key] = ckpt_mod.dtype_name(t.dtype)
            arrays[key] = ckpt_mod.to_numpy_bits(t)
        np.savez(path, **arrays)
        with open(path + ".dtypes.json", "w") as f:
            json.dump(dtypes, f)
        if self._part is not None:
            comm.barrier()
        return path


def load_16bit_model(path: str) -> Dict[str, torch.Tensor]:
    """A ``save_16bit_model`` export (of either package) as {name: CPU
    tensor}; bf16 leaves come back as bf16, bit for bit."""
    if not path.endswith(".npz"):
        path += ".npz"
    dtypes = {}
    if os.path.exists(path + ".dtypes.json"):
        with open(path + ".dtypes.json") as f:
            dtypes = json.load(f)
    with np.load(path, allow_pickle=False) as z:
        return {k: ckpt_mod.from_numpy_bits(z[k], dtypes.get(k, ""))
                for k in z.files}


def _check_structure(got: Dict[str, Any], want: Dict[str, Any],
                     what: str) -> None:
    """Raise ValueError unless ``got`` has exactly ``want``'s leaves with
    the same shapes and dtypes. Leaves are tensors, host ints or
    (array, dtype name) pairs."""

    def sig(v):
        if isinstance(v, tuple):
            arr, dt = v
            return tuple(arr.shape), dt
        if isinstance(v, torch.Tensor):
            return tuple(v.shape), ckpt_mod.dtype_name(v.dtype)
        return (), "int"

    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{what} lacks leaves {missing[:8]} and has "
                         f"leaves this engine lacks {extra[:8]}")
    bad = []
    for name, leaf in want.items():
        (gs, gd), (ws, wd) = sig(got[name]), sig(leaf)
        if wd == "int":
            ok = gs in ((), (1,)) and "int" in gd
        else:
            ok = (gs, gd) == (ws, wd)
        if not ok:
            bad.append(f"{name}: {gs} {gd}, want {ws} {wd}")
    if bad:
        raise ValueError(f"{what} does not match this engine's state: "
                         + "; ".join(bad[:8]))


def _set_leaf(tree, name: str, value, make: bool = False) -> None:
    *parents, last = name.split("/")
    for p in parents:
        tree = tree.setdefault(p, {}) if make else tree[p]
    tree[last] = value


class _Shape:
    """A shape standing in for a leaf where only its shape is read."""

    def __init__(self, shape):
        self.shape = tuple(shape)

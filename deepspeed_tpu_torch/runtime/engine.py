"""The training engine on one device, a port of the main path of
``deepspeed_tpu/runtime/engine.py``: ``initialize`` -> ``Engine`` ->
``train_batch`` / ``train_batches`` / ``forward``-``backward``-``step``,
with checkpoints a run can resume from.

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
  memory on a side stream while step N runs), and the 3-call
  ``forward`` / ``backward`` / ``step`` API (grads buffered until the
  accumulation boundary, the update ``train_batch`` applies);
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

Runs on the card: ``device=None`` means "cuda" and raises without CUDA;
``device="cpu"`` runs the plain PyTorch versions of the kernels. What the
slice leaves out raises ``NotImplementedError`` naming its ROADMAP item:
more than one rank, meshes and model-parallel groups (A4), and the config
sections ``config/config.py`` lists.
"""

import collections
import dataclasses
import itertools
import json
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                state_from_numpy)
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    check_trainable,
                                                    make_model, mask_seed)
from deepspeed_tpu_torch.ops.optimizers import (Optimizer, cast_tree,
                                                global_grad_norm, tree_leaves,
                                                tree_map)
from deepspeed_tpu_torch.ops.registry import get_optimizer_builder
from deepspeed_tpu_torch.runtime import checkpointing as ckpt_mod
from deepspeed_tpu_torch.runtime import fp16 as fp16_mod
from deepspeed_tpu_torch.runtime import zero as zero_mod
from deepspeed_tpu_torch.runtime.dataloader import DataLoader, PrefetchLoader
from deepspeed_tpu_torch.runtime.lr_schedules import get_scheduler

logger = logging.getLogger("deepspeed_tpu_torch")


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


def initialize(args=None, model=None, config=None, config_params=None,
               optimizer=None, lr_scheduler=None, params=None, state=None,
               device=None, training_data=None, **kwargs):
    """Build an Engine. ``model``: a ModelSpec (``models.make_model``);
    ``config``: a dict, a JSON path or a Config; ``params``: a JAX-layout
    tree (numpy arrays) instead of the seeded init; ``state``: the JAX
    engine's whole training state as numpy (``models.state_from_numpy``)
    to continue from; ``training_data``: an indexable dataset of rows,
    batched by a ``DataLoader`` of ``train_batch_size`` rows that is
    attached (checkpoints carry its position). Returns (engine, optimizer,
    dataloader, lr_scheduler); dataloader is None without
    training_data."""
    cfg = Config.load(config if config is not None else config_params)
    if args is not None and getattr(args, "deepspeed_config", None):
        cfg = Config.load(args.deepspeed_config)
    for key in ("mesh", "mpu"):
        if kwargs.get(key) is not None:
            _not_ported(f"initialize({key}=...)",
                        "A4 (meshes, model-parallel groups)")
    engine = Engine(model=model, config=cfg, optimizer=optimizer,
                    lr_scheduler=lr_scheduler, params=params, state=state,
                    device=device)
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
                 params=None, state=None, device=None):
        self.device = resolve_device(device)
        self.config = config
        zero_mod.check_single_device(config.zero_optimization.stage)
        config.resolve_batch_size(1)

        # the `transformer` section rebuilds the model config, as in JAX
        if config.transformer.fused_backward:
            if isinstance(getattr(model, "config", None), TransformerConfig):
                model = make_model(dataclasses.replace(
                    model.config, fused_backward=True), name=model.name)
            else:
                logger.warning("`transformer` config section ignored: model "
                               "is not a transformer ModelSpec")
        self.model = model
        if isinstance(getattr(model, "config", None), TransformerConfig):
            check_trainable(model.config)

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

        if state is None:
            self.state = self._init_state(params)
        else:
            self.state = self._adopt_state(state)
        # train_batch calls, as JAX counts them (skipped steps included;
        # state["step"] is the applied-update count)
        self.global_steps = self.state["step"] + self.skipped_steps
        self.micro_steps = (self.global_steps
                            * config.gradient_accumulation_steps)
        self._dataloader = None
        self._ckpt_engine = None
        self._copy_stream = None
        # 3-call API: grads and losses buffered until the boundary
        self._pending = None
        self._grad_buffer = None
        self._losses = []

    # ------------------------------------------------------------------
    def _init_state(self, params):
        """f32 params -> optimizer state (masters copied from them) ->
        params in the compute dtype, each an autograd leaf."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.config.seed)
            params32 = self.model.init(gen, self.device, dtype=torch.float32)
        else:
            params32 = params_from_numpy(params, self.model.config,
                                         device=self.device,
                                         dtype=torch.float32)
        opt_state = self.optimizer.init(params32)
        params = cast_tree(params32, self.compute_dtype)
        del params32
        for p in tree_leaves(params):
            p.requires_grad_(True)
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

    def _adopt_state(self, state):
        """A JAX training state (numpy) as this engine's, checked against
        the structure this engine's optimizer builds."""
        adopted = state_from_numpy(state, self.model.config,
                                   device=self.device,
                                   compute_dtype=self.compute_dtype)
        meta = tree_map(lambda p: torch.empty_like(p, device="meta"),
                        adopted["params"])
        want = {"params": meta, "opt": self.optimizer.init(meta), "step": 0,
                **self._fp16_state()}
        _check_structure(ckpt_mod.flatten(adopted), ckpt_mod.flatten(want),
                         "state")
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
        """The loss function's dropout seed for micro-batch ``micro`` of
        this step, for a model with ``dropout_rate > 0`` (else nothing):
        fixed by (config seed, step, micro-batch), so a replayed layer, a
        repeated run and a resumed one draw the same masks."""
        if not getattr(getattr(self.model, "config", None), "dropout_rate",
                       0.0):
            return {}
        return {"dropout_seed": mask_seed(self.config.seed,
                                          self.global_steps, micro)}

    def _micro_grads(self, mb, micro: int = 0):
        """(loss, f32 grads as a list over the param leaves) of one
        micro-batch; under fp16 the grads are those of the scaled loss
        (the loss itself comes back unscaled)."""
        leaves = tree_leaves(self.state["params"])
        loss = self.model.loss_fn(self.state["params"], mb,
                                  **self._dropout_kw(micro))
        target = loss
        if self._fp16:
            target = fp16_mod.scale_loss(
                loss, fp16_mod.LossScaleState(**self.state["loss_scale"]))
        grads = torch.autograd.grad(target, leaves, materialize_grads=True)
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

    def _accum_micro_grads(self, batch):
        """Grads averaged over ``gas`` micro-batches and the mean loss."""
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

    @torch.no_grad()
    def _apply_grads(self, grads, mean_loss):
        """JAX's ``apply_grads``: under fp16 unscale and the overflow
        check, then the global norm, clipping, the optimizer update (in
        place, masters written back into the params) unless the step
        overflowed, and the scaler's update."""
        ls = None
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        if self._fp16:
            ls = fp16_mod.LossScaleState(**self.state["loss_scale"])
            grads = fp16_mod.unscale_grads(grads, ls)
            overflow = fp16_mod.has_overflow(grads)
        gnorm = global_grad_norm(grads)
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            scale = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale)
        # fp16: the one host sync a step (the update below writes in place)
        if not (self._fp16 and bool(overflow)):
            params = self.state["params"]
            it = iter(grads)
            grad_tree = tree_map(lambda _: next(it), params)
            self.optimizer.update(grad_tree, self.state["opt"], params)
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

    def train_batch(self, batch) -> Dict[str, Any]:
        """One global batch (train_batch_size rows) -> one optimizer step.
        Returns {"loss", "grad_norm", "overflow"} (and "loss_scale" under
        fp16) as 0-dim device tensors. Nothing is fetched to the host,
        except under fp16 the overflow flag: one read a step, before the
        in-place update."""
        batch = self._device_batch(batch)
        rows = batch["input_ids"].shape[0]
        if rows != self.config.train_batch_size:
            raise ValueError(f"train_batch takes a global batch of "
                             f"{self.config.train_batch_size} rows, got "
                             f"{rows}")
        grads, mean_loss = self._accum_micro_grads(batch)
        metrics = self._apply_grads(grads, mean_loss)
        self.global_steps += 1
        self.micro_steps += self.config.gradient_accumulation_steps
        return metrics

    @torch.no_grad()
    def eval_batch(self, batch):
        """The loss of a batch of any size, without gradients (and without
        dropout)."""
        return self.model.loss_fn(self.state["params"],
                                  self._device_batch(batch))

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
        return self.state["params"]

    @property
    def skipped_steps(self) -> int:
        """Steps skipped on an fp16 overflow (a read of the device
        counter; 0 without fp16)."""
        if "skipped" not in self.state:
            return 0
        return int(self.state["skipped"])

    def get_loss_scale(self) -> float:
        if self._fp16:
            return float(self.state["loss_scale"]["scale"])
        return 1.0

    # --- the async loop and the 3-call API ----------------------------
    def train_batches(self, data_iter, num_steps: int):
        """Consume ``num_steps`` global batches from ``data_iter``, one
        ``train_batch`` each, with at most ``pipeline.in_flight`` steps
        issued ahead of the card: before issuing further, the host waits
        on the event of step i - in_flight. With ``pipeline.prefetch`` the
        copy of batch N+1 overlaps step N (``PrefetchLoader``). Nothing is
        fetched to the host but fp16's overflow flag, read once a step
        (which leaves no step in flight under fp16); returns the last
        step's metrics."""
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
        rows); the grads wait for ``backward``. Returns the loss."""
        loss, grads = self._micro_grads(self._device_batch(batch),
                                        micro=len(self._losses))
        self._pending = (loss, grads)
        return loss

    def backward(self, loss=None):
        """Accumulate the pending grads (``forward`` already
        differentiated; this keeps the reference's call order)."""
        if self._pending is None:
            raise RuntimeError("backward() called without forward()")
        loss, grads = self._pending
        self._pending = None
        self._grad_buffer = self._accumulate(self._grad_buffer, grads)
        self._losses.append(loss)
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return len(self._losses) >= self.config.gradient_accumulation_steps

    def step(self):
        """At the accumulation boundary, the update ``train_batch``
        applies (returns its metrics); otherwise None."""
        if not self.is_gradient_accumulation_boundary():
            return None
        metrics = self._apply_grads(self._grad_buffer,
                                    self._mean_loss(self._losses))
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
        save). Returns the tag's directory."""
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
        engine = None
        if ck.async_save:
            if self._ckpt_engine is None:
                self._ckpt_engine = ckpt_mod.CheckpointEngine(async_save=True)
            engine = self._ckpt_engine
        return ckpt_mod.save_checkpoint(
            save_dir, tag, self.state, client_state=client_state,
            config_dict=self.config.to_dict(), engine=engine,
            save_latest=save_latest, write_integrity=ck.integrity,
            checksums=ck.integrity_checksums, keep_last_k=ck.keep_last_k)

    def wait_checkpoint(self) -> None:
        """Block until an in-flight async save is durable and published
        (its `latest` written). No-op without one."""
        if self._ckpt_engine is not None:
            self._ckpt_engine.wait()

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
        return ckpt_mod.load_with_walk_back(
            load_dir, tag,
            lambda t: self._load_resolved(load_dir, t, load_optimizer_states))

    def _load_resolved(self, load_dir: str, tag: str,
                       load_optimizer_states: bool):
        """Load one resolved tag. Everything is checked before the first
        leaf is written, so a tag that fails leaves the engine as it was
        (and the walk-back can try the next)."""
        ckpt_path = os.path.join(load_dir, tag)
        arrays, dtypes = ckpt_mod.read_payload(
            os.path.join(ckpt_path, "state"))
        client_state = ckpt_mod.read_meta(ckpt_path).get("client_state", {})
        saved = {k: (arrays[k], dtypes[k]) for k in arrays}
        have = ckpt_mod.flatten(self.state)
        if not load_optimizer_states:
            saved = {k: v for k, v in saved.items() if not k.startswith("opt/")}
            have = {k: v for k, v in have.items() if not k.startswith("opt/")}
        _check_structure(saved, have, f"checkpoint {ckpt_path}")
        with torch.no_grad():
            for name, leaf in have.items():
                src = ckpt_mod.from_numpy_bits(arrays[name], dtypes[name])
                if isinstance(leaf, torch.Tensor):
                    leaf.copy_(src)
                else:
                    _set_leaf(self.state, name, int(src))
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
        format: each package reads the other's). Returns the path."""
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, name)
        if not path.endswith(".npz"):
            path += ".npz"
        arrays, dtypes = {}, {}
        for key, t in ckpt_mod.flatten(self.state["params"]).items():
            t = t.detach().cpu()
            dtypes[key] = ckpt_mod.dtype_name(t.dtype)
            arrays[key] = ckpt_mod.to_numpy_bits(t)
        np.savez(path, **arrays)
        with open(path + ".dtypes.json", "w") as f:
            json.dump(dtypes, f)
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


def _set_leaf(tree, name: str, value) -> None:
    *parents, last = name.split("/")
    for p in parents:
        tree = tree[p]
    tree[last] = value

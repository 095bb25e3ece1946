"""The training engine on one device, a port of the main path of
``deepspeed_tpu/runtime/engine.py``: ``initialize`` -> ``Engine`` ->
``train_batch``.

What it runs, in the JAX engine's order:

- ``_init_state``: f32 params from the model's seeded init (or a JAX tree
  given as ``params=``), the optimizer state built on them (f32 masters
  when the compute dtype is not f32), then the params cast to the compute
  dtype;
- ``_accum_micro_grads``: ``gradient_accumulation_steps`` micro-batches,
  the 1/gas mean folded into the accumulate;
- ``micro_grads`` / ``apply_grads`` / ``batch_grads``: grads cast to f32,
  the global norm, clipping, the optimizer update and the write-back of
  the updated masters into the params;
- ``train_batch``, ``eval_batch``, ``get_lr``, ``global_steps``,
  ``params``.

JAX compiles the step into one program and never fetches a metric per
step; here the step is eager PyTorch and ``train_batch`` returns its
metrics as 0-dim device tensors, again without a host fetch.

Runs on the card: ``device=None`` means "cuda" and raises without CUDA;
``device="cpu"`` runs the plain PyTorch versions of the kernels. What the
slice leaves out raises ``NotImplementedError`` naming its ROADMAP item:
``train_batches``, the 3-call forward/backward/step API and the data
loader (A4), checkpointing (A5), more than one rank (A4), and the config
sections ``config/config.py`` lists.
"""

import dataclasses
import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    make_model)
from deepspeed_tpu_torch.ops.optimizers import (Optimizer, cast_tree,
                                                global_grad_norm, tree_leaves,
                                                tree_map)
from deepspeed_tpu_torch.ops.registry import get_optimizer_builder
from deepspeed_tpu_torch.runtime import zero as zero_mod
from deepspeed_tpu_torch.runtime.lr_schedules import get_scheduler

logger = logging.getLogger("deepspeed_tpu_torch")


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


def initialize(args=None, model=None, config=None, config_params=None,
               optimizer=None, lr_scheduler=None, params=None, device=None,
               **kwargs):
    """Build an Engine. ``model``: a ModelSpec (``models.make_model``);
    ``config``: a dict, a JSON path or a Config; ``params``: a JAX-layout
    tree (numpy arrays) instead of the seeded init. Returns (engine,
    optimizer, dataloader, lr_scheduler), the dataloader always None."""
    cfg = Config.load(config if config is not None else config_params)
    if args is not None and getattr(args, "deepspeed_config", None):
        cfg = Config.load(args.deepspeed_config)
    for key in ("training_data", "mesh", "mpu"):
        if kwargs.get(key) is not None:
            _not_ported(f"initialize({key}=...)",
                        "A4 (data loader, meshes, model-parallel groups)")
    engine = Engine(model=model, config=cfg, optimizer=optimizer,
                    lr_scheduler=lr_scheduler, params=params, device=device)
    return engine, engine.optimizer, None, engine.lr_scheduler


class Engine:
    def __init__(self, model, config: Config,
                 optimizer: Optional[Optimizer] = None, lr_scheduler=None,
                 params=None, device=None):
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

        self.compute_dtype = config.compute_dtype
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

        self.state = self._init_state(params)
        self.global_steps = 0
        self.micro_steps = 0

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
        return {"params": params, "opt": opt_state, "step": 0}

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    def _micro_grads(self, mb):
        """(loss, f32 grads as a list over the param leaves) of one
        micro-batch."""
        leaves = tree_leaves(self.state["params"])
        loss = self.model.loss_fn(self.state["params"], mb)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), [g.float() for g in grads]

    def _accum_micro_grads(self, batch):
        """Grads averaged over ``gas`` micro-batches (1/gas folded into the
        accumulate) and the mean loss."""
        gas = self.config.gradient_accumulation_steps
        if gas == 1:
            loss, grads = self._micro_grads(batch)
            return grads, loss
        mbs = {k: v.reshape((gas, v.shape[0] // gas) + v.shape[1:])
               for k, v in batch.items()}
        inv_gas = float(np.float32(1.0 / gas))
        acc, losses = None, []
        for i in range(gas):
            loss, grads = self._micro_grads({k: v[i] for k, v in mbs.items()})
            if acc is None:
                acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(acc, grads):
                a.add_(g * inv_gas)
            losses.append(loss)
        return acc, torch.stack(losses).mean()

    @torch.no_grad()
    def _apply_grads(self, grads, mean_loss):
        """Global norm, clipping, the optimizer update (in place, masters
        written back into the params)."""
        gnorm = global_grad_norm(grads)
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            scale = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale)
        params = self.state["params"]
        it = iter(grads)
        grad_tree = tree_map(lambda _: next(it), params)
        self.optimizer.update(grad_tree, self.state["opt"], params)
        self.state["step"] += 1
        return {"loss": mean_loss, "grad_norm": gnorm,
                "overflow": torch.zeros((), dtype=torch.bool,
                                        device=self.device)}

    def train_batch(self, batch) -> Dict[str, Any]:
        """One global batch (train_batch_size rows) -> one optimizer step.
        Returns {"loss", "grad_norm", "overflow"} as 0-dim device tensors
        (nothing is fetched to the host)."""
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
        """The loss of a batch of any size, without gradients."""
        return self.model.loss_fn(self.state["params"],
                                  self._device_batch(batch))

    # ------------------------------------------------------------------
    def get_lr(self) -> float:
        """The learning rate of the next update (the schedule at the
        applied-update count + 1, as JAX)."""
        if self._schedule is not None:
            return float(self._schedule(self.global_steps + 1))
        if isinstance(self._base_lr, (int, float)):
            return float(self._base_lr)
        return 0.0

    @property
    def params(self):
        return self.state["params"]

    # --- outside this slice -------------------------------------------
    def train_batches(self, data_iter, num_steps: int):
        _not_ported("Engine.train_batches", "A4 (async multi-step loop)")

    def forward(self, batch):
        _not_ported("the 3-call forward/backward/step API",
                    "A4 (use train_batch)")

    def backward(self, loss=None):
        _not_ported("the 3-call forward/backward/step API",
                    "A4 (use train_batch)")

    def step(self):
        _not_ported("the 3-call forward/backward/step API",
                    "A4 (use train_batch)")

    def save_checkpoint(self, *args, **kwargs):
        _not_ported("checkpointing", "A5")

    def load_checkpoint(self, *args, **kwargs):
        _not_ported("checkpointing", "A5")

"""The transformer under the pipeline schedules, a port of
``deepspeed_tpu/models/pipeline_wrapper.py``.

``make_pipelined_model`` rewires a transformer ``ModelSpec`` so that its
layer stack runs over the ``pipe`` axis: each rank holds its stage's
layers (the stacked leaves' slice) and the leaves outside the stack
whole.

- training (``loss_fn`` with gradients on): ``parallel/pipeline.
  make_pipeline_1f1b``, loss and grads from one interleaved tick loop,
  handed to autograd through ``as_loss_fn``;
- eval (``loss_fn`` without gradients): the same schedule's forward
  ticks;
- ``apply``: the GPipe forward (``pipeline_spmd``), the logits on every
  rank.

Stage 0 embeds, the last stage runs the final norm, the head and the CE
(a micro-batch's mean, over ``label_count[i]`` when the engine gives the
micro-batches' denominators). The dropout masks of micro-batch i and
model layer g come from ``mask_seed(micro_seeds[i], g)``, the seeds the
non-pipelined engine gives its i-th micro-batch's layer g, so the
1F1B backward's recompute redraws them and a pipelined run drops what a
one-stage run drops (JAX salts its masks by (micro-batch, layer) for the
same reason). A MoE model's layers accumulate their aux losses per
stage; they ride the backward seeds with weight
``moe_aux_loss_weight / M``. ZeRO-3: each layer gathers its weights
inside the stage (and again in the recompute), the embedding and the
head where they run.
"""

import dataclasses
from typing import Optional, Sequence

import torch

from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.parallel.context import axis_index, gather_params
from deepspeed_tpu_torch.parallel.pipeline import (as_loss_fn,
                                                   make_pipeline_1f1b,
                                                   pipeline_spmd)


def make_pipelined_model(cfg: T.TransformerConfig, mesh,
                         num_microbatches: int, name: str = "pipelined",
                         pipe_axis: str = "pipe") -> T.ModelSpec:
    """The ModelSpec of ``cfg`` over ``mesh``'s ``pipe`` axis with
    ``num_microbatches`` micro-batches a batch (module note). Its
    ``loss_fn(params, batch, label_count=None, train=False,
    micro_seeds=None)``: ``label_count`` [M] the micro-batches' CE
    denominators, ``micro_seeds`` their dropout seeds (None: no
    dropout)."""
    n_stages = mesh.size(pipe_axis)
    M = num_microbatches
    if cfg.num_layers % n_stages:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                         f"pipeline stages={n_stages}")
    aux_w = cfg.moe_aux_loss_weight if cfg.num_experts > 1 else 0.0

    def split(params):
        return (params["layers"],
                {k: v for k, v in params.items() if k != "layers"})

    def embed_fn(other, tokens):
        return T._embed(gather_params(other), tokens, cfg)

    def make_stage_fn(mask_mb, seeds, train):
        def stage_fn(stage, x, mb_idx):
            n_local = next(iter(stage.values())).shape[0]
            B, S = x.shape[:2]
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
            aux: list = []
            y, _ = T.layer_stack(
                x, stage, cfg, positions=positions,
                attention_mask=None if mask_mb is None else mask_mb[mb_idx],
                dropout_seed=None if seeds is None else seeds[mb_idx],
                train=train, aux=aux,
                first_layer=axis_index(pipe_axis) * n_local)
            total = (torch.stack(aux).sum() if aux
                     else x.new_zeros((), dtype=torch.float32))
            return y, total
        return stage_fn

    def loss_fn(params, batch, dropout_seed=None, label_count=None,
                train: bool = False,
                micro_seeds: Optional[Sequence[int]] = None):
        del dropout_seed            # the pipeline takes micro_seeds
        ids = batch["input_ids"]
        B, S = ids.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        mb = B // M
        tokens = ids.reshape(M, mb, S)
        labels = T.lm_labels(batch).reshape(M, mb, S)
        mask = batch.get("attention_mask")
        mask_mb = None if mask is None else mask.reshape(M, mb, S)

        def head_loss_fn(other, y, mb_idx):
            other = gather_params(other)
            y = T._norm(y, other["final_norm_scale"],
                        other.get("final_norm_bias"), cfg)
            count = None if label_count is None else label_count[mb_idx]
            return T.head_loss(other, y, labels[mb_idx], cfg, count)

        stage, other = split(params)
        run = make_pipeline_1f1b(
            embed_fn, make_stage_fn(mask_mb, micro_seeds, train),
            head_loss_fn, mesh, num_microbatches=M,
            act_shape=(mb, S, cfg.hidden_size), act_dtype=cfg.dtype,
            aux_weight=aux_w, pipe_axis=pipe_axis)
        if not torch.is_grad_enabled():
            return run(stage, other, tokens, grads=False)[0]
        names = list(stage) + list(other)
        leaves = [stage[n] for n in stage] + [other[n] for n in other]

        def schedule():
            loss, ds, do = run(stage, other, tokens)
            grads = {**ds, **do}
            return loss, [grads[n] for n in names]
        return as_loss_fn(schedule, leaves)

    def forward(params, input_ids, attention_mask=None, **kw):
        B, S = input_ids.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        stage, other = split(params)
        with torch.no_grad():
            x = embed_fn(other, input_ids)
            mask_mb = (None if attention_mask is None
                       else attention_mask.reshape(M, B // M, S))
            stage_fn = make_stage_fn(mask_mb, None, False)
            y = pipeline_spmd(lambda h, i: stage_fn(stage, h, i)[0], mesh,
                              num_microbatches=M, pipe_axis=pipe_axis)(
                x.reshape((M, B // M) + x.shape[1:]))
            og = gather_params(other)
            y = T._norm(y.reshape(x.shape), og["final_norm_scale"],
                        og.get("final_norm_bias"), cfg)
            return T.lm_head_logits(y, og, cfg.vocab_size)

    return dataclasses.replace(T.make_model(cfg, name=name),
                               loss_fn=loss_fn, apply=forward)

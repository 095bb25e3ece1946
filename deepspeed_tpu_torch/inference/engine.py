"""Inference engine, PyTorch port of ``deepspeed_tpu/inference/engine.py``
(the part the serving path and one-shot generation use): one device, the
params cast to the engine's dtype, and the decode GEMMs fused (wqkv,
w_in_gate) as the JAX engine fuses float weights at tp=1.
``generate`` decodes one batch in lockstep on the contiguous KV cache
(``inference/generation.py``); ``forward`` returns full-sequence logits.

Quantized inference, as JAX resolves it: ``kv_cache_bits`` (None: 8 when
the declared context budget ``max_tokens`` is >= 1024, else 0) selects
the int8 KV cache and pools; ``quantize_bits=8`` stores the layer stack
int8 and dequantizes one layer at a time, ``weight_bits=8`` keeps it int8
through the matmul (the scale in the epilogue). Both quantize after the
cast to the engine's dtype, and both turn the GEMM fusion off, as JAX's
default does.

Tensor and expert parallelism (``tensor_parallel`` / ``expert_parallel``,
or ``mesh=``: a ``parallel.MeshPlan`` or a built ``parallel.Mesh``): the
engine runs on every rank of a ``torch.distributed`` group of
``tensor x expert`` processes, each holding the slice of every leaf that
JAX's rules give its device (``models/convert.param_specs``; the seeded
init keeps each leaf's slice as soon as it is drawn), and the model's
collectives run over the mesh. The validations are JAX's: an explicit
mesh is authoritative (a contradicting degree raises, naming the axis),
``expert_parallel > 1`` needs a MoE model whose ``num_experts`` it
divides, a dense model on an expert mesh serves at ep = 1 (every rank a
full replica), the tensor degree must divide ``kv_heads``, and the GEMM
fusion is off at tp > 1 (the concat would interleave head shards).
``forward`` and ``generate`` are collective then: every rank calls them
with the same inputs (the serving engine drives its ranks itself). A
model family (biases, learned positions, ALiBi at the rank's head
offset, a vocab-sharded head bias) and a block-sparse model (B5 on the
rank's head shard, the layout shared by every head as JAX's) serve on
any of these meshes.

On a ``data`` (and ``fsdp``) mesh, as JAX's engine shards a batch over
``data`` when the data degree divides it (``_batch_spec``): ``forward``
and ``generate`` give each data rank its contiguous rows, every rank
returns the whole output (an ``all_gather`` over ``data``), and a batch
the degree does not divide is replicated (every rank computes all of
it). ``fsdp`` holds no serving shard (the serving rules are JAX's
``make_rules(0)``): its ranks replicate. Sampled decode draws each rank's
rows from that rank's ``rng``.

``init_inference`` runs on the card: ``device=None`` means "cuda" and
raises when CUDA is missing. Pass ``device="cpu"`` for the plain PyTorch
versions of the kernels (the tests do).
"""

import dataclasses
from typing import Any, Optional

import torch

from deepspeed_tpu_torch.inference import generation

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.transformer import (fuse_layer_stack,
                                                    logical_axes,
                                                    make_model,
                                                    quantize_leaf,
                                                    quantized_logical_axes,
                                                    unfuse_layer_stack)
from deepspeed_tpu_torch.parallel.context import parallel_context
from deepspeed_tpu_torch.parallel.mesh import Mesh, MeshPlan, build_mesh
from deepspeed_tpu_torch.parallel.partitioning import own_shard, spec_tree


@dataclasses.dataclass
class InferenceConfig:
    """The fields of the JAX ``InferenceConfig`` this port serves."""
    dtype: Any = None                  # torch dtype; None -> bfloat16
    # the declared context budget: it sets the int8 KV default
    max_tokens: int = 1024
    # None -> context-aware: 8 (int8 cache, which bypasses the paged decode
    # kernel) when max_tokens >= 1024, else 0 (float); 0 or 8 explicitly
    kv_cache_bits: Optional[int] = None
    # parallel degrees: the tensor axis shards heads, FFN columns and the
    # vocab; the expert axis shards a MoE model's experts
    tensor_parallel: int = 1
    expert_parallel: int = 1
    # int8 layer weights: dequantized one layer at a time (quantize_bits)
    # or kept int8 through the matmul (weight_bits); 8 only, exclusive
    quantize_bits: Optional[int] = None
    weight_bits: Optional[int] = None

    def __post_init__(self):
        for name in ("tensor_parallel", "expert_parallel"):
            if int(getattr(self, name) or 1) < 1:
                raise ValueError(f"{name}={getattr(self, name)}: >= 1")
        if self.kv_cache_bits not in (None, 0, 8):
            raise ValueError(f"kv_cache_bits={self.kv_cache_bits} "
                             "unsupported (0 = float cache, 8 = int8)")
        if self.weight_bits and int(self.weight_bits) != 8:
            raise ValueError(f"weight_bits={self.weight_bits} unsupported "
                             "(8 = int8 is the only value)")
        if self.quantize_bits and int(self.quantize_bits) != 8:
            raise ValueError("weight-only inference quantization supports "
                             f"int8 (quantize_bits={self.quantize_bits})")
        if self.weight_bits and self.quantize_bits:
            raise ValueError(
                "weight_bits and quantize_bits are mutually exclusive: both "
                "store int8 weights; weight_bits keeps them int8 through "
                "the matmul instead of dequantizing each layer")

    @property
    def resolved_kv_cache_bits(self) -> int:
        """JAX's context-aware default: int8 from 1024 tokens of context."""
        if self.kv_cache_bits is not None:
            return int(self.kv_cache_bits)
        return 8 if int(self.max_tokens or 0) >= 1024 else 0


def init_inference(model, config=None, dtype=None, params=None, device=None,
                   seed: int = 0, mesh=None, **kwargs):
    """``model``: a ModelSpec (``models.make_model``). ``config``: an
    InferenceConfig or a dict of its field names (kwargs add to it).
    ``params``: a JAX-layout tree (numpy arrays or tensors, int8
    {"q", "scale"} stacks included) instead of the seeded on-device
    init. ``mesh``: a ``MeshPlan`` (laid over the default process group)
    or a built ``Mesh``; None builds the config's degrees."""
    if not isinstance(config, InferenceConfig):
        raw = dict(config or {})
        raw.update(kwargs)
        if dtype is not None:
            raw["dtype"] = dtype
        config = InferenceConfig(**raw)
    elif dtype is not None:
        config = dataclasses.replace(config, dtype=dtype)
    return InferenceEngine(model, config, params=params, device=device,
                           seed=seed, mesh=mesh)


def _quantized_tree(params) -> bool:
    return any(isinstance(v, dict) for v in params["layers"].values())


def _resolve_mesh(model, config: InferenceConfig, mesh):
    """JAX's mesh validations (``inference/engine.py``), then the mesh:
    (mesh, tp, ep). The degrees are checked before any process group is
    touched."""
    tp = max(1, int(config.tensor_parallel or 1))
    ep = max(1, int(config.expert_parallel or 1))
    if mesh is None:
        plan = MeshPlan(expert=ep, tensor=tp)
    else:
        plan = mesh.plan if isinstance(mesh, Mesh) else mesh
        # an explicit mesh is authoritative: a config degree that
        # contradicts it is a caller bug, not a silent replication
        if config.tensor_parallel > 1 and plan.tensor != tp:
            raise ValueError(f"tensor_parallel={tp} but the mesh's tensor "
                             f"axis has size {plan.tensor}")
        if ep > 1 and plan.expert != ep:
            raise ValueError(f"expert_parallel={ep} but the mesh's expert "
                             f"axis has size {plan.expert}")
        tp, ep = plan.tensor, plan.expert
    if plan.pipe > 1 or plan.seq > 1:
        raise ValueError(
            f"inference on a mesh with pipe={plan.pipe}, seq={plan.seq}: "
            "the inference engine runs the data, fsdp, expert and tensor "
            "axes (JAX's InferenceEngine plans data x expert x tensor)")
    mcfg = model.config
    if ep > 1:
        if mcfg.num_experts <= 1:
            if config.expert_parallel > 1:
                raise ValueError(
                    f"expert_parallel={ep} needs a MoE model (num_experts "
                    "> 1): the expert axis shards the stacked expert dim "
                    "of the MoE FFN weights")
            # an expert axis of a shared mesh: a dense model has nothing
            # to shard over it, every rank holds it whole
            ep = 1
        elif mcfg.num_experts % ep:
            raise ValueError(
                f"expert_parallel={ep} does not divide num_experts="
                f"{mcfg.num_experts}: each rank must hold whole experts")
    if tp > 1 and mcfg.kv_heads % tp:
        raise ValueError(
            f"tensor parallel degree {tp} does not divide kv_heads="
            f"{mcfg.kv_heads}: the KV pools shard on the kv-head dim, so "
            "each rank must hold whole heads")
    if not isinstance(mesh, Mesh):
        mesh = build_mesh(plan)
    return mesh, tp, ep


class InferenceEngine:
    def __init__(self, model, config: InferenceConfig, params=None,
                 device=None, seed: int = 0, mesh=None):
        self.mesh, self.tp, self.ep = _resolve_mesh(model, config, mesh)
        self.device = resolve_device(device)
        self.config = config
        self.dtype = config.dtype or torch.bfloat16
        weight_only = bool(config.weight_bits)
        quantized = weight_only or bool(config.quantize_bits)
        # activations run in the engine's dtype, so the pools, the params
        # and every kernel operand agree; the ModelSpec's functions are
        # bound to its config, so a changed config rebuilds it
        mcfg = dataclasses.replace(
            model.config, dtype=self.dtype,
            kv_cache_bits=config.resolved_kv_cache_bits,
            quantized_weights=quantized,
            weight_only_bits=8 if weight_only else 0)
        if mcfg != model.config:
            model = make_model(mcfg, name=model.name)
        self.model = model
        self.params = self._build_params(params, seed, quantized)

    def _build_params(self, params, seed: int, quantized: bool):
        """This rank's params, one path for every mesh (on one rank every
        slice is the whole leaf): cast to the engine's dtype, quantized
        per layer when asked (a row-parallel leaf's scales are maxima
        over all its rows, an expert stack's over all its experts, as
        JAX's), then sliced by the rules. The seeded init keeps each
        leaf's slice as soon as it is drawn; a given tree is sliced
        before its copy (``params_from_numpy``). The GEMM fusion runs at
        tp = 1 on float stacks only, as JAX's."""
        mcfg = self.model.config
        if params is None:
            specs = spec_tree(quantized_logical_axes(mcfg) if quantized
                              else logical_axes(mcfg))

            def keep(path, t):
                spec = specs
                for part in path.split("/"):
                    spec = spec[part]
                if quantized and path.startswith("layers/"):
                    t = quantize_leaf(t)
                if isinstance(t, dict):
                    return {k: own_shard(v, spec[k], self.mesh, path)
                            for k, v in t.items()}
                return own_shard(t, spec, self.mesh, path)

            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, self.device, dtype=self.dtype,
                                     keep=keep)
        else:
            if _quantized_tree(params) and not quantized:
                raise ValueError("params hold int8 layer stacks: serve them "
                                 "with quantize_bits=8 or weight_bits=8")
            params = params_from_numpy(unfuse_layer_stack(params, mcfg),
                                       mcfg, device=self.device,
                                       dtype=self.dtype, mesh=self.mesh,
                                       quantize=quantized)
        if quantized or self.tp > 1:
            return params
        return fuse_layer_stack(params)

    def forward(self, input_ids, **kwargs):
        """Full-sequence f32 logits [B, S, V] (the prefill path: the flash
        kernel on the card). Extra kwargs pass through to the model's
        ``apply``: ``attention_mask``, ``token_type_ids`` (an encoder's
        segment ids) and ``positions`` are moved to the engine's device
        (arrays or tensors). Collective on a mesh of more than one
        rank."""
        ids = torch.as_tensor(input_ids).long().to(self.device)
        B = ids.shape[0]
        kwargs = {k: (torch.as_tensor(v).to(self.device)
                      if k in ("attention_mask", "token_type_ids",
                               "positions") and v is not None else v)
                  for k, v in kwargs.items()}
        rows = self._data_rows(B)
        if rows is not None:
            ids = ids[rows]
            kwargs = {k: (v[rows] if isinstance(v, torch.Tensor)
                          and v.dim() and v.shape[0] == B else v)
                      for k, v in kwargs.items()}
        with torch.no_grad(), parallel_context(self.mesh):
            out = self.model.apply(self.params, ids, **kwargs)
            return out if rows is None else comm.all_gather(out, "data")

    __call__ = forward

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 rng: Optional[torch.Generator] = None):
        """Greedy (``temperature=0``) or sampled decode of one batch in
        lockstep on the contiguous KV cache: returns [B, P +
        max_new_tokens] ids. ``rng``: the generator sampling draws from.
        Collective on a mesh of more than one rank (every rank samples
        the same greedy tokens; sampled decode draws on each rank's
        ``rng``)."""
        ids = torch.as_tensor(input_ids)
        rows = self._data_rows(ids.shape[0]) if ids.dim() == 2 else None
        if rows is not None:
            ids = ids[rows]
        with parallel_context(self.mesh):
            out = generation.generate(self, ids,
                                      max_new_tokens=max_new_tokens,
                                      temperature=temperature, rng=rng)
            return out if rows is None else comm.all_gather(out, "data")

    def _data_rows(self, batch_size: int) -> Optional[slice]:
        """This rank's rows of a batch the data degree divides (JAX's
        ``_batch_spec``: ``P("data")``); None: the batch is whole on
        every rank (no data axis, or a batch it does not divide)."""
        dp = self.mesh.size("data")
        if dp <= 1 or batch_size % dp:
            return None
        n = batch_size // dp
        i = self.mesh.index("data")
        return slice(i * n, (i + 1) * n)

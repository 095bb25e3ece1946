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

``init_inference`` runs on the card: ``device=None`` means "cuda" and
raises when CUDA is missing. Pass ``device="cpu"`` for the plain PyTorch
versions of the kernels (the tests do).
"""

import dataclasses
from typing import Any, Optional

import torch

from deepspeed_tpu_torch.inference import generation

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.transformer import (fuse_layer_stack,
                                                    make_model,
                                                    quantize_layer_stack,
                                                    unfuse_layer_stack)


@dataclasses.dataclass
class InferenceConfig:
    """The fields of the JAX ``InferenceConfig`` this port serves."""
    dtype: Any = None                  # torch dtype; None -> bfloat16
    # the declared context budget: it sets the int8 KV default
    max_tokens: int = 1024
    # None -> context-aware: 8 (int8 cache, which bypasses the paged decode
    # kernel) when max_tokens >= 1024, else 0 (float); 0 or 8 explicitly
    kv_cache_bits: Optional[int] = None
    tensor_parallel: int = 1
    expert_parallel: int = 1
    # int8 layer weights: dequantized one layer at a time (quantize_bits)
    # or kept int8 through the matmul (weight_bits); 8 only, exclusive
    quantize_bits: Optional[int] = None
    weight_bits: Optional[int] = None

    def __post_init__(self):
        deferred = {
            "tensor_parallel": (self.tensor_parallel != 1,
                                "A6h (tensor / expert parallel serving)"),
            "expert_parallel": (self.expert_parallel != 1,
                                "A6h (tensor / expert parallel serving)"),
        }
        for name, (bad, item) in deferred.items():
            if bad:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet: "
                    f"ROADMAP {item}")
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
                   seed: int = 0, **kwargs):
    """``model``: a ModelSpec (``models.make_model``). ``config``: an
    InferenceConfig or a dict of its field names (kwargs add to it).
    ``params``: a JAX-layout tree (numpy arrays or tensors, int8
    {"q", "scale"} stacks included) instead of the seeded on-device
    init."""
    if not isinstance(config, InferenceConfig):
        raw = dict(config or {})
        raw.update(kwargs)
        if dtype is not None:
            raw["dtype"] = dtype
        config = InferenceConfig(**raw)
    elif dtype is not None:
        config = dataclasses.replace(config, dtype=dtype)
    return InferenceEngine(model, config, params=params, device=device,
                           seed=seed)


def _quantized_tree(params) -> bool:
    return any(isinstance(v, dict) for v in params["layers"].values())


class InferenceEngine:
    def __init__(self, model, config: InferenceConfig, params=None,
                 device=None, seed: int = 0):
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
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = model.init(gen, self.device, dtype=self.dtype)
        else:
            params = params_from_numpy(params, mcfg, device=self.device,
                                       dtype=self.dtype)
        if quantized:
            # as JAX: cast, unfused layout, then int8 (stacks that arrive
            # int8 stay as they are)
            params = quantize_layer_stack(unfuse_layer_stack(params, mcfg))
        elif _quantized_tree(params):
            raise ValueError("params hold int8 layer stacks: serve them with "
                             "quantize_bits=8 or weight_bits=8")
        else:
            # the model runs either layout; an already-fused tree stays
            # fused
            params = fuse_layer_stack(params)
        self.params = params

    def forward(self, input_ids, **kwargs):
        """Full-sequence f32 logits [B, S, V] (the prefill path: the flash
        kernel on the card). Extra kwargs pass through to the model's
        ``apply`` (e.g. ``attention_mask``)."""
        ids = torch.as_tensor(input_ids).long().to(self.device)
        with torch.no_grad():
            return self.model.apply(self.params, ids, **kwargs)

    __call__ = forward

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 rng: Optional[torch.Generator] = None):
        """Greedy (``temperature=0``) or sampled decode of one batch in
        lockstep on the contiguous KV cache: returns [B, P +
        max_new_tokens] ids. ``rng``: the generator sampling draws from."""
        return generation.generate(self, input_ids,
                                   max_new_tokens=max_new_tokens,
                                   temperature=temperature, rng=rng)

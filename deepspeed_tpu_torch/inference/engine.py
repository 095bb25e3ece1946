"""Inference engine, PyTorch port of ``deepspeed_tpu/inference/engine.py``
(the part the serving path uses): one device, the params cast to the
engine's dtype, and the decode GEMMs fused (wqkv, w_in_gate) as the JAX
engine fuses float weights at tp=1.

``init_inference`` runs on the card: ``device=None`` means "cuda" and
raises when CUDA is missing. Pass ``device="cpu"`` for the plain PyTorch
versions of the kernels (the tests do).
"""

import dataclasses
from typing import Any, Optional

import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.transformer import (fuse_layer_stack,
                                                    make_model)


@dataclasses.dataclass
class InferenceConfig:
    """The fields of the JAX ``InferenceConfig`` this slice serves."""
    dtype: Any = None                  # torch dtype; None -> bfloat16
    # The JAX engine's context-aware default turns on an int8 KV pool at
    # max_tokens >= 1024, and that pool bypasses the paged decode kernel.
    # This slice serves the float pool the kernel reads: None and 0 both
    # mean float; 8 arrives with ROADMAP A6a (and with it max_tokens).
    kv_cache_bits: Optional[int] = None
    tensor_parallel: int = 1
    expert_parallel: int = 1
    quantize_bits: Optional[int] = None
    weight_bits: Optional[int] = None

    def __post_init__(self):
        deferred = {
            "kv_cache_bits": (self.kv_cache_bits not in (None, 0),
                              "A6a (int8 KV cache)"),
            "tensor_parallel": (self.tensor_parallel != 1,
                                "A6h (tensor / expert parallel serving)"),
            "expert_parallel": (self.expert_parallel != 1,
                                "A6h (tensor / expert parallel serving)"),
            "quantize_bits": (self.quantize_bits is not None,
                              "A6b (int8 weights)"),
            "weight_bits": (self.weight_bits is not None,
                            "A6b (int8 weights)"),
        }
        for name, (bad, item) in deferred.items():
            if bad:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet: "
                    f"ROADMAP {item}")


def init_inference(model, config=None, dtype=None, params=None, device=None,
                   seed: int = 0, **kwargs):
    """``model``: a ModelSpec (``models.make_model``). ``config``: an
    InferenceConfig or a dict of its field names (kwargs add to it).
    ``params``: a JAX-layout tree (numpy arrays or tensors) instead of the
    seeded on-device init."""
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


class InferenceEngine:
    def __init__(self, model, config: InferenceConfig, params=None,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.config = config
        self.dtype = config.dtype or torch.bfloat16
        # activations run in the engine's dtype, so the pools, the params
        # and every kernel operand agree
        if model.config.dtype != self.dtype:
            model = make_model(dataclasses.replace(model.config,
                                                   dtype=self.dtype),
                               name=model.name)
        self.model = model
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = model.init(gen, self.device, dtype=self.dtype)
        else:
            params = params_from_numpy(params, model.config,
                                       device=self.device, dtype=self.dtype)
        # the model runs either layout; an already-fused tree stays fused
        self.params = fuse_layer_stack(params)

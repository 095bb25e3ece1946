"""Move a JAX parameter tree into the port.

The port keeps the JAX layout (same names, ``[in, out]`` matrices, the
stacked leading ``L`` dim), so conversion is leaf for leaf with no
transposes. Both layouts that ``init_inference`` can produce are accepted:
unfused (wq/wk/wv, w_in/w_gate) and fused by ``fuse_layer_stack``
(wqkv = concat(wq, wk, wv), w_in_gate = concat(w_in, w_gate)).
"""

from typing import Any, Dict

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer import TransformerConfig

_TOP = {"tok_embed", "layers", "final_norm_scale", "final_norm_bias",
        "lm_head"}
_LAYER = {"ln1_scale", "ln2_scale", "ln1_bias", "ln2_bias", "wq", "wk", "wv",
          "wqkv", "wo", "w_in", "w_gate", "w_in_gate", "w_out"}


def _leaf(a, device, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a
    else:
        arr = np.asarray(a)
        if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
            # numpy has no native bfloat16: widen exactly, narrow on device
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr, copy=True))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device).contiguous()


def params_from_numpy(tree: Dict[str, Any], cfg: TransformerConfig, *,
                      device, dtype: torch.dtype) -> Dict[str, Any]:
    """JAX params (numpy arrays, or anything ``np.asarray`` takes) -> the
    port's params on ``device``, float leaves cast to ``dtype``."""
    unknown = (set(tree) - _TOP) | (set(tree.get("layers", {})) - _LAYER)
    if unknown:
        raise NotImplementedError(
            f"parameters {sorted(unknown)} belong to a model family this "
            "slice does not serve (MoE, learned positions, projection "
            "biases, quantized stacks): see ROADMAP A9 / A11 / A6b")
    layers = tree["layers"]
    L = cfg.num_layers
    for name, a in layers.items():
        if np.shape(a)[0] != L:
            raise ValueError(f"layers/{name} has leading dim "
                             f"{np.shape(a)[0]}, config has {L} layers")
    out = {k: _leaf(v, device, dtype) for k, v in tree.items()
           if k != "layers"}
    out["layers"] = {k: _leaf(v, device, dtype) for k, v in layers.items()}
    return out

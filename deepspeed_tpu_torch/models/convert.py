"""Move a JAX parameter tree, or the JAX engine's whole training state,
into the port.

The port keeps the JAX layout (same names, ``[in, out]`` matrices, the
stacked leading ``L`` dim), so conversion is leaf for leaf with no
transposes. Both layouts that ``init_inference`` can produce are accepted:
unfused (wq/wk/wv, w_in/w_gate) and fused by ``fuse_layer_stack``
(wqkv = concat(wq, wk, wv), w_in_gate = concat(w_in, w_gate)), and so are
the int8 stacks of ``quantize_layer_stack``: a {"q", "scale"} leaf keeps
its int8 payload and its f32 scales.
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


def _layer_leaf(a, device, dtype):
    """A layer-stack leaf: an array, or an int8 {"q", "scale"} leaf (the
    scales stay f32, as ``quantize_layer_stack`` makes them)."""
    if isinstance(a, dict):
        if set(a) != {"q", "scale"}:
            raise ValueError(f"a quantized leaf has keys {sorted(a)}: "
                             "expected q and scale")
        return {"q": _leaf(a["q"], device, dtype),
                "scale": _leaf(a["scale"], device, torch.float32)}
    return _leaf(a, device, dtype)


def _lead(a) -> int:
    return np.shape(a["q"] if isinstance(a, dict) else a)[0]


def params_from_numpy(tree: Dict[str, Any], cfg: TransformerConfig, *,
                      device, dtype: torch.dtype) -> Dict[str, Any]:
    """JAX params (numpy arrays, or anything ``np.asarray`` takes) -> the
    port's params on ``device``, float leaves cast to ``dtype``."""
    unknown = (set(tree) - _TOP) | (set(tree.get("layers", {})) - _LAYER)
    if unknown:
        raise NotImplementedError(
            f"parameters {sorted(unknown)} belong to a model family this "
            "slice does not serve (MoE, learned positions, projection "
            "biases): see ROADMAP A9 / A11")
    layers = tree["layers"]
    L = cfg.num_layers
    for name, a in layers.items():
        if _lead(a) != L:
            raise ValueError(f"layers/{name} has leading dim {_lead(a)}, "
                             f"config has {L} layers")
    out = {k: _leaf(v, device, dtype) for k, v in tree.items()
           if k != "layers"}
    out["layers"] = {k: _layer_leaf(v, device, dtype)
                     for k, v in layers.items()}
    return out


def _host_int(v) -> int:
    return int(np.asarray(v).reshape(-1)[0])


def state_from_numpy(state_tree: Dict[str, Any], cfg: TransformerConfig, *,
                     device, compute_dtype: torch.dtype) -> Dict[str, Any]:
    """The JAX engine's whole training state as numpy (``params``, ``opt``
    with JAX's names: ``step``, ``exp_avg``, ``exp_avg_sq``, ``master``
    (None without masters), ``max_exp_avg_sq`` under amsgrad; the applied
    update count ``step``) -> the port's ``Engine.state``: params in
    ``compute_dtype`` (bf16 arrives as ml_dtypes and is widened and
    narrowed exactly), the optimizer's trees in f32, both step counts as
    host ints."""
    params = params_from_numpy(state_tree["params"], cfg, device=device,
                               dtype=compute_dtype)
    opt = {}
    for name, v in state_tree["opt"].items():
        if name == "step":
            opt[name] = _host_int(v)
        elif v is None:
            opt[name] = None
        else:
            opt[name] = params_from_numpy(v, cfg, device=device,
                                          dtype=torch.float32)
    step = state_tree.get("step", opt.get("step", 0))
    return {"params": params, "opt": opt, "step": _host_int(step)}

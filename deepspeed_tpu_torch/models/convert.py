"""Move a JAX parameter tree, or the JAX engine's whole training state,
into the port.

The port keeps the JAX layout (same names, ``[in, out]`` matrices, the
stacked leading ``L`` dim), so conversion is leaf for leaf with no
transposes. Both layouts that ``init_inference`` can produce are accepted:
unfused (wq/wk/wv, w_in/w_gate) and fused by ``fuse_layer_stack``
(wqkv = concat(wq, wk, wv), w_in_gate = concat(w_in, w_gate)), and so are
the int8 stacks of ``quantize_layer_stack``: a {"q", "scale"} leaf keeps
its int8 payload and its f32 scales. MoE trees carry the gate ``wg``, the
expert stacks ``moe_w_in`` / ``moe_w_out`` / ``moe_w_gate`` and PR-MoE's
``moe_coef``.

With a ``mesh`` (tensor / expert parallel serving) each leaf is cut to
this rank's slice by JAX's sharding rules before it is copied, so a rank
moves only its shard to the device.
"""

from typing import Any, Dict

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    logical_axes,
                                                    quantize_leaf,
                                                    quantized_logical_axes)
from deepspeed_tpu_torch.parallel.partitioning import own_shard, spec_tree

_TOP = {"tok_embed", "layers", "final_norm_scale", "final_norm_bias",
        "lm_head"}
_LAYER = {"ln1_scale", "ln2_scale", "ln1_bias", "ln2_bias", "wq", "wk", "wv",
          "wqkv", "wo", "w_in", "w_gate", "w_in_gate", "w_out", "wg",
          "moe_w_in", "moe_w_out", "moe_w_gate", "moe_coef"}


def _leaf(a, device, dtype, spec=None, mesh=None, what="leaf"
          ) -> torch.Tensor:
    if spec is not None:
        a = own_shard(a, spec, mesh, what)
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


def _layer_leaf(a, device, dtype, spec=None, mesh=None, what="leaf",
                quantize=False):
    """A layer-stack leaf: an array, or an int8 {"q", "scale"} leaf (the
    scales stay f32, as ``quantize_layer_stack`` makes them). ``quantize``:
    a float leaf that ``quantize_leaf`` turns int8 is quantized on the
    device one layer at a time and then sliced (a row-parallel leaf's
    scales are maxima over all its rows, an expert stack's over all its
    experts, so the slice is cut after the scales are taken)."""
    if quantize and not isinstance(a, dict) and np.ndim(a) >= 3:
        layers = [quantize_leaf(_leaf(a[i:i + 1], device, dtype))
                  for i in range(_lead(a))]
        if isinstance(layers[0], dict):
            spec = spec or {"q": None, "scale": None}
            return {k: torch.cat([w[k] if mesh is None else
                                  own_shard(w[k], spec[k], mesh, what)
                                  for w in layers])
                    for k in ("q", "scale")}
    if isinstance(a, dict):
        if set(a) != {"q", "scale"}:
            raise ValueError(f"a quantized leaf has keys {sorted(a)}: "
                             "expected q and scale")
        spec = spec or {"q": None, "scale": None}
        return {"q": _leaf(a["q"], device, dtype, spec["q"], mesh, what),
                "scale": _leaf(a["scale"], device, torch.float32,
                               spec["scale"], mesh, what + "/scale")}
    return _leaf(a, device, dtype, spec, mesh, what)


def _lead(a) -> int:
    return np.shape(a["q"] if isinstance(a, dict) else a)[0]


def param_specs(tree: Dict[str, Any], cfg: TransformerConfig,
                quantized: bool = False, rules=None):
    """The mesh spec of every leaf of an unfused (possibly int8) param
    tree under JAX's serving rules (``parallel/partitioning.RULES``), or
    under ``rules`` (a training table of ``make_rules``)."""
    layers = tree["layers"]
    fused = {"wqkv", "w_in_gate"} & set(layers)
    if fused:
        raise ValueError(f"fused leaves {sorted(fused)} cannot be sharded "
                         "(the concat dim would interleave head shards): "
                         "unfuse_layer_stack first")
    quantized = quantized or any(isinstance(v, dict)
                                 for v in layers.values())
    axes = quantized_logical_axes(cfg) if quantized else logical_axes(cfg)
    specs = spec_tree(axes, rules)
    missing = ({k for k in tree if k != "layers"} - set(specs)) | (
        set(layers) - set(specs["layers"]))
    if missing:
        raise ValueError(f"leaves {sorted(missing)} have no sharding rule "
                         "for this config")
    return specs


def params_from_numpy(tree: Dict[str, Any], cfg: TransformerConfig, *,
                      device, dtype: torch.dtype, mesh=None,
                      quantize: bool = False,
                      rules=None) -> Dict[str, Any]:
    """JAX params (numpy arrays, or anything ``np.asarray`` takes) -> the
    port's params on ``device``, float leaves cast to ``dtype``. With a
    ``mesh`` of more than one rank, each leaf is this rank's slice
    (``param_specs``: the serving table, or ``rules``, a training table
    of ``parallel.partitioning.make_rules`` for a ZeRO stage with or
    without the tensor axis), cut before the copy. ``quantize``: the
    float layer stacks arrive int8 (``quantize_leaf``, after the cast,
    one layer at a time on the device)."""
    unknown = (set(tree) - _TOP) | (set(tree.get("layers", {})) - _LAYER)
    if unknown:
        raise NotImplementedError(
            f"parameters {sorted(unknown)} belong to a model family this "
            "slice does not serve (learned positions, projection biases): "
            "see ROADMAP A11")
    layers = tree["layers"]
    L = cfg.num_layers
    for name, a in layers.items():
        if _lead(a) != L:
            raise ValueError(f"layers/{name} has leading dim {_lead(a)}, "
                             f"config has {L} layers")
    if mesh is None or mesh.world_size == 1:
        specs = {"layers": {}}
        mesh = None
    else:
        specs = param_specs(tree, cfg, quantized=quantize, rules=rules)
    out = {k: _leaf(v, device, dtype, specs.get(k), mesh, k)
           for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: _layer_leaf(v, device, dtype,
                                    specs["layers"].get(k), mesh,
                                    "layers/" + k, quantize)
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
    host ints; an fp16 state's ``loss_scale`` (scale, good_steps,
    hysteresis) and ``skipped`` as 0-dim tensors of JAX's dtypes."""
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
    out = {"params": params, "opt": opt, "step": _host_int(step)}
    if "loss_scale" in state_tree:          # an fp16 state: 0-dim leaves
        out["loss_scale"] = {
            k: torch.as_tensor(np.asarray(v), device=device).reshape(())
            for k, v in state_tree["loss_scale"].items()}
        out["skipped"] = torch.as_tensor(
            np.asarray(state_tree["skipped"]), device=device).reshape(())
    return out

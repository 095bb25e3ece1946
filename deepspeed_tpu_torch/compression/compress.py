"""Compression: QAT weight and activation quantization, structured and
unstructured pruning, layer reduction and distillation, PyTorch port of
``deepspeed_tpu/compression/compress.py``.

As in JAX there is no module surgery: compression is a transform of the
param tree applied inside each micro-batch's loss, ``params' =
transform(params, step)``, with straight-through gradients, so the
optimizer keeps updating full-precision masters while the forward sees
quantized or pruned weights. A rule hits a leaf by its path (the
``/``-joined dict keys, JAX's leaf names: ``layers/w_in``), by fnmatch or
by substring, and only leaves of 2 or more dims and 64 or more values.
The rules' order is JAX's: weight quantization, then the sparse, row,
head and channel masks, each on the previous rule's output.

The masks keep JAX's granularity: one threshold over the whole stacked
leaf (all layers together) for the sparse, row and channel masks, one per
layer over its heads for the head mask. On a mesh whose model axes cut a
leaf (``tensor``, ``expert``, ``pipe``: ``parallel.partitioning.
model_split``), JAX's GSPMD program still sees the whole leaf, so each
mask, threshold and scale is computed on the whole leaf (gathered,
detached, in the one-rank order: a partial norm summed over the ranks
adds in another order, and a quantile can flip a mask entry at a
near-tie) and the rank applies its slice of it to its own slice, whose
gradient stays local; a leaf with only weight quantization takes the
whole leaf's amax by a max over the ranks (exact) instead. The threshold
is JAX's ``jnp.quantile`` (linear interpolation, its f32 arithmetic, n -
1 rounded to f32 as JAX rounds it) over a sort: ``torch.quantile``
refuses more than 2^24 values, and llama-1b's ``layers/w_in`` holds
184.5 M.

Activation quantization is not a param transform: the engine rebuilds the
model with ``activation_quant_bits`` once its ``schedule_offset`` is
reached (``models/transformer``: the post-norm activations before the
attention and MLP matmuls). Layer reduction builds the student of
``keep_number`` layers at the engine's init; ``student_params_from_
teacher`` and ``make_distillation_loss`` give it a teacher's layers and
the teacher's logits, as in JAX.
"""

import dataclasses
import fnmatch
import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.quantizer import fake_quant

logger = logging.getLogger("deepspeed_tpu_torch")


@dataclasses.dataclass
class _Rule:
    kind: str                 # weight_quant | sparse | row | head | channel
    patterns: List[str]
    offset: int = 0           # schedule_offset: active from this step
    bits: int = 8
    dense_ratio: float = 1.0  # fraction of weights / rows / heads KEPT
    num_heads: Optional[int] = None


def _section_rules(kind: str, section: Dict[str, Any]) -> List[_Rule]:
    if not section:
        return []
    shared = section.get("shared_parameters", {})
    if not shared.get("enabled", False):
        return []
    offset = int(shared.get("schedule_offset", 0))
    rules = []
    for _name, grp in (section.get("different_groups") or {}).items():
        p = grp.get("params", {})
        rules.append(_Rule(
            kind=kind,
            patterns=[str(m) for m in grp.get("modules", ["*"])],
            offset=offset,
            bits=int(p.get("target_bits", p.get("bits", 8))),
            dense_ratio=float(p.get("dense_ratio", 1.0)),
            num_heads=p.get("num_heads")))
    if not rules:  # enabled with no groups: every leaf
        rules.append(_Rule(kind=kind, patterns=["*"], offset=offset))
    return rules


def _match(path: str, patterns: List[str]) -> bool:
    return any(fnmatch.fnmatch(path, pat) or pat in path for pat in patterns)


def _map_with_path(fn, tree, prefix: str = ""):
    return {k: (_map_with_path(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
                else fn(f"{prefix}{k}", v)) for k, v in tree.items()}


class CompressionTransform:
    """The param-tree transform of a ``compression_training`` section
    (built once, applied every micro-batch)."""

    def __init__(self, config: Dict[str, Any]):
        self.rules: List[_Rule] = []
        self.rules += _section_rules("weight_quant",
                                     config.get("weight_quantization", {}))
        self.rules += _section_rules("sparse", config.get("sparse_pruning", {}))
        self.rules += _section_rules("row", config.get("row_pruning", {}))
        self.rules += _section_rules("head", config.get("head_pruning", {}))
        self.rules += _section_rules("channel",
                                     config.get("channel_pruning", {}))

        # activation quantization: (bits, schedule_offset), model-wide on
        # the post-norm activations (the engine rebuilds the model)
        self.activation_quant: Optional[Tuple[int, int]] = None
        aq = config.get("activation_quantization", {}) or {}
        if aq.get("shared_parameters", {}).get("enabled"):
            shared = aq["shared_parameters"]
            groups = list((aq.get("different_groups") or {}).values())
            bits = int(groups[0].get("params", {}).get("bits", 8)) \
                if groups else 8
            if len(groups) > 1 or any(
                    g.get("modules", ["*"]) not in (["*"], "*")
                    for g in groups):
                logger.warning(
                    "activation_quantization applies model-wide (post-norm "
                    "activations); per-group module scoping is ignored — "
                    f"using bits={bits} from the first group")
            self.activation_quant = (bits,
                                     int(shared.get("schedule_offset", 0)))

        # layer reduction: the student's depth, taken at the engine's build
        lr_cfg = config.get("layer_reduction", {}) or {}
        self.layer_reduction: Optional[Dict[str, Any]] = None
        if lr_cfg.get("enabled"):
            self.layer_reduction = {
                "keep_number": int(lr_cfg["keep_number"]),
                "teacher_layer": list(lr_cfg.get("teacher_layer", [])),
            }

        if not self.rules and self.activation_quant is None \
                and self.layer_reduction is None:
            raise ValueError("compression config has no enabled section")

    def _leaf_ops(self, path: str, leaf, shape=None) -> List[_Rule]:
        """The rules that hit ``leaf``, by its path and by the whole
        leaf's ``shape`` (default: its own)."""
        if not isinstance(leaf, torch.Tensor):
            return []
        shape = tuple(leaf.shape) if shape is None else shape
        if len(shape) < 2 or int(np.prod(shape)) < 64:
            return []
        return [r for r in self.rules if _match(path, r.patterns)]

    def apply(self, params, step: int, split=None, record=None):
        """The params the forward sees at (host) ``step``: a rule acts from
        its ``schedule_offset`` on; before that the leaf passes as it is.
        ``split(path)``: the leaf's ``ModelSplit`` on a mesh (None: the
        rank holds it whole). ``record``: a dict that receives each mask
        this rank applies, by (path, rule kind)."""
        def one(path, leaf):
            sp = split(path) if split is not None else None
            rules = [r for r in self._leaf_ops(
                path, leaf, None if sp is None else sp.shape)
                if step >= r.offset]
            # the whole leaf, detached, where a mask needs it; a rank's
            # slice of it is ``out``'s value throughout
            whole = None
            if sp is not None and any(r.kind != "weight_quant"
                                      for r in rules):
                whole = sp.whole(leaf)
            out = leaf
            for r in rules:
                if r.kind == "weight_quant":
                    amax = None
                    if whole is not None:
                        amax = whole.float().abs().amax()
                        whole = fake_quant(whole, bits=r.bits, amax=amax)
                    elif sp is not None:
                        amax = sp.max(out.detach().float().abs().amax())
                    out = fake_quant(out, bits=r.bits, amax=amax)
                    continue
                mask = _MASKS[r.kind](out if whole is None else whole, r)
                if whole is not None:
                    whole = whole * mask
                    mask = sp.local(mask)
                if record is not None:
                    record[path, r.kind] = mask
                out = out * mask
            return out

        return _map_with_path(one, params)


def quantile(a, q: float, dim: Optional[int] = None, keepdim: bool = False):
    """``jnp.quantile(a, q, axis=dim, keepdims=keepdim)`` with its linear
    interpolation, in JAX's f32 arithmetic: the position q * (n - 1) with n
    and n - 1 rounded to f32 (so past 2^24 values JAX's position, not the
    exact one), the two order statistics read from a sort along ``dim``
    (None: the flattened ``a``), lo * (1 - w) + hi * w. The weights are
    host scalars: no device sync."""
    a = a.detach().float()
    if dim is None:
        a, dim = a.reshape(-1), 0
    a = a.movedim(dim, -1)
    n = np.float32(a.shape[-1])
    pos = np.float32(q) * (n - np.float32(1.0))
    low, high = np.floor(pos), np.ceil(pos)
    hw = np.float32(pos - low)
    lw = np.float32(np.float32(1.0) - hw)
    lo_i = int(np.clip(low, 0, n - 1))
    hi_i = int(np.clip(high, 0, n - 1))
    s = torch.sort(a, dim=-1).values
    out = s[..., lo_i] * float(lw) + s[..., hi_i] * float(hw)
    if keepdim:
        out = out.unsqueeze(-1).movedim(-1, dim)
    return out


def _topk_mask(w, dense_ratio: float):
    """Unstructured magnitude mask keeping the top ``dense_ratio`` of the
    whole leaf (one threshold over every layer of a stacked leaf)."""
    a = w.detach().float().abs()
    thresh = quantile(a, 1.0 - dense_ratio)
    return (a >= thresh).to(w.dtype)


def _row_mask(w, dense_ratio: float):
    """Keep the rows of highest L2 norm: the leading dim of a 2-D leaf,
    the (layer, row) pairs of a stacked one, one threshold over them."""
    w2 = w.detach().reshape(w.shape[0], -1) if w.dim() == 2 else \
        w.detach().reshape(w.shape[0] * w.shape[1], -1)
    w2 = w2.float()
    norms = (w2 * w2).sum(dim=1).sqrt()
    thresh = quantile(norms, 1.0 - dense_ratio)
    mask = (norms >= thresh).to(w.dtype)
    shape = (w.shape[0], 1) if w.dim() == 2 else (w.shape[0], w.shape[1], 1)
    return mask.reshape(shape)


def _head_mask(w, dense_ratio: float, num_heads: Optional[int]):
    """Mask whole heads of an output projection [..., nh * hd, H] by the
    norm of each head's rows, one threshold per layer over its heads."""
    if not num_heads:
        raise ValueError("head_pruning needs params.num_heads")
    *lead, In, Out = w.shape
    hd = In // num_heads
    g = w.detach().reshape(*lead, num_heads, hd, Out).float()
    norms = (g * g).sum(dim=(-2, -1)).sqrt()             # [..., nh]
    thresh = quantile(norms, 1.0 - dense_ratio, dim=-1, keepdim=True)
    mask = (norms >= thresh).to(w.dtype)
    return mask[..., None].expand(*mask.shape, hd).reshape(*lead, In, 1)


def _channel_mask(w, dense_ratio: float):
    """Keep the output channels (the last axis of an [in, out] matmul) of
    highest L2 norm over every row of every layer."""
    w2 = w.detach().reshape(-1, w.shape[-1]).float()
    norms = (w2 * w2).sum(dim=0).sqrt()                  # [out]
    thresh = quantile(norms, 1.0 - dense_ratio)
    return (norms >= thresh).to(w.dtype)


# each mask rule: the mask (in w's dtype, broadcasting against w) of the
# values ``w`` under rule ``r``
_MASKS = {
    "sparse": lambda w, r: _topk_mask(w, r.dense_ratio),
    "row": lambda w, r: _row_mask(w, r.dense_ratio),
    "head": lambda w, r: _head_mask(w, r.dense_ratio, r.num_heads),
    "channel": lambda w, r: _channel_mask(w, r.dense_ratio),
}


def student_params_from_teacher(teacher_params, keep_layers: List[int]):
    """Layer reduction: the teacher's stacked layer dim cut to
    ``keep_layers`` (torch tensors or numpy arrays); the other leaves are
    the teacher's."""
    def take(a):
        if isinstance(a, torch.Tensor):
            return a.index_select(0, torch.as_tensor(
                keep_layers, dtype=torch.long, device=a.device))
        return np.take(np.asarray(a), keep_layers, axis=0)
    out = dict(teacher_params)
    out["layers"] = {k: take(v) for k, v in teacher_params["layers"].items()}
    return out


def make_distillation_loss(student_cfg, teacher_params, teacher_cfg=None,
                           alpha: float = 0.5, temperature: float = 2.0,
                           reference: bool = False) -> Callable:
    """Knowledge distillation for a layer-reduced student, JAX's loss:
    alpha * CE(student, labels) + (1 - alpha) * T^2 * KL(teacher_T ||
    student_T), the teacher's forward frozen (no graph). The returned
    function takes the model ``loss_fn``'s arguments, so a ``ModelSpec``
    can carry it (``dataclasses.replace(make_model(student_cfg),
    loss_fn=...)``). ``reference``: both forwards through the plain
    versions of the kernels (for comparisons on the card)."""
    from deepspeed_tpu_torch.models.transformer import (cross_entropy_loss,
                                                        forward, lm_labels)
    from deepspeed_tpu_torch.parallel.context import (gather_params,
                                                      param_gather)
    tcfg = teacher_cfg or student_cfg

    def loss_fn(params, batch, dropout_seed=None, label_count=None,
                train=False, **_):
        params = gather_params(params)
        ids = batch["input_ids"]
        s_logits = forward(params, ids, student_cfg, reference=reference,
                           dropout_seed=dropout_seed, train=train)
        ce = cross_entropy_loss(s_logits, lm_labels(batch),
                                count=label_count)
        with torch.no_grad(), param_gather(None):
            t_logits = forward(teacher_params, ids, tcfg,
                               reference=reference)
        T = temperature
        t_prob = torch.softmax(t_logits.float() / T, dim=-1)
        s_logp = torch.log_softmax(s_logits.float() / T, dim=-1)
        kl = (t_prob * (torch.log(t_prob + 1e-9) - s_logp)).sum(-1).mean()
        return alpha * ce + (1.0 - alpha) * (T * T) * kl

    return loss_fn


def init_compression(config: Dict[str, Any]) -> CompressionTransform:
    t = CompressionTransform(config)
    logger.info(f"compression: {len(t.rules)} rule(s) active "
                f"({', '.join(r.kind for r in t.rules)})")
    return t


@torch.no_grad()
def redundancy_clean(params, config: Dict[str, Any], step: int = 10 ** 9):
    """The compression applied for good (before an export)."""
    return CompressionTransform(config).apply(params, step)

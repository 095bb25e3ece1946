"""Decoder-only llama-family transformer, PyTorch port of the dense
pre-norm path of ``deepspeed_tpu/models/transformer.py``, with the paged
serving protocol (block pools + block tables).

Parameters keep the JAX layout at every boundary: a dict with the same
names, ``[in, out]`` matrices and the stacked leading ``L`` dim of
``init_params`` (``models/convert.params_from_numpy`` moves a JAX tree
over). Both the unfused (wq/wk/wv, w_in/w_gate) and the inference-fused
(wqkv, w_in_gate) layer layouts run.

Attention goes through the two hand-written kernels: the flash forward
(``ops/flash_attention``) for prefill and the paged decode kernel
(``ops/decode_attention``) for each decode step. On CUDA tensors they
launch their kernels; ``reference=True`` calls their plain versions by
name instead (for comparisons), and CPU tensors always take the plain
versions.

Training: ``lm_loss`` (full or chunked cross-entropy) is differentiable
through the flash forward and its two backward kernels (B2, B3), or, for
a ``sparse_attention`` config without a key mask, through the block-sparse
kernels (B5-B7, ``ops/sparse_attention``), with layer-level
rematerialization on ``torch.utils.checkpoint`` under the JAX package's
remat policies (``_remat_policy``). Serving a block-sparse model raises
(``check_servable``).

Weights are cast to the activation dtype at every matmul, as ``_wmat`` /
``_wrow`` / ``lm_head_logits`` do in JAX, so f32 parameters (a trainer's
storage) run under a bf16 compute config.

What this slice leaves out raises ``NotImplementedError`` naming its
ROADMAP item: alibi / learned positions, windows, MoE, int8 KV and int8
weights, the multi-token span path, and dropout.
"""

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.ops.decode_attention import (
    paged_decode_attention, paged_decode_reference)
from deepspeed_tpu_torch.ops.flash_attention import (FLASH_FWD_OP,
                                                     flash_attention)
from deepspeed_tpu_torch.ops.sparse_attention import (get_sparsity_config,
                                                      sparse_attention)

Params = Dict[str, Any]


REMAT_POLICIES = ("none", "full", "save_nothing", "dots_saveable",
                  "dots_and_attn")
_JAX_ONLY_POLICIES = ("dots_with_no_batch_dims", "offload_dots")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The fields of the JAX ``TransformerConfig`` this path reads, with
    the same names and defaults (dtypes are torch dtypes)."""
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None          # GQA; None -> num_heads
    head_dim: Optional[int] = None              # None -> hidden // heads
    intermediate_size: Optional[int] = None     # None -> 4*hidden / 8/3 (glu)
    max_seq_len: int = 1024
    position_type: str = "learned"              # this slice: rotary | none
    activation: str = "gelu"                    # gelu | silu_glu | gelu_glu | ...
    norm_type: str = "layernorm"                # layernorm | rmsnorm
    norm_eps: float = 1e-5
    causal: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    attn_scale: Optional[float] = None          # None -> 1/sqrt(head_dim)
    dtype: torch.dtype = torch.bfloat16         # activation/compute dtype
    param_dtype: torch.dtype = torch.float32    # storage dtype (engine casts)
    # training: layer remat (see _remat_policy), chunked cross-entropy
    # (0 = off), delta inside the attention backward kernels
    remat: bool = False
    remat_policy: str = "none"
    loss_chunk: int = 0
    fused_backward: bool = False
    # outside this slice (must stay at their defaults)
    dropout_rate: float = 0.0
    kv_cache_bits: int = 0
    quantized_weights: bool = False
    attn_windows: Optional[Tuple[int, ...]] = None
    num_experts: int = 1
    sparse_attention: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        deferred = {
            "kv_cache_bits": (self.kv_cache_bits != 0,
                              "A6a (int8 KV cache)"),
            "quantized_weights": (self.quantized_weights,
                                  "A6b (int8 weights)"),
            "attn_windows": (bool(self.attn_windows),
                             "A11 (local-attention windows)"),
            "num_experts": (self.num_experts > 1, "A9 (MoE)"),
            "position_type": (self.position_type not in ("rotary", "none"),
                              "A11 (learned / alibi positions)"),
            "causal": (not self.causal, "A11 (encoder models)"),
            "dropout_rate": (self.dropout_rate > 0, "A12 (dropout)"),
            "remat_policy": (self.remat_policy in _JAX_ONLY_POLICIES,
                             "A5 (remat sweep policies)"),
        }
        for name, (bad, item) in deferred.items():
            if bad:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet: "
                    f"ROADMAP {item}")
        if self.remat_policy not in REMAT_POLICIES + (None,):
            raise ValueError(f"remat_policy {self.remat_policy!r}: one of "
                             f"{REMAT_POLICIES}")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dim_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def ffn_dim(self) -> int:
        if self.intermediate_size:
            return self.intermediate_size
        if "glu" in self.activation:
            d = int(8 * self.hidden_size / 3)
            return 256 * ((d + 255) // 256)
        return 4 * self.hidden_size


def llama_config(size: str = "7b", **overrides) -> TransformerConfig:
    dims = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=4, num_kv_heads=2,
                     intermediate_size=768, vocab_size=32000, max_seq_len=2048),
        "350m": dict(hidden_size=1024, num_layers=24, num_heads=16,
                     num_kv_heads=8, intermediate_size=2816, vocab_size=32000,
                     max_seq_len=4096),
        "1b": dict(hidden_size=2048, num_layers=16, num_heads=32, num_kv_heads=8,
                   intermediate_size=5632, vocab_size=32000, max_seq_len=4096),
        "3b": dict(hidden_size=3072, num_layers=28, num_heads=24, num_kv_heads=8,
                   intermediate_size=8192, vocab_size=32000, max_seq_len=4096),
        "7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                   intermediate_size=11008, vocab_size=32000, max_seq_len=4096),
        "13b": dict(hidden_size=5120, num_layers=40, num_heads=40,
                    intermediate_size=13824, vocab_size=32000, max_seq_len=4096),
        "70b": dict(hidden_size=8192, num_layers=80, num_heads=64, num_kv_heads=8,
                    intermediate_size=28672, vocab_size=32000, max_seq_len=4096),
    }[size]
    base = dict(position_type="rotary", activation="silu_glu", norm_type="rmsnorm",
                norm_eps=1e-5, tie_embeddings=False)
    base.update(dims)
    base.update(overrides)
    return TransformerConfig(**base)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device, dtype: Optional[torch.dtype] = None) -> Params:
    """Seeded on-device init with the JAX init's distribution: normal with
    std 0.02, ``0.02 / sqrt(2L)`` for the residual out-projections (wo,
    w_out), ones for norm scales. The numbers differ from JAX's (another
    generator); parity tests move a JAX tree over with
    ``convert.params_from_numpy`` instead."""
    H, L = cfg.hidden_size, cfg.num_layers
    nh, nkv, hd, Fd = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head, cfg.ffn_dim
    dt = dtype or cfg.param_dtype
    std = 0.02
    out_scale = std / math.sqrt(2 * L)

    def normal(shape, scale=std):
        t = torch.empty(shape, dtype=dt, device=device)
        return t.normal_(0.0, scale, generator=generator)

    layers = {
        "ln1_scale": torch.ones((L, H), dtype=dt, device=device),
        "ln2_scale": torch.ones((L, H), dtype=dt, device=device),
        "wq": normal((L, H, nh * hd)),
        "wk": normal((L, H, nkv * hd)),
        "wv": normal((L, H, nkv * hd)),
        "wo": normal((L, nh * hd, H), out_scale),
        "w_in": normal((L, H, Fd)),
        "w_out": normal((L, Fd, H), out_scale),
    }
    if "glu" in cfg.activation:
        layers["w_gate"] = normal((L, H, Fd))
    if cfg.norm_type == "layernorm":
        layers["ln1_bias"] = torch.zeros((L, H), dtype=dt, device=device)
        layers["ln2_bias"] = torch.zeros((L, H), dtype=dt, device=device)
    params: Params = {"tok_embed": normal((cfg.vocab_size, H)),
                      "layers": layers,
                      "final_norm_scale": torch.ones((H,), dtype=dt,
                                                     device=device)}
    if cfg.norm_type == "layernorm":
        params["final_norm_bias"] = torch.zeros((H,), dtype=dt, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((H, cfg.vocab_size))
    return params


def fuse_layer_stack(params: Params) -> Params:
    """Inference weight fusion, as the JAX ``fuse_layer_stack``: wq/wk/wv
    -> wqkv and w_in/w_gate -> w_in_gate (one GEMM instead of three / two
    per layer)."""
    L = dict(params["layers"])
    if "wq" in L:
        L["wqkv"] = torch.cat([L.pop("wq"), L.pop("wk"), L.pop("wv")], dim=-1)
    if "w_gate" in L and "w_in" in L:
        L["w_in_gate"] = torch.cat([L.pop("w_in"), L.pop("w_gate")], dim=-1)
    return {**params, "layers": L}


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

def _norm(x, scale, bias, cfg: TransformerConfig):
    """RMSNorm / LayerNorm computed in f32, cast back to x's dtype."""
    x32 = x.float()
    if cfg.norm_type == "rmsnorm":
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + cfg.norm_eps)
    else:
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        y = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rotary_embed(x, positions, theta: float):
    """x: [B, S, N, D]; positions: [B, S]. Rotates the pairs (d, d + D/2)
    (llama). The frequencies use the JAX formula exactly,
    ``exp(-arange(half) * log(theta) / half)`` in f32 (``theta ** (-2i/D)``
    rounds differently)."""
    D = x.shape[-1]
    half = D // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    angles = positions.float()[:, :, None] * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _activation(x, gate, cfg: TransformerConfig):
    if cfg.activation == "silu_glu":
        return F.silu(gate) * x
    if cfg.activation == "gelu_glu":
        return F.gelu(gate, approximate="tanh") * x
    if cfg.activation == "relu":
        return F.relu(x)
    if cfg.activation == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def _sm_scale(cfg: TransformerConfig, D: int) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else 1.0 / math.sqrt(D)


def _w(h, w):
    """h @ w in h's dtype (JAX ``_wmat``/``_wrow``: the weight is cast at
    the matmul, so f32 storage runs under bf16 compute)."""
    return h @ w.to(h.dtype)


def attention(q, k, v, mask=None, *, causal: bool = True,
              cfg: TransformerConfig, reference: bool = False):
    """q: [B,S,Nq,D], k/v: [B,S,Nkv,D] -> [B,S,Nq,D]. mask: optional [B, S]
    key-padding mask.

    As in JAX: a ``sparse_attention`` config without a key mask repeats K/V
    over the query-head group (query head h reads kv head h // rep; autograd
    of the repeat sums dK/dV over the group) and goes through the
    block-sparse kernels (B5-B7). Everything else, a sparse config with a
    key mask included, goes through the GQA-native flash kernels (B1-B3),
    which compute the JAX dense branch's function.

    A query row that sees no key (a causal row whose visible keys are all
    masked: left padding) gets O = 0 here, as JAX's Pallas flash kernel
    gives on the TPU (and B2/B3 rely on its p = 0). JAX's XLA branch gives
    such a row the mean of V over all S keys instead (its -1e30 fill makes
    the softmax uniform). That concerns the dense route under a key mask
    on JAX's CPU backend (its Pallas opt-in agrees with the port), and the
    sparse config with a key mask, which JAX sends to XLA on every
    backend. Every row that sees a key agrees with both."""
    sm = _sm_scale(cfg, q.shape[-1])
    if cfg.sparse_attention and mask is None:
        rep = q.shape[2] // k.shape[2]
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        sa = dict(cfg.sparse_attention)
        mode = sa.pop("mode", "fixed")
        return sparse_attention(q, k, v, get_sparsity_config(mode, **sa),
                                causal=causal, sm_scale=sm,
                                reference=reference)
    return flash_attention(q, k, v, causal=causal, sm_scale=sm, kv_mask=mask,
                           fused_backward=cfg.fused_backward,
                           reference=reference)


def check_servable(cfg: TransformerConfig) -> None:
    """The serving path's refusal of what it does not serve yet: a
    block-sparse model (the JAX prefill takes the dense path under a
    length mask; the port's prefill has no mask and would run sparse)."""
    if cfg.sparse_attention:
        raise NotImplementedError(
            "serving a block-sparse model is not ported yet: ROADMAP A10b "
            "(serving a block-sparse model)")


def _paged_attention(q, pool_k, pool_v, tables, index,
                     cfg: TransformerConfig, kv_row, reference: bool = False):
    """Single-token attention against one layer's block pool slices
    ([NB, Nkv, bs, D]) through the block tables [S, MB]; index: per-slot
    sequence lengths [S]. Goes through the paged decode kernel."""
    if q.shape[1] > 1:
        raise NotImplementedError(
            "multi-token spans against the pool (chunked prefill, "
            "speculative verify) are not ported yet: ROADMAP A6e / A6f")
    fn = paged_decode_reference if reference else paged_decode_attention
    return fn(q, pool_k, pool_v, tables, index, kv_row=kv_row,
              sm_scale=_sm_scale(cfg, q.shape[-1]))


def transformer_layer(x, p, cfg: TransformerConfig, *, positions,
                      mask=None, cache=None, block_tables=None,
                      reference: bool = False):
    """One pre-norm block: x + attn(ln1(x)); x + mlp(ln2(x)).

    Without ``cache``: full-sequence (prefill) attention; returns
    (x, (k, v)) with the post-rotary k, v [B, S, nkv, hd] that seed the
    pool. With ``cache=(pool_k, pool_v, seq_lens)`` and ``block_tables``:
    one decode token per slot (x [S, 1, H]) attending the paged pool; the
    pool is NOT written here — the fresh row joins the softmax separately
    and is returned as (k_row, v_row) [S, nkv, 1, hd] for the caller to
    write after all layers (writing it first would count it twice)."""
    B, S, H = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head
    h = _norm(x, p["ln1_scale"], p.get("ln1_bias"), cfg)
    if "wqkv" in p:
        q, k, v = _w(h, p["wqkv"]).split([nh * hd, nkv * hd, nkv * hd],
                                         dim=-1)
    else:
        q, k, v = _w(h, p["wq"]), _w(h, p["wk"]), _w(h, p["wv"])
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)
    if cfg.position_type == "rotary":
        q = rotary_embed(q, positions, cfg.rope_theta)
        k = rotary_embed(k, positions, cfg.rope_theta)
    if cache is not None:
        pool_k, pool_v, seq_lens = cache
        k_row = k.transpose(1, 2).to(pool_k.dtype).contiguous()
        v_row = v.transpose(1, 2).to(pool_v.dtype).contiguous()
        attn = _paged_attention(q.contiguous(), pool_k, pool_v, block_tables,
                                seq_lens, cfg, (k_row, v_row),
                                reference=reference)
        new_kv = (k_row, v_row)
    else:
        attn = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         mask, causal=cfg.causal, cfg=cfg,
                         reference=reference)
        new_kv = (k, v)
    x = x + _w(attn.reshape(B, S, nh * hd), p["wo"])
    h = _norm(x, p["ln2_scale"], p.get("ln2_bias"), cfg)
    if "w_in_gate" in p:
        up, gate = _w(h, p["w_in_gate"]).chunk(2, dim=-1)
    else:
        up = _w(h, p["w_in"])
        gate = _w(h, p["w_gate"]) if "w_gate" in p else None
    return x + _w(_activation(up, gate, cfg), p["w_out"]), new_kv


def _layers(params: Params) -> List[Params]:
    """Per-layer views of the stacked [L, ...] leaves, taken once per pass:
    the backward of ``unbind`` is one stack per leaf, where indexing v[i]
    in the layer loop would build a zero-filled full stack per layer."""
    names = list(params["layers"])
    cols = [torch.unbind(params["layers"][n], 0) for n in names]
    return [dict(zip(names, vals)) for vals in zip(*cols)]


def _head(params):
    """The [H, V] head in the layout x @ head takes (tied: the [V, H]
    table, transposed as a view)."""
    head = params.get("lm_head")
    return params["tok_embed"].t() if head is None else head


def lm_head_logits(x, params):
    """Final projection to f32 vocab logits, the head cast to x's dtype."""
    return _w(x, _head(params)).float()


def forward(params: Params, input_ids, cfg: TransformerConfig, *,
            attention_mask=None, positions=None, return_kv: bool = False,
            return_hidden: bool = False, reference: bool = False):
    """input_ids [B, S] -> f32 logits [B, S, V]; with ``return_kv`` also
    the per-layer post-rotary (k, v), each stacked [L, B, S, nkv, hd];
    with ``return_hidden`` the final-normed hidden states [B, S, H]
    instead of logits (the chunked loss projects them chunk by chunk)."""
    x, kvs = _hidden(params, input_ids, cfg, attention_mask=attention_mask,
                     positions=positions, reference=reference,
                     keep_kv=return_kv)
    if return_hidden:
        return x
    logits = lm_head_logits(x, params)
    if return_kv:
        return logits, (torch.stack([k for k, _ in kvs]),
                         torch.stack([v for _, v in kvs]))
    return logits


# matmul outputs: what JAX's ``dots_saveable`` keeps (a matmul of a 3-D
# activation by a 2-D weight reaches the dispatcher as aten.mm)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _remat_policy(cfg: TransformerConfig):
    """How each layer is rematerialized, as JAX's ``_remat_policy`` picks
    it: None = no checkpoint; otherwise the ``context_fn`` for
    ``torch.utils.checkpoint`` ("full", "save_nothing" and ``remat`` with
    policy "none" save nothing inside the layer: a bare checkpoint).

    "dots_saveable" keeps the matmul outputs and replays the rest,
    including the flash forward (B1), in the backward. "dots_and_attn" also
    keeps B1's O and LSE (the custom op ``dstpu_torch::flash_fwd``), so the
    backward runs straight into B2/B3 without replaying B1. The sparse
    forward (B5) is kept by neither: both replay it, as in JAX."""
    if not cfg.remat and cfg.remat_policy in ("none", None):
        return None
    saved = {"dots_saveable": _DOTS,
             "dots_and_attn": _DOTS | {FLASH_FWD_OP}}.get(cfg.remat_policy)
    if saved is None:
        return noop_context_fn

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


def _hidden(params, input_ids, cfg, *, attention_mask=None, positions=None,
            reference=False, on_layer_kv: Optional[Callable] = None,
            keep_kv: bool = False):
    """Embedding, the layer stack and the final norm. ``on_layer_kv(i, k,
    v)`` consumes each layer's K/V as soon as it exists (the paged prefill
    writes them straight into the pool); ``keep_kv`` returns them. With
    gradients on, each layer runs under the config's remat policy."""
    B, S = input_ids.shape
    x = params["tok_embed"][input_ids.long()].to(cfg.dtype)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    context_fn = _remat_policy(cfg) if torch.is_grad_enabled() else None

    def layer(x_in, lp):
        return transformer_layer(x_in, lp, cfg, positions=positions,
                                 mask=attention_mask, reference=reference)

    kvs = []
    for i, lp in enumerate(_layers(params)):
        if context_fn is not None and on_layer_kv is None and not keep_kv:
            x = checkpoint(lambda a, b: layer(a, b)[0], x, lp,
                           use_reentrant=False, context_fn=context_fn)
            continue
        x, (k, v) = layer(x, lp)
        if on_layer_kv is not None:
            on_layer_kv(i, k, v)
        elif keep_kv:
            kvs.append((k, v))
    x = _norm(x, params["final_norm_scale"], params.get("final_norm_bias"),
              cfg)
    return x, kvs


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def _gold_logit(logits, safe_labels):
    """logits[..., safe_labels]: a gather, exact in f32 like the JAX
    one-hot contraction (the mask selects a single element)."""
    return logits.gather(-1, safe_labels[..., None].long())[..., 0]


def _nll_sum(logits, labels, ignore_index: int):
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    return ((logz - _gold_logit(logits, safe)) * valid).sum(), valid.sum()


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Mean next-token CE over the labels that are not ``ignore_index``.
    logits [B, S, V] f32; labels [B, S] already aligned."""
    tot, cnt = _nll_sum(logits, labels, ignore_index)
    return tot / cnt.clamp_min(1)


def chunked_cross_entropy(x, head, labels, chunk: int,
                          ignore_index: int = -100, tied_embed: bool = False):
    """CE over sequence chunks: each chunk's f32 logits [B, c, V] exist
    only inside a ``torch.utils.checkpoint`` (the head matmul re-runs in
    the backward). x: [B, S, H] final hidden (normed); head: [H, V], or
    with ``tied_embed`` the [V, H] embedding table. c is the largest
    divisor of S that is <= chunk, as in JAX."""
    B, S, _ = x.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    if tied_embed:
        head = head.t()

    def body(xc, lc, w):
        return _nll_sum(_w(xc, w).float(), lc, ignore_index)[0]

    tot = x.new_zeros((), dtype=torch.float32)
    cnt = 0
    for i in range(S // c):
        xc, lc = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            tot = tot + checkpoint(body, xc, lc, head, use_reentrant=False)
        else:
            tot = tot + body(xc, lc, head)
        cnt = cnt + (lc != ignore_index).sum()
    return tot / torch.as_tensor(cnt, device=x.device).clamp_min(1)


def lm_loss(params: Params, batch, cfg: TransformerConfig,
            reference: bool = False):
    """Causal-LM loss: predict token t+1 from the prefix <= t. ``batch``:
    input_ids [B, S]; optional labels (default: the ids shifted left, -100
    at the end) and attention_mask [B, S] (a key mask in attention)."""
    ids = batch["input_ids"]
    labels = batch.get("labels")
    if labels is None:
        labels = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -100)],
                           dim=1)
    mask = batch.get("attention_mask")
    if cfg.loss_chunk and cfg.loss_chunk > 0:
        x = forward(params, ids, cfg, attention_mask=mask, return_hidden=True,
                    reference=reference)
        tied = params.get("lm_head") is None
        head = params["tok_embed"] if tied else params["lm_head"]
        return chunked_cross_entropy(x, head, labels, cfg.loss_chunk,
                                     tied_embed=tied)
    logits = forward(params, ids, cfg, attention_mask=mask,
                     reference=reference)
    return cross_entropy_loss(logits, labels)


# --------------------------------------------------------------------------
# Paged KV cache (serving): block pools [L, NB, nkv, bs, hd] + block tables
# --------------------------------------------------------------------------

def init_paged_cache(cfg: TransformerConfig, num_blocks: int,
                     block_size: int, dtype=None, device=None) -> Params:
    """Block pools [L, NB, n_kv, block_size, head_dim]. Block 0 is the
    reserved TRASH block: null table entries point at it and inactive slots
    write into it; its contents are never read (masked by the lengths).
    ``device=None`` means the card (raises without CUDA), as every entry
    point of the port."""
    shape = (cfg.num_layers, num_blocks, cfg.kv_heads, block_size,
             cfg.dim_per_head)
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_paged(params: Params, input_ids, cfg: TransformerConfig,
                  pools: Params, block_ids, length: Optional[int] = None,
                  reference: bool = False):
    """Prefill ONE request and write its K/V into the slot's blocks.

    input_ids: [1, P] with P a multiple of the block size (the prompt
    bucket); block_ids: [P // bs] pool blocks; length: true prompt length.
    Causal attention over all P rows, no key mask: pad rows land in the
    last blocks, are masked by the slot's length and overwritten as decode
    appends. Returns the f32 logits at position length-1, [1, V].

    The pools are updated IN PLACE (JAX donated them to the jitted step);
    each layer's K/V goes into its blocks as soon as the layer has run."""
    check_servable(cfg)
    B, P = input_ids.shape
    bs = pools["k"].shape[3]
    nblk = P // bs
    length = P if length is None else int(length)
    block_ids = torch.as_tensor(block_ids, device=pools["k"].device).long()

    def to_blocks(a):            # [1, P, nkv, hd] -> [nblk, nkv, bs, hd]
        return a[0].reshape(nblk, bs, a.shape[2], a.shape[3]).transpose(1, 2)

    def write(i, k, v):
        pools["k"][i, block_ids] = to_blocks(k).to(pools["k"].dtype)
        pools["v"][i, block_ids] = to_blocks(v).to(pools["v"].dtype)

    x, _ = _hidden(params, input_ids, cfg, reference=reference,
                   on_layer_kv=write)
    return lm_head_logits(x[:, length - 1], params)


def decode_step_paged(params: Params, tokens, cfg: TransformerConfig,
                      pools: Params, block_tables, seq_lens, active=None,
                      reference: bool = False):
    """One decode step for every slot of a paged serving batch.

    tokens: [S] (one in-flight token per slot); block_tables: [S, MB]
    int32; seq_lens: [S] int32 = rows already in each slot's cache (the
    fresh row is written AT seq_lens); active: [S] bool (None = all).
    Returns f32 logits [S, V].

    The fresh rows of all layers are written after the layer stack, in
    place (JAX donated the pools): one scatter to (block_tables[s,
    len // bs], len % bs). Inactive slots, and slots whose column len // bs
    is past the table (a request that reached max_model_len mid-quantum),
    still compute but write into the trash block 0; duplicate trash writes
    are fine (never read)."""
    S = tokens.shape[0]
    if active is None:
        active = torch.ones((S,), dtype=torch.bool, device=tokens.device)
    x = params["tok_embed"][tokens.long()][:, None].to(cfg.dtype)  # [S,1,H]
    positions = seq_lens[:, None]
    k_rows, v_rows = [], []
    for i, lp in enumerate(_layers(params)):
        x, (k_row, v_row) = transformer_layer(
            x, lp, cfg, positions=positions,
            cache=(pools["k"][i], pools["v"][i], seq_lens),
            block_tables=block_tables, reference=reference)
        k_rows.append(k_row[:, :, 0])
        v_rows.append(v_row[:, :, 0])
    bs = pools["k"].shape[3]
    MB = block_tables.shape[1]
    # a slot at or past its table's capacity (its request reached
    # max_model_len mid-quantum) writes its discarded row into the trash
    # block, as an inactive slot does (JAX drops that row)
    col = seq_lens.long() // bs
    write = active & (col < MB)
    blk = block_tables.long().gather(1, col.clamp(max=MB - 1)[:, None])[:, 0]
    blk = torch.where(write, blk, torch.zeros_like(blk))
    off = torch.where(write, seq_lens.long() % bs, torch.zeros_like(blk))
    # [L, S, nkv, hd] -> [S, L, nkv, hd]: the advanced indices lead
    pools["k"][:, blk, :, off, :] = torch.stack(k_rows, dim=1)
    pools["v"][:, blk, :, off, :] = torch.stack(v_rows, dim=1)
    x = _norm(x, params["final_norm_scale"], params.get("final_norm_bias"),
              cfg)
    return lm_head_logits(x, params)[:, 0, :]


# --------------------------------------------------------------------------
# ModelSpec — what the engines consume
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ModelSpec:
    """The config plus the training and serving functions, bound to it."""
    config: TransformerConfig
    name: str
    init: Callable[..., Params]
    loss_fn: Callable[..., torch.Tensor]
    apply: Callable[..., torch.Tensor]
    init_paged_cache: Callable[..., Params]
    prefill_paged: Callable[..., torch.Tensor]
    decode_step_paged: Callable[..., torch.Tensor]

    def flops_per_token(self) -> float:
        """Approximate train FLOPs/token (6N rule + attention), as JAX."""
        cfg = self.config
        n_params = (cfg.vocab_size * cfg.hidden_size
                    * (1 if cfg.tie_embeddings else 2)
                    + cfg.num_layers * (
                        cfg.hidden_size * (cfg.num_heads + 2 * cfg.kv_heads)
                        * cfg.dim_per_head
                        + cfg.num_heads * cfg.dim_per_head * cfg.hidden_size
                        + cfg.hidden_size * cfg.ffn_dim
                        * (3 if "glu" in cfg.activation else 2)))
        attn = 6 * cfg.num_layers * cfg.hidden_size * cfg.max_seq_len
        return 6.0 * n_params + attn


def make_model(cfg: TransformerConfig, name: str = "transformer") -> ModelSpec:
    return ModelSpec(
        config=cfg,
        name=name,
        init=lambda generator, device, dtype=None:
            init_params(cfg, generator, device, dtype=dtype),
        loss_fn=lambda params, batch: lm_loss(params, batch, cfg),
        apply=lambda params, input_ids, **kw:
            forward(params, input_ids, cfg, **kw),
        init_paged_cache=lambda num_blocks, block_size, dtype=None,
            device=None: init_paged_cache(cfg, num_blocks, block_size,
                                          dtype=dtype, device=device),
        prefill_paged=lambda params, input_ids, pools, block_ids, **kw:
            prefill_paged(params, input_ids, cfg, pools, block_ids, **kw),
        decode_step_paged=lambda params, tokens, pools, block_tables,
            seq_lens, **kw:
            decode_step_paged(params, tokens, cfg, pools, block_tables,
                              seq_lens, **kw),
    )

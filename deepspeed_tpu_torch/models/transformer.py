"""The transformer families, PyTorch port of
``deepspeed_tpu/models/transformer.py``, with the paged serving protocol
(block pools + block tables) and the contiguous cache of one-shot
generation: llama-shaped decoders (rotary, rmsnorm, GLU), and, with JAX's
config fields and leaves, GPT-2 / OPT / CLIP's text tower (learned
positions, layernorm with every bias), BLOOM (ALiBi, an embedding norm),
GPT-Neo (per-layer local windows, an unscaled softmax), GPT-J and GPT-NeoX
(the parallel block, partial and interleaved rotary, a head bias) and the
encoders BERT / RoBERTa / DistilBERT (bidirectional, post-LN blocks,
token types, no final norm). ``models/hf_import`` loads their HF
checkpoints.

Parameters keep the JAX layout at every boundary: a dict with the same
names, ``[in, out]`` matrices and the stacked leading ``L`` dim of
``init_params`` (``models/convert.params_from_numpy`` moves a JAX tree
over). Both the unfused (wq/wk/wv, w_in/w_gate) and the inference-fused
(wqkv, w_in_gate) layer layouts run.

Attention goes through the two hand-written kernels: the flash forward
(``ops/flash_attention``) for every full-sequence pass (the paged
prefill, the contiguous ``prefill``; causal or not, with a key mask) and
the paged decode kernel (``ops/decode_attention``) for each single-token
paged decode step. ALiBi and a local window take plain torch attention
(``plain_attention``, and the gathered pool view in decode), per layer,
because JAX runs both on XLA: no kernel adds a score bias or a band. On
CUDA tensors they launch their kernels; ``reference=True`` calls their
plain versions by name instead (for comparisons), and CPU tensors always
take the plain versions. Two attention paths are plain torch ops because
JAX runs them on XLA, not on a Pallas kernel: the multi-token span against
the pool (``decode_span_paged``: chunked prefill, prefix-cache tails and
the speculative verify step) and the contiguous decode
(``_decode_attention``).

int8 KV (``kv_cache_bits=8``): the caches and pools hold int8 rows with
per-row f32 scales (``ops/quantizer.quantize_rows``); the fresh rows are
computed in the compute dtype and quantized as they are written. The
attention read is JAX's int8 math in plain torch ops: q quantized per
row, integer scores with the q and k scales multiplied in, the
probabilities times the V scales re-quantized to [0, 127] for an integer
PV product (``_decode_attention``, ``_decode_pv``,
``_paged_span_attention``). A paged int8 decode step reads a gathered
view of the pool, as JAX's does: the paged decode kernel (B4) reads float
pools only. The prefill still runs the flash kernel (B1) on the fresh
float K/V and quantizes the rows it writes.

The contiguous cache is updated in place: each decode step writes one row
per layer, O(row). JAX's two-level suffix decode exists because its scan
carry copied the whole ring buffer every token; eager PyTorch has no such
copy, so ``inference/generation`` decodes single-level. The suffix
functions are kept (and held against JAX) as part of the ``ModelSpec``
API.

Training: ``lm_loss`` (full or chunked cross-entropy) is differentiable
through the flash forward and its two backward kernels (B2, B3), or, for
a ``sparse_attention`` config without a key mask, through the block-sparse
kernels (B5-B7, ``ops/sparse_attention``), with layer-level
rematerialization on ``torch.utils.checkpoint`` under the JAX package's
remat policies (``_remat_policy``). Serving a block-sparse model follows
JAX's routing: its prefill (no key mask) runs B5 over the prompt bucket,
its decode and spans attend densely (``prefill_paged``). A sparse model
under float16 raises, as JAX's does on its TPU: B5-B7 take bf16 and f32.

Dropout (``dropout_rate > 0``): JAX's ``_dropout`` on the attention and
FFN outputs before each residual add, on the training path only
(``dropout_seed`` given, see ``_dropout``).

The training extras (JAX's fields): ``activation_quant_bits`` fake-quantizes
(straight-through) the post-norm activations before the attention and
MLP matmuls; on the training path (``lm_loss(train=True)``) random-LTD
runs layers 1 .. L - 2 on the kept tokens of ``ltd_select`` (each kept
token at its true position, the key mask gathered with it, B1-B3 at S =
keep; over ``seq`` the kept tokens of the whole sequence, each rank its
contiguous keep / n of them through the ring), and progressive layer
drop skips the layers ``pld_keep`` marks
(a dropped layer launches nothing). Both take their draws as inputs
(``ltd_draws``, ``pld_coins``: host generators keyed by the caller's
seed), never ``jax.random``'s bits.

Weights are cast to the activation dtype at every matmul, as ``_wmat`` /
``_wrow`` / ``lm_head_logits`` do in JAX, so f32 parameters (a trainer's
storage) run under a bf16 compute config. int8 weights
(``quantize_layer_stack``: per-(layer, out-channel) scales; norms and
embeddings stay float) are either dequantized one layer at a time
(``_maybe_dequant``) or, with ``weight_only_bits=8``, multiplied as int8
cast to the compute dtype with the scale on the result rows
(``ops/quantizer.weight_matmul``).

MoE (``num_experts > 1``, ``mixtral_config``): the layer's FFN is the
expert FFN of ``moe/sharded_moe.moe_ffn`` (top-k gating with capacity,
and with ``use_residual`` JAX's PR-MoE mix with a dense MLP). Training
(``lm_loss(train=True)``) routes with ``capacity_factor``, draws the gate
noise from a generator seeded by the layer's seed, and adds
``moe_aux_loss_weight`` times the sum of the layers' aux losses to the
loss, as JAX's ``lm_loss``; serving and eval route with
``eval_capacity_factor`` and no noise.

Sharding (tensor / expert parallelism): each rank holds the slice of
every leaf that JAX's rules give its device (``logical_axes``,
``parallel/partitioning``), and the model calls ``torch.distributed``
where GSPMD would insert a collective, reading the ambient mesh
(``parallel/context``): an ``all_reduce`` over ``tensor`` after the
row-parallel ``wo`` (with the LoRA ``o`` delta's partial sums in the same
reduction) and ``w_out``, the vocab-parallel embedding (a masked local
lookup, then an ``all_reduce``), vocab-sharded logits assembled by an
``all_reduce`` of a zero-filled full-vocab buffer, and the MoE combine
(over ``tensor`` and ``expert``). A rank's head counts are its shard's
(the projections' widths); its pools hold ``kv_heads / tp`` heads.
Without a mesh (or at tp = ep = 1) no collective runs. Serving reduces
in place. Where autograd records (training: the params need grads) the
same sums are collectives autograd differentiates: the inputs of the column-parallel projections (``wq``,
``wk``, ``wv``, ``w_in``, ``w_gate``, the head) enter through
``copy_to_tensor``, the row-parallel outputs, the embedding and the
logits leave through ``reduce_from_tensor``, and with
``tp_overlap_chunks > 1`` the row-parallel sum is cut along the sequence
(``parallel/partitioning.row_parallel_matmul``).

The families run on every mesh axis, as JAX's do through GSPMD. Over
``tensor``: the column biases (``bq`` / ``bk`` / ``bv``, ``b_in``) are
sliced with their columns, the row biases (``bo``, ``b_out``) are whole
and added once, after the row-parallel sum; the vocab-sharded
``lm_head_bias`` takes its place in the assembled logits
(``_full_vocab``); ALiBi's slopes are those of the model's heads at the
rank's head offset (``_alibi_term``). Over ``seq``: learned positions
and token types are read at the rank's global positions; a windowed
layer gathers K/V over ``seq`` and runs JAX's band softmax on the rank's
query rows (``_seq_gathered_attention``), and so does an ALiBi layer
under a key mask (JAX's XLA branch); an ALiBi layer without one takes
the ring without the bias, as JAX's ring does (ROADMAP C11). A
block-sparse model with ALiBi runs the sparse kernels without the bias
(JAX's routing, ROADMAP C12), and its windowed layers the dense band.

What the port leaves out raises ``NotImplementedError`` naming its
ROADMAP item: under ``pipe`` a family's token types, embedding norm,
``final_norm=False`` or local windows, which JAX's pipeline drops
(``check_family_mesh``, A11 (the leaves JAX's pipeline drops)). A
position past the learned table clamps to its last row, as JAX's gather
does, so no out-of-range index reaches the card.
"""

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.comm.comm import all_gather as comm_all_gather
from deepspeed_tpu_torch.moe.sharded_moe import layer_scope, moe_ffn
from deepspeed_tpu_torch.ops.decode_attention import (
    paged_decode_attention, paged_decode_reference)
from deepspeed_tpu_torch.ops.flash_attention import (FLASH_FWD_OP,
                                                     flash_attention)
from deepspeed_tpu_torch.ops.quantizer import (fake_quant, int8_matmul,
                                               quantize_rows, weight_matmul)
from deepspeed_tpu_torch.ops.ring_attention import ring_attention_local
from deepspeed_tpu_torch.ops.sparse_attention import (get_sparsity_config,
                                                      sparse_attention)
from deepspeed_tpu_torch.parallel.context import (all_reduce, axis_index,
                                                  axis_size,
                                                  batch_row,
                                                  copy_to_tensor,
                                                  gather_along,
                                                  gather_params,
                                                  reduce_from_tensor,
                                                  seq_offset,
                                                  seq_parallel_degree)
from deepspeed_tpu_torch.parallel.partitioning import row_parallel_matmul

Params = Dict[str, Any]
_NEG = -1e30                    # JAX's mask fill: exp(-1e30 - max) is 0


REMAT_POLICIES = ("none", "full", "save_nothing", "dots_saveable",
                  "dots_and_attn", "dots_with_no_batch_dims", "offload_dots")


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
    position_type: str = "learned"              # learned | rotary | alibi | none
    activation: str = "gelu"                    # gelu | silu_glu | gelu_glu | ...
    norm_type: str = "layernorm"                # layernorm | rmsnorm
    norm_eps: float = 1e-5
    # a layernorm after the token embedding (BLOOM's, BERT's)
    embed_norm: bool = False
    # encoders (BERT / RoBERTa / DistilBERT): bidirectional attention,
    # post-LN blocks, segment (token-type) embeddings
    causal: bool = True
    norm_style: str = "pre"                     # pre | post
    type_vocab_size: int = 0                    # > 0: tok_type_embed
    # GPT-J / GPT-NeoX: x + attn(ln1(x)) + mlp(ln2(x)) in one residual,
    # rotary over the first rotary_dim dims, GPT-J's interleaved pairs
    parallel_block: bool = False
    rotary_dim: Optional[int] = None
    rotary_interleaved: bool = False
    head_bias: bool = False                     # lm_head_bias (GPT-J)
    qkv_bias: bool = True                       # layernorm models' biases
    attn_out_bias: Optional[bool] = None        # bo without bq/bk/bv (Neo)
    final_norm: bool = True                     # False: BERT (post-LN)
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
    # quantized serving: int8 KV cache and pools (0 = float, 8 = int8:
    # payloads with per-row f32 scales, int8 attention math); int8 layer
    # weights ({"q", "scale"} leaves from ``quantize_layer_stack``),
    # dequantized one layer at a time before its matmuls, or with
    # ``weight_only_bits=8`` kept int8 through the matmul (the scale in
    # the epilogue)
    kv_cache_bits: int = 0
    quantized_weights: bool = False
    weight_only_bits: int = 0
    # MoE (JAX's names and defaults): top-k gating over num_experts with
    # per-expert capacity ceil(T / E * factor) >= min_capacity
    # (eval_capacity_factor when serving), PR-MoE's dense residual mix
    # (use_residual); the aux loss weight and the gate noise belong to
    # training
    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None     # None | Jitter | RSample
    drop_tokens: bool = True
    use_residual: bool = False
    moe_aux_loss_weight: float = 0.01
    # dropout on the attention and FFN outputs (the training path only)
    dropout_rate: float = 0.0
    # the row-parallel projections' tensor-axis sum in this many pieces
    # along the sequence (``transformer.tp_overlap_chunks``; 0 / 1: one)
    tp_overlap_chunks: int = 0
    # per-layer local-attention windows (length num_layers; 0 = global):
    # key j is visible to query i iff i - j < window
    attn_windows: Optional[Tuple[int, ...]] = None
    sparse_attention: Optional[Dict[str, Any]] = None
    # the training extras (JAX's fields): random-LTD on layers 1 .. L - 2
    # at random_ltd_keep tokens, the STE fake-quant of the post-norm
    # activations at activation_quant_bits (0: off), progressive layer
    # drop (layer i kept with probability 1 - (i + 1) / L * (1 - theta))
    random_ltd: bool = False
    random_ltd_keep: int = 0
    activation_quant_bits: int = 0
    progressive_layer_drop: bool = False

    def __post_init__(self):
        if self.kv_cache_bits not in (0, 8):
            raise ValueError(f"kv_cache_bits={self.kv_cache_bits}: 0 (float "
                             "cache) or 8 (int8)")
        if self.weight_only_bits not in (0, 8):
            raise ValueError(f"weight_only_bits={self.weight_only_bits}: 0 "
                             "or 8 (int8)")
        if self.position_type not in ("learned", "rotary", "alibi", "none"):
            raise ValueError(f"position_type={self.position_type!r}: "
                             "learned, rotary, alibi or none")
        if self.norm_style not in ("pre", "post"):
            raise ValueError(f"norm_style={self.norm_style!r}: pre or post")
        if self.attn_windows and len(self.attn_windows) != self.num_layers:
            raise ValueError(f"attn_windows has {len(self.attn_windows)} "
                             f"entries for {self.num_layers} layers")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate={self.dropout_rate}: in [0, 1)")
        if self.num_experts > 1 and not 1 <= self.top_k <= self.num_experts:
            raise ValueError(f"top_k={self.top_k}: between 1 and "
                             f"num_experts={self.num_experts}")
        if self.noisy_gate_policy not in (None, "Jitter", "RSample"):
            raise ValueError(f"noisy_gate_policy={self.noisy_gate_policy!r}"
                             ": None, Jitter or RSample")
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


def gpt2_config(size: str = "125m", **overrides) -> TransformerConfig:
    """GPT-2 (learned positions, gelu, layernorm with every bias, tied
    head), JAX's ``gpt2_config``."""
    dims = {
        "125m": dict(hidden_size=768, num_layers=12, num_heads=12),
        "350m": dict(hidden_size=1024, num_layers=24, num_heads=16),
        "760m": dict(hidden_size=1536, num_layers=24, num_heads=16),
        "1.3b": dict(hidden_size=2048, num_layers=24, num_heads=32),
    }[size]
    base = dict(vocab_size=50257, max_seq_len=1024, position_type="learned",
                activation="gelu", norm_type="layernorm", tie_embeddings=True)
    base.update(dims)
    base.update(overrides)
    return TransformerConfig(**base)


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


def mixtral_config(size: str = "8x7b", **overrides) -> TransformerConfig:
    """Mixtral-style MoE (top-2 of 8 experts), JAX's ``mixtral_config``."""
    dims = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=4, num_kv_heads=2,
                     intermediate_size=512, vocab_size=32000, max_seq_len=2048,
                     num_experts=4),
        "8x7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                     num_kv_heads=8, intermediate_size=14336, vocab_size=32000,
                     max_seq_len=4096, num_experts=8),
    }[size]
    base = dict(position_type="rotary", activation="silu_glu",
                norm_type="rmsnorm", tie_embeddings=False, top_k=2)
    base.update(dims)
    base.update(overrides)
    return TransformerConfig(**base)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device, dtype: Optional[torch.dtype] = None,
                keep: Optional[Callable] = None) -> Params:
    """Seeded on-device init with the JAX init's distribution: normal with
    std 0.02, ``0.02 / sqrt(2L)`` for the residual out-projections (wo,
    w_out, moe_w_out), ones for norm scales, zeros for PR-MoE's
    ``moe_coef``. The numbers differ from JAX's (another generator);
    parity tests move a JAX tree over with ``convert.params_from_numpy``
    instead. ``keep(path, tensor)``: applied to each leaf as soon as it
    is drawn (path "tok_embed", "layers/wq", ...), e.g. to keep a rank's
    shard only, so the whole tree is never resident at once."""
    H, L = cfg.hidden_size, cfg.num_layers
    nh, nkv, hd, Fd = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head, cfg.ffn_dim
    E = cfg.num_experts
    dt = dtype or cfg.param_dtype
    std = 0.02
    out_scale = std / math.sqrt(2 * L)
    keep = keep or (lambda path, t: t)

    def normal(shape, scale=std):
        t = torch.empty(shape, dtype=dt, device=device)
        return t.normal_(0.0, scale, generator=generator)

    def const(shape, fill):
        return torch.full(shape, fill, dtype=dt, device=device)

    # drawn in a fixed order: a dense model's is that of earlier slices
    moe = E > 1
    dense_mlp = not moe or cfg.use_residual
    draws = [("ln1_scale", lambda: const((L, H), 1.0)),
             ("ln2_scale", lambda: const((L, H), 1.0)),
             ("wq", lambda: normal((L, H, nh * hd))),
             ("wk", lambda: normal((L, H, nkv * hd))),
             ("wv", lambda: normal((L, H, nkv * hd))),
             ("wo", lambda: normal((L, nh * hd, H), out_scale))]
    if dense_mlp:
        draws += [("w_in", lambda: normal((L, H, Fd))),
                  ("w_out", lambda: normal((L, Fd, H), out_scale))]
    if moe:
        draws += [("wg", lambda: normal((L, H, E))),
                  ("moe_w_in", lambda: normal((L, E, H, Fd))),
                  ("moe_w_out", lambda: normal((L, E, Fd, H), out_scale))]
        if "glu" in cfg.activation:
            draws.append(("moe_w_gate", lambda: normal((L, E, H, Fd))))
        if cfg.use_residual:
            draws.append(("moe_coef", lambda: const((L, H, 2), 0.0)))
    if "glu" in cfg.activation and dense_mlp:
        draws.append(("w_gate", lambda: normal((L, H, Fd))))
    if cfg.norm_type == "layernorm":
        draws += [("ln1_bias", lambda: const((L, H), 0.0)),
                  ("ln2_bias", lambda: const((L, H), 0.0))]
        draws += [(name, lambda n=n: const((L, n), 0.0))
                  for name, n in _layer_biases(cfg, dense_mlp)]
    layers = {name: keep("layers/" + name, fn()) for name, fn in draws}
    params: Params = {"tok_embed": keep("tok_embed",
                                        normal((cfg.vocab_size, H))),
                      "layers": layers}
    if cfg.final_norm:
        params["final_norm_scale"] = keep("final_norm_scale",
                                          const((H,), 1.0))
        if cfg.norm_type == "layernorm":
            params["final_norm_bias"] = keep("final_norm_bias",
                                             const((H,), 0.0))
    if not cfg.tie_embeddings:
        params["lm_head"] = keep("lm_head", normal((H, cfg.vocab_size)))
    # the family leaves, drawn after those of earlier slices
    if cfg.position_type == "learned":
        params["pos_embed"] = keep("pos_embed",
                                   normal((cfg.max_seq_len, H), 0.01))
    if cfg.type_vocab_size:
        params["tok_type_embed"] = keep(
            "tok_type_embed", normal((cfg.type_vocab_size, H), 0.01))
    if cfg.head_bias and not cfg.tie_embeddings:
        params["lm_head_bias"] = keep("lm_head_bias",
                                      const((cfg.vocab_size,), 0.0))
    if cfg.embed_norm:
        params["embed_norm_scale"] = keep("embed_norm_scale",
                                          const((H,), 1.0))
        if cfg.norm_type == "layernorm":
            params["embed_norm_bias"] = keep("embed_norm_bias",
                                             const((H,), 0.0))
    return params


def _layer_biases(cfg: TransformerConfig, dense_mlp: bool):
    """The layer stack's bias leaves and their widths, JAX's rule: a
    layernorm model carries bq / bk / bv with ``qkv_bias``, bo with
    ``qkv_bias`` or ``attn_out_bias``, and b_in / b_out on a dense MLP."""
    if cfg.norm_type != "layernorm":
        return []
    nq, nkv = cfg.num_heads * cfg.dim_per_head, cfg.kv_heads * cfg.dim_per_head
    out = []
    if cfg.qkv_bias:
        out += [("bq", nq), ("bk", nkv), ("bv", nkv)]
    if cfg.qkv_bias or cfg.attn_out_bias:
        out.append(("bo", cfg.hidden_size))
    if dense_mlp:
        out += [("b_in", cfg.ffn_dim), ("b_out", cfg.hidden_size)]
    return out


_BIAS_AXES = {"bq": ("layers", "qkv"), "bk": ("layers", "qkv"),
              "bv": ("layers", "qkv"), "bo": ("layers", "unmodeled"),
              "b_in": ("layers", "mlp"), "b_out": ("layers", "unmodeled")}


def logical_axes(cfg: TransformerConfig) -> Params:
    """The logical axes of every leaf of the unfused tree ``init_params``
    makes, JAX's ``logical_axes`` for the leaves the port has
    (``parallel/partitioning.RULES`` maps them to mesh axes)."""
    layers = {
        "ln1_scale": ("layers", "unmodeled"),
        "ln2_scale": ("layers", "unmodeled"),
        "wq": ("layers", "embed", "qkv"),
        "wk": ("layers", "embed", "qkv"),
        "wv": ("layers", "embed", "qkv"),
        "wo": ("layers", "heads", "embed"),
        "w_in": ("layers", "embed", "mlp"),
        "w_out": ("layers", "mlp", "embed"),
    }
    if cfg.num_experts > 1:
        layers["wg"] = ("layers", "embed", None)
        layers["moe_w_in"] = ("layers", "expert", "embed", "mlp")
        layers["moe_w_out"] = ("layers", "expert", "mlp", "embed")
        if "glu" in cfg.activation:
            layers["moe_w_gate"] = ("layers", "expert", "embed", "mlp")
        if not cfg.use_residual:
            del layers["w_in"], layers["w_out"]
        else:
            layers["moe_coef"] = ("layers", "embed", None)
    if "glu" in cfg.activation and "w_in" in layers:
        layers["w_gate"] = ("layers", "embed", "mlp")
    if cfg.norm_type == "layernorm":
        layers["ln1_bias"] = ("layers", "unmodeled")
        layers["ln2_bias"] = ("layers", "unmodeled")
        for name, _ in _layer_biases(cfg, "w_in" in layers):
            layers[name] = _BIAS_AXES[name]
    axes: Params = {"tok_embed": ("vocab", "embed"), "layers": layers}
    if cfg.final_norm:
        axes["final_norm_scale"] = ("unmodeled",)
        if cfg.norm_type == "layernorm":
            axes["final_norm_bias"] = ("unmodeled",)
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.position_type == "learned":
        axes["pos_embed"] = (None, "embed")
    if cfg.type_vocab_size:
        axes["tok_type_embed"] = (None, "embed")
    if cfg.head_bias and not cfg.tie_embeddings:
        axes["lm_head_bias"] = ("vocab",)
    if cfg.embed_norm:
        axes["embed_norm_scale"] = ("unmodeled",)
        if cfg.norm_type == "layernorm":
            axes["embed_norm_bias"] = ("unmodeled",)
    return axes


def family_leaves(cfg: TransformerConfig) -> List[str]:
    """The leaves of this config that llama-shaped decoders lack (biases,
    position and token-type tables, the embedding norm, the head bias),
    and the layer features they lack (ALiBi, windows, post-LN, the
    parallel block, partial or interleaved rotary, bidirectional
    attention, no final norm)."""
    axes = logical_axes(cfg)
    base = {"ln1_scale", "ln2_scale", "ln1_bias", "ln2_bias", "wq", "wk",
            "wv", "wo", "w_in", "w_out", "w_gate", "wg", "moe_w_in",
            "moe_w_out", "moe_w_gate", "moe_coef"}
    out = [f"layers/{k}" for k in axes["layers"] if k not in base]
    out += [k for k in axes if k not in ("tok_embed", "layers", "lm_head",
                                         "final_norm_scale",
                                         "final_norm_bias")]
    features = {"alibi": cfg.position_type == "alibi",
                "attn_windows": bool(cfg.attn_windows),
                "norm_style=post": cfg.norm_style == "post",
                "parallel_block": cfg.parallel_block,
                "rotary_dim": bool(cfg.rotary_dim),
                "rotary_interleaved": cfg.rotary_interleaved,
                "causal=False": not cfg.causal,
                "final_norm=False": not cfg.final_norm}
    return out + [k for k, on in features.items() if on]


def pipe_dropped(cfg: TransformerConfig) -> List[str]:
    """What JAX's pipeline leaves out of this config: its ``embed_fn``
    adds only the token and learned-position rows (no token types, no
    embedding norm), its stage scan passes no window, and its head reads
    ``final_norm_scale`` whatever ``final_norm`` says
    (``deepspeed_tpu/models/pipeline_wrapper.py``)."""
    dropped = {"tok_type_embed": bool(cfg.type_vocab_size),
               "embed_norm": cfg.embed_norm,
               "final_norm=False": not cfg.final_norm,
               "attn_windows": bool(cfg.attn_windows)}
    return [k for k, on in dropped.items() if on]


def check_family_mesh(cfg: TransformerConfig, plan) -> None:
    """A family runs on every mesh axis; over ``pipe`` (``plan.pipe`` >
    1) the features JAX's pipeline drops (``pipe_dropped``) raise naming
    their ROADMAP label, where JAX would compute another model."""
    dropped = pipe_dropped(cfg)
    if plan.pipe > 1 and dropped:
        raise NotImplementedError(
            f"{dropped} over pipe={plan.pipe} is not ported: JAX's pipeline "
            "drops them. ROADMAP A11 (the leaves JAX's pipeline drops)")


def quantized_logical_axes(cfg: TransformerConfig,
                           base_axes: Optional[Params] = None) -> Params:
    """``logical_axes`` for the ``quantize_layer_stack`` structure, as
    JAX's: a >= 3-dim layer leaf becomes {"q": its axes, "scale": (layers,
    None, ..., its out axis)}, so the scales shard with their out
    columns."""
    axes = dict(base_axes if base_axes is not None else logical_axes(cfg))

    def one(a):
        if a is None or len(a) < 3:
            return a
        return {"q": a, "scale": (a[0],) + (None,) * (len(a) - 2) + (a[-1],)}
    axes["layers"] = {k: one(v) for k, v in axes["layers"].items()}
    return axes


def paged_cache_logical_axes(cfg: Optional[TransformerConfig] = None
                             ) -> Params:
    """The block pools shard over kv heads like the weights (JAX's
    ``paged_cache_logical_axes``); the block dim stays whole (any block
    serves any sequence)."""
    out = {"k": ("layers", None, "heads", None, None),
           "v": ("layers", None, "heads", None, None)}
    if cfg is not None and cfg.kv_cache_bits == 8:
        out["k_scale"] = ("layers", None, "heads", None)
        out["v_scale"] = ("layers", None, "heads", None)
    return out


def _local_kv_heads(cfg: TransformerConfig) -> int:
    """This rank's kv heads: ``kv_heads / tp`` under the ambient mesh."""
    tp = axis_size("tensor")
    if cfg.kv_heads % tp:
        raise ValueError(f"kv_heads={cfg.kv_heads} does not split over "
                         f"tensor parallel degree {tp}")
    return cfg.kv_heads // tp


def fuse_layer_stack(params: Params) -> Params:
    """Inference weight fusion, as the JAX ``fuse_layer_stack``: wq/wk/wv
    -> wqkv (bq/bk/bv -> bqkv) and w_in/w_gate -> w_in_gate (one GEMM
    instead of three / two per layer; not with a b_in, as in JAX). A MoE
    stack stays unfused, as in JAX (PR-MoE reads w_in / w_gate in its
    residual branch). The biases stay float through
    ``quantize_layer_stack`` (2-dim leaves)."""
    if "wg" in params["layers"]:
        return params
    L = dict(params["layers"])
    if "wq" in L:
        L["wqkv"] = torch.cat([L.pop("wq"), L.pop("wk"), L.pop("wv")], dim=-1)
        if "bq" in L:
            L["bqkv"] = torch.cat([L.pop("bq"), L.pop("bk"), L.pop("bv")],
                                  dim=-1)
    if "w_gate" in L and "w_in" in L and "b_in" not in L:
        L["w_in_gate"] = torch.cat([L.pop("w_in"), L.pop("w_gate")], dim=-1)
    return {**params, "layers": L}


def unfuse_layer_stack(params: Params, cfg: TransformerConfig) -> Params:
    """Inverse of ``fuse_layer_stack`` (JAX ``unfuse_layer_stack``): the
    quantized engines run the per-projection layout."""
    L = dict(params["layers"])
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head
    if "wqkv" in L:
        w = L.pop("wqkv")
        L["wq"] = w[..., :nh * hd]
        L["wk"] = w[..., nh * hd:(nh + nkv) * hd]
        L["wv"] = w[..., (nh + nkv) * hd:]
        if "bqkv" in L:
            b = L.pop("bqkv")
            L["bq"] = b[..., :nh * hd]
            L["bk"] = b[..., nh * hd:(nh + nkv) * hd]
            L["bv"] = b[..., (nh + nkv) * hd:]
    if "w_in_gate" in L:
        w = L.pop("w_in_gate")
        half = w.shape[-1] // 2
        L["w_in"], L["w_gate"] = w[..., :half], w[..., half:]
    return {**params, "layers": L}


def quantize_leaf(w):
    """One layer-stack leaf to int8 plus per-(layer, out-channel) f32
    scales, JAX's rule: a >= 3-dim leaf ([L, In, Out], the gate [L, H, E],
    MoE stacks [L, E, In, Out] with one scale per (layer, out column)
    shared across experts) becomes {"q", "scale"}; norms ([L, H]), int8
    and already quantized leaves stay as they are."""
    if isinstance(w, dict) or w.dim() < 3 or w.dtype == torch.int8:
        return w
    w32 = w.float()
    amax = w32.abs().amax(dim=tuple(range(1, w.dim() - 1)), keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return {"q": q.to(torch.int8).contiguous(), "scale": scale}


def quantize_layer_stack(params: Params, bits: int = 8) -> Params:
    """The stacked layer weights to int8 (``quantize_leaf``), as JAX's
    ``quantize_layer_stack``: everything outside the layer stack stays
    float."""
    if bits != 8:
        raise ValueError("weight-only inference quantization supports int8")
    return {**params, "layers": {k: quantize_leaf(v)
                                 for k, v in params["layers"].items()}}


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


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """ALiBi's per-head slopes, JAX's ``alibi_slopes`` (BLOOM's rule: a
    geometric series from the closest power of two, the odd terms of the
    next series filling a head count that is not one), f32 [n_heads]."""
    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]
    if math.log2(n_heads).is_integer():
        vals = pow2(n_heads)
    else:
        cp2 = 2 ** int(math.floor(math.log2(n_heads)))
        vals = pow2(cp2) + pow2(2 * cp2)[0::2][: n_heads - cp2]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def rotary_freqs(half: int, theta: float, device) -> torch.Tensor:
    """The rotation frequencies ``exp(-arange(half) * log(theta) / half)``
    in f32, JAX's formula. The arguments of the exp are bit-equal to
    JAX's; ``torch.exp`` and XLA's ``exp`` may part in the last bit of
    the result (ROADMAP C16)."""
    return torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                   device=device)
                     * (math.log(theta) / half))


def rotary_embed(x, positions, theta: float, rotary_dim: Optional[int] = None,
                 interleaved: bool = False):
    """x: [B, S, N, D]; positions: [B, S]. Rotates the pairs (d, d + r/2)
    of the first r = ``rotary_dim`` (default D) dims (llama, GPT-NeoX's
    partial rotary), or with ``interleaved`` the pairs (2d, 2d + 1)
    (GPT-J's rotate-every-two); dims past r pass through. The frequencies
    use the JAX formula exactly, ``exp(-arange(r/2) * log(theta) / (r/2))``
    in f32 (``theta ** (-2i/r)`` rounds differently)."""
    B, S, N, D = x.shape
    rd = rotary_dim if rotary_dim else D
    if rd % 2:
        raise ValueError(f"rotary_dim must be even, got {rd} (the rotation "
                         "pairs dims)")
    half = rd // 2
    freqs = rotary_freqs(half, theta, x.device)
    angles = positions.float()[:, :, None] * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if interleaved:
        x1 = x[..., 0:rd:2].float()
        x2 = x[..., 1:rd:2].float()
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(B, S, N, rd)
    else:
        x1 = x[..., :half].float()
        x2 = x[..., half:rd].float()
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(x.dtype)
    return out if rd == D else torch.cat([out, x[..., rd:]], dim=-1)


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
    the matmul, so f32 storage runs under bf16 compute). A {"q", "scale"}
    leaf (``weight_only_bits=8``) is multiplied as int8 with its scale in
    the epilogue."""
    if isinstance(w, dict):
        return weight_matmul(h, w["q"], w["scale"])
    return h @ w.to(h.dtype)


def _graph(*ts) -> bool:
    """Autograd records an op on ``ts``: the training path's collectives
    then differentiate (serving, whose params need no grad, reduces in
    place)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def _to_tensor_region(h):
    """A replicated activation entering column-parallel projections: with
    a graph, ``copy_to_tensor`` (its grad summed over ``tensor``)."""
    return copy_to_tensor(h) if _graph(h) else h


def _w_row(h, w, delta=None, chunks: int = 0):
    """The row-parallel twin of ``_w`` (``wo``, ``w_out``: their IN dim
    is sharded over ``tensor``): this rank's partial product, summed over
    the tensor axis by one ``all_reduce`` (in place when serving; with a
    graph, or with ``chunks`` > 1, through ``row_parallel_matmul``,
    ``chunks`` pieces along the sequence). An int8 leaf's per-out-channel
    scale multiplies after the sum (it factors out of the contraction, as
    JAX's ``_wrow`` applies it). ``delta``: the LoRA ``o`` delta's partial
    sums (its A is sharded on heads too), reduced in the same
    ``all_reduce`` and added after the projection, as JAX adds it."""
    scale = None
    if isinstance(w, dict):
        w, scale = w["q"], w["scale"]
    if delta is None and (_graph(h, w) or chunks > 1):
        y = row_parallel_matmul(h, w.to(h.dtype), chunks=chunks)
        if scale is not None:
            y = y * scale.reshape(scale.shape[-1:]).to(h.dtype)
        return y
    y = h @ w.to(h.dtype)
    if delta is not None and axis_size("tensor") > 1:
        n = y.shape[-1]
        both = all_reduce(torch.cat([y, delta], dim=-1), "tensor")
        y, delta = both[..., :n], both[..., n:]
    else:
        all_reduce(y, "tensor")
    if scale is not None:
        y = y * scale.reshape(scale.shape[-1:]).to(h.dtype)
    return y if delta is None else y + delta


def _maybe_dequant(p, cfg: TransformerConfig):
    """One layer's {"q", "scale"} leaves -> the compute dtype, JAX's
    ``_maybe_dequant``: only that layer's dequantized weights are ever
    live. With ``weight_only_bits=8`` the dense projections stay int8
    (``_w`` multiplies them) and only the MoE leaves dequantize: the
    expert stacks, as in JAX (their dispatch has no per-column epilogue),
    and the gate ``wg``, which JAX leaves int8 where its ``moe_ffn``
    cannot read it (a defect of the reference: its weight_bits engine
    fails on a MoE model)."""
    if not cfg.quantized_weights:
        return p
    epilogue = cfg.weight_only_bits == 8

    def one(k, v):
        if not isinstance(v, dict) or (
                epilogue and not k.startswith("moe_") and k != "wg"):
            return v
        return v["q"].to(cfg.dtype) * v["scale"].to(cfg.dtype)
    return {k: one(k, v) for k, v in p.items()}


def _lora_delta(h, ab, idx):
    """Gathered multi-adapter LoRA delta: (h @ A[idx]) @ B[idx], JAX's
    ``_lora_delta``.

    ``ab``: one layer's slot tables (A [NS, In, r], B [NS, r, Out]);
    ``idx``: [B] adapter slot per batch row. The gather and the batched
    products serve a batch whose rows use DIFFERENT adapters in one
    pass (slot 0 is the all-zero null adapter: base-model rows add an
    exact zero). Rank is tiny, so the product goes through the rank
    bottleneck first."""
    a, b = ab
    idx = idx.long()
    ga = a.index_select(0, idx).to(h.dtype)            # [B, In, r]
    gb = b.index_select(0, idx).to(h.dtype)            # [B, r, Out]
    return torch.bmm(torch.bmm(h, ga), gb)


def _window(cfg: TransformerConfig, i: int) -> Optional[int]:
    """Layer i's local-attention window, None for a global layer (JAX's
    unrolled ``cfg.attn_windows[i] or None``)."""
    return (cfg.attn_windows[i] or None) if cfg.attn_windows else None


@functools.lru_cache(maxsize=None)
def _slopes_on(nq: int, device) -> torch.Tensor:
    """``alibi_slopes(nq)`` on ``device``, made once (not a host-to-device
    copy a layer a step)."""
    return alibi_slopes(nq, device=device)


def _alibi_term(nq: int, rel, shape):
    """ALiBi's additive score term: the slopes of this rank's ``nq``
    heads, viewed as ``shape`` (which places the heads), times ``rel``
    (key position minus query position, f32). The slopes are those of
    the model's ``nq * tp`` heads (BLOOM's series depends on the head
    count) at the rank's head offset ``axis_index("tensor") * nq``, as
    JAX's GSPMD program sees every head."""
    tp = axis_size("tensor")
    slopes = _slopes_on(nq * tp, rel.device)
    if tp > 1:
        off = axis_index("tensor") * nq
        slopes = slopes[off:off + nq]
    return slopes.reshape(shape) * rel


def plain_attention(q, k, v, mask=None, *, causal: bool, cfg: TransformerConfig,
                    window: Optional[int] = None, q_offset: int = 0):
    """JAX's XLA branch of ``attention`` in plain torch ops: K/V repeated
    over the query-head group, f32 scores times the scale, ALiBi's
    ``slope * (k - q)``, then the causal, band (``i - j < window``) and
    key masks filled with -1e30, the softmax, and P V in q's dtype. ALiBi
    and local windows run here, on the card too, because JAX runs them on
    XLA (its flash kernel has no score bias and no band): no kernel of
    the port adds either. ``q_offset``: the position of q's first row
    among k's (a ``seq`` rank's query rows against the gathered keys)."""
    B, Sq, Nq, D = q.shape
    rep = Nq // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bsnd,btnd->bnst", q, k).float() * _sm_scale(cfg, D)
    qpos = torch.arange(q_offset, q_offset + Sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    if cfg.position_type == "alibi":
        rel = (kpos[None, :] - qpos[:, None]).float()
        scores = scores + _alibi_term(Nq, rel, (1, Nq, 1, 1))
    if causal:
        scores = scores.masked_fill(~(kpos[None, :] <= qpos[:, None]), _NEG)
    if window:
        scores = scores.masked_fill(
            ~((qpos[:, None] - kpos[None, :]) < window), _NEG)
    if mask is not None:
        scores = scores.masked_fill(~(mask != 0)[:, None, None, :], _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)


def attention(q, k, v, mask=None, *, causal: bool = True,
              cfg: TransformerConfig, reference: bool = False,
              window: Optional[int] = None):
    """q: [B,S,Nq,D], k/v: [B,S,Nkv,D] -> [B,S,Nq,D]. mask: optional [B, S]
    key-padding mask; ``causal`` False for an encoder (the kernels take
    it, with the key mask). ``window``: this layer's local window (None:
    global).

    The route, JAX's order per layer:

    - over a ``seq`` axis of more than one rank (q / k / v this rank's
      piece of the sequence): a windowed layer, and an ALiBi layer under
      a key mask, gather K/V over ``seq`` and run ``plain_attention`` on
      the rank's query rows at their global positions (JAX's XLA branch:
      the band, or the bias, over the whole sequence); everything else
      is the ring (``ops/ring_attention.ring_attention_local``: B1-B3 per
      pair of pieces), ahead of the sparse branch, as in JAX; under a
      key mask too (JAX's XLA branch takes that case; the rows that see a
      key agree), and for ALiBi without a mask, which JAX's ring runs
      without the bias (ROADMAP C11);
    - a window takes ``plain_attention`` (JAX's XLA branch, the band): a
      global layer of a windowed model keeps its kernel, as JAX's
      unrolled stack does;
    - a ``sparse_attention`` config without a key mask repeats K/V over
      the query-head group (query head h reads kv head h // rep; autograd
      of the repeat sums dK/dV over the group) and goes through the
      block-sparse kernels (B5-B7), ALiBi's bias left out as JAX's sparse
      branch leaves it out (ROADMAP C12);
    - ALiBi takes ``plain_attention`` (the bias);
    - everything else, a sparse config with a key mask included, goes
      through the GQA-native flash kernels (B1-B3), which compute the JAX
      dense branch's function.

    A query row that sees no key (a causal row whose visible keys are all
    masked: left padding) gets O = 0 here, as JAX's Pallas flash kernel
    gives on the TPU (and B2/B3 rely on its p = 0). JAX's XLA branch gives
    such a row the mean of V over all S keys instead (its -1e30 fill makes
    the softmax uniform). That concerns the dense route under a key mask
    on JAX's CPU backend (its Pallas opt-in agrees with the port), and the
    sparse config with a key mask, which JAX sends to XLA on every
    backend. Every row that sees a key agrees with both."""
    alibi = cfg.position_type == "alibi"
    sm = _sm_scale(cfg, q.shape[-1])
    if seq_parallel_degree() > 1:
        if window or (alibi and mask is not None):
            return _seq_gathered_attention(q, k, v, mask, causal=causal,
                                           cfg=cfg, window=window)
        # the rank holds a piece of the sequence: the ring over ``seq``,
        # ahead of the sparse branch, as JAX routes it
        return ring_attention_local(q, k, v, causal=causal, sm_scale=sm,
                                    kv_mask=mask,
                                    fused_backward=cfg.fused_backward,
                                    reference=reference)
    if window:
        return plain_attention(q, k, v, mask, causal=causal, cfg=cfg,
                               window=window)
    if cfg.sparse_attention and mask is None:
        if q.dtype == torch.float16:
            raise ValueError("sparse_attention kernels take no float16 (B5-B7 "
                             "run bf16 and f32, as JAX's on its TPU) — use "
                             "bf16")
        rep = q.shape[2] // k.shape[2]
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        sa = dict(cfg.sparse_attention)
        mode = sa.pop("mode", "fixed")
        return sparse_attention(q, k, v, get_sparsity_config(mode, **sa),
                                causal=causal, sm_scale=sm,
                                reference=reference)
    if alibi:
        return plain_attention(q, k, v, mask, causal=causal, cfg=cfg)
    return flash_attention(q, k, v, causal=causal, sm_scale=sm, kv_mask=mask,
                           fused_backward=cfg.fused_backward,
                           reference=reference)


def _seq_gathered_attention(q, k, v, mask=None, *, causal: bool,
                            cfg: TransformerConfig,
                            window: Optional[int] = None):
    """Over ``seq``: this rank's query rows against the whole sequence's
    keys, JAX's XLA branch (the softmax over every key, with the band or
    ALiBi's bias): K/V (and the key mask) gathered over ``seq`` in
    coordinate order, then ``plain_attention`` with the rows at their
    global positions. The gather's backward sums dK/dV over ``seq`` and
    keeps the rank's piece."""
    k_all = gather_along(k, "seq", dim=1)
    v_all = gather_along(v, "seq", dim=1)
    if mask is not None:
        mask = comm_all_gather(mask.contiguous(), "seq", dim=1)
    return plain_attention(q, k_all, v_all, mask, causal=causal, cfg=cfg,
                           window=window, q_offset=seq_offset(q.shape[1]))


def _quant_q(q32):
    """JAX's per-row int8 of the query rows (f32 [..., D]) for the int8
    score product: (int8 values, f32 scale [...])."""
    qs = torch.clamp_min(q32.abs().amax(dim=-1) / 127.0, 1e-8)
    qi = torch.clamp(torch.round(q32 / qs[..., None]), -127, 127)
    return qi.to(torch.int8), qs


def _int8_scores(qg, keys, k_scale):
    """Integer scores of the int8 path: q [..., R, D] quantized per row,
    contracted with the int8 keys [..., Tk, D] in int32 (exact, see
    ``ops/quantizer.int8_matmul``), then the q and k scales multiplied
    in, as JAX: f32 [..., R, Tk]. k_scale: [..., Tk] broadcast over R."""
    qi, qs = _quant_q(qg.float())
    sc = int8_matmul(qi, keys.transpose(-1, -2)).float()
    return sc * qs[..., None] * k_scale.unsqueeze(-2)


def _decode_pv(probs, cv, kv_scale, dtype):
    """probs [..., Tk] @ V [..., Tk, D] (JAX ``_decode_pv``). int8 cache:
    the per-position V scale folds into the probabilities, which are
    re-quantized per row to [0, 127] for an exact integer product; the row
    scale multiplies the result."""
    if kv_scale is None:
        return torch.matmul(probs.to(dtype), cv)
    pv = probs * kv_scale[1].unsqueeze(-2)
    ps = torch.clamp_min(pv.amax(dim=-1) / 127.0, 1e-20)
    pvi = torch.clamp(torch.round(pv / ps[..., None]), 0, 127)
    out = int8_matmul(pvi, cv).float()
    return (out * ps[..., None]).to(dtype)


def _col(v, device):
    """A decode cursor as a column over the rows: a [B] tensor becomes
    [B, 1] (the paged path's per-slot lengths), a host int stays an int
    (one-shot decode: every row at one position)."""
    if isinstance(v, torch.Tensor):
        return v.to(device).long()[:, None]
    return v


def _decode_attention(q, ck, cv, index, cfg: TransformerConfig,
                      kv_row, kv_scale=None, kv_suffix=None,
                      window: Optional[int] = None):
    """Single-token GQA attention against a contiguous KV buffer, JAX's
    ``_decode_attention`` in plain torch ops: JAX runs it on XLA, not on a
    Pallas kernel (its contiguous kernel was deleted), so there is no
    kernel to port.

    q: [B, 1, Nq, D]; ck/cv: [B, Nkv, T, D]; index: the current position,
    a host int (one-shot decode: every row at the same one) or a [B]
    tensor (the paged gathered path's per-slot lengths). kv_row: the
    CURRENT token's (k, v) [B, Nkv, 1, D], kept out of the buffer: its
    score joins the softmax separately and the caller writes the row
    afterwards (buffer rows at >= the prefix length are stale). kv_scale:
    the int8 buffer's (k_scale, v_scale) [B, Nkv, T] (int8 math, see
    ``_int8_scores`` / ``_decode_pv``). kv_suffix: (sk, sv, count), the
    two-level decode's segment rows [B, Nkv, Ssuf, D] in the compute
    dtype, of which the first ``count`` are valid; the buffer then holds
    ``index - count`` rows. ALiBi adds ``slope * (t - index)`` to the
    buffer's and the suffix's scores (the fresh row's distance is 0);
    ``window`` keeps the rows t with ``index - t < window``."""
    B, _, Nq, D = q.shape
    Nkv, T = ck.shape[1], ck.shape[2]
    rep = Nq // Nkv
    sm = _sm_scale(cfg, D)
    dev = q.device
    qg = q.reshape(B, Nkv, rep, D)
    k_row, v_row = kv_row
    idx = _col(index, dev)
    prefix_len = idx if kv_suffix is None else idx - kv_suffix[2]
    alibi = cfg.position_type == "alibi"
    if kv_scale is not None:
        scores = _int8_scores(qg, ck, kv_scale[0])
    else:
        scores = torch.einsum("bgrd,bgtd->bgrt", qg, ck).float()
    scores = scores * sm
    t = torch.arange(T, device=dev)[None, :]
    if alibi:
        scores = scores + _alibi_term(Nq, (t - idx).float()[:, None, None, :],
                                      (1, Nkv, rep, 1))
    keep = t < prefix_len                                        # [B|1, T]
    if window:
        keep = keep & (idx - t < window)
    parts = [scores.masked_fill(~keep[:, None, None, :], _NEG)]
    if kv_suffix is not None:
        sk, sv, count = kv_suffix
        n = sk.shape[2]
        s_suf = torch.einsum("bgrd,bgtd->bgrt", qg,
                             sk.to(qg.dtype)).float() * sm
        u = prefix_len + torch.arange(n, device=dev)[None, :]  # absolute
        if alibi:
            s_suf = s_suf + _alibi_term(Nq, (u - idx).float()[:, None, None, :],
                                        (1, Nkv, rep, 1))
        skeep = torch.arange(n, device=dev)[None, :] < count
        if window:
            skeep = skeep & (idx - u < window)
        parts.append(s_suf.masked_fill(~skeep[:, None, None, :], _NEG))
    s_self = torch.einsum("bgrd,bgtd->bgrt", qg,
                          k_row.to(qg.dtype)).float() * sm
    probs = torch.softmax(torch.cat(parts + [s_self], dim=-1), dim=-1)
    out = _decode_pv(probs[..., :T], cv, kv_scale, q.dtype)
    at = T
    if kv_suffix is not None:
        n = kv_suffix[0].shape[2]
        out = out + torch.einsum("bgrt,bgtd->bgrd",
                                 probs[..., at:at + n].to(q.dtype),
                                 kv_suffix[1].to(q.dtype))
        at += n
    out = out + probs[..., at:].to(q.dtype) * v_row.to(q.dtype)
    return out.reshape(B, 1, Nq, D)


def _pool_view(pool, idx):
    """One layer's pool [NB, Nkv, bs, ...] gathered through the tables
    idx [S, MB] into the contiguous per-slot view [S, Nkv, MB*bs, ...]."""
    g = pool[idx]                                # [S, MB, Nkv, bs, ...]
    S, MB, Nkv, bs = g.shape[:4]
    return g.transpose(1, 2).reshape((S, Nkv, MB * bs) + g.shape[4:])


def _paged_attention(q, pool_k, pool_v, tables, index,
                     cfg: TransformerConfig, kv_row, kv_scale=None,
                     reference: bool = False, window: Optional[int] = None):
    """Attention against one layer's block pool slices ([NB, Nkv, bs, D])
    through the block tables [S, MB]; index: per-slot sequence lengths
    [S]. A span of T > 1 tokens per slot (chunked prefill, a prefix-cache
    hit's tail, the speculative verify step) takes
    ``_paged_span_attention``, plain torch ops as in JAX, where the Pallas
    kernel is single-token only. One token per slot on a float pool goes
    through the paged decode kernel (B4), with the config's scale
    (``attn_scale`` too: B4 takes ``sm_scale``, where JAX's Pallas gate
    refuses an override). The gathered view, read with the math of
    ``_decode_attention``, serves what JAX's ``_paged_attention`` sends
    to XLA: an int8 pool (kv_scale: the layer's (k_scale, v_scale) [NB,
    Nkv, bs]; B4 reads float pools only), ALiBi (a score bias B4 lacks),
    and a model with ``attn_windows`` (JAX's decode passes every layer a
    traced window, so its global layers read the view too; ``window`` is
    this layer's, None for a global one)."""
    if q.shape[1] > 1:
        return _paged_span_attention(q, pool_k, pool_v, tables, index, cfg,
                                     kv_row, kv_scale=kv_scale,
                                     window=window)
    if kv_scale is not None or _gathered_decode(cfg):
        idx = tables.long()
        sc = (None if kv_scale is None
              else tuple(_pool_view(s, idx) for s in kv_scale))
        return _decode_attention(q, _pool_view(pool_k, idx),
                                 _pool_view(pool_v, idx), index, cfg,
                                 kv_row=kv_row, kv_scale=sc, window=window)
    fn = paged_decode_reference if reference else paged_decode_attention
    return fn(q, pool_k, pool_v, tables, index, kv_row=kv_row,
              sm_scale=_sm_scale(cfg, q.shape[-1]))


def _gathered_decode(cfg: TransformerConfig) -> bool:
    """A float pool's single-token decode reads the gathered view, not B4:
    ALiBi or ``attn_windows`` (JAX's XLA route for both)."""
    return cfg.position_type == "alibi" or bool(cfg.attn_windows)


def _paged_span_attention(q, pool_k, pool_v, tables, prior_lens,
                          cfg: TransformerConfig, kv_row, kv_scale=None,
                          window: Optional[int] = None):
    """T-token attention for a span appended at each slot's cursor, JAX's
    ``_paged_span_attention``. q: [S, T, Nq, D]; kv_row: the span's fresh
    (k, v) [S, Nkv, T, D]; prior_lens: [S] rows already in the pool.
    Position ``prior + t`` attends the pool prefix [0, prior), the span
    rows u <= t and itself: scores over the gathered pool view under the
    per-slot prefix mask, scores over the span under the causal ``u <= t``
    mask, one softmax over both (ALiBi's ``slope * (key - query)`` added
    to both, ``window`` banding both). Masked entries are -1e30, so they
    weigh exactly 0 and each position sees the single-token chain's
    logits (to reduction-order rounding: the softmax is wider). int8 pools
    (kv_scale: (k_scale, v_scale) [NB, Nkv, bs]): the pool read runs the
    int8 math of ``_decode_attention`` batched over T; the span's own
    fresh rows are read as floats, where single steps would re-read them
    quantized (JAX's relaxation too)."""
    S, T, Nq, D = q.shape
    _, Nkv, bs, _ = pool_k.shape
    MB = tables.shape[1]
    rep, Tp = Nq // Nkv, MB * bs
    chunk_k, chunk_v = kv_row
    sm = _sm_scale(cfg, D)
    dev = q.device
    idx = tables.long()
    qg = q.transpose(1, 2).reshape(S, Nkv, rep, T, D)
    vk = _pool_view(pool_k, idx)
    if kv_scale is not None:
        ksg, vsg = (_pool_view(s, idx) for s in kv_scale)   # [S, Nkv, Tp]
        sp = _int8_scores(qg.reshape(S, Nkv, rep * T, D), vk, ksg)
        sp = sp.reshape(S, Nkv, rep, T, Tp)
    else:
        sp = torch.einsum("bgrtd,bgsd->bgrts", qg, vk).float()
    sp = sp * sm
    tp = torch.arange(Tp, device=dev)
    t = torch.arange(T, device=dev)
    pos = prior_lens.long()[:, None] + t[None, :]                # [S, T]
    alibi = cfg.position_type == "alibi"
    if alibi:
        rel = (tp[None, None, :] - pos[:, :, None]).float()      # [S, T, Tp]
        sp = sp + _alibi_term(Nq, rel[:, None, None], (1, Nkv, rep, 1, 1))
    keep = (tp[None, None, :] < prior_lens.long()[:, None, None])
    if window:
        keep = keep & (pos[:, :, None] - tp[None, None, :] < window)
    sp = sp.masked_fill(~keep[:, None, None], _NEG)            # [S, T, Tp]
    sq = torch.einsum("bgrtd,bgud->bgrtu", qg,
                      chunk_k.to(qg.dtype)).float() * sm
    if alibi:
        rel_c = (t[None, :] - t[:, None]).float()                # u - t
        sq = sq + _alibi_term(Nq, rel_c, (1, Nkv, rep, 1, 1))
    causal = t[None, :] <= t[:, None]                            # [t, u]
    if window:
        causal = causal & (t[:, None] - t[None, :] < window)
    sq = sq.masked_fill(~causal, _NEG)
    probs = torch.softmax(torch.cat([sp, sq], dim=-1), dim=-1)
    vv = _pool_view(pool_v, idx)
    if kv_scale is not None:
        pp = probs[..., :Tp].reshape(S, Nkv, rep * T, Tp)
        out = _decode_pv(pp, vv, (None, vsg), q.dtype)
        out = out.reshape(S, Nkv, rep, T, D)
    else:
        out = torch.einsum("bgrts,bgsd->bgrtd", probs[..., :Tp].to(q.dtype),
                           vv)
    out = out + torch.einsum("bgrtu,bgud->bgrtd",
                             probs[..., Tp:].to(q.dtype),
                             chunk_v.to(q.dtype))
    # [S, Nkv, rep, T, D] -> [S, T, Nq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(S, T, Nq, D)


_MASK64 = (1 << 64) - 1


def mask_seed(*parts: int) -> int:
    """A 63-bit seed mixed from integers (splitmix64 steps): the dropout
    masks' seeds, fixed by (run seed, step, micro-batch, layer, salt)."""
    h = 0x9E3779B97F4A7C15
    for part in parts:
        h = ((h ^ (int(part) & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 31
        h = (h * 0x94D049BB133111EB) & _MASK64
    return h >> 1


def _dropout(x, cfg: TransformerConfig, seed: Optional[int], salt: int):
    """JAX's ``_dropout``: keep each element with probability 1 - rate,
    scaled by 1 / keep, else 0 (in x's dtype). ``seed`` None (eval,
    serving) or rate 0 leaves x as it is. Row r of x (its leading dim; a
    1-D x is one row) draws its mask from a ``torch.Generator`` seeded
    with ``mask_seed(seed, salt, r)``, so a rematerialized layer redraws
    exactly the mask its forward drew (``torch.utils.checkpoint``
    restores the global RNG state, not an explicit generator's), and a
    data-parallel rank, whose rows start at ``parallel.context.
    batch_row()`` of the one-rank run's micro-batch, draws only its own
    rows' masks, the one-rank run's. Another stream than JAX's: the two
    compare in distribution, not bit for bit."""
    if seed is None or cfg.dropout_rate == 0.0:
        return x
    keep = 1.0 - cfg.dropout_rate
    rows = x.reshape((x.shape[0], -1) if x.dim() > 1 else (1, -1))
    u = torch.empty(rows.shape, dtype=torch.float32, device=x.device)
    start = batch_row()
    # over ``seq`` a row here is a piece of the one-rank run's row: draw
    # the whole row and keep the piece
    sp = seq_parallel_degree() if x.dim() > 2 else 1
    n = rows.shape[1]
    piece = seq_offset(n) if sp > 1 else 0
    for r in range(rows.shape[0]):
        gen = torch.Generator(device=x.device).manual_seed(
            mask_seed(seed, salt, start + r))
        if sp > 1:
            u[r] = torch.rand((n * sp,), generator=gen,
                              device=x.device)[piece:piece + n]
        else:
            torch.rand(rows.shape[1:], generator=gen, out=u[r])
    mask = (u < keep).reshape(x.shape)
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


def _bias(y, p, name):
    """y + p[name] in y's dtype (JAX adds each bias after its matmul, cast
    to the activation dtype); y when the layer has no such bias."""
    b = p.get(name)
    return y if b is None else y + b.to(y.dtype)


def transformer_layer(x, p, cfg: TransformerConfig, *, positions,
                      mask=None, attend: Optional[Callable] = None,
                      row_dtype=None, reference: bool = False, lora=None,
                      dropout_seed: Optional[int] = None,
                      train: bool = False, aux: Optional[list] = None,
                      window: Optional[int] = None):
    """One block, JAX's ``transformer_layer``: pre-norm x + attn(ln1(x));
    x + mlp(ln2(x)), or post-norm (``norm_style="post"``, BERT) ln1(x +
    attn(x)), then ln2(h + mlp(h)), or the parallel block
    (``parallel_block``, GPT-J / NeoX) x + attn(ln1(x)) + mlp(ln2(x)). Each
    projection adds its bias where the layer has one (bq / bk / bv or the
    fused bqkv, bo, b_in, b_out), after its matmul (bo and b_out after the
    row-parallel sum).

    Without ``attend``: full-sequence (prefill) attention; returns
    (x, (k, v)) with the post-rotary k, v [B, S, nkv, hd] that seed a
    cache. With ``attend``: the S new tokens of each row attend a cache
    through ``attend(q, (k_row, v_row))`` (q [B, S, Nq, D]); the cache is
    NOT written here. The fresh rows join the softmax separately and are
    returned as (k_row, v_row) [B, nkv, S, hd] in ``row_dtype`` for the
    caller to write after all layers (writing them first would count them
    twice). ``window``: this layer's local window (None: global).

    ``lora=({proj: (A, B)}, idx)``: one layer's adapter slot tables and
    the per-row adapter slot; each projection in the dict gains the
    gathered low-rank delta (``_lora_delta``) where JAX adds it: q, k, v
    after their projections and biases, o on the flattened attention
    output (before bo).

    ``dropout_seed``: the layer's mask seed on the training path; dropout
    (salt 0 on the attention output, 1 on the FFN output) before each
    residual add, where JAX's is, and on a MoE layer with ``train`` the
    gate noise's generator (salt 2). None: no dropout, no noise.
    ``train``: a MoE layer routes with the training capacity; ``aux``: a
    list the MoE layer appends its aux loss to."""
    B, S, H = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head
    p = _maybe_dequant(p, cfg)
    post = cfg.norm_style == "post"
    h = x if post else _norm(x, p["ln1_scale"], p.get("ln1_bias"), cfg)
    if cfg.activation_quant_bits:
        h = fake_quant(h, bits=cfg.activation_quant_bits)
    h = _to_tensor_region(h)
    if "wqkv" in p:
        q, k, v = _bias(_w(h, p["wqkv"]), p, "bqkv").split(
            [nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q = _bias(_w(h, p["wq"]), p, "bq")
        k = _bias(_w(h, p["wk"]), p, "bk")
        v = _bias(_w(h, p["wv"]), p, "bv")
    tabs, aidx = lora if lora is not None else ({}, None)
    if "q" in tabs:
        q = q + _lora_delta(h, tabs["q"], aidx)
    if "k" in tabs:
        k = k + _lora_delta(h, tabs["k"], aidx)
    if "v" in tabs:
        v = v + _lora_delta(h, tabs["v"], aidx)
    # this rank's heads (all of them without a tensor axis)
    nh, nkv = q.shape[-1] // hd, k.shape[-1] // hd
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)
    if cfg.position_type == "rotary":
        q = rotary_embed(q, positions, cfg.rope_theta, cfg.rotary_dim,
                         cfg.rotary_interleaved)
        k = rotary_embed(k, positions, cfg.rope_theta, cfg.rotary_dim,
                         cfg.rotary_interleaved)
    if attend is not None:
        k_row = k.transpose(1, 2).to(row_dtype).contiguous()
        v_row = v.transpose(1, 2).to(row_dtype).contiguous()
        attn = attend(q.contiguous(), (k_row, v_row))
        new_kv = (k_row, v_row)
    else:
        attn = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         mask, causal=cfg.causal, cfg=cfg,
                         reference=reference, window=window)
        new_kv = (k, v)
    attn_flat = attn.reshape(B, S, nh * hd)
    attn_out = _bias(_w_row(attn_flat, p["wo"],
                            delta=(_lora_delta(attn_flat, tabs["o"], aidx)
                                   if "o" in tabs else None),
                            chunks=cfg.tp_overlap_chunks), p, "bo")
    if cfg.parallel_block:
        # both sublayers read the block's input x (GPT-J's import fills
        # both norms with its one ln_1)
        h = _norm(x, p["ln2_scale"], p.get("ln2_bias"), cfg)
    else:
        x = x + _dropout(attn_out, cfg, dropout_seed, 0)
        if post:
            x = _norm(x, p["ln1_scale"], p.get("ln1_bias"), cfg)
        h = x if post else _norm(x, p["ln2_scale"], p.get("ln2_bias"), cfg)
    if cfg.activation_quant_bits:
        h = fake_quant(h, bits=cfg.activation_quant_bits)
    if "wg" in p:
        gen = None
        if train and dropout_seed is not None and cfg.noisy_gate_policy:
            gen = torch.Generator(device=x.device).manual_seed(
                mask_seed(dropout_seed, 2))
        out, layer_aux = _moe_mlp(h, p, cfg, train=train, generator=gen)
        if aux is not None:
            aux.append(layer_aux)
    else:
        out = _mlp(h, p, cfg)
    if cfg.parallel_block:
        return (x + _dropout(attn_out, cfg, dropout_seed, 0)
                + _dropout(out, cfg, dropout_seed, 1)), new_kv
    x = x + _dropout(out, cfg, dropout_seed, 1)
    if post:
        x = _norm(x, p["ln2_scale"], p.get("ln2_bias"), cfg)
    return x, new_kv


def _mlp(h, p, cfg: TransformerConfig):
    """The dense MLP: column-parallel up (and gate), row-parallel down,
    with b_in after the up projection and b_out after the sum."""
    h = _to_tensor_region(h)
    if "w_in_gate" in p:
        up, gate = _w(h, p["w_in_gate"]).chunk(2, dim=-1)
    else:
        up = _bias(_w(h, p["w_in"]), p, "b_in")
        gate = _w(h, p["w_gate"]) if "w_gate" in p else None
    return _bias(_w_row(_activation(up, gate, cfg), p["w_out"],
                        chunks=cfg.tp_overlap_chunks), p, "b_out")


def _moe_mlp(h, p, cfg: TransformerConfig, train: bool = False,
             generator=None):
    """JAX's MoE branch of ``transformer_layer``: the expert FFN (with
    ``train``, the training capacity and ``generator``'s gate noise;
    else ``eval_capacity_factor`` and no noise), and under
    ``use_residual`` (PR-MoE) its mix with the dense MLP by the softmax
    of ``h @ moe_coef``. Returns (out, aux loss)."""
    moe = {"wg": p["wg"], "w_in": p["moe_w_in"], "w_out": p["moe_w_out"]}
    if "moe_w_gate" in p:
        moe["w_gate"] = p["moe_w_gate"]
    out, aux = moe_ffn(moe, h, cfg, generator=generator, train=train)
    if "w_in" not in p:
        return out, aux
    coef = torch.softmax((h @ p["moe_coef"].to(h.dtype)).float(), dim=-1)
    return (_mlp(h, p, cfg) * coef[..., 0:1].to(h.dtype)
            + out * coef[..., 1:2].to(h.dtype)), aux


def _layers(params: Params) -> List[Params]:
    """Per-layer views of the stacked [L, ...] leaves, taken once per pass:
    the backward of ``unbind`` is one stack per leaf, where indexing v[i]
    in the layer loop would build a zero-filled full stack per layer."""
    def unbind(a):
        if isinstance(a, dict):              # an int8 {"q", "scale"} leaf
            parts = {k: torch.unbind(v, 0) for k, v in a.items()}
            return [dict(zip(parts, vals)) for vals in zip(*parts.values())]
        return torch.unbind(a, 0)

    names = list(params["layers"])
    cols = [unbind(params["layers"][n]) for n in names]
    return [dict(zip(names, vals)) for vals in zip(*cols)]


def _head(params):
    """The [H, V] head in the layout x @ head takes (tied: the [V, H]
    table, transposed as a view)."""
    head = params.get("lm_head")
    return params["tok_embed"].t() if head is None else head


def _vocab_logits(x, head, vocab: Optional[int] = None):
    """f32 logits of x through a [H, V_local] head. Under a tensor axis
    the head holds this rank's vocab columns: the local logits go into a
    zero-filled full-vocab buffer at the rank's offset, and an
    ``all_reduce`` assembles the whole row on every rank (one non-zero
    term an entry: exact); with a graph, x enters through
    ``copy_to_tensor`` and the buffer leaves through
    ``reduce_from_tensor``. A head of all ``vocab`` columns (ZeRO-3's
    table gives the untied head's vocab dim no tensor axis: its embed dim
    took ``fsdp``) is the plain product on every tensor rank."""
    tp = axis_size("tensor")
    if tp == 1 or head.shape[-1] == vocab:
        return _w(x, head).float()
    i = axis_index("tensor")
    if _graph(x, head):
        local = _w(copy_to_tensor(x), head).float()
        Vl = local.shape[-1]
        return reduce_from_tensor(F.pad(local, (i * Vl, (tp - 1 - i) * Vl)))
    local = _w(x, head).float()
    Vl = local.shape[-1]
    full = local.new_zeros(local.shape[:-1] + (Vl * tp,))
    full[..., i * Vl:(i + 1) * Vl] = local
    return all_reduce(full, "tensor")


def _full_vocab(bias, vocab: int):
    """The head's f32 bias over the whole vocabulary. Under a tensor axis
    a vocab-sharded bias [V / tp] goes into a zero-filled [V] row at the
    rank's offset, summed over ``tensor`` (one non-zero term an entry:
    exact; with a graph through ``reduce_from_tensor``, whose identity
    backward hands each rank its slice of the replicated grad)."""
    bias = bias.float()
    tp = axis_size("tensor")
    if tp == 1 or bias.shape[-1] == vocab:
        return bias
    i, Vl = axis_index("tensor"), bias.shape[-1]
    full = F.pad(bias, (i * Vl, (tp - 1 - i) * Vl))
    if _graph(bias):
        return reduce_from_tensor(full)
    return all_reduce(full, "tensor")


def lm_head_logits(x, params, vocab: Optional[int] = None):
    """Final projection to f32 vocab logits, the head cast to x's dtype
    (vocab-parallel under a tensor axis: ``_vocab_logits``; ``vocab``:
    the model's vocabulary size), plus the f32 ``lm_head_bias`` where the
    model has one (GPT-J; vocab-sharded under a tensor axis:
    ``_full_vocab``)."""
    logits = _vocab_logits(x, _head(params), vocab)
    bias = params.get("lm_head_bias")
    if bias is None:
        return logits
    return logits + _full_vocab(bias, logits.shape[-1])


def _tokens(params, ids, cfg: TransformerConfig):
    """Token embeddings in the compute dtype. F.embedding, not an index:
    its backward sums a token's rows in a fixed order on the CPU and the
    card, where the index's backward (an accumulating index_put) adds f32
    rows atomically in parallel on the CPU, so two runs of one step could
    differ in the last bit. Vocab-parallel under a tensor axis: each rank
    looks up the ids in its rows (zeros elsewhere) and an ``all_reduce``
    sums the one non-zero row of each token (exact)."""
    table = params["tok_embed"]
    tp = axis_size("tensor")
    if tp == 1:
        return F.embedding(ids.long(), table).to(cfg.dtype)
    Vl = table.shape[0]
    local = ids.long() - axis_index("tensor") * Vl
    mine = (local >= 0) & (local < Vl)
    x = F.embedding(torch.where(mine, local, torch.zeros_like(local)), table)
    x = torch.where(mine[..., None], x, torch.zeros_like(x))
    if _graph(table):
        return reduce_from_tensor(x).to(cfg.dtype)
    return all_reduce(x, "tensor").to(cfg.dtype)


def _rows_of(table, idx):
    """table[idx] by F.embedding with the index clamped into the table, as
    JAX's gather clamps it: a position past ``max_seq_len`` (a forward or a
    generate that runs past the table) reads the last row and never sends
    an out-of-range index to the device."""
    return F.embedding(idx.long().clamp(0, table.shape[0] - 1), table)


def _embed(params, ids, cfg: TransformerConfig, positions=None,
           token_type_ids=None, token_types: bool = True):
    """The embedding block, JAX's: token rows, plus the learned position
    rows at ``positions`` (default 0 .. S - 1), plus the token-type rows
    (``token_type_ids``, default all 0) when the model has
    ``tok_type_embed`` and ``token_types`` (JAX's decode paths add none),
    then ``embed_norm``, each term in the compute dtype."""
    x = _tokens(params, ids, cfg)
    if cfg.position_type == "learned":
        if positions is None:
            positions = torch.arange(ids.shape[1], device=ids.device)[None]
        x = x + _rows_of(params["pos_embed"], positions).to(cfg.dtype)
    if token_types and "tok_type_embed" in params:
        tt = (torch.zeros_like(ids) if token_type_ids is None
              else torch.as_tensor(token_type_ids, device=ids.device))
        x = x + _rows_of(params["tok_type_embed"], tt).to(cfg.dtype)
    if cfg.embed_norm:
        x = _norm(x, params["embed_norm_scale"],
                  params.get("embed_norm_bias"), cfg)
    return x


def final_norm(x, params, cfg: TransformerConfig):
    """The final norm, where the model has one (BERT's post-LN blocks end
    normed: ``final_norm=False``)."""
    if not cfg.final_norm:
        return x
    return _norm(x, params["final_norm_scale"],
                 params.get("final_norm_bias"), cfg)


def forward(params: Params, input_ids, cfg: TransformerConfig, *,
            attention_mask=None, positions=None, token_type_ids=None,
            return_kv: bool = False,
            return_hidden: bool = False, reference: bool = False,
            dropout_seed: Optional[int] = None, train: bool = False,
            return_aux: bool = False, layer_keep=None, ltd_select=None):
    """input_ids [B, S] -> f32 logits [B, S, V]; with ``return_kv`` also
    the per-layer post-rotary (k, v), each stacked [L, B, S, nkv, hd];
    with ``return_hidden`` the final-normed hidden states [B, S, H]
    instead of logits (the chunked loss projects them chunk by chunk).
    ``positions`` [B, S]: the rotary angles' and the learned table's rows
    (default 0 .. S - 1); ``token_type_ids`` [B, S]: an encoder's segment
    ids (default 0).
    ``dropout_seed``: the training path's mask seed (None: no dropout);
    ``train``: MoE layers route with the training capacity (and draw
    their gate noise from the seed); ``return_aux``: (out, the sum of the
    MoE layers' aux losses), as JAX's; ``layer_keep`` / ``ltd_select``:
    the training extras' draws (``layer_stack``)."""
    aux: list = []
    x, kvs = _hidden(params, input_ids, cfg, attention_mask=attention_mask,
                     positions=positions, token_type_ids=token_type_ids,
                     reference=reference, keep_kv=return_kv,
                     dropout_seed=dropout_seed, train=train, aux=aux,
                     layer_keep=layer_keep, ltd_select=ltd_select)
    total = (torch.stack(aux).sum() if aux
             else x.new_zeros((), dtype=torch.float32))
    if return_hidden:
        return (x, total) if return_aux else x
    logits = lm_head_logits(x, params, cfg.vocab_size)
    if return_kv:
        logits = (logits, (torch.stack([k for k, _ in kvs]),
                           torch.stack([v for _, v in kvs])))
    return (logits, total) if return_aux else logits


# matmul outputs: what JAX's ``dots_saveable`` keeps (a matmul of a 3-D
# activation by a 2-D weight reaches the dispatcher as aten.mm)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})
# the matmuls without a batch dim: what ``dots_with_no_batch_dims_saveable``
# keeps (aten.bmm carries one)
_NO_BATCH_DOTS = frozenset({torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default})


class _OffloadSave(TorchDispatchMode):
    """The checkpointed forward of ``offload_dots``: each output of a
    ``saved`` op is copied into host memory (pinned, by a non-blocking
    copy in stream order, on CUDA) and kept in ``store``, per op, in call
    order."""

    def __init__(self, saved, store):
        super().__init__()
        self.saved, self.store = saved, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.saved:
            host = torch.empty(out.shape, dtype=out.dtype,
                               pin_memory=out.is_cuda)
            host.copy_(out, non_blocking=out.is_cuda)
            self.store.setdefault(func, []).append(host)
        return out


class _OffloadRestore(TorchDispatchMode):
    """The backward's replay under ``offload_dots``: a ``saved`` op is not
    recomputed; its output comes back from host memory, bit for bit the
    value the forward computed. Everything else is recomputed."""

    def __init__(self, saved, store, device):
        super().__init__()
        self.saved, self.store, self.device = saved, store, device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.saved and self.store.get(func):
            host = self.store[func].pop(0)
            return host.to(self.device, non_blocking=host.is_pinned())
        return func(*args, **(kwargs or {}))


def _offload_contexts(saved, device):
    """``context_fn`` of ``offload_dots``: JAX's
    ``offload_dot_with_no_batch_dims("device", "pinned_host")``. The
    selective-checkpoint contexts keep MUST_SAVE outputs in their own
    cache on the device, out of reach of ``saved_tensors_hooks``; these
    two modes keep them on the host instead, between the forward and the
    replay."""
    store = {}
    return _OffloadSave(saved, store), _OffloadRestore(saved, store, device)


def _remat_policy(cfg: TransformerConfig, device=None):
    """How each layer is rematerialized, as JAX's ``_remat_policy`` picks
    it: None = no checkpoint; otherwise the ``context_fn`` for
    ``torch.utils.checkpoint`` ("full", "save_nothing" and ``remat`` with
    policy "none" save nothing inside the layer: a bare checkpoint).

    "dots_saveable" keeps the matmul outputs and replays the rest,
    including the flash forward (B1), in the backward;
    "dots_with_no_batch_dims" keeps those without a batch dim (aten.mm /
    addmm, not bmm: every weight matmul of the layer) and so replays B1
    too; "offload_dots" keeps that same set in host memory between the
    forward and the backward (``device``: where the replay puts it back).
    "dots_and_attn" also keeps B1's O and LSE (the custom op
    ``dstpu_torch::flash_fwd``), so the backward runs straight into B2/B3
    without replaying B1. The sparse forward (B5) is kept by none: all
    replay it, as in JAX."""
    if not cfg.remat and cfg.remat_policy in ("none", None):
        return None
    if cfg.remat_policy == "offload_dots":
        return functools.partial(_offload_contexts, _NO_BATCH_DOTS, device)
    saved = {"dots_saveable": _DOTS,
             "dots_with_no_batch_dims": _NO_BATCH_DOTS,
             "dots_and_attn": _DOTS | {FLASH_FWD_OP}}.get(cfg.remat_policy)
    if saved is None:
        return noop_context_fn

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


def layer_stack(x, layers: Params, cfg, *, positions, attention_mask=None,
                reference=False, on_layer_kv: Optional[Callable] = None,
                keep_kv: bool = False, dropout_seed: Optional[int] = None,
                train: bool = False, aux: Optional[list] = None,
                first_layer: int = 0, layer_keep=None,
                ltd_select: Optional[Dict[int, torch.Tensor]] = None):
    """The stacked ``layers`` ([L, ...] leaves) over x [B, S, H]: returns
    (x, the kept K/V). With gradients on, each layer runs under the
    config's remat policy. Layer i of the stack is the model's layer
    ``first_layer + i`` (a pipeline stage's run of layers): its dropout
    masks (and gate noise) come from ``mask_seed(dropout_seed,
    first_layer + i)``, its window from ``attn_windows[first_layer + i]``. ``on_layer_kv``, ``keep_kv``, ``train`` and
    ``aux``: as ``_hidden``'s. The training extras (ignored where K/V are
    kept): ``layer_keep[i]`` false drops model layer i (progressive layer
    drop: the layer is the identity and launches nothing);
    ``ltd_select[i]`` [B, keep] runs layer i on those tokens only
    (random-LTD, ``runtime/data_pipeline.random_ltd_layer``), gather, layer
    and scatter rematerialized as one unit."""
    from deepspeed_tpu_torch.runtime.data_pipeline import random_ltd_layer
    context_fn = (_remat_policy(cfg, x.device) if torch.is_grad_enabled()
                  else None)
    serving = on_layer_kv is not None or keep_kv

    def layer(x_in, lp, i, box=None, sel=None):
        seed = None if dropout_seed is None else mask_seed(dropout_seed, i)
        # ZeRO-3: the layer's whole weights, gathered inside the remat
        # checkpoint (they replay in the backward and live only while the
        # layer runs)
        lp = gather_params(lp, "layers/")

        def run(xs, positions=positions, mask=attention_mask):
            return transformer_layer(xs, lp, cfg, positions=positions,
                                     mask=mask, reference=reference,
                                     dropout_seed=seed, train=train, aux=box,
                                     window=_window(cfg, i))
        with layer_scope(i):
            if sel is None:
                return run(x_in)
            return random_ltd_layer(x_in, run, sel, positions=positions,
                                    mask=attention_mask)

    def remat(x_in, lp, i, sel=None):
        box: list = []
        out = layer(x_in, lp, i, box, sel)[0]
        return (out, box[0]) if box else out

    kvs = []
    for j, lp in enumerate(_layers({"layers": layers})):
        i = first_layer + j
        sel = None
        if not serving:
            if layer_keep is not None and not layer_keep[i]:
                continue
            if ltd_select is not None:
                sel = ltd_select.get(i)
        if context_fn is not None and not serving:
            out = checkpoint(remat, x, lp, i, sel, use_reentrant=False,
                             context_fn=context_fn)
            if isinstance(out, tuple):
                x, layer_aux = out
                if aux is not None:
                    aux.append(layer_aux)
            else:
                x = out
            continue
        x, (k, v) = layer(x, lp, i, aux, sel)
        if on_layer_kv is not None:
            on_layer_kv(i, k, v)
        elif keep_kv:
            kvs.append((k, v))
    return x, kvs


def pld_keep_probs(theta: float, num_layers: int) -> np.ndarray:
    """Progressive layer drop's keep probability of each layer, JAX's f32
    1 - (i + 1) / L * (1 - theta): the deeper, the likelier dropped."""
    i = np.arange(num_layers, dtype=np.float32)
    return (np.float32(1.0) - (i + np.float32(1.0)) / np.float32(num_layers)
            * (np.float32(1.0) - np.float32(theta))).astype(np.float32)


def pld_coins(theta: float, num_layers: int, key) -> List[bool]:
    """Which layers a training pass keeps: layer i's coin from a numpy
    generator keyed by (``key``..., 7919 + i) against its keep
    probability. Host draws: no device sync."""
    probs = pld_keep_probs(theta, num_layers)
    return [bool(np.random.default_rng([*key, 7919 + i]).random() < probs[i])
            for i in range(num_layers)]


def ltd_draws(cfg: TransformerConfig, rows: int, seq_len: int, keep: int,
              key, device, row0: int = 0) -> Dict[int, torch.Tensor]:
    """Random-LTD's kept tokens of layers 1 .. L - 2 ({layer: [rows, keep]
    sorted int64 on ``device``}), each drawn on the host by
    ``data_pipeline.ltd_selection`` keyed by (``key``..., layer) and the
    global row (``row0`` + r), moved in one copy. Empty when ``keep`` is
    not below ``seq_len`` or the model has fewer than 3 layers."""
    from deepspeed_tpu_torch.runtime.data_pipeline import ltd_selection
    mids = list(range(1, cfg.num_layers - 1))
    if keep >= seq_len or not mids:
        return {}
    host = np.stack([ltd_selection((*key, i), rows, seq_len, keep, row0)
                     for i in mids])
    t = torch.from_numpy(host)
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return dict(zip(mids, t.unbind(0)))


def _hidden(params, input_ids, cfg, *, attention_mask=None, positions=None,
            token_type_ids=None, reference=False,
            on_layer_kv: Optional[Callable] = None,
            keep_kv: bool = False, dropout_seed: Optional[int] = None,
            train: bool = False, aux: Optional[list] = None,
            layer_keep=None, ltd_select=None):
    """Embedding (``_embed``), the layer stack and the final norm.
    ``on_layer_kv(i, k, v)`` consumes each layer's K/V as soon as it
    exists (the paged prefill writes them straight into the pool);
    ``keep_kv`` returns them. With gradients on, each layer runs under
    the config's remat policy. ``dropout_seed``: layer i's masks (and
    gate noise) come from ``mask_seed(dropout_seed, i)`` (None: no
    dropout); ``train`` and ``aux``: as ``transformer_layer``'s (each MoE
    layer's aux loss appended to ``aux``); ``layer_keep`` and
    ``ltd_select``: as ``layer_stack``'s."""
    B, S = input_ids.shape
    if positions is None:
        # over ``seq`` the ids are this rank's piece: its global positions
        start = seq_offset(S) if seq_parallel_degree() > 1 else 0
        positions = torch.arange(start, start + S,
                                 device=input_ids.device)[None].expand(B, S)
    x = _embed(params, input_ids, cfg, positions=positions,
               token_type_ids=token_type_ids)
    x, kvs = layer_stack(x, params["layers"], cfg, positions=positions,
                         attention_mask=attention_mask, reference=reference,
                         on_layer_kv=on_layer_kv, keep_kv=keep_kv,
                         dropout_seed=dropout_seed, train=train, aux=aux,
                         layer_keep=layer_keep, ltd_select=ltd_select)
    return final_norm(x, params, cfg), kvs


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


def _mean_over(tot, cnt, count):
    """``tot`` over the label count: this batch's own ``cnt`` (at least
    1), or the ``count`` given."""
    if count is None:
        return tot / torch.as_tensor(cnt, device=tot.device).clamp_min(1)
    return tot / count


def cross_entropy_loss(logits, labels, ignore_index: int = -100,
                       count=None):
    """Mean next-token CE over the labels that are not ``ignore_index``.
    logits [B, S, V] f32; labels [B, S] already aligned. ``count``: the
    label count to divide by instead of this batch's own."""
    tot, cnt = _nll_sum(logits, labels, ignore_index)
    return _mean_over(tot, cnt, count)


def chunked_cross_entropy(x, head, labels, chunk: int,
                          ignore_index: int = -100, tied_embed: bool = False,
                          count=None, vocab: Optional[int] = None,
                          bias=None):
    """CE over sequence chunks: each chunk's f32 logits [B, c, V] exist
    only inside a ``torch.utils.checkpoint`` (the head matmul re-runs in
    the backward). x: [B, S, H] final hidden (normed); head: [H, V], or
    with ``tied_embed`` the [V, H] embedding table. c is the largest
    divisor of S that is <= chunk, as in JAX. ``count`` as in
    ``cross_entropy_loss``. A vocab-sharded head (a tensor axis) gives
    each chunk's whole-vocab logits as ``lm_head_logits`` does
    (``vocab``: the model's vocabulary size). ``bias``: the head's [V]
    bias (GPT-J's ``lm_head_bias``), added to each chunk's f32 logits as
    ``lm_head_logits`` adds it, vocab-sharded or not (JAX's chunked loss
    leaves it out: its chunked and full losses differ for such a
    model)."""
    B, S, _ = x.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    if tied_embed:
        head = head.t()

    def body(xc, lc, w, b=None):
        logits = _vocab_logits(xc, w, vocab)
        if b is not None:
            logits = logits + _full_vocab(b, logits.shape[-1])
        return _nll_sum(logits, lc, ignore_index)[0]

    tot = x.new_zeros((), dtype=torch.float32)
    cnt = 0
    for i in range(S // c):
        xc, lc = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            tot = tot + checkpoint(body, xc, lc, head, bias,
                                   use_reentrant=False)
        else:
            tot = tot + body(xc, lc, head, bias)
        cnt = cnt + (lc != ignore_index).sum()
    return _mean_over(tot, cnt, count)


def lm_labels(batch):
    """The labels ``lm_loss`` reads: ``batch["labels"]``, else the ids
    shifted left with -100 at the end."""
    labels = batch.get("labels")
    if labels is None:
        ids = batch["input_ids"]
        labels = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -100)],
                           dim=1)
    return labels


def head_loss(params: Params, x, labels, cfg: TransformerConfig,
              label_count=None):
    """The CE of the final-normed hidden states x [B, S, H] through the
    head (chunked with ``loss_chunk``), over ``label_count`` (None: the
    labels' own count)."""
    if cfg.loss_chunk and cfg.loss_chunk > 0:
        tied = params.get("lm_head") is None
        head = params["tok_embed"] if tied else params["lm_head"]
        return chunked_cross_entropy(x, head, labels, cfg.loss_chunk,
                                     tied_embed=tied, count=label_count,
                                     vocab=cfg.vocab_size,
                                     bias=params.get("lm_head_bias"))
    return cross_entropy_loss(lm_head_logits(x, params, cfg.vocab_size),
                              labels, count=label_count)


def lm_loss(params: Params, batch, cfg: TransformerConfig,
            reference: bool = False, dropout_seed: Optional[int] = None,
            label_count=None, train: bool = False, pld_theta=None,
            pld_keep=None, ltd_select=None):
    """Causal-LM loss: predict token t+1 from the prefix <= t. ``batch``:
    input_ids [B, S]; optional labels (default: the ids shifted left, -100
    at the end) and attention_mask [B, S] (a key mask in attention).
    ``dropout_seed``: the training step's mask seed (JAX's ``dropout_rng``
    with ``deterministic=False``); None, as in eval, drops nothing.
    ``label_count``: the count to divide the summed token losses by
    (default: this batch's labels; a data-parallel rank gives the global
    batch's, ``runtime/engine``). ``train``: MoE layers route with the
    training capacity (JAX's ``deterministic=False``). A MoE model adds
    ``moe_aux_loss_weight`` times the sum of its layers' aux losses, as
    JAX's ``lm_loss``.

    The training extras act only with ``train``, as JAX's act only with
    ``deterministic=False``: random-LTD (``cfg.random_ltd`` with
    ``random_ltd_keep`` below S) on ``ltd_select`` ({layer: [B, keep]}),
    drawn from ``dropout_seed`` (0 without one) when not given; else
    progressive layer drop (``cfg.progressive_layer_drop`` and
    ``pld_theta``) keeping the layers ``pld_keep`` marks, drawn by
    ``pld_coins`` when not given."""
    # ZeRO-3: the embedding, the head and the final norm, gathered once a
    # pass (each layer gathers its own in ``_hidden``)
    params = gather_params(params)
    ids = batch["input_ids"]
    labels = lm_labels(batch)
    mask = batch.get("attention_mask")
    layer_keep = None
    if not train:
        ltd_select = None
    elif ltd_select is None and cfg.random_ltd \
            and 0 < cfg.random_ltd_keep < ids.shape[1]:
        ltd_select = ltd_draws(cfg, ids.shape[0], ids.shape[1],
                               cfg.random_ltd_keep, (dropout_seed or 0,),
                               ids.device)
    if train and not ltd_select and cfg.progressive_layer_drop \
            and pld_theta is not None:
        layer_keep = (pld_keep if pld_keep is not None else pld_coins(
            pld_theta, cfg.num_layers, (dropout_seed or 0,)))
    kw = dict(attention_mask=mask, reference=reference,
              dropout_seed=dropout_seed, train=train, return_aux=True,
              layer_keep=layer_keep, ltd_select=ltd_select or None)
    x, aux = forward(params, ids, cfg, return_hidden=True, **kw)
    loss = head_loss(params, x, labels, cfg, label_count)
    if cfg.num_experts > 1:
        loss = loss + cfg.moe_aux_loss_weight * aux
    return loss


# --------------------------------------------------------------------------
# Paged KV cache (serving): block pools [L, NB, nkv, bs, hd] + block tables
# --------------------------------------------------------------------------

def init_paged_cache(cfg: TransformerConfig, num_blocks: int,
                     block_size: int, dtype=None, device=None) -> Params:
    """Block pools [L, NB, n_kv, block_size, head_dim]. Block 0 is the
    reserved TRASH block: null table entries point at it and inactive slots
    write into it; its contents are never read (masked by the lengths).
    ``kv_cache_bits=8``: int8 pools plus f32 ``k_scale`` / ``v_scale``
    [L, NB, n_kv, block_size] (one scale a row). Under a tensor axis n_kv
    is this rank's ``kv_heads / tp``. ``device=None`` means the card
    (raises without CUDA), as every entry point of the port."""
    shape = (cfg.num_layers, num_blocks, _local_kv_heads(cfg), block_size,
             cfg.dim_per_head)
    device = resolve_device(device)
    if cfg.kv_cache_bits == 8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)}
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_rows(store, name, index, rows):
    """``store[name][index] = rows``, quantized per row into the int8
    payload and its ``<name>_scale`` when the store holds scales, else
    cast to the store's dtype. ``index``: a tuple of indices into the
    payload that leaves its last (head) dim whole."""
    if name + "_scale" in store:
        q, sc = quantize_rows(rows)
        store[name][index] = q
        store[name + "_scale"][index] = sc
    else:
        store[name][index] = rows.to(store[name].dtype)


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
    each layer's K/V goes into its blocks as soon as the layer has run
    (quantized per row, with its scales, into an int8 pool).

    A block-sparse model prefills as JAX's does: no key mask, so the whole
    bucket goes through K/V repeat + the block-sparse kernel (B5); causal,
    so the pad rows at the end never reach a real row. The bucket must be
    a multiple of the layout's block (``sparse_attention`` raises the
    ``ValueError`` JAX raises). Its decode (``decode_step_paged``, B4) and
    its spans (``decode_span_paged``: chunked and warm prefills) attend
    densely, as JAX's paged decode and XLA span do."""
    B, P = input_ids.shape
    bs = pools["k"].shape[3]
    nblk = P // bs
    length = P if length is None else int(length)
    block_ids = torch.as_tensor(block_ids, device=pools["k"].device).long()

    def to_blocks(a):            # [1, P, nkv, hd] -> [nblk, nkv, bs, hd]
        return a[0].reshape(nblk, bs, a.shape[2], a.shape[3]).transpose(1, 2)

    def write(i, k, v):
        _write_rows(pools, "k", (i, block_ids), to_blocks(k))
        _write_rows(pools, "v", (i, block_ids), to_blocks(v))

    x, _ = _hidden(params, input_ids, cfg, reference=reference,
                   on_layer_kv=write)
    return lm_head_logits(x[:, length - 1], params)


def _final_logits(x, params, cfg):
    return lm_head_logits(final_norm(x, params, cfg), params)


def _paged_rows(params, tokens, cfg, pools, block_tables, seq_lens,
                reference, lora=None):
    """The layer stack over T new tokens per slot (tokens [S, T] at
    positions seq_lens .. seq_lens + T - 1) attending the pool; returns
    the final hidden states [S, T, H] and every layer's fresh rows
    stacked [L, S, nkv, T, hd], not yet written (in the compute dtype for
    an int8 pool: they are quantized as they are written). ``lora``:
    ``(adapter_pool, aidx)``, the pool ``{proj: {"a": [L, NS, In, r],
    "b": [L, NS, r, Out]}}`` and each slot's adapter slot [S]; each
    layer takes its row of the pool."""
    T = tokens.shape[1]
    positions = (seq_lens.long()[:, None]
                 + torch.arange(T, device=tokens.device)[None, :])
    # JAX's decode paths add no token-type rows
    x = _embed(params, tokens, cfg, positions=positions,
               token_types=False)                               # [S, T, H]
    int8 = cfg.kv_cache_bits == 8
    row_dtype = cfg.dtype if int8 else pools["k"].dtype
    k_rows, v_rows = [], []
    for i, lp in enumerate(_layers(params)):
        sc = (pools["k_scale"][i], pools["v_scale"][i]) if int8 else None
        lora_i = None
        if lora is not None:
            apool, aidx = lora
            lora_i = ({k: (v["a"][i], v["b"][i]) for k, v in apool.items()},
                      aidx)
        x, (k_row, v_row) = transformer_layer(
            x, lp, cfg, positions=positions, row_dtype=row_dtype,
            attend=lambda q, kv, i=i, sc=sc: _paged_attention(
                q, pools["k"][i], pools["v"][i], block_tables, seq_lens,
                cfg, kv, kv_scale=sc, reference=reference,
                window=_window(cfg, i)), lora=lora_i)
        k_rows.append(k_row)
        v_rows.append(v_row)
    return x, torch.stack(k_rows), torch.stack(v_rows)


def decode_step_paged(params: Params, tokens, cfg: TransformerConfig,
                      pools: Params, block_tables, seq_lens, active=None,
                      reference: bool = False, lora=None):
    """One decode step for every slot of a paged serving batch.

    tokens: [S] (one in-flight token per slot); block_tables: [S, MB]
    int32; seq_lens: [S] int32 = rows already in each slot's cache (the
    fresh row is written AT seq_lens); active: [S] bool (None = all).
    Returns f32 logits [S, V].

    The fresh rows of all layers are written after the layer stack, in
    place (JAX donated the pools): one scatter to (block_tables[s,
    len // bs], len % bs), quantized with their scales into an int8 pool.
    Inactive slots, and slots whose column len // bs is past the table (a
    request that reached max_model_len mid-quantum), still compute but
    write into the trash block 0; duplicate trash writes are fine (never
    read). ``lora``: ``(adapter_pool, aidx)``, each slot's adapter delta
    (``_paged_rows``)."""
    S = tokens.shape[0]
    if active is None:
        active = torch.ones((S,), dtype=torch.bool, device=tokens.device)
    x, k_rows, v_rows = _paged_rows(params, tokens[:, None], cfg, pools,
                                    block_tables, seq_lens, reference,
                                    lora=lora)
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
    at = (slice(None), blk, slice(None), off)
    _write_rows(pools, "k", at, k_rows[:, :, :, 0].transpose(0, 1))
    _write_rows(pools, "v", at, v_rows[:, :, :, 0].transpose(0, 1))
    return _final_logits(x, params, cfg)[:, 0, :]


def decode_span_paged(params: Params, tokens, cfg: TransformerConfig,
                      pools: Params, block_tables, seq_lens, active=None,
                      n_rows=None, reference: bool = False, lora=None):
    """T consecutive tokens per slot in one pass, JAX's
    ``decode_span_paged``: a prefill chunk appended behind rows already in
    the pool (an earlier chunk, or a prefix-cache hit), or the speculative
    verify step (the pending token plus K proposals).

    tokens: [S, T] at positions ``seq_lens .. seq_lens + T - 1``; returns
    f32 logits [S, T, V] and writes each token's K/V row at its position,
    in place, after the layer stack (quantized with their scales into an
    int8 pool). ``n_rows``: [S] rows actually written per slot (default
    T): a bucketed chunk's pad tokens past ``n_rows`` compute garbage that
    lands in the trash block 0, as do inactive slots and positions past
    the table's capacity (a verify step near the context cap). Rows of
    rejected proposals stay in place behind the caller's cursor until
    overwritten. The caller forks shared (refcounted) blocks before any
    span writes them (the serving engine's copy-on-write fork). Attention
    is plain torch ops (``_paged_span_attention``), as JAX runs it on
    XLA. ``lora`` as in ``decode_step_paged``."""
    S, T = tokens.shape
    dev = tokens.device
    if active is None:
        active = torch.ones((S,), dtype=torch.bool, device=dev)
    if n_rows is None:
        n_rows = torch.full((S,), T, dtype=torch.long, device=dev)
    x, k_rows, v_rows = _paged_rows(params, tokens, cfg, pools,
                                    block_tables, seq_lens, reference,
                                    lora=lora)
    bs = pools["k"].shape[3]
    MB = block_tables.shape[1]
    t = torch.arange(T, device=dev)
    positions = seq_lens.long()[:, None] + t[None, :]           # [S, T]
    write = (active[:, None] & (t[None, :] < n_rows.long()[:, None])
             & (positions < MB * bs))
    blk = block_tables.long().gather(1, (positions // bs).clamp(0, MB - 1))
    blk = torch.where(write, blk, torch.zeros_like(blk)).reshape(-1)
    off = torch.where(write, positions % bs,
                      torch.zeros_like(positions)).reshape(-1)

    def flat(a):                     # [L, S, nkv, T, hd] -> [S*T, L, nkv, hd]
        a = a.permute(1, 3, 0, 2, 4)
        return a.reshape((S * T,) + a.shape[2:])

    at = (slice(None), blk, slice(None), off)
    _write_rows(pools, "k", at, flat(k_rows))
    _write_rows(pools, "v", at, flat(v_rows))
    return _final_logits(x, params, cfg)


# --------------------------------------------------------------------------
# Contiguous KV cache (one-shot generate): buffers [L, B, nkv, T, hd]
# --------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch_size: int, max_len: int,
               dtype=None, device=None) -> Params:
    """Preallocated KV buffers [L, B, n_kv, max_len, head_dim] and the
    cursor ``index`` (a host int: every row of the batch sits at the same
    position). ``kv_cache_bits=8``: int8 buffers plus f32 ``k_scale`` /
    ``v_scale`` [L, B, n_kv, max_len]. ``device=None`` means the card."""
    shape = (cfg.num_layers, batch_size, _local_kv_heads(cfg), max_len,
             cfg.dim_per_head)
    device = resolve_device(device)
    if cfg.kv_cache_bits == 8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device),
                "index": 0}
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def prefill(params: Params, input_ids, cfg: TransformerConfig, cache: Params,
            attention_mask=None, length: Optional[int] = None,
            reference: bool = False):
    """Process the prompt, seed the cache, return (logits at the last real
    position [B, V], cache). One forward pass through the flash kernel
    (B1): each layer's K/V goes into the buffer, in place (quantized per
    row into an int8 cache), as soon as the layer has run. ``length``: the
    true prompt length when input_ids is right-padded to a bucket; the
    cursor is set there, so decode overwrites the pad rows before they can
    be attended."""
    S = input_ids.shape[1]
    true_len = S if length is None else int(length)

    def write(i, k, v):           # [B, S, nkv, hd] -> [B, nkv, S, hd]
        at = (i, slice(None), slice(None), slice(0, S))
        _write_rows(cache, "k", at, k.transpose(1, 2))
        _write_rows(cache, "v", at, v.transpose(1, 2))

    x, _ = _hidden(params, input_ids, cfg, attention_mask=attention_mask,
                   reference=reference, on_layer_kv=write)
    cache["index"] = true_len
    return lm_head_logits(x[:, true_len - 1], params), cache


def _contiguous_step(params, token, cfg, cache, read_len, index, row_dtype,
                     suffix=None):
    """The layer stack for one token per row at ``index`` against the
    buffer's first ``read_len`` rows (and the suffix, if any); returns the
    logits [B, V] and the fresh rows [L, B, nkv, hd]."""
    if token.dim() == 1:
        token = token[:, None]
    B = token.shape[0]
    positions = torch.full((B, 1), index, dtype=torch.long,
                           device=token.device)
    x = _embed(params, token, cfg, positions=positions,
               token_types=False)                               # [B, 1, H]
    T = cache["k"].shape[3]
    W = read_len if read_len and read_len < T else T
    k_rows, v_rows = [], []
    for i, lp in enumerate(_layers(params)):
        ck, cv = cache["k"][i, :, :, :W], cache["v"][i, :, :, :W]
        sc = ((cache["k_scale"][i, :, :, :W], cache["v_scale"][i, :, :, :W])
              if "k_scale" in cache else None)
        sfx = (None if suffix is None
               else (suffix["k"][i], suffix["v"][i], suffix["count"]))
        x, (k_row, v_row) = transformer_layer(
            x, lp, cfg, positions=positions, row_dtype=row_dtype,
            attend=lambda q, kv, ck=ck, cv=cv, sc=sc, sfx=sfx, i=i:
                _decode_attention(q, ck, cv, index, cfg, kv_row=kv,
                                  kv_scale=sc, kv_suffix=sfx,
                                  window=_window(cfg, i)))
        k_rows.append(k_row[:, :, 0])
        v_rows.append(v_row[:, :, 0])
    return (_final_logits(x, params, cfg)[:, 0, :], torch.stack(k_rows),
            torch.stack(v_rows))


def decode_step(params: Params, token, cfg: TransformerConfig,
                cache: Params, read_len: Optional[int] = None):
    """One incremental decode step. token: [B] or [B, 1] -> (logits [B, V],
    cache). Attention reads the buffer's first ``read_len`` rows (the
    caller guarantees index < read_len), then all layers' fresh rows are
    written at ``index`` in place (quantized into an int8 cache), O(row)
    per token, and the cursor moves on. As JAX's ``dynamic_update_slice``,
    a cursor at or past the buffer writes into its last row (such steps'
    tokens are discarded)."""
    index = int(cache["index"])
    row_dtype = (cfg.dtype if cfg.kv_cache_bits == 8
                 else cache["k"].dtype)
    logits, k_rows, v_rows = _contiguous_step(
        params, token, cfg, cache, read_len, index, row_dtype)
    at = (slice(None), slice(None), slice(None),
          min(index, cache["k"].shape[3] - 1))
    _write_rows(cache, "k", at, k_rows)
    _write_rows(cache, "v", at, v_rows)
    cache["index"] = index + 1
    return logits, cache


def init_suffix(cfg: TransformerConfig, batch_size: int, seg_len: int,
                cache: Optional[Params] = None, device=None) -> Params:
    """The two-level decode's segment buffers [L, B, nkv, seg, hd] and the
    written-row ``count``, on the cache's device: in a float cache's dtype
    (the merge is a plain write), in the compute dtype for an int8 cache
    (the merge quantizes)."""
    shape = (cfg.num_layers, batch_size, _local_kv_heads(cfg), seg_len,
             cfg.dim_per_head)
    dtype = cfg.dtype
    if cache is not None:
        device = cache["k"].device
        if cache["k"].dtype != torch.int8:
            dtype = cache["k"].dtype
    else:
        device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "count": 0}


def decode_step_suffix(params: Params, token, cfg: TransformerConfig,
                       cache: Params, suffix: Params,
                       read_len: Optional[int] = None):
    """One decode step against a frozen prefix cache plus the segment
    suffix: the buffer is only read, the fresh rows go into the suffix at
    ``count``. Returns (logits [B, V], suffix). ``merge_suffix`` folds a
    finished segment into the buffer."""
    count = int(suffix["count"])
    index = int(cache["index"]) + count
    logits, k_rows, v_rows = _contiguous_step(
        params, token, cfg, cache, read_len, index, suffix["k"].dtype,
        suffix=suffix)
    at = min(count, suffix["k"].shape[3] - 1)
    suffix["k"][:, :, :, at] = k_rows
    suffix["v"][:, :, :, at] = v_rows
    suffix["count"] = count + 1
    return logits, suffix


def merge_suffix(cfg: TransformerConfig, cache: Params,
                 suffix: Params) -> Params:
    """Fold a segment's suffix rows into the buffer at the cursor (one
    O(seg) write a segment; an int8 cache quantizes them here) and advance
    the cursor by ``count``. As JAX's ``dynamic_update_slice``, a segment
    that would run past the buffer is written at its end."""
    index = int(cache["index"])
    seg = suffix["k"].shape[3]
    at = max(0, min(index, cache["k"].shape[3] - seg))
    where = (slice(None), slice(None), slice(None), slice(at, at + seg))
    _write_rows(cache, "k", where, suffix["k"])
    _write_rows(cache, "v", where, suffix["v"])
    cache["index"] = index + int(suffix["count"])
    return cache


# --------------------------------------------------------------------------
# ModelSpec — what the engines consume
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ModelSpec:
    """The config plus the training and serving functions, bound to it:
    the paged protocol (pools, prefill, decode step, span), the contiguous
    cache of one-shot ``generate`` (init_cache, prefill, decode_step) and
    its two-level suffix (init_suffix, decode_step_suffix, merge_suffix),
    as JAX's ``ModelSpec`` carries them."""
    config: TransformerConfig
    name: str
    init: Callable[..., Params]
    loss_fn: Callable[..., torch.Tensor]
    apply: Callable[..., torch.Tensor]
    init_paged_cache: Callable[..., Params]
    prefill_paged: Callable[..., torch.Tensor]
    decode_step_paged: Callable[..., torch.Tensor]
    decode_span_paged: Callable[..., torch.Tensor]
    init_cache: Callable[..., Params]
    prefill: Callable[..., Tuple[torch.Tensor, Params]]
    decode_step: Callable[..., Tuple[torch.Tensor, Params]]
    init_suffix: Callable[..., Params]
    decode_step_suffix: Callable[..., Tuple[torch.Tensor, Params]]
    merge_suffix: Callable[..., Params]

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
        init=lambda generator, device, dtype=None, keep=None:
            init_params(cfg, generator, device, dtype=dtype, keep=keep),
        loss_fn=lambda params, batch, dropout_seed=None, label_count=None,
            train=False, **extras: lm_loss(params, batch, cfg,
                                           dropout_seed=dropout_seed,
                                           label_count=label_count,
                                           train=train, **extras),
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
        decode_span_paged=lambda params, tokens, pools, block_tables,
            seq_lens, **kw:
            decode_span_paged(params, tokens, cfg, pools, block_tables,
                              seq_lens, **kw),
        init_cache=lambda batch_size, max_len, dtype=None, device=None:
            init_cache(cfg, batch_size, max_len, dtype=dtype, device=device),
        prefill=lambda params, input_ids, cache, **kw:
            prefill(params, input_ids, cfg, cache, **kw),
        decode_step=lambda params, token, cache, **kw:
            decode_step(params, token, cfg, cache, **kw),
        init_suffix=lambda batch_size, seg_len, cache=None, device=None:
            init_suffix(cfg, batch_size, seg_len, cache=cache, device=device),
        decode_step_suffix=lambda params, token, cache, suffix, **kw:
            decode_step_suffix(params, token, cfg, cache, suffix, **kw),
        merge_suffix=lambda cache, suffix: merge_suffix(cfg, cache, suffix),
    )

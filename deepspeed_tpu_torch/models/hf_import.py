"""HuggingFace <-> port parameter trees, from local files only: the port's
copy of ``deepspeed_tpu/models/hf_import.py``.

Reference: ``deepspeed/runtime/state_dict_factory.py:189`` (MegatronSDLoader
— merge/split external state dicts across model parallel ranks) and
``deepspeed/module_inject/load_checkpoint.py`` (HF layer-by-layer weight
loading).

``load_hf_params`` returns ONE whole tree of numpy arrays in the JAX
layout (the same tree as JAX's ``load_hf_params`` with ``shardings=None``),
checked leaf for leaf against the port's own ``init_params`` shapes;
``models/convert.params_from_numpy`` moves it to the card (or the CPU),
and with ``mesh=`` cuts a rank's slice of every leaf of any family before
the copy, so an imported family serves or trains on a tensor, expert,
data or fsdp mesh straight from the one tree.
The same tables run backwards export a tree to an HF-layout state dict
(Llama and GPT-2 layouts), ``hf_config_to_transformer`` builds the port's
config from a ``config.json``, ``load_peft_adapter`` reads a PEFT LoRA
adapter into ``ServingEngine.register_adapter``'s tables and
``load_megatron_params`` merges Megatron-LM tensor-parallel ranks.

Supported families: Llama/Mistral (GQA, rotary, silu-GLU, rmsnorm), Mixtral
(MoE), GPT-2 (fused-qkv Conv1D, learned positions), OPT, BLOOM (alibi,
embed-LN, interleaved fused qkv), BERT/RoBERTa/DistilBERT (bidirectional
post-LN encoders, segment embeddings), CLIP's text tower, GPT-J (parallel
block, shared LN, partial interleaved rotary, head bias), GPT-Neo (local
windows, unscaled attention) and GPT-NeoX (parallel residual, two LNs,
partial rotary).

Sources are a state dict (numpy arrays or torch tensors), an object with
``state_dict()``, a file or a checkpoint directory (sharded or not, with or
without an index JSON): ``.bin`` / ``.pt`` files load through
``torch.load(weights_only=True)``, ``.safetensors`` files through the small
numpy reader below (``read_safetensors``: an 8-byte header length, a JSON
header, raw little-endian bytes; BF16 widened to f32), so no package beyond
numpy and torch is needed. Nothing is fetched: a name that is not a local
path raises.
"""

import json
import logging
import os
import re
import struct
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)

logger = logging.getLogger("deepspeed_tpu_torch")

__all__ = ["load_hf_params", "export_hf_state_dict",
           "hf_config_to_transformer", "load_peft_adapter",
           "load_megatron_params", "read_safetensors"]


# --------------------------------------------------------------------------
# streaming state-dict sources
# --------------------------------------------------------------------------

def _iter_state_dict(src) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (hf_key, numpy array) from a dict, a torch state_dict, an object
    with ``state_dict()``, or a local file or checkpoint directory
    (safetensors / pytorch_model.bin, sharded or not). Directory shards
    stream one file at a time."""
    if hasattr(src, "state_dict"):  # an nn.Module
        src = src.state_dict()
    if isinstance(src, dict):
        for k, v in src.items():
            yield k, _to_numpy(v)
        return
    path = os.fspath(src)
    if os.path.isfile(path):
        yield from _iter_file(path)
        return
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint path {path!r} does not exist "
                                "(only local files are read)")
    # index json (sharded) or single-file conventions
    for index_name in ("model.safetensors.index.json",
                       "pytorch_model.bin.index.json"):
        idx = os.path.join(path, index_name)
        if os.path.exists(idx):
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            for shard in sorted(set(weight_map.values())):
                yield from _iter_file(os.path.join(path, shard))
            return
    for name in ("model.safetensors", "pytorch_model.bin"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            yield from _iter_file(p)
            return
    shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no model weights found under {path!r}")
    for shard in shards:
        yield from _iter_file(os.path.join(path, shard))


def _iter_file(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    if path.endswith(".safetensors"):
        yield from read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for k, v in sd.items():
            yield k, _to_numpy(v)


# the safetensors dtype names and their little-endian numpy types (BF16
# is read as uint16 bits and widened)
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
              "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
              "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (name, numpy array) from a ``.safetensors`` file, names in
    sorted order (as ``safe_open(...).keys()``). The format: an unsigned
    little-endian 8-byte header length N, N bytes of JSON mapping each
    name to its ``dtype``, ``shape`` and ``data_offsets`` [begin, end)
    (relative to the byte after the header; ``__metadata__`` is skipped),
    then the raw bytes. Each tensor is read on its own (peak memory: one
    tensor); BF16 is widened to f32 exactly (its bits are the high half
    of the f32's)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name in sorted(k for k in header if k != "__metadata__"):
            meta = header[name]
            dt = meta["dtype"]
            if dt not in _ST_DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {dt}, "
                                 f"not one of {sorted(_ST_DTYPES)}")
            begin, end = meta["data_offsets"]
            f.seek(base + begin)
            arr = np.frombuffer(f.read(end - begin), dtype=_ST_DTYPES[dt])
            shape = tuple(meta["shape"])
            if arr.size != int(np.prod(shape, dtype=np.int64)):
                raise ValueError(f"{path}: tensor {name!r} holds {arr.size} "
                                 f"elements for shape {shape}")
            if dt == "BF16":
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            yield name, arr.reshape(shape).copy()


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.float().numpy()
        return v.numpy()
    return np.asarray(v)


# --------------------------------------------------------------------------
# key-mapping tables (JAX's, as they are)
# --------------------------------------------------------------------------

# Each entry: hf key regex -> (dest path fn, transform fn). Dest path is
# ("layers", name, layer_idx) for stacked per-layer params or (name,) for
# top-level; transform maps the HF array to our layout (torch Linear stores
# [out, in]; our matmuls are x @ W so weights are [in, out]).

def _t(x):
    return np.ascontiguousarray(x.T)


def _llama_table(cfg):
    L = [
        (r"^(?:model\.)?embed_tokens\.weight$", ("tok_embed",), None),
        (r"^(?:model\.)?norm\.weight$", ("final_norm_scale",), None),
        (r"^lm_head\.weight$", ("lm_head",), _t),
        (r"^(?:model\.)?layers\.(\d+)\.input_layernorm\.weight$",
         ("layers", "ln1_scale"), None),
        (r"^(?:model\.)?layers\.(\d+)\.post_attention_layernorm\.weight$",
         ("layers", "ln2_scale"), None),
        (r"^(?:model\.)?layers\.(\d+)\.self_attn\.q_proj\.weight$",
         ("layers", "wq"), _t),
        (r"^(?:model\.)?layers\.(\d+)\.self_attn\.k_proj\.weight$",
         ("layers", "wk"), _t),
        (r"^(?:model\.)?layers\.(\d+)\.self_attn\.v_proj\.weight$",
         ("layers", "wv"), _t),
        (r"^(?:model\.)?layers\.(\d+)\.self_attn\.o_proj\.weight$",
         ("layers", "wo"), _t),
        (r"^(?:model\.)?layers\.(\d+)\.mlp\.gate_proj\.weight$",
         ("layers", "w_gate"), _t),
        (r"^(?:model\.)?layers\.(\d+)\.mlp\.up_proj\.weight$",
         ("layers", "w_in"), _t),
        (r"^(?:model\.)?layers\.(\d+)\.mlp\.down_proj\.weight$",
         ("layers", "w_out"), _t),
    ]
    return L


def _mixtral_table(cfg):
    """Llama backbone + block-sparse MoE: per-expert w1 (gate), w2 (down),
    w3 (up) stack onto the leading expert dim of moe_w_gate/out/in; the
    router Linear becomes wg. Reference coverage: the MoE containers in
    ``module_inject/containers`` + ``deepspeed/moe/layer.py`` weight layout."""
    L = [r for r in _llama_table(cfg)
         if "mlp" not in r[0]]  # dense MLP rows replaced by experts
    L += [
        (r"^(?:model\.)?layers\.(\d+)\.block_sparse_moe\.gate\.weight$",
         ("layers", "wg"), _t),
        (r"^(?:model\.)?layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w1\.weight$",
         ("layers", "moe_w_gate"), _t),
        (r"^(?:model\.)?layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w2\.weight$",
         ("layers", "moe_w_out"), _t),
        (r"^(?:model\.)?layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w3\.weight$",
         ("layers", "moe_w_in"), _t),
    ]
    return L


def _opt_table(cfg):
    S = cfg.max_seq_len

    def pos_slice(w):
        # OPTLearnedPositionalEmbedding carries a +2 offset: rows 0/1 are
        # padding artifacts; row i+2 is position i
        return w[2:2 + S]

    pre = r"^(?:model\.)?decoder\."
    lyr = pre + r"layers\.(\d+)\."
    L = [
        (pre + r"embed_tokens\.weight$", ("tok_embed",), None),
        (pre + r"embed_positions\.weight$", ("pos_embed",), pos_slice),
        (pre + r"final_layer_norm\.weight$", ("final_norm_scale",), None),
        (pre + r"final_layer_norm\.bias$", ("final_norm_bias",), None),
        (r"^lm_head\.weight$", ("lm_head",), _t),
        (lyr + r"self_attn_layer_norm\.weight$", ("layers", "ln1_scale"), None),
        (lyr + r"self_attn_layer_norm\.bias$", ("layers", "ln1_bias"), None),
        (lyr + r"self_attn\.q_proj\.weight$", ("layers", "wq"), _t),
        (lyr + r"self_attn\.q_proj\.bias$", ("layers", "bq"), None),
        (lyr + r"self_attn\.k_proj\.weight$", ("layers", "wk"), _t),
        (lyr + r"self_attn\.k_proj\.bias$", ("layers", "bk"), None),
        (lyr + r"self_attn\.v_proj\.weight$", ("layers", "wv"), _t),
        (lyr + r"self_attn\.v_proj\.bias$", ("layers", "bv"), None),
        (lyr + r"self_attn\.out_proj\.weight$", ("layers", "wo"), _t),
        (lyr + r"self_attn\.out_proj\.bias$", ("layers", "bo"), None),
        (lyr + r"final_layer_norm\.weight$", ("layers", "ln2_scale"), None),
        (lyr + r"final_layer_norm\.bias$", ("layers", "ln2_bias"), None),
        (lyr + r"fc1\.weight$", ("layers", "w_in"), _t),
        (lyr + r"fc1\.bias$", ("layers", "b_in"), None),
        (lyr + r"fc2\.weight$", ("layers", "w_out"), _t),
        (lyr + r"fc2\.bias$", ("layers", "b_out"), None),
    ]
    return L


def _bloom_table(cfg):
    """BLOOM: alibi positions, embedding layernorm, per-head-INTERLEAVED
    fused qkv ([nh, 3, hd, H] row blocks, unlike GPT-2's [q|k|v] concat)."""
    nh, hd = cfg.num_heads, cfg.dim_per_head

    def split_qkv(w):  # [3H, H] -> three [H, H] (ours: x @ W)
        w = w.reshape(nh, 3, hd, w.shape[-1])
        return [np.ascontiguousarray(w[:, i].reshape(nh * hd, -1).T)
                for i in range(3)]

    def split_qkv_bias(b):
        b = b.reshape(nh, 3, hd)
        return [np.ascontiguousarray(b[:, i].reshape(-1)) for i in range(3)]

    pre = r"^(?:transformer\.)?"
    lyr = pre + r"h\.(\d+)\."
    return [
        (pre + r"word_embeddings\.weight$", ("tok_embed",), None),
        (pre + r"word_embeddings_layernorm\.weight$",
         ("embed_norm_scale",), None),
        (pre + r"word_embeddings_layernorm\.bias$",
         ("embed_norm_bias",), None),
        (pre + r"ln_f\.weight$", ("final_norm_scale",), None),
        (pre + r"ln_f\.bias$", ("final_norm_bias",), None),
        (r"^lm_head\.weight$", ("lm_head",), _t),
        (lyr + r"input_layernorm\.weight$", ("layers", "ln1_scale"), None),
        (lyr + r"input_layernorm\.bias$", ("layers", "ln1_bias"), None),
        (lyr + r"post_attention_layernorm\.weight$",
         ("layers", "ln2_scale"), None),
        (lyr + r"post_attention_layernorm\.bias$",
         ("layers", "ln2_bias"), None),
        (lyr + r"self_attention\.query_key_value\.weight$",
         ("layers", ("wq", "wk", "wv")), split_qkv),
        (lyr + r"self_attention\.query_key_value\.bias$",
         ("layers", ("bq", "bk", "bv")), split_qkv_bias),
        (lyr + r"self_attention\.dense\.weight$", ("layers", "wo"), _t),
        (lyr + r"self_attention\.dense\.bias$", ("layers", "bo"), None),
        (lyr + r"mlp\.dense_h_to_4h\.weight$", ("layers", "w_in"), _t),
        (lyr + r"mlp\.dense_h_to_4h\.bias$", ("layers", "b_in"), None),
        (lyr + r"mlp\.dense_4h_to_h\.weight$", ("layers", "w_out"), _t),
        (lyr + r"mlp\.dense_4h_to_h\.bias$", ("layers", "b_out"), None),
    ]


def _gpt2_table(cfg):
    H = cfg.hidden_size
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head

    def split_qkv(w):  # Conv1D weight [in, 3H] -> three [in, H]
        return np.split(w, [nh * hd, nh * hd + nkv * hd], axis=-1)

    def split_qkv_bias(b):
        return np.split(b, [nh * hd, nh * hd + nkv * hd], axis=-1)

    L = [
        (r"^(?:transformer\.)?wte\.weight$", ("tok_embed",), None),
        (r"^(?:transformer\.)?wpe\.weight$", ("pos_embed",), None),
        (r"^lm_head\.weight$", ("lm_head",), _t),
        (r"^(?:transformer\.)?ln_f\.weight$", ("final_norm_scale",), None),
        (r"^(?:transformer\.)?ln_f\.bias$", ("final_norm_bias",), None),
        (r"^(?:transformer\.)?h\.(\d+)\.ln_1\.weight$", ("layers", "ln1_scale"), None),
        (r"^(?:transformer\.)?h\.(\d+)\.ln_1\.bias$", ("layers", "ln1_bias"), None),
        (r"^(?:transformer\.)?h\.(\d+)\.ln_2\.weight$", ("layers", "ln2_scale"), None),
        (r"^(?:transformer\.)?h\.(\d+)\.ln_2\.bias$", ("layers", "ln2_bias"), None),
        # GPT-2 Conv1D stores [in, out] — no transpose, but qkv is fused
        (r"^(?:transformer\.)?h\.(\d+)\.attn\.c_attn\.weight$",
         ("layers", ("wq", "wk", "wv")), split_qkv),
        (r"^(?:transformer\.)?h\.(\d+)\.attn\.c_attn\.bias$",
         ("layers", ("bq", "bk", "bv")), split_qkv_bias),
        (r"^(?:transformer\.)?h\.(\d+)\.attn\.c_proj\.weight$",
         ("layers", "wo"), None),
        (r"^(?:transformer\.)?h\.(\d+)\.attn\.c_proj\.bias$",
         ("layers", "bo"), None),
        (r"^(?:transformer\.)?h\.(\d+)\.mlp\.c_fc\.weight$",
         ("layers", "w_in"), None),
        (r"^(?:transformer\.)?h\.(\d+)\.mlp\.c_fc\.bias$",
         ("layers", "b_in"), None),
        (r"^(?:transformer\.)?h\.(\d+)\.mlp\.c_proj\.weight$",
         ("layers", "w_out"), None),
        (r"^(?:transformer\.)?h\.(\d+)\.mlp\.c_proj\.bias$",
         ("layers", "b_out"), None),
    ]
    return L


def _bert_table(cfg):
    """BERT/RoBERTa encoder (reference: module_inject/containers/bert.py):
    post-LN blocks — attention.output.LayerNorm is our ln1 (applied after
    the attention residual), output.LayerNorm our ln2. The pooler and MLM
    head are out of scope (hidden states + tied-embedding logits)."""
    pre = r"^(?:bert\.|roberta\.)?"
    lyr = pre + r"encoder\.layer\.(\d+)\."
    att = lyr + r"attention\."

    def pos_check(w):
        # A bare RoBERTa encoder dict (no 'roberta.' prefix) detects as
        # BERT; its position table has exactly max_seq_len+2 rows (HF's
        # padding_idx offset). Loading it unsliced would shift every
        # position embedding by two rows — refuse instead of drifting.
        if w.shape[0] == cfg.max_seq_len + 2:
            raise ValueError(
                f"position-embedding table has {w.shape[0]} rows = "
                f"max_seq_len+2 — this looks like a bare RoBERTa state "
                "dict whose rows carry the padding_idx+1=2 offset; pass "
                "family='roberta' so the offset slice is applied")
        return w

    return [
        (pre + r"embeddings\.word_embeddings\.weight$", ("tok_embed",), None),
        (pre + r"embeddings\.position_embeddings\.weight$",
         ("pos_embed",), pos_check),
        (pre + r"embeddings\.token_type_embeddings\.weight$",
         ("tok_type_embed",), None),
        (pre + r"embeddings\.LayerNorm\.weight$", ("embed_norm_scale",), None),
        (pre + r"embeddings\.LayerNorm\.bias$", ("embed_norm_bias",), None),
        (att + r"self\.query\.weight$", ("layers", "wq"), _t),
        (att + r"self\.query\.bias$", ("layers", "bq"), None),
        (att + r"self\.key\.weight$", ("layers", "wk"), _t),
        (att + r"self\.key\.bias$", ("layers", "bk"), None),
        (att + r"self\.value\.weight$", ("layers", "wv"), _t),
        (att + r"self\.value\.bias$", ("layers", "bv"), None),
        (att + r"output\.dense\.weight$", ("layers", "wo"), _t),
        (att + r"output\.dense\.bias$", ("layers", "bo"), None),
        (att + r"output\.LayerNorm\.weight$", ("layers", "ln1_scale"), None),
        (att + r"output\.LayerNorm\.bias$", ("layers", "ln1_bias"), None),
        (lyr + r"intermediate\.dense\.weight$", ("layers", "w_in"), _t),
        (lyr + r"intermediate\.dense\.bias$", ("layers", "b_in"), None),
        (lyr + r"output\.dense\.weight$", ("layers", "w_out"), _t),
        (lyr + r"output\.dense\.bias$", ("layers", "b_out"), None),
        (lyr + r"output\.LayerNorm\.weight$", ("layers", "ln2_scale"), None),
        (lyr + r"output\.LayerNorm\.bias$", ("layers", "ln2_bias"), None),
    ]


def _roberta_table(cfg):
    """RoBERTa = BERT layout with position rows offset by padding_idx+1=2
    (HF's create_position_ids_from_input_ids). Detection needs the
    'roberta.' key prefix; for bare encoder state dicts pass
    family="roberta" explicitly."""
    S = cfg.max_seq_len

    def pos_slice(w):
        return w[2:2 + S]

    table = []
    for pat, dest, tf in _bert_table(cfg):
        if dest == ("pos_embed",):
            tf = pos_slice
        table.append((pat, dest, tf))
    return table


def _clip_table(cfg):
    """CLIP text encoder (reference: module_inject/containers/clip.py —
    HFCLIPLayerPolicy over CLIPEncoderLayer): pre-LN causal text tower,
    quick_gelu MLP, learned positions, final layer norm, no LM head.
    Accepts a bare CLIPTextModel dict or the text half of a full CLIPModel
    (vision keys are skipped; models/clip_vision.py imports that tower)."""
    pre = r"^(?:text_model\.)?"
    lyr = pre + r"encoder\.layers\.(\d+)\."
    att = lyr + r"self_attn\."
    return [
        (pre + r"embeddings\.token_embedding\.weight$", ("tok_embed",),
         None),
        (pre + r"embeddings\.position_embedding\.weight$", ("pos_embed",),
         None),
        (pre + r"final_layer_norm\.weight$", ("final_norm_scale",), None),
        (pre + r"final_layer_norm\.bias$", ("final_norm_bias",), None),
        (att + r"q_proj\.weight$", ("layers", "wq"), _t),
        (att + r"q_proj\.bias$", ("layers", "bq"), None),
        (att + r"k_proj\.weight$", ("layers", "wk"), _t),
        (att + r"k_proj\.bias$", ("layers", "bk"), None),
        (att + r"v_proj\.weight$", ("layers", "wv"), _t),
        (att + r"v_proj\.bias$", ("layers", "bv"), None),
        (att + r"out_proj\.weight$", ("layers", "wo"), _t),
        (att + r"out_proj\.bias$", ("layers", "bo"), None),
        (lyr + r"layer_norm1\.weight$", ("layers", "ln1_scale"), None),
        (lyr + r"layer_norm1\.bias$", ("layers", "ln1_bias"), None),
        (lyr + r"layer_norm2\.weight$", ("layers", "ln2_scale"), None),
        (lyr + r"layer_norm2\.bias$", ("layers", "ln2_bias"), None),
        (lyr + r"mlp\.fc1\.weight$", ("layers", "w_in"), _t),
        (lyr + r"mlp\.fc1\.bias$", ("layers", "b_in"), None),
        (lyr + r"mlp\.fc2\.weight$", ("layers", "w_out"), _t),
        (lyr + r"mlp\.fc2\.bias$", ("layers", "b_out"), None),
    ]


def _gptj_table(cfg):
    """GPT-J (reference: module_inject/containers/gptj.py): parallel
    attn+MLP block with ONE shared LN — ln_1 fills both our ln1 and ln2
    slots; bias-free attention projections; lm_head carries a bias."""
    pre = r"^(?:transformer\.)?"
    lyr = pre + r"h\.(\d+)\."
    return [
        (pre + r"wte\.weight$", ("tok_embed",), None),
        (pre + r"ln_f\.weight$", ("final_norm_scale",), None),
        (pre + r"ln_f\.bias$", ("final_norm_bias",), None),
        (r"^lm_head\.weight$", ("lm_head",), _t),
        (r"^lm_head\.bias$", ("lm_head_bias",), None),
        (lyr + r"ln_1\.weight$",
         ("layers", ("ln1_scale", "ln2_scale")), lambda w: [w, w]),
        (lyr + r"ln_1\.bias$",
         ("layers", ("ln1_bias", "ln2_bias")), lambda b: [b, b]),
        (lyr + r"attn\.q_proj\.weight$", ("layers", "wq"), _t),
        (lyr + r"attn\.k_proj\.weight$", ("layers", "wk"), _t),
        (lyr + r"attn\.v_proj\.weight$", ("layers", "wv"), _t),
        (lyr + r"attn\.out_proj\.weight$", ("layers", "wo"), _t),
        (lyr + r"mlp\.fc_in\.weight$", ("layers", "w_in"), _t),
        (lyr + r"mlp\.fc_in\.bias$", ("layers", "b_in"), None),
        (lyr + r"mlp\.fc_out\.weight$", ("layers", "w_out"), _t),
        (lyr + r"mlp\.fc_out\.bias$", ("layers", "b_out"), None),
    ]


def _gptneo_table(cfg):
    """GPT-Neo (reference: module_inject/containers/gptneo.py): GPT-2-shaped
    block but with nn.Linear projections ([out, in] — transposed, unlike
    GPT-2's Conv1D), un-fused q/k/v with NO biases, and alternating
    global/local attention (handled by cfg.attn_windows, not weights)."""
    pre = r"^(?:transformer\.)?"
    lyr = pre + r"h\.(\d+)\."
    att = lyr + r"attn\.attention\."
    return [
        (pre + r"wte\.weight$", ("tok_embed",), None),
        (pre + r"wpe\.weight$", ("pos_embed",), None),
        (r"^lm_head\.weight$", ("lm_head",), _t),
        (pre + r"ln_f\.weight$", ("final_norm_scale",), None),
        (pre + r"ln_f\.bias$", ("final_norm_bias",), None),
        (lyr + r"ln_1\.weight$", ("layers", "ln1_scale"), None),
        (lyr + r"ln_1\.bias$", ("layers", "ln1_bias"), None),
        (lyr + r"ln_2\.weight$", ("layers", "ln2_scale"), None),
        (lyr + r"ln_2\.bias$", ("layers", "ln2_bias"), None),
        (att + r"q_proj\.weight$", ("layers", "wq"), _t),
        (att + r"k_proj\.weight$", ("layers", "wk"), _t),
        (att + r"v_proj\.weight$", ("layers", "wv"), _t),
        (att + r"out_proj\.weight$", ("layers", "wo"), _t),
        (att + r"out_proj\.bias$", ("layers", "bo"), None),
        (lyr + r"mlp\.c_fc\.weight$", ("layers", "w_in"), _t),
        (lyr + r"mlp\.c_fc\.bias$", ("layers", "b_in"), None),
        (lyr + r"mlp\.c_proj\.weight$", ("layers", "w_out"), _t),
        (lyr + r"mlp\.c_proj\.bias$", ("layers", "b_out"), None),
    ]


def _distilbert_table(cfg):
    """DistilBERT (reference: module_inject/containers/distil_bert.py):
    BERT-shaped post-LN encoder, no token-type embeddings; sa_layer_norm is
    our ln1 (after the attention residual), output_layer_norm our ln2."""
    pre = r"^(?:distilbert\.)?"
    lyr = pre + r"transformer\.layer\.(\d+)\."
    att = lyr + r"attention\."
    return [
        (pre + r"embeddings\.word_embeddings\.weight$", ("tok_embed",), None),
        (pre + r"embeddings\.position_embeddings\.weight$",
         ("pos_embed",), None),
        (pre + r"embeddings\.LayerNorm\.weight$", ("embed_norm_scale",), None),
        (pre + r"embeddings\.LayerNorm\.bias$", ("embed_norm_bias",), None),
        (att + r"q_lin\.weight$", ("layers", "wq"), _t),
        (att + r"q_lin\.bias$", ("layers", "bq"), None),
        (att + r"k_lin\.weight$", ("layers", "wk"), _t),
        (att + r"k_lin\.bias$", ("layers", "bk"), None),
        (att + r"v_lin\.weight$", ("layers", "wv"), _t),
        (att + r"v_lin\.bias$", ("layers", "bv"), None),
        (att + r"out_lin\.weight$", ("layers", "wo"), _t),
        (att + r"out_lin\.bias$", ("layers", "bo"), None),
        (lyr + r"sa_layer_norm\.weight$", ("layers", "ln1_scale"), None),
        (lyr + r"sa_layer_norm\.bias$", ("layers", "ln1_bias"), None),
        (lyr + r"ffn\.lin1\.weight$", ("layers", "w_in"), _t),
        (lyr + r"ffn\.lin1\.bias$", ("layers", "b_in"), None),
        (lyr + r"ffn\.lin2\.weight$", ("layers", "w_out"), _t),
        (lyr + r"ffn\.lin2\.bias$", ("layers", "b_out"), None),
        (lyr + r"output_layer_norm\.weight$", ("layers", "ln2_scale"), None),
        (lyr + r"output_layer_norm\.bias$", ("layers", "ln2_bias"), None),
    ]


def _gptneox_table(cfg):
    """GPT-NeoX (reference: module_inject/containers/gptneox.py): parallel
    residual with two LNs, per-head-interleaved fused qkv like BLOOM."""
    nh, hd = cfg.num_heads, cfg.dim_per_head

    def split_qkv(w):  # [3H, H], rows interleaved [nh, 3, hd]
        w = w.reshape(nh, 3, hd, w.shape[-1])
        return [np.ascontiguousarray(w[:, i].reshape(nh * hd, -1).T)
                for i in range(3)]

    def split_qkv_bias(b):
        b = b.reshape(nh, 3, hd)
        return [np.ascontiguousarray(b[:, i].reshape(-1)) for i in range(3)]

    pre = r"^(?:gpt_neox\.)?"
    lyr = pre + r"layers\.(\d+)\."
    return [
        (pre + r"embed_in\.weight$", ("tok_embed",), None),
        (pre + r"final_layer_norm\.weight$", ("final_norm_scale",), None),
        (pre + r"final_layer_norm\.bias$", ("final_norm_bias",), None),
        (r"^embed_out\.weight$", ("lm_head",), _t),
        (lyr + r"input_layernorm\.weight$", ("layers", "ln1_scale"), None),
        (lyr + r"input_layernorm\.bias$", ("layers", "ln1_bias"), None),
        (lyr + r"post_attention_layernorm\.weight$",
         ("layers", "ln2_scale"), None),
        (lyr + r"post_attention_layernorm\.bias$",
         ("layers", "ln2_bias"), None),
        (lyr + r"attention\.query_key_value\.weight$",
         ("layers", ("wq", "wk", "wv")), split_qkv),
        (lyr + r"attention\.query_key_value\.bias$",
         ("layers", ("bq", "bk", "bv")), split_qkv_bias),
        (lyr + r"attention\.dense\.weight$", ("layers", "wo"), _t),
        (lyr + r"attention\.dense\.bias$", ("layers", "bo"), None),
        (lyr + r"mlp\.dense_h_to_4h\.weight$", ("layers", "w_in"), _t),
        (lyr + r"mlp\.dense_h_to_4h\.bias$", ("layers", "b_in"), None),
        (lyr + r"mlp\.dense_4h_to_h\.weight$", ("layers", "w_out"), _t),
        (lyr + r"mlp\.dense_4h_to_h\.bias$", ("layers", "b_out"), None),
    ]


# keys the import skips (patterns stay strings: ``re`` caches them)
_SKIP = (r"(rotary_emb\.inv_freq|\.attn\.(bias|masked_bias)$"
         r"|\.attention\.(bias|masked_bias|rotary_emb)"
         r"|pooler\.dense\.|cls\.|position_ids$"
         # full-CLIP extras: the vision tower (JAX's models/clip_vision.py,
         # not ported yet: ROADMAP A, item 7); projections are out of scope
         r"|^vision_model\.|^visual_projection\."
         r"|^text_projection\.|^logit_scale$"
         # DistilBERT MLM/classification heads: hidden states +
         # tied-embedding logits, as with BERT's cls.* head
         r"|^vocab_(transform|layer_norm|projector)\."
         r"|^(pre_)?classifier\.|^qa_outputs\.)")


_TABLES = {"llama": _llama_table, "gpt2": _gpt2_table,
           "mixtral": _mixtral_table, "opt": _opt_table,
           "bloom": _bloom_table, "bert": _bert_table,
           "roberta": _roberta_table, "clip": _clip_table,
           "gptj": _gptj_table, "gpt_neox": _gptneox_table,
           "gpt_neo": _gptneo_table, "distilbert": _distilbert_table}


def _detect_family(keys) -> str:
    # order matters: OPT has self_attn.q_proj too (under decoder.), BERT has
    # word_embeddings (BLOOM's marker), NeoX has dense_h_to_4h (also
    # BLOOM's) — test the distinctive keys first
    for k in keys:
        if "block_sparse_moe" in k:
            return "mixtral"
        if k.startswith("roberta."):
            return "roberta"
        if "text_model." in k or "token_embedding" in k:
            return "clip"
        if (k.startswith("distilbert.") or "sa_layer_norm" in k
                or "output_layer_norm" in k or ".q_lin." in k
                or ".ffn.lin1." in k):
            return "distilbert"
        if "encoder.layer." in k or "token_type_embeddings" in k:
            return "bert"
        if ("gpt_neox." in k or "embed_in." in k or "embed_out." in k
                or (".attention.query_key_value" in k
                    and "self_attention" not in k)):
            return "gpt_neox"
        if "decoder.embed_positions" in k or "decoder.layers." in k:
            return "opt"
        # bloom-DISTINCTIVE only: plain word_embeddings is also BERT's and
        # dense_h_to_4h is also NeoX's — those must stay pending
        if "word_embeddings_layernorm" in k or "self_attention." in k:
            return "bloom"
    for k in keys:
        if "decoder." in k:
            continue  # OPT-shaped: wait for a distinctive decoder key
        if ("self_attn.q_proj" in k or "embed_tokens" in k
                or k.startswith(("model.layers.", "layers."))):
            return "llama"
        # GPT-J: bias-free separated projections under .attn. (GPT-2's are
        # fused c_attn; llama's sit under .self_attn.)
        if ".self_attn." not in k and (
                ".attn.q_proj" in k or ".attn.k_proj" in k
                or ".attn.v_proj" in k or ".attn.out_proj" in k
                or ".mlp.fc_in." in k or ".mlp.fc_out." in k):
            return "gptj"
        # GPT-Neo: un-fused projections under .attn.attention. (GPT-2's are
        # fused c_attn; shares wpe/ln_2/mlp.c_fc with GPT-2, so only this
        # marker is distinctive)
        if ".attn.attention." in k:
            return "gpt_neo"
        # gpt2 needs a DISTINCTIVE marker, not just the h.* prefix (BLOOM
        # also uses h.N., GPT-J shares wte/ln_1, GPT-Neo shares
        # wpe/ln_2/mlp.c_* — their keys must stay pending until a
        # family-distinctive key streams by)
        if ".attn.c_attn." in k or ".attn.c_proj." in k:
            return "gpt2"
    raise ValueError("unrecognized checkpoint family; expected Llama/Mixtral/"
                     "OPT/BLOOM/GPT-2/BERT/GPT-J/GPT-NeoX-style keys")


# --------------------------------------------------------------------------
# import
# --------------------------------------------------------------------------

def _reference_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """The port's own leaf set and shapes for ``cfg`` ("tok_embed",
    "layers/wq", ...): ``init_params`` on the meta device (no memory)."""
    tree = init_params(cfg, None, "meta")
    out = {f"layers/{k}": tuple(v.shape) for k, v in tree["layers"].items()}
    out.update({k: tuple(v.shape) for k, v in tree.items() if k != "layers"})
    return out


def load_hf_params(src, cfg: TransformerConfig, *, dtype=None,
                   family: Optional[str] = None,
                   strict: bool = True) -> Dict[str, Any]:
    """Convert an HF checkpoint to the port's param tree (numpy, the JAX
    layout: JAX's ``load_hf_params`` with ``shardings=None``), then check
    it against the port's own leaf set (``init_params``' names and
    shapes). ``src``: a local directory / file / state dict / object with
    ``state_dict()``; ``cfg``: the port's config of the checkpoint's
    architecture (``hf_config_to_transformer``); ``dtype``: the numpy dtype
    of the leaves (default f32); ``family``: skips detection (needed for a
    bare RoBERTa encoder dict); ``strict``: an unmapped key raises. Move
    the tree with ``models/convert.params_from_numpy``."""
    dtype = np.dtype(dtype) if dtype is not None else np.float32
    Lcount = cfg.num_layers
    out: Dict[str, Any] = {"layers": {}}
    table = None
    fam = family
    seen_layers: Dict[str, set] = {}
    E = cfg.num_experts

    def place(dest, layer_idx, arr, expert_idx=None):
        if dest[0] == "lm_head" and cfg.tie_embeddings:
            return  # tied checkpoints carry a redundant copy of the embedding
        arr = arr.astype(dtype, copy=False)
        if dest[0] == "layers":
            name = dest[1]
            buf = out["layers"].get(name)
            if expert_idx is None:
                if buf is None:
                    buf = np.empty((Lcount,) + arr.shape, dtype)
                    out["layers"][name] = buf
                buf[layer_idx] = arr
                key = layer_idx
            else:  # per-expert stacked weights: [L, E, ...]
                if expert_idx >= E:
                    raise ValueError(f"checkpoint expert {expert_idx} >= "
                                     f"cfg.num_experts {E}")
                if buf is None:
                    buf = np.empty((Lcount, E) + arr.shape, dtype)
                    out["layers"][name] = buf
                buf[layer_idx, expert_idx] = arr
                key = (layer_idx, expert_idx)
            seen_layers.setdefault(name, set()).add(key)
        else:
            out[dest[0]] = arr

    n_loaded = 0

    def process(key, arr):
        nonlocal n_loaded
        matched = False
        for pat, dest, tf in table:
            m = re.match(pat, key)
            if not m:
                continue
            matched = True
            groups = m.groups()
            layer_idx = int(groups[0]) if groups else None
            expert_idx = int(groups[1]) if len(groups) > 1 else None
            if layer_idx is not None and layer_idx >= Lcount:
                raise ValueError(
                    f"checkpoint layer {layer_idx} >= cfg.num_layers {Lcount}")
            val = tf(arr) if tf is not None else arr
            if isinstance(dest[1] if len(dest) > 1 else None, tuple):
                for sub, v in zip(dest[1], val):
                    place(("layers", sub), layer_idx, v)
            else:
                place(dest, layer_idx, val, expert_idx)
            n_loaded += 1
            break
        if not matched and not re.search(_SKIP, key):
            if strict:
                raise ValueError(
                    f"hf import: unmapped key {key!r} — the checkpoint has "
                    "weights this architecture mapping would silently drop "
                    "(pass strict=False to skip them)")
            logger.warning(f"hf import: unmapped key {key!r} (skipped)")

    # family detection may need more than the first key (e.g. a shard that
    # starts with lm_head.weight) — buffer until a distinctive key shows up,
    # but bounded: an unrecognized checkpoint must fail fast, not stream every
    # shard into host RAM on the way to the error.
    _PENDING_CAP = 64
    pending = []
    for key, arr in _iter_state_dict(src):
        if table is None:
            if len(pending) >= _PENDING_CAP:
                raise ValueError(
                    f"unrecognized checkpoint family after {_PENDING_CAP} "
                    "keys; expected Llama-style (self_attn.q_proj) or "
                    "GPT-2-style (attn.c_attn) keys")
            pending.append((key, arr))
            try:
                fam = fam or _detect_family([k for k, _ in pending])
            except ValueError:
                continue
            if fam == "llama" and cfg.num_experts > 1:
                fam = "mixtral"  # llama backbone + experts in the config
            table = _TABLES[fam](cfg)
            logger.info(f"hf import: detected {fam}-family checkpoint")
            for k, a in pending:
                process(k, a)
            pending = []
            continue
        process(key, arr)
    if table is None:
        raise ValueError("unrecognized checkpoint family; no distinctive "
                         "Llama/GPT-2 keys found")

    if cfg.tie_embeddings:
        out.pop("lm_head", None)
    elif "lm_head" not in out and "tok_embed" in out:
        # some checkpoints tie but the config says untied: clone the embedding
        out["lm_head"] = _t(out["tok_embed"])
        logger.info("hf import: lm_head absent in checkpoint; using tied "
                    "tok_embed")
    if n_loaded == 0:
        raise ValueError("no weights matched the mapping table")
    for name, idxs in seen_layers.items():
        per_expert = bool(idxs) and isinstance(next(iter(idxs)), tuple)
        expected = Lcount * E if per_expert else Lcount
        if len(idxs) != expected:
            if per_expert:
                missing_l = sorted(
                    {(l, e) for l in range(Lcount) for e in range(E)} - idxs)
            else:
                missing_l = sorted(set(range(Lcount)) - idxs)
            raise ValueError(f"hf import: layers.{name} missing indices "
                             f"{missing_l[:8]} (num_layers={Lcount}, "
                             f"num_experts={E})")

    # the port's own leaf set and shapes
    ref = _reference_shapes(cfg)
    got = {f"layers/{k}": v.shape for k, v in out["layers"].items()}
    got.update({k: v.shape for k, v in out.items() if k != "layers"})
    missing = [k for k in ref if k not in got]
    if missing:
        raise ValueError(f"hf import: checkpoint missing params {missing}")
    for k, shape in ref.items():
        if tuple(got[k]) != shape:
            raise ValueError(f"hf import: {k} shape {tuple(got[k])} != "
                             f"expected {shape}")
    return out


# --------------------------------------------------------------------------
# PEFT LoRA adapters (multi-tenant serving)
# --------------------------------------------------------------------------

# PEFT names each factor under the wrapped module's path, e.g.
#   base_model.model.model.layers.3.self_attn.q_proj.lora_A.weight
# (the leading wrapper prefix varies by how the model was wrapped, so only
# the stable tail is matched). torch Linear stores [out, in]: lora_A is
# [r, in] and lora_B is [out, r]; our matmuls are x @ W, so both transpose.
_PEFT_KEY_RE = (
    r"layers\.(\d+)\.self_attn\.([qkvo])_proj\.lora_([AB])\.weight$")


def load_peft_adapter(src, cfg, adapter_config: Optional[dict] = None):
    """Load a PEFT LoRA checkpoint into the serving engine's table layout.

    ``src`` is anything ``_iter_state_dict`` accepts — a state dict, an
    ``adapter_model.safetensors`` file, or a PEFT output directory (where
    ``adapter_config.json`` is read for ``r``/``lora_alpha`` unless
    ``adapter_config`` is passed explicitly). Returns ``(tables, alpha)``
    with ``tables[proj] = (A [L, In, r], B [L, r, Out])`` — exactly what
    ``ServingEngine.register_adapter`` takes::

        srv.register_adapter(7, *load_peft_adapter(peft_dir, cfg))

    Every layer must carry the same projections at the same rank (the
    device slot pool has ONE shape); partial or ragged checkpoints raise.
    """
    path = None
    if not isinstance(src, dict) and not hasattr(src, "state_dict"):
        path = os.fspath(src)
        if os.path.isdir(path):
            cand = os.path.join(path, "adapter_model.safetensors")
            if not os.path.exists(cand):
                cand = os.path.join(path, "adapter_model.bin")
            if adapter_config is None:
                cfg_path = os.path.join(path, "adapter_config.json")
                if os.path.exists(cfg_path):
                    with open(cfg_path) as f:
                        adapter_config = json.load(f)
            src = cand

    L = cfg.num_layers
    # {proj: {layer: {"A"/"B": arr}}}
    raw: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    for key, arr in _iter_state_dict(src):
        m = re.search(_PEFT_KEY_RE, key)
        if m is None:
            continue
        layer, proj, which = int(m.group(1)), m.group(2), m.group(3)
        if layer >= L:
            raise ValueError(f"peft import: {key!r} indexes layer {layer} "
                             f"but the model has {L} layers")
        raw.setdefault(proj, {}).setdefault(layer, {})[which] = _t(arr)
    if not raw:
        raise ValueError("peft import: no lora_A/lora_B attention-projection "
                         "tensors found (expected keys like "
                         "'...layers.N.self_attn.q_proj.lora_A.weight')")

    rank = None
    tables: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for proj, per_layer in sorted(raw.items()):
        missing = [i for i in range(L)
                   if set(per_layer.get(i, ())) != {"A", "B"}]
        if missing:
            raise ValueError(f"peft import: {proj}_proj missing lora_A/B "
                             f"at layers {missing} — every layer must "
                             "carry the adapter (one pool shape)")
        a = np.stack([per_layer[i]["A"] for i in range(L)])  # [L, In, r]
        b = np.stack([per_layer[i]["B"] for i in range(L)])  # [L, r, Out]
        r = a.shape[-1]
        if rank is None:
            rank = r
        if r != rank or b.shape[1] != rank:
            raise ValueError(f"peft import: {proj}_proj rank {r} != {rank} "
                             "elsewhere — mixed-rank adapters don't fit "
                             "one slot pool")
        tables[proj] = (np.asarray(a, np.float32), np.asarray(b, np.float32))

    alpha = None
    if adapter_config is not None:
        cfg_r = adapter_config.get("r")
        if cfg_r is not None and int(cfg_r) != rank:
            raise ValueError(f"peft import: adapter_config.json r={cfg_r} "
                             f"but tensors have rank {rank}")
        if adapter_config.get("lora_alpha") is not None:
            alpha = float(adapter_config["lora_alpha"])
    return tables, alpha


def _numpy_tree(tree):
    """A param tree (nested dicts of tensors or arrays) as numpy."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return _to_numpy(tree)


# --------------------------------------------------------------------------
# export (our tree -> HF layout)
# --------------------------------------------------------------------------

def export_hf_state_dict(params, cfg: TransformerConfig, *,
                         family: Optional[str] = None
                         ) -> Dict[str, np.ndarray]:
    """Inverse mapping (JAX's ``export_hf_state_dict``): an HF-layout state
    dict (numpy) from a tree of numpy arrays or tensors (on any device;
    bf16 widened to f32). Covers the Llama and GPT-2 layouts;
    ``load_hf_params`` round-trips through it."""
    params = _numpy_tree(params)
    if (family in ("opt", "bloom", "mixtral", "bert", "roberta", "gptj",
                   "gpt_neox", "gpt_neo", "distilbert")
            or cfg.num_experts > 1
            or cfg.activation == "relu" or cfg.position_type == "alibi"
            or cfg.parallel_block or not cfg.causal or not cfg.qkv_bias
            or cfg.type_vocab_size or cfg.head_bias or cfg.attn_windows):
        raise NotImplementedError(
            "export_hf_state_dict covers the Llama and GPT-2 layouts; "
            "Mixtral/OPT/BLOOM/BERT/GPT-J/GPT-NeoX export is import-only "
            "for now (a gelu-OPT tree is structurally gpt2-shaped — pass "
            "family='opt' to get this error instead of a gpt2-layout dict)")
    fam = family or ("gpt2" if cfg.position_type == "learned" else "llama")
    sd: Dict[str, np.ndarray] = {}
    lp = params["layers"]
    if fam == "llama":
        sd["model.embed_tokens.weight"] = params["tok_embed"]
        sd["model.norm.weight"] = params["final_norm_scale"]
        if "lm_head" in params:
            sd["lm_head.weight"] = _t(params["lm_head"])
        names = [("input_layernorm.weight", "ln1_scale", None),
                 ("post_attention_layernorm.weight", "ln2_scale", None),
                 ("self_attn.q_proj.weight", "wq", _t),
                 ("self_attn.k_proj.weight", "wk", _t),
                 ("self_attn.v_proj.weight", "wv", _t),
                 ("self_attn.o_proj.weight", "wo", _t),
                 ("mlp.gate_proj.weight", "w_gate", _t),
                 ("mlp.up_proj.weight", "w_in", _t),
                 ("mlp.down_proj.weight", "w_out", _t)]
        for i in range(cfg.num_layers):
            for hf_name, ours, tf in names:
                if ours not in lp:
                    continue
                v = lp[ours][i]
                sd[f"model.layers.{i}.{hf_name}"] = tf(v) if tf else v
    else:
        sd["transformer.wte.weight"] = params["tok_embed"]
        if "pos_embed" in params:
            sd["transformer.wpe.weight"] = params["pos_embed"]
        sd["transformer.ln_f.weight"] = params["final_norm_scale"]
        if "final_norm_bias" in params:
            sd["transformer.ln_f.bias"] = params["final_norm_bias"]
        if "lm_head" in params:
            sd["lm_head.weight"] = _t(params["lm_head"])
        for i in range(cfg.num_layers):
            pre = f"transformer.h.{i}"
            sd[f"{pre}.ln_1.weight"] = lp["ln1_scale"][i]
            sd[f"{pre}.ln_1.bias"] = lp["ln1_bias"][i]
            sd[f"{pre}.ln_2.weight"] = lp["ln2_scale"][i]
            sd[f"{pre}.ln_2.bias"] = lp["ln2_bias"][i]
            sd[f"{pre}.attn.c_attn.weight"] = np.concatenate(
                [lp["wq"][i], lp["wk"][i], lp["wv"][i]], axis=-1)
            sd[f"{pre}.attn.c_attn.bias"] = np.concatenate(
                [lp["bq"][i], lp["bk"][i], lp["bv"][i]], axis=-1)
            sd[f"{pre}.attn.c_proj.weight"] = lp["wo"][i]
            sd[f"{pre}.attn.c_proj.bias"] = lp["bo"][i]
            sd[f"{pre}.mlp.c_fc.weight"] = lp["w_in"][i]
            sd[f"{pre}.mlp.c_fc.bias"] = lp["b_in"][i]
            sd[f"{pre}.mlp.c_proj.weight"] = lp["w_out"][i]
            sd[f"{pre}.mlp.c_proj.bias"] = lp["b_out"][i]
    return sd


# --------------------------------------------------------------------------
# HF config -> TransformerConfig
# --------------------------------------------------------------------------

def _even_rotary(head_dim: int, pct: float) -> int:
    rd = int(head_dim * pct)
    if rd % 2:
        raise ValueError(
            f"rotary_pct {pct} of head_dim {head_dim} gives odd "
            f"rotary_dim {rd}; rotation pairs dims — use an even value")
    return max(2, rd)


def hf_config_to_transformer(hf_cfg, **overrides):
    """The port's ``TransformerConfig`` from a transformers
    ``PretrainedConfig`` or a ``config.json`` dict (JAX's
    ``hf_config_to_transformer``; ``overrides`` win, ``dtype`` among
    them)."""
    get = (hf_cfg.get if isinstance(hf_cfg, dict)
           else lambda k, d=None: getattr(hf_cfg, k, d))
    mt = (get("model_type") or "").lower()
    if mt == "qwen2":
        # qwen2 is llama-shaped EXCEPT for attention biases, which the rmsnorm
        # param tree does not carry — importing would silently drop them.
        raise ValueError("qwen2 attention biases are not supported yet; "
                         "convert without biases explicitly if acceptable")
    if mt in ("llama", "mistral", "mixtral"):
        kw = dict(
            vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            num_kv_heads=get("num_key_value_heads"),
            intermediate_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 4096),
            rope_theta=float(get("rope_theta", 10000.0)),
            norm_eps=get("rms_norm_eps", 1e-5),
            position_type="rotary", activation="silu_glu",
            norm_type="rmsnorm",
            tie_embeddings=bool(get("tie_word_embeddings", False)))
        if mt == "mixtral":
            kw.update(
                num_experts=get("num_local_experts", 8),
                top_k=get("num_experts_per_tok", 2),
                moe_aux_loss_weight=float(get("router_aux_loss_coef", 0.02)),
                use_residual=False)
    elif mt == "opt":
        if get("word_embed_proj_dim", get("hidden_size")) != get("hidden_size"):
            raise ValueError(
                "OPT word_embed_proj_dim != hidden_size (the 350m-style "
                "embedding projection) is not supported")
        if not get("do_layer_norm_before", True):
            raise ValueError("OPT do_layer_norm_before=False (the 350m "
                             "post-norm variant) is not supported")
        act = get("activation_function", "relu")
        if act not in ("relu", "gelu"):
            raise ValueError(f"unsupported OPT activation {act!r}")
        kw = dict(
            vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            intermediate_size=get("ffn_dim"),
            max_seq_len=get("max_position_embeddings", 2048),
            position_type="learned", activation=act,
            norm_type="layernorm",
            tie_embeddings=bool(get("tie_word_embeddings", True)))
    elif mt == "bloom":
        H = get("hidden_size") or get("n_embed")
        kw = dict(
            vocab_size=get("vocab_size"), hidden_size=H,
            num_layers=get("n_layer") or get("num_hidden_layers"),
            num_heads=get("n_head") or get("num_attention_heads"),
            intermediate_size=4 * H,
            max_seq_len=get("seq_length", 2048),
            norm_eps=get("layer_norm_epsilon", 1e-5),
            position_type="alibi", activation="gelu",
            norm_type="layernorm", embed_norm=True,
            tie_embeddings=bool(get("tie_word_embeddings", True)))
    elif mt in ("bert", "roberta"):
        # encoder family (reference: module_inject/containers/bert.py +
        # distilbert.py): bidirectional, post-LN, segment embeddings.
        # RoBERTa's learned-position table carries a padding_idx+1=2 row
        # offset (its import table slices it off), so usable positions are
        # max_position_embeddings - 2.
        max_pos = get("max_position_embeddings", 512)
        if mt == "roberta":
            max_pos -= 2
        kw = dict(
            vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            intermediate_size=get("intermediate_size"),
            max_seq_len=max_pos,
            norm_eps=get("layer_norm_eps", 1e-12),
            position_type="learned", activation="gelu",
            norm_type="layernorm", causal=False, norm_style="post",
            embed_norm=True, final_norm=False,
            type_vocab_size=get("type_vocab_size", 2) or 0,
            tie_embeddings=True)
    elif mt == "distilbert":
        # reference: module_inject/containers/distil_bert.py — BERT-shaped
        # post-LN encoder, no token-type embeddings
        if get("sinusoidal_pos_embds", False):
            raise ValueError("distilbert sinusoidal_pos_embds=True is not "
                             "supported (learned-position table expected)")
        kw = dict(
            vocab_size=get("vocab_size"), hidden_size=get("dim"),
            num_layers=get("n_layers"), num_heads=get("n_heads"),
            intermediate_size=get("hidden_dim"),
            max_seq_len=get("max_position_embeddings", 512),
            norm_eps=1e-12,
            position_type="learned", activation="gelu",
            norm_type="layernorm", causal=False, norm_style="post",
            embed_norm=True, final_norm=False, type_vocab_size=0,
            tie_embeddings=True)
    elif mt == "gpt_neo":
        # reference: module_inject/containers/gptneo.py — GPT-2-shaped block
        # with alternating global/local attention (attention_layers pattern;
        # local layers see a window_size band)
        H = get("hidden_size")
        att_layers = get("attention_layers")
        if not att_layers:
            # raw config.json dicts carry the documented attention_types
            # form [[[kinds...], repeat], ...]; HF derives attention_layers
            att_layers = [a for kinds, rep in (get("attention_types") or [])
                          for _ in range(rep) for a in kinds]
        window = int(get("window_size", 256))
        wins = tuple(window if a == "local" else 0
                     for a in att_layers) or None
        if wins is not None and all(w == 0 for w in wins):
            wins = None
        kw = dict(
            vocab_size=get("vocab_size"), hidden_size=H,
            num_layers=get("num_layers"),
            num_heads=get("num_heads"),
            intermediate_size=get("intermediate_size") or 4 * H,
            max_seq_len=get("max_position_embeddings", 2048),
            norm_eps=get("layer_norm_epsilon", 1e-5),
            position_type="learned", activation="gelu",
            norm_type="layernorm", qkv_bias=False, attn_out_bias=True,
            attn_windows=wins,
            attn_scale=1.0,   # GPT-Neo trains UNSCALED (HF softmax_scale=1)
            tie_embeddings=bool(get("tie_word_embeddings", True)))
    elif mt in ("clip", "clip_text_model"):
        # CLIP text tower (reference: module_inject/containers/clip.py).
        # A full CLIPModel config nests it under text_config.
        tc = get("text_config") if mt == "clip" else None
        if tc is not None and not isinstance(tc, dict):
            tc = getattr(tc, "to_dict", lambda: vars(tc))()
        g2 = (lambda k, d=None: tc.get(k, d)) if tc else get
        act = g2("hidden_act", "quick_gelu")
        kw = dict(
            vocab_size=g2("vocab_size"), hidden_size=g2("hidden_size"),
            num_layers=g2("num_hidden_layers"),
            num_heads=g2("num_attention_heads"),
            intermediate_size=g2("intermediate_size"),
            max_seq_len=g2("max_position_embeddings", 77),
            norm_eps=g2("layer_norm_eps", 1e-5),
            position_type="learned",
            activation="quick_gelu" if act == "quick_gelu" else "gelu",
            norm_type="layernorm", causal=True, qkv_bias=True,
            final_norm=True, tie_embeddings=True)
    elif mt == "gptj":
        # reference: module_inject/containers/gptj.py — parallel attn+MLP
        # residual, single shared LN, partial interleaved rotary, head bias
        kw = dict(
            vocab_size=get("vocab_size"), hidden_size=get("n_embd"),
            num_layers=get("n_layer"), num_heads=get("n_head"),
            intermediate_size=get("n_inner") or 4 * get("n_embd"),
            max_seq_len=get("n_positions", 2048),
            norm_eps=get("layer_norm_epsilon", 1e-5),
            position_type="rotary", rotary_dim=get("rotary_dim", 64),
            rotary_interleaved=True, parallel_block=True,
            activation="gelu", norm_type="layernorm", qkv_bias=False,
            tie_embeddings=False, head_bias=True)
    elif mt == "gpt_neox":
        # reference: module_inject/containers/gptneox.py — parallel residual
        # (two LNs), rotary over rotary_pct of the head dim
        if not get("use_parallel_residual", True):
            raise ValueError("gpt_neox use_parallel_residual=False is not "
                             "supported (sequential NeoX variant)")
        hd = get("hidden_size") // get("num_attention_heads")
        kw = dict(
            vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            intermediate_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 2048),
            norm_eps=get("layer_norm_eps", 1e-5),
            position_type="rotary",
            rotary_dim=_even_rotary(hd, float(get("rotary_pct", 0.25))),
            rope_theta=float(get("rotary_emb_base", 10000.0)),
            parallel_block=True, activation="gelu",
            norm_type="layernorm",
            tie_embeddings=bool(get("tie_word_embeddings", False)))
    elif mt in ("gpt2", ""):
        kw = dict(
            vocab_size=get("vocab_size"), hidden_size=get("n_embd"),
            num_layers=get("n_layer"), num_heads=get("n_head"),
            intermediate_size=get("n_inner") or 4 * get("n_embd"),
            max_seq_len=get("n_positions", 1024),
            norm_eps=get("layer_norm_epsilon", 1e-5),
            position_type="learned", activation="gelu",
            norm_type="layernorm", tie_embeddings=True)
    else:
        raise ValueError(f"unsupported model_type {mt!r}")
    kw.update(overrides)
    sw = get("sliding_window")
    if mt == "mistral" and sw and kw["max_seq_len"] > sw \
            and "attn_windows" not in overrides:
        # every layer slides: the per-layer band mask keeps logits
        # HF-exact beyond the window
        kw["attn_windows"] = (int(sw),) * kw["num_layers"]
        logger.warning(
            f"mistral sliding_window={sw} < max_seq_len="
            f"{kw['max_seq_len']}: per-layer band masks keep logits "
            "HF-exact, but windowed layers take the plain O(S^2) attention "
            "(the flash kernel has no band) — pass "
            "max_seq_len<=sliding_window to stay on the flash kernel "
            "within the window")
    return TransformerConfig(**kw)


# --------------------------------------------------------------------------
# Megatron-LM TP-rank checkpoint merge
# --------------------------------------------------------------------------

def _flatten_nested(d, prefix=""):
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flatten_nested(v, key)
        else:
            yield key, v


def load_megatron_params(sources, cfg, dtype=None) -> Dict[str, Any]:
    """Merge Megatron-LM tensor-parallel rank checkpoints into one tree.

    Reference: ``deepspeed/runtime/state_dict_factory.py:189``
    (MegatronSDLoader.merge_state_dict — qkv/mlp column merges, attention
    dense / mlp output row merges); JAX's ``load_megatron_params``.
    `sources`: one state dict (or .pt path / nested Megatron checkpoint
    dict) per TP rank, rank order. Column-parallel weights concat on the
    output dim, row-parallel on the input dim; fused qkv is per-head
    interleaved ([nh/tp, 3, hd, H] per rank). Returns one whole numpy
    tree (``models/convert.params_from_numpy`` moves it, and slices a
    rank's share on a mesh).
    """
    nh, hd = cfg.num_heads, cfg.dim_per_head
    if cfg.kv_heads != nh:
        raise ValueError("megatron merge supports MHA only (the fused qkv "
                         f"interleave assumes kv_heads == num_heads; got "
                         f"{cfg.kv_heads} != {nh})")
    rank_sds = []
    for src in sources:
        if isinstance(src, dict) and not any(
                hasattr(v, "shape") for v in src.values()):
            # nested megatron layout ({'model': {'language_model': ...}});
            # drop non-tensor metadata (iteration, args, rng_state, ...)
            sd = {k: _to_numpy(v) for k, v in _flatten_nested(src)
                  if hasattr(v, "shape")}
        elif isinstance(src, dict):
            sd = {k: _to_numpy(v) for k, v in src.items()
                  if hasattr(v, "shape")}
        else:
            sd = {}
            for k, v in _iter_state_dict(src):
                sd[k] = v
        # strip wrapper prefixes down to language_model.*
        out = {}
        for k, v in sd.items():
            for pre in ("model.language_model.", "module.language_model.",
                        "language_model."):
                if k.startswith(pre):
                    k = k[len(pre):]
                    break
            out[k] = v
        rank_sds.append(out)

    tp = len(rank_sds)
    if nh % tp:
        raise ValueError(f"num_heads {nh} not divisible by tp degree {tp}")

    def gather(key):
        vals = [sd[key] for sd in rank_sds if key in sd]
        if len(vals) not in (0, tp):
            raise ValueError(f"megatron merge: key {key!r} present in "
                             f"{len(vals)}/{tp} ranks")
        return vals

    def merge_qkv(vals):
        """Per-rank fused qkv [3H/tp, H] (heads interleaved) -> wq/wk/wv."""
        qs, ks, vs = [], [], []
        for w in vals:
            per = nh // tp
            if w.ndim == 2:
                w4 = w.reshape(per, 3, hd, w.shape[-1])
                qs.append(w4[:, 0].reshape(per * hd, -1))
                ks.append(w4[:, 1].reshape(per * hd, -1))
                vs.append(w4[:, 2].reshape(per * hd, -1))
            else:  # bias [3H/tp]
                b3 = w.reshape(per, 3, hd)
                qs.append(b3[:, 0].reshape(-1))
                ks.append(b3[:, 1].reshape(-1))
                vs.append(b3[:, 2].reshape(-1))
        cat = [np.concatenate(x, axis=0) for x in (qs, ks, vs)]
        if cat[0].ndim == 2:
            return [_t(c) for c in cat]
        return cat

    L = cfg.num_layers
    layers: Dict[str, list] = {}
    params: Dict[str, Any] = {}

    def put_layer(name, i, arr):
        layers.setdefault(name, [None] * L)[i] = arr

    lyr = r"^(?:encoder|transformer)\.layers\.(\d+)\.(.+)$"
    for key in sorted(set().union(*[sd.keys() for sd in rank_sds])):
        vals = gather(key)
        if not vals:
            continue
        if key in ("embedding.word_embeddings.weight",):
            params["tok_embed"] = np.concatenate(vals, axis=0)[:cfg.vocab_size]
            continue
        if key == "embedding.position_embeddings.weight":
            params["pos_embed"] = vals[0]
            continue
        m = re.match(lyr, key)
        if m is None:
            if key.endswith("final_layernorm.weight"):
                params["final_norm_scale"] = vals[0]
            elif key.endswith("final_layernorm.bias"):
                params["final_norm_bias"] = vals[0]
            elif "output_layer" in key or "lm_head" in key:
                # vocab dim may be Megatron-padded (divisible-by rounding)
                params["lm_head"] = _t(
                    np.concatenate(vals, axis=0)[:cfg.vocab_size])
            elif "_extra_state" in key or "rotary" in key:
                continue
            else:
                logger.warning(f"megatron merge: unmapped key {key!r}")
            continue
        i, rest = int(m.group(1)), m.group(2)
        if rest == "input_layernorm.weight":
            put_layer("ln1_scale", i, vals[0])
        elif rest == "input_layernorm.bias":
            put_layer("ln1_bias", i, vals[0])
        elif rest == "post_attention_layernorm.weight":
            put_layer("ln2_scale", i, vals[0])
        elif rest == "post_attention_layernorm.bias":
            put_layer("ln2_bias", i, vals[0])
        elif rest in ("attention.query_key_value.weight",
                      "self_attention.query_key_value.weight"):
            q, k, v = merge_qkv(vals)
            put_layer("wq", i, q), put_layer("wk", i, k), put_layer("wv", i, v)
        elif rest in ("attention.query_key_value.bias",
                      "self_attention.query_key_value.bias"):
            q, k, v = merge_qkv(vals)
            put_layer("bq", i, q), put_layer("bk", i, k), put_layer("bv", i, v)
        elif rest in ("attention.dense.weight", "self_attention.dense.weight"):
            put_layer("wo", i, _t(np.concatenate(vals, axis=1)))  # row-par
        elif rest in ("attention.dense.bias", "self_attention.dense.bias"):
            put_layer("bo", i, vals[0])
        elif rest == "mlp.dense_h_to_4h.weight":
            put_layer("w_in", i, _t(np.concatenate(vals, axis=0)))  # col-par
        elif rest == "mlp.dense_h_to_4h.bias":
            put_layer("b_in", i, np.concatenate(vals, axis=0))
        elif rest == "mlp.dense_4h_to_h.weight":
            put_layer("w_out", i, _t(np.concatenate(vals, axis=1)))
        elif rest == "mlp.dense_4h_to_h.bias":
            put_layer("b_out", i, vals[0])
        elif "_extra_state" in rest or "rotary" in rest:
            continue
        else:
            logger.warning(f"megatron merge: unmapped layer key {key!r}")

    want = np.dtype("float32") if dtype is None else np.dtype(dtype)
    for name, stack in layers.items():
        missing = [i for i, a in enumerate(stack) if a is None]
        if missing:
            raise ValueError(f"megatron merge: layer param {name!r} missing "
                             f"for layers {missing}")
        params.setdefault("layers", {})[name] = np.stack(stack).astype(want)
    params = {k: (v.astype(want) if hasattr(v, "astype") else v)
              for k, v in params.items()}
    if cfg.tie_embeddings:
        params.pop("lm_head", None)
    return params

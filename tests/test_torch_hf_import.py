"""The port's ``models/hf_import`` against the JAX package's: HF-layout
state dicts drawn from a seed with each family's key names load into the
same numpy tree in both packages, leaf for leaf; the export, the config
conversion, the PEFT adapter and the Megatron merge agree with JAX's; and
the ``.bin`` and sharded ``.safetensors`` readers load what the in-memory
dict loads. The files are written here (the safetensors bytes by hand:
an 8-byte header length, a JSON header, raw little-endian data)."""

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

from deepspeed_tpu.models import hf_import as jh
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import hf_import as ph
from deepspeed_tpu_torch.models import transformer as pt

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

V, H, L, NH, F, S = 128, 64, 2, 4, 128, 64
COMMON = dict(vocab_size=V, hidden_size=H, num_hidden_layers=L,
              num_attention_heads=NH, intermediate_size=F,
              max_position_embeddings=S)
HF_CONFIGS = {
    "llama": dict(COMMON, model_type="llama", num_key_value_heads=2,
                  rope_theta=10000.0, rms_norm_eps=1e-5,
                  tie_word_embeddings=False),
    "mixtral": dict(COMMON, model_type="mixtral", num_key_value_heads=2,
                    num_local_experts=4, num_experts_per_tok=2),
    "opt": dict(COMMON, model_type="opt", ffn_dim=F,
                activation_function="relu", word_embed_proj_dim=H),
    "bloom": dict(model_type="bloom", vocab_size=V, hidden_size=H,
                  n_layer=L, n_head=NH, seq_length=S),
    "gpt2": dict(model_type="gpt2", vocab_size=V, n_embd=H, n_layer=L,
                 n_head=NH, n_positions=S),
    "bert": dict(COMMON, model_type="bert", type_vocab_size=2),
    "roberta": dict(COMMON, model_type="roberta", type_vocab_size=1,
                    max_position_embeddings=S + 2),
    "clip": dict(COMMON, model_type="clip_text_model",
                 max_position_embeddings=32),
    "gptj": dict(model_type="gptj", vocab_size=V, n_embd=H, n_layer=L,
                 n_head=NH, n_positions=S, rotary_dim=8),
    "gpt_neo": dict(model_type="gpt_neo", vocab_size=V, hidden_size=H,
                    num_layers=L, num_heads=NH, max_position_embeddings=S,
                    attention_types=[[["global", "local"], 1]],
                    window_size=8),
    "distilbert": dict(model_type="distilbert", vocab_size=V, dim=H,
                       n_layers=L, n_heads=NH, hidden_dim=F,
                       max_position_embeddings=S),
    "gpt_neox": dict(COMMON, model_type="gpt_neox", rotary_pct=0.25),
    "mistral": dict(COMMON, model_type="mistral", num_key_value_heads=2,
                    sliding_window=16),
}
FAMILIES = [k for k in HF_CONFIGS if k != "mistral"]


def _hf_shapes(fam, cfg):
    """{HF key: shape} of a ``fam`` checkpoint of ``cfg`` (torch Linear
    weights [out, in], GPT-2's Conv1D [in, out]), with a few keys the
    import skips (attention bias buffers, a pooler, rotary tables)."""
    hd, nkv = cfg.dim_per_head, cfg.kv_heads
    q, kv, Fd, E = NH * hd, nkv * hd, cfg.ffn_dim, cfg.num_experts
    out = {}

    def ln(prefix):
        out[prefix + ".weight"] = (H,)
        out[prefix + ".bias"] = (H,)

    def linear(prefix, o, i, bias=True):
        out[prefix + ".weight"] = (o, i)
        if bias:
            out[prefix + ".bias"] = (o,)

    if fam in ("llama", "mixtral", "mistral"):
        out["model.embed_tokens.weight"] = (V, H)
        out["model.norm.weight"] = (H,)
        out["lm_head.weight"] = (V, H)
        for i in range(L):
            p = f"model.layers.{i}."
            out[p + "input_layernorm.weight"] = (H,)
            out[p + "post_attention_layernorm.weight"] = (H,)
            for n, o in (("q", q), ("k", kv), ("v", kv)):
                linear(p + f"self_attn.{n}_proj", o, H, bias=False)
            linear(p + "self_attn.o_proj", H, q, bias=False)
            out[p + "self_attn.rotary_emb.inv_freq"] = (hd // 2,)
            if fam == "mixtral":
                out[p + "block_sparse_moe.gate.weight"] = (E, H)
                for e in range(E):
                    x = p + f"block_sparse_moe.experts.{e}."
                    linear(x + "w1", Fd, H, bias=False)
                    linear(x + "w2", H, Fd, bias=False)
                    linear(x + "w3", Fd, H, bias=False)
            else:
                linear(p + "mlp.gate_proj", Fd, H, bias=False)
                linear(p + "mlp.up_proj", Fd, H, bias=False)
                linear(p + "mlp.down_proj", H, Fd, bias=False)
    elif fam == "opt":
        p0 = "model.decoder."
        out[p0 + "embed_tokens.weight"] = (V, H)
        out[p0 + "embed_positions.weight"] = (S + 2, H)
        ln(p0 + "final_layer_norm")
        for i in range(L):
            p = f"{p0}layers.{i}."
            ln(p + "self_attn_layer_norm")
            for n in ("q", "k", "v", "out"):
                linear(p + f"self_attn.{n}_proj", H, H)
            ln(p + "final_layer_norm")
            linear(p + "fc1", Fd, H)
            linear(p + "fc2", H, Fd)
    elif fam == "bloom":
        out["transformer.word_embeddings.weight"] = (V, H)
        ln("transformer.word_embeddings_layernorm")
        ln("transformer.ln_f")
        for i in range(L):
            p = f"transformer.h.{i}."
            ln(p + "input_layernorm")
            ln(p + "post_attention_layernorm")
            linear(p + "self_attention.query_key_value", 3 * H, H)
            linear(p + "self_attention.dense", H, H)
            linear(p + "mlp.dense_h_to_4h", Fd, H)
            linear(p + "mlp.dense_4h_to_h", H, Fd)
    elif fam == "gpt2":
        out["transformer.wte.weight"] = (V, H)
        out["transformer.wpe.weight"] = (S, H)
        ln("transformer.ln_f")
        for i in range(L):
            p = f"transformer.h.{i}."
            ln(p + "ln_1")
            ln(p + "ln_2")
            out[p + "attn.c_attn.weight"] = (H, 3 * H)
            out[p + "attn.c_attn.bias"] = (3 * H,)
            out[p + "attn.c_proj.weight"] = (H, H)
            out[p + "attn.c_proj.bias"] = (H,)
            out[p + "attn.bias"] = (1, 1, S, S)
            out[p + "mlp.c_fc.weight"] = (H, Fd)
            out[p + "mlp.c_fc.bias"] = (Fd,)
            out[p + "mlp.c_proj.weight"] = (Fd, H)
            out[p + "mlp.c_proj.bias"] = (H,)
    elif fam in ("bert", "roberta"):
        p0 = fam + "."
        out[p0 + "embeddings.word_embeddings.weight"] = (V, H)
        out[p0 + "embeddings.position_embeddings.weight"] = (
            (S + 2 if fam == "roberta" else S), H)
        out[p0 + "embeddings.token_type_embeddings.weight"] = (
            cfg.type_vocab_size, H)
        ln(p0 + "embeddings.LayerNorm")
        for i in range(L):
            p = f"{p0}encoder.layer.{i}."
            for n in ("query", "key", "value"):
                linear(p + f"attention.self.{n}", H, H)
            linear(p + "attention.output.dense", H, H)
            ln(p + "attention.output.LayerNorm")
            linear(p + "intermediate.dense", Fd, H)
            linear(p + "output.dense", H, Fd)
            ln(p + "output.LayerNorm")
        linear(p0 + "pooler.dense", H, H)
    elif fam == "clip":
        p0 = "text_model."
        out[p0 + "embeddings.token_embedding.weight"] = (V, H)
        out[p0 + "embeddings.position_embedding.weight"] = (
            cfg.max_seq_len, H)
        ln(p0 + "final_layer_norm")
        for i in range(L):
            p = f"{p0}encoder.layers.{i}."
            for n in ("q", "k", "v", "out"):
                linear(p + f"self_attn.{n}_proj", H, H)
            ln(p + "layer_norm1")
            ln(p + "layer_norm2")
            linear(p + "mlp.fc1", Fd, H)
            linear(p + "mlp.fc2", H, Fd)
    elif fam == "gptj":
        out["transformer.wte.weight"] = (V, H)
        ln("transformer.ln_f")
        linear("lm_head", V, H)
        for i in range(L):
            p = f"transformer.h.{i}."
            ln(p + "ln_1")
            for n in ("q", "k", "v", "out"):
                linear(p + f"attn.{n}_proj", H, H, bias=False)
            linear(p + "mlp.fc_in", Fd, H)
            linear(p + "mlp.fc_out", H, Fd)
    elif fam == "gpt_neo":
        out["transformer.wte.weight"] = (V, H)
        out["transformer.wpe.weight"] = (S, H)
        ln("transformer.ln_f")
        for i in range(L):
            p = f"transformer.h.{i}."
            ln(p + "ln_1")
            ln(p + "ln_2")
            for n in ("q", "k", "v"):
                linear(p + f"attn.attention.{n}_proj", H, H, bias=False)
            linear(p + "attn.attention.out_proj", H, H)
            linear(p + "mlp.c_fc", Fd, H)
            linear(p + "mlp.c_proj", H, Fd)
    elif fam == "distilbert":
        p0 = "distilbert."
        out[p0 + "embeddings.word_embeddings.weight"] = (V, H)
        out[p0 + "embeddings.position_embeddings.weight"] = (S, H)
        ln(p0 + "embeddings.LayerNorm")
        for i in range(L):
            p = f"{p0}transformer.layer.{i}."
            for n in ("q", "k", "v", "out"):
                linear(p + f"attention.{n}_lin", H, H)
            ln(p + "sa_layer_norm")
            linear(p + "ffn.lin1", Fd, H)
            linear(p + "ffn.lin2", H, Fd)
            ln(p + "output_layer_norm")
    elif fam == "gpt_neox":
        out["gpt_neox.embed_in.weight"] = (V, H)
        ln("gpt_neox.final_layer_norm")
        out["embed_out.weight"] = (V, H)
        for i in range(L):
            p = f"gpt_neox.layers.{i}."
            ln(p + "input_layernorm")
            ln(p + "post_attention_layernorm")
            linear(p + "attention.query_key_value", 3 * H, H)
            linear(p + "attention.dense", H, H)
            linear(p + "mlp.dense_h_to_4h", Fd, H)
            linear(p + "mlp.dense_4h_to_h", H, Fd)
    return out


def _state_dict(fam, cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0.0, 0.1, shape).astype(np.float32)
            for k, shape in _hf_shapes(fam, cfg).items()}


def _configs(fam):
    return (ph.hf_config_to_transformer(HF_CONFIGS[fam]),
            jh.hf_config_to_transformer(HF_CONFIGS[fam]))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _fields(cfg):
    skip = {"dtype", "param_dtype"}
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in skip}


@pytest.mark.parametrize("fam", list(HF_CONFIGS))
def test_hf_config_to_transformer_matches_jax(fam):
    """Every field the port's config shares with JAX's takes JAX's value
    (the mistral dict's sliding window becomes per-layer windows)."""
    pcfg, jcfg = _configs(fam)
    want = _fields(jcfg)
    got = _fields(pcfg)
    shared = set(got) & set(want)
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    # the JAX fields the port leaves out are at their defaults
    assert set(want) - set(got) <= {
        "attention_impl", "scan_layers", "random_ltd", "random_ltd_keep",
        "activation_quant_bits", "progressive_layer_drop", "offload_params"}
    if fam == "mistral":
        assert pcfg.attn_windows == (16,) * L


@pytest.mark.parametrize("fam", FAMILIES)
def test_load_hf_params_matches_jax(fam):
    """The same seeded HF dict through both packages' ``load_hf_params``:
    the trees agree leaf for leaf (names, dtypes, values); the port's tree
    moves with ``params_from_numpy``; a wrong shape raises."""
    pcfg, jcfg = _configs(fam)
    sd = _state_dict(fam, pcfg)
    family = "roberta" if fam == "roberta" else None
    want = jh.load_hf_params(sd, jcfg, family=family)
    got = ph.load_hf_params(sd, pcfg, family=family)
    _assert_trees_equal(got, want)
    moved = convert.params_from_numpy(got, pcfg, device="cpu",
                                      dtype=torch.float32)
    assert set(dict(_flat(moved))) == set(dict(_flat(got)))
    # a layer-0 norm weight (every family has one [H] leaf there)
    key = next(k for k, v in sd.items() if ".0." in k and v.shape == (H,))
    bad = dict(sd)
    bad[key] = np.zeros((H + 1,), np.float32)
    with pytest.raises((ValueError, IndexError)):
        ph.load_hf_params(bad, pcfg, family=family)


def test_import_refusals_match_jax():
    """An unmapped key raises (``strict``) and is skipped otherwise; a
    bare RoBERTa dict read as BERT raises on its offset table; a layer
    past the config raises."""
    pcfg, jcfg = _configs("gpt2")
    sd = _state_dict("gpt2", pcfg)
    sd["transformer.h.0.attn.mystery.weight"] = np.zeros((2,), np.float32)
    for mod, cfg in ((ph, pcfg), (jh, jcfg)):
        with pytest.raises(ValueError, match="unmapped"):
            mod.load_hf_params(sd, cfg)
    _assert_trees_equal(ph.load_hf_params(sd, pcfg, strict=False),
                        jh.load_hf_params(sd, jcfg, strict=False))
    pcfg, jcfg = _configs("roberta")
    bare = {k[len("roberta."):]: v
            for k, v in _state_dict("roberta", pcfg).items()}
    with pytest.raises(ValueError, match="RoBERTa"):
        ph.load_hf_params(bare, pcfg)
    _assert_trees_equal(ph.load_hf_params(bare, pcfg, family="roberta"),
                        jh.load_hf_params(bare, jcfg, family="roberta"))
    short = dataclasses.replace(pcfg, num_layers=1)
    with pytest.raises(ValueError, match="num_layers"):
        ph.load_hf_params(bare, short, family="roberta")


@pytest.mark.parametrize("fam", ["llama", "gpt2"])
def test_export_matches_jax_and_round_trips(fam):
    """``export_hf_state_dict`` of a loaded tree (numpy, and as tensors)
    equals JAX's key for key, and loading the export gives the tree back;
    a family the export does not cover raises as JAX's."""
    pcfg, jcfg = _configs(fam)
    tree = ph.load_hf_params(_state_dict(fam, pcfg), pcfg)
    want = jh.export_hf_state_dict(tree, jcfg)
    got = ph.export_hf_state_dict(tree, pcfg)
    _assert_trees_equal(got, want)
    on_device = convert.params_from_numpy(tree, pcfg, device="cpu",
                                          dtype=torch.float32)
    _assert_trees_equal(ph.export_hf_state_dict(on_device, pcfg), want)
    _assert_trees_equal(ph.load_hf_params(got, pcfg), tree)
    pcfg, _ = _configs("bloom")
    with pytest.raises(NotImplementedError):
        ph.export_hf_state_dict(ph.load_hf_params(
            _state_dict("bloom", pcfg), pcfg), pcfg)


def test_peft_adapter_and_megatron_merge_match_jax(tmp_path):
    """``load_peft_adapter`` (a state dict, and a PEFT directory with its
    ``adapter_config.json`` and ``adapter_model.bin``) and
    ``load_megatron_params`` (two tensor-parallel ranks of a GPT-2-shaped
    Megatron checkpoint, nested and flat) give JAX's tables and tree."""
    pcfg, jcfg = _configs("llama")
    rng = np.random.default_rng(4)
    r, hd = 4, H // NH
    sd = {}
    for i in range(L):
        for proj, out_dim in (("q", H), ("v", 2 * hd)):
            p = f"base_model.model.model.layers.{i}.self_attn.{proj}_proj."
            sd[p + "lora_A.weight"] = rng.normal(0, 0.1, (r, H)).astype(
                np.float32)
            sd[p + "lora_B.weight"] = rng.normal(0, 0.1, (out_dim, r)).astype(
                np.float32)
    conf = {"r": r, "lora_alpha": 8}
    want = jh.load_peft_adapter(sd, jcfg, adapter_config=conf)
    got = ph.load_peft_adapter(sd, pcfg, adapter_config=conf)
    assert got[1] == want[1] == 8.0
    assert sorted(got[0]) == sorted(want[0]) == ["q", "v"]
    for proj in want[0]:
        for a, b in zip(got[0][proj], want[0][proj]):
            np.testing.assert_array_equal(a, b)
    (tmp_path / "adapter_config.json").write_text(json.dumps(conf))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "adapter_model.bin")
    from_dir = ph.load_peft_adapter(str(tmp_path), pcfg)
    assert from_dir[1] == 8.0
    for proj in want[0]:
        for a, b in zip(from_dir[0][proj], want[0][proj]):
            np.testing.assert_array_equal(a, b)

    pcfg, jcfg = _configs("gpt2")
    tp, hd = 2, H // NH
    ranks = []
    for t in range(tp):
        d = {"embedding.word_embeddings.weight":
             rng.normal(0, 0.1, (V // tp, H)).astype(np.float32),
             "embedding.position_embeddings.weight":
             rng.normal(0, 0.1, (S, H)).astype(np.float32),
             "encoder.final_layernorm.weight": np.ones(H, np.float32),
             "encoder.final_layernorm.bias": np.zeros(H, np.float32)}
        for i in range(L):
            p = f"encoder.layers.{i}."
            for n in ("input_layernorm", "post_attention_layernorm"):
                d[p + n + ".weight"] = rng.normal(1, 0.1, H).astype(np.float32)
                d[p + n + ".bias"] = rng.normal(0, 0.1, H).astype(np.float32)
            d[p + "attention.query_key_value.weight"] = rng.normal(
                0, 0.1, (3 * H // tp, H)).astype(np.float32)
            d[p + "attention.query_key_value.bias"] = rng.normal(
                0, 0.1, 3 * H // tp).astype(np.float32)
            d[p + "attention.dense.weight"] = rng.normal(
                0, 0.1, (H, H // tp)).astype(np.float32)
            d[p + "attention.dense.bias"] = rng.normal(0, 0.1, H).astype(
                np.float32)
            d[p + "mlp.dense_h_to_4h.weight"] = rng.normal(
                0, 0.1, (4 * H // tp, H)).astype(np.float32)
            d[p + "mlp.dense_h_to_4h.bias"] = rng.normal(
                0, 0.1, 4 * H // tp).astype(np.float32)
            d[p + "mlp.dense_4h_to_h.weight"] = rng.normal(
                0, 0.1, (H, 4 * H // tp)).astype(np.float32)
            d[p + "mlp.dense_4h_to_h.bias"] = rng.normal(0, 0.1, H).astype(
                np.float32)
        ranks.append(d)
    want = jh.load_megatron_params(ranks, jcfg)
    got = ph.load_megatron_params(ranks, pcfg)
    _assert_trees_equal(got, want)
    nested = [{"model": {"language_model": d}, "iteration": 7}
              for d in ranks]
    _assert_trees_equal(ph.load_megatron_params(nested, pcfg), want)
    convert.params_from_numpy(got, pcfg, device="cpu", dtype=torch.float32)


def _write_safetensors(path, tensors):
    """A ``.safetensors`` file written by hand: f32 arrays as F32, torch
    bfloat16 tensors as BF16 (their raw bits)."""
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in tensors.items():
        if isinstance(t, torch.Tensor):
            raw = t.view(torch.int16).numpy().tobytes()
            dt, shape = "BF16", list(t.shape)
        else:
            raw = np.ascontiguousarray(t, "<f4").tobytes()
            dt, shape = "F32", list(t.shape)
        header[name] = {"dtype": dt, "shape": shape,
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def test_bin_and_sharded_safetensors_readers(tmp_path):
    """A ``pytorch_model.bin`` (``torch.save``) and a directory of two
    ``.safetensors`` shards with ``model.safetensors.index.json`` load the
    tree the in-memory dict loads; one leaf travels as bf16 in both files
    and arrives widened exactly. A missing path raises without a fetch."""
    pcfg, _ = _configs("gpt2")
    sd = _state_dict("gpt2", pcfg)
    wide = "transformer.h.1.mlp.c_fc.weight"
    bf = torch.from_numpy(sd[wide]).to(torch.bfloat16)
    sd[wide] = bf.float().numpy()
    want = ph.load_hf_params(sd, pcfg)

    files = {k: (bf if k == wide else torch.from_numpy(v))
             for k, v in sd.items()}
    (tmp_path / "bin").mkdir()
    torch.save(files, tmp_path / "bin" / "pytorch_model.bin")
    _assert_trees_equal(ph.load_hf_params(str(tmp_path / "bin"), pcfg), want)
    _assert_trees_equal(ph.load_hf_params(
        str(tmp_path / "bin" / "pytorch_model.bin"), pcfg), want)

    shard_dir = tmp_path / "st"
    shard_dir.mkdir()
    keys = sorted(sd)
    halves = {"model-00001-of-00002.safetensors": keys[::2],
              "model-00002-of-00002.safetensors": keys[1::2]}
    weight_map = {}
    for fname, ks in halves.items():
        _write_safetensors(shard_dir / fname,
                           {k: (bf if k == wide else sd[k]) for k in ks})
        weight_map.update({k: fname for k in ks})
    (shard_dir / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))
    _assert_trees_equal(ph.load_hf_params(str(shard_dir), pcfg), want)
    read = dict(ph.read_safetensors(
        str(shard_dir / "model-00001-of-00002.safetensors")))
    assert list(read) == sorted(halves["model-00001-of-00002.safetensors"])
    with pytest.raises(FileNotFoundError):
        ph.load_hf_params(str(tmp_path / "gpt2-from-the-hub"), pcfg)

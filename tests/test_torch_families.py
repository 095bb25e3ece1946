"""The port's model families against the JAX package, at f32, hidden 64 and
2 layers: GPT-2, OPT (relu), BLOOM (ALiBi, embedding norm), GPT-Neo (local
windows, unscaled attention), GPT-J (parallel block, interleaved partial
rotary, head bias), GPT-NeoX (parallel block, partial rotary), BERT (post-LN
encoder, token types, a padded batch) and DistilBERT.

Every bias and norm leaf is drawn from the seed (nonzero) before a
comparison: JAX's init sets biases to 0 and norm scales to 1, where a
dropped ``+ bo`` would pass. The JAX side runs its XLA attention
(``attention_impl="xla"``); the port takes its plain versions on the CPU.

- the leaf set (names, shapes and logical axes of ``init_params``) is
  JAX's for every family config, the layernorm + rotary one included;
- ``forward`` logits within 1e-5 relative L2, ``lm_loss`` within 1e-5 and
  its grads within 1e-4 (per leaf);
- greedy ``generate`` and paged serving streams token-identical to JAX's;
- fused and int8 layer stacks with biases as JAX's;
- positions past the learned table clamp as JAX's gather does;
- a family on a mesh slices its leaves by JAX's rules; what still raises
  names its ROADMAP label.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.parallel.mesh import Mesh, MeshPlan

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

BASE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64)
FAMILIES = {
    "gpt2": dict(position_type="learned", activation="gelu",
                 norm_type="layernorm", tie_embeddings=True),
    "opt": dict(position_type="learned", activation="relu",
                norm_type="layernorm", tie_embeddings=True),
    "bloom": dict(position_type="alibi", activation="gelu",
                  norm_type="layernorm", embed_norm=True,
                  tie_embeddings=True),
    "gpt_neo": dict(position_type="learned", activation="gelu",
                    norm_type="layernorm", qkv_bias=False,
                    attn_out_bias=True, attn_windows=(0, 8), attn_scale=1.0,
                    tie_embeddings=True),
    "gptj": dict(position_type="rotary", rotary_dim=8,
                 rotary_interleaved=True, parallel_block=True,
                 activation="gelu", norm_type="layernorm", qkv_bias=False,
                 tie_embeddings=False, head_bias=True),
    "gpt_neox": dict(position_type="rotary", rotary_dim=4,
                     parallel_block=True, activation="gelu",
                     norm_type="layernorm", tie_embeddings=False),
    "bert": dict(position_type="learned", activation="gelu",
                 norm_type="layernorm", causal=False, norm_style="post",
                 embed_norm=True, final_norm=False, type_vocab_size=2,
                 norm_eps=1e-12, tie_embeddings=True),
    "distilbert": dict(position_type="learned", activation="gelu",
                       norm_type="layernorm", causal=False,
                       norm_style="post", embed_norm=True, final_norm=False,
                       norm_eps=1e-12, tie_embeddings=True),
}
# the leaf-set test also holds the config the port accepted before its
# families existed, with layernorm (JAX's default qkv_bias makes its six
# bias leaves), and a layernorm PR-MoE model
LEAF_CASES = dict(FAMILIES, ln_rotary=dict(
    position_type="rotary", activation="silu_glu", norm_type="layernorm",
    tie_embeddings=False), ln_moe=dict(
    position_type="rotary", activation="gelu", norm_type="layernorm",
    num_experts=4, top_k=2, use_residual=True, tie_embeddings=False))
SERVED = ("gpt2", "bloom", "gpt_neo", "gptj")
ENCODERS = ("bert", "distilbert")
SERVING = dict(max_seqs=2, block_size=16, max_model_len=64,
               decode_quantum=4, prompt_bucket=16)
TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 24


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _jcfg(name, **over):
    return jt.TransformerConfig(**{**BASE, **LEAF_CASES[name], **over},
                                dtype=jnp.float32, attention_impl="xla")


def _pcfg(name, **over):
    return pt.TransformerConfig(**{**BASE, **LEAF_CASES[name], **over},
                                dtype=torch.float32)


def _is_bias_or_norm(path: str) -> bool:
    leaf = path.rsplit("/", 1)[-1]
    return (leaf.startswith("b") or leaf.endswith("_bias")
            or leaf.endswith("_scale"))


def _seeded(name, seed=0):
    """JAX's init of the family as numpy, with every bias and norm leaf
    redrawn from ``seed``: biases N(0, 0.1), norm scales 1 + N(0, 0.1)."""
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(seed),
                                                   _jcfg(name)))
    rng = np.random.default_rng(seed + 1)

    def draw(path, a):
        a = np.asarray(a, np.float32)
        if not _is_bias_or_norm(path):
            return a
        base = 1.0 if path.endswith("_scale") else 0.0
        return (base + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)

    out = {k: draw(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: draw("layers/" + k, v)
                     for k, v in tree["layers"].items()}
    return out


def _inputs(name, seed=3):
    """ids [B, S]; for an encoder a padded batch (row 1's last 6 keys
    masked) and, with token types, random segment ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BASE["vocab_size"], (B, S)).astype(np.int32)
    extra = {}
    if name in ENCODERS:
        mask = np.ones((B, S), np.int32)
        mask[1, S - 6:] = 0
        extra["attention_mask"] = mask
    if LEAF_CASES[name].get("type_vocab_size"):
        extra["token_type_ids"] = rng.integers(0, 2, (B, S)).astype(np.int32)
    return ids, extra


def _leaf_paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# C8: the leaf set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(LEAF_CASES))
def test_leaf_set_matches_jax(name):
    """Names and shapes of both packages' ``init_params`` and their
    ``logical_axes`` agree for every family config (C8: the port's
    layernorm model lacked JAX's six bias leaves)."""
    want = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0),
                                                 _jcfg(name)))
    got = pt.init_params(_pcfg(name), None, "meta")
    want_shapes = {k: tuple(v.shape) for k, v in _leaf_paths(want)}
    got_shapes = {k: tuple(v.shape) for k, v in _leaf_paths(got)}
    assert got_shapes == want_shapes
    jaxes = jt.logical_axes(_jcfg(name))
    paxes = pt.logical_axes(_pcfg(name))
    assert {k: tuple(v) for k, v in _leaf_paths(paxes)} == \
        {k: tuple(v) for k, v in _leaf_paths(jaxes)}
    # a tree of JAX's leaves moves over, and one lacking a leaf does not
    tree = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), want)
    moved = convert.params_from_numpy(tree, _pcfg(name), device="cpu",
                                      dtype=torch.float32)
    assert {k for k, _ in _leaf_paths(moved)} == set(want_shapes)
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_numpy(
            {**tree, "layers": {k: v for k, v in tree["layers"].items()
                                if k != "wo"}},
            _pcfg(name), device="cpu", dtype=torch.float32)


# ---------------------------------------------------------------------------
# forward, loss and grads
# ---------------------------------------------------------------------------

def _jax_loss_and_logits(name, params, ids, extra):
    cfg = _jcfg(name)

    def f(p, ids, extra):
        batch = {"input_ids": ids}
        if "attention_mask" in extra:
            batch["attention_mask"] = extra["attention_mask"]
        logits = jt.forward(p, ids, cfg, **extra)
        return jt.lm_loss(p, batch, cfg), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params, jnp.asarray(ids), {k: jnp.asarray(v) for k, v in
                                   extra.items()})
    return float(loss), np.asarray(logits), jax.tree.map(np.asarray, grads)


def _grad_errors(got, want):
    """Relative L2 per leaf, over max(|want|, 1e-3 |all grads|): a key
    bias's grad is zero up to rounding (it shifts a query's scores by one
    constant), and its relative error would compare noise with noise."""
    total = np.sqrt(sum(np.sum(np.square(np.asarray(w, np.float64)))
                        for _, w in _leaf_paths(want)))
    got = dict(_leaf_paths(got))
    out = {}
    for path, w in _leaf_paths(want):
        w = np.asarray(w, np.float64)
        g = got[path].grad.double().numpy()
        out[path] = float(np.linalg.norm(g - w)
                          / max(np.linalg.norm(w), 1e-3 * total))
    return out


@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_loss_and_grads_match_jax(name):
    params = _seeded(name)
    ids, extra = _inputs(name)
    jloss, jlogits, jgrads = _jax_loss_and_logits(name, params, ids, extra)
    cfg = _pcfg(name)
    tp = convert.params_from_numpy(params, cfg, device="cpu",
                                   dtype=torch.float32)
    for _, t in _leaf_paths(tp):
        t.requires_grad_(True)
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    logits = pt.forward(tp, torch.from_numpy(ids), cfg, **textra)
    assert rel_l2(logits.detach().numpy(), jlogits) <= TOL
    batch = {"input_ids": torch.from_numpy(ids).long()}
    if "attention_mask" in textra:
        batch["attention_mask"] = textra["attention_mask"]
    loss = pt.lm_loss(tp, batch, cfg)
    loss.backward()
    assert abs(loss.item() - jloss) <= TOL * abs(jloss)
    errs = _grad_errors(tp, jgrads)
    assert max(errs.values()) <= GRAD_TOL, errs


def test_positions_past_the_table_clamp_as_jax():
    """``forward`` with explicit positions, some past ``max_seq_len``: the
    learned table's index clamps to its last row, as JAX's gather does
    (an out-of-range index never reaches ``F.embedding``); the chunked
    loss adds GPT-J's head bias as the full head does."""
    params = _seeded("gpt2")
    ids, _ = _inputs("gpt2")
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0) + 50   # 50 .. 73
    cfg = _jcfg("gpt2")
    want = jax.jit(lambda p, i, q: jt.forward(p, i, cfg, positions=q))(
        params, jnp.asarray(ids), jnp.asarray(pos))
    tp = convert.params_from_numpy(params, _pcfg("gpt2"), device="cpu",
                                   dtype=torch.float32)
    got = pt.forward(tp, torch.from_numpy(ids), _pcfg("gpt2"),
                     positions=torch.from_numpy(pos))
    assert rel_l2(got.numpy(), want) <= TOL
    same = pt.forward(tp, torch.from_numpy(ids), _pcfg("gpt2"),
                      positions=torch.from_numpy(pos).clamp(max=63))
    assert torch.equal(got, same)
    gptj = convert.params_from_numpy(_seeded("gptj"), _pcfg("gptj"),
                                     device="cpu", dtype=torch.float32)
    batch = {"input_ids": torch.from_numpy(ids).long()}
    full = pt.lm_loss(gptj, batch, _pcfg("gptj"))
    chunked = pt.lm_loss(gptj, batch, _pcfg("gptj", loss_chunk=8))
    assert abs(float(chunked) - float(full)) <= TOL * abs(float(full))


# ---------------------------------------------------------------------------
# generate and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FAMILIES))
def test_greedy_generate_matches_jax(name):
    """``InferenceEngine.generate`` (fused weights, bqkv included) against
    JAX's on the same seeded params: token-identical, on a batch of two
    prompts of 11 tokens and 9 new ones (the decode steps cross GPT-Neo's
    8-token window)."""
    params = _seeded(name)
    ids = np.random.default_rng(5).integers(
        0, BASE["vocab_size"], (2, 11)).astype(np.int32)
    je = deepspeed_tpu.init_inference(
        jt.make_model(_jcfg(name)), config={"kv_cache_bits": 0},
        dtype=jnp.float32, params=params)
    want = np.asarray(je.generate(jnp.asarray(ids), max_new_tokens=9))
    pe = deepspeed_tpu_torch.init_inference(
        pt.make_model(_pcfg(name)), config={"kv_cache_bits": 0},
        params=params, dtype=torch.float32, device="cpu")
    got = pe.generate(ids, max_new_tokens=9).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_past_the_table_matches_jax():
    """GPT-2's learned table has 64 rows; a 40-token prompt and 20 new
    tokens run decode steps to position 71 (the loop rounds its steps up
    to 32, and the steps past the cap are discarded): the port clamps the
    index as JAX's gather does and the streams are token-identical."""
    params = _seeded("gpt2")
    ids = np.random.default_rng(6).integers(
        0, BASE["vocab_size"], (1, 40)).astype(np.int32)
    je = deepspeed_tpu.init_inference(
        jt.make_model(_jcfg("gpt2")), config={"kv_cache_bits": 0},
        dtype=jnp.float32, params=params)
    pe = deepspeed_tpu_torch.init_inference(
        pt.make_model(_pcfg("gpt2")), config={"kv_cache_bits": 0},
        params=params, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(
        pe.generate(ids, max_new_tokens=20).numpy(),
        np.asarray(je.generate(jnp.asarray(ids), max_new_tokens=20)))


@pytest.mark.parametrize("name", ["bloom", "gpt_neo"])
def test_suffix_decode_and_merge_match_jax(name):
    """The two-level contiguous decode with ALiBi and a window: a 12-row
    prefill, 5 steps into a 6-row suffix (``decode_step_suffix``: the
    suffix rows take ALiBi's distance and the band), ``merge_suffix``,
    then one ``decode_step`` on the merged buffer: logits and buffers
    within 1e-5 of JAX's."""
    params = _seeded(name)
    jcfg, cfg = _jcfg(name), _pcfg(name)
    ids = np.random.default_rng(8).integers(
        0, BASE["vocab_size"], (B, 12)).astype(np.int32)
    feed = np.random.default_rng(9).integers(
        0, BASE["vocab_size"], (6, B)).astype(np.int32)
    tp = convert.params_from_numpy(params, cfg, device="cpu",
                                   dtype=torch.float32)
    _, jcache = jax.jit(lambda p, i, c: jt.prefill(p, i, jcfg, c))(
        params, jnp.asarray(ids), jt.init_cache(jcfg, B, 32))
    _, pcache = pt.prefill(tp, torch.from_numpy(ids).long(), cfg,
                           pt.init_cache(cfg, B, 32, device="cpu"))
    jsuf = jt.init_suffix(jcfg, B, 6, cache=jcache)
    psuf = pt.init_suffix(cfg, B, 6, cache=pcache)
    suffix_step = jax.jit(lambda p, t, c, s: jt.decode_step_suffix(
        p, t, jcfg, c, s))
    for i in range(5):
        jl, jsuf = suffix_step(params, jnp.asarray(feed[i]), jcache, jsuf)
        pl, psuf = pt.decode_step_suffix(tp, torch.from_numpy(feed[i]).long(),
                                         cfg, pcache, psuf)
        assert rel_l2(pl.numpy(), jl) <= TOL, i
    jcache = jt.merge_suffix(jcfg, jcache, jsuf)
    pcache = pt.merge_suffix(cfg, pcache, psuf)
    jl, jcache = jax.jit(lambda p, t, c: jt.decode_step(p, t, jcfg, c))(
        params, jnp.asarray(feed[5]), jcache)
    pl, pcache = pt.decode_step(tp, torch.from_numpy(feed[5]).long(), cfg,
                                pcache)
    assert rel_l2(pl.numpy(), jl) <= TOL
    for k in ("k", "v"):
        assert rel_l2(pcache[k].numpy(), jcache[k]) <= TOL, k


@pytest.mark.parametrize("name", SERVED)
def test_paged_serving_matches_jax(name):
    """``init_serving`` streams against JAX's ``ServingEngine``: three
    requests on two slots (prompts of 21, 40 and 25 tokens; the 40-token
    one chunked by a 32-token prefill budget through the span path), 12
    new tokens each, token-identical. The route is recorded as JAX's: the
    gathered view ("xla") for ALiBi and windows, B4 ("pallas") else."""
    params = _seeded(name)
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, BASE["vocab_size"], n).astype(np.int32), 12)
            for n in (21, 40, 25)]
    serving = dict(SERVING, prefill_token_budget=32)
    js = deepspeed_tpu.init_serving(
        jt.make_model(_jcfg(name)), config={"kv_cache_bits": 0},
        serving=serving, dtype=jnp.float32, params=params)
    want = js.run(reqs)
    ps = deepspeed_tpu_torch.init_serving(
        pt.make_model(_pcfg(name)), config={"kv_cache_bits": 0},
        serving=serving, params=params, dtype=torch.float32, device="cpu")
    got = ps.run(reqs)
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"req {k}")
    gathered = name in ("bloom", "gpt_neo")
    assert ps.decode_backend == ("xla" if gathered else "pallas")
    if gathered:
        assert ps.backend_bench["reason"] == js.backend_bench["reason"] == \
            "kernel-unsupported attention variant"
    assert ps.stats()["prefill_chunks"] >= 2


# ---------------------------------------------------------------------------
# fused and int8 stacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gpt2", "gptj"])
def test_fused_and_int8_stacks_with_biases_match_jax(name):
    """``fuse_layer_stack`` (bqkv beside wqkv; no w_in_gate with a b_in),
    ``unfuse_layer_stack`` and ``quantize_layer_stack`` (the biases stay
    float) leaf for leaf as JAX's, and the fused and int8 (dequantized
    per layer, and int8 through the matmul) forwards within 1e-5 of
    JAX's."""
    params = _seeded(name)
    jcfg, cfg = _jcfg(name), _pcfg(name)
    ids, _ = _inputs(name)
    tp = convert.params_from_numpy(params, cfg, device="cpu",
                                   dtype=torch.float32)
    jf = jax.tree.map(np.asarray, jt.fuse_layer_stack(params, jcfg))
    pf = pt.fuse_layer_stack(tp)
    assert set(pf["layers"]) == set(jf["layers"])
    for k, v in jf["layers"].items():
        np.testing.assert_array_equal(pf["layers"][k].numpy(), v)
    back = pt.unfuse_layer_stack(pf, cfg)
    for k, v in tp["layers"].items():
        assert torch.equal(back["layers"][k], v)
    want = jt.forward(jf, jnp.asarray(ids), jcfg)
    assert rel_l2(pt.forward(pf, torch.from_numpy(ids), cfg).numpy(),
                  want) <= TOL
    jq = jax.tree.map(np.asarray, jt.quantize_layer_stack(params))
    pq = pt.quantize_layer_stack(tp)
    for k, v in jq["layers"].items():
        if isinstance(v, dict):
            np.testing.assert_array_equal(pq["layers"][k]["q"].numpy(),
                                          v["q"])
            np.testing.assert_allclose(pq["layers"][k]["scale"].numpy(),
                                       v["scale"], rtol=1e-6)
        else:
            assert pq["layers"][k].dtype == torch.float32
            np.testing.assert_array_equal(pq["layers"][k].numpy(), v)
    for bits in (0, 8):
        jc = dataclasses.replace(jcfg, quantized_weights=True,
                                 weight_only_bits=bits)
        pc = dataclasses.replace(cfg, quantized_weights=True,
                                 weight_only_bits=bits)
        want = jt.forward(jq, jnp.asarray(ids), jc)
        got = pt.forward(pq, torch.from_numpy(ids), pc)
        assert rel_l2(got.numpy(), want) <= TOL


# ---------------------------------------------------------------------------
# the routes and the refusals
# ---------------------------------------------------------------------------

def test_windows_route_per_layer_and_alibi_slopes(monkeypatch):
    """GPT-Neo's global layer calls the flash entry point and its local
    one the plain attention; ALiBi never reaches the flash entry point.
    ``alibi_slopes`` equals JAX's for 1 .. 48 heads (powers of two and
    the odd-term fill)."""
    for n in range(1, 49):
        np.testing.assert_array_equal(pt.alibi_slopes(n).numpy(),
                                      np.asarray(jt.alibi_slopes(n)))
    calls = []
    real = pt.flash_attention
    monkeypatch.setattr(pt, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ids = torch.from_numpy(_inputs("gpt2")[0])
    for name, want in (("gpt_neo", 1), ("bloom", 0), ("gpt2", 2)):
        calls.clear()
        cfg = _pcfg(name)
        tp = convert.params_from_numpy(_seeded(name), cfg, device="cpu",
                                       dtype=torch.float32)
        pt.forward(tp, ids, cfg)
        assert len(calls) == want, name


def test_refusal_on_a_mesh_larger_than_one_rank():
    """A family on a mesh now runs (tests/test_torch_families_mesh.py holds
    it against JAX): ``params_from_numpy`` cuts a rank's slice of every
    family leaf by JAX's rules, the config builds a block-sparse model
    with ALiBi or windows. What still raises, before any process group is
    touched: a vocabulary the tensor axis does not divide (``ValueError``
    naming the leaf, as JAX's ``device_put`` raises), what JAX's pipeline
    drops over ``pipe`` and the training extras on the model-parallel
    axes (``NotImplementedError`` naming their ROADMAP labels)."""
    mesh = Mesh(MeshPlan(tensor=2))
    got = convert.params_from_numpy(_seeded("gpt2"), _pcfg("gpt2"),
                                    device="cpu", dtype=torch.float32,
                                    mesh=mesh)
    H, V, L = BASE["hidden_size"], BASE["vocab_size"], BASE["num_layers"]
    assert tuple(got["tok_embed"].shape) == (V // 2, H)
    assert tuple(got["pos_embed"].shape) == (BASE["max_seq_len"], H)
    assert tuple(got["layers"]["bq"].shape) == (L, H // 2)
    assert tuple(got["layers"]["b_in"].shape) == (L, 2 * H)
    assert tuple(got["layers"]["bo"].shape) == (L, H)
    assert tuple(got["layers"]["b_out"].shape) == (L, H)
    odd = jt.TransformerConfig(**{**BASE, **FAMILIES["gpt2"],
                                  "vocab_size": V + 1},
                               dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0),
                                                   odd))
    with pytest.raises(ValueError, match="tok_embed"):
        convert.params_from_numpy(tree, _pcfg("gpt2", vocab_size=V + 1),
                                  device="cpu", dtype=torch.float32,
                                  mesh=mesh)
    with pytest.raises(NotImplementedError,
                       match="A11 \\(the leaves JAX's pipeline drops\\)"):
        deepspeed_tpu_torch.initialize(
            model=pt.make_model(_pcfg("bert")), mesh=Mesh(MeshPlan(pipe=2)),
            config={"train_batch_size": 4, "gradient_accumulation_steps": 2,
                    "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}},
            device="cpu")
    with pytest.raises(NotImplementedError,
                       match="A11 \\(training extras on the model-parallel"):
        deepspeed_tpu_torch.initialize(
            model=pt.make_model(_pcfg("gpt2")), mesh=mesh, config={
                "train_batch_size": 4,
                "optimizer": {"type": "sgd", "params": {"lr": 0.1}},
                "compression_training": {"weight_quantization": {
                    "shared_parameters": {"enabled": True},
                    "different_groups": {"wq1": {
                        "params": {"start_bits": 8, "target_bits": 8},
                        "modules": ["wq"]}}}}}, device="cpu")
    assert pt.family_leaves(pt.llama_config("tiny")) == []
    assert "alibi" in pt.family_leaves(_pcfg("bloom"))
    assert pt.pipe_dropped(_pcfg("bert")) == [
        "tok_type_embed", "embed_norm", "final_norm=False"]
    assert pt.pipe_dropped(_pcfg("gpt_neo")) == ["attn_windows"]
    for name in FAMILIES:
        pt.check_family_mesh(_pcfg(name), MeshPlan(tensor=2, data=2))
    pt.check_family_mesh(_pcfg("gptj"), MeshPlan(pipe=2))
    for bad in (dict(position_type="sinusoid"), dict(norm_style="mid"),
                dict(attn_windows=(0,))):
        with pytest.raises(ValueError):
            _pcfg("gpt2", **bad)
    for over in (dict(position_type="alibi"), dict(attn_windows=(0, 8))):
        cfg = _pcfg("gpt2", sparse_attention={"mode": "bigbird",
                                              "block": 16}, **over)
        assert cfg.sparse_attention["mode"] == "bigbird"

"""The port's llama model against the JAX model: one JAX ``init_params``
tree moved over with ``params_from_numpy`` (unfused and fused layouts),
then the paged protocol — ``prefill_paged`` of two slots, and 8
teacher-forced ``decode_step_paged`` steps — compared logits and pools.
Tolerance: relative L2 <= 1e-4 at f32, <= 2e-2 at bf16."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import convert, transformer as pt

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

CFG = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=512, max_seq_len=128,
           position_type="rotary", activation="silu_glu", norm_type="rmsnorm",
           tie_embeddings=False)
BS, NB = 16, 9
PROMPTS = (20, 9)                       # slot 0: 2 blocks, slot 1: 1 block
TABLES = np.asarray([[3, 5, 0, 0], [2, 8, 0, 0]], np.int32)
STEPS = 8
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_params(fused: bool, dtype: str):
    cfg = jt.TransformerConfig(**CFG, dtype=jnp.dtype(dtype),
                               attention_impl="xla")
    p = jt.init_params(jax.random.PRNGKey(0), cfg)
    p = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), p)
    if fused:
        p = jt.fuse_layer_stack(p, cfg)
    return cfg, p


def _run_jax(cfg, params, ids, tokens, prompts=PROMPTS, tables=TABLES):
    pools = jt.init_paged_cache(cfg, NB, BS)
    prefill = jax.jit(functools.partial(jt.prefill_paged, cfg=cfg),
                      static_argnames=())
    lasts = []
    for s, n in enumerate(prompts):
        P = -(-n // BS) * BS
        last, pools = prefill(params, jnp.asarray(ids[s][None, :P]),
                              pools=pools,
                              block_ids=jnp.asarray(tables[s, :P // BS]),
                              length=n)
        lasts.append(last)
    step = jax.jit(lambda p, t, pl, lens: jt.decode_step_paged(
        p, t, cfg, pl, jnp.asarray(tables), lens))
    lens = jnp.asarray(prompts, jnp.int32)
    logits = []
    for i in range(STEPS):
        lg, pools = step(params, jnp.asarray(tokens[i]), pools, lens)
        logits.append(lg)
        lens = lens + 1
    return lasts, logits, pools


def _run_port(cfg, params, ids, tokens, prompts=PROMPTS, tables=TABLES):
    pools = pt.init_paged_cache(cfg, NB, BS, device="cpu")
    lasts = []
    for s, n in enumerate(prompts):
        P = -(-n // BS) * BS
        lasts.append(pt.prefill_paged(
            params, torch.from_numpy(ids[s][None, :P]).long(), cfg, pools,
            torch.from_numpy(tables[s, :P // BS]), length=n))
    tables = torch.from_numpy(tables)
    lens = torch.tensor(prompts, dtype=torch.int32)
    logits = []
    for i in range(STEPS):
        logits.append(pt.decode_step_paged(
            params, torch.from_numpy(tokens[i]).long(), cfg, pools, tables,
            lens))
        lens = lens + 1
    return lasts, logits, pools


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_and_decode_match_jax(fused, dtype):
    jcfg, jparams = _jax_params(fused, dtype)
    tdtype = getattr(torch, dtype)
    cfg = pt.TransformerConfig(**CFG, dtype=tdtype)
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu", dtype=tdtype)
    assert ("wqkv" in params["layers"]) == fused
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG["vocab_size"], size=(2, 32)).astype(np.int32)
    ids[1, 9:] = 0                                   # slot 1's pad rows
    tokens = rng.integers(0, CFG["vocab_size"],
                          size=(STEPS, 2)).astype(np.int32)
    j_last, j_logits, j_pools = _run_jax(jcfg, jparams, ids, tokens)
    p_last, p_logits, p_pools = _run_port(cfg, params, ids, tokens)
    tol = TOL[dtype]
    for s in range(2):
        assert rel_l2(_f32(p_last[s]), _f32(j_last[s])) <= tol
    for i in range(STEPS):
        assert rel_l2(_f32(p_logits[i]), _f32(j_logits[i])) <= tol, i
    for name in ("k", "v"):        # block 0 is trash: never compared
        assert p_pools[name].dtype == tdtype
        assert rel_l2(_f32(p_pools[name])[:, 1:],
                      _f32(j_pools[name])[:, 1:]) <= tol


def test_decode_past_capacity_matches_jax():
    """Slot 0 fills its whole table (4 blocks = 64 rows) and decodes on past
    it, as a request that reaches max_model_len mid-quantum does: its rows
    at and past the capacity are dropped by JAX and go to the trash block
    in the port (no live block is overwritten). Pools (block 0 aside) and
    every step's logits match JAX's."""
    jcfg, jparams = _jax_params(False, "float32")
    cfg = pt.TransformerConfig(**CFG, dtype=torch.float32)
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu",
        dtype=torch.float32)
    prompts = (60, 9)                  # slot 0: rows 60..67 over 8 steps
    tables = np.asarray([[3, 5, 6, 7], [2, 8, 0, 0]], np.int32)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, CFG["vocab_size"], size=(2, 64)).astype(np.int32)
    tokens = rng.integers(0, CFG["vocab_size"],
                          size=(STEPS, 2)).astype(np.int32)
    j_last, j_logits, j_pools = _run_jax(jcfg, jparams, ids, tokens,
                                         prompts, tables)
    p_last, p_logits, p_pools = _run_port(cfg, params, ids, tokens,
                                          prompts, tables)
    tol = TOL["float32"]
    for s in range(2):
        assert rel_l2(_f32(p_last[s]), _f32(j_last[s])) <= tol
    for i in range(STEPS):
        assert rel_l2(_f32(p_logits[i]), _f32(j_logits[i])) <= tol, i
    for name in ("k", "v"):
        assert rel_l2(_f32(p_pools[name])[:, 1:],
                      _f32(j_pools[name])[:, 1:]) <= tol
        # the first rows of slot 0's last block hold prompt rows 48..51
        assert rel_l2(_f32(p_pools[name])[:, 7, :, :4],
                      _f32(j_pools[name])[:, 7, :, :4]) <= tol


@pytest.mark.parametrize("fused", [False, True])
def test_forward_with_kv_matches_jax(fused):
    """Full-sequence forward (causal, no cache) and its per-layer K/V."""
    jcfg, jparams = _jax_params(fused, "float32")
    cfg = pt.TransformerConfig(**CFG, dtype=torch.float32)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       cfg, device="cpu", dtype=torch.float32)
    ids = np.random.default_rng(2).integers(0, 256, (2, 24)).astype(np.int32)
    logits, (k, v) = pt.forward(params, torch.from_numpy(ids).long(), cfg,
                                return_kv=True)
    j_logits, (jk, jv) = jt.forward(jparams, jnp.asarray(ids), jcfg,
                                    return_kv=True)
    assert rel_l2(logits.numpy(), _f32(j_logits)) <= TOL["float32"]
    assert rel_l2(k.numpy(), _f32(jk)) <= TOL["float32"]
    assert rel_l2(v.numpy(), _f32(jv)) <= TOL["float32"]


def test_rotary_matches_jax_formula():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 5))
    got = pt.rotary_embed(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    want = jt.rotary_embed(jnp.asarray(x), jnp.asarray(pos), 1e4)
    assert rel_l2(got.numpy(), np.asarray(want)) <= 1e-6


def test_seeded_init_matches_jax_layout():
    """The on-device init (for the card, where there is no JAX) gives the
    JAX tree's names, shapes and scales."""
    cfg = pt.TransformerConfig(**CFG, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    ours = pt.init_params(cfg, gen, "cpu")
    theirs = jt.init_params(jax.random.PRNGKey(0),
                            jt.TransformerConfig(**CFG))
    flat = lambda t: {k: v for k, v in t.items() if k != "layers"}  # noqa
    for a, b in ((flat(ours), flat(theirs)),
                 (ours["layers"], theirs["layers"])):
        assert set(a) == set(b)
        for k in a:
            assert tuple(a[k].shape) == tuple(b[k].shape), k
            assert abs(float(a[k].std()) - float(np.std(b[k]))) <= \
                0.1 * float(np.std(b[k])) + 1e-6, k


def test_paged_cache_device_none_means_the_card():
    """``device=None`` resolves as every entry point does: the card, or a
    raise where there is no CUDA (never a silent pool on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: device=None gives a pool on the card")
    cfg = pt.TransformerConfig(**CFG, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.init_paged_cache(cfg, NB, BS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.make_model(cfg).init_paged_cache(NB, BS)


def test_paged_cache_on_the_cpu_when_asked():
    cfg = pt.TransformerConfig(**CFG, dtype=torch.bfloat16)
    for pools in (pt.init_paged_cache(cfg, NB, BS, device="cpu"),
                  pt.make_model(cfg).init_paged_cache(NB, BS, device="cpu")):
        for name in ("k", "v"):
            t = pools[name]
            assert t.device.type == "cpu" and t.dtype == torch.bfloat16
            assert tuple(t.shape) == (CFG["num_layers"], NB,
                                      CFG["num_kv_heads"], BS,
                                      CFG["hidden_size"] // CFG["num_heads"])
            assert not t.any()


def test_deferred_model_features_raise():
    # the model families are ported, and a block-sparse model with ALiBi
    # or local windows builds (JAX's routing); over pipe, the windows JAX's
    # pipeline drops raise naming their ROADMAP label
    from deepspeed_tpu_torch.parallel.mesh import MeshPlan
    sparse = {"sparse_attention": {"mode": "bigbird", "block": 16}}
    for over in (dict(position_type="alibi"), dict(attn_windows=(0, 8))):
        cfg = pt.TransformerConfig(**{**CFG, **over, **sparse})
        assert cfg.sparse_attention == sparse["sparse_attention"]
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        pt.check_family_mesh(cfg, MeshPlan(pipe=2))
    # a MoE model serves and trains (its loss carries the aux term)
    moe = pt.TransformerConfig(**{**CFG, "num_experts": 4})
    p = pt.init_params(moe, torch.Generator().manual_seed(0), "cpu")
    loss = pt.lm_loss(p, {"input_ids": torch.zeros((1, 4), dtype=torch.long)},
                      moe, train=True)
    assert torch.isfinite(loss)
    # a leaf of no model the port serves raises naming its item; a family
    # leaf this config lacks (an rmsnorm model has no bq) is a mismatch
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        convert.params_from_numpy({"tok_embed": np.zeros((4, 4)),
                                   "layers": {"conv_in": np.zeros((2, 4))}},
                                  pt.TransformerConfig(**CFG), device="cpu",
                                  dtype=torch.float32)
    with pytest.raises(ValueError, match="extra .*layers/bq"):
        convert.params_from_numpy({"tok_embed": np.zeros((4, 4)),
                                   "layers": {"bq": np.zeros((2, 4))}},
                                  pt.TransformerConfig(**CFG), device="cpu",
                                  dtype=torch.float32)

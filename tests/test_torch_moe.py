"""The MoE serving forward against JAX: top-k gating with capacity
(``moe/sharded_moe.py``), the expert FFN, a MoE model's paged prefill and
decode, and a MoE model served end to end (f32, numpy-seeded inputs, the
JAX side on XLA as its own tests run it).

The gates are a softmax: XLA's ``exp`` and torch's differ in the last
bit, so the combine weights agree to ~1e-7 and are held at 1e-6; every
routing decision (dispatch: expert, slot, drop) is held exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.models import make_model as jax_make_model
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu_torch.models import convert, transformer as pt
from deepspeed_tpu_torch.moe import sharded_moe as pmoe

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

# tests/unit/test_tp_serving.py's _cfg(num_experts=4, top_k=2)
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=256, position_type="rotary",
           activation="silu_glu", norm_type="rmsnorm", tie_embeddings=False,
           num_experts=4, top_k=2)


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("k,capacity", [(1, 16), (2, 24), (1, 3), (2, 5)])
def test_top_k_gating_matches_jax(k, capacity):
    """64 tokens over 8 experts; capacities 3 and 5 force drops."""
    logits = np.random.default_rng(k * 100 + capacity).normal(
        0, 1, (64, 8)).astype(np.float32)
    jc, jd, jaux, jm = jmoe.top_k_gating(jnp.asarray(logits), k, capacity,
                                         train=False)
    pc, pd, paux, pm = pmoe.top_k_gating(torch.from_numpy(logits), k,
                                         capacity, train=False)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    assert np.abs(pc.numpy() - np.asarray(jc)).max() <= 1e-6
    assert abs(float(paux) - float(jaux)) <= 1e-6
    assert abs(float(pm["dropped_fraction"])
               - float(jm["dropped_fraction"])) <= 1e-7
    if capacity < 8:
        assert float(pm["dropped_fraction"]) > 0


def test_gate_noise_is_seeded():
    """The training noise draws from an explicit generator: the same seed
    routes the same way; serving (train=False) ignores it."""
    logits = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (32, 4)).astype(np.float32))
    for policy in ("Jitter", "RSample"):
        a = pmoe.top_k_gating(logits, 2, 16, noise_policy=policy,
                              generator=torch.Generator().manual_seed(3))
        b = pmoe.top_k_gating(logits, 2, 16, noise_policy=policy,
                              generator=torch.Generator().manual_seed(3))
        assert torch.equal(a[0], b[0])
    plain = pmoe.top_k_gating(logits, 2, 16, train=False)
    noisy = pmoe.top_k_gating(logits, 2, 16, noise_policy="RSample",
                              generator=torch.Generator().manual_seed(3),
                              train=False)
    assert torch.equal(plain[0], noisy[0])


@pytest.mark.parametrize("activation", ["silu_glu", "gelu"])
@pytest.mark.parametrize("drop_tokens", [True, False])
def test_moe_ffn_matches_jax(activation, drop_tokens):
    """The expert FFN over [2, 24] tokens at capacity factor 1.0 (drops
    under drop_tokens), the dispatch scatter, the per-expert products and
    the combine against JAX's einsums."""
    cfg = dict(CFG, activation=activation, drop_tokens=drop_tokens,
               eval_capacity_factor=1.0, min_capacity=2)
    jcfg = JaxConfig(**cfg, dtype=jnp.float32)
    rng = np.random.default_rng(7)
    H, E, Fd = 64, 4, 96
    mp = {"wg": rng.normal(0, 0.5, (H, E)),
          "w_in": rng.normal(0, 0.1, (E, H, Fd)),
          "w_out": rng.normal(0, 0.1, (E, Fd, H))}
    if activation == "silu_glu":
        mp["w_gate"] = rng.normal(0, 0.1, (E, H, Fd))
    mp = {k: v.astype(np.float32) for k, v in mp.items()}
    x = rng.normal(0, 1, (2, 24, H)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in mp.items()},
                            jnp.asarray(x), jcfg, train=False)
    py, paux = pmoe.moe_ffn({k: torch.from_numpy(v) for k, v in mp.items()},
                            torch.from_numpy(x),
                            pt.TransformerConfig(**cfg, dtype=torch.float32))
    assert rel_l2(py.numpy(), np.asarray(jy)) <= 1e-5
    assert abs(float(paux) - float(jaux)) <= 1e-6


@functools.lru_cache(maxsize=None)
def _jax_params(use_residual: bool):
    cfg = jt.TransformerConfig(**CFG, use_residual=use_residual,
                               dtype=jnp.float32, attention_impl="xla")
    p = jt.init_params(jax.random.PRNGKey(1), cfg)
    if use_residual:        # a non-trivial mix (JAX inits moe_coef at 0)
        c = np.random.default_rng(5).normal(0, 1, p["layers"]["moe_coef"]
                                            .shape).astype(np.float32)
        p["layers"]["moe_coef"] = jnp.asarray(c)
    return cfg, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("use_residual", [False, True])
def test_moe_paged_prefill_and_decode_match_jax(use_residual):
    """Two slots' prefills (a 32-row bucket with pad rows routed too) and
    6 teacher-forced decode steps of the two-slot batch."""
    jcfg, jp = _jax_params(use_residual)
    cfg = pt.TransformerConfig(**CFG, use_residual=use_residual,
                               dtype=torch.float32)
    params = convert.params_from_numpy(jp, cfg, device="cpu",
                                       dtype=torch.float32)
    assert ("w_in" in params["layers"]) == use_residual
    bs, nb = 16, 9
    tables = np.asarray([[3, 5, 0, 0], [2, 8, 0, 0]], np.int32)
    prompts = (20, 9)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, size=(2, 32)).astype(np.int32)
    ids[1, 9:] = 0
    tokens = rng.integers(0, 128, size=(6, 2)).astype(np.int32)
    jpools = jt.init_paged_cache(jcfg, nb, bs)
    ppools = pt.init_paged_cache(cfg, nb, bs, device="cpu")
    for s, n in enumerate(prompts):
        P = -(-n // bs) * bs
        jl, jpools = jt.prefill_paged(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(ids[s][None, :P]),
            jcfg, jpools, jnp.asarray(tables[s, :P // bs]), length=n)
        pl = pt.prefill_paged(params, torch.from_numpy(ids[s][None, :P]),
                              cfg, ppools,
                              torch.from_numpy(tables[s, :P // bs]),
                              length=n)
        assert rel_l2(pl.numpy(), np.asarray(jl)) <= 1e-5
    lens = np.asarray(prompts, np.int32)
    for i in range(6):
        jl, jpools = jt.decode_step_paged(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(tokens[i]), jcfg,
            jpools, jnp.asarray(tables), jnp.asarray(lens))
        pl = pt.decode_step_paged(params, torch.from_numpy(tokens[i]), cfg,
                                  ppools, torch.from_numpy(tables),
                                  torch.from_numpy(lens))
        assert rel_l2(pl.numpy(), np.asarray(jl)) <= 1e-5, i
        lens = lens + 1


SERVING = dict(max_seqs=16, block_size=16, max_model_len=128,
               decode_quantum=4, prompt_bucket=16)


def _load(seed=3, n=20):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, size=(int(rng.integers(5, 40)),))
             .astype(np.int32), int(rng.integers(6, 20))) for _ in range(n)]


def _jax_streams(config=None):
    model = jax_make_model(JaxConfig(**CFG, dtype=jnp.float32,
                                     attention_impl="xla"))
    srv = deepspeed_tpu.init_serving(
        model, config={"kv_cache_bits": 0, **(config or {})},
        serving=SERVING, dtype=jnp.float32, params=_jax_params(False)[1])
    outs = srv.run(_load())
    return [outs[k] for k in sorted(outs)]


def _port_streams(config=None):
    srv = deepspeed_tpu_torch.init_serving(
        pt.make_model(pt.TransformerConfig(**CFG, dtype=torch.float32)),
        config={"kv_cache_bits": 0, **(config or {})}, serving=SERVING,
        dtype=torch.float32, params=_jax_params(False)[1], device="cpu")
    outs = srv.run(_load())
    assert srv.allocator.used_blocks == 0
    return [outs[k] for k in sorted(outs)]


def test_moe_serving_matches_jax_with_drops(monkeypatch):
    """16 slots, top-2 of 4 experts: a decode batch routes 32 choices into
    4 x 8 places, so any uneven routing drops tokens; the port's
    ServingEngine must make JAX's drops (the same rows, idle slots
    included) and its streams token for token."""
    drops = []
    route = pmoe.route

    def counting(logits, *a, **kw):
        picks, aux, m = route(logits, *a, **kw)
        if logits.shape[0] == SERVING["max_seqs"]:
            drops.append(float(m["dropped_fraction"]))
        return picks, aux, m
    monkeypatch.setattr(pmoe, "route", counting)
    got = _port_streams()
    assert max(drops) > 0, "no decode batch dropped a token"
    want = _jax_streams()
    assert len(got) == len(want) == 20
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_moe_weight_bits_matches_jax(monkeypatch):
    """weight_bits=8 on the MoE model: the dense projections stay int8
    through the matmul, the expert stacks and the gate dequantize. JAX's
    own weight_bits engine leaves the gate int8 where its moe_ffn cannot
    read it (it fails on any MoE model); the reference here is that
    engine with its gate dequantized like the expert stacks, nothing
    else changed."""
    base = jt._maybe_dequant

    def with_gate(p, cfg):
        p = base(p, cfg)
        wg = p.get("wg")
        if isinstance(wg, dict):
            p = {**p, "wg": wg["q"].astype(cfg.dtype)
                 * wg["scale"].astype(cfg.dtype)}
        return p
    monkeypatch.setattr(jt, "_maybe_dequant", with_gate)
    want = _jax_streams({"weight_bits": 8})
    got = _port_streams({"weight_bits": 8})
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_moe_training_raises():
    """What of MoE training raises: pipeline stages at one rank (JAX's
    plan error: the stages do not divide the world; MoE under pipe=2 runs
    in ``tests/test_torch_pipeline.py``) and the layer-streamed offload,
    which streams dense layers only, as JAX's. MoE training itself runs
    (``tests/test_torch_moe_training.py``)."""
    model = pt.make_model(pt.TransformerConfig(**CFG, dtype=torch.float32))
    conf = {"train_batch_size": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    with pytest.raises(ValueError, match=r"pipe\(2\)"):
        deepspeed_tpu_torch.initialize(
            model=model, config=dict(conf, pipeline={"stages": 2}),
            device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        deepspeed_tpu_torch.initialize(
            model=model, config=dict(conf, zero_optimization={
                "stage": 3, "offload_param": {"device": "cpu"}}),
            device="cpu")


def test_mixtral_config_matches_jax():
    from deepspeed_tpu.models.transformer import mixtral_config as jmix
    for size in ("tiny", "8x7b"):
        j, p = jmix(size), pt.mixtral_config(size)
        for f in ("hidden_size", "num_layers", "num_heads", "num_kv_heads",
                  "intermediate_size", "vocab_size", "max_seq_len",
                  "num_experts", "top_k", "capacity_factor",
                  "eval_capacity_factor", "min_capacity", "drop_tokens",
                  "use_residual", "activation", "norm_type"):
            assert getattr(p, f) == getattr(j, f), (size, f)
    cfg = pt.mixtral_config("tiny", dtype=torch.float32)
    jcfg = jmix("tiny")
    assert jax.tree.structure(jt.logical_axes(jcfg), is_leaf=lambda x:
                              isinstance(x, tuple)) == jax.tree.structure(
        pt.logical_axes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    assert pt.logical_axes(cfg) == jt.logical_axes(jcfg)

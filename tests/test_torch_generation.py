"""The port's one-shot generation against the JAX package: the contiguous
KV cache (``prefill``, ``decode_step`` with read windows, the two-level
suffix functions) logit for logit within 1e-5 relative L2 at f32, and
``InferenceEngine.generate`` token-identical to JAX's ``generate`` on the
same weights. The port's paged ``ServingEngine`` must emit exactly the
port's own ``generate`` stream (JAX's
``test_serving_matches_oneshot_generate``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import transformer as pt

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

# tests/unit/test_serving.py's _cfg, at f32
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=256, position_type="rotary",
           activation="silu_glu", norm_type="rmsnorm", tie_embeddings=False)
TOL = 1e-5


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def engines():
    """The JAX engine (its seeded init, fused at tp=1) and the port's engine
    on the same weights, both f32."""
    jm = jt.make_model(jt.TransformerConfig(**CFG, dtype=jnp.float32,
                                            attention_impl="xla"))
    je = deepspeed_tpu.init_inference(jm, config={"kv_cache_bits": 0},
                                      dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jax.device_get(je.params))
    pe = deepspeed_tpu_torch.init_inference(
        pt.make_model(pt.TransformerConfig(**CFG, dtype=torch.float32)),
        config={"kv_cache_bits": 0}, params=params, dtype=torch.float32,
        device="cpu")
    return je, pe, params


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], size=shape).astype(np.int32)


# (batch, prompt, new tokens): a mixed batch; a prompt past one bucket;
# one whose buckets clamp to max_seq_len (decode steps past it write the
# buffer's last row, as JAX's dynamic_update_slice, and are discarded)
CASES = {"batch": (3, 21, 40), "bucket": (1, 70, 9), "capped": (2, 200, 50)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_matches_jax(engines, case):
    je, pe, _ = engines
    B, P, n = CASES[case]
    ids = _ids((B, P), seed=len(case))
    want = np.asarray(je.generate(ids, max_new_tokens=n))
    got = pe.generate(ids, max_new_tokens=n)
    assert got.shape == (B, P + n) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_and_decode_step_match_jax(engines):
    """A right-padded prompt (length 29 in a 32 bucket), then 8
    teacher-forced decode steps, the last 4 under a read window: logits
    and both buffers within 1e-5."""
    je, pe, params = engines
    B, P, n, T = 2, 32, 29, 96
    ids = _ids((B, P), seed=5)
    feed = _ids((8, B), seed=6)
    jcfg = je.model.config
    jparams = jax.tree.map(jnp.asarray, params)
    step = {w: jax.jit(lambda p, t, c, w=w: jt.decode_step(
        p, t, jcfg, c, read_len=w)) for w in (None, 64)}
    jcache = jt.init_cache(jcfg, B, T)
    jlast, jcache = jt.prefill(jparams, jnp.asarray(ids), jcfg, jcache,
                               length=n)
    pcache = pe.model.init_cache(B, T, device="cpu")
    plast, pcache = pe.model.prefill(pe.params, torch.from_numpy(ids).long(),
                                     pcache, length=n)
    assert pcache["index"] == n
    assert rel_l2(plast, jlast) < TOL
    for i in range(8):
        w = 64 if i >= 4 else None
        jl, jcache = step[w](jparams, jnp.asarray(feed[i]), jcache)
        pl, pcache = pe.model.decode_step(
            pe.params, torch.from_numpy(feed[i]).long(), pcache, read_len=w)
        assert rel_l2(pl, jl) < TOL, i
    assert pcache["index"] == int(jcache["index"]) == n + 8
    for name in ("k", "v"):
        assert rel_l2(pcache[name], jcache[name]) < TOL, name


def test_suffix_decode_and_merge_match_jax(engines):
    """The two-level scheme: a frozen prefix cache, 5 steps into a
    6-row suffix (``decode_step_suffix``), ``merge_suffix``, then one
    plain step on the merged buffer: logits and buffers within 1e-5."""
    je, pe, params = engines
    B, P, T = 2, 24, 64
    ids = _ids((B, P), seed=7)
    feed = _ids((6, B), seed=8)
    jcfg = je.model.config
    jparams = jax.tree.map(jnp.asarray, params)
    _, jcache = jt.prefill(jparams, jnp.asarray(ids), jcfg,
                           jt.init_cache(jcfg, B, T))
    pcache = pe.model.init_cache(B, T, device="cpu")
    _, pcache = pe.model.prefill(pe.params, torch.from_numpy(ids).long(),
                                 pcache)
    jsuf = jt.init_suffix(jcfg, B, 6, cache=jcache)
    psuf = pe.model.init_suffix(B, 6, cache=pcache)
    suffix_step = jax.jit(lambda p, t, c, s: jt.decode_step_suffix(
        p, t, jcfg, c, s, read_len=32))
    for i in range(5):
        jl, jsuf = suffix_step(jparams, jnp.asarray(feed[i]), jcache, jsuf)
        pl, psuf = pe.model.decode_step_suffix(
            pe.params, torch.from_numpy(feed[i]).long(), pcache, psuf,
            read_len=32)
        assert rel_l2(pl, jl) < TOL, i
    assert psuf["count"] == int(jsuf["count"]) == 5
    jcache = jt.merge_suffix(jcfg, jcache, jsuf)
    pcache = pe.model.merge_suffix(pcache, psuf)
    assert pcache["index"] == int(jcache["index"]) == P + 5
    jl, jcache = jt.decode_step(jparams, jnp.asarray(feed[5]), jcfg, jcache)
    pl, pcache = pe.model.decode_step(pe.params,
                                      torch.from_numpy(feed[5]).long(),
                                      pcache)
    assert rel_l2(pl, jl) < TOL
    for name in ("k", "v"):
        assert rel_l2(pcache[name], jcache[name]) < TOL, name


def test_engine_forward_matches_jax(engines):
    je, pe, _ = engines
    ids = _ids((2, 48), seed=9)
    assert rel_l2(pe.forward(ids), je.forward(ids)) < TOL


def test_sampling_draws_from_the_given_generator(engines):
    """temperature > 0 draws from the generator passed as ``rng`` (its bits
    cannot match JAX's): the same seed gives the same tokens, and they
    stay in the vocab."""
    _, pe, _ = engines
    ids = _ids((2, 12), seed=11)
    runs = [pe.generate(ids, max_new_tokens=20, temperature=1.0,
                        rng=torch.Generator().manual_seed(3))
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0].numpy(), runs[1].numpy())
    gen = runs[0][:, 12:]
    assert gen.min() >= 0 and gen.max() < CFG["vocab_size"]


def test_generate_refuses_past_max_seq_len(engines):
    _, pe, _ = engines
    with pytest.raises(ValueError, match="max_seq_len"):
        pe.generate(_ids((1, 250), seed=12), max_new_tokens=10)


def test_serving_matches_oneshot_generate(engines):
    """Two concurrent variable-length requests through the port's paged
    serving engine give exactly the port's one-shot greedy outputs."""
    _, pe, params = engines
    srv = deepspeed_tpu_torch.init_serving(
        pe.model, config={"kv_cache_bits": 0},
        serving=dict(max_seqs=2, block_size=16, max_model_len=128,
                     decode_quantum=4, prompt_bucket=16),
        params=params, dtype=torch.float32, device="cpu")
    reqs = [(_ids((7,), seed=13), 9), (_ids((21,), seed=14), 6)]
    outs = srv.run(reqs)
    for rid, (p, n) in zip(sorted(outs), reqs):
        one = pe.generate(p[None], max_new_tokens=n)[0].numpy()
        np.testing.assert_array_equal(outs[rid], one)
    assert srv.stats()["generated_tokens"] == 15


def test_contiguous_cache_device_none_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pt.TransformerConfig(**CFG, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.init_cache(cfg, 1, 64)

"""Serving a block-sparse model in the port against the JAX package's
serving engine: a 2-layer model under a BigBird and a fixed layout
(block 16), f32, on the CPU.

JAX's prefill has no key mask, so a sparse config routes the whole prompt
bucket through its block-sparse kernel (Pallas, interpret mode here); its
paged decode and its span path attend densely. The port routes the same
way (B5's plain version here). Held: greedy streams token-identical for
whole prompts over several buckets, on the int8 pool, for a chunked
load (dense spans in both) and for a warm prefix-cache load; ``prefill_paged``'s last logits
within 1e-5 relative L2; ``generate`` token-identical; a bucket that is
not a multiple of the block raises the same ``ValueError`` in both; a
sparse model on a mesh raises naming ROADMAP A10b; the layout's tables
are built once a bucket.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import convert, transformer as pt
from deepspeed_tpu_torch.ops import sparse_attention as tsa

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=256, position_type="rotary",
           activation="silu_glu", norm_type="rmsnorm", tie_embeddings=False)
LAYOUTS = {
    "bigbird": {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
                "num_sliding_window_blocks": 3, "num_global_blocks": 1},
    "fixed": {"mode": "fixed", "block": 16, "num_local_blocks": 2,
              "num_global_blocks": 1},
}
SERVING = dict(max_seqs=2, block_size=16, max_model_len=128,
               decode_quantum=4, prompt_bucket=16)
TOL = 1e-5


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def ref(request):
    """(layout name, the JAX sparse model, its seeded params as numpy)."""
    jm = jt.make_model(jt.TransformerConfig(
        **CFG, dtype=jnp.float32, attention_impl="xla",
        sparse_attention=LAYOUTS[request.param]))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return request.param, jm, jax.tree.map(np.asarray,
                                           jax.device_get(params))


def _port_model(layout, **kw):
    return pt.make_model(pt.TransformerConfig(
        **CFG, dtype=torch.float32, sparse_attention=LAYOUTS[layout], **kw))


def _jax_srv(ref, **serving):
    _, jm, params = ref
    return deepspeed_tpu.init_serving(
        jm, config={"kv_cache_bits": 0}, serving={**SERVING, **serving},
        dtype=jnp.float32, params=params)


def _port_srv(ref, **serving):
    layout, _, params = ref
    return deepspeed_tpu_torch.init_serving(
        _port_model(layout), config={"kv_cache_bits": 0},
        serving={**SERVING, **serving}, params=params, dtype=torch.float32,
        device="cpu")


def _streams(outs):
    return [np.asarray(outs[k]) for k in sorted(outs)]


def _assert_same(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: request {i}")


def _load(seed, lengths, new=10):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32),
             new) for n in lengths]


def test_whole_prompt_streams_match_jax(ref):
    """Prompts of 9 to 70 tokens: buckets of 16, 32, 48 and 80 rows, each
    prefilled through the sparse kernel; more requests than slots."""
    load = _load(1, (9, 20, 37, 70))
    want = _streams(_jax_srv(ref).run(list(load)))
    got = _streams(_port_srv(ref).run(list(load)))
    _assert_same(got, want, "whole prompts")


def test_int8_pool_streams_match_jax(ref):
    """The int8 pool works unchanged: the sparse prefill only computes
    the K/V rows, quantized per row as they are written."""
    load = _load(9, (9, 37))
    want = deepspeed_tpu.init_serving(
        ref[1], config={"kv_cache_bits": 8}, serving=SERVING,
        dtype=jnp.float32, params=ref[2]).run(list(load))
    srv = deepspeed_tpu_torch.init_serving(
        _port_model(ref[0]), config={"kv_cache_bits": 8}, serving=SERVING,
        params=ref[2], dtype=torch.float32, device="cpu")
    assert srv.pools["k"].dtype == torch.int8
    _assert_same(_streams(srv.run(list(load))), _streams(want), "int8 pool")


def test_chunked_streams_match_jax(ref):
    """A prefill token budget: prompts past it prefill in dense spans in
    both engines."""
    load = _load(2, (40, 13, 60))
    kw = dict(prefill_token_budget=24)
    want = _streams(_jax_srv(ref, **kw).run(list(load)))
    srv = _port_srv(ref, **kw)
    _assert_same(_streams(srv.run(list(load))), want, "chunked")
    assert srv.stats()["prefill_chunks"] >= 1


def test_warm_streams_match_jax(ref):
    """A shared 40-token prefix: the later requests prefill their tails
    warm (dense spans over the cached blocks)."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, CFG["vocab_size"], size=(40,)).astype(np.int32)
    load = [(np.concatenate([prefix, rng.integers(
        0, CFG["vocab_size"], size=(5,)).astype(np.int32)]), 8)
        for _ in range(4)]
    kw = dict(enable_prefix_cache=True)
    want = _streams(_jax_srv(ref, **kw).run(list(load)))
    srv = _port_srv(ref, **kw)
    _assert_same(_streams(srv.run(list(load))), want, "warm")
    assert srv.stats()["prefix_hits"] >= 1


def test_prefill_paged_logits_match_jax(ref):
    layout, jm, params = ref
    cfg = _port_model(layout).config
    p = convert.params_from_numpy(params, cfg, device="cpu",
                                  dtype=torch.float32)
    P, bs, NB, length = 48, 16, 8, 41
    ids = np.random.default_rng(4).integers(0, CFG["vocab_size"],
                                            (1, P)).astype(np.int32)
    blocks = np.asarray([2, 5, 3], np.int32)
    jpools = jt.init_paged_cache(jm.config, NB, bs, dtype=jnp.float32)
    want, jpools = jax.jit(lambda pr, i, pl, b: jt.prefill_paged(
        pr, i, jm.config, pl, b, length=length))(params, ids, jpools, blocks)
    pools = pt.init_paged_cache(cfg, NB, bs, dtype=torch.float32,
                                device="cpu")
    got = pt.prefill_paged(p, torch.from_numpy(ids).long(), cfg, pools,
                           blocks, length=length)
    assert rel_l2(got.numpy(), np.asarray(want)) <= TOL
    for name in ("k", "v"):
        assert rel_l2(pools[name][:, 1:].numpy(),
                      np.asarray(jpools[name])[:, 1:]) <= TOL


def test_generate_matches_jax(ref):
    layout, jm, params = ref
    ids = np.random.default_rng(5).integers(0, CFG["vocab_size"],
                                            (2, 23)).astype(np.int32)
    want = deepspeed_tpu.init_inference(
        jm, config={"kv_cache_bits": 0}, dtype=jnp.float32,
        params=params).generate(ids, 12)
    got = deepspeed_tpu_torch.init_inference(
        _port_model(layout), config={"kv_cache_bits": 0},
        dtype=torch.float32, params=params, device="cpu").generate(ids, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bucket_not_a_multiple_of_the_block_raises(ref):
    """Block 16 under a bucket of 8: JAX's sparse kernel refuses the
    prefill's sequence, and so does the port's, with the same message."""
    load = _load(6, (5,))
    # JAX's round recovery retries the failed prefill, then raises from it
    with pytest.raises(RuntimeError) as err:
        _jax_srv(ref, prompt_bucket=8, block_size=8).run(list(load))
    cause = err.value.__cause__
    assert isinstance(cause, ValueError)
    assert "not divisible by block 16" in str(cause)
    with pytest.raises(ValueError, match="not divisible by block 16"):
        _port_srv(ref, prompt_bucket=8, block_size=8).run(list(load))


def test_sparse_model_on_a_mesh_raises(ref):
    layout = ref[0]
    with pytest.raises(NotImplementedError, match="A10b"):
        deepspeed_tpu_torch.init_serving(
            _port_model(layout), config={"tensor_parallel": 2},
            serving=SERVING, dtype=torch.float32, device="cpu")


def test_tables_are_built_once_a_bucket(ref):
    """Two loads over the buckets 16, 32 and 48: each bucket's adjacency
    tables are made on the host, and copied to the device, by its first
    prefill only; every later layer and prefill reads the cache."""
    for cache in (tsa._cached_adjacency, tsa.adjacency_tables):
        cache.cache_clear()
    srv = _port_srv(ref)
    for seed in (7, 8):
        srv.run(_load(seed, (10, 30, 45), new=3))
    for cache in (tsa._cached_adjacency, tsa.adjacency_tables):
        assert cache.cache_info().misses == 3
    assert tsa.adjacency_tables.cache_info().hits >= \
        2 * 3 * CFG["num_layers"] - 3


def test_tables_stay_cached_past_64_buckets():
    """A load over 66 prompt buckets (16 to 1056 rows), served twice: each
    bucket's tables are built once, on its first prefill, however many
    buckets the server has."""
    buckets = 66
    model = pt.make_model(pt.TransformerConfig(
        **dict(CFG, max_seq_len=16 * buckets + 16), dtype=torch.float32,
        sparse_attention=LAYOUTS["bigbird"]))
    for cache in (tsa._cached_adjacency, tsa.adjacency_tables):
        cache.cache_clear()
    srv = deepspeed_tpu_torch.init_serving(
        model, config={"kv_cache_bits": 0},
        serving=dict(SERVING, max_seqs=4, max_model_len=16 * buckets + 16),
        dtype=torch.float32, device="cpu")
    lengths = [16 * b - 5 for b in range(1, buckets + 1)]
    for seed in (10, 11):
        outs = srv.run(_load(seed, lengths, new=1))
        assert len(outs) == buckets
    for cache in (tsa._cached_adjacency, tsa.adjacency_tables):
        assert cache.cache_info().misses == buckets

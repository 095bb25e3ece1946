"""The port's quantized inference against the JAX package at f32: the int8
quantizers bit for bit; the int8 KV attention (contiguous, paged, span)
within 1e-5 relative L2 on identical pools; the int8 caches and pools of
the model functions; int8 serving, warm/cold int8 and speculation on an
int8 pool token-identical to JAX's int8 engines; the ``weight_bits`` and
``quantize_bits`` logits within 1e-5 of JAX's same mode; and the
context-aware ``kv_cache_bits`` default resolved as JAX resolves it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu_torch.inference.kv_cache import pool_bytes
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.ops import quantizer as pq

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

# tests/unit/test_serving.py's _cfg, at f32
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=256, position_type="rotary",
           activation="silu_glu", norm_type="rmsnorm", tie_embeddings=False)
SERVING = dict(max_seqs=2, block_size=16, max_model_len=128,
               decode_quantum=4, prompt_bucket=16)
TOL = 1e-5


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(a), copy=True))
    return t if dtype is None else t.to(dtype)


def _jcfg(**kw):
    return jt.TransformerConfig(**CFG, dtype=jnp.float32,
                                attention_impl="xla", **kw)


def _pcfg(**kw):
    return pt.TransformerConfig(**CFG, dtype=torch.float32, **kw)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

def test_quantize_rows_and_channels_match_jax():
    """Identical int8 payloads and scales, zero rows / columns (the scale
    floors) and exact halves (round half to even) included."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 9, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                                    # floor 1e-8
    x[1, 1, 1] = np.linspace(-127, 127, 16) / 127 * 2.5
    x[2, 2, 2, :4] = [127.0, 0.5, 1.5, -2.5]            # exact halves
    jqv, jsc = jq.quantize_rows(jnp.asarray(x))
    qv, sc = pq.quantize_rows(_t(x))
    assert qv.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(qv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    w = rng.standard_normal((2, 24, 8)).astype(np.float32)
    w[1, :, 3] = 0.0                                     # floor 1e-12
    jqw, jsw = jq.quantize_channels(jnp.asarray(w))
    qw, sw = pq.quantize_channels(_t(w))
    assert tuple(sw.shape) == (2, 1, 8)
    np.testing.assert_array_equal(qw.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))


def test_weight_matmul_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    q, s = jq.quantize_channels(jnp.asarray(
        rng.standard_normal((24, 8)).astype(np.float32)))
    want = jq.weight_matmul(jnp.asarray(x), q, s)
    got = pq.weight_matmul(_t(x), _t(q), _t(s))
    assert rel_l2(got, want) < TOL
    w = rng.standard_normal((24, 8)).astype(np.float32)
    assert rel_l2(pq.weight_matmul(_t(x), _t(w)),
                  jq.weight_matmul(jnp.asarray(x), jnp.asarray(w))) < TOL


def test_int8_matmul_is_exact_past_two_to_the_24():
    """127^2 * 2048 terms pass 2^24: the pieces keep the sum exact (an f32
    matmul of the whole row would round it)."""
    a = torch.full((2, 3, 2048), 127, dtype=torch.int8)
    b = torch.full((2, 2048, 5), 127, dtype=torch.int8)
    b[1, :7] = -127
    got = pq.int8_matmul(a, b)
    want = torch.matmul(a.long(), b.long())
    assert got.dtype == torch.int32 and int(want.max()) > 2 ** 24
    assert torch.equal(got.long(), want)
    rng = np.random.default_rng(2)
    a = _t(rng.integers(-127, 128, (4, 2, 3000)).astype(np.int8))
    b = _t(rng.integers(0, 128, (4, 3000, 7)).astype(np.int8))
    assert torch.equal(pq.int8_matmul(a, b).long(),
                       torch.matmul(a.long(), b.long()))


def test_quantize_layer_stack_matches_jax():
    jm = jt.make_model(_jcfg())
    jparams = jm.init(jax.random.PRNGKey(0))
    want = _np(jt.quantize_layer_stack(jparams))
    got = pt.quantize_layer_stack(jax.tree.map(
        lambda a: _t(a, torch.float32), _np(jparams)))
    assert set(got["layers"]) == set(want["layers"])
    for name, w in want["layers"].items():
        g = got["layers"][name]
        if isinstance(w, dict):
            assert g["q"].dtype == torch.int8
            np.testing.assert_array_equal(g["q"].numpy(), w["q"])
            np.testing.assert_array_equal(g["scale"].numpy(), w["scale"])
        else:                                    # norm scales stay float
            np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got["tok_embed"].numpy(),
                                  want["tok_embed"])


# ---------------------------------------------------------------------------
# int8 attention on identical caches and pools
# ---------------------------------------------------------------------------

def _int8_rows(rng, shape):
    q, s = jq.quantize_rows(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32)))
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("suffix", [False, True])
def test_int8_contiguous_attention_matches_jax(suffix):
    rng = np.random.default_rng(3)
    B, Nq, Nkv, T, D, Ssuf = 2, 4, 2, 40, 16, 6
    jcfg, pcfg = _jcfg(), _pcfg()
    q = rng.standard_normal((B, 1, Nq, D)).astype(np.float32)
    ck, ks = _int8_rows(rng, (B, Nkv, T, D))
    cv, vs = _int8_rows(rng, (B, Nkv, T, D))
    row = [rng.standard_normal((B, Nkv, 1, D)).astype(np.float32)
           for _ in range(2)]
    sfx = [rng.standard_normal((B, Nkv, Ssuf, D)).astype(np.float32)
           for _ in range(2)]
    index = 33
    jsfx = (jnp.asarray(sfx[0]), jnp.asarray(sfx[1]), 4) if suffix else None
    psfx = (_t(sfx[0]), _t(sfx[1]), 4) if suffix else None
    want = jt._decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), index, jcfg,
        kv_row=tuple(map(jnp.asarray, row)),
        kv_scale=(jnp.asarray(ks), jnp.asarray(vs)), kv_suffix=jsfx)
    got = pt._decode_attention(
        _t(q), _t(ck), _t(cv), index, pcfg, kv_row=tuple(map(_t, row)),
        kv_scale=(_t(ks), _t(vs)), kv_suffix=psfx)
    assert rel_l2(got, want) < TOL


def _pool_case(rng, S=3, NB=10, MB=3, Nkv=2, Nq=4, bs=16, D=16):
    pk, pks = _int8_rows(rng, (NB, Nkv, bs, D))
    pv, pvs = _int8_rows(rng, (NB, Nkv, bs, D))
    tables = rng.permutation(np.arange(1, NB))[:S * MB].reshape(S, MB)
    return pk, pks, pv, pvs, tables.astype(np.int32)


def test_int8_paged_decode_attention_matches_jax():
    """One token per slot on an int8 pool: the gathered view with the
    int8 math (JAX's route for an int8 pool), at lengths 0, mid-block and
    the full table."""
    rng = np.random.default_rng(4)
    pk, pks, pv, pvs, tables = _pool_case(rng)
    S, Nkv, D = 3, 2, 16
    q = rng.standard_normal((S, 1, 4, D)).astype(np.float32)
    row = [rng.standard_normal((S, Nkv, 1, D)).astype(np.float32)
           for _ in range(2)]
    lens = np.asarray([0, 17, 48], np.int32)
    want = jt._paged_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(lens), _jcfg(),
        kv_row=tuple(map(jnp.asarray, row)),
        kv_scale=(jnp.asarray(pks), jnp.asarray(pvs)), backend="xla")
    got = pt._paged_attention(
        _t(q), _t(pk), _t(pv), _t(tables), _t(lens), _pcfg(),
        kv_row=tuple(map(_t, row)), kv_scale=(_t(pks), _t(pvs)))
    assert rel_l2(got, want) < TOL


def test_int8_span_attention_matches_jax():
    """A 5-token span per slot on an int8 pool (the verify step's and a
    prefill chunk's read), prior lengths 0, mid-block and one block."""
    rng = np.random.default_rng(5)
    pk, pks, pv, pvs, tables = _pool_case(rng)
    S, T, Nkv, D = 3, 5, 2, 16
    q = rng.standard_normal((S, T, 4, D)).astype(np.float32)
    rows = [rng.standard_normal((S, Nkv, T, D)).astype(np.float32)
            for _ in range(2)]
    prior = np.asarray([0, 21, 16], np.int32)
    want = jt._paged_span_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(prior), _jcfg(),
        kv_row=tuple(map(jnp.asarray, rows)),
        kv_scale=(jnp.asarray(pks), jnp.asarray(pvs)))
    got = pt._paged_span_attention(
        _t(q), _t(pk), _t(pv), _t(tables), _t(prior), _pcfg(),
        kv_row=tuple(map(_t, rows)), kv_scale=(_t(pks), _t(pvs)))
    assert rel_l2(got, want) < TOL


# ---------------------------------------------------------------------------
# int8 caches and pools through the model functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_models():
    jcfg, pcfg = _jcfg(kv_cache_bits=8), _pcfg(kv_cache_bits=8)
    jparams = jt.make_model(jcfg).init(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: _t(a, torch.float32), _np(jparams))
    return jcfg, jparams, pcfg, params


def _dequant(store, name):
    """An int8 store's rows dequantized (f64), for a comparison in rows
    that cannot flip a rounding by more than one step."""
    return (np.asarray(store[name], np.float64)
            * np.asarray(store[name + "_scale"], np.float64)[..., None])


def test_int8_contiguous_cache_matches_jax(int8_models):
    """prefill (quantized rows plus scales), 6 decode steps (the last 3
    under a read window), then 4 steps into a suffix, its merge and one
    more step: logits within 1e-5, buffers and scales alike."""
    jcfg, jparams, pcfg, params = int8_models
    rng = np.random.default_rng(6)
    B, P, n, T = 2, 32, 27, 96
    ids = rng.integers(0, 128, (B, P)).astype(np.int32)
    feed = rng.integers(0, 128, (11, B)).astype(np.int32)
    step = {w: jax.jit(lambda p, t, c, w=w: jt.decode_step(
        p, t, jcfg, c, read_len=w)) for w in (None, 64)}
    suffix_step = jax.jit(lambda p, t, c, s: jt.decode_step_suffix(
        p, t, jcfg, c, s))
    jc = jt.init_cache(jcfg, B, T)
    jl, jc = jt.prefill(jparams, jnp.asarray(ids), jcfg, jc, length=n)
    pc = pt.init_cache(pcfg, B, T, device="cpu")
    assert pc["k"].dtype == torch.int8 and tuple(pc["k_scale"].shape) \
        == (2, B, 2, T)
    pl, pc = pt.prefill(params, _t(ids).long(), pcfg, pc, length=n)
    assert rel_l2(pl, jl) < TOL
    for i in range(6):
        w = 64 if i >= 3 else None
        jl, jc = step[w](jparams, jnp.asarray(feed[i]), jc)
        pl, pc = pt.decode_step(params, _t(feed[i]).long(), pcfg, pc,
                                read_len=w)
        assert rel_l2(pl, jl) < TOL, i
    jsuf = jt.init_suffix(jcfg, B, 4, cache=jc)
    psuf = pt.init_suffix(pcfg, B, 4, cache=pc)
    assert psuf["k"].dtype == torch.float32          # compute dtype
    for i in range(6, 10):
        jl, jsuf = suffix_step(jparams, jnp.asarray(feed[i]), jc, jsuf)
        pl, psuf = pt.decode_step_suffix(params, _t(feed[i]).long(), pcfg,
                                         pc, psuf)
        assert rel_l2(pl, jl) < TOL, i
    jc = jt.merge_suffix(jcfg, jc, jsuf)
    pc = pt.merge_suffix(pcfg, pc, psuf)
    assert pc["index"] == int(jc["index"]) == n + 10
    jl, jc = step[None](jparams, jnp.asarray(feed[10]), jc)
    pl, pc = pt.decode_step(params, _t(feed[10]).long(), pcfg, pc)
    assert rel_l2(pl, jl) < TOL
    for name in ("k", "v"):
        assert rel_l2(_dequant(pc, name), _dequant(jc, name)) < TOL, name


def test_int8_paged_prefill_decode_and_span_match_jax(int8_models):
    """Two prompts prefilled into an int8 pool, 4 decode steps (one slot
    inactive for the last two), then a 3-token span with one pad row:
    logits within 1e-5 and the pools' live rows alike."""
    jcfg, jparams, pcfg, params = int8_models
    rng = np.random.default_rng(7)
    NB, bs, MB = 13, 16, 4
    prompts = (21, 32)
    tables = np.asarray([[3, 7, 1, 9], [2, 12, 5, 4]], np.int32)
    ids = rng.integers(0, 128, (2, 32)).astype(np.int32)
    jp = jt.init_paged_cache(jcfg, NB, bs)
    pp = pt.init_paged_cache(pcfg, NB, bs, device="cpu")
    assert pp["k"].dtype == torch.int8 and set(pp) == set(jp)
    for s, n in enumerate(prompts):
        P = -(-n // bs) * bs
        jl, jp = jt.prefill_paged(jparams, jnp.asarray(ids[s:s + 1, :P]),
                                  jcfg, jp, jnp.asarray(tables[s, :P // bs]),
                                  length=n)
        pl = pt.prefill_paged(params, _t(ids[s:s + 1, :P]).long(), pcfg, pp,
                              _t(tables[s, :P // bs]), length=n)
        assert rel_l2(pl, jl) < TOL, s
    lens = np.asarray(prompts, np.int32)
    for i in range(4):
        act = np.asarray([True, i < 2])
        tok = rng.integers(0, 128, (2,)).astype(np.int32)
        jl, jp = jt.decode_step_paged(
            jparams, jnp.asarray(tok), jcfg, jp, jnp.asarray(tables),
            jnp.asarray(lens), active=jnp.asarray(act))
        pl = pt.decode_step_paged(params, _t(tok).long(), pcfg, pp,
                                  _t(tables), _t(lens), active=_t(act))
        assert rel_l2(pl, jl) < TOL, i
        lens = lens + act.astype(np.int32)
    span = rng.integers(0, 128, (2, 3)).astype(np.int32)
    n_rows = np.asarray([3, 2], np.int32)
    jl, jp = jt.decode_span_paged(
        jparams, jnp.asarray(span), jcfg, jp, jnp.asarray(tables),
        jnp.asarray(lens), n_rows=jnp.asarray(n_rows))
    pl = pt.decode_span_paged(params, _t(span).long(), pcfg, pp, _t(tables),
                              _t(lens), n_rows=_t(n_rows))
    assert rel_l2(pl, jl) < TOL
    for name in ("k", "v"):          # block 0 is trash: never compared
        assert rel_l2(_dequant(pp, name)[:, 1:],
                      _dequant(jp, name)[:, 1:]) < TOL, name


# ---------------------------------------------------------------------------
# int8 engines against JAX's
# ---------------------------------------------------------------------------

def _shared_load(rng, n=4):
    """tests/unit/test_prefix_cache.py's ``_shared_load``."""
    shared = rng.integers(0, 128, size=(40,)).astype(np.int32)
    return [(np.concatenate([shared, rng.integers(0, 128, size=(k,))
                             .astype(np.int32)]), 8)
            for k in rng.integers(3, 12, size=(n,))]


def _repetitive_load(rng, n=3):
    """tests/unit/test_spec_decode.py's ``_repetitive_load``."""
    reqs = []
    for _ in range(n):
        motif = rng.integers(0, 128, size=(4,)).astype(np.int32)
        prompt = np.concatenate([motif, motif, motif,
                                 rng.integers(0, 128, size=(3,))
                                 .astype(np.int32)])
        reqs.append((prompt, 10))
    return reqs


# name: (load, serving options); the loads of JAX's int8 tests
INT8_LOADS = {
    "plain": (lambda: [(np.random.default_rng(5).integers(
        0, 128, size=(m,)).astype(np.int32), 8) for m in (12, 33)], {}),
    "warm": (lambda: _shared_load(np.random.default_rng(13)),
             {"enable_prefix_cache": True}),
    "spec": (lambda: _repetitive_load(np.random.default_rng(23)),
             {"spec_tokens": 3}),
}


@pytest.fixture(scope="module")
def int8_params():
    jm = jt.make_model(_jcfg())
    return _np(jm.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name", sorted(INT8_LOADS))
def test_int8_serving_matches_jax(int8_params, name):
    """The same int8 engine configuration on both sides, JAX's
    ``test_serving_int8_kv_pool``, ``test_warm_vs_cold_int8_kv`` and
    ``test_spec_int8_kv_agreement`` loads: token-identical streams, the
    pool int8 with its scales, the same pool bytes and decode route."""
    make, extra = INT8_LOADS[name]
    reqs = make()
    serving = {**SERVING, **extra}
    jsrv = deepspeed_tpu.init_serving(
        jt.make_model(_jcfg()), config={"kv_cache_bits": 8},
        serving=serving, dtype=jnp.float32, params=int8_params)
    want = jsrv.run(list(reqs))
    srv = deepspeed_tpu_torch.init_serving(
        pt.make_model(_pcfg()), config={"kv_cache_bits": 8},
        serving=serving, params=int8_params, dtype=torch.float32,
        device="cpu")
    assert srv.model.config.kv_cache_bits == 8
    assert srv.pools["k"].dtype == torch.int8
    assert set(srv.pools) == {"k", "v", "k_scale", "v_scale"}
    got = srv.run(list(reqs))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"request {rid} diverged")
    st, jst = srv.stats(), jsrv.stats()
    assert st["pool_bytes"] == jst["pool_bytes"]
    assert st["kv_cache_bits"] == 8 and st["weight_bits"] == 0
    assert (srv.decode_backend, srv.backend_bench["reason"]) == (
        jsrv.decode_backend, jsrv.backend_bench["reason"])
    assert st["decode_steps"] > 0 or name == "spec"
    if name == "warm":
        assert st["prefix_hits"] == jst["prefix_hits"] >= 1
    if name == "spec":
        for key in ("spec_steps", "spec_proposed", "spec_accepted"):
            assert st[key] == jst[key], key
        assert st["decode_steps"] == 0 and st["spec_accepted"] > 0
    assert srv.allocator.used_blocks == (
        srv._prefix_cache.held_blocks if name == "warm" else 0)


def test_int8_generate_matches_jax_and_paged(int8_params):
    """``generate`` on the int8 contiguous cache: token-identical to JAX's
    int8 ``generate``, and to the int8 paged engine by JAX's bar (the
    first p + 4 tokens equal, agreement > 0.9)."""
    reqs = INT8_LOADS["plain"][0]()
    je = deepspeed_tpu.init_inference(
        jt.make_model(_jcfg()), config={"kv_cache_bits": 8},
        dtype=jnp.float32, params=int8_params)
    pe = deepspeed_tpu_torch.init_inference(
        pt.make_model(_pcfg()), config={"kv_cache_bits": 8},
        params=int8_params, dtype=torch.float32, device="cpu")
    srv = deepspeed_tpu_torch.inference.ServingEngine(
        pe, deepspeed_tpu_torch.inference.ServingConfig(**SERVING))
    paged = srv.run(list(reqs))
    for i, (p, n) in enumerate(reqs):
        want = np.asarray(je.generate(p[None], max_new_tokens=n))[0]
        got = pe.generate(p[None], max_new_tokens=n)[0].numpy()
        np.testing.assert_array_equal(got, want)
        assert (paged[i][:p.size + 4] == got[:p.size + 4]).all()
        assert (paged[i] == got).mean() > 0.9


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["weight_bits", "quantize_bits"])
def test_int8_weights_match_jax(int8_params, mode):
    """The same float weights quantized by both engines: forward logits
    within 1e-5 of JAX's same mode, the layer stack int8 (under 0.3 x the
    f32 bytes), the GEMM fusion off, and greedy serving token-identical
    to JAX's engine in that mode."""
    ids = np.random.default_rng(8).integers(0, 128, (2, 24)).astype(np.int32)
    je = deepspeed_tpu.init_inference(
        jt.make_model(_jcfg()), config={mode: 8, "kv_cache_bits": 0},
        dtype=jnp.float32, params=int8_params)
    pe = deepspeed_tpu_torch.init_inference(
        pt.make_model(_pcfg()), config={mode: 8, "kv_cache_bits": 0},
        params=int8_params, dtype=torch.float32, device="cpu")
    cfg = pe.model.config
    assert cfg.quantized_weights and cfg.weight_only_bits == (
        8 if mode == "weight_bits" else 0)
    assert "wq" in pe.params["layers"] and "wqkv" not in pe.params["layers"]
    want = np.asarray(je.forward(jnp.asarray(ids)))
    got = pe.forward(ids)
    assert rel_l2(got, want) < TOL

    def nbytes(layers):
        return sum(t.numel() * t.element_size()
                   for v in layers.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    f32 = sum(np.asarray(a).nbytes for a in int8_params["layers"].values())
    assert nbytes(pe.params["layers"]) < 0.3 * f32
    reqs = INT8_LOADS["plain"][0]()
    jsrv = deepspeed_tpu.ServingEngine(je, deepspeed_tpu.inference.serving
                                       .ServingConfig(**SERVING))
    srv = deepspeed_tpu_torch.inference.ServingEngine(
        pe, deepspeed_tpu_torch.inference.ServingConfig(**SERVING))
    want, got = jsrv.run(list(reqs)), srv.run(list(reqs))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert srv.stats()["weight_bits"] == (8 if mode == "weight_bits" else 0)


def test_quantized_tree_moves_over_and_needs_a_mode(int8_params):
    """A JAX ``quantize_layer_stack`` tree goes through
    ``params_from_numpy`` as int8 payloads with f32 scales; an engine
    without weight_bits / quantize_bits refuses it."""
    q = _np(jt.quantize_layer_stack(jax.tree.map(jnp.asarray, int8_params)))
    pe = deepspeed_tpu_torch.init_inference(
        pt.make_model(_pcfg()), config={"weight_bits": 8,
                                        "kv_cache_bits": 0},
        params=q, dtype=torch.float32, device="cpu")
    wq = pe.params["layers"]["wq"]
    assert wq["q"].dtype == torch.int8 and wq["scale"].dtype == torch.float32
    np.testing.assert_array_equal(wq["q"].numpy(), q["layers"]["wq"]["q"])
    with pytest.raises(ValueError, match="int8 layer stacks"):
        deepspeed_tpu_torch.init_inference(
            pt.make_model(_pcfg()), params=q, dtype=torch.float32,
            device="cpu")
    for bad, why in (({"weight_bits": 4}, "weight_bits"),
                     ({"quantize_bits": 4}, "int8"),
                     ({"weight_bits": 8, "quantize_bits": 8},
                      "mutually exclusive"),
                     ({"kv_cache_bits": 4}, "kv_cache_bits")):
        with pytest.raises(ValueError, match=why):
            deepspeed_tpu_torch.inference.InferenceConfig(**bad)


# ---------------------------------------------------------------------------
# the context-aware int8 KV default
# ---------------------------------------------------------------------------

# (model max_seq_len, init_inference config or None for init_serving,
#  serving options)
DEFAULTS = {
    "short-engine": (256, {"max_tokens": 256}, None),
    "long-engine": (4096, {"max_tokens": 2048}, None),
    "engine-default": (256, {}, None),
    "explicit-0": (4096, {"kv_cache_bits": 0}, None),
    "serving-explicit-max-tokens": (4096, {"max_tokens": 256},
                                    dict(max_model_len=2048)),
    "serving-cap": (4096, {}, dict(max_model_len=2048)),
    "serving-clamped": (256, {}, dict(max_model_len=2048)),
    "serving-short": (256, {}, dict(max_model_len=128)),
}


@pytest.mark.parametrize("case", sorted(DEFAULTS))
def test_kv_cache_bits_default_matches_jax(case):
    """The resolved ``kv_cache_bits`` and ``max_tokens`` of the same
    configuration on both sides (JAX's
    ``test_kv_cache_bits_default_is_context_aware``,
    ``test_init_serving_respects_explicit_max_tokens`` and
    ``test_init_serving_clamps_max_tokens_to_model_cap``), and a serving
    engine's pool dtype and bytes."""
    cap, config, serving = DEFAULTS[case]
    cfg = {**CFG, "max_seq_len": cap}
    jm = jt.make_model(jt.TransformerConfig(**cfg, dtype=jnp.float32,
                                            attention_impl="xla"))
    pm = pt.make_model(pt.TransformerConfig(**cfg, dtype=torch.float32))
    if serving is None:
        j = deepspeed_tpu.init_inference(jm, config=dict(config),
                                         dtype=jnp.float32)
        p = deepspeed_tpu_torch.init_inference(pm, config=dict(config),
                                               dtype=torch.float32,
                                               device="cpu")
        je, pe = j, p
    else:
        sv = dict(max_seqs=2, block_size=16, **serving)
        j = deepspeed_tpu.init_serving(jm, config=dict(config), serving=sv,
                                       dtype=jnp.float32)
        p = deepspeed_tpu_torch.init_serving(pm, config=dict(config),
                                             serving=sv, dtype=torch.float32,
                                             device="cpu")
        je, pe = j.engine, p.engine
        assert p.pool_bytes == j.pool_bytes
        assert p.pool_bytes == pool_bytes(p.model.config, p.num_blocks, 16,
                                          dtype=torch.float32)
        assert (p.pools["k"].dtype == torch.int8) == (
            j.pools["k"].dtype == jnp.int8)
    assert pe.config.max_tokens == je.config.max_tokens
    assert pe.model.config.kv_cache_bits == je.model.config.kv_cache_bits

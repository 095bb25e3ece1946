"""The port's multi-LoRA serving against the JAX package at f32, on the
model and adapters of ``tests/unit/test_lora_serving.py`` (numpy-seeded
tables at scale 0.2, so the deltas move greedy argmaxes): the gathered
delta within 1e-6 of JAX's, the adapter slot pool's accounting equal to
JAX's under one seeded acquire / release sequence, mixed-adapter streams
token-identical to JAX's engine and to the port's merged-dense serial
runs, eviction and re-paging, all-pinned exhaustion bouncing (not
failing) a request, validation, LoRA under ``weight_bits=8`` and under
speculation with a prefill budget and the prefix cache, the prefix-cache
bypass of adapter requests, and the stats counters against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import kv_cache as jkv
from deepspeed_tpu.inference import lora as jlora
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.inference import kv_cache as pkv
from deepspeed_tpu_torch.inference import lora as plora
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.robustness import events as rb_events

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

RANK = 4
# tests/unit/test_lora_serving.py's _cfg and _serving, at f32
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=256, position_type="rotary",
           activation="silu_glu", norm_type="rmsnorm", tie_embeddings=False)
SERVING = dict(max_seqs=2, block_size=16, max_model_len=128,
               decode_quantum=4, prompt_bucket=16)
LORA = dict(adapter_slots=4, lora_rank=RANK)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def base():
    """JAX's raw (unfused) init and three adapters, numpy."""
    jcfg = jt.TransformerConfig(**CFG, dtype=jnp.float32,
                                attention_impl="xla")
    params = jax.tree.map(np.asarray, jax.device_get(
        jt.init_params(jax.random.PRNGKey(0), jcfg)))
    adapters = {a: plora.make_random_adapter(jcfg, RANK, seed=a, scale=0.2)
                for a in (1, 2, 3)}
    return jcfg, params, adapters


def _jax_srv(params, config=None, **serving):
    jm = jt.make_model(jt.TransformerConfig(**CFG, dtype=jnp.float32,
                                            attention_impl="xla"))
    return deepspeed_tpu.init_serving(
        jm, config={"kv_cache_bits": 0, **(config or {})},
        serving={**SERVING, **serving}, dtype=jnp.float32, params=params)


def _port_srv(params, config=None, **serving):
    pm = pt.make_model(pt.TransformerConfig(**CFG, dtype=torch.float32))
    return deepspeed_tpu_torch.init_serving(
        pm, config={"kv_cache_bits": 0, **(config or {})},
        serving={**SERVING, **serving}, params=params,
        dtype=torch.float32, device="cpu")


def _register(srv, adapters, ids=(1, 2, 3)):
    for a in ids:
        srv.register_adapter(a, adapters[a])
    return srv


def _reqs(seed=0, lens=(7, 21, 12, 30), news=(9, 6, 8, 5)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, size=(n,)).astype(np.int32), k)
            for n, k in zip(lens, news)]


def _streams(outs):
    return [np.asarray(outs[k]) for k in sorted(outs)]


def _assert_same(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: request {i}")


_COUNTERS = ("adapter_hits", "adapter_page_ins", "adapter_evictions",
             "completed", "generated_tokens", "preemptions")


def _same_counters(port, jax_srv):
    p, j = port.stats(), jax_srv.stats()
    assert {k: p[k] for k in _COUNTERS} == {k: j[k] for k in _COUNTERS}


# ---------------------------------------------------------------------------
# the delta, the store and the slot pool
# ---------------------------------------------------------------------------

def test_lora_delta_matches_jax():
    rng = np.random.default_rng(0)
    h = rng.normal(size=(5, 3, 64)).astype(np.float32)
    a = rng.normal(size=(4, 64, RANK)).astype(np.float32)
    b = rng.normal(size=(4, RANK, 32)).astype(np.float32)
    a[0] = b[0] = 0                         # slot 0: the null adapter
    idx = np.array([0, 2, 1, 3, 0], np.int32)
    want = np.asarray(jt._lora_delta(jnp.asarray(h),
                                     (jnp.asarray(a), jnp.asarray(b)),
                                     jnp.asarray(idx)))
    got = pt._lora_delta(torch.from_numpy(h), (torch.from_numpy(a),
                                               torch.from_numpy(b)),
                         torch.from_numpy(idx)).numpy()
    assert rel_l2(got, want) <= 1e-6
    assert not got[0].any() and not got[4].any()   # exact zero delta


def test_store_tables_and_merge_match_jax(base):
    jcfg, params, adapters = base
    jtabs = jlora.make_random_adapter(jcfg, RANK, seed=2, scale=0.2)
    for proj, (a, b) in jtabs.items():
        np.testing.assert_array_equal(adapters[2][proj][0], a)
        np.testing.assert_array_equal(adapters[2][proj][1], b)
    js = jlora.AdapterStore(jcfg, RANK)
    ps = plora.AdapterStore(jcfg, RANK)
    js.register(2, jtabs, alpha=8.0)
    ps.register(2, adapters[2], alpha=8.0)
    jt_ = js.table_for_slot(2, np.float32)
    for proj, ab in ps.table_for_slot(2).items():
        for name in ("a", "b"):
            np.testing.assert_array_equal(ab[name], jt_[proj][name])
    pm = plora.apply_lora_dense(params, jcfg, adapters[1])
    jm = jlora.apply_lora_dense(params, jcfg, adapters[1])
    for k in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(pm["layers"][k], jm["layers"][k])
    pool = plora.init_adapter_pool(jcfg, 3, RANK, ("q", "o"), device="cpu")
    assert pool["q"]["a"].shape == (2, 3, 64, RANK)
    assert pool["o"]["b"].shape == (2, 3, RANK, 64)
    assert not any(t.any() for ab in pool.values() for t in ab.values())


def test_slot_pool_matches_jax_under_seeded_sequence():
    """One seeded acquire / release sequence through both pools: the same
    slots, page-ins, exhaustion points and counters."""
    rng = np.random.default_rng(5)
    jp, pp = jkv.AdapterSlotPool(4), pkv.AdapterSlotPool(4)
    held = []
    for _ in range(300):
        if held and rng.random() < 0.45:
            aid = held.pop(int(rng.integers(len(held))))
            jp.release(aid)
            pp.release(aid)
            continue
        aid = int(rng.integers(0, 7))
        got = []
        for pool, exc in ((jp, jkv.BlockPoolExhausted),
                          (pp, pkv.BlockPoolExhausted)):
            try:
                got.append(pool.acquire(aid))
            except exc:
                got.append("exhausted")
        assert got[0] == got[1]
        if got[0] != "exhausted" and aid:
            held.append(aid)
        assert (pp.hits, pp.page_ins, pp.evictions, pp.resident) == \
            (jp.hits, jp.page_ins, jp.evictions, jp.resident)
    assert pp.evictions > 0 and pp.hits > 0
    with pytest.raises(ValueError, match="no in-flight reader"):
        pp.release(99)
    pp.reset()
    assert pp.resident == 0 and pp.acquire(5) == (1, True)


# ---------------------------------------------------------------------------
# serving: the parity bar and slot pressure
# ---------------------------------------------------------------------------

def test_mixed_batch_matches_jax_and_merged_serial(base):
    """Interleaved tenants {base, 1, 2, 3} on one engine: token-identical
    to JAX's pooled engine, to each tenant served alone on merged dense
    weights, and the nonzero adapters change the tokens."""
    jcfg, params, adapters = base
    load = [(p, n, a) for (p, n), a in zip(_reqs(seed=1), (0, 1, 2, 3))]
    j = _register(_jax_srv(params, max_seqs=4, **LORA), adapters)
    want = _streams(j.run(list(load)))
    srv = _register(_port_srv(params, max_seqs=4, **LORA), adapters)
    got = _streams(srv.run(list(load)))
    _assert_same(got, want, "pooled vs JAX")
    _same_counters(srv, j)
    assert srv.stats()["adapter_page_ins"] == 3.0
    for i, (p, n, a) in enumerate(load):
        merged = (plora.apply_lora_dense(params, jcfg, adapters[a]) if a
                  else params)
        solo = _port_srv(merged).run([(p, n)])
        np.testing.assert_array_equal(got[i], solo[0],
                                      err_msg=f"adapter {a}: merged")
    plain = _streams(_port_srv(params, max_seqs=4).run(
        [(p, n) for p, n, _ in load]))
    np.testing.assert_array_equal(got[0], plain[0])
    assert any(not np.array_equal(got[i], plain[i]) for i in (1, 2, 3))
    assert srv.adapter_slots.resident == 3
    assert all(srv.adapter_slots.refcount(a) == 0 for a in (1, 2, 3))


def test_eviction_and_repaging_match_jax(base):
    """2 usable slots, 3 tenants, one request at a time: the third
    page-in evicts the LRU resident, re-demanding it re-pages it with the
    same tokens, and a resident re-acquire is a hit — stream for stream
    and counter for counter with JAX."""
    _, params, adapters = base
    (prompt, n), = _reqs(seed=2)[:1]
    seq = (1, 2, 3, 1, 1)
    j = _register(_jax_srv(params, adapter_slots=3, lora_rank=RANK),
                  adapters)
    srv = _register(_port_srv(params, adapter_slots=3, lora_rank=RANK),
                    adapters)
    got, want = [], []
    for a in seq:
        want += _streams(j.run([(prompt, n, a)]))
        got += _streams(srv.run([(prompt, n, a)]))
        _same_counters(srv, j)
    _assert_same(got, want, "eviction sequence")
    np.testing.assert_array_equal(got[0], got[3])     # re-paged adapter 1
    st = srv.stats()
    assert (st["adapter_page_ins"], st["adapter_evictions"],
            st["adapter_hits"]) == (4.0, 2.0, 1.0)


def test_all_pinned_exhaustion_bounces_not_fails(base):
    """Every slot pinned by in-flight tenants: the third request bounces
    to the queue (an ``adapter_slots_exhausted`` event, a preemption) and
    completes once a slot frees, with JAX's tokens."""
    _, params, adapters = base
    load = [(p, n, a) for (p, n), a in zip(
        _reqs(seed=3, lens=(8, 8, 8), news=(12, 12, 4)), (1, 2, 3))]
    j = _register(_jax_srv(params, max_seqs=3, adapter_slots=3,
                           lora_rank=RANK), adapters)
    want = _streams(j.run(list(load)))
    rb_events.clear()
    srv = _register(_port_srv(params, max_seqs=3, adapter_slots=3,
                              lora_rank=RANK), adapters)
    got = _streams(srv.run(list(load)))
    _assert_same(got, want, "exhaustion")
    assert rb_events.history("adapter_slots_exhausted")
    assert srv.stats()["completed"] == 3.0
    assert srv.allocator.used_blocks == 0
    assert all(srv.adapter_slots.refcount(a) == 0 for a in (1, 2, 3))


def test_adapter_validation(base):
    jcfg, params, adapters = base
    plain = _port_srv(params)
    with pytest.raises(ValueError, match="adapter_slots=0"):
        plain.register_adapter(1, adapters[1])
    with pytest.raises(ValueError, match="adapter_slots=0"):
        plain.add_request(np.arange(4, dtype=np.int32), 4, adapter_id=1)
    srv = _port_srv(params, adapter_slots=3, lora_rank=RANK)
    with pytest.raises(ValueError, match="not registered"):
        srv.add_request(np.arange(4, dtype=np.int32), 4, adapter_id=9)
    with pytest.raises(ValueError, match="reserved"):
        srv.register_adapter(0, adapters[1])
    with pytest.raises(ValueError, match="targets"):
        srv.register_adapter(4, {"q": adapters[1]["q"]})
    bad = dict(adapters[1], q=(adapters[1]["q"][0][:, :, :2],
                               adapters[1]["q"][1]))
    with pytest.raises(ValueError, match="q.A shape"):
        srv.register_adapter(4, bad)
    with pytest.raises(ValueError, match="num_slots=1"):
        pkv.AdapterSlotPool(1)
    with pytest.raises(ValueError, match="adapter_slots=1"):
        _port_srv(params, adapter_slots=1, lora_rank=RANK)
    with pytest.raises(ValueError, match="lora_rank=0"):
        _port_srv(params, adapter_slots=2)
    with pytest.raises(ValueError, match="unknown lora targets"):
        _port_srv(params, adapter_slots=2, lora_rank=RANK,
                  lora_targets=("q", "gate"))


def test_double_release_is_a_no_op(base):
    """A request's pin is dropped once: a second release (finish after a
    cancel, a recovery after a release) must not drive the refcount
    below zero."""
    _, params, adapters = base
    srv = _register(_port_srv(params, adapter_slots=3, lora_rank=RANK),
                    adapters)
    srv.add_request(np.arange(9, dtype=np.int32), 8, adapter_id=1)
    srv.add_request(np.arange(5, dtype=np.int32), 8, adapter_id=1)
    srv.step()
    req = srv.scheduler.running[0]
    assert srv.adapter_slots.refcount(1) == 2
    srv._release_adapter(req)
    srv._release_adapter(req)
    assert srv.adapter_slots.refcount(1) == 1 and req.adapter_slot is None


# ---------------------------------------------------------------------------
# composition: int8 weights, speculation, chunking, the prefix cache
# ---------------------------------------------------------------------------

def test_lora_with_weight_bits_matches_jax(base):
    """int8 base weights (epilogue scale) plus the pooled f32 delta,
    token-identical to JAX's engine with the same settings."""
    _, params, adapters = base
    load = [(p, n, a) for (p, n), a in zip(_reqs(seed=7), (1, 0, 2, 1))]
    wb = {"weight_bits": 8}
    j = _register(_jax_srv(params, config=wb, max_seqs=4, **LORA),
                  adapters)
    srv = _register(_port_srv(params, config=wb, max_seqs=4, **LORA),
                    adapters)
    _assert_same(_streams(srv.run(list(load))), _streams(j.run(list(load))),
                 "weight_bits")
    _same_counters(srv, j)


def test_lora_with_spec_budget_and_cache_matches_jax(base):
    """The latency stack on (speculation, a prefill budget, the prefix
    cache) over a mixed-tenant shared-prefix load, twice in a row:
    token-identical to JAX's engine with the same settings and to the
    port's plain pooled engine."""
    _, params, adapters = base
    rng = np.random.default_rng(8)
    shared = rng.integers(0, 128, size=(40,)).astype(np.int32)
    load = []
    for i, a in enumerate((0, 1, 2, 0)):
        tail = rng.integers(0, 128, size=(5 + i,)).astype(np.int32)
        load.append((np.concatenate([shared, tail]), 8, a))
    feats = dict(enable_prefix_cache=True, prefill_token_budget=32,
                 spec_tokens=4, max_seqs=4, adapter_slots=3,
                 lora_rank=RANK)
    plain = _streams(_register(_port_srv(
        params, max_seqs=4, adapter_slots=3, lora_rank=RANK),
        adapters).run(list(load)))
    j = _register(_jax_srv(params, **feats), adapters)
    srv = _register(_port_srv(params, **feats), adapters)
    for _ in range(2):
        want = _streams(j.run(list(load)))
        got = _streams(srv.run(list(load)))
        _assert_same(got, want, "latency stack vs JAX")
        _assert_same(got, plain, "latency stack vs plain pooled")
    st = srv.stats()
    assert st["prefix_hit_rows"] > 0 and st["spec_steps"] > 0
    assert st["prefill_chunks"] > 0 and st["decode_steps"] == 0
    for k in ("prefix_hit_rows", "spec_steps", "spec_accepted",
              "prefill_chunks") + _COUNTERS:
        assert st[k] == j.stats()[k], k


def test_adapter_requests_skip_prefix_cache(base):
    """The same prompt under adapter 1 neither matches the base request's
    published prefix nor publishes its own; a base repeat does hit."""
    _, params, adapters = base
    srv = _register(_port_srv(params, adapter_slots=2, lora_rank=RANK,
                              enable_prefix_cache=True), adapters, (1,))
    prompt = np.arange(48, dtype=np.int32) % 128
    srv.run([(prompt, 4)])
    srv.run([(prompt, 4, 1)])
    srv.run([(prompt, 4, 1)])
    assert srv.stats()["prefix_hit_rows"] == 0.0
    srv.run([(prompt, 4)])
    assert srv.stats()["prefix_hit_rows"] > 0


def test_stats_counters_and_reset(base):
    _, params, adapters = base
    srv = _register(_port_srv(params, adapter_slots=3, lora_rank=RANK),
                    adapters, (1,))
    plain = _port_srv(params)
    pool = sum(t.numel() * 4 for ab in srv.adapter_pool.values()
               for t in ab.values())
    assert srv.stats()["pool_bytes"] == plain.stats()["pool_bytes"] + pool
    p, n = _reqs(seed=9)[0]
    srv.run([(p, n, 1)])
    st = srv.stats()
    assert st["adapter_page_ins"] == 1.0 and st["weight_bits"] == 0.0
    srv.reset_stats()
    st = srv.stats()
    assert (st["adapter_page_ins"], st["adapter_hits"],
            st["adapter_evictions"]) == (0.0, 0.0, 0.0)
    assert plain.stats()["adapter_page_ins"] == 0.0

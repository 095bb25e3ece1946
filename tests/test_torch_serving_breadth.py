"""Serving breadth in the port against the JAX package: the span path
(``decode_span_paged``, logits and pools within 1e-5 relative L2 at f32),
token-budget chunked prefill and the copy-on-write prefix cache (greedy
streams token-identical to the JAX engine's and to the port's own plain
streams), and the reliability tier (deadlines, admission watermarks, the
JSONL sink, the dispatch watchdog) as JAX's ``TestDeadlines`` and
``TestAdmissionWatermarks`` pin it. Every field of JAX's ``ServingConfig``
is either served by the port or refused naming its ROADMAP item."""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import serving as jax_serving
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.robustness import events as jax_events
from deepspeed_tpu_torch.inference import serving as port_serving
from deepspeed_tpu_torch.inference.scheduler import AdmissionRejected
from deepspeed_tpu_torch.models import convert, transformer as pt
from deepspeed_tpu_torch.robustness import events as port_events

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

# tests/unit/test_serving.py's _cfg at f32, and its _serving defaults
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


@pytest.fixture(scope="module")
def ref():
    """The JAX model and its seeded params as numpy (the port's weights)."""
    jm = jt.make_model(jt.TransformerConfig(**CFG, dtype=jnp.float32,
                                            attention_impl="xla"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jax.device_get(params))
    return jm, params


def _jax_srv(ref, **serving):
    jm, params = ref
    return deepspeed_tpu.init_serving(
        jm, config={"kv_cache_bits": 0}, serving={**SERVING, **serving},
        dtype=jnp.float32, params=params)


def _port_srv(ref, **serving):
    model = pt.make_model(pt.TransformerConfig(**CFG, dtype=torch.float32))
    return deepspeed_tpu_torch.init_serving(
        model, config={"kv_cache_bits": 0}, serving={**SERVING, **serving},
        params=ref[1], dtype=torch.float32, device="cpu")


def _streams(outs):
    return [outs[k] for k in sorted(outs)]     # by submission order


def _assert_same(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: request {i}")


def _rand(rng, n):
    return rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32)


# ---------------------------------------------------------------------------
# The span path
# ---------------------------------------------------------------------------

def test_decode_span_paged_matches_jax(ref):
    """Two slots with rows already in the pool (prefills of 20 and 9
    tokens), then a 16-token span each: slot 0 writes all 16 rows, slot 1
    only 10 (its pad rows go to the trash block), a third slot is inactive.
    Logits and every pool block but the trash block within 1e-5."""
    jm, params = ref
    jcfg = jm.config
    cfg = pt.TransformerConfig(**CFG, dtype=torch.float32)
    p_params = convert.params_from_numpy(params, cfg, device="cpu",
                                         dtype=torch.float32)
    bs, NB, T = 16, 12, 16
    tables = np.asarray([[3, 5, 7, 0], [2, 8, 9, 0], [4, 0, 0, 0]], np.int32)
    prompts = (20, 9)
    rng = np.random.default_rng(1)
    ids = [_rand(rng, 32) for _ in prompts]
    span = np.stack([_rand(rng, T) for _ in range(3)])
    lens = np.asarray(prompts + (0,), np.int32)
    active = np.asarray([True, True, False])
    n_rows = np.asarray([16, 10, 16], np.int32)

    jpools = jt.init_paged_cache(jcfg, NB, bs)
    ppools = pt.init_paged_cache(cfg, NB, bs, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    prefill = jax.jit(lambda p, i, pl, b, n: jt.prefill_paged(
        p, i, jcfg, pl, b, length=n))
    for s, n in enumerate(prompts):
        P = -(-n // bs) * bs
        _, jpools = prefill(jparams, jnp.asarray(ids[s][None, :P]), jpools,
                            jnp.asarray(tables[s, :P // bs]), n)
        pt.prefill_paged(p_params, torch.from_numpy(ids[s][None, :P]).long(),
                         cfg, ppools, torch.from_numpy(tables[s, :P // bs]),
                         length=n)
    jl, jpools = jax.jit(lambda *a: jt.decode_span_paged(
        a[0], a[1], jcfg, a[2], a[3], a[4], active=a[5], n_rows=a[6]))(
        jparams, jnp.asarray(span), jpools, jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(active), jnp.asarray(n_rows))
    pl = pt.decode_span_paged(
        p_params, torch.from_numpy(span), cfg, ppools,
        torch.from_numpy(tables), torch.from_numpy(lens),
        active=torch.from_numpy(active), n_rows=torch.from_numpy(n_rows))
    assert pl.shape == (3, T, CFG["vocab_size"])
    assert rel_l2(pl[:2], jl[:2]) < TOL
    for name in ("k", "v"):
        assert rel_l2(ppools[name][:, 1:], jpools[name][:, 1:]) < TOL, name
    # slot 1's pad rows (9 + 10 .. 9 + 15) and the inactive slot wrote
    # nothing outside the trash block
    assert not ppools["k"][:, 4].abs().sum()
    assert not ppools["k"][:, 9, :, 3:].abs().sum()


def test_span_of_one_token_is_the_decode_step(ref):
    """T = 1 through the span path is the single-token step's math (the
    gathered plain version): same logits and rows."""
    _, params = ref
    cfg = pt.TransformerConfig(**CFG, dtype=torch.float32)
    p_params = convert.params_from_numpy(params, cfg, device="cpu",
                                         dtype=torch.float32)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(_rand(rng, 32)[None]).long()
    tables = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32)
    outs = []
    for span in (True, False):
        pools = pt.init_paged_cache(cfg, 6, 16, device="cpu")
        pt.prefill_paged(p_params, ids, cfg, pools, tables[0, :2], length=27)
        tok = torch.tensor([5])
        lens = torch.tensor([27], dtype=torch.int32)
        if span:
            lg = pt.decode_span_paged(p_params, tok[:, None], cfg, pools,
                                      tables, lens)[:, 0]
        else:
            lg = pt.decode_step_paged(p_params, tok, cfg, pools, tables, lens)
        outs.append((lg, pools["k"].clone()))
    assert rel_l2(outs[0][0], outs[1][0]) < TOL
    assert rel_l2(outs[0][1], outs[1][1]) < TOL


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------

CHUNK_LOAD = ((70, 8), (9, 8), (33, 8))


def _chunk_load():
    rng = np.random.default_rng(6)
    return [(_rand(rng, n), k) for n, k in CHUNK_LOAD]


def test_chunked_prefill_matches_jax_and_unchunked(ref):
    want = _streams(_jax_srv(ref, prefill_token_budget=32)
                    .run(_chunk_load()))
    srv = _port_srv(ref, prefill_token_budget=32)
    _assert_same(_streams(srv.run(_chunk_load())), want, "chunked vs JAX")
    _assert_same(_streams(_port_srv(ref).run(_chunk_load())), want,
                 "unchunked vs chunked")
    st = srv.stats()
    assert st["prefill_chunks"] >= 3        # the 70-token prompt was sliced
    assert st["prefill_chunk_tokens"] >= 70
    assert srv.allocator.used_blocks == 0


def test_decode_progresses_while_long_prompt_chunks(ref):
    """With a budget, a running request keeps emitting tokens across the
    rounds a 96-token admission spends prefilling."""
    srv = _port_srv(ref, prefill_token_budget=24, decode_quantum=2)
    rng = np.random.default_rng(8)
    short = srv.add_request(_rand(rng, 8), 24)
    srv.step()
    long_req = srv._requests[srv.add_request(_rand(rng, 96), 4)]
    interleaved = 0
    for _ in range(40):
        if srv.scheduler.done:
            break
        before = len(srv._requests[short].generated)
        srv.step()
        if not long_req.prefill_done \
                and len(srv._requests[short].generated) > before:
            interleaved += 1
    assert srv.scheduler.done
    assert interleaved >= 1, "decode stalled for the whole prefill"
    assert srv.stats()["prefill_chunks"] >= 2


# ---------------------------------------------------------------------------
# Prefix cache
# ---------------------------------------------------------------------------

def _shared_load(seed, n=6, prefix=50, tail=5):
    rng = np.random.default_rng(seed)
    shared = _rand(rng, prefix)
    return [(np.concatenate([shared, _rand(rng, tail)]), 8)
            for _ in range(n)]


def test_warm_streams_match_jax_and_cold(ref):
    want = _streams(_jax_srv(ref, enable_prefix_cache=True)
                    .run(_shared_load(3)))
    srv = _port_srv(ref, enable_prefix_cache=True)
    _assert_same(_streams(srv.run(_shared_load(3))), want, "warm vs JAX")
    _assert_same(_streams(_port_srv(ref).run(_shared_load(3))), want,
                 "cold vs warm")
    st = srv.stats()
    assert st["prefix_hits"] >= 3 and st["prefix_hit_rows"] >= 3 * 48
    assert st["cow_forks"] >= 1             # boundary blocks were copied
    assert st["prefix_hit_rate"] > 0
    # every block is free or held by the cache: no leaked reference
    assert srv.allocator.used_blocks == srv._prefix_cache.held_blocks \
        == st["prefix_held_blocks"]
    srv.reset_stats()
    st = srv.stats()
    assert st["prefix_lookups"] == st["cow_forks"] == 0
    assert st["prefill_chunks"] == st["completed"] == 0
    assert "p50_itl_ms" not in st


def test_full_blocks_shared_while_donor_still_running(ref):
    """Full prompt blocks publish at prefill time: a consumer admitted
    while the donor still decodes maps them by reference."""
    rng = np.random.default_rng(7)
    shared = _rand(rng, 40)
    srv = _port_srv(ref, enable_prefix_cache=True)
    donor = srv.add_request(shared, 60)
    srv.step()
    assert not srv.scheduler.done
    consumer = srv.add_request(np.concatenate([shared, _rand(rng, 4)]), 4)
    while srv._requests[consumer].state not in ("finished", "cancelled"):
        srv.step()
    assert srv._requests[consumer].prefix_rows >= 32
    assert srv._requests[donor].state == "running"
    while not srv.scheduler.done:
        srv.step()
    solo = _port_srv(ref).run([(np.concatenate(
        [shared, srv._requests[consumer].prompt[40:]]), 4)])
    np.testing.assert_array_equal(srv._requests[consumer].output,
                                  _streams(solo)[0])


def test_fork_copies_the_boundary_block(ref):
    """A retried prompt: the finished donor leaves its partial boundary
    block (5 prompt rows + 8 generated) in the cache, and the retry's match
    reaches 4 rows into it, so the consumer forks it. Every free block is
    filled with noise first: the stream equals the cold one only if the
    fork copied the rows (stale rows of a recycled block cannot stand in
    for them)."""
    prompt = _rand(np.random.default_rng(12), 37)
    srv = _port_srv(ref, enable_prefix_cache=True)
    srv.run([(prompt, 8)])
    free = [b for b in range(1, srv.num_blocks)
            if srv.allocator.refcount(b) == 0]
    gen = torch.Generator().manual_seed(0)
    for pool in srv.pools.values():
        pool[:, free] = 5 * torch.randn(pool[:, free].shape, generator=gen)
    warm = srv.run([(prompt, 8)])
    cold = _port_srv(ref).run([(prompt, 8)])
    _assert_same(_streams(warm), _streams(cold), "forked vs cold")
    st = srv.stats()
    assert st["cow_forks"] == 1 and st["prefix_partial_hits"] == 1


def test_preempted_consumer_resumes_warm_and_exact(ref):
    """An oversubscribed pool preempts mid-load; re-prefills go through
    the cache, and every stream still equals the cold run."""
    load = _shared_load(5, n=5, prefix=40, tail=7)
    cold = _streams(_port_srv(ref).run(list(load)))
    srv = _port_srv(ref, enable_prefix_cache=True, num_blocks=12)
    _assert_same(_streams(srv.run(list(load))), cold, "warm vs cold")
    assert srv.allocator.used_blocks == srv._prefix_cache.held_blocks


def test_cache_and_budget_together_match_jax(ref):
    """The composed latency tier: prefix hits whose tails arrive in
    budgeted chunks, against JAX under the same settings."""
    load = _shared_load(9, n=5, prefix=60, tail=30)
    kw = dict(enable_prefix_cache=True, prefill_token_budget=32)
    want = _streams(_jax_srv(ref, **kw).run(list(load)))
    srv = _port_srv(ref, **kw)
    _assert_same(_streams(srv.run(list(load))), want, "cache + budget")
    st = srv.stats()
    assert st["prefix_hits"] >= 1 and st["prefill_chunks"] >= 1


# ---------------------------------------------------------------------------
# Reliability tier
# ---------------------------------------------------------------------------

def test_total_deadline_cancels_mid_decode_and_frees_blocks(ref):
    port_events.clear()
    srv = _port_srv(ref)
    rid = srv.add_request(np.arange(9, dtype=np.int32), 64)
    srv.step()
    assert srv.allocator.used_blocks > 0
    # set after the first round, so warm-up time cannot race the clock
    srv._requests[rid].deadline_ms = 1e-3
    srv.step()
    req = srv._requests[rid]
    assert req.state == "cancelled" and req.cancel_reason == "total_deadline"
    assert srv.allocator.used_blocks == 0
    assert srv.scheduler.done
    st = srv.stats()
    assert st["deadline_misses"] == st["cancelled"] == 1.0
    assert st["completed"] == 0.0
    assert len(srv.cancelled) == 1 and len(req.output) >= 9
    ev = port_events.history("deadline_miss")[-1]
    assert ev["rid"] == rid and ev["kind"] == "total"


def test_ttft_deadline_sheds_queued_request(ref):
    srv = _port_srv(ref, max_seqs=1)
    first = srv.add_request(np.arange(5, dtype=np.int32), 24)
    queued = srv.add_request(np.arange(5, dtype=np.int32), 8,
                             ttft_deadline_ms=1e-3)
    srv.step()
    srv.step()
    q = srv._requests[queued]
    assert q.state == "cancelled" and q.cancel_reason == "ttft_deadline"
    assert not q.generated
    f = srv._requests[first]
    assert f.first_token_t is not None
    while not srv.scheduler.done:
        srv.step()
    assert f.state == "finished"
    st = srv.stats()
    assert st["deadline_misses"] == 1.0 and st["completed"] == 1.0


def test_queue_watermark_sheds_typed_and_counts(ref):
    port_events.clear()
    srv = _port_srv(ref, max_queue=1)
    srv.add_request(np.arange(4, dtype=np.int32), 4)
    with pytest.raises(AdmissionRejected, match="queue_full"):
        srv.add_request(np.arange(4, dtype=np.int32), 4)
    assert srv.stats()["shed"] == 1.0
    assert port_events.history("request_shed")[-1]["reason"] == "queue_full"
    while not srv.scheduler.done:
        srv.step()
    assert srv.stats()["completed"] == 1.0


def test_pool_watermark_sheds_under_pressure(ref):
    srv = _port_srv(ref, pool_watermark=0.05)
    srv.add_request(np.arange(8, dtype=np.int32), 32)
    srv.step()
    assert srv.allocator.used_fraction > 0.05
    with pytest.raises(AdmissionRejected, match="pool_pressure"):
        srv.add_request(np.arange(8, dtype=np.int32), 4)
    with pytest.raises(ValueError, match="pool_watermark"):
        _port_srv(ref, pool_watermark=1.5)


def _sink_scenario(srv, events):
    """A shed (queue_full) and a total-deadline miss mid-decode, with the
    events drained at round ends; returns the sink's records of those
    two types."""
    events.clear()
    rid = srv.add_request(np.arange(6, dtype=np.int32), 40)
    with pytest.raises(Exception, match="queue_full"):
        srv.add_request(np.arange(6, dtype=np.int32), 4)
    srv.step()
    srv._requests[rid].deadline_ms = 1e-3
    srv.step()
    with open(srv.config.telemetry_jsonl) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r["type"] in ("request_shed", "deadline_miss")]


def test_jsonl_sink_records_match_jax(ref, tmp_path):
    """The same scenario on both engines: the sink holds the same event
    types with the same fields, and the same values but the clocks'."""
    got = _sink_scenario(_port_srv(ref, max_queue=1, telemetry_jsonl=str(
        tmp_path / "port.jsonl")), port_events)
    want = _sink_scenario(_jax_srv(ref, max_queue=1, telemetry_jsonl=str(
        tmp_path / "jax.jsonl")), jax_events)
    assert [r["type"] for r in got] == [r["type"] for r in want] \
        == ["request_shed", "deadline_miss"]
    clocks = {"time", "ts", "elapsed_ms"}
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: v for k, v in g.items() if k not in clocks} \
            == {k: v for k, v in w.items() if k not in clocks}


def test_jsonl_monitor_writes_what_jax_writes(tmp_path):
    """The port's sink and JAX's on the same records, the timestamp aside:
    non-finite floats become null at any depth, a record's own ``time`` is
    kept, an object JSON cannot spell is written as its string, and every
    write appends; a sink without a path writes nothing."""
    from deepspeed_tpu.monitor.monitor import JSONLMonitor as JaxJSONL
    from deepspeed_tpu_torch.monitor.monitor import JSONLMonitor
    batches = [[{"type": "deadline_miss", "rid": 3, "x": float("nan")},
                {"type": "request_shed", "time": 5.0,
                 "v": [1.0, float("inf"), {"w": float("-inf")}]}],
               [{"type": "other", "obj": np.float32(0.5).dtype}]]
    lines = {}
    for name, cls in (("port", JSONLMonitor), ("jax", JaxJSONL)):
        path = tmp_path / "sub" / f"{name}.jsonl"
        mon = cls(str(path))
        for b in batches:
            mon.write_records(b)
        mon.flush()
        lines[name] = [json.loads(line) for line in open(path)]
    assert len(lines["port"]) == 3
    for g, w in zip(lines["port"], lines["jax"]):
        assert {k: v for k, v in g.items() if k != "time"} \
            == {k: v for k, v in w.items() if k != "time"}
    assert lines["port"][0]["x"] is None
    assert lines["port"][1]["v"] == [1.0, None, {"w": None}]
    assert lines["port"][1]["time"] == 5.0
    assert lines["port"][2]["obj"] == "float32"
    off = JSONLMonitor("")
    off.write_records(batches[0])
    assert not off.enabled and not list(tmp_path.glob("*.jsonl"))

def test_watchdog_raises_and_engine_refuses_later_rounds(ref):
    """A round that outlives dispatch_timeout_s raises DecodeDispatchHang
    to the caller once no recovery retry is left (``round_retries=0``);
    the engine then refuses every round, naming that error. A timeout
    that is not hit leaves the stream as without one."""
    load = [(np.arange(7, dtype=np.int32), 12)]
    plain = _streams(_port_srv(ref).run(list(load)))
    armed = _port_srv(ref, dispatch_timeout_s=30.0)
    _assert_same(_streams(armed.run(list(load))), plain, "watchdog on")

    srv = _port_srv(ref, dispatch_timeout_s=0.2, round_retries=0)
    srv.add_request(np.arange(7, dtype=np.int32), 40)
    srv.step()                    # warm: the watchdog arms after this
    release = threading.Event()
    real = srv._quantum

    def hung(*args):
        release.wait(10)
        return real(*args)

    srv._quantum = hung
    with pytest.raises(port_serving.DecodeDispatchHang):
        srv.step()
    with pytest.raises(RuntimeError, match="DecodeDispatchHang"):
        srv.step()
    with pytest.raises(RuntimeError, match="DecodeDispatchHang"):
        srv.run([(np.arange(3, dtype=np.int32), 2)])
    release.set()
    assert srv.close(timeout=10)


def test_round_error_reaches_the_caller_unchanged(ref):
    srv = _port_srv(ref)
    srv.add_request(np.arange(7, dtype=np.int32), 12)
    boom = RuntimeError("kernel launch failed")

    def fail(*args, **kwargs):
        raise boom

    srv.model = dataclasses.replace(srv.model, decode_step_paged=fail)
    with pytest.raises(RuntimeError) as e:
        srv.step()
    assert e.value is boom
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        srv.step()


# ---------------------------------------------------------------------------
# ServingConfig: every JAX field has a place
# ---------------------------------------------------------------------------

# a value away from each deferred field's default
_AWAY = {"backend_bench_iters": 3}


def test_every_jax_serving_field_is_served_or_refused(ref):
    jax_fields = {f.name: f.default
                  for f in dataclasses.fields(jax_serving.ServingConfig)}
    served = {f.name for f in dataclasses.fields(port_serving.ServingConfig)}
    deferred = set(port_serving._DEFERRED)
    assert not served & deferred
    assert set(jax_fields) == served | deferred
    assert set(_AWAY) == deferred
    # speculative decoding and multi-LoRA are served, with JAX's defaults
    port_defaults = {f.name: f.default
                     for f in dataclasses.fields(port_serving.ServingConfig)}
    for name in ("spec_tokens", "spec_ngram", "spec_proposer",
                 "adapter_slots", "lora_rank", "lora_targets",
                 "round_retries", "request_trace", "trace_replica",
                 "trace_events", "role"):
        assert name in served and port_defaults[name] == jax_fields[name]
    for name in deferred:
        # the JAX default is accepted, anything else names its item
        assert port_serving.serving_config({name: jax_fields[name]}) \
            == port_serving.ServingConfig()
        why = ("one decode backend" if name == "backend_bench_iters"
               else "ROADMAP A")
        with pytest.raises(NotImplementedError, match=why):
            port_serving.serving_config({name: _AWAY[name]})
    with pytest.raises(ValueError, match="prefill | decode | both"):
        port_serving.ServingConfig(role="replica")
    with pytest.raises(ValueError, match="paged decode kernel"):
        port_serving.serving_config({"decode_backend": "xla"})
    for backend in ("auto", "pallas"):
        port_serving.serving_config({"decode_backend": backend})
    with pytest.raises(ValueError, match="prefill_token_budget"):
        _port_srv(ref, prefill_token_budget=0)

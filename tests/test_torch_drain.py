"""The port's drain, resume, migration and KV handoff at f32: a drain and
resume byte-identical to the uninterrupted run; across packages, a JAX
drain directory resumed by the port and a JAX f32 ``export_kv`` payload
imported by the port, each giving JAX's own streams; the refusals of
``tests/unit/test_serving.py::TestDrainResume`` (a torn drain skipped, a
smaller engine refused, capacity compared in tokens, the per-request
check, an unregistered adapter); the handoff cases of
``tests/unit/test_disagg.py::TestKvHandoff`` (f32, an int8 pool, a
mid-chunk handoff, onto a live prefix cache, geometry mismatch, a torn
payload, rows outside the protocol); and ``attach_preemption``. Here
the sources are colocated engines
stepped until every request has its first token (the prefill-role
handoff through the router is held in ``tests/test_torch_fleet.py``)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.inference import kv_cache as pkv
from deepspeed_tpu_torch.inference import lora as plora
from deepspeed_tpu_torch.inference import schemas
from deepspeed_tpu_torch.inference.scheduler import AdmissionRejected
from deepspeed_tpu_torch.inference.serving import (ResumeIncompatible,
                                                   kv_payload_crc,
                                                   load_drain_state)
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.robustness import events as rb_events
from deepspeed_tpu_torch.robustness import integrity
from deepspeed_tpu_torch.robustness.preemption import (Preempted,
                                                       PreemptionHandler)

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

# tests/unit/test_disagg.py's _cfg and _serving (no role), at f32
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=128, position_type="rotary",
           activation="silu_glu", norm_type="rmsnorm", tie_embeddings=False)
SERVING = dict(max_seqs=3, block_size=16, max_model_len=128,
               decode_quantum=2, prompt_bucket=16, num_blocks=24)


@pytest.fixture(scope="module")
def params():
    jm = jt.make_model(jt.TransformerConfig(**CFG, dtype=jnp.float32,
                                            attention_impl="xla"))
    return jax.tree.map(np.asarray,
                        jax.device_get(jm.init(jax.random.PRNGKey(0))))


def _jax_srv(params, **serving):
    jm = jt.make_model(jt.TransformerConfig(**CFG, dtype=jnp.float32,
                                            attention_impl="xla"))
    return deepspeed_tpu.init_serving(
        jm, config={"kv_cache_bits": 0}, serving={**SERVING, **serving},
        dtype=jnp.float32, params=params)


def _port_srv(params, config=None, max_seq_len=128, **serving):
    pm = pt.make_model(pt.TransformerConfig(**dict(
        CFG, max_seq_len=max_seq_len), dtype=torch.float32))
    return deepspeed_tpu_torch.init_serving(
        pm, config={"kv_cache_bits": 0, **(config or {})},
        serving={**SERVING, **serving}, params=params,
        dtype=torch.float32, device="cpu")


def _reqs(seed=0, n=3, lens=(7, 21, 12), news=(8, 6, 9)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, size=(lens[i % len(lens)],)
                          ).astype(np.int32), news[i % len(news)])
            for i in range(n)]


def _prefill_all(srv, reqs):
    """Admit ``reqs`` and step until each has its first token (the
    handoff-ready state)."""
    rids = [srv.add_request(p.copy(), k) for p, k in reqs]
    for _ in range(200):
        live = {r.rid: r for r in srv.scheduler.running}
        if all(rid in live and live[rid].prefill_done
               and live[rid].generated for rid in rids):
            return rids
        srv.step()
    raise AssertionError("prefill never completed on the source engine")


def _run_to_done(srv, rids=None, budget=400):
    outs = {}
    for _ in range(budget):
        if srv.scheduler.done:
            break
        for r in srv.step():
            outs[r.rid] = r.output
    if rids is not None:
        assert set(outs) >= set(rids), set(rids) - set(outs)
    return outs


def _handoff(src, dst, rids, payloads=None):
    payloads = src.export_kv(rids) if payloads is None else payloads
    recs = src.release_requests(rids)
    dst.accept_migration(recs, source="src", kv=payloads)
    return _run_to_done(dst, rids), payloads, recs


@pytest.fixture(scope="module")
def base(params):
    """The port's colocated streams of the default load (token-identical
    to JAX's colocated engine: ``tests/test_torch_serving.py``)."""
    return _port_srv(params).run([(p.copy(), k) for p, k in _reqs()])


# ---------------------------------------------------------------------------
# drain and resume
# ---------------------------------------------------------------------------

def _drained_then_resumed(first, second, reqs, path):
    for p, k in reqs:
        first.add_request(p.copy(), k)
    first.step()                             # partial progress
    tag_dir = first.drain(str(path))
    rids = second.resume(str(path))
    assert rids
    outs = _run_to_done(second)
    for r in first._finished:
        outs.setdefault(r.rid, r.output)
    return outs, tag_dir


def test_drain_resume_byte_identical(params, tmp_path):
    reqs = [(p, k) for p, k in _reqs(seed=4, lens=(7, 21, 12),
                                     news=(12, 8, 10))]
    want = _port_srv(params).run([(p.copy(), k) for p, k in reqs])
    rb_events.clear()
    srv = _port_srv(params)
    outs, tag_dir = _drained_then_resumed(srv, _port_srv(params), reqs,
                                          tmp_path)
    ok, reason = integrity.validate_tag(tag_dir)
    assert ok, reason
    with pytest.raises(AdmissionRejected, match="draining"):
        srv.add_request(np.arange(3, dtype=np.int32), 4)
    assert srv.stats()["shed"] == 1.0
    assert set(outs) == set(want)
    for rid in want:
        np.testing.assert_array_equal(outs[rid], want[rid])
    state = load_drain_state(str(tmp_path))
    assert state["version"] == schemas.DRAIN_STATE_VERSION == 3
    assert state["engine"]["tp"] == 1 and state["engine"]["ep"] == 1
    assert state["rng_counter"] > 0
    assert rb_events.history("serving_drained")
    assert rb_events.history("serving_resumed")


def test_jax_drain_resumed_by_port(params, tmp_path):
    """A drain directory the JAX engine wrote, resumed by the port: the
    merged streams equal JAX's uninterrupted run."""
    reqs = _reqs(seed=9, lens=(6, 18, 11), news=(10, 8, 12))
    want = _jax_srv(params).run([(p.copy(), k) for p, k in reqs])
    outs, _ = _drained_then_resumed(_jax_srv(params), _port_srv(params),
                                    reqs, tmp_path)
    assert set(outs) == set(want)
    for rid in want:
        np.testing.assert_array_equal(outs[rid], want[rid])


def test_resume_refuses_torn_drain(params, tmp_path):
    srv = _port_srv(params)
    srv.add_request(np.arange(5, dtype=np.int32), 8)
    tag_dir = srv.drain(str(tmp_path))
    os.remove(os.path.join(tag_dir, "COMMITTED"))
    with pytest.raises(FileNotFoundError, match="integrity-valid"):
        _port_srv(params).resume(str(tmp_path))
    with pytest.raises(ValueError, match="failed integrity"):
        _port_srv(params).resume(str(tmp_path), tag="serving_drain")


def test_resume_refuses_smaller_engine(params, tmp_path):
    srv = _port_srv(params)                       # max_model_len 128
    srv.add_request(np.arange(60, dtype=np.int32), 60)
    srv.drain(str(tmp_path))
    small = _port_srv(params, max_model_len=64)
    with pytest.raises(ResumeIncompatible, match="max_model_len"):
        small.resume(str(tmp_path))
    with pytest.raises(ValueError, match="table width"):
        small.resume(str(tmp_path))
    assert small.scheduler.num_waiting == 0


def test_resume_compares_tokens_not_widths(params, tmp_path):
    """A larger engine with bigger blocks (a narrower table) resumes."""
    srv = _port_srv(params)                       # 128 tokens, width 8
    srv.add_request(np.arange(20, dtype=np.int32), 8)
    srv.drain(str(tmp_path))
    big = _port_srv(params, max_seq_len=256, max_model_len=256,
                    block_size=64, prompt_bucket=64, num_blocks=None)
    assert big.MB == 4 and big.resume(str(tmp_path)) == [0]


def test_accept_migration_per_request_check(params, tmp_path):
    srv = _port_srv(params)
    srv.add_request(np.arange(8, dtype=np.int32), 8)       # fits 64
    srv.add_request(np.arange(50, dtype=np.int32), 40)     # needs 90
    srv.drain(str(tmp_path), source="r-big")
    state = load_drain_state(str(tmp_path))
    assert state["source"] == "r-big"
    assert state["engine"]["max_model_len"] == 128
    small = _port_srv(params, max_model_len=64)
    fits = [r for r in state["requests"] if r["rid"] == 0]
    too_big = [r for r in state["requests"] if r["rid"] == 1]
    assert small.accept_migration(fits, source="r-big") == [0]
    with pytest.raises(ResumeIncompatible, match="max_model_len"):
        small.accept_migration(fits + too_big, source="r-big")
    assert small.scheduler.num_waiting == 1        # all or nothing
    with pytest.raises(ResumeIncompatible, match="tp=2"):
        small.accept_migration(fits, geometry=dict(state["engine"], tp=2))


def test_unregistered_adapter_is_refused(params, tmp_path):
    adapter = plora.make_random_adapter(
        pt.TransformerConfig(**CFG), 4, seed=1, scale=0.2)
    lora = dict(adapter_slots=2, lora_rank=4)
    srv = _port_srv(params, **lora)
    srv.register_adapter(1, adapter)
    srv.add_request(np.arange(10, dtype=np.int32), 6, adapter_id=1)
    srv.drain(str(tmp_path), source="r0")
    recs = load_drain_state(str(tmp_path))["requests"]
    assert recs[0]["adapter_id"] == 1
    with pytest.raises(ResumeIncompatible, match="no registration"):
        _port_srv(params, **lora).accept_migration(recs, source="r0")
    with pytest.raises(ResumeIncompatible, match="disabled"):
        _port_srv(params).accept_migration(recs, source="r0")
    ok = _port_srv(params, **lora)
    ok.register_adapter(1, adapter)
    assert ok.accept_migration(recs, source="r0") == [0]


def test_attach_preemption_drains_and_raises(params, tmp_path):
    """A latched SIGTERM drains at the next step() boundary and raises
    ``Preempted`` with a valid tag; a fresh engine resumes it."""
    reqs = _reqs(seed=5)
    want = _port_srv(params).run([(p.copy(), k) for p, k in reqs])
    srv = _port_srv(params)
    handler = PreemptionHandler()
    srv.attach_preemption(handler, str(tmp_path))
    for p, k in reqs:
        srv.add_request(p.copy(), k)
    srv.step()
    handler._on_signal(15, None)                   # the latch, by hand
    with pytest.raises(Preempted) as e:
        srv.step()
    ok, reason = integrity.validate_tag(e.value.ckpt_path)
    assert ok, reason
    handler.reset()
    fresh = _port_srv(params)
    fresh.resume(str(tmp_path))
    outs = _run_to_done(fresh)
    for r in srv._finished:
        outs.setdefault(r.rid, r.output)
    for rid in want:
        np.testing.assert_array_equal(outs[rid], want[rid])


# ---------------------------------------------------------------------------
# the KV handoff
# ---------------------------------------------------------------------------

def test_handoff_token_identical_and_accounted(params, base):
    src, dst = _port_srv(params), _port_srv(params)
    reqs = _reqs()
    rids = _prefill_all(src, reqs)
    payloads = src.export_kv(rids)
    assert sorted(payloads) == sorted(rids)
    pl = payloads[rids[0]]
    assert pl["schema"] == schemas.KV_PAYLOAD_SCHEMA
    assert pl["geometry"] == {"num_layers": 2, "kv_heads": 2,
                              "head_dim": 16, "block_size": 16,
                              "kv_bits": 0, "dtype": "float32"}
    assert pl["crc"] == kv_payload_crc(pl["data"])
    nbytes = sum(pkv.kv_payload_nbytes(p["data"]) for p in payloads.values())
    st = src.stats()
    assert st["kv_staging_bytes"] == nbytes
    assert st["handoffs"] == 3 and st["handoff_bytes"] == nbytes
    recs = src.release_requests(rids)
    assert src.scheduler.done and not src._requests
    assert src.allocator.used_blocks == 0
    assert src.stats()["kv_staging_bytes"] == 0
    dst.accept_migration(recs, source="src", kv=payloads)
    assert dst.stats()["kv_staging_bytes"] == nbytes
    outs = _run_to_done(dst, rids)
    for rid in base:
        np.testing.assert_array_equal(outs[rid], base[rid])
    st = dst.stats()
    assert st["kv_staging_bytes"] == 0 and st["handoff_fallbacks"] == 0
    assert st["handoffs"] == 3 and st["handoff_bytes"] == nbytes
    assert st["prefills"] == 0                 # only tail spans ran
    dst.reset_stats()
    assert dst.stats()["handoffs"] == 0
    assert src.export_kv([777]) == {}          # unknown rid: nothing


def test_jax_payload_imported_by_port(params):
    """An f32 payload from JAX's ``export_kv`` (a prefill-role engine)
    imports into the port unchanged and continues as JAX's colocated
    engine does."""
    reqs = _reqs(seed=2)
    want = _jax_srv(params).run([(p.copy(), k) for p, k in reqs])
    src = _jax_srv(params, role="prefill")
    rids = _prefill_all(src, reqs)
    payloads = src.export_kv(rids)
    recs = src.release_requests(rids)
    dst = _port_srv(params)
    assert all(payloads[r]["geometry"] == dst._kv_geometry() for r in rids)
    dst.accept_migration(recs, source="jax", kv=payloads)
    outs = _run_to_done(dst, rids)
    for rid in want:
        np.testing.assert_array_equal(outs[rid], want[rid])
    assert dst.stats()["handoff_fallbacks"] == 0


def test_int8_pool_handoff_token_identical(params):
    q = {"kv_cache_bits": 8}
    reqs = _reqs(n=2)
    want = _port_srv(params, config=q).run([(p.copy(), k) for p, k in reqs])
    src, dst = _port_srv(params, config=q), _port_srv(params, config=q)
    rids = _prefill_all(src, reqs)
    payloads = src.export_kv(rids)
    pl = payloads[rids[0]]
    assert pl["geometry"]["kv_bits"] == 8
    assert pl["geometry"]["dtype"] == "int8"
    assert set(pl["data"]) == {"k", "v", "k_scale", "v_scale"}
    outs, _, _ = _handoff(src, dst, rids, payloads)
    for rid in want:
        np.testing.assert_array_equal(outs[rid], want[rid])
    f32 = _port_srv(params)
    rids2 = _prefill_all(src, reqs)
    payloads2 = src.export_kv(rids2)
    recs2 = src.release_requests(rids2)
    with pytest.raises(ResumeIncompatible, match="kv_bits"):
        f32.accept_migration(recs2, source="src", kv=payloads2)
    assert not f32._requests


def test_handoff_mid_chunked_prefill(params):
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 128, size=(60,)).astype(np.int32)
    want = _port_srv(params).run([(prompt.copy(), 6)])
    src = _port_srv(params, prefill_token_budget=16)
    rid = src.add_request(prompt, max_new_tokens=6)
    req = src._requests[rid]
    src.step()                                # the first 16-token chunk
    assert not req.prefill_done and 0 < req.cached_rows < 60
    payloads = src.export_kv([rid])
    assert payloads[rid]["rows"] == req.cached_rows
    outs, _, _ = _handoff(src, _port_srv(params), [rid], payloads)
    np.testing.assert_array_equal(outs[rid], want[rid])


def test_handoff_onto_live_prefix_cache(params):
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 128, size=(33,)).astype(np.int32)
    want = _port_srv(params).run([(prompt.copy(), 6)])[0]
    dst = _port_srv(params, enable_prefix_cache=True, num_blocks=32)
    warm = dst.run([(prompt.copy(), 4)])
    np.testing.assert_array_equal(want[:len(prompt) + 4], warm[0])
    src = _port_srv(params)
    rid = _prefill_all(src, [(prompt, 6)])[0]
    outs, _, _ = _handoff(src, dst, [rid])
    np.testing.assert_array_equal(outs[rid], want)
    again = dst.run([(prompt.copy(), 6)])
    np.testing.assert_array_equal(list(again.values())[0], want)
    assert dst.allocator.used_blocks == dst._prefix_cache.held_blocks


def test_geometry_mismatch_refuses_then_fallback(params, base):
    src = _port_srv(params)
    dst = _port_srv(params, block_size=8, num_blocks=48)
    rids = _prefill_all(src, _reqs())
    payloads = src.export_kv(rids)
    recs = src.release_requests(rids)
    with pytest.raises(ResumeIncompatible, match="block_size"):
        dst.accept_migration(recs, source="src", kv=payloads)
    assert not dst._requests and dst.stats()["handoff_fallbacks"] >= 1
    dst.accept_migration(recs, source="src")      # the re-prefill path
    outs = _run_to_done(dst, rids)
    for rid in base:
        np.testing.assert_array_equal(outs[rid], base[rid])


def test_torn_payload_refused_then_fallback(params, base):
    src, dst = _port_srv(params), _port_srv(params)
    rids = _prefill_all(src, _reqs())
    payloads = src.export_kv(rids)
    flat = payloads[rids[0]]["data"]["k"].reshape(-1).view(np.uint8)
    flat[0] ^= 0x01                               # one flipped bit
    recs = src.release_requests(rids)
    with pytest.raises(ResumeIncompatible, match="checksum"):
        dst.accept_migration(recs, source="src", kv=payloads)
    assert not dst._requests
    dst.accept_migration(recs, source="src")
    outs = _run_to_done(dst, rids)
    for rid in base:
        np.testing.assert_array_equal(outs[rid], base[rid])


def test_rows_outside_the_protocol_refused(params):
    src, dst = _port_srv(params), _port_srv(params)
    (rid,) = _prefill_all(src, _reqs(n=1))
    payloads = src.export_kv([rid])
    recs = src.release_requests([rid])
    ctx = len(recs[0]["prompt"]) + len(recs[0]["generated"])
    for rows in (ctx, 0):
        bad = dict(payloads[rid], rows=rows)
        with pytest.raises(ResumeIncompatible, match="rows"):
            dst.accept_migration(recs, source="src", kv={rid: bad})
    assert not dst._requests
    # import_kv onto a waiting request, the same checks
    dst.accept_migration(recs, source="src")
    dst.import_kv(rid, payloads[rid])
    assert dst._requests[rid].kv_rows == payloads[rid]["rows"]
    with pytest.raises(ResumeIncompatible, match="not waiting"):
        dst.import_kv(999, payloads[rid])


def test_drain_state_is_jax_schema(params, tmp_path):
    """The port's state.json carries exactly the JAX writer's keys."""
    srv = _port_srv(params)
    srv.add_request(np.arange(9, dtype=np.int32), 4)
    srv.step()
    tag_dir = srv.drain(str(tmp_path))
    with open(os.path.join(tag_dir, "state.json")) as f:
        mine = json.load(f)
    jsrv = _jax_srv(params)
    jsrv.add_request(np.arange(9, dtype=np.int32), 4)
    jsrv.step()
    jdir = jsrv.drain(str(tmp_path / "jax"))
    with open(os.path.join(jdir, "state.json")) as f:
        theirs = json.load(f)
    assert set(mine) == set(theirs)
    assert set(mine["engine"]) == set(theirs["engine"])
    assert set(mine["requests"][0]) == set(theirs["requests"][0])
    for key in ("prompt", "generated", "cached_rows", "block_ids", "state"):
        assert mine["requests"][0][key] == theirs["requests"][0][key], key


def test_deferred_features_still_raise(params):
    """Tensor / expert parallel serving is served since A6h, on the ranks
    of a process group (none here: refused before anything is built; a
    dense model refuses an expert degree); request tracing, round
    recovery and fleet roles are served since A7."""
    pm = pt.make_model(pt.TransformerConfig(**CFG, dtype=torch.float32))
    for config, why in (({"tensor_parallel": 2}, "process group"),
                        ({"expert_parallel": 2}, "MoE")):
        with pytest.raises(ValueError, match=why):
            deepspeed_tpu_torch.init_serving(
                pm, config=config, serving=SERVING, dtype=torch.float32,
                device="cpu")
    for field, value in (("request_trace", True), ("round_retries", 2),
                         ("role", "decode")):
        assert getattr(_port_srv(params, **{field: value}).config,
                       field) == value


def test_bf16_payload_in_either_layout_lands_bit_for_bit(params):
    """A bf16 pool ships its leaves as raw int16 views; the same bytes as
    an ml_dtypes bfloat16 array (how JAX's export ships a bf16 pool) have
    the same crc and land in the receiver's pool unchanged."""
    import ml_dtypes
    pm = pt.make_model(pt.TransformerConfig(**CFG, dtype=torch.bfloat16))

    def srv():
        return deepspeed_tpu_torch.init_serving(
            pm, config={"kv_cache_bits": 0}, serving=SERVING, params=params,
            dtype=torch.bfloat16, device="cpu")
    for layout in ("int16", "ml_dtypes"):
        src, dst = srv(), srv()
        (rid,) = _prefill_all(src, _reqs(n=1))
        pl = src.export_kv([rid])[rid]
        assert pl["geometry"]["dtype"] == "bfloat16"
        assert pl["data"]["k"].dtype == np.int16
        n, rows = pl["blocks"], pl["rows"]
        want = {k: src.pools[k][:, src._requests[rid].block_ids[:n]].clone()
                for k in ("k", "v")}
        if layout == "ml_dtypes":
            pl = dict(pl, data={k: a.view(ml_dtypes.bfloat16)
                                for k, a in pl["data"].items()})
            assert kv_payload_crc(pl["data"]) == pl["crc"]
        recs = src.release_requests([rid])
        dst.accept_migration(recs, kv={rid: pl})
        dst.step()                      # the scatter, then the tail span
        blocks = dst._requests[rid].block_ids[:n]
        for k in ("k", "v"):
            got = dst.pools[k][:, blocks]
            L, _, nkv, bs, hd = got.shape

            def rows_of(t):
                return t.transpose(1, 2).reshape(L, nkv, n * bs, hd)[
                    :, :, :rows].view(torch.int16)
            assert torch.equal(rows_of(got), rows_of(want[k]))

"""The fleet's telemetry held against JAX's: ``Histogram``,
``render_prometheus`` and ``parse_exposition`` give JAX's output for the
same observations; the ``RequestTracer``'s span sequence and the merged
Chrome trace equal JAX's with times stripped, driven by hand and by a
traced engine of each package on the same load; tracing leaves streams
bit-identical with no device sync; ``obs_meta()`` and
``phase_decomposition()`` carry JAX's keys; a drain (v3) carries the
trace context in both directions between the packages, and a v2 record
still loads; a traced failover stitches one trace across two replicas;
the router's exposition parses back to its fleet rollup."""

import collections
import json
import math
import os

import numpy as np
import pytest

from deepspeed_tpu.telemetry import exposition as jexp
from deepspeed_tpu.telemetry import request_trace as jrt
from deepspeed_tpu_torch.telemetry import exposition as pexp
from deepspeed_tpu_torch.telemetry import request_trace as prt

from tests import _torch_fleet_common as C
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

JAX, PORT = C.package("jax"), C.package("port")
_TIMES = ("ts", "dur")


@pytest.fixture(autouse=True)
def _clean():
    for P in (JAX, PORT):
        P.faults.clear()
        P.events.clear()
    yield
    for P in (JAX, PORT):
        P.faults.clear()
        P.events.clear()


@pytest.fixture(scope="module")
def params():
    return C.make_params()


def _timeless(events):
    return [{k: v for k, v in e.items() if k not in _TIMES}
            for e in events]


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------

def _metrics(E):
    h = E.Histogram(E.DEFAULT_EDGES_MS)
    h.observe_many([0.5, 3.0, 3.5, 900.0, 1e6, float("nan")])
    other = E.Histogram(E.DEFAULT_EDGES_MS)
    other.observe_many([7.0, 70.0])
    h.merge(other)
    frac = E.Histogram(E.FRACTION_EDGES)
    frac.observe_many([0.05, 0.5, 0.95])
    return h, {"ttft_ms": h, "pool": frac.to_dict(), "live": 2,
               "ok": True, "rate": 0.125, "nan": float("nan"),
               "name": "skipped", "bad": {"edges": [1]}}


def test_histogram_and_exposition_equal_jax():
    """The same observations give the same buckets, merge, quantiles,
    wire dict and Prometheus text (byte for byte), and the parse of that
    text gives the same gauges and histograms."""
    (jh, jm), (ph, pm) = _metrics(jexp), _metrics(pexp)
    assert ph.to_dict() == jh.to_dict()
    assert [ph.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)] \
        == [jh.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)]
    assert pexp.DEFAULT_EDGES_MS == jexp.DEFAULT_EDGES_MS
    assert pexp.DEPTH_EDGES == jexp.DEPTH_EDGES
    assert pexp.FRACTION_EDGES == jexp.FRACTION_EDGES
    for prefix in ("dstpu", ""):
        text = pexp.render_prometheus(pm, prefix=prefix)
        assert text == jexp.render_prometheus(jm, prefix=prefix)
        got, want = (pexp.parse_exposition(text),
                     jexp.parse_exposition(text))
        assert set(got) == set(want)
        for k in want:
            if isinstance(want[k], float):
                assert got[k] == want[k]
            else:
                assert got[k].to_dict() == want[k].to_dict()
    assert pexp.Histogram.from_dict({"edges": [1], "counts": [1]}) is None
    with pytest.raises(ValueError):
        pexp.Histogram([2, 1])
    with pytest.raises(ValueError):
        ph.merge(pexp.Histogram([1, 2]))


# ---------------------------------------------------------------------------
# the request tracer
# ---------------------------------------------------------------------------

def _tracer_script(R, tmp):
    """One fixed sequence of tracer calls (begin, spans at explicit times,
    instants, a drain context adopted on a second replica, a bounded
    ring, a self-reporting hook); returns what each piece exported."""
    syncs = []
    src = R.RequestTracer(replica="r0")
    ids = [src.begin(7), src.begin(7), src.begin(8)]
    src.add_span(7, "queue_wait", 10.0, 10.25, preemptions=0)
    with src.span(7, "prefill", tokens=4, reprefill=False):
        pass
    src.instant(7, "drained", tag="t")
    src.end(8)
    ids.append(src.begin(8))
    dst = R.RequestTracer(replica="r1", on_span=lambda ev: syncs.append(1))
    ids.append(dst.adopt(7, src.context(7)))
    ids.append(dst.adopt(9, None))
    dst.instant(7, "migrated_in", source="r0", kv=True)
    with dst.span(7, "decode_quantum", steps=2):
        pass
    ring = R.RequestTracer(replica="rr", max_events=64)
    ring.begin(1)
    for i in range(100):
        ring.instant(1, f"e{i}")
    merged = R.merge_chrome_trace([src.export(), dst.export()],
                                  path=os.path.join(tmp, "trace.json"))
    on_disk = json.load(open(os.path.join(tmp, "trace.json")))
    return {"ids": ids, "src": _timeless(src.events),
            "dst": _timeless(dst.events), "syncs": len(syncs),
            "ring": (len(ring.events), ring.events[0]["name"]),
            "merged": _timeless(merged["traceEvents"]),
            "disk": _timeless(on_disk["traceEvents"]),
            "unit": merged["displayTimeUnit"]}


def test_request_tracer_sequence_and_merged_trace_equal_jax(tmp_path):
    got = {}
    for name, R in (("jax", jrt), ("port", prt)):
        os.makedirs(tmp_path / name)
        got[name] = _tracer_script(R, str(tmp_path / name))
    assert got["port"] == got["jax"]
    assert got["port"]["ids"] == ["r0/7.0", "r0/7.0", "r0/8.1", "r0/8.2",
                                  "r0/7.0", "r1/9.0"]
    assert got["port"]["syncs"] == 2        # adopted history is not new
    assert PORT.events.history("trace_export")


def test_traced_engine_spans_equal_jax(params):
    """A traced engine of each package on the same load (with a
    preemption: 2 slots, a tight pool): the span sequence — names, the
    requests they belong to, their args — is JAX's, times stripped."""
    load = C.reqs(n=4, lens=(30, 28, 25, 20), news=(16, 16, 16, 16))
    got = {}
    for P in (JAX, PORT):
        srv = P.srv(params, max_seqs=2, num_blocks=6, max_model_len=64,
                    request_trace=True, trace_replica="rX")
        outs = C.streams(srv.run([(p.copy(), k) for p, k in load]))
        got[P.name] = {"streams": outs,
                       "spans": [(e["name"], e["rid"], e["trace"],
                                  e.get("args")) for e in srv.tracer.events],
                       "preemptions": srv.stats()["preemptions"]}
    assert got["port"]["preemptions"] > 0
    assert got["port"] == got["jax"]


def test_tracing_on_off_bit_identical_without_syncs(params):
    """Tracing on or off, from the start or armed on a warm engine: the
    same streams, zero device syncs, every lifecycle span present, one
    trace id a request; ``reset_stats`` clears the window's rollups."""
    load = C.reqs(n=3)
    plain = C.streams(PORT.srv(params).run([(p.copy(), k)
                                            for p, k in load]))
    traced = PORT.srv(params, request_trace=True, trace_replica="rA")
    assert C.streams(traced.run([(p.copy(), k) for p, k in load])) == plain
    tr = traced.tracer
    assert tr.device_syncs == 0
    assert {"admitted", "queue_wait", "prefill", "decode_quantum",
            "finish"} <= {e["name"] for e in tr.events}
    assert all(e["replica"] == "rA" for e in tr.events)
    per_rid = collections.defaultdict(set)
    for e in tr.events:
        per_rid[e["rid"]].add(e["trace"])
    assert len(per_rid) == 3 and all(len(v) == 1 for v in per_rid.values())
    d = traced.phase_decomposition()
    assert d["serve_rounds"] > 0 and d["serve_tokens"] > 0
    assert d["trace_armed"] == 1.0 and d["trace_device_syncs"] == 0.0
    traced.reset_stats()
    d = traced.phase_decomposition()
    assert d["serve_rounds"] == 0.0 and d["serve_tokens"] == 0.0
    meta = traced.obs_meta()
    assert meta["completed"] == 0 and meta["generated_tokens"] == 0
    warm = PORT.srv(params)
    warm.run([(p.copy(), k) for p, k in load])
    warm.enable_request_trace(replica="rB")
    assert C.streams(warm.run([(p.copy(), k) for p, k in load])) \
        == {k + 3: v for k, v in plain.items()}
    assert warm.tracer.device_syncs == 0 and warm.tracer.events
    warm.disable_request_trace()
    assert warm.tracer is None and warm.export_trace() is None


def test_obs_meta_and_phase_keys_equal_jax(params):
    """``obs_meta()`` and ``phase_decomposition()`` carry JAX's keys; the
    counts (not the times) in them agree for the same load."""
    load = C.reqs(n=3)
    got = {}
    for P in (JAX, PORT):
        srv = P.srv(params)
        srv.run([(p.copy(), k) for p, k in load])
        meta, phases = srv.obs_meta(), srv.phase_decomposition()
        got[P.name] = {
            "meta_keys": sorted(meta), "phase_keys": sorted(phases),
            "counts": {k: meta[k] for k in ("completed", "cancelled",
                                             "generated_tokens",
                                             "pool_occupancy")},
            "hist_counts": [meta[k]["count"] for k in ("ttft_ms_hist",
                                                      "itl_ms_hist")],
            "rounds": (phases["serve_rounds"], phases["serve_tokens"])}
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# drains carry the trace context; a traced failover stitches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("port", "jax"),
                                           ("jax", "port")])
def test_drain_v3_carries_trace_and_v2_loads(params, tmp_path, writer,
                                             reader):
    """A traced engine's drain (v3) records each request's trace context,
    the drain marker last; the reader adopts it under the same id (one
    trace across the two replicas), and a record without the field (v2)
    begins a fresh trace. Either package writes, either reads."""
    W, R = {"jax": JAX, "port": PORT}[writer], \
        {"jax": JAX, "port": PORT}[reader]
    src = W.srv(params, request_trace=True, trace_replica="r0")
    for p, k in C.reqs(seed=1, n=2):
        src.add_request(p.copy(), k)
    src.step()
    tag_dir = src.drain(str(tmp_path), tag="t0", source="r0")
    state = json.load(open(os.path.join(tag_dir, "state.json")))
    assert state["version"] == 3 and len(state["requests"]) == 2
    for rec in state["requests"]:
        assert rec["trace"]["id"].startswith("r0/")
        names = [e["name"] for e in rec["trace"]["spans"]]
        assert names[0] == "admitted" and names[-1] == "drained"
        assert "prefill" in names
    dst = R.srv(params, request_trace=True, trace_replica="r1")
    recs = state["requests"]
    recs[1] = {k: v for k, v in recs[1].items() if k != "trace"}   # v2
    rids = dst.accept_migration(recs, rng_counter=state["rng_counter"],
                                source="r0", geometry=state["engine"])
    assert dst.tracer.trace_id(rids[0]) == state["requests"][0]["trace"][
        "id"]
    assert dst.tracer.trace_id(rids[1]).startswith("r1/")
    dst.run([])
    merged = (jrt if reader == "jax" else prt).merge_chrome_trace(
        [dst.export_trace()])
    rows = collections.defaultdict(set)
    for e in merged["traceEvents"]:
        if e["ph"] != "M":
            rows[e["args"]["trace"]].add(e["pid"])
    assert len(rows[state["requests"][0]["trace"]["id"]]) == 2
    # a v2 drain directory (no trace anywhere) still resumes
    v2 = dict(state, version=2,
              requests=[{k: v for k, v in r.items() if k != "trace"}
                        for r in state["requests"]])
    from deepspeed_tpu_torch.robustness import integrity
    d2 = os.path.join(str(tmp_path), "v2", "t2")
    os.makedirs(d2)
    integrity.atomic_write(os.path.join(d2, "state.json"), json.dumps(v2),
                           what="v2 drain")
    integrity.write_manifest(d2)
    integrity.write_commit_marker(d2)
    fresh = R.srv(params, request_trace=True)
    assert len(fresh.resume(os.path.dirname(d2))) == 2


def test_traced_failover_stitches_and_exposition_parses(params, tmp_path):
    """Two traced replicas behind the port's router, r0 killed mid-load:
    streams equal the untraced single replica's, the merged Chrome trace
    (written and parsed back) has a trace id in both replicas' process
    rows, and the router's Prometheus text parses back to its rollup."""
    load = C.reqs(n=6, lens=(7, 21, 12, 30, 9, 17), news=(8, 6, 9, 5, 7, 10))
    base = C.streams(PORT.srv(params, max_seqs=6, num_blocks=48).run(
        [(p.copy(), k) for p, k in load]))
    t = [0.0]
    router = PORT.router.ServingRouter(PORT.router.RouterConfig(
        store_dir=str(tmp_path / "store"),
        drain_dir=str(tmp_path / "drains"), dead_after_s=2.0,
        clock=lambda: t[0]))
    e0 = PORT.srv(params, request_trace=True)
    e1 = PORT.srv(params, request_trace=True)
    router.register("r0", e0)
    router.register("r1", e1)
    assert (e0.tracer.replica, e1.tracer.replica) == ("r0", "r1")
    PORT.faults.install(PORT.faults.FaultInjector(PORT.faults.FaultSchedule(
        [{"kind": "replica_kill", "at": 2, "replica": 0}], seed=0)))
    outs, _ = C.drive(router, load, clock=t)
    assert outs == base
    assert e0.tracer.device_syncs == e1.tracer.device_syncs == 0
    path = str(tmp_path / "fleet.json")
    prt.merge_chrome_trace([e0.export_trace(), e1.export_trace()],
                           path=path)
    on_disk = json.load(open(path))["traceEvents"]
    pids = collections.defaultdict(set)
    for e in on_disk:
        if e["ph"] != "M":
            pids[e["args"]["trace"]].add(e["pid"])
    assert any(len(p) >= 2 for p in pids.values())
    fs = router.fleet_stats()
    parsed = pexp.parse_exposition(router.exposition(prefix="dstpu"))
    assert parsed["dstpu_fleet_completed"] == fs["fleet_completed"] == 6
    assert parsed["dstpu_fleet_live"] == 1.0
    assert parsed["dstpu_fleet_ttft_ms"].counts == fs["fleet_ttft_ms"].counts
    assert parsed["dstpu_failovers"] == 1.0
    assert not any(isinstance(v, float) and math.isnan(v)
                   for v in parsed.values())
    router.reset_stats()
    assert router.fleet_stats()["fleet_completed"] == 0
    assert np.isfinite(router.stats()["rounds"])

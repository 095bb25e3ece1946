"""The fleet's host layer over real serving engines, held against JAX's
router over JAX's engines (the tiny llama of ``tests/unit/test_disagg.py``,
f32, both packages on the same numpy weights, greedy): failover of a
killed replica, the disaggregated prefill → decode handoff with its KV
bytes (and its fallbacks), a JAX replica's drain failing over onto a port
survivor, the ``FleetController``'s burst and lull, and a chaos soak of
every serving, router and handoff kind. Every stream is token-identical
to a fault-free single replica's; the router's events and counters equal
JAX's where both run.

A simulated clock (1 s a router round) drives heartbeat ages, so a
death is detected in rounds, not seconds."""

import os

import pytest

from deepspeed_tpu_torch.inference.router import ReplicaHandle

from tests import _torch_fleet_common as C
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

JAX, PORT = C.package("jax"), C.package("port")
# the router-level events held equal between the packages
ROUTER_EVENTS = ("fault_injected", "replica_degraded", "replica_recovered",
                 "replica_failover", "request_migrated", "request_spilled",
                 "request_handoff", "request_lost", "fleet_scale_up",
                 "fleet_scale_down", "serving_recovered")


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


LOAD = C.reqs(n=6, lens=(7, 21, 12, 30, 9, 17), news=(8, 6, 9, 5, 7, 10))


@pytest.fixture(scope="module")
def base(params):
    """The fault-free single replica's streams (the port's; JAX's equal
    them, tests/test_torch_serving.py)."""
    return C.streams(C.port_srv(params, max_seqs=6, num_blocks=48).run(
        [(p.copy(), k) for p, k in LOAD]))


def _router(P, tmp, t, **kw):
    return P.router.ServingRouter(P.router.RouterConfig(
        store_dir=os.path.join(tmp, "store"),
        drain_dir=os.path.join(tmp, "drains"), dead_after_s=2.5,
        breaker_faults=2, breaker_probe_after=2, clock=lambda: t[0], **kw))


def _events(P):
    return C.strip_times([e for e in P.events.history()
                          if e["type"] in ROUTER_EVENTS])


def _stats(router):
    return {k: v for k, v in router.stats().items()
            if not k.endswith("_ms")}


def test_failover_matches_jax_and_single_replica(params, base, tmp_path):
    """Two ``both`` replicas, ``replica_kill`` of r0 at router round 3:
    its engine drains through the integrity chain, the router detects the
    silent heartbeat, loads the snapshot and migrates every request onto
    r1. Streams equal the single replica's in both packages, and the
    router's events and counters equal JAX's."""
    got = {}
    for P in (JAX, PORT):
        t = [0.0]
        router = _router(P, str(tmp_path / P.name), t)
        router.register("r0", P.srv(params))
        router.register("r1", P.srv(params))
        P.faults.install(P.faults.FaultInjector(P.faults.FaultSchedule(
            [{"kind": "replica_kill", "at": 3, "replica": 0}], seed=0)))
        outs, rounds = C.drive(router, LOAD, clock=t)
        st = _stats(router)
        assert st["failovers"] == 1 and st["lost_requests"] == 0
        assert st["migrated"] >= 1
        got[P.name] = {"streams": outs, "stats": st, "rounds": rounds,
                       "events": _events(P),
                       "generation": router.generation()["hosts"]}
        P.faults.clear()
    assert got["port"]["streams"] == base
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("faults", ["none", "corrupt_then_fail"])
def test_disaggregated_handoff_matches_jax(params, base, tmp_path, faults):
    """A ``prefill`` replica and a ``decode`` replica, ``handoff_kv`` on:
    new requests land on the prefill tier (which never runs a decode
    quantum), each prefill-done request moves with its KV bytes, and the
    streams equal the single replica's and JAX's, with the same handoff
    counters and events. Under ``kv_handoff`` faults — handoff 0's payload
    corrupted in flight (refused by the receiver's crc32), handoff 1's
    lost — both fall back to re-prefill, token-identically."""
    entries = {"none": [],
               "corrupt_then_fail": [
                   {"kind": "kv_handoff", "at": 0, "mode": "corrupt"},
                   {"kind": "kv_handoff", "at": 1}]}[faults]
    got = {}
    for P in (JAX, PORT):
        t = [0.0]
        router = _router(P, str(tmp_path / P.name), t)
        pre = P.srv(params, role="prefill")
        dec = P.srv(params, role="decode", max_seqs=6, num_blocks=48)
        router.register("pre0", pre)
        router.register("dec0", dec)
        P.faults.install(P.faults.FaultInjector(P.faults.FaultSchedule(
            entries, seed=0)))
        outs, rounds = C.drive(router, LOAD, clock=t)
        st = _stats(router)
        fs = router.fleet_stats()
        assert (fs["fleet_prefill_replicas"], fs["fleet_decode_replicas"],
                fs["fleet_both_replicas"]) == (1, 1, 0)
        assert st["handoffs"] == len(LOAD) and st["lost_requests"] == 0
        assert st["handoff_fallbacks"] == len(entries)
        if P is PORT:
            assert pre.stats()["decode_steps"] == 0
            assert pre.stats()["prefills"] == len(LOAD)
            assert dec.stats()["prefills"] == len(entries)
        got[P.name] = {"streams": outs, "stats": st, "rounds": rounds,
                       "events": _events(P),
                       "fired": P.faults.active().fired,
                       "dec": {k: dec.stats()[k] for k in (
                           "handoffs", "handoff_bytes",
                           "handoff_fallbacks", "completed")}}
        P.faults.clear()
    assert got["port"]["streams"] == base
    assert got["port"] == got["jax"]


def test_jax_drain_fails_over_onto_port_survivor(params, base, tmp_path):
    """The port's router over a JAX replica and a port replica: the JAX
    engine is killed (it drains through JAX's integrity chain), and the
    port's router reads that snapshot and migrates every request onto
    the port engine, to the single replica's streams."""
    t = [0.0]
    router = _router(PORT, str(tmp_path), t)
    jx = C.jax_srv(params)
    router.register_handle(ReplicaHandle(
        "jx0", jx, router.config.store_dir, router.config.drain_dir,
        clock=router.config.clock))
    router.register("pt1", PORT.srv(params, max_seqs=6, num_blocks=48))
    PORT.faults.install(PORT.faults.FaultInjector(PORT.faults.FaultSchedule(
        [{"kind": "replica_kill", "at": 2, "replica": 0}], seed=0)))
    outs, _ = C.drive(router, LOAD, clock=t)
    st = _stats(router)
    assert st["failovers"] == 1 and st["lost_requests"] == 0
    migrated = PORT.events.history("request_migrated")
    assert migrated and all(e["src"] == "jx0" and e["dst"] == "pt1"
                            and e["origin"] == "drain" for e in migrated)
    assert outs == base


def test_fleet_controller_burst_and_lull_matches_jax(params, base, tmp_path):
    """One replica and a ``FleetController`` (role both, 1..2 replicas):
    the burst's sustained load spawns a second engine, the lull
    decommissions one (drain, failover, retire), no request is lost, the
    streams equal the single replica's, and the scale events equal
    JAX's."""
    load = LOAD + C.reqs(seed=1, n=4, lens=(11, 5, 26, 14),
                         news=(9, 12, 6, 8))
    want = C.streams(C.port_srv(params, max_seqs=10, num_blocks=80).run(
        [(p.copy(), k) for p, k in load]))
    got = {}
    for P in (JAX, PORT):
        t = [0.0]
        router = _router(P, str(tmp_path / P.name), t)
        router.register("r0", P.srv(params, max_seqs=2, max_queue=2))
        ctl = P.fleet.FleetController(
            router, lambda name, role, P=P: P.srv(params, max_seqs=2,
                                                  max_queue=2),
            P.fleet.FleetConfig(role="both", min_replicas=1,
                                max_replicas=2, scale_up_load=1.0,
                                scale_up_after=2, scale_down_load=0.05,
                                scale_down_after=2, cooldown_ticks=1))
        ticks = []
        outs, rounds = C.drive(router, load, clock=t,
                               tick=lambda: ticks.append(ctl.tick()))
        for _ in range(8):                  # the lull after the burst
            router.step()
            ticks.append(ctl.tick())
            t[0] += 1.0
        st = _stats(router)
        cs = ctl.stats()
        assert st["lost_requests"] == 0
        assert cs["scale_ups"] >= 1 and cs["scale_downs"] >= 1
        assert router.fleet_stats()["fleet_live"] == 1
        got[P.name] = {"streams": outs, "ticks": ticks, "ctl": cs,
                       "stats": st, "events": _events(P)}
    assert got["port"]["streams"] == want
    assert got["port"] == got["jax"]


def test_chaos_soak_token_identical_with_every_recovery_counted(
        params, base, tmp_path):
    """Three port replicas (one prefill, one decode, one both) under every
    serving, router and handoff kind at once: heartbeat loss, a router
    partition, failed and hung decode dispatches, a pool-exhaustion
    storm, a backend fault, a corrupted and a lost KV handoff. Every
    stream equals the fault-free single replica's; the engines'
    ``recoveries`` add up to the injected dispatch and backend faults;
    ``degraded`` stays 0 and no ``backend_degraded`` is emitted."""
    t = [0.0]
    router = _router(PORT, str(tmp_path), t)
    engines = {"pre0": PORT.srv(params, role="prefill",
                                dispatch_timeout_s=0.5),
               "dec0": PORT.srv(params, role="decode", max_seqs=4,
                                num_blocks=32, dispatch_timeout_s=0.5),
               "both0": PORT.srv(params, dispatch_timeout_s=0.5)}
    for name, srv in engines.items():
        router.register(name, srv)
    inj = PORT.faults.FaultInjector(PORT.faults.FaultSchedule([
        {"kind": "heartbeat_loss", "at": 2, "replica": 2, "times": 3},
        {"kind": "router_partition", "at": 4, "replica": 1, "times": 2},
        {"kind": "decode_dispatch", "at": 3},
        {"kind": "decode_dispatch", "at": 9, "mode": "hang", "hang_s": 2.0},
        {"kind": "pool_exhaust", "at": 5, "times": 3, "keep": 0},
        {"kind": "backend_fault", "at": 12},
        {"kind": "kv_handoff", "at": 0, "mode": "corrupt"},
        {"kind": "kv_handoff", "at": 2},
    ], seed=3))
    PORT.faults.install(inj)
    outs, rounds = C.drive(router, LOAD, clock=t)
    fired = [f["kind"] for f in inj.fired]
    assert set(fired) == {"heartbeat_loss", "router_partition",
                          "decode_dispatch", "pool_exhaust",
                          "backend_fault", "kv_handoff"}, fired
    assert outs == base
    st = _stats(router)
    assert st["lost_requests"] == 0 and st["failovers"] == 0
    assert st["handoff_fallbacks"] == 2
    recoveries = sum(e.stats()["recoveries"] for e in engines.values())
    assert recoveries == sum(k in ("decode_dispatch", "backend_fault")
                             for k in fired)
    assert all(e.stats()["degraded"] == 0 for e in engines.values())
    assert not PORT.events.history("backend_degraded")
    reasons = {e["reason"] for e in
               PORT.events.history("replica_degraded")}
    assert reasons == {"heartbeat_loss", "dispatch_faults"}
    for srv in engines.values():
        assert srv.close(timeout=10)

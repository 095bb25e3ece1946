"""The fleet's host layer held against JAX's, pure host: the scenarios of
``tests/unit/test_router.py`` (``TestHeartbeatMeta``,
``TestSpillAdmission``, ``TestCircuitBreaker``, ``TestFailover``) and the
stub-backed ones of ``tests/unit/test_disagg.py`` (role routing,
decommission, the ``FleetController``), each driven once through JAX's
router over JAX's ``_StubReplica`` and once through the port's over its
own stub (``tests/_torch_fleet_stub.py``), on the same simulated clock and
the same ``FaultSchedule`` (each package installs its own injector: the
injector is process-global per package).

Held equal between the packages: the robustness events (kind and fields;
times, durations and the run's temp root stripped), the breaker states
at every round, the placements, ``stats()`` without its timings,
``fleet_stats()``, the generation manifests and each scenario's own
checks. Then the rendezvous stores interoperate both ways: heartbeats and
manifests written by either package, torn ones included, read in the
other.
"""

import json
import os

import numpy as np
import pytest

from tests import _torch_fleet_common as C
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

PACKAGES = {n: C.package(n) for n in ("jax", "port")}
PROMPT = np.arange(4, dtype=np.int32)
_TIMING = {"ts", "ms", "age_s", "failover_ms", "handoff_ms", "elapsed_ms"}


@pytest.fixture(autouse=True)
def _clean():
    for P in PACKAGES.values():
        P.faults.clear()
        P.events.clear()
    yield
    for P in PACKAGES.values():
        P.faults.clear()
        P.events.clear()


def _norm(value, root):
    """Times stripped, the run's temp root replaced, histograms as dicts."""
    if isinstance(value, dict):
        return {k: _norm(v, root) for k, v in sorted(value.items())
                if k not in _TIMING}
    if isinstance(value, (list, tuple)):
        return [_norm(v, root) for v in value]
    if isinstance(value, str):
        return value.replace(root, "<tmp>")
    if hasattr(value, "to_dict"):
        return value.to_dict()
    if isinstance(value, (np.integer, np.floating)):
        return value.item()
    return value


def _router(P, tmp, clock, breaker=True, dead_after_s=2.5, **kw):
    cfg = P.router.RouterConfig(
        store_dir=os.path.join(tmp, "store"),
        drain_dir=os.path.join(tmp, "drains"), dead_after_s=dead_after_s,
        breaker=breaker, breaker_faults=2, breaker_probe_after=2,
        clock=clock, **kw)
    return P.router.ServingRouter(cfg)


def _stubs(P, router, n=2, **kw):
    c = router.config
    reps = [P.Stub(f"r{i}", c.store_dir, c.drain_dir, clock=c.clock, **kw)
            for i in range(n)]
    for rep in reps:
        router.register_handle(rep)
    return reps


def _install(P, entries):
    P.faults.install(P.faults.FaultInjector(
        P.faults.FaultSchedule(entries, seed=0)))


def _manifests(store):
    out = []
    for fn in sorted(os.listdir(store)):
        if not fn.startswith("gen_") or ".tmp." in fn:
            continue
        try:
            with open(os.path.join(store, fn)) as f:
                out.append(json.load(f))
        except ValueError:
            out.append({"torn": fn})
    return out


def _record(P, router, tmp, **extra):
    stats = {k: v for k, v in router.stats().items()
             if k not in ("failover_ms", "handoff_ms")}
    return _norm({"events": P.events.history(),
                  "placements": dict(router._placement),
                  "inflight": router.replica_inflight(),
                  "stats": stats, "fleet": router.fleet_stats(),
                  "manifests": _manifests(router.config.store_dir),
                  **extra}, tmp)


def _bounded(P, max_queue):
    class Bounded(P.Stub):
        """Sheds typed, like a ServingEngine at its queue watermark."""

        def try_admit(self, prompt, max_new_tokens, rid, **kw):
            if len(self._q) >= max_queue:
                raise P.AdmissionRejected("queue_full",
                                          queue_len=len(self._q),
                                          max_queue=max_queue)
            return super().try_admit(prompt, max_new_tokens, rid, **kw)
    return Bounded


# ---------------------------------------------------------------------------
# the scenarios: each returns a comparable record
# ---------------------------------------------------------------------------

def spill_to_sibling(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    c = router.config
    Bounded = _bounded(P, 2)
    reps = [Bounded(f"r{i}", c.store_dir, c.drain_dir, clock=c.clock)
            for i in range(2)]
    for rep in reps:
        router.register_handle(rep)
    for _ in range(4):
        router.add_request(PROMPT, 8)
    assert reps[0].inflight() == 2 and reps[1].inflight() == 2
    st = router.stats()
    assert st["spilled"] == 2.0 and st["shed"] == 0.0
    assert st["spill_rate"] == 0.5
    return _record(P, router, tmp)


def all_saturated_shed(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    c = router.config
    Bounded = _bounded(P, 1)
    for i in range(2):
        router.register_handle(Bounded(f"r{i}", c.store_dir, c.drain_dir,
                                       clock=c.clock))
    router.add_request(PROMPT, 8)
    router.add_request(PROMPT, 8)
    with pytest.raises(P.AdmissionRejected) as ei:
        router.add_request(PROMPT, 8)
    assert ei.value.reason == "all_replicas_saturated"
    return _record(P, router, tmp, shed=[ei.value.reason, ei.value.detail])


def least_loaded_wins(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    r0, r1 = _stubs(P, router, 2, service_rate=0)
    router.add_request(PROMPT, 8)
    router.step()
    t[0] += 1.0
    router.add_request(PROMPT, 8)
    assert r0.inflight() == 1 and r1.inflight() == 1
    return _record(P, router, tmp)


def heartbeat_loss_half_open(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    r0, r1 = _stubs(P, router, 2)
    _install(P, [{"kind": "heartbeat_loss", "at": 1, "replica": 0,
                  "times": 4}])
    states, opened = [], None
    for rnd in range(12):
        router.step()
        t[0] += 1.0
        states.append(router.breaker_state("r0"))
        if opened is None and states[-1] == P.router.BREAKER_OPEN:
            opened = rnd
            router.add_request(PROMPT, 8)
            assert r0.inflight() == 0 and r1.inflight() == 1
    assert opened is not None and states[-1] == P.router.BREAKER_CLOSED
    assert not P.events.history("request_migrated")
    return _record(P, router, tmp, states=states,
                   fired=P.faults.active().fired)


def partition_and_manifest_fallback(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    _stubs(P, router, 2)
    gen_before = router.generation()["generation"]
    _install(P, [{"kind": "router_partition", "at": 1, "replica": 0,
                  "times": 3}])
    reps = list(router.replicas.values())
    states = []
    for rnd in range(10):
        router.step()
        if rnd == 1:
            router.add_request(PROMPT, 8)
            assert reps[0].inflight() == 0 and reps[1].inflight() >= 1
        t[0] += 1.0
        states.append(router.breaker_state("r0"))
    assert [e["reason"] for e in P.events.history("replica_degraded")] \
        == ["dispatch_faults"]
    cur = router.generation()
    assert cur is not None and cur["generation"] >= gen_before
    router._publish_generation()
    assert router.generation()["generation"] > gen_before
    return _record(P, router, tmp, states=states)


def drained_kill_migrates(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    r0, r1 = _stubs(P, router, 2, service_rate=0)
    for _ in range(3):
        router.add_request(PROMPT, 8)
    r0.publish()
    r0.die()
    states = []
    for _ in range(5):
        router.step()
        t[0] += 1.0
        states.append(router.breaker_state("r0"))
    st = router.stats()
    assert st["failovers"] == 1.0 and st["migrated"] == 3.0
    assert router.generation()["hosts"] == ["r1"]
    router.add_request(PROMPT, 8)
    assert router.replica_inflight()["r1"] == 4
    return _record(P, router, tmp, states=states)


def preexisting_snapshot_not_evidence(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    c = router.config
    old = os.path.join(c.drain_dir, "r0", "drain_r0")
    os.makedirs(old)
    P.integrity.atomic_write(
        os.path.join(old, "state.json"),
        json.dumps({"version": 2, "requests": [
            {"rid": 999, "prompt": [1, 2], "max_new_tokens": 4,
             "generated": []}]}), what="stale drain")
    P.integrity.write_manifest(old)
    P.integrity.write_commit_marker(old)
    for i in range(2):
        router.register_handle(P.Stub(f"r{i}", c.store_dir, c.drain_dir,
                                      clock=c.clock))
    router.add_request(PROMPT, 8)
    _install(P, [{"kind": "heartbeat_loss", "at": 1, "replica": 0,
                  "times": 4}])
    for _ in range(12):
        router.step()
        t[0] += 1.0
    st = router.stats()
    assert st["failovers"] == 0.0 and st["completed"] == 1.0
    return _record(P, router, tmp)


def failover_consumes_snapshot(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    r0, r1 = _stubs(P, router, 2, service_rate=0)
    router.add_request(PROMPT, 8)
    r0.publish()
    r0.die()
    for _ in range(5):
        router.step()
        t[0] += 1.0
    tag_dir = os.path.join(r0.drain_dir, "drain_r0")
    assert not P.integrity.is_committed(tag_dir)
    assert os.path.exists(os.path.join(tag_dir, "state.json"))
    return _record(P, router, tmp)


def lost_requests_residue(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    c = router.config

    class Small(P.Stub):
        def accept_migration(self, recs, rng_counter=None, source=None,
                             geometry=None):
            if any(int(r["rid"]) == 1 for r in recs):
                raise P.serving.ResumeIncompatible("too small")
            return super().accept_migration(recs, rng_counter, source)

    r0 = P.Stub("r0", c.store_dir, c.drain_dir, clock=c.clock,
                service_rate=0)
    router.register_handle(r0)
    router.register_handle(Small("r1", c.store_dir, c.drain_dir,
                                 clock=c.clock))
    router.add_request(PROMPT, 8)
    router.add_request(PROMPT, 8)
    r0.publish()
    r0.die()
    for _ in range(8):
        router.step()
        t[0] += 1.0
    residue = P.serving.load_drain_state(os.path.join(c.drain_dir, "r0"))
    assert residue["failover_residue"] is True
    assert [r["rid"] for r in residue["requests"]] == [1]
    residue.pop("tag")
    return _record(P, router, tmp, residue=residue)


def corrupt_snapshot_resubmits(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    r0, r1 = _stubs(P, router, 2, service_rate=0)
    for _ in range(2):
        router.add_request(PROMPT, 8)
    r0.publish()
    r0.die()
    path = os.path.join(r0.drain_dir, "drain_r0", "state.json")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))
    for _ in range(6):
        router.step()
        t[0] += 1.0
    st = router.stats()
    assert st["migrated"] == 2.0 and st["resubmitted"] == 2.0
    # the invalid-snapshot event names the reader's error, worded by each
    # package's own integrity module: compare its presence, not its text
    bad = P.events.history("drain_snapshot_invalid")
    assert len(bad) == 1
    P.events.clear()
    rec = _record(P, router, tmp)
    return dict(rec, snapshot_invalid=[e["tag"] for e in bad])


def too_long_spills(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    c = router.config

    class Capped(P.Stub):
        def __init__(self, *a, max_model_len=64, **kw):
            super().__init__(*a, **kw)
            self.max_model_len = max_model_len

        def try_admit(self, prompt, max_new_tokens, rid, **kw):
            if len(prompt) + max_new_tokens > self.max_model_len:
                raise P.AdmissionRejected(
                    "too_long", replica=self.name,
                    max_model_len=self.max_model_len)
            return super().try_admit(prompt, max_new_tokens, rid, **kw)

    router.register_handle(Capped("r0", c.store_dir, c.drain_dir,
                                  clock=c.clock, max_model_len=32))
    router.register_handle(Capped("r1", c.store_dir, c.drain_dir,
                                  clock=c.clock, max_model_len=128))
    rid = router.add_request(np.arange(20, dtype=np.int32), 30)
    assert router._placement[rid] == "r1"
    with pytest.raises(P.AdmissionRejected) as ei:
        router.add_request(np.arange(120, dtype=np.int32), 30)
    assert ei.value.reason == "too_long"
    return _record(P, router, tmp)


def heartbeat_write_failure(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    r0, = _stubs(P, router, 1)
    rid = router.add_request(PROMPT, 8)

    def failing_heartbeat(meta=None):
        raise OSError("injected EIO writing hb_r0.json")
    r0.rdzv.heartbeat = failing_heartbeat
    finished = []
    for _ in range(4):
        finished += router.step()
        t[0] += 1.0
    assert any(f.rid == rid for f in finished)
    return _record(P, router, tmp, finished=[f.rid for f in finished])


def silent_death_resubmits(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    r0, r1 = _stubs(P, router, 2, service_rate=0)
    for _ in range(2):
        router.add_request(PROMPT, 8)
    r0.silent = True
    r0.dead = True
    for _ in range(5):
        router.step()
        t[0] += 1.0
    st = router.stats()
    assert st["migrated"] == 2.0 and st["resubmitted"] == 2.0
    return _record(P, router, tmp)


def old_role_interops_as_both(P, tmp):
    router = _router(P, tmp, clock=None)
    c = router.config
    old = P.Stub("old0", c.store_dir, c.drain_dir)
    router.register_handle(old)
    assert router._role_of(old) == "both"
    rid = router.add_request(PROMPT, 4)
    assert router._placement[rid] == "old0"
    fleet = router.fleet_stats()
    assert fleet["fleet_both_replicas"] == 1
    return _norm({"placements": dict(router._placement), "fleet": fleet},
                 tmp)


def prefill_capable_first(P, tmp):
    router = _router(P, tmp, clock=None)
    c = router.config

    class Role(P.Stub):
        def __init__(self, *a, role="both", **kw):
            super().__init__(*a, **kw)
            self.role = role

    pre = Role("pre0", c.store_dir, c.drain_dir, role="prefill")
    dec = Role("dec0", c.store_dir, c.drain_dir, role="decode")
    router.register_handle(pre)
    router.register_handle(dec)
    for _ in range(3):
        router.add_request(PROMPT, 4)
    pre.dead = True
    rid = router.add_request(PROMPT, 4)
    assert router._placement[rid] == "dec0"
    return _norm({"placements": dict(router._placement)}, tmp)


def _killable(P):
    class Killable(P.Stub):
        def kill(self):
            self.killed_t = self._clock()
            self.die()
    return Killable


def decommission_retires(P, tmp):
    t = [0.0]
    router = _router(P, tmp, clock=lambda: t[0])
    c = router.config
    Killable = _killable(P)
    r0 = Killable("r0", c.store_dir, c.drain_dir, clock=c.clock,
                  service_rate=0)
    r1 = Killable("r1", c.store_dir, c.drain_dir, clock=c.clock)
    router.register_handle(r0)
    router.register_handle(r1)
    for _ in range(2):
        router.add_request(PROMPT, 8)
    r0.publish()
    r1.publish()
    router.decommission("r0")
    assert "r0" not in router._registry.live_hosts()
    assert router.replica_inflight()["r1"] == 2
    return _record(P, router, tmp)


def _fleet(P, tmp, t, **cfg_kw):
    router = _router(P, tmp, clock=lambda: t[0])
    c = router.config
    Killable = _killable(P)
    made = []

    def spawn(name, role):
        rep = Killable(name, c.store_dir, c.drain_dir, clock=c.clock,
                       capacity=2, service_rate=1)
        made.append(rep)
        return rep

    cfg = P.fleet.FleetConfig(**dict(dict(
        role="both", min_replicas=1, max_replicas=3, scale_up_load=1.0,
        scale_up_after=2, scale_down_load=0.05, scale_down_after=2,
        cooldown_ticks=1), **cfg_kw))
    return router, P.fleet.FleetController(router, spawn, cfg), made, \
        Killable


def fleet_bootstrap(P, tmp):
    t = [0.0]
    router, ctl, made, _ = _fleet(P, tmp, t, min_replicas=2)
    names = [ctl.tick()]
    made[0].publish()
    t[0] += 1.0
    names.append(ctl.tick())
    t[0] += 1.0
    names.append(ctl.tick())
    assert names == ["auto-both-0", None, "auto-both-1"]
    return _record(P, router, tmp, names=names, ctl=ctl.stats())


def fleet_burst_lull(P, tmp):
    t = [0.0]
    router, ctl, made, Killable = _fleet(P, tmp, t)
    c = router.config
    router.register_handle(Killable("r0", c.store_dir, c.drain_dir,
                                    clock=c.clock, capacity=2,
                                    service_rate=1))
    pending = [(PROMPT, 4)] * 10
    done, peak, ticks, lives = 0, 1, [], []
    for _ in range(60):
        while pending:
            try:
                router.add_request(*pending[0])
            except P.AdmissionRejected:
                break
            pending.pop(0)
        done += len(router.step())
        ticks.append(ctl.tick())
        lives.append(int(router.fleet_stats()["fleet_live"]))
        peak = max(peak, lives[-1])
        t[0] += 1.0
        if done == 10 and not pending and lives[-1] == 1:
            break
    assert done == 10 and peak >= 2 and lives[-1] == 1
    st = router.stats()
    assert st["lost_requests"] == 0.0
    assert ctl.stats()["scale_ups"] >= 1 and ctl.stats()["scale_downs"] >= 1
    return _record(P, router, tmp, ticks=ticks, lives=lives,
                   ctl=ctl.stats())


def fleet_foreign_host(P, tmp):
    t = [0.0]
    router, ctl, made, Killable = _fleet(P, tmp, t, scale_down_after=1,
                                         cooldown_ticks=0)
    c = router.config
    r0 = Killable("r0", c.store_dir, c.drain_dir, clock=c.clock)
    router.register_handle(r0)
    foreign = P.rendezvous.FileRendezvous(c.store_dir, "foreign0",
                                          clock=lambda: t[0])
    ticks = []
    for _ in range(6):
        foreign.heartbeat(meta={"queue_depth": 0, "running": 0,
                                "capacity": 4})
        r0.publish()
        router.step()
        ticks.append(ctl.tick())
        t[0] += 1.0
    assert "foreign0" in router._registry.live_hosts()
    return _record(P, router, tmp, ticks=ticks, ctl=ctl.stats())


def fleet_spawn_refused(P, tmp):
    t = [0.0]
    router, ctl, made, _ = _fleet(P, tmp, t)
    ctl.spawn = lambda name, role: None
    assert ctl.tick() is None
    assert ctl.stats()["scale_ups"] == 0.0 and not router.replicas
    return _norm({"ctl": ctl.stats(), "events": P.events.history()}, tmp)


SCENARIOS = [spill_to_sibling, all_saturated_shed, least_loaded_wins,
             heartbeat_loss_half_open, partition_and_manifest_fallback,
             drained_kill_migrates, preexisting_snapshot_not_evidence,
             failover_consumes_snapshot, lost_requests_residue,
             corrupt_snapshot_resubmits, too_long_spills,
             heartbeat_write_failure, silent_death_resubmits,
             old_role_interops_as_both, prefill_capable_first,
             decommission_retires, fleet_bootstrap, fleet_burst_lull,
             fleet_foreign_host, fleet_spawn_refused]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario, tmp_path):
    """The scenario's own checks pass in both packages, and its record
    (events, breaker states, placements, stats, fleet rollup, manifests)
    is the same."""
    got = {}
    for name, P in PACKAGES.items():
        tmp = str(tmp_path / name)
        os.makedirs(tmp)
        got[name] = scenario(P, tmp)
        P.faults.clear()
        P.events.clear()
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# the rendezvous files interoperate both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_rendezvous_stores_interoperate(tmp_path, writer, reader):
    """Heartbeats (with and without meta, an old no-schema one, a torn
    one, a temp file) and generation manifests (a torn newest one
    included) written by one package read the same in the other, and a
    publish by the reader continues the writer's history."""
    W, R = PACKAGES[writer], PACKAGES[reader]
    t = [100.0]
    store = str(tmp_path)
    a = W.rendezvous.FileRendezvous(store, "host-a", dead_after_s=10.0,
                                    clock=lambda: t[0])
    b = W.rendezvous.FileRendezvous(store, "host-b", dead_after_s=10.0,
                                    clock=lambda: t[0])
    a.heartbeat(meta={"queue_depth": 3, "capacity": 8})
    b.heartbeat()
    with open(tmp_path / "hb_host-old.json", "w") as f:
        json.dump({"host": "host-old", "beats": 4, "ts": t[0]}, f)
    with open(tmp_path / "hb_host-torn.json", "w") as f:
        f.write('{"host": "host-torn", "beats": 2, "ts"')
    with open(tmp_path / "hb_host-c.json.tmp.999", "w") as f:
        json.dump({"host": "host-c", "beats": 1, "ts": t[0]}, f)
    a.publish_generation(["host-a", "host-b"])
    a.publish_generation(["host-a"])
    with open(tmp_path / "gen_00000002.json", "w") as f:
        f.write('{"generation": ')                     # torn newest
    r = R.rendezvous.FileRendezvous(store, "reader", dead_after_s=10.0,
                                    clock=lambda: t[0])
    w = W.rendezvous.FileRendezvous(store, "reader", dead_after_s=10.0,
                                    clock=lambda: t[0])
    assert r.read_heartbeats() == w.read_heartbeats()
    info = r.live_host_info()
    assert sorted(info) == ["host-a", "host-b", "host-old"]
    assert info["host-a"]["schema"] == R.rendezvous.HEARTBEAT_SCHEMA == 1
    assert info["host-a"]["meta"] == {"queue_depth": 3, "capacity": 8}
    assert "meta" not in info["host-b"] and "meta" not in info["host-old"]
    assert r.current_generation() == w.current_generation()
    assert r.current_generation()["generation"] == 1
    assert r.current_generation()["schema"] \
        == R.rendezvous.GENERATION_MANIFEST_SCHEMA == 1
    m = r.publish_generation(["host-a", "host-b"])
    assert m["generation"] == 2
    assert w.current_generation() == m
    r.retire("host-b")
    assert sorted(w.live_hosts()) == ["host-a", "host-old"]


def test_schema_constants_match_jax():
    from deepspeed_tpu.inference import schemas as js
    from deepspeed_tpu_torch.inference import schemas as ps
    for name in ("HEARTBEAT_SCHEMA", "GENERATION_MANIFEST_SCHEMA",
                 "DRAIN_STATE_VERSION", "KV_PAYLOAD_SCHEMA", "EVENT_SCHEMA"):
        assert getattr(ps, name) == getattr(js, name), name


@pytest.mark.parametrize("lint", ["proto_lint", "race_lint"])
def test_lints_are_clean_over_the_port(lint):
    """JAX's wire-schema lint and race lint, pointed at the port's
    package, find nothing (every port module counts as a boundary module
    to the wire-schema lint: each serialized dict carries a version key
    or matches a registered schema)."""
    import importlib
    mod = importlib.import_module(f"deepspeed_tpu.analysis.{lint}")
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "deepspeed_tpu_torch")
    report = mod.scan_package(root=root)
    assert report.ok, [(f.rule, f.message) for f in report.findings]
    assert not report.findings

"""Multi-replica serving router, the port's copy of
``deepspeed_tpu/inference/router.py`` (host only): a rendezvous-backed
registry, health-checked failover and in-flight request migration over
``ServingEngine`` replicas.

  * **Replica registry** — every replica publishes a heartbeat to a
    shared ``FileRendezvous`` store carrying a schema-versioned ``meta``
    payload: queue depth, running count, capacity, pool headroom,
    draining flag, role, tp / ep and the engine's ``obs_meta``. The router
    reads the registry, never the engines, to rank replicas. Membership
    changes (registration, death) publish generation manifests; the
    torn-newest-manifest fallback keeps the history monotone against
    partial writes (the ``router_partition`` fault tears one on purpose).
  * **Least-loaded admission with spill** — ``add_request`` ranks healthy
    replicas by registry load (queue + running over capacity) and admits to
    the least loaded. A replica at its watermarks sheds with the typed
    ``AdmissionRejected`` and the router SPILLS to the next sibling
    (``request_spilled``). Only when every healthy replica refuses does the
    caller see ``AdmissionRejected("all_replicas_saturated")``.
  * **Per-replica circuit breaker** — consecutive dispatch faults or a
    stale heartbeat OPEN the breaker (``replica_degraded``): no new
    admissions route there. After ``breaker_probe_after`` rounds the
    breaker goes HALF_OPEN and the replica may receive ONE probe request;
    a successful round with a fresh heartbeat closes it
    (``replica_recovered``). Without the breaker a router keeps assigning
    to a dead replica on its frozen (low-load) registry meta.
  * **Failover with in-flight migration** — a replica's SIGTERM drains
    through the integrity chain into its NAMESPACED drain dir
    (``<drain_dir>/<name>``, tag ``drain_<name>``). The router detects the
    dead replica by heartbeat loss, loads the newest integrity-valid
    snapshot, and re-places every serialized request onto survivors via
    ``ServingEngine.accept_migration`` (``request_migrated`` per request,
    ``replica_failover`` for the episode). Requests the router placed that
    made neither the finish line nor the snapshot (a hard crash without a
    drain) are resubmitted from the router's own admission record: full
    regeneration, still deterministic under greedy decoding.
  * **Disaggregated handoff** — a ``prefill``-role replica never decodes;
    after each round the router moves its prefill-done requests to a
    ``decode`` or ``both`` replica with their KV bytes (``export_kv`` →
    ``kv_handoff_seam`` → ``accept_migration(kv=)``), or by re-prefill
    when the payload faults or is refused.

Fencing rule (why heartbeat loss alone never migrates): migration without
death evidence can double-serve live work. The router migrates only when
the replica is CONFIRMED dead — an integrity-valid drain snapshot exists
(the drain stopped that engine's admission before the snapshot committed)
or the kill is in-process knowledge (``handle.dead`` / a ``Preempted``
raised out of the engine's own SIGTERM latch). A silent heartbeat with a
live replica is a partition: the breaker opens, in-flight work stays put,
and the half-open probe closes the loop when the partition heals.

Determinism: routing decisions only choose WHERE a request decodes; every
replica holds the same params, greedy decoding is rng-free, and
preemption/migration resume by re-prefilling exact host cursors — so the
admitted set's outputs are bit-identical to a single-replica fault-free
run regardless of placement, spill, or failover history.
"""

import collections
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.elasticity.rendezvous import FileRendezvous
from deepspeed_tpu_torch.inference.schemas import (DRAIN_STATE_VERSION,
                                             EVENT_SCHEMA)
from deepspeed_tpu_torch.inference.scheduler import AdmissionRejected, Request
from deepspeed_tpu_torch.inference.serving import (ResumeIncompatible,
                                             load_drain_state)
from deepspeed_tpu_torch.robustness import events as rb_events
from deepspeed_tpu_torch.robustness import faults as rb_faults
from deepspeed_tpu_torch.robustness.preemption import Preempted


class ReplicaUnreachable(RuntimeError):
    """The router could not dispatch to a replica this round (network
    partition / injected ``router_partition``): the replica may be alive,
    so this is breaker evidence — never death evidence."""


class ReplicaDead(RuntimeError):
    """A dispatch reached a replica that is already dead (drained or
    killed). The router skips dead replicas; this surfaces misuse."""


# breaker states (per replica). "dead" is terminal: the replica failed
# over and its registration only remains for post-mortem stats.
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"
BREAKER_DEAD = "dead"


@dataclasses.dataclass
class RouterConfig:
    """Knobs of the multi-replica tier. ``store_dir`` is the shared
    rendezvous store (heartbeats + generation manifests); ``drain_dir`` is
    the root under which each replica namespaces its integrity-chain
    drains."""
    store_dir: str
    drain_dir: str
    # a replica whose newest heartbeat is older than this is unhealthy:
    # breaker OPEN; with death evidence (drain snapshot / in-process kill)
    # it fails over
    dead_after_s: float = 5.0
    # circuit breaker (False = the router-blackhole defect: no health
    # sweep, admissions keep trusting frozen registry meta forever)
    breaker: bool = True
    breaker_faults: int = 3        # consecutive dispatch faults -> OPEN
    breaker_probe_after: int = 2   # OPEN rounds before the HALF_OPEN probe
    # robustness/telemetry events drain into this JSONL at round
    # boundaries (give the sink to the ROUTER, not the replicas, so one
    # process-wide queue has exactly one drainer)
    telemetry_jsonl: Optional[str] = None
    # injectable time source shared with every replica's FileRendezvous
    # (tests drive detection deterministically; None = time.time)
    clock: Optional[Callable[[], float]] = None
    # disaggregated serving: when a prefill-role replica finishes a
    # prompt, ship the KV bytes to the decode replica through
    # export_kv/accept_migration(kv=) instead of re-prefilling there.
    # False still hands off (re-prefill migration), but every handoff
    # makes the decode tier pay the prompt again.
    handoff_kv: bool = True


class ReplicaHandle:
    """One serving replica as the router drives it: a ``ServingEngine``
    plus its rendezvous membership. The router only touches the handle
    protocol (``name``/``dead``/``partitioned``/``mute_heartbeat``,
    ``publish``/``step``/``try_admit``/``accept_migration``/``kill``/
    ``new_cancelled``/``drain_dir``) — a pure-host stub replica can
    implement the same surface. The disaggregated-handoff half
    (``handoff_ready``/``export_kv``/``release_requests``) is optional:
    the router's sweep getattr-guards it, so role-less stubs and old
    handles simply never hand off."""

    def __init__(self, name: str, engine, store_dir: str, drain_root: str,
                 clock: Optional[Callable[[], float]] = None,
                 preemption=None, role: Optional[str] = None):
        self.name = name
        self.engine = engine
        # disaggregated serving: the tier this replica serves.
        # Defaults to the engine's own config.role; anything else (old
        # handles, stub replicas) routes as "both"
        self.role = str(role or getattr(
            getattr(engine, "config", None), "role", None) or "both")
        self.rdzv = FileRendezvous(store_dir, name, clock=clock)
        # integrity-chain namespacing: every drain of this replica lives
        # under its own directory AND tag, so two replicas draining into
        # one shared filesystem can never clobber each other's chains
        self.drain_dir = os.path.join(drain_root, name)
        self.dead = False
        self.partitioned = False       # set per round by fault actions
        self.mute_heartbeat = False    # set per round by fault actions
        self.killed_t: Optional[float] = None
        self._cancel_seen = 0
        if preemption is not None:
            engine.attach_preemption(preemption, self.drain_dir)
        # a tracing-armed engine still tagged with the default replica
        # name inherits THIS handle's: the merged Chrome trace needs one
        # process row per replica, and "r0" twice would alias them
        tracer = getattr(engine, "tracer", None)
        if tracer is not None and tracer.replica == "r0" and name != "r0":
            tracer.replica = name

    # ---- registry ----------------------------------------------------

    @property
    def capacity(self) -> int:
        return int(self.engine.config.max_seqs)

    def meta(self) -> Dict[str, Any]:
        """The heartbeat payload's routing half: what a remote router
        needs to rank this replica without touching it. Carries the mesh
        topology (tp/ep degrees): ``_survivor_order`` ranks
        geometry-matched survivors first during a failover (a mismatched
        one refuses drain-origin records typed anyway — the ordering
        skips the wasted round-trips) and an operator can see which
        replicas are pod-sharded; old no-meta/no-topology heartbeats
        interop (the schema satellite's contract)."""
        sched = self.engine.scheduler
        # "role" carries the serving tier (prefill/decode/both). Old
        # heartbeats said "replica" — readers treat anything that isn't
        # prefill/decode as "both", so old metas interop unchanged
        d = {"role": self.role,
             "queue_depth": int(sched.num_waiting),
             "running": int(sched.num_running),
             "capacity": self.capacity,
             "pool_free": round(
                 1.0 - self.engine.allocator.used_fraction, 4),
             "draining": bool(self.engine._draining),
             "tp": int(getattr(self.engine, "tp", 1)),
             "ep": int(getattr(self.engine, "ep", 1))}
        # fleet rollup half: mergeable histograms + occupancy.
        # Optional by the schema contract — stub replicas (and pre-obs
        # engines) just omit the key; the rollup skips them
        if hasattr(self.engine, "obs_meta"):
            try:
                d["obs"] = self.engine.obs_meta()
            except Exception:  # noqa: BLE001 - obs must not kill heartbeats
                pass
        return d

    def publish(self) -> None:
        if self.dead or self.mute_heartbeat:
            return
        self.rdzv.heartbeat(meta=self.meta())

    # ---- dispatch ----------------------------------------------------

    def try_admit(self, prompt, max_new_tokens: int, rid: int,
                  ttft_deadline_ms: Optional[float] = None,
                  deadline_ms: Optional[float] = None) -> int:
        if len(prompt) + max_new_tokens > self.engine.max_model_len:
            # the engine raises an untyped ValueError for this (a caller
            # bug when talking to ONE engine) — but under a router with
            # heterogeneous replicas it is a routing signal: typed, so
            # the admission loop spills to a larger sibling
            raise AdmissionRejected(
                "too_long", replica=self.name,
                need=int(len(prompt) + max_new_tokens),
                max_model_len=int(self.engine.max_model_len))
        return self.engine.add_request(
            prompt, max_new_tokens, request_id=rid,
            ttft_deadline_ms=ttft_deadline_ms, deadline_ms=deadline_ms)

    def step(self) -> List[Request]:
        """One serving round of this replica (its own serve loop, driven
        by the router for in-process replicas). Publishes the heartbeat
        AFTER the round so registry meta reflects post-round load."""
        if self.dead:
            raise ReplicaDead(self.name)
        if self.partitioned:
            # unreachable: the engine never runs this round — its
            # in-flight work stalls until the partition heals
            raise ReplicaUnreachable(
                f"router partition: replica {self.name} unreachable")
        finished = self.engine.step()
        try:
            self.publish()
        except OSError:
            # a transient store-write hiccup (the shared NFS/gcsfuse
            # heartbeat file) must not discard the round's COMPLETED
            # work — the missed beat just ages the heartbeat one round,
            # which is exactly what the router's health sweep measures
            pass
        return finished

    def accept_migration(self, recs, rng_counter=None, source=None,
                         geometry=None, kv=None):
        return self.engine.accept_migration(recs, rng_counter=rng_counter,
                                            source=source,
                                            geometry=geometry, kv=kv)

    # ---- disaggregated handoff ------------------------------------

    def handoff_ready(self) -> List[int]:
        """Requests a prefill-tier replica is done prefilling: first
        token committed, everything after it is decode work that belongs
        on the decode tier. The router's handoff sweep drains these."""
        return [r.rid for r in self.engine.scheduler.running
                if r.prefill_done and r.generated]

    def export_kv(self, request_ids):
        return self.engine.export_kv(request_ids)

    def release_requests(self, request_ids):
        return self.engine.release_requests(request_ids)

    def new_cancelled(self) -> List[Request]:
        cur = self.engine.cancelled
        out = cur[self._cancel_seen:]
        self._cancel_seen = len(cur)
        return out

    @property
    def done(self) -> bool:
        return bool(self.engine.scheduler.done)

    def inflight(self) -> int:
        sched = self.engine.scheduler
        return int(sched.num_waiting + sched.num_running)

    # ---- death -------------------------------------------------------

    def kill(self) -> Optional[str]:
        """SIGTERM-equivalent: drain through the integrity chain into the
        replica's namespaced drain dir, then die (heartbeats stop with
        the replica). In-process replicas kill synchronously — the same
        ``drain()`` the PreemptionHandler latches to; a per-process
        deployment delivers a real SIGTERM and the router sees the
        resulting heartbeat loss (and drain snapshot) identically."""
        if self.dead:
            return None
        self.killed_t = time.perf_counter()
        path = self.engine.drain(self.drain_dir, tag=f"drain_{self.name}",
                                 source=self.name)
        self.dead = True
        return path


class ServingRouter:
    """Route requests across serving replicas registered on one
    rendezvous store.

    >>> router = ServingRouter(RouterConfig(store, drains))
    >>> router.register("r0", srv0); router.register("r1", srv1)
    >>> rid = router.add_request(prompt_ids, 32)   # least-loaded + spill
    >>> finished = router.step()                   # one round, all replicas
    >>> router.stats()                             # spill/failover/SLO view
    """

    def __init__(self, config: RouterConfig, name: str = "router"):
        self.config = config
        self.name = name
        os.makedirs(config.store_dir, exist_ok=True)
        os.makedirs(config.drain_dir, exist_ok=True)
        self._clock = config.clock or time.time
        # the router reads the registry and publishes generation
        # manifests but never heartbeats: it is an observer of the
        # membership, not a member
        self._registry = FileRendezvous(config.store_dir, name,
                                        dead_after_s=config.dead_after_s,
                                        clock=config.clock)
        self.replicas: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._breaker: Dict[str, Dict[str, Any]] = {}
        self._info: Dict[str, Dict[str, Any]] = {}   # last-seen heartbeats
        self._info_round = -1                        # round the cache is from
        # drain tags that existed BEFORE a replica registered are history
        # from a previous incarnation, not death evidence for this one
        # (fencing: a leftover snapshot must not convert a heartbeat blip
        # into a false failover that double-serves live work)
        self._stale_tags: Dict[str, set] = {}
        self._placement: Dict[int, str] = {}         # rid -> replica name
        self._records: Dict[int, Dict[str, Any]] = {}  # rid -> resubmit rec
        # dead replicas whose frozen heartbeat obs left the stats window
        # (reset_stats): rollups skip them without rewriting the store
        self._obs_excluded: set = set()
        self._next_rid = 0
        self._round = 0
        self._ttfts: List[float] = []
        self._counters = {"admitted": 0, "spilled": 0, "shed": 0,
                          "migrated": 0, "resubmitted": 0, "lost": 0,
                          "failovers": 0, "failover_ms": 0.0,
                          "completed": 0, "cancelled": 0,
                          "dispatch_faults": 0,
                          "handoffs": 0, "handoff_bytes": 0,
                          "handoff_fallbacks": 0, "handoff_ms": 0.0}
        self._jsonl = None
        if config.telemetry_jsonl:
            from deepspeed_tpu_torch.monitor.monitor import JSONLMonitor
            self._jsonl = JSONLMonitor(config.telemetry_jsonl)

    # ---- registration ------------------------------------------------

    def register(self, name: str, engine, preemption=None,
                 role: Optional[str] = None) -> ReplicaHandle:
        """Wrap a ServingEngine as a replica and add it to the registry
        (publishes its first heartbeat and the next generation manifest).
        ``role`` overrides the engine's own ``config.role`` for routing
        (prefill / decode / both)."""
        return self.register_handle(ReplicaHandle(
            name, engine, self.config.store_dir, self.config.drain_dir,
            clock=self.config.clock, preemption=preemption, role=role))

    def register_handle(self, handle) -> Any:
        """Register a prebuilt replica handle (stub replicas enter
        here); see ReplicaHandle for the protocol."""
        if handle.name in self.replicas:
            raise ValueError(f"replica '{handle.name}' already registered")
        self.replicas[handle.name] = handle
        self._breaker[handle.name] = {
            "state": BREAKER_CLOSED, "faults": 0, "open_rounds": 0,
            "reason": None, "probe_rid": None, "ok": False}
        from deepspeed_tpu_torch.robustness import integrity
        self._stale_tags[handle.name] = (
            set(integrity.list_tags(handle.drain_dir))
            if os.path.isdir(handle.drain_dir) else set())
        handle.publish()
        self._refresh_info()
        self._publish_generation()
        return handle

    def _replica_at(self, idx: int):
        reps = list(self.replicas.values())
        return reps[idx] if 0 <= idx < len(reps) else None

    def _publish_generation(self) -> Dict[str, Any]:
        """Membership changed (registration / death): publish the next
        generation manifest over the live replica set. Reads-before-write
        go through ``current_generation`` — whose torn-newest fallback
        keeps the history monotone even while a ``router_partition`` has
        torn the newest manifest file."""
        hosts = [n for n, rep in self.replicas.items() if not rep.dead]
        return self._registry.publish_generation(hosts)

    def generation(self) -> Optional[Dict[str, Any]]:
        return self._registry.current_generation()

    # ---- admission ---------------------------------------------------

    def _refresh_info(self) -> None:
        # stale payloads intentionally kept: staleness IS the health
        # signal (the sweep measures it); a breaker-less router trusting
        # these frozen values forever is the router-blackhole defect
        self._info.update(self._registry.read_heartbeats())
        self._info_round = self._round

    def _load_score(self, name: str, rep) -> float:
        meta = (self._info.get(name) or {}).get("meta") or {}
        cap = meta.get("capacity") or getattr(rep, "capacity", 1) or 1
        return (int(meta.get("queue_depth", 0))
                + int(meta.get("running", 0))) / max(1, int(cap))

    def _role_of(self, rep) -> str:
        """The replica's serving tier: the handle's own ``role`` first,
        its registry heartbeat second. Anything that isn't exactly
        prefill/decode — including the old "replica" string and missing
        meta — routes as "both" (the interop contract for old metas)."""
        role = getattr(rep, "role", None)
        if role is None:
            meta = (self._info.get(rep.name) or {}).get("meta") or {}
            role = meta.get("role")
        return role if role in ("prefill", "decode") else "both"

    def _admission_order(self) -> List[Tuple[Any, bool]]:
        """Healthy replicas, least registry-load first; HALF_OPEN replicas
        rank last and only while no probe request is in flight (the
        probe-request half of the breaker protocol).

        The registry cache refreshes at most once per routing round
        (replicas only publish at round boundaries, so a per-admission
        disk scan of the store — NFS in the deployment this is designed
        for — would buy nothing): the sweep's refresh covers breaker
        routers, and the first admission of a round covers the rest."""
        if self._info_round != self._round:
            self._refresh_info()
        ranked = []
        for i, (name, rep) in enumerate(self.replicas.items()):
            if rep.dead:
                continue
            br = self._breaker[name]
            half = False
            if self.config.breaker:
                if br["state"] in (BREAKER_OPEN, BREAKER_DEAD):
                    continue
                if br["state"] == BREAKER_HALF_OPEN:
                    if br["probe_rid"] is not None:
                        continue
                    half = True
            if getattr(rep, "partitioned", False):
                # known-unreachable THIS round: its frozen low-load meta
                # would otherwise keep winning admissions into the
                # partition window before the breaker's fault count opens
                continue
            meta = (self._info.get(name) or {}).get("meta") or {}
            if meta.get("draining"):
                continue
            ranked.append((1 if half else 0,
                           self._load_score(name, rep), i, rep, half))
        ranked.sort(key=lambda t: t[:3])
        # disaggregated routing: NEW requests are prefill work, so
        # prefill-capable replicas (prefill/both) take them and the
        # decode tier only sees handoffs. A registry with nothing
        # prefill-capable falls back to the full ranking — admitting to
        # a decode replica (which can still serve end-to-end) beats
        # shedding the request
        pref = [(rep, half) for _, _, _, rep, half in ranked
                if self._role_of(rep) != "decode"]
        if pref:
            return pref
        return [(rep, half) for _, _, _, rep, half in ranked]

    def add_request(self, prompt_ids, max_new_tokens: int = 64,
                    ttft_deadline_ms: Optional[float] = None,
                    deadline_ms: Optional[float] = None) -> int:
        """Admit to the least-loaded healthy replica; a watermark shed
        SPILLS to the next sibling (``request_spilled``) instead of
        surfacing. Raises the typed
        ``AdmissionRejected("all_replicas_saturated")`` only when every
        healthy replica refused — the single-replica shed behavior is the
        degenerate case of a one-entry registry."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        rid = self._next_rid
        order = self._admission_order()
        last: Optional[AdmissionRejected] = None
        reasons = set()
        for i, (rep, half) in enumerate(order):
            try:
                rep.try_admit(prompt, max_new_tokens, rid=rid,
                              ttft_deadline_ms=ttft_deadline_ms,
                              deadline_ms=deadline_ms)
            except AdmissionRejected as e:
                last = e
                reasons.add(e.reason)
                continue
            except (ReplicaUnreachable, ReplicaDead) as e:
                # a transport failure on the admission path is breaker
                # evidence AND a reason to spill — never a caller crash
                self._on_step_fault(rep, e)
                last = AdmissionRejected("replica_unreachable",
                                         replica=rep.name)
                reasons.add(last.reason)
                continue
            self._next_rid += 1
            self._placement[rid] = rep.name
            # the router-owned int32 copy, NOT a Python list: admission
            # is the hot path and the list form is only needed in the
            # rare failover-resubmit serialization
            self._records[rid] = {
                "prompt": prompt,
                "max_new_tokens": int(max_new_tokens),
                "ttft_deadline_ms": ttft_deadline_ms,
                "deadline_ms": deadline_ms}
            self._counters["admitted"] += 1
            if half:
                self._breaker[rep.name]["probe_rid"] = rid
            if i > 0:
                self._counters["spilled"] += 1
                rb_events.emit("request_spilled", rid=rid, dst=rep.name,
                               skipped=i,
                               reason=getattr(last, "reason", None))
            return rid
        self._counters["shed"] += 1
        if order and reasons == {"too_long"}:
            # no replica in the registry can EVER hold this request —
            # a retry can't succeed, so the shed is permanent, not
            # backpressure (run() drops it instead of spinning)
            rb_events.emit("request_shed", reason="too_long",
                           healthy=len(order))
            raise AdmissionRejected(
                "too_long", healthy=len(order),
                need=int(prompt.size + max_new_tokens))
        rb_events.emit("request_shed", reason="all_replicas_saturated",
                       healthy=len(order), replicas=len(self.replicas))
        raise AdmissionRejected(
            "all_replicas_saturated", healthy=len(order),
            replicas=len(self.replicas),
            last=getattr(last, "reason", None))

    # ---- the routing round -------------------------------------------

    def step(self) -> List[Request]:
        """One routing round: apply scheduled router faults, run every
        live replica's serving round, then the health sweep (breaker
        transitions + heartbeat-loss failover). Returns the requests that
        finished this round, across all replicas."""
        for rep in self.replicas.values():
            rep.partitioned = False
            rep.mute_heartbeat = False
        for act in rb_faults.router_seam(self.config.store_dir):
            rep = self._replica_at(act["replica"])
            if rep is None or rep.dead:
                continue
            if act["kind"] == "replica_kill":
                rep.kill()
            elif act["kind"] == "heartbeat_loss":
                rep.mute_heartbeat = True
            elif act["kind"] == "router_partition":
                rep.partitioned = True
        finished: List[Request] = []
        for rep in list(self.replicas.values()):
            if rep.dead:
                continue
            try:
                finished.extend(rep.step())
            except Preempted:
                # the engine latched a real SIGTERM and drained itself:
                # replica death — the sweep detects the heartbeat loss
                # and fails over from the snapshot it just committed
                rep.dead = True
            except ReplicaDead:
                pass
            except Exception as e:  # noqa: BLE001 — ANY dispatch failure
                # (partition, engine round failure past its own retries)
                # is breaker evidence, never fatal to the router
                self._on_step_fault(rep, e)
            else:
                self._on_step_ok(rep)
            for r in rep.new_cancelled():
                self._counters["cancelled"] += 1
                self._placement.pop(r.rid, None)
                self._records.pop(r.rid, None)
        self._round += 1
        if self.config.breaker:
            self._health_sweep()
        self._handoff_sweep()
        for r in finished:
            self._on_finished(r)
        self._drain_events()
        return finished

    def _on_finished(self, req: Request) -> None:
        self._counters["completed"] += 1
        self._placement.pop(req.rid, None)
        self._records.pop(req.rid, None)
        if req.first_token_t is not None:
            self._ttfts.append((req.first_token_t - req.submit_t) * 1e3)
        for br in self._breaker.values():
            if br["probe_rid"] == req.rid:
                br["probe_rid"] = None

    def _on_step_ok(self, rep) -> None:
        br = self._breaker[rep.name]
        br["faults"] = 0
        br["ok"] = True

    def _on_step_fault(self, rep, err: BaseException) -> None:
        br = self._breaker[rep.name]
        br["faults"] += 1
        br["ok"] = False
        self._counters["dispatch_faults"] += 1
        if not self.config.breaker:
            return
        if br["state"] == BREAKER_HALF_OPEN:
            # the probe failed: back to OPEN, cooldown restarts
            br.update(state=BREAKER_OPEN, open_rounds=0, probe_rid=None)
        elif br["state"] == BREAKER_CLOSED \
                and br["faults"] >= self.config.breaker_faults:
            self._open(rep, "dispatch_faults", error=type(err).__name__)

    def _open(self, rep, reason: str, **detail) -> None:
        br = self._breaker[rep.name]
        br.update(state=BREAKER_OPEN, open_rounds=0, reason=reason,
                  probe_rid=None, ok=False)
        rb_events.emit("replica_degraded", replica=rep.name, reason=reason,
                       **detail)

    # ---- health sweep / failover -------------------------------------

    def _heartbeat_age(self, name: str) -> float:
        p = self._info.get(name)
        if p is None:
            return float("inf")
        return self._clock() - float(p["ts"])

    def _health_sweep(self) -> None:
        """Post-round health pass: refresh the registry cache, open the
        breaker on stale heartbeats, walk OPEN -> HALF_OPEN -> CLOSED,
        and fail over replicas that are confirmed dead (fencing rule —
        see module docstring)."""
        self._refresh_info()
        for name, rep in list(self.replicas.items()):
            br = self._breaker[name]
            if br["state"] == BREAKER_DEAD:
                continue
            age = self._heartbeat_age(name)
            stale = age > self.config.dead_after_s
            snap = self._drain_snapshot(rep) if stale else None
            if stale and (rep.dead or snap is not None):
                if br["state"] == BREAKER_CLOSED:
                    # record the detection before the failover episode
                    self._open(rep, "heartbeat_loss",
                               age_s=round(age, 2), terminal=True)
                self._failover(rep, tag=snap)
                continue
            if br["state"] == BREAKER_CLOSED:
                if stale:
                    self._open(rep, "heartbeat_loss", age_s=round(age, 2))
            elif br["state"] == BREAKER_OPEN:
                br["open_rounds"] += 1
                if br["open_rounds"] >= self.config.breaker_probe_after:
                    br.update(state=BREAKER_HALF_OPEN, ok=False)
            elif br["state"] == BREAKER_HALF_OPEN:
                if stale:
                    br.update(state=BREAKER_OPEN, open_rounds=0,
                              probe_rid=None)
                elif br["ok"]:
                    opened_for = br["reason"]
                    br.update(state=BREAKER_CLOSED, faults=0,
                              open_rounds=0, reason=None, probe_rid=None)
                    rb_events.emit("replica_recovered", replica=name,
                                   was=opened_for)

    def _drain_snapshot(self, rep) -> Optional[str]:
        """Newest integrity-valid drain tag written SINCE this replica
        registered. Tags that predate the registration are a previous
        incarnation's history — treating one as death evidence would let
        a leftover snapshot convert a transient heartbeat blip into a
        false failover that double-serves live work (and re-runs the old
        snapshot's already-completed requests). A consumed snapshot is
        invalidated by ``_failover`` for the same reason.

        Shallow validation (marker + sizes) — enough for the evidence
        decision; ``load_drain_state`` inside the failover does the one
        deep (checksum) pass before anything is actually restored."""
        from deepspeed_tpu_torch.robustness import integrity
        if not os.path.isdir(rep.drain_dir):
            return None
        return integrity.newest_valid_tag(
            rep.drain_dir, deep=False,
            exclude=self._stale_tags.get(rep.name, ()))

    def _survivor_order(self, exclude: str,
                        geometry: Optional[Dict[str, Any]] = None
                        ) -> List[Any]:
        """Migration targets, best first: geometry-matched (the drained
        tp/ep degrees vs each survivor's heartbeat meta — a mismatched
        survivor would refuse drain-origin records with
        ``ResumeIncompatible`` anyway, so trying it first just wastes a
        round-trip), then CLOSED by load, then HALF_OPEN, then
        OPEN-but-alive (placing on a degraded survivor beats losing the
        request; its breaker still blocks NEW admissions). Survivors
        whose meta predates the topology fields rank as matched — the
        typed refusal is still the arbiter, ordering is only a hint."""
        state_rank = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1,
                      BREAKER_OPEN: 2}
        want_tp = want_ep = None
        if geometry is not None:
            want_tp, want_ep = geometry.get("tp"), geometry.get("ep")

        def mismatch(name: str) -> int:
            meta = (self._info.get(name) or {}).get("meta") or {}
            for want, key in ((want_tp, "tp"), (want_ep, "ep")):
                got = meta.get(key)
                if want is not None and got is not None \
                        and int(got) != int(want):
                    return 1
            return 0

        out = []
        for i, (name, rep) in enumerate(self.replicas.items()):
            if name == exclude or rep.dead:
                continue
            br = self._breaker[name]
            if br["state"] == BREAKER_DEAD:
                continue
            out.append((mismatch(name), state_rank.get(br["state"], 2),
                        self._load_score(name, rep), i, rep))
        out.sort(key=lambda t: t[:4])
        return [rep for *_, rep in out]

    def _failover(self, rep, tag: Optional[str] = None) -> None:
        """Failover episode for a confirmed-dead replica: resume its
        integrity-valid drain snapshot onto survivors (plus resubmit
        anything the router placed that made neither the finish line nor
        the snapshot), re-publish the generation manifest, and account
        the episode. ``tag`` is the snapshot the health sweep already
        located (shallow-validated there; deep-validated once here by
        ``load_drain_state``). ``failover_ms`` measures the real
        unavailability window when the kill time is known in-process,
        else the episode's own duration."""
        t0 = time.perf_counter()
        br = self._breaker[rep.name]
        br.update(state=BREAKER_DEAD, probe_rid=None)
        rep.dead = True
        if tag is None:
            tag = self._drain_snapshot(rep)
        recs: List[Dict[str, Any]] = []
        rng_counter = None
        drained_engine = None
        if tag is not None:
            try:
                state = load_drain_state(rep.drain_dir, tag)
            except (OSError, ValueError) as e:
                # the snapshot passed the shallow evidence check but fails
                # the deep read (bitrot, torn rewrite). The failover must
                # NOT wedge here — the router's own admission records can
                # resubmit every placed request from scratch (only the
                # generated-token progress is lost, and regeneration is
                # deterministic). The bad tag becomes consumed evidence so
                # it is never picked again.
                rb_events.emit("drain_snapshot_invalid", replica=rep.name,
                               tag=tag, error=str(e))
                self._stale_tags.setdefault(rep.name, set()).add(tag)
                tag = None
            else:
                rng_counter = state.get("rng_counter")
                drained_engine = state.get("engine")
                for r in state["requests"]:
                    recs.append(dict(r, _origin="drain"))
        drained = {int(r["rid"]) for r in recs}
        for rid, name in list(self._placement.items()):
            if name != rep.name or rid in drained:
                continue
            rec = self._records.get(rid)
            if rec is None:
                continue
            recs.append({"rid": rid,
                         "prompt": np.asarray(rec["prompt"],
                                              np.int32).tolist(),
                         "max_new_tokens": rec["max_new_tokens"],
                         "generated": [],
                         "ttft_deadline_ms": rec.get("ttft_deadline_ms"),
                         "deadline_ms": rec.get("deadline_ms"),
                         "_origin": "resubmit"})
            self._counters["resubmitted"] += 1
        migrated = lost = 0
        lost_recs: List[Dict[str, Any]] = []
        # drain-origin records prefer geometry-matched survivors (a
        # mismatched one refuses them typed anyway); resubmit-origin
        # records regenerate from scratch with NO geometry constraint —
        # they keep the plain health/load order, never skipping a
        # healthy idle survivor for a mesh it doesn't care about
        survivors = self._survivor_order(exclude=rep.name,
                                         geometry=drained_engine)
        survivors_resubmit = (self._survivor_order(exclude=rep.name)
                              if drained_engine is not None else survivors)
        for rec in recs:
            rid = int(rec["rid"])
            origin = rec.pop("_origin", "drain")
            placed = None
            for target in (survivors if origin == "drain"
                           else survivors_resubmit):
                try:
                    # drain-origin records carry the drained engine's
                    # geometry: a mesh-mismatched survivor refuses typed
                    # (continuation determinism is per-geometry) and the
                    # next one is tried. Resubmit-origin records
                    # regenerate from scratch on whatever mesh accepts
                    # them — no geometry to honor.
                    target.accept_migration(
                        [rec], rng_counter=rng_counter, source=rep.name,
                        geometry=(drained_engine if origin == "drain"
                                  else None))
                except ResumeIncompatible:
                    continue          # too small / wrong mesh: next
                placed = target
                break
            if placed is None:
                lost += 1
                self._counters["lost"] += 1
                self._placement.pop(rid, None)
                self._records.pop(rid, None)
                lost_recs.append(rec)
                rb_events.emit("request_lost", rid=rid, replica=rep.name,
                               reason="no survivor can hold it")
                continue
            migrated += 1
            self._counters["migrated"] += 1
            self._placement[rid] = placed.name
            rb_events.emit("request_migrated", rid=rid, src=rep.name,
                           dst=placed.name, origin=origin,
                           generated=len(rec.get("generated") or []))
        if tag is not None:
            # consume the snapshot: the migrated requests now live on
            # survivors, so the tag must never count as death evidence
            # (or be resumed wholesale) again — that would double-serve.
            # Fully placed: drop the COMMITTED marker (state/manifest
            # stay on disk for post-mortems). Partially lost: REWRITE the
            # tag to hold exactly the lost records, still committed — an
            # operator bringing up a large-enough engine can
            # ServingEngine.resume() them; destroying the only durable
            # copy of accepted work is not an option.
            import json
            from deepspeed_tpu_torch.robustness import integrity
            tag_dir = os.path.join(rep.drain_dir, tag)
            integrity.invalidate(tag_dir)
            if lost_recs:
                # the residue keeps the ORIGINAL drained geometry: a
                # later whole-drain resume of these records must still
                # hit the envelope check (dropping it would silently
                # downgrade — the exact refusal the record exists for).
                # v3: lost records keep their drained trace context too
                integrity.atomic_write(
                    os.path.join(tag_dir, "state.json"),
                    json.dumps({"version": DRAIN_STATE_VERSION,
                                "source": rep.name,
                                "rng_counter": rng_counter,
                                "engine": drained_engine,
                                "failover_residue": True,
                                "requests": lost_recs}, indent=1),
                    what="failover residue write")
                integrity.write_manifest(tag_dir)
                integrity.write_commit_marker(tag_dir)
                # the residue is consumed evidence for THIS router: a
                # later blip must not re-trigger failover on it
                self._stale_tags.setdefault(rep.name, set()).add(tag)
        killed_t = getattr(rep, "killed_t", None)
        ms = (time.perf_counter() - (killed_t or t0)) * 1e3
        self._counters["failovers"] += 1
        self._counters["failover_ms"] += ms
        rb_events.emit("replica_failover", replica=rep.name, drain_tag=tag,
                       migrated=migrated, lost=lost, ms=round(ms, 2))
        self._publish_generation()

    # ---- disaggregated prefill/decode handoff --------------------------

    def _decode_targets(self, exclude: str) -> List[Any]:
        """Live decode-capable replicas (decode/both, not draining, not
        breaker-blocked), least loaded first — where a finished prefill's
        KV bytes and continuation go."""
        out = []
        for i, (name, rep) in enumerate(self.replicas.items()):
            if name == exclude or rep.dead:
                continue
            if self.config.breaker and self._breaker[name]["state"] in (
                    BREAKER_OPEN, BREAKER_DEAD):
                continue
            if getattr(rep, "partitioned", False):
                continue
            meta = (self._info.get(name) or {}).get("meta") or {}
            if meta.get("draining"):
                continue
            if self._role_of(rep) == "prefill":
                continue
            out.append((self._load_score(name, rep), i, rep))
        out.sort(key=lambda t: t[:2])
        return [rep for *_, rep in out]

    def _handoff_sweep(self) -> None:
        """Post-round disaggregation pass: every prefill-role replica's
        prefill-done requests move to the least-loaded decode replica —
        KV bytes by default (one gather + one scatter), the ordinary
        re-prefill migration when the payload is refused or the seam
        faults. With no decode tier registered the work stays put (a
        prefill-role replica never decodes, so the controller owns
        fixing that)."""
        if len(self.replicas) < 2:
            return
        if self._info_round != self._round:
            self._refresh_info()
        for name, rep in list(self.replicas.items()):
            if rep.dead or self._role_of(rep) != "prefill":
                continue
            ready = getattr(rep, "handoff_ready", None)
            if ready is None:
                continue
            rids = ready()
            if not rids:
                continue
            targets = self._decode_targets(exclude=name)
            if not targets:
                continue
            for rid in rids:
                self._handoff(rep, rid, targets)

    def _handoff(self, src, rid: int, targets: List[Any]) -> None:
        """Move one prefill-done request from ``src`` to the first decode
        target that takes it. The KV payload travels when
        ``handoff_kv`` is on and survives the fault seam; a typed
        ``ResumeIncompatible`` refusal (geometry/bits/torn checksum)
        retries the SAME target through the re-prefill path — the refusal
        is about the bytes, not the placement. Request traces stitch
        across the hop via the trace context in the release record."""
        t0 = time.perf_counter()
        payload = None
        if self.config.handoff_kv:
            payload = src.export_kv([rid]).get(rid)
        recs = src.release_requests([rid])
        if not recs:
            return
        if payload is not None:
            try:
                rb_faults.kv_handoff_seam(payload)
            except rb_faults.HandoffFault:
                # injected transfer failure: the bytes never arrive, the
                # record still does — decode-side re-prefill
                payload = None
        geometry = None
        meta = (self._info.get(src.name) or {}).get("meta") or {}
        if meta.get("tp") is not None:
            geometry = {"tp": meta.get("tp"), "ep": meta.get("ep")}
        placed = None
        kv_ok = False
        for target in targets:
            try:
                if payload is not None:
                    try:
                        target.accept_migration(recs, source=src.name,
                                                geometry=geometry,
                                                kv={rid: payload})
                        kv_ok = True
                    except ResumeIncompatible:
                        # payload refused (validated before anything was
                        # enqueued): same target, ordinary re-prefill
                        target.accept_migration(recs, source=src.name,
                                                geometry=geometry)
                else:
                    target.accept_migration(recs, source=src.name,
                                            geometry=geometry)
            except ResumeIncompatible:
                continue              # too small / wrong mesh: next
            placed = target
            break
        if placed is None:
            # released from the prefill tier but no decode replica can
            # hold it: accounted exactly like a failover loss (the
            # admission record would resubmit it if src dies; here it is
            # simply gone from the fleet)
            self._counters["lost"] += 1
            self._placement.pop(rid, None)
            self._records.pop(rid, None)
            rb_events.emit("request_lost", rid=rid, replica=src.name,
                           reason="no decode replica can hold it")
            return
        ms = (time.perf_counter() - t0) * 1e3
        self._counters["handoffs"] += 1
        self._counters["handoff_ms"] += ms
        if kv_ok:
            from deepspeed_tpu_torch.inference.kv_cache import kv_payload_nbytes
            self._counters["handoff_bytes"] += kv_payload_nbytes(
                payload["data"])
        else:
            self._counters["handoff_fallbacks"] += 1
        self._placement[rid] = placed.name
        rb_events.emit("request_handoff", schema=EVENT_SCHEMA, rid=rid,
                       src=src.name, dst=placed.name, kv=kv_ok,
                       ms=round(ms, 2))

    def decommission(self, name: str) -> None:
        """Planned scale-down (the fleet controller's lull path): SIGTERM
        drain through the replica's integrity chain, fail its in-flight
        work over to survivors — the in-process kill IS death evidence,
        so the fencing rule holds — and retire its heartbeat so dead
        registry entries don't accumulate across scale cycles."""
        rep = self.replicas[name]
        if rep.dead:
            return
        rep.kill()
        self._failover(rep)
        self._registry.retire(name)

    # ---- telemetry / introspection -----------------------------------

    def _drain_events(self) -> None:
        """Round-boundary drain of the process-wide pending event queue
        into the router's JSONL sink (replica engines should run WITHOUT
        their own sink under a router, so this is the one drainer)."""
        if self._jsonl is None or not self._jsonl.enabled:
            return
        recs = rb_events.drain()
        if recs:
            self._jsonl.write_records(recs)

    def replica_inflight(self) -> Dict[str, int]:
        """Router-side view: how many admitted-but-unfinished requests the
        router currently attributes to each replica. A dead/blackholed
        replica's count can only fall through failover."""
        out = {name: 0 for name in self.replicas}
        for name in self._placement.values():
            if name in out:
                out[name] += 1
        return out

    def breaker_state(self, name: str) -> str:
        return self._breaker[name]["state"]

    @property
    def done(self) -> bool:
        if self._placement:
            return False
        return all(rep.dead or rep.done for rep in self.replicas.values())

    def run(self, requests, max_new_tokens: int = 64,
            max_rounds: int = 100000) -> Dict[int, np.ndarray]:
        """Submit-and-drain convenience: feeds the request list (prompt
        arrays or (prompt, max_new) tuples), retrying all-saturated sheds
        at later rounds (router-level shed is backpressure, not loss),
        and steps until every admitted request finished. Returns
        {rid: output ids}."""
        pending = collections.deque(
            r if isinstance(r, tuple) else (r, max_new_tokens)
            for r in requests)
        outs: Dict[int, np.ndarray] = {}
        rounds = 0
        while pending or not self.done:
            while pending:
                prompt, n = pending[0]
                try:
                    self.add_request(prompt, n)
                except AdmissionRejected as e:
                    if e.reason == "too_long":
                        pending.popleft()   # permanent: no replica can
                        continue            # ever hold it (counted shed)
                    break              # all saturated: retry next round
                pending.popleft()
            for r in self.step():
                outs[r.rid] = r.output
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError(
                    f"router run did not converge ({rounds} rounds)")
        return outs

    def reset_stats(self) -> None:
        """Start a fresh measurement window (the ServingEngine contract,
        extended to FLEET scope): TTFT records and counters
        reset, every live replica's engine window resets and re-publishes
        its heartbeat (so the rollup's histograms restart too), and dead
        replicas' frozen drained stats leave the window (their history
        belongs to the window that watched them die). Registry, breaker
        state, and outstanding placements are untouched."""
        self._ttfts = []
        self._counters = {k: (0.0 if isinstance(v, float) else 0)
                          for k, v in self._counters.items()}
        for name, rep in self.replicas.items():
            eng = getattr(rep, "engine", None)
            if rep.dead:
                # the store still holds its last heartbeat; exclude it
                # from rollups instead of rewriting history on disk
                self._obs_excluded.add(name)
            elif eng is not None and hasattr(eng, "reset_stats"):
                eng.reset_stats()
                rep.publish()
        self._refresh_info()

    # ---- fleet rollup ----------------------------------------------

    def fleet_stats(self) -> Dict[str, Any]:
        """One pod-level snapshot: per-replica heartbeat ``obs`` payloads
        (live replicas contribute their CURRENT engine state; dead ones
        their last-seen heartbeat — the drained stats) merged into fleet
        histograms, plus liveness and the summed completion counters.
        Histogram values are ``telemetry.Histogram`` — feed the dict to
        ``exposition()``/``render_prometheus`` for a scrape."""
        from deepspeed_tpu_torch.telemetry.exposition import (DEFAULT_EDGES_MS,
                                                        DEPTH_EDGES,
                                                        FRACTION_EDGES,
                                                        Histogram)
        self._refresh_info()
        ttft, itl = Histogram(DEFAULT_EDGES_MS), Histogram(DEFAULT_EDGES_MS)
        qdepth = Histogram(DEPTH_EDGES)
        pool_occ = Histogram(FRACTION_EDGES)
        adapter_occ = Histogram(FRACTION_EDGES)
        live = 0
        roles = {"prefill": 0, "decode": 0, "both": 0}
        totals = {"completed": 0, "cancelled": 0, "generated_tokens": 0,
                  "adapter_page_ins": 0}
        for name, rep in self.replicas.items():
            meta = (self._info.get(name) or {}).get("meta") or {}
            obs = meta.get("obs")
            eng = getattr(rep, "engine", None)
            if not rep.dead and eng is not None \
                    and hasattr(eng, "obs_meta"):
                obs = eng.obs_meta()     # fresher than the last heartbeat
            if rep.dead and name in self._obs_excluded:
                obs = None               # pre-reset history
            if not rep.dead:
                live += 1
                roles[self._role_of(rep)] += 1
                # gauges are now-facts of the LIVE fleet — a dead
                # replica's queue depth is not depth anyone waits in
                qdepth.observe(float(meta.get("queue_depth", 0)))
                if obs and obs.get("pool_occupancy") is not None:
                    pool_occ.observe(float(obs["pool_occupancy"]))
                if obs and obs.get("adapter_occupancy") is not None:
                    adapter_occ.observe(float(obs["adapter_occupancy"]))
            if obs:
                for key, h in (("ttft_ms_hist", ttft),
                               ("itl_ms_hist", itl)):
                    part = Histogram.from_dict(obs.get(key))
                    if part is not None and part.edges == h.edges:
                        h.merge(part)
                for key in totals:
                    totals[key] += int(obs.get(key) or 0)
        out: Dict[str, Any] = {
            "fleet_replicas": len(self.replicas),
            "fleet_live": live,
            # role gauges of the LIVE fleet: the autoscaler's
            # view of the tier it manages
            "fleet_prefill_replicas": roles["prefill"],
            "fleet_decode_replicas": roles["decode"],
            "fleet_both_replicas": roles["both"],
            "fleet_ttft_ms": ttft,
            "fleet_itl_ms": itl,
            "fleet_queue_depth": qdepth,
            "fleet_pool_occupancy": pool_occ,
            "fleet_adapter_occupancy": adapter_occ,
        }
        out.update({f"fleet_{k}": v for k, v in totals.items()})
        return out

    def exposition(self, prefix: str = "dstpu") -> str:
        """Prometheus text exposition of the fleet: router counters +
        the ``fleet_stats`` rollup. Serve the returned string from any
        HTTP handler and the pod is a scrape target."""
        from deepspeed_tpu_torch.telemetry.exposition import render_prometheus
        metrics: Dict[str, Any] = dict(self.stats())
        metrics.update(self.fleet_stats())
        return render_prometheus(metrics, prefix=prefix)

    def stats(self) -> Dict[str, float]:
        """Spill/failover/SLO counters across the router's lifetime plus
        TTFT percentiles over every request the router saw finish (TTFT
        of a migrated request is measured from its re-admission — the
        drain reset its clock, exactly like preemption resume)."""
        healthy = sum(1 for n, rep in self.replicas.items()
                      if not rep.dead
                      and self._breaker[n]["state"] == BREAKER_CLOSED)
        out: Dict[str, float] = {
            "replicas": float(len(self.replicas)),
            "healthy": float(healthy),
            "rounds": float(self._round),
        }
        for k, v in self._counters.items():
            out[k] = float(round(v, 3) if isinstance(v, float) else v)
        n_f = int(self._counters["failovers"])
        out["failover_ms"] = float(
            round(self._counters["failover_ms"] / n_f, 2)) if n_f else 0.0
        n_h = int(self._counters["handoffs"])
        out["handoff_ms"] = float(
            round(self._counters["handoff_ms"] / n_h, 2)) if n_h else 0.0
        attempts = self._counters["admitted"] + self._counters["shed"]
        out["spill_rate"] = float(
            round(self._counters["spilled"] / attempts, 4)) if attempts \
            else 0.0
        out["lost_requests"] = out.pop("lost")
        if self._ttfts:
            t = np.asarray(self._ttfts)
            out["p50_ttft_ms"] = float(np.percentile(t, 50))
            out["p99_ttft_ms"] = float(np.percentile(t, 99))
        return out

"""Deterministic, seedable fault injection at the runtime's seams, the
port's copy of ``deepspeed_tpu/robustness/faults.py`` (host only): the same
``FaultSchedule`` and seed fire at the same indices in both packages.

A ``FaultSchedule`` (config section ``robustness.faults``) drives a
``FaultInjector`` that fires exactly reproducible faults at these seams:

  step seam       — ``step(n)`` before global step n: a ``device_fault``
                    raises there and arms the health-probe cull below
  probe seam      — ``cull(devices)`` hides ``survivors``.. devices for the
                    next ``probes`` consults
                    (both belong to the elastic training agent, ROADMAP
                    A11: they are ported with the module and nothing in
                    the port calls them yet)
  I/O seams       — ``io_seam(category, path, offset)`` inside the
                    checkpoint chain raises scheduled ``OSError``s (EIO,
                    ENOSPC, …); transient ones are absorbed by
                    ``retry_io``, terminal ones reach the caller
  commit seam     — a ``torn_save`` raises at the ``ckpt_commit`` seam:
                    payload durable, COMMITTED never written — exactly the
                    crash-between-write-and-commit shape
  corrupt seam    — ``corrupt_payload`` truncates a manifest-listed file
                    after the manifest is written (bitrot: committed but
                    checksum-invalid)
  preemption      — delivers a real SIGTERM to this process at step n
                    (training: ``step`` key, read by the training engine;
                    serving: ``round`` key — the ServingEngine drains
                    through its ``PreemptionHandler``)
  clock           — ``make_clock(base)`` wraps the rendezvous' injectable
                    clock with scheduled skew (a skewed host reads its peers
                    as dead / itself as live: heartbeat loss without
                    touching the store)

Serving seams (the serving engine calls these at its round boundaries;
``at``/``round`` count the seam's own 0-based INVOCATION index, exactly
like the I/O seams count ops — recovery retries re-invoke the seams, so an
index is "rounds attempted", not "rounds committed", and a fault that
triggers a recovery shifts every later index by one attempt):

  decode_dispatch — ``dispatch_seam()`` inside the watchdog-guarded quantum
                    dispatch: mode "fail" (default) raises DispatchFault (a
                    failed dispatch); mode "hang" sleeps ``hang_s`` so the
                    engine's dispatch watchdog times the round out — both
                    recover by rebuilding the batch from host-side cursors
  pool_exhaust    — ``serving_round_seam()`` returns a squeeze: the engine
                    hides (free - keep) blocks from the allocator for the
                    round, forcing a REAL exhaustion storm through the
                    scheduler's queue/preempt paths
  backend_fault   — ``serving_round_seam()`` raises BackendFault (a decode
                    kernel failure). JAX's engine degrades to its gather
                    backend here; the port has one decode backend, the
                    paged decode kernel, so it recovers the round like any
                    other failure and the retry runs the same kernel

Router seams (the multi-replica ``ServingRouter`` consults
``router_seam()`` once per routing round; ``at`` counts 0-based router
rounds, independent of the per-engine ``serving_round`` counter):

  replica_kill    — SIGTERM-equivalent on one replica: its engine drains
                    through the integrity chain, its heartbeats stop,
                    and the router must detect the loss and resume the
                    drained requests on survivors (in-flight migration)
  heartbeat_loss  — the replica stays alive and reachable but its
                    heartbeats are suppressed for ``times`` rounds: the
                    router's breaker must OPEN (``replica_degraded``) and,
                    with no drain snapshot and no death evidence, must NOT
                    migrate (fencing: never double-serve live work) —
                    recovery closes via the half-open probe
  router_partition — the replica is alive but unreachable from the router
                    for ``times`` rounds (dispatches raise); the first
                    partitioned round also writes a TORN newest generation
                    manifest into the rendezvous store, so the registry's
                    generation reads during the partition exercise the
                    ``FileRendezvous.current_generation`` fallback

Handoff seam (the router consults ``kv_handoff_seam(payload)`` once per
disaggregated KV handoff, AFTER export and BEFORE the decode replica
imports; ``at`` counts 0-based handoff attempts):

  kv_handoff      — mode "fail" (default) raises HandoffFault: the bytes
                    never arrive, the record still does — the router falls
                    back to the ordinary re-prefill migration; mode
                    "corrupt" flips bytes in the payload in place (a torn
                    transfer): the importer's crc32 check MUST refuse it
                    typed and fall back — a corrupted payload must never
                    decode garbage

Every kind emits ``fault_injected`` plus its recovery record. Schedules
are deterministic by construction: explicit entries fire at exact
step/op indices, and the optional ``seed`` only feeds probabilistic rates
through a private ``numpy`` Generator — same seed, same faults, every run.
"""

import errno as _errno
import logging
import os
import signal
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.robustness import events

logger = logging.getLogger("deepspeed_tpu_torch")

_ERRNO_BY_NAME = {"EIO": _errno.EIO, "ENOSPC": _errno.ENOSPC,
                  "EAGAIN": _errno.EAGAIN, "EBUSY": _errno.EBUSY,
                  "ETIMEDOUT": _errno.ETIMEDOUT}

KINDS = ("device_fault", "step_fault", "io_error", "torn_save",
         "corrupt_payload", "preempt", "clock_skew",
         "decode_dispatch", "pool_exhaust", "backend_fault",
         "replica_kill", "heartbeat_loss", "router_partition",
         "kv_handoff")

ROUTER_KINDS = ("replica_kill", "heartbeat_loss", "router_partition")


class DispatchFault(RuntimeError):
    """Injected decode-dispatch failure (the serving engine's recovery
    path treats it exactly like a real failed dispatch)."""


class BackendFault(RuntimeError):
    """Injected decode-kernel failure: the serving engine recovers the
    round (preempt all, zero the pools) and retries it through the same
    paged decode kernel."""


class HandoffFault(RuntimeError):
    """Injected KV-handoff transfer failure (mode "fail"): the payload is
    lost in flight — the router hands the request off WITHOUT it and the
    decode replica re-prefills."""


class FaultSchedule:
    """Normalized list of fault entries + a seeded RNG for rate-based ones.

    Entry keys (dicts, from config ``robustness.faults.entries``):
      kind            one of KINDS (required)
      step            1-based global optimizer step (step/device faults,
                      preempt)
      op              I/O seam category the fault targets (io_error;
                      default matches any category)
      at              0-based operation index within that category
                      (io_error / torn_save / corrupt_payload; torn and
                      corrupt count ``ckpt_commit`` seam hits, i.e. saves)
      times           consecutive operations affected (io_error; default 1 —
                      with retry attempts > times the fault is transient)
      errno           symbolic ("EIO", "ENOSPC", …) or int (default EIO)
      survivors       device count the armed cull reports (device_fault)
      probes          health consults the cull stays armed for
                      (device_fault; default 1 = transient blip)
      skew_s / after  clock_skew: add skew_s seconds after `after` reads
      round           preempt only: 0-based serving round-seam invocation
                      (the serving alternative to `step`; recovery retries
                      advance it — see "Serving seams" above)
      mode / hang_s   decode_dispatch: "fail" (default, raises) or "hang"
                      (sleeps hang_s, default 30 — the engine's dispatch
                      watchdog must time it out); kv_handoff: "fail"
                      (default, raises HandoffFault — payload lost in
                      flight) or "corrupt" (flips payload bytes in place —
                      the importer's crc32 must refuse it typed); for
                      kv_handoff `at` counts 0-based handoff attempts
      keep            pool_exhaust: free blocks left visible during the
                      storm (default 0 = total exhaustion)
      replica         router kinds only (required): 0-based registration
                      index of the target replica; `at` counts router
                      rounds, `times` holds a heartbeat_loss /
                      router_partition condition for that many rounds
                      (replica_kill fires once — death is permanent)
      rate            instead of step/at: per-opportunity probability drawn
                      from the schedule seed (still deterministic)
    """

    def __init__(self, entries: Sequence[Dict[str, Any]] = (), seed: int = 0):
        self.seed = int(seed)
        self.entries: List[Dict[str, Any]] = []
        for i, raw in enumerate(entries):
            e = dict(raw)
            kind = e.get("kind")
            if kind not in KINDS:
                raise ValueError(f"faults.entries[{i}]: unknown kind {kind!r}"
                                 f" (choose from {KINDS})")
            # an entry with no trigger would validate and then never fire —
            # a chaos schedule that silently tests nothing
            if kind in ("device_fault", "step_fault") and "step" not in e:
                raise ValueError(f"faults.entries[{i}] ({kind}): needs "
                                 "'step' (1-based global step)")
            if kind == "preempt" and "step" not in e and "round" not in e:
                raise ValueError(f"faults.entries[{i}] ({kind}): needs "
                                 "'step' (1-based global step) or 'round' "
                                 "(0-based serving round-seam invocation)")
            if kind in ("io_error", "torn_save", "corrupt_payload",
                        "decode_dispatch", "pool_exhaust", "backend_fault",
                        "kv_handoff") \
                    + ROUTER_KINDS \
                    and "at" not in e and "rate" not in e:
                raise ValueError(f"faults.entries[{i}] ({kind}): needs 'at' "
                                 "(0-based op index) or 'rate'")
            if kind in ROUTER_KINDS:
                # the router applies these to a specific replica; an entry
                # without one would silently always hit replica 0 — make
                # the target explicit so chaos schedules read unambiguously
                if "replica" not in e:
                    raise ValueError(f"faults.entries[{i}] ({kind}): needs "
                                     "'replica' (0-based registration "
                                     "index)")
            err = e.get("errno", "EIO")
            e["errno"] = _ERRNO_BY_NAME.get(err, err) if isinstance(err, str) \
                else int(err)
            e.setdefault("times", 1)
            self.entries.append(e)

    @classmethod
    def from_config(cls, cfg) -> "FaultSchedule":
        """cfg: a FaultsConfig (config section ``robustness.faults``)."""
        return cls(entries=cfg.entries, seed=cfg.seed)


class FaultInjector:
    """Executes a FaultSchedule against the instrumented seams. Counters and
    the fired-fault log make every run's fault sequence auditable."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.counters: Dict[str, int] = {}
        self.fired: List[Dict[str, Any]] = []
        self._armed_culls: List[Dict[str, Any]] = []
        self._rng = np.random.default_rng(schedule.seed)

    # -- bookkeeping ---------------------------------------------------
    def _fire(self, entry: Dict[str, Any], seam: str, **ctx):
        rec = {"kind": entry["kind"], "seam": seam, **ctx}
        self.fired.append(rec)
        events.emit("fault_injected", **rec)

    def _count(self, category: str) -> int:
        n = self.counters.get(category, 0)
        self.counters[category] = n + 1
        return n

    def _matches_index(self, e: Dict[str, Any], idx: int) -> bool:
        if "at" in e:
            return e["at"] <= idx < e["at"] + e["times"]
        rate = e.get("rate")
        return rate is not None and self._rng.random() < rate

    # -- step seam (elastic agent) -------------------------------------
    def step(self, global_step: int) -> None:
        """Called with the 1-based step about to be dispatched. Raises for
        scheduled device/step faults; delivers scheduled preemptions."""
        for e in self.schedule.entries:
            if e.get("step") != global_step or e.get("_done"):
                continue
            if e["kind"] == "preempt":
                e["_done"] = True
                self._fire(e, "step", step=global_step,
                           signal="SIGTERM")
                os.kill(os.getpid(), signal.SIGTERM)
            elif e["kind"] in ("device_fault", "step_fault"):
                e["_done"] = True
                if e["kind"] == "device_fault":
                    self._armed_culls.append({
                        "survivors": int(e.get("survivors", 0)),
                        "probes": int(e.get("probes", 1))})
                self._fire(e, "step", step=global_step)
                raise RuntimeError(
                    f"injected {e['kind']} at step {global_step} "
                    "(robustness.faults)")

    # -- probe seam (elastic agent health checks) ----------------------
    def cull(self, devices: List) -> List:
        """While a device fault is armed, hide the dead devices from the
        health probe for the configured number of consults."""
        if not self._armed_culls:
            return devices
        armed = self._armed_culls[0]
        armed["probes"] -= 1
        if armed["probes"] <= 0:
            self._armed_culls.pop(0)
        n = armed["survivors"]
        return list(devices)[:n] if n < len(devices) else list(devices)

    # -- I/O seams ------------------------------------------------------
    def op(self, category: str, path: Optional[str] = None,
           offset: Optional[int] = None) -> None:
        idx = self._count(category)
        for e in self.schedule.entries:
            if e["kind"] == "io_error" and e.get("op", category) == category \
                    and self._matches_index(e, idx):
                self._fire(e, category, path=path, offset=offset, index=idx)
                raise OSError(e["errno"],
                              f"injected io_error ({category}) "
                              "(robustness.faults)")
            if e["kind"] == "torn_save" and category == "ckpt_commit" \
                    and self._matches_index(e, idx):
                self._fire(e, category, path=path, index=idx)
                raise OSError(_errno.EIO,
                              "injected torn save: crash before commit "
                              "marker (robustness.faults)")

    def mutate_tag(self, tag_dir: str) -> None:
        """corrupt_payload seam: truncate the largest manifest-listed file
        of the `at`-th committed save (fires after the manifest, before the
        commit marker — a committed-but-bitrotten tag)."""
        idx = self._count("ckpt_mutate")
        for e in self.schedule.entries:
            if e["kind"] != "corrupt_payload" or not self._matches_index(e, idx):
                continue
            victims = []
            for root, _d, files in os.walk(tag_dir):
                for fn in files:
                    if fn in ("manifest.json", "COMMITTED"):
                        continue
                    p = os.path.join(root, fn)
                    victims.append((os.path.getsize(p), p))
            if not victims:
                continue
            _, victim = max(victims)
            keep = max(0, os.path.getsize(victim) // 2)
            with open(victim, "r+b") as f:
                f.truncate(keep)
            self._fire(e, "ckpt_mutate", path=victim, index=idx,
                       truncated_to=keep)

    # -- serving seams (ServingEngine scheduling rounds) ----------------
    def serving_round(self) -> Dict[str, Any]:
        """Round-boundary seam, called once per scheduling-round ATTEMPT
        (recovery retries included) BEFORE the admission/growth decisions.
        Delivers round-keyed preemptions (SIGTERM), raises scheduled
        BackendFaults, and returns the round's pool squeeze
        ({"squeeze": blocks-to-keep-visible or None})."""
        idx = self._count("serving_round")
        squeeze = None
        for e in self.schedule.entries:
            kind = e["kind"]
            if kind == "preempt" and e.get("round") == idx \
                    and not e.get("_done"):
                e["_done"] = True
                self._fire(e, "serving_round", round=idx, signal="SIGTERM")
                os.kill(os.getpid(), signal.SIGTERM)
            elif kind == "backend_fault" and self._matches_index(e, idx):
                self._fire(e, "serving_round", round=idx)
                raise BackendFault(
                    f"injected backend_fault at serving round {idx} "
                    "(robustness.faults)")
            elif kind == "pool_exhaust" and self._matches_index(e, idx):
                keep = int(e.get("keep", 0))
                self._fire(e, "serving_round", round=idx, keep=keep)
                squeeze = keep if squeeze is None else min(squeeze, keep)
        return {"squeeze": squeeze}

    def decode_dispatch(self) -> None:
        """Dispatch seam, called inside the engine's watchdog-guarded
        quantum dispatch. "fail" raises (failed dispatch); "hang" sleeps
        past the watchdog (hung dispatch) — the watchdog's timeout, not
        this sleep, is what the engine recovers from."""
        import time as _time
        idx = self._count("decode_dispatch")
        for e in self.schedule.entries:
            if e["kind"] != "decode_dispatch" \
                    or not self._matches_index(e, idx):
                continue
            mode = e.get("mode", "fail")
            self._fire(e, "decode_dispatch", index=idx, mode=mode)
            if mode == "hang":
                _time.sleep(float(e.get("hang_s", 30.0)))
            else:
                raise DispatchFault(
                    f"injected decode_dispatch failure (op {idx}) "
                    "(robustness.faults)")

    # -- router seams (ServingRouter routing rounds) ---------------------
    def router_round(self, store_dir: Optional[str] = None
                     ) -> List[Dict[str, Any]]:
        """Router round-boundary seam, called once per routing round. Returns
        this round's scheduled router fault actions
        ``[{"kind", "replica"}, ...]`` — the router applies them to its
        handles (kill / mute heartbeat / partition for THIS round; a held
        condition fires every round of its ``times`` window so the handle
        needs no countdown state). The first ``router_partition`` round also
        tears the newest rendezvous generation manifest (see module
        docstring)."""
        idx = self._count("router_round")
        actions: List[Dict[str, Any]] = []
        for e in self.schedule.entries:
            if e["kind"] not in ROUTER_KINDS \
                    or not self._matches_index(e, idx):
                continue
            if e["kind"] == "replica_kill":
                if e.get("_done"):
                    continue
                e["_done"] = True
            if e["kind"] == "router_partition" and store_dir \
                    and not e.get("_torn"):
                e["_torn"] = True
                self._tear_newest_manifest(store_dir)
            act = {"kind": e["kind"], "replica": int(e["replica"])}
            self._fire(e, "router_round", round=idx, **act)
            actions.append(act)
        return actions

    def kv_handoff(self, payload: Dict[str, Any]) -> None:
        """Handoff seam (disaggregated serving): called once per KV
        handoff attempt with the exported payload. "fail" raises
        HandoffFault (the router falls back to re-prefill); "corrupt"
        flips bytes in the largest payload buffer IN PLACE — the
        importing engine's crc32 check must refuse the torn payload
        typed, never scatter it."""
        idx = self._count("kv_handoff")
        for e in self.schedule.entries:
            if e["kind"] != "kv_handoff" or not self._matches_index(e, idx):
                continue
            mode = e.get("mode", "fail")
            self._fire(e, "kv_handoff", index=idx, mode=mode)
            if mode == "corrupt":
                data = payload.get("data") or {}
                if not data:
                    continue
                name = max(data, key=lambda k: data[k].nbytes)
                flat = data[name].reshape(-1).view(np.uint8)
                flat[: max(1, flat.size // 16)] ^= 0xFF
            else:
                raise HandoffFault(
                    f"injected kv_handoff failure (handoff {idx}) "
                    "(robustness.faults)")

    @staticmethod
    def _tear_newest_manifest(store_dir: str) -> None:
        """Write a TRUNCATED ``gen_<N+1>.json`` (a torn manifest write that
        never finished, NOT a ``.tmp.`` temp) so every generation read during
        the partition must fall back to the newest READABLE manifest — the
        exact ``FileRendezvous.current_generation`` walk-back.
        The next real publish heals it by replacing the same filename."""
        try:
            gens = sorted(fn for fn in os.listdir(store_dir)
                          if fn.startswith("gen_") and ".tmp." not in fn
                          and fn.endswith(".json"))
            n = (int(gens[-1][len("gen_"):-len(".json")]) + 1) if gens else 0
            with open(os.path.join(store_dir, f"gen_{n:08d}.json"), "w") as f:
                f.write('{"generation": ')          # torn mid-write
        except (OSError, ValueError):
            pass            # an unwritable store is its own fault, not ours

    # -- clock seam (rendezvous) ---------------------------------------
    def make_clock(self, base=None):
        """Wrap a clock with scheduled skew: after `after` reads, add
        ``skew_s`` seconds — the file-rendezvous sees heartbeats age out
        (host death / heartbeat loss) without any store mutation."""
        import time as _time
        base = base or _time.time
        skews = [dict(e) for e in self.schedule.entries
                 if e["kind"] == "clock_skew"]
        state = {"reads": 0}

        def clock() -> float:
            t = base()
            state["reads"] += 1
            for e in skews:
                if state["reads"] > e.get("after", 0):
                    if not e.get("_seen"):
                        e["_seen"] = True
                        self._fire(e, "clock", reads=state["reads"])
                    t += float(e.get("skew_s", 0.0))
            return t
        return clock


# -- global install (the seams consult this) ----------------------------
# The injector is PROCESS-global by design: an elastic rebuild constructs a
# fresh engine mid-run and must keep the schedule's counters. Consequence:
# a later engine with `robustness.faults.enabled: false` does NOT disarm an
# already-armed injector — call faults.clear() to stop injecting.
_ACTIVE: Optional[FaultInjector] = None
_ACTIVE_CFG_KEY: Optional[str] = None  # set only for config-armed injectors


def install(injector: Optional[FaultInjector]) -> Optional[FaultInjector]:
    global _ACTIVE, _ACTIVE_CFG_KEY
    _ACTIVE = injector
    _ACTIVE_CFG_KEY = None
    return injector


def install_from_config(faults_cfg) -> Optional[FaultInjector]:
    """Engine-init hook: build + install from ``robustness.faults``. A
    rebuild with the SAME schedule keeps the live injector (counters
    survive the rescale); a DIFFERENT schedule replaces it; a manually
    install()ed injector (test harness) is never replaced."""
    global _ACTIVE_CFG_KEY
    if not getattr(faults_cfg, "enabled", False):
        return _ACTIVE
    import json as _json
    key = _json.dumps({"seed": faults_cfg.seed,
                       "entries": faults_cfg.entries},
                      sort_keys=True, default=str)
    if _ACTIVE is None or (_ACTIVE_CFG_KEY is not None
                           and _ACTIVE_CFG_KEY != key):
        if _ACTIVE is not None:
            logger.warning("robustness: replacing the active fault "
                           "injector — the config schedule changed")
        logger.warning("robustness: fault injection ENABLED "
                       f"({len(faults_cfg.entries)} scheduled entries, "
                       f"seed={faults_cfg.seed})")
        install(FaultInjector(FaultSchedule.from_config(faults_cfg)))
        _ACTIVE_CFG_KEY = key
    return _ACTIVE


def active() -> Optional[FaultInjector]:
    return _ACTIVE


def clear() -> None:
    install(None)


def io_seam(category: str, path: Optional[str] = None,
            offset: Optional[int] = None) -> None:
    """Production-code hook: a no-op unless an injector is installed."""
    if _ACTIVE is not None:
        _ACTIVE.op(category, path, offset)


def mutate_seam(tag_dir: str) -> None:
    if _ACTIVE is not None:
        _ACTIVE.mutate_tag(tag_dir)


def serving_round_seam() -> Dict[str, Any]:
    """ServingEngine round-boundary hook: a no-op unless an injector is
    installed. May raise BackendFault or deliver SIGTERM; returns the
    round's pool squeeze decision."""
    if _ACTIVE is not None:
        return _ACTIVE.serving_round()
    return {"squeeze": None}


def dispatch_seam() -> None:
    """ServingEngine decode-dispatch hook (inside the watchdog guard)."""
    if _ACTIVE is not None:
        _ACTIVE.decode_dispatch()


def kv_handoff_seam(payload: Dict[str, Any]) -> None:
    """ServingRouter KV-handoff hook: a no-op unless an injector is
    installed. May raise HandoffFault (payload lost in flight) or corrupt
    the payload in place (torn transfer — the importer's checksum is the
    last line of defense)."""
    if _ACTIVE is not None:
        _ACTIVE.kv_handoff(payload)


def router_seam(store_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    """ServingRouter round-boundary hook: a no-op (empty action list) unless
    an injector is installed. ``store_dir`` is the rendezvous store a
    ``router_partition`` tears its manifest into."""
    if _ACTIVE is not None:
        return _ACTIVE.router_round(store_dir)
    return []

"""Per-request tracing for the serving fleet, the port's copy of
``deepspeed_tpu/telemetry/request_trace.py`` (stdlib only).

A request-centric timeline: every request carries a trace id from
admission to finish and accumulates host-wall-clock spans for each phase
it passes through (admission, queue wait, each prefill or prefill chunk,
each decode quantum it takes part in, preemption and re-prefill, adapter
page-in, KV import and export, drain and migration).

Design rules, in priority order:

* **Zero added device syncs.** Span bookkeeping is two ``perf_counter``
  calls and a deque append — no ``device_get``, no ``block_until_ready``.
  A tracing-armed engine is bit-identical to an untraced one. The
  ``on_span`` hook is the documented defect seam: anything it does per
  span is on the caller, and :data:`device_syncs` counts self-reported
  syncs so an overhead check can name the offender.
* **Stitching across replicas.** Timestamps are anchored to the UNIX epoch
  (``time.time() - perf_counter()`` captured once at construction), so
  per-replica streams share one time axis. :meth:`RequestTracer.context`
  serializes a request's trace (id + spans) into the drain-state v3 record;
  :meth:`RequestTracer.adopt` on the destination replica re-appends those
  spans under the SAME trace id with their ORIGINAL replica tag — the
  merged Chrome trace shows one continuous trace spanning both process
  rows.
* **Bounded.** Events live in a ring (default 65536); a hot fleet cannot
  grow host memory without bound. Finished requests' id bookkeeping is
  dropped on :meth:`end`.

Export is Chrome-trace JSON ("traceEvents"): one *process* row per replica
(``merge_chrome_trace`` assigns pids and emits ``process_name`` metadata),
one *thread* row per request within its replica, ``args.trace`` carrying
the trace id so Perfetto's flow queries can follow a migration.
"""

import collections
import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

__all__ = ["RequestTracer", "merge_chrome_trace", "TRACE_SCHEMA"]

#: the merged trace's version key: the one top-level key JAX's export does
#: not write (Chrome and Perfetto ignore it)
TRACE_SCHEMA = 1


class RequestTracer:
    """Host-clock span recorder keyed by request id.

    ``replica`` tags every span (and becomes the process row at export);
    ``on_span`` is an optional per-span callback (keep it host-only: a
    device sync there is overhead on every span). If the hook performs a device sync it must account for
    it by incrementing :data:`device_syncs`; the built-in paths never do.
    """

    def __init__(self, replica: str = "r0", max_events: int = 65536,
                 on_span: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.replica = str(replica)
        self.events: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=max(64, int(max_events)))
        self.on_span = on_span
        self.device_syncs = 0        # self-reported by leaky on_span hooks
        self._seq = 0                # per-tracer trace-id sequence
        self._ids: Dict[str, str] = {}       # rid -> trace id
        # one wall-clock anchor per tracer: perf_counter deltas become
        # unix-epoch microseconds, so independently-started replicas merge
        # on a single time axis without any cross-host coordination
        self._anchor = time.time() - time.perf_counter()

    # -- lifecycle -------------------------------------------------------
    def begin(self, rid: str, trace_id: Optional[str] = None) -> str:
        """Open (or re-open, for resubmission) a request's trace. Returns
        the trace id — deterministic ``<replica>/<rid>.<seq>`` unless an
        inherited id is supplied (migration adoption goes through
        :meth:`adopt` instead)."""
        if trace_id is None:
            trace_id = self._ids.get(rid)
        if trace_id is None:
            trace_id = f"{self.replica}/{rid}.{self._seq}"
            self._seq += 1
        self._ids[rid] = trace_id
        return trace_id

    def trace_id(self, rid: str) -> Optional[str]:
        return self._ids.get(rid)

    def end(self, rid: str) -> None:
        """Drop id bookkeeping for a finished/cancelled request. Its spans
        stay in the ring until evicted."""
        self._ids.pop(rid, None)

    # -- recording -------------------------------------------------------
    def _now(self) -> float:
        return self._anchor + time.perf_counter()

    def epoch(self, perf_t: float) -> float:
        """Convert a ``time.perf_counter()`` stamp (the scheduler's
        ``submit_t`` basis) to this tracer's unix-epoch seconds."""
        return self._anchor + perf_t

    def _append(self, ev: Dict[str, Any]) -> None:
        self.events.append(ev)
        if self.on_span is not None:
            self.on_span(ev)

    def add_span(self, rid: str, name: str, t0: float, t1: float,
                 cat: str = "serve", **args: Any) -> None:
        """Record a completed span from explicit HOST wall-clock seconds
        (unix epoch — pass ``submit_t``-style stamps directly). Used for
        phases whose start predates the tracer call site (queue wait)."""
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": t0 * 1e6, "dur": max(0.0, (t1 - t0)) * 1e6,
              "replica": self.replica, "trace": self._ids.get(rid, rid),
              "rid": rid}
        if args:
            ev["args"] = args
        self._append(ev)

    @contextlib.contextmanager
    def span(self, rid: str, name: str, cat: str = "serve", **args: Any):
        t0 = self._now()
        try:
            yield
        finally:
            self.add_span(rid, name, t0, self._now(), cat=cat, **args)

    def instant(self, rid: str, name: str, **args: Any) -> None:
        ev = {"name": name, "cat": "event", "ph": "i", "s": "t",
              "ts": self._now() * 1e6,
              "replica": self.replica, "trace": self._ids.get(rid, rid),
              "rid": rid}
        if args:
            ev["args"] = args
        self._append(ev)

    # -- migration stitching ---------------------------------------------
    def context(self, rid: str) -> Dict[str, Any]:
        """Serializable trace context for a drain-state v3 record: the
        trace id plus every span recorded for the request SO FAR (original
        replica tags kept — the destination must not rewrite history)."""
        tid = self._ids.get(rid, f"{self.replica}/{rid}.?")
        return {"id": tid,
                "spans": [dict(e) for e in self.events
                          if e.get("rid") == rid]}

    def adopt(self, rid: str, ctx: Optional[Dict[str, Any]]) -> str:
        """Resume a migrated request's trace on THIS replica: inherit the
        trace id and re-append the source replica's spans verbatim so a
        single export from the destination still shows the whole life."""
        if not ctx:
            return self.begin(rid)
        tid = str(ctx.get("id") or f"{self.replica}/{rid}.{self._seq}")
        self._ids[rid] = tid
        for ev in ctx.get("spans") or []:
            e = dict(ev)
            e.setdefault("replica", "?")
            e["trace"] = tid
            e["rid"] = rid
            self.events.append(e)   # no on_span: history, not new activity
        return tid

    # -- export ----------------------------------------------------------
    def export(self) -> Dict[str, Any]:
        """One replica's stream, mergeable by :func:`merge_chrome_trace`."""
        return {"replica": self.replica, "events": list(self.events)}


def merge_chrome_trace(streams: Iterable[Dict[str, Any]],
                       path: Optional[str] = None) -> Dict[str, Any]:
    """Merge per-replica streams (``RequestTracer.export`` dicts) into one
    Chrome-trace JSON. Each distinct replica tag — including tags carried
    by ADOPTED spans from a replica that no longer exists — gets its own
    process row; requests are thread rows within a replica. A migrated
    request appears in two process rows under one ``args.trace`` id."""
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    out: List[Dict[str, Any]] = []

    def pid_of(rep: str) -> int:
        if rep not in pids:
            pids[rep] = len(pids) + 1
            out.append({"name": "process_name", "ph": "M", "pid": pids[rep],
                        "tid": 0, "args": {"name": f"replica {rep}"}})
        return pids[rep]

    for stream in streams:
        default_rep = str(stream.get("replica", "?"))
        for ev in stream.get("events", []):
            rep = str(ev.get("replica", default_rep))
            pid = pid_of(rep)
            key = (rep, ev.get("rid", ""))
            if key not in tids:
                tids[key] = len(tids) + 1
            e = {k: v for k, v in ev.items()
                 if k not in ("replica", "trace", "rid")}
            e["pid"] = pid
            e["tid"] = tids[key]
            args = dict(e.get("args") or {})
            args["trace"] = ev.get("trace", "")
            args["rid"] = ev.get("rid", "")
            e["args"] = args
            out.append(e)
    trace = {"traceEvents": out, "displayTimeUnit": "ms",
             "schema": TRACE_SCHEMA}
    if path:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
        try:
            from deepspeed_tpu_torch.robustness import events as rb_events
            rb_events.emit("trace_export", path=path, events=len(out),
                           replicas=len(pids))
        except Exception:  # noqa: BLE001 - export must not fail on emit
            pass
    return trace

"""The JSONL telemetry sink, copied from ``deepspeed_tpu/monitor/monitor.py``
(``JSONLMonitor``, ``MonitorMaster`` and what they need; stdlib only).
The serving engine drains its robustness events into a ``JSONLMonitor``
at round boundaries; ``comm.log_summary(monitor=...)`` writes the comms
logger's totals as scalar events. The other sinks (TensorBoard, W&B, CSV)
and the config sections that build them are ROADMAP A11: a
``MonitorMaster`` here fans out to the sinks it is given.
"""

import json
import math
import os
import time
from typing import Any, Dict, List, Sequence, Tuple

Event = Tuple[str, float, int]

# the port runs one process on one card: it is always the writing rank
_IS_RANK0 = True


def _jsonable(value):
    """Strict-JSON projection: NaN/Infinity have no JSON spelling and would
    make the machine-readable sink unparseable exactly when a run diverges —
    map them to null (recursively)."""
    if isinstance(value, float) and not math.isfinite(value):
        return None
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return value


class JSONLMonitor:
    """Machine-readable sink: one JSON object per line. Structured records
    (robustness events) are written verbatim plus a timestamp — the format
    downstream alerting actually wants to tail. JAX's scalar-event writer
    has no caller in the port and is not copied."""

    def __init__(self, path: str):
        self.enabled = False
        self.path = path
        self._f = None
        if not (path and _IS_RANK0):
            return
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.enabled = True

    def _handle(self):
        if self._f is None:
            self._f = open(self.path, "a")
        return self._f

    def write_events(self, events: List[Event]) -> None:
        if not self.enabled:
            return
        now = time.time()
        f = self._handle()
        for name, value, step in events:
            # JAX's scalar record, versioned: the port's JSON payloads
            # carry a version key
            f.write(json.dumps({"type": "scalar", "version": 1,
                                "name": name,
                                "value": _jsonable(float(value)),
                                "step": int(step), "time": now}) + "\n")
        f.flush()  # durable per boundary batch, not per interpreter exit

    def write_records(self, records: List[Dict[str, Any]]) -> None:
        if not self.enabled:
            return
        now = time.time()
        f = self._handle()
        for r in records:
            rec = _jsonable(dict(r))
            rec.setdefault("time", now)
            f.write(json.dumps(rec, default=str) + "\n")
        f.flush()

    def flush(self):
        if self._f is not None:
            try:
                self._f.flush()
                self._f.close()
            except Exception:  # noqa: BLE001
                pass
            self._f = None

    def __del__(self):
        try:
            self.flush()
        except Exception:  # noqa: BLE001
            pass


class MonitorMaster:
    """Fans one event stream out to every enabled sink, as JAX's (whose
    sinks come from the config's monitor sections: ROADMAP A11 here, so
    the sinks are given)."""

    def __init__(self, sinks: Sequence = ()):
        self.sinks = list(sinks)
        self.enabled = any(s.enabled for s in self.sinks)

    def write_events(self, events: List[Event]) -> None:
        for s in self.sinks:
            if s.enabled:
                s.write_events(events)

    def write_records(self, records: List[Dict[str, Any]]) -> None:
        for s in self.sinks:
            if s.enabled:
                s.write_records(records)

    def flush(self):
        for s in self.sinks:
            if s.enabled:
                s.flush()

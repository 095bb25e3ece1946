"""The JSONL telemetry sink, copied from ``deepspeed_tpu/monitor/monitor.py``
(``JSONLMonitor`` and what it needs; stdlib only). The serving engine
drains its robustness events into it at round boundaries. The other sinks
(TensorBoard, W&B, CSV) and ``MonitorMaster`` are ROADMAP A11.
"""

import json
import math
import os
import time
from typing import Any, Dict, List

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

"""Structured robustness events, copied from
``deepspeed_tpu/robustness/events.py`` (stdlib only).

Every recovery or refusal decision becomes a structured record: ``emit``
queues it for a telemetry drain and ``history()`` keeps a bounded copy of
everything emitted, for tests and post-mortems.
"""

import logging
import threading
import time
from typing import Any, Dict, List

logger = logging.getLogger("deepspeed_tpu_torch")

_LOCK = threading.Lock()
_PENDING: List[Dict[str, Any]] = []
_HISTORY: List[Dict[str, Any]] = []
_MAX_HISTORY = 4096
# pending is bounded too: a process with no drain wired must not grow this
# list forever — oldest records drop, history keeps its bounded copy
_MAX_PENDING = 4096


def emit(event_type: str, **fields) -> Dict[str, Any]:
    """Record one robustness event. Returns the record (already queued)."""
    rec = {"type": event_type, "ts": time.time(), **fields}
    with _LOCK:
        _PENDING.append(rec)
        del _PENDING[:-_MAX_PENDING]
        _HISTORY.append(rec)
        del _HISTORY[:-_MAX_HISTORY]
    logger.warning(f"robustness: {event_type} "
                   + " ".join(f"{k}={v}" for k, v in fields.items()))
    return rec


def drain() -> List[Dict[str, Any]]:
    """Pop every pending event (a telemetry sink's boundary drain)."""
    with _LOCK:
        out, _PENDING[:] = list(_PENDING), []
    return out


def history(event_type: str = None) -> List[Dict[str, Any]]:
    """Everything emitted this process (drained or not), newest last."""
    with _LOCK:
        out = list(_HISTORY)
    if event_type is not None:
        out = [r for r in out if r["type"] == event_type]
    return out


def clear() -> None:
    """Reset both queues (test isolation)."""
    with _LOCK:
        _PENDING[:] = []
        _HISTORY[:] = []

"""Fleet metric rollup primitives, the port's copy of
``deepspeed_tpu/telemetry/exposition.py`` (stdlib only; for the same
observations the text is byte for byte JAX's).

The router sees the fleet through per-replica heartbeat ``meta`` payloads,
plus the frozen last-seen meta of drained or dead replicas. This module
holds the two pieces a scrape needs:

* :class:`Histogram` — fixed-bucket-edge histogram whose *merge* is exact
  (same edges ⇒ bucket-wise add). Replicas serialize compact
  ``to_dict`` payloads in their heartbeats; the router merges them without
  ever seeing the raw samples. Edges default to a latency-friendly
  geometric ladder but are part of the serialized payload, so a version
  skew between replica and router degrades to "ignore, don't corrupt".
* :func:`render_prometheus` — Prometheus text exposition (line format):
  gauges/counters as single samples, histograms as cumulative
  ``_bucket{le="..."}`` series plus ``_sum``/``_count``. A plain HTTP
  handler returning this string is a scrape endpoint; the repo stays
  stdlib-only.
* :func:`parse_exposition` — inverse of the renderer, for round-trip
  checks (and for anyone gluing two routers).
"""

import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = ["Histogram", "render_prometheus", "parse_exposition",
           "DEFAULT_EDGES_MS", "DEPTH_EDGES", "FRACTION_EDGES"]

# geometric ladder 1ms..~16s: wide enough for TTFT on a cold replica,
# fine enough near the bottom for CPU-test ITL
DEFAULT_EDGES_MS: Tuple[float, ...] = tuple(
    float(v) for v in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                       1024, 2048, 4096, 8192, 16384))
# queue depth / running-count style small integers
DEPTH_EDGES: Tuple[float, ...] = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0,
                                  64.0, 128.0)
# occupancy fractions (pool / adapter slots), 0..1
FRACTION_EDGES: Tuple[float, ...] = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


class Histogram:
    """Fixed-edge histogram with exact merge. ``counts[i]`` is the number
    of samples ``<= edges[i]``-exclusive-of-lower-buckets (i.e. classic
    per-bucket counts, NOT cumulative); an implicit overflow bucket holds
    samples above the last edge. Rendering converts to Prometheus's
    cumulative ``le`` convention."""

    def __init__(self, edges: Iterable[float] = DEFAULT_EDGES_MS):
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(self.edges):
            raise ValueError("histogram edges must be ascending")
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return
        i = 0
        for i, e in enumerate(self.edges):  # noqa: B007 - tiny fixed ladder
            if v <= e:
                break
        else:
            i = len(self.edges)
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def observe_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.observe(v)

    def merge(self, other: "Histogram") -> "Histogram":
        if other.edges != self.edges:
            raise ValueError(f"edge mismatch: {other.edges} vs {self.edges}")
        for i, c in enumerate(other.counts):
            self.counts[i] += int(c)
        self.sum += other.sum
        self.count += other.count
        return self

    # -- wire format (heartbeat meta / drain stats) ----------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}

    @classmethod
    def from_dict(cls, d: Optional[Mapping[str, Any]]) -> Optional["Histogram"]:
        """Rehydrate a wire payload; malformed/foreign payloads return
        ``None`` (version-skew rule: ignore, don't corrupt)."""
        if not isinstance(d, Mapping):
            return None
        try:
            h = cls(d["edges"])
            counts = [int(c) for c in d["counts"]]
            if len(counts) != len(h.counts):
                return None
            h.counts = counts
            h.sum = float(d.get("sum", 0.0))
            h.count = int(d.get("count", sum(counts)))
            return h
        except (KeyError, TypeError, ValueError):
            return None

    def quantile(self, q: float) -> float:
        """Edge-resolution quantile (upper edge of the bucket holding the
        q-th sample; +inf bucket reports the last edge)."""
        if self.count <= 0:
            return 0.0
        target = max(1, math.ceil(min(max(q, 0.0), 1.0) * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self.edges[i] if i < len(self.edges) else self.edges[-1]
        return self.edges[-1]


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(metrics: Mapping[str, Any],
                      prefix: str = "dstpu") -> str:
    """Render a ``{name: value}`` mapping as Prometheus text exposition.

    Values may be numbers (rendered as gauges), :class:`Histogram`
    instances, or dicts that rehydrate via :meth:`Histogram.from_dict`.
    Non-numeric, non-histogram values are skipped — the caller can pass a
    whole ``fleet_stats()`` snapshot without pre-filtering."""
    lines: List[str] = []
    for name in sorted(metrics):
        val = metrics[name]
        full = f"{prefix}_{name}" if prefix else name
        if isinstance(val, Mapping):
            val = Histogram.from_dict(val)
            if val is None:
                continue
        if isinstance(val, Histogram):
            lines.append(f"# TYPE {full} histogram")
            cum = 0
            for i, e in enumerate(val.edges):
                cum += val.counts[i]
                lines.append(f'{full}_bucket{{le="{_fmt(e)}"}} {cum}')
            lines.append(f'{full}_bucket{{le="+Inf"}} {val.count}')
            lines.append(f"{full}_sum {_fmt(val.sum)}")
            lines.append(f"{full}_count {val.count}")
        elif isinstance(val, bool):
            lines.append(f"# TYPE {full} gauge")
            lines.append(f"{full} {int(val)}")
        elif isinstance(val, (int, float)):
            if isinstance(val, float) and math.isnan(val):
                continue
            lines.append(f"# TYPE {full} gauge")
            lines.append(f"{full} {_fmt(val)}")
    return "\n".join(lines) + "\n"


def parse_exposition(text: str) -> Dict[str, Any]:
    """Inverse of :func:`render_prometheus`: gauges come back as floats,
    histograms as :class:`Histogram` (per-bucket counts reconstructed from
    the cumulative series)."""
    gauges: Dict[str, float] = {}
    buckets: Dict[str, List[Tuple[float, int]]] = {}
    sums: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, val = line.rpartition(" ")
        if "_bucket{le=" in name:
            base, _, le = name.partition("_bucket{le=")
            le = le.rstrip("}").strip('"')
            edge = math.inf if le == "+Inf" else float(le)
            buckets.setdefault(base, []).append((edge, int(float(val))))
        elif name.endswith("_sum") and name[:-4] in buckets:
            sums[name[:-4]] = float(val)
        elif name.endswith("_count") and name[:-6] in buckets:
            counts[name[:-6]] = int(float(val))
        else:
            gauges[name] = float(val)
    out: Dict[str, Any] = dict(gauges)
    for base, series in buckets.items():
        series.sort(key=lambda p: p[0])
        edges = [e for e, _ in series if e != math.inf]
        h = Histogram(edges)
        prev = 0
        for i, (_, cum) in enumerate(series):
            h.counts[i] = cum - prev
            prev = cum
        h.count = counts.get(base, prev)
        h.sum = sums.get(base, 0.0)
        out[base] = h
    return out

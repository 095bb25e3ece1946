"""The serving fleet's telemetry, the port's part of
``deepspeed_tpu/telemetry``:

  request_trace — per-request host-clock spans across the lifecycle
                  (admission → prefill → decode quanta → drain /
                  migration), stitched across replicas through drain-state
                  v3 and merged into one Chrome trace (replica = process)
  exposition    — mergeable fixed-edge histograms and the Prometheus text
                  format for the router's ``fleet_stats()`` rollup

The training-side modules (accumulators, anomaly, join, tracing) are
ROADMAP A11.
"""

from deepspeed_tpu_torch.telemetry.exposition import (Histogram,
                                                      parse_exposition,
                                                      render_prometheus)
from deepspeed_tpu_torch.telemetry.request_trace import (RequestTracer,
                                                         merge_chrome_trace)

__all__ = ["Histogram", "RequestTracer", "merge_chrome_trace",
           "parse_exposition", "render_prometheus"]

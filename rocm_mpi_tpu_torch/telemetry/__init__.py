"""Structured observability of the port — counterpart of
rocm_mpi_tpu/telemetry/ (docs/TELEMETRY.md), writing the same records
under the same schema strings and environment names, so either
package's read side reads the other's artifacts.

The write side is stdlib-only and gated on one bool so instrumented
code costs nothing when telemetry is off:

    from rocm_mpi_tpu_torch import telemetry

    telemetry.configure(directory="out/telemetry", rank=distributed.rank())
    with telemetry.span("step_window", phase="step", steps=50) as sp:
        T = advance(T, Cp, 50)
        sp.sync(T)                      # torch.cuda.synchronize on a CUDA tensor
    telemetry.gauge("run.gpts", r.gpts)
    telemetry.record_event("restored", step=120)

Every rank appends to its own `telemetry-rank{k}.jsonl` (versioned
schema: telemetry.events). The read side merges them:

    python -m rocm_mpi_tpu_torch.telemetry summarize DIR        # + Chrome trace
    python -m rocm_mpi_tpu_torch.telemetry regress S --baseline B

Layer map: spans/events collect (write side); aggregate merges and
attributes (halo / interior / checkpoint / step, stragglers); trace
exports to Perfetto; regress gates on committed baselines; probes
(torch-needing, imported lazily) time the phases of a fused step that
exposes no seams at run time; compiles counts nvcc builds, cached
library loads and CUDA-graph captures under the JAX package's
`compiles.*` gauge names.

The runtime health plane rides on top: flight (write side — per-rank
flight recorder, heartbeat sidecars, SIGUSR2 post-mortems) and health
(read side — sidecar tailing, the progress-aware stall verdict,
monitor/OpenMetrics):

    python -m rocm_mpi_tpu_torch.telemetry monitor DIR
    python -m rocm_mpi_tpu_torch.telemetry export-openmetrics DIR
"""

from rocm_mpi_tpu_torch.telemetry.events import (
    SCHEMA_VERSION,
    annotate,
    annotate_once,
    clear,
    clear_events,
    configure,
    counter,
    enabled,
    gauge,
    rank,
    record_event,
    records,
    stream_path,
)
from rocm_mpi_tpu_torch.telemetry.spans import span, span_record

__all__ = [
    "SCHEMA_VERSION",
    "annotate",
    "annotate_once",
    "clear",
    "clear_events",
    "configure",
    "counter",
    "enabled",
    "gauge",
    "rank",
    "record_event",
    "records",
    "span",
    "span_record",
    "stream_path",
]

"""Multi-tenant batched simulation serving — counterpart of
rocm_mpi_tpu/serving/ (docs/SERVING.md), with the same exports.

A request queue (`queue.py`), a bin scheduler that packs heterogeneous
requests onto shared programs (`bins.py`), SLO accounting and the soak
report schema (`slo.py`), and the service driver (`service.py`) that runs
batches on a space×batch grid (parallel.mesh.BatchedGrid) through a
pipelined drain, bitwise equal to the serial drain at any depth, with
session checkpoints, preemption, retries, quarantine, a circuit breaker
and queue-driven elasticity.

The fleet fronts several services: `router.FleetRouter` routes requests
to `SimulationService` replicas and re-routes a dead replica's open
tickets from the durable ticket journal (`journal.py`).

`queue`, `bins`, `slo`, `journal` and `router` are stdlib at import (the
telemetry read side validates their formats without torch); `service`
imports torch.
"""

from rocm_mpi_tpu_torch.serving.bins import (  # noqa: F401
    BIN_MANIFEST_SCHEMA,
    BinKey,
    bin_key,
    plan_batches,
    steps_bucket,
)
from rocm_mpi_tpu_torch.serving.queue import (  # noqa: F401
    QUARANTINE_SCHEMA,
    REQUEST_SCHEMA,
    Request,
    RequestQueue,
    Ticket,
)
from rocm_mpi_tpu_torch.serving.slo import (  # noqa: F401
    SOAK_SCHEMA,
    validate_soak_report,
    write_soak_report,
)

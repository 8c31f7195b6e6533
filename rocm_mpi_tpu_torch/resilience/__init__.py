"""Fault tolerance of the port — counterpart of rocm_mpi_tpu/resilience/.

The layer spans the levels where failure strikes:

* `supervisor.run_supervised` — process-level retry/backoff around the
  segmented checkpointed advance (crash → restore the latest VALID step);
* `utils.checkpoint` — integrity manifests and `latest_valid_step`, the
  storage-fault plane (per-save retry/backoff, ENOSPC pruning, the
  slow-save watchdog, degraded mode), the fault sites, preemption polling
  at segment boundaries, and restores onto another process grid;
* `faults` — deterministic fault injection (crash/kill/die/truncate/
  delay/stall at exact steps, the storage kinds at save attempts), from
  the apps' `--inject-fault` or RMT_INJECT_FAULT;
* `preempt` — the SIGTERM grace-deadline handler, the emergency-save
  budget and the RC_PREEMPTED exit every supervisor upstack classifies
  as resumable;
* `elastic.run_elastic` — launcher-level topology supervision: when a
  rank dies for good, shrink to the largest valid sub-grid and resume
  from the latest valid step; when devices rejoin the budget, preempt
  and grow back;
* `policy.ElasticPolicy` — the pluggable shrink/grow/give-up table;
* `reshard` — the manifest's topology metadata, restore templates for
  another process grid, and the host gather/scatter of live state.
"""

from rocm_mpi_tpu_torch.resilience.elastic import (  # noqa: F401
    ElasticExhausted,
    ElasticReport,
    run_elastic,
)
from rocm_mpi_tpu_torch.resilience.faults import (  # noqa: F401
    FaultPlan,
    InjectedCrash,
    fault_point,
    install,
    install_from_env,
)
from rocm_mpi_tpu_torch.resilience.policy import ElasticPolicy  # noqa: F401
from rocm_mpi_tpu_torch.resilience.preempt import (  # noqa: F401
    RC_PREEMPTED,
    Preempted,
)
from rocm_mpi_tpu_torch.resilience.supervisor import (  # noqa: F401
    default_retryable,
    run_supervised,
)

"""Self-healing training (``paddle_tpu.distributed.resilience``
counterpart): fault injection, anomaly detection with checkpoint
rollback, and a supervised recovery loop.

* ``faults``: the fault-injection registry (named points, one-shot /
  nth-hit / probabilistic / always triggers, armed from code or
  ``FLAGS_fault_injection``).
* ``anomaly.AnomalyDetector``: the step's health flag and host-side
  median+MAD loss-spike detection, with the policies warn | skip_batch |
  rollback | halt.
* ``supervisor.run_resilient``: the supervised loop (rollback to the last
  committed elastic checkpoint, data-cursor fast-forward, batch
  quarantine, feeder-crash retry, hang restart, JSONL incident log,
  bounded budgets ending in a structured ``ResilienceHalt``).
"""
from paddle_tpu_torch.distributed.resilience import faults  # noqa: F401
from paddle_tpu_torch.distributed.resilience.anomaly import (  # noqa: F401
    Anomaly, AnomalyDetector)
from paddle_tpu_torch.distributed.resilience.supervisor import (  # noqa: F401
    IncidentLog, ResilienceHalt, ResiliencePolicy, run_resilient)

__all__ = ["faults", "Anomaly", "AnomalyDetector", "IncidentLog",
           "ResilienceHalt", "ResiliencePolicy", "run_resilient"]

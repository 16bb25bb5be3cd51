"""Resilience pieces of the port (counterpart of ``paddle_tpu/resilience``):
the engine's health machine, deterministic fault injection, crash-safe
checkpoints, retry with backoff, the preemption drain, and the training
sentinel with its poison localization, digests and cross-rank digest
vote, and the fleet (``fleet.py``: timeout-bounded coordination,
heartbeats and the fleet watchdog, the distributed checkpointer,
reconfigure). Every fault, recovery, retry, drain, checkpoint and
anomaly is recorded through :mod:`paddle_tpu_torch.observability`."""
from paddle_tpu_torch.resilience import (faultinject, fleet, preemption,
                                         sentinel)
from paddle_tpu_torch.resilience.checkpoint import (CheckpointCorruption,
                                                    Checkpointer, auto_resume)
from paddle_tpu_torch.resilience.faultinject import (FaultInjector, FaultPlan,
                                                     FaultSpec, WorkerFault)
from paddle_tpu_torch.resilience.health import HealthMonitor, HealthState
from paddle_tpu_torch.resilience.preemption import (PreemptionHandler,
                                                    request_preemption)
from paddle_tpu_torch.resilience.retry import (RetryExhausted, RetryPolicy,
                                               retry)
from paddle_tpu_torch.resilience.sentinel import (AnomalyDetected,
                                                  BatchLineage, DigestVote,
                                                  GuardSummary, SentinelAction,
                                                  TrainingSentinel,
                                                  digest_vote,
                                                  localize_poison,
                                                  replay_bisect, tree_digest)

__all__ = ["AnomalyDetected", "BatchLineage", "CheckpointCorruption",
           "Checkpointer", "DigestVote", "FaultInjector", "FaultPlan",
           "FaultSpec", "GuardSummary", "HealthMonitor", "HealthState",
           "PreemptionHandler", "RetryExhausted", "RetryPolicy",
           "SentinelAction", "TrainingSentinel", "WorkerFault",
           "auto_resume", "digest_vote", "faultinject", "fleet",
           "localize_poison",
           "preemption", "replay_bisect", "request_preemption", "retry",
           "sentinel", "tree_digest"]

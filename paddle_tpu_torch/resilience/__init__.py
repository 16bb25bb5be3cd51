"""Resilience pieces of the port (counterpart of ``paddle_tpu/resilience``):
the engine's health machine, deterministic fault injection, crash-safe
checkpoints, retry with backoff, the preemption drain, and the training
sentinel with its poison localization and digests. Every fault,
recovery, retry, drain, checkpoint and anomaly is recorded through
:mod:`paddle_tpu_torch.observability`.

Not ported yet: the fleet (``fleet.py``: timeout-bounded coordination,
heartbeats, the distributed checkpointer, reconfigure), with the
multi-rank digest vote and the ``rank_kill`` / ``wedge`` fault kinds
that need it (ROADMAP A.4)."""
from paddle_tpu_torch.resilience import faultinject, preemption, sentinel
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
           "auto_resume", "digest_vote", "faultinject", "localize_poison",
           "preemption", "replay_bisect", "request_preemption", "retry",
           "sentinel", "tree_digest"]

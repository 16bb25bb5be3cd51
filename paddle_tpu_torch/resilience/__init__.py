"""Resilience pieces of the port (counterpart of ``paddle_tpu/resilience``):
the engine's health machine, deterministic fault injection, crash-safe
checkpoints and the training sentinel."""
from paddle_tpu_torch.resilience import faultinject, sentinel
from paddle_tpu_torch.resilience.checkpoint import (CheckpointCorruption,
                                                    Checkpointer, auto_resume)
from paddle_tpu_torch.resilience.faultinject import (FaultInjector, FaultPlan,
                                                     FaultSpec, WorkerFault)
from paddle_tpu_torch.resilience.health import HealthMonitor, HealthState
from paddle_tpu_torch.resilience.sentinel import (AnomalyDetected,
                                                  GuardSummary, SentinelAction,
                                                  TrainingSentinel)

__all__ = ["AnomalyDetected", "CheckpointCorruption", "Checkpointer",
           "FaultInjector", "FaultPlan", "FaultSpec", "GuardSummary",
           "HealthMonitor", "HealthState", "SentinelAction",
           "TrainingSentinel", "WorkerFault", "auto_resume", "faultinject",
           "sentinel"]

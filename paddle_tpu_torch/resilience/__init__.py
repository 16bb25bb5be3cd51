"""Resilience pieces of the port."""
from paddle_tpu_torch.resilience.health import HealthMonitor, HealthState

__all__ = ["HealthMonitor", "HealthState"]

"""paddle_tpu_torch.serving.traffic: deterministic workload models, SLO
autoscaling and capacity reports for the serving fleet (counterpart of
``paddle_tpu.serving.traffic``).

A seeded, JSON-able :class:`TrafficSpec` (arrival process, length
mixtures, shared-prefix ratio, deadline classes) compiles into a
byte-identical request trace; the :class:`TrafficDriver` replays it
open-loop against a :class:`~paddle_tpu_torch.serving.router.Router` on
a :class:`VirtualClock` (same seed, identical goodput and SLO counters);
the :class:`SLOAutoscaler` parks and unparks replicas through the
router's respawn queue with hysteresis; and :func:`probe_capacity`
binary-searches the largest sustained QPS at a declared TTFT SLO per
replica count into a :class:`CapacityReport`.

Quickstart::

    from paddle_tpu_torch.serving import traffic

    spec = traffic.TrafficSpec(
        seed=0, arrival={"kind": "poisson", "rate_qps": 12.0},
        duration_s=2.0, prompt_len=[[1.0, 4, 16]],
        output_tokens=[[1.0, 4, 8]],
        classes=[traffic.DeadlineClass("interactive", ttft_slo_s=0.5)])
    clock = traffic.VirtualClock()
    router = Router(model, engine_config, num_replicas=2, clock=clock)
    report = traffic.TrafficDriver(router, spec, clock).run()
"""
from paddle_tpu_torch.serving.traffic.autoscaler import (SLO,
                                                         AutoscalerConfig,
                                                         SLOAutoscaler)
from paddle_tpu_torch.serving.traffic.capacity import (CapacityReport,
                                                       probe_capacity,
                                                       run_traffic)
from paddle_tpu_torch.serving.traffic.driver import (TrafficDriver,
                                                     TrafficMetrics,
                                                     VirtualClock)
from paddle_tpu_torch.serving.traffic.workload import (DeadlineClass,
                                                       TraceRequest,
                                                       TrafficSpec,
                                                       compile_trace,
                                                       trace_digest)

__all__ = [
    "AutoscalerConfig",
    "CapacityReport",
    "DeadlineClass",
    "SLO",
    "SLOAutoscaler",
    "TraceRequest",
    "TrafficDriver",
    "TrafficMetrics",
    "TrafficSpec",
    "VirtualClock",
    "compile_trace",
    "probe_capacity",
    "run_traffic",
    "trace_digest",
]

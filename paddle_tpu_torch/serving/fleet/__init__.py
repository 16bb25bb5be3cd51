"""Elastic multi-process serving (counterpart of
``paddle_tpu/serving/fleet``).

Runs :class:`~paddle_tpu_torch.serving.LLMEngine` replicas in separate
processes and fronts them with the stock
:mod:`paddle_tpu_torch.serving.router`, which never learns its engines
are remote:

- :mod:`.wire`: an ordered RPC over the coordination store, and the
  page handoff's blob format;
- :class:`.RemoteEngineClient`: the controller-side handle with the
  engine surface the router drives (exactly-once streams, waits aborted
  by the watchdog, deadlines re-anchored from ``age_s``);
- :class:`.ReplicaServer`: the worker-side serve loop around a real
  engine, with heartbeat telemetry and the ``serving.fleet.step`` chaos
  hook;
- :class:`.ServingFleet`: the controller: router, fleet watchdog,
  respawn onto spare ranks booting warm from the shared AOT cache;
- :class:`.DisaggregatedEngine`: prefill and decode on different
  engines over the page handoff, token-identical to one engine.

The multi-process entry point is :mod:`.worker`, started one process a
rank under ``python -m paddle_tpu_torch.distributed.launch``.
"""
from paddle_tpu_torch.serving.fleet.controller import (FleetServingConfig,
                                                       ServingFleet)
from paddle_tpu_torch.serving.fleet.disagg import (DisaggregatedEngine,
                                                   DisaggResult)
from paddle_tpu_torch.serving.fleet.handle import (FinishedRemote,
                                                   RemoteEngineClient)
from paddle_tpu_torch.serving.fleet.server import ReplicaServer
from paddle_tpu_torch.serving.fleet.wire import (RemoteReplicaError,
                                                 pack_state, unpack_state)

__all__ = [
    "DisaggResult",
    "DisaggregatedEngine",
    "FinishedRemote",
    "FleetServingConfig",
    "RemoteEngineClient",
    "RemoteReplicaError",
    "ReplicaServer",
    "ServingFleet",
    "pack_state",
    "unpack_state",
]

"""paddle_tpu_torch.serving.router: telemetry-driven multi-replica
serving (counterpart of ``paddle_tpu.serving.router``).

A :class:`Router` fronts N :class:`~paddle_tpu_torch.serving.LLMEngine`
replicas and balances admissions on their live telemetry (queue depth,
page occupancy, health), with sticky request-to-replica affinity,
``AdmissionRejected``-aware spillover and retry, failover migration that
loses no tokens, and elastic drain and respawn, replicas booting warm
from a shared AOT program cache (:mod:`paddle_tpu_torch.serving.
aot_cache`).

Quickstart::

    from paddle_tpu_torch import serving
    from paddle_tpu_torch.serving.router import Router
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny

    router = Router(GPTForCausalLM(gpt3_tiny()),
                    serving.EngineConfig(max_num_seqs=8,
                                         max_model_len=128),
                    num_replicas=3, program_cache="/var/cache/ptt_aot")
    results = router.generate(
        [[12, 7, 9], [4, 4, 8, 1]],
        serving.SamplingParams(max_new_tokens=16, seed=1))
    router.drain(0)          # elastic: finish work, respawn warm
    router.shutdown()
"""
from paddle_tpu_torch.serving.aot_cache import (AOTProgramCache,
                                                engine_fingerprint)
from paddle_tpu_torch.serving.router.metrics import RouterMetrics
from paddle_tpu_torch.serving.router.replica import (ReplicaHandle,
                                                     ReplicaState)
from paddle_tpu_torch.serving.router.router import (Router, RouterConfig,
                                                    RouterResult)

__all__ = [
    "AOTProgramCache",
    "ReplicaHandle",
    "ReplicaState",
    "Router",
    "RouterConfig",
    "RouterMetrics",
    "RouterResult",
    "engine_fingerprint",
]

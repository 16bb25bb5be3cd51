"""Continuous-batching serving over a paged KV cache (counterpart of
``paddle_tpu.serving``)."""
from paddle_tpu_torch.serving.engine import (AdmissionRejected, EngineConfig,
                                             LLMEngine, PagedKVContext)
from paddle_tpu_torch.serving.metrics import EngineMetrics, Histogram
from paddle_tpu_torch.serving.request import (GenerationResult, Request,
                                              RequestState, SamplingParams)
from paddle_tpu_torch.serving.sampler import sample_tokens
from paddle_tpu_torch.serving.scheduler import (Scheduler, bucket_for,
                                                default_buckets)

__all__ = ["AdmissionRejected", "EngineConfig", "EngineMetrics",
           "GenerationResult", "Histogram", "LLMEngine", "PagedKVContext",
           "Request", "RequestState", "SamplingParams", "Scheduler",
           "bucket_for", "default_buckets", "sample_tokens"]

"""Quantization of the port (counterpart of ``paddle_tpu/quantization``):
the per-page-scaled int8 / fp8 KV pools behind
``serving.EngineConfig(kv_cache_dtype=)``. The quantized collectives and
PTQ/QAT are not ported yet."""
from paddle_tpu_torch.quantization.kv_cache import (
    KV_CACHE_DTYPES, KVQuantSpec, dequantize_codes, encode_int_codes,
    kv_bytes_per_token, quantize_block, quantized_attend,
    quantized_decode_step, quantized_prefill_append, resolve_kv_cache_dtype)

__all__ = ["KVQuantSpec", "KV_CACHE_DTYPES", "dequantize_codes",
           "encode_int_codes", "kv_bytes_per_token", "quantize_block",
           "quantized_attend", "quantized_decode_step",
           "quantized_prefill_append", "resolve_kv_cache_dtype"]

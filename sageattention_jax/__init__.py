"""sageattention_jax — quantized attention for NVIDIA Hopper in JAX.

A framework with the capabilities of SageAttention (reference:
eliotwang/SageAttention): Q·Kᵀ runs as INT8 (per-token Q scales, per-tile
K scales, K mean-smoothing) and P·V on bf16, int8 or fp8-stored V, in one
fused Pallas-through-Triton kernel, with a plain blockwise JAX path for
every other option; a drop-in ``sageattn(q, k, v, ...)`` API, varlen
(segment-id) batching, GQA, LSE output for ring attention, quantized
dense and paged KV caches for decode, and ring/Ulysses sequence
parallelism over device meshes.

The reference selects a compiled CUDA/HIP backend per GPU arch at import
time (reference: sageattention/__init__.py:8-95).  Here the kernel is
compiled by Triton when first traced, and ``core.choose_impl`` picks the
path per call, so everything is exported eagerly.
"""

from sageattention_jax.core import (
    sageattn,
    sageattn_varlen,
    sageattn_qk_int8_pv_bf16,
    sageattn_qk_int8_pv_int8,
    sageattn_qk_int8_pv_fp8,
)
from sageattention_jax import quant
from sageattention_jax.ops import reference
from sageattention_jax.speculative import speculative_verify
from sageattention_jax.kvcache import (
    PagedKVCache,
    QuantKVCache,
    append_kv,
    calibrate,
    init_kv_cache,
    init_paged_kv_cache,
    paged_append,
    paged_prefill,
    sageattn_decode,
    sageattn_paged_decode,
)

__version__ = "0.1.0"

__all__ = [
    "sageattn",
    "sageattn_varlen",
    "sageattn_qk_int8_pv_bf16",
    "sageattn_qk_int8_pv_int8",
    "sageattn_qk_int8_pv_fp8",
    "quant",
    "reference",
    "QuantKVCache",
    "calibrate",
    "speculative_verify",
    "init_kv_cache",
    "append_kv",
    "sageattn_decode",
    "PagedKVCache",
    "init_paged_kv_cache",
    "paged_append",
    "paged_prefill",
    "sageattn_paged_decode",
    "__version__",
]

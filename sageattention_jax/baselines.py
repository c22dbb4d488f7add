"""Baseline attention adapters (reference: sageattention/fa3_wrapper.py).

The reference wraps FlashAttention-3 (fp16 and per-tensor-FP8) behind the
same call signature as ``sageattn`` so benchmarks and examples can swap
implementations (reference: fa3_wrapper.py:11-77).  Here:

* :func:`cudnn` — NVIDIA's cuDNN fused flash attention in bf16, through
  ``jax.nn.dot_product_attention(implementation="cudnn")``: a library
  kernel, the bar on the GPU.
* :func:`int8_pertensor` — attention fed per-tensor-quantized int8
  Q/K/V (global amax/127 scales, dequantized on entry) — the accuracy
  analogue of the reference's per-tensor FP8 FA3 (``fa3_fp8``,
  fa3_wrapper.py:64-70): it shows what *coarse* per-tensor scaling does
  to accuracy versus SageAttention's fine-grained scales.
* :func:`sdpa` — ``jax.nn.dot_product_attention`` compiled by XLA (runs
  on any backend).

All take HND ([b, h, s, d]) or NHD layouts like ``sageattn``, and GQA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sageattention_jax.quant import round_half_away


def _to_nhd(x, layout):
    return jnp.swapaxes(x, 1, 2) if layout == "HND" else x


def _dpa(q, k, v, layout, is_causal, sm_scale, implementation):
    o = jax.nn.dot_product_attention(
        _to_nhd(q, layout), _to_nhd(k, layout), _to_nhd(v, layout),
        is_causal=is_causal, scale=sm_scale, implementation=implementation,
    )
    return _to_nhd(o, layout)


def cudnn(q, k, v, tensor_layout: str = "HND", is_causal: bool = False,
          sm_scale: float | None = None):
    """cuDNN's bf16 fused attention (GPU only; reference:
    fa3_wrapper.py:11 ``fa3``)."""
    dt = q.dtype
    q, k, v = (x.astype(jnp.bfloat16) for x in (q, k, v))
    return _dpa(q, k, v, tensor_layout, is_causal, sm_scale,
                "cudnn").astype(dt)


def int8_pertensor(q, k, v, tensor_layout: str = "HND",
                   is_causal: bool = False, sm_scale: float | None = None):
    """Per-tensor-quantized baseline (reference: fa3_wrapper.py:64-70
    ``fa3_fp8``): one global scale per tensor, the coarsest quantization —
    the accuracy strawman SageAttention's per-token/per-tile scales beat."""

    def qdq(x):  # quantize-dequantize with one per-tensor scale
        # same rounding spec as every other int8 path in the package
        xf = x.astype(jnp.float32)
        scale = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-30) / 127.0
        xi = jnp.clip(round_half_away(xf / scale), -127, 127)
        return (xi * scale).astype(jnp.bfloat16)

    return sdpa(qdq(q), qdq(k), qdq(v), tensor_layout, is_causal,
                sm_scale).astype(q.dtype)


def sdpa(q, k, v, tensor_layout: str = "HND", is_causal: bool = False,
         sm_scale: float | None = None):
    """jax.nn.dot_product_attention compiled by XLA (reference:
    bench/bench_baseline.py torch-SDPA backends)."""
    return _dpa(q, k, v, tensor_layout, is_causal, sm_scale, "xla")

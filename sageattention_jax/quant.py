"""Quantization (reference: sageattention/quant.py, csrc/fused/fused.cu).

Scale layout
------------
The reference emits scale tensors whose shapes encode the CUDA MMA lane
mapping (per-thread: ``ceil(L/BLKQ)*(BLKQ/WARPQ)*8`` scales per head,
reference: triton/quant_per_thread.py:184-185; per-warp / per-block
analogues in quant.py:23-181).  Here the dequantization is a multiply of
the int32 Q·Kᵀ tile by a row scale and a column scale, so the layouts are
simple:

* ``per_token``   — one scale per row (Q's scale in the fused kernel;
  strictly finer than the reference's per-thread granularity).
* ``quant_int8_block_scales`` — one scale per ``group`` K rows, unexpanded
  (K's scale in the fused kernel: the group is its KV tile).
* ``per_subtile`` / ``per_block`` — one scale per 32 / 128 rows, expanded
  to a **per-row scale vector** ``[b, h, s]`` (the blockwise path).

``sm_scale * log2(e)`` is folded into the Q scales (reference: quant.py:95)
so the softmax is base-2.

These are plain jnp: XLA fuses each quantizer (amax reduction plus the
scale-round-clip chain) into one pass over its tensor.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

LOG2E = 1.4426950408889634

# Max representable magnitudes per quantized dtype.
_QMAX = {
    jnp.int8.dtype: 127.0,
    jnp.float8_e4m3fn.dtype: 448.0,
    jnp.float8_e5m2.dtype: 57344.0,
}
_INT4_QMAX = 7.0


def round_half_away(x: jax.Array) -> jax.Array:
    """Round half away from zero (reference: triton/quant_per_block.py:43-45,
    csrc/numeric_conversion.cuh:144 ``float_to_int8_rn`` uses round-to-nearest;
    the Triton kernels use +0.5*sign then truncate — we match the Triton/fused
    semantics).  Implemented as the rounding op (exact, where trunc(x+0.5)
    misrounds values whose +0.5 sum rounds up to the next integer)."""
    return jax.lax.round(x, jax.lax.RoundingMethod.AWAY_FROM_ZERO)


def inv_scale(amax: jax.Array, qmax: float) -> tuple[jax.Array, jax.Array]:
    """(scale, 1/scale) from a per-row/channel amax.

    Quantization multiplies by the reciprocal (one divide per *row*, one
    multiply per element) instead of dividing per element.  Every writer
    of quantized codes (this module, the KV cache) computes the scale
    chain this one way."""
    scale = jnp.maximum(amax, 1e-30) * (1.0 / qmax)
    return scale, 1.0 / scale


def _group_amax(x: jax.Array, group: int) -> jax.Array:
    """amax over [group-rows x head_dim] groups -> per-row expanded [.., s]."""
    b, h, s, d = x.shape
    if group <= 1:
        return jnp.max(jnp.abs(x), axis=-1)
    pad = (-s) % group
    if pad:
        x = jnp.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0)))
    g = x.reshape(b, h, (s + pad) // group, group, d)
    amax = jnp.max(jnp.abs(g), axis=(-1, -2))  # [b, h, n_groups]
    per_row = jnp.repeat(amax, group, axis=-1)
    return per_row[..., :s]


@functools.partial(
    jax.jit, static_argnames=("granularity", "block_size", "bits")
)
def quant_int8(
    x: jax.Array,
    *,
    granularity: str = "per_token",
    block_size: int = 32,
    scale_fold: float = 1.0,
    bits: int = 8,
) -> tuple[jax.Array, jax.Array]:
    """Quantize [b, h, s, d] to int8 with per-row scales [b, h, s] (fp32).

    ``scale_fold`` is multiplied into the returned scales (used to fold
    ``sm_scale * log2e`` into Q's scales, reference: quant.py:95).
    ``bits=4`` quantizes into the int4 range (values stored as int8 and
    multiplied by the same int8 dot — reference INT4 variants:
    triton/quant_per_thread.py:104-156).
    """
    x = x.astype(jnp.float32)
    if granularity == "per_token":
        amax = _group_amax(x, 1)
    elif granularity == "per_subtile":
        amax = _group_amax(x, block_size)
    elif granularity == "per_block":
        amax = _group_amax(x, max(block_size, 128))
    else:
        raise ValueError(f"unknown granularity {granularity!r}")
    qmax = _INT4_QMAX if bits == 4 else 127.0
    scale, r = inv_scale(amax, qmax)
    q = round_half_away(x * r[..., None])
    q = jnp.clip(q, -qmax, qmax).astype(jnp.int8)
    return q, scale * scale_fold


@functools.partial(jax.jit, static_argnames=("group", "bits"))
def quant_int8_block_scales(
    x: jax.Array, *, group: int, bits: int = 8
) -> tuple[jax.Array, jax.Array]:
    """Quantize [b,h,s,d] with one scale per ``group`` rows, returning the
    scales UNEXPANDED as [b, h, ceil(s/group)] fp32.

    This is the fused kernel's K layout: the group equals the kernel's KV
    tile, so the kernel loads one scalar per tile and dequantization is
    one multiply per score element.  Accuracy
    is within noise of per-token K scaling once K is mean-smoothed
    (measured; see tests/test_quant.py), because smoothing removes the
    channel-mean outliers that coarse scales would otherwise absorb
    (reference's coarsest mode: triton/quant_per_block.py).
    """
    x = x.astype(jnp.float32)
    b, h, s, d = x.shape
    pad = (-s) % group
    xp = jnp.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0)))
    g = xp.reshape(b, h, -1, group, d)
    qmax = _INT4_QMAX if bits == 4 else 127.0
    amax = jnp.max(jnp.abs(g), axis=(-1, -2))  # [b, h, n_groups]
    scale, r = inv_scale(amax, qmax)
    q = round_half_away(g * r[..., None, None])
    q = jnp.clip(q, -qmax, qmax).astype(jnp.int8)
    q = q.reshape(b, h, s + pad, d)[:, :, :s]
    return q, scale


@jax.jit
def sub_mean(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Subtract the per-(b,h,d) mean over the sequence axis.

    The K-smoothing / V-smoothing primitive (reference: quant.py:183-223
    ``sub_mean``; core.py:793-799 ``km = k.mean(seq_dim)``).  Softmax is
    invariant to subtracting ``q . km`` (a per-row constant) from every
    logit, which centers K and shrinks the INT8 quantization range.
    """
    mean = jnp.mean(x.astype(jnp.float32), axis=-2)
    return (x.astype(jnp.float32) - mean[..., None, :]), mean


@functools.partial(jax.jit, static_argnames=("dtype", "smooth"))
def per_channel_quant(
    v: jax.Array,
    *,
    dtype=jnp.int8,
    smooth: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array | None]:
    """Per-(b,h,d)-channel quantization of V (reference: quant.py:225-322
    ``per_channel_fp8`` / csrc/fused/fused.cu:316-427 ``MeanScaleKernel``).

    Returns (v_q, v_scale [b,h,d] fp32, v_mean [b,h,d] or None).
    ``dtype`` may be jnp.int8 or a float8 dtype.  No transpose/permute is
    needed: the reference's 16-token FP8-MMA permutation
    (fused.cu:289-291) is an ldmatrix artifact of its CUDA kernel, which
    the Triton kernel does not need (SURVEY.md §7).
    """
    v = v.astype(jnp.float32)
    if smooth:
        v, v_mean = sub_mean(v)
    else:
        v_mean = None
    amax = jnp.max(jnp.abs(v), axis=-2)  # [b, h, d]
    qmax = _QMAX[jnp.dtype(dtype)]
    scale, r = inv_scale(amax, qmax)
    scaled = v * r[..., None, :]
    if jnp.dtype(dtype) == jnp.int8.dtype:
        v_q = jnp.clip(round_half_away(scaled), -127, 127).astype(jnp.int8)
    else:
        v_q = scaled.astype(dtype)
    return v_q, scale, v_mean


@functools.partial(jax.jit, static_argnames=("dtype",))
def per_token_quant_fp8(x: jax.Array, *, dtype=jnp.float8_e4m3fn):
    """Per-token (per-row) FP8 quantization (reference: quant.py:324-366
    ``torch_per_token_quant_fp8`` — the pure-torch 'exactly like CUDA
    kernel' spec).  Returns (x_fp8 [b,h,s,d], scales [b,h,s] f32)."""
    x = x.astype(jnp.float32)
    qmax = _QMAX[jnp.dtype(dtype)]
    amax = jnp.max(jnp.abs(x), axis=-1)
    scale = jnp.maximum(amax, 1e-30) / qmax
    return (x / scale[..., None]).astype(dtype), scale


@functools.partial(
    jax.jit, static_argnames=("dtype", "loss", "n_alpha", "smooth")
)
def per_channel_fp8_affine_autoalpha(
    v: jax.Array,
    *,
    dtype=jnp.float8_e4m3fn,
    loss: str = "huber",
    n_alpha: int = 12,
    alpha_min: float = 0.5,
    smooth: bool = True,
):
    """Per-channel affine FP8 quantization with an automatic saturation-
    alpha search (reference: quant.py:369-437
    ``quant_fp8_per_channel_affine_huber_autoalpha``).

    For each (b, h, d) channel, candidate scales ``alpha * amax / qmax``
    (alpha in [alpha_min, 1]) are evaluated by quantize-dequantize
    reconstruction loss (Huber or RMSE) and the per-channel argmin wins —
    deliberately saturating outliers when that lowers the overall error.
    Returns (v_q, scale [b,h,d], mean [b,h,d] or None, alpha [b,h,d]).
    """
    v = v.astype(jnp.float32)
    if smooth:
        mean = jnp.mean(v, axis=-2)
        vc = v - mean[..., None, :]
    else:
        mean = None
        vc = v
    qmax = _QMAX[jnp.dtype(dtype)]
    amax = jnp.maximum(jnp.max(jnp.abs(vc), axis=-2), 1e-30)  # [b,h,d]
    alphas = jnp.linspace(alpha_min, 1.0, n_alpha)  # [A]

    def loss_for(alpha):
        scale = amax * alpha / qmax  # [b,h,d]
        # saturate explicitly: e4m3 has no inf, overflow would NaN
        q = jnp.clip(vc / scale[..., None, :], -qmax, qmax).astype(dtype)
        rec = q.astype(jnp.float32) * scale[..., None, :]
        err = rec - vc
        if loss == "huber":
            delta = scale  # one-LSB delta, per channel
            a = jnp.abs(err)
            hub = jnp.where(
                a <= delta[..., None, :],
                0.5 * err * err,
                delta[..., None, :] * (a - 0.5 * delta[..., None, :]),
            )
            return jnp.sum(hub, axis=-2)  # [b,h,d]
        return jnp.sum(err * err, axis=-2)

    # sequential map: one alpha's quantize/dequant intermediates live at
    # a time (vmap would materialize n_alpha copies of V-sized arrays)
    losses = jax.lax.map(loss_for, alphas)  # [A,b,h,d]
    best = jnp.argmin(losses, axis=0)  # [b,h,d]
    alpha = alphas[best]
    scale = amax * alpha / qmax
    v_q = jnp.clip(vc / scale[..., None, :], -qmax, qmax).astype(dtype)
    return v_q, scale, mean, alpha


def quantize_qk(
    q: jax.Array,
    k: jax.Array,
    *,
    sm_scale: float,
    granularity: str = "per_token",
    block_size: int = 32,
    smooth_k: bool = True,
    bits: int = 8,
):
    """Full Q/K quantization preprocessing for the fused attention kernel.

    Mirrors the reference call sequence (core.py:793-806): compute ``km``,
    smooth K, quantize Q with ``sm_scale*log2e`` folded into its scales,
    quantize smoothed K.  Returns (q_i8, q_scale, k_i8, k_scale, km).
    ``km`` is needed for the LSE correction when ``return_lse=True``
    (reference: core.py:281-285).
    """
    if smooth_k:
        k_s, km = sub_mean(k)
    else:
        k_s, km = k, None
    q_i8, q_scale = quant_int8(
        q,
        granularity=granularity,
        block_size=block_size,
        scale_fold=sm_scale * LOG2E,
        bits=bits,
    )
    k_i8, k_scale = quant_int8(
        k_s, granularity=granularity, block_size=block_size, bits=bits
    )
    return q_i8, q_scale, k_i8, k_scale, km

"""Golden reference implementations (pure JAX, fp32, CPU-runnable).

These are the test oracles for the fused kernel, playing the role the
reference fork assigned to its unfused ROCm bring-up pipeline and commented
torch softmax path (reference: csrc/qattn/rocm/gfx942.hip:326-496) and to its
offline dump-diff comparators (reference: utils/count.py, count_per_row.py).

Two levels of oracle:

* :func:`attention_reference` — exact fp32 scaled-dot-product attention with
  causal/segment masking and natural-log LSE.  The *accuracy* target: the
  quantized kernel should be close to this (cosine similarity).
* :func:`quantized_attention_reference` — an unfused re-statement of exactly
  the arithmetic the fused kernel performs (INT8 QK^T, per-row dequant scales,
  base-2 softmax, quantized PV, smoothing corrections).  The *correctness*
  target: the fused kernel must match this to near machine precision.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

LOG2E = 1.4426950408889634
# Large-negative mask value; -inf would produce NaN via exp(-inf - (-inf))
# when an entire row is masked.
MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


def window_band_mask(sq: int, sk: int, window: int) -> jax.Array:
    """[1, 1, sq, sk] bool: key col within the last ``window`` positions
    of query row (top-left aligned; the upper edge comes from
    is_causal).  THE band convention — core.py's forward and the
    autodiff fallback backward must share it or gradients desync."""
    return (
        jnp.arange(sk)[None, :] > jnp.arange(sq)[:, None] - window
    )[None, None]


def _build_mask(
    sq: int,
    sk: int,
    *,
    is_causal: bool,
    q_segment_ids: jax.Array | None,
    kv_segment_ids: jax.Array | None,
    attn_mask: jax.Array | None,
    q_positions: jax.Array | None = None,
    kv_positions: jax.Array | None = None,
) -> jax.Array | None:
    """Combine causal / segment-id / position / boolean masks into one
    bool mask broadcastable against [b, h, sq, sk] scores.

    Every [b, sq, sk] component gets an explicit head axis before
    combining: a raw 3-D mask against 4-D scores (or against a 4-D
    attn_mask) would broadcast batch against heads — a shape error at
    best, silently wrong masking when the sizes happen to match."""
    def _bh(m):
        return m[:, None] if m.ndim == 3 else m

    mask = None
    if is_causal:
        row = jax.lax.broadcasted_iota(jnp.int32, (sq, sk), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (sq, sk), 1)
        mask = col <= row
    if q_positions is not None:
        pm = _bh(kv_positions[..., None, :] <= q_positions[..., :, None])
        mask = pm if mask is None else jnp.logical_and(mask, pm)
    if q_segment_ids is not None:
        # [.., sq] x [.., sk] -> [.., sq, sk] -> head axis
        seg = _bh(
            q_segment_ids[..., :, None] == kv_segment_ids[..., None, :]
        )
        mask = seg if mask is None else jnp.logical_and(mask, seg)
    if attn_mask is not None:
        if attn_mask.dtype == jnp.bool_:
            am = _bh(attn_mask)
            mask = am if mask is None else jnp.logical_and(mask, am)
        else:
            # additive float masks handled by caller (added to scores)
            raise TypeError("float attn_mask must be added to scores by caller")
    return mask


@functools.partial(
    jax.jit,
    static_argnames=("is_causal", "return_lse"),
)
def attention_reference(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    is_causal: bool = False,
    sm_scale: float | None = None,
    q_segment_ids: jax.Array | None = None,
    kv_segment_ids: jax.Array | None = None,
    q_positions: jax.Array | None = None,
    kv_positions: jax.Array | None = None,
    attn_bias: jax.Array | None = None,
    attn_mask: jax.Array | None = None,
    return_lse: bool = False,
):
    """Exact fp32 attention. q,k,v: [b, h, s, d] (HND layout).

    Supports GQA: k/v may have fewer heads; h_q % h_kv == 0.
    Returns o (same dtype as q) and, if requested, natural-log LSE [b, h, sq]
    (the ring-attention merge contract, reference: core.py:122-124).
    """
    out_dtype = q.dtype
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if sm_scale is None:
        sm_scale = d**-0.5
    if hq != hkv:
        rep = hq // hkv
        k = jnp.repeat(k, rep, axis=1)
        v = jnp.repeat(v, rep, axis=1)
    q32, k32, v32 = (x.astype(jnp.float32) for x in (q, k, v))
    s = jnp.einsum("bhqd,bhkd->bhqk", q32, k32, precision="highest") * sm_scale
    if attn_bias is not None:
        s = s + attn_bias.astype(jnp.float32)
    mask = _build_mask(
        sq,
        k.shape[2],
        is_causal=is_causal,
        q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids,
        q_positions=q_positions,
        kv_positions=kv_positions,
        attn_mask=attn_mask,
    )
    if mask is not None:
        s = jnp.where(mask, s, MASK_VALUE)
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    o = jnp.einsum(
        "bhqk,bhkd->bhqd", p / l, v32, precision="highest"
    ).astype(out_dtype)
    if return_lse:
        lse = (m + jnp.log(l))[..., 0]
        return o, lse
    return o


def quantized_attention_reference(
    q_i8: jax.Array,
    q_scale: jax.Array,
    k_i8: jax.Array,
    k_scale: jax.Array,
    v_q: jax.Array,
    v_scale: jax.Array | None = None,
    v_mean: jax.Array | None = None,
    *,
    is_causal: bool = False,
    q_segment_ids: jax.Array | None = None,
    kv_segment_ids: jax.Array | None = None,
    q_positions: jax.Array | None = None,
    kv_positions: jax.Array | None = None,
    attn_mask: jax.Array | None = None,
    score_col_bias: jax.Array | None = None,
    score_bias: jax.Array | None = None,
    return_lse: bool = False,
    out_dtype=jnp.bfloat16,
):
    """Unfused spec of the fused kernel's arithmetic.

    Mirrors the three-stage debug pipeline of the reference fork
    (gfx942.hip:234-638: INT8 GEMM -> host softmax -> quantized PV GEMM) but
    with this framework's scale layout:

    * ``q_scale``/``k_scale`` are **per-row** fp32 vectors [b, h, s]; every
      quantization granularity (per-token / per-subtile / per-block / per
      KV tile) expands to this form (the reference's per-thread / per-warp
      / per-block scale tensors encode CUDA lane layout in their shapes,
      reference: triton/quant_per_thread.py:184-185).
    * ``score_bias`` [b, 1|h, sq, sk], if given, is an additive bias in
      the base-2 logit domain (a natural-log bias times log2(e)).
    * ``q_scale`` has sm_scale * log2(e) pre-folded (reference: quant.py:95),
      so softmax is base-2: p = 2^(s - rowmax(s)).
    * ``v_q`` may be int8 (with per-channel ``v_scale`` [b, h, d]), fp8, or a
      bf16/fp32 tensor (``v_scale`` None).
    * ``v_mean`` [b, h, d], if given, is added back in the epilogue
      (smooth_v, reference: core.py:636-638).

    GQA: k/v may have fewer heads than q.
    Returns o and, if requested, the **base-2** LSE ``log2(l) + m`` exactly as
    the kernel stores it (reference: qk_int_sv_f8_cuda_sm89.cuh:694-706).
    """
    b, hq, sq, d = q_i8.shape
    hkv = k_i8.shape[1]
    if hq != hkv:
        rep = hq // hkv
        k_i8 = jnp.repeat(k_i8, rep, axis=1)
        k_scale = jnp.repeat(k_scale, rep, axis=1)
        v_q = jnp.repeat(v_q, rep, axis=1)
        if v_scale is not None:
            v_scale = jnp.repeat(v_scale, rep, axis=1)
        if v_mean is not None:
            v_mean = jnp.repeat(v_mean, rep, axis=1)
    sk = k_i8.shape[2]

    s_i32 = jax.lax.dot_general(
        q_i8,
        k_i8,
        dimension_numbers=(((3,), (3,)), ((0, 1), (0, 1))),
        preferred_element_type=jnp.int32,
    )
    s = (
        s_i32.astype(jnp.float32)
        * q_scale[..., :, None].astype(jnp.float32)
        * k_scale[..., None, :].astype(jnp.float32)
    )
    if score_col_bias is not None:
        # smooth_q correction (base-2 folded domain, [b, h, sk])
        s = s + score_col_bias[..., None, :].astype(jnp.float32)
    if score_bias is not None:
        s = s + score_bias.astype(jnp.float32)
    mask = _build_mask(
        sq,
        sk,
        is_causal=is_causal,
        q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids,
        attn_mask=attn_mask,
        q_positions=q_positions,
        kv_positions=kv_positions,
    )
    if mask is not None:
        s = jnp.where(mask, s, MASK_VALUE)
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp2(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    pv = jnp.einsum(
        "bhqk,bhkd->bhqd", p, v_q.astype(jnp.float32), precision="highest"
    )
    if v_scale is not None:
        pv = pv * v_scale[..., None, :].astype(jnp.float32)
    o = pv / l
    if v_mean is not None:
        o = o + v_mean[..., None, :].astype(jnp.float32)
    o = o.astype(out_dtype)
    if return_lse:
        lse2 = (jnp.log2(l) + m)[..., 0]
        return o, lse2
    return o


def merge_attention_partials(
    o_parts: list[jax.Array],
    lse_parts: list[jax.Array],
):
    """Merge partial attention outputs via their natural-log LSEs.

    The ring-attention merge: given per-shard (o_i, lse_i) computed over
    disjoint KV shards, reconstruct the global softmax attention.  This is
    the consumer of the ``return_lse`` contract (reference: core.py:122-124;
    xDiT performs this merge outside the reference repo).  A part with
    lse = -inf (no live key) has zero weight; a row no part reaches comes
    out o = 0, lse = -inf.
    """
    lse = jnp.stack(lse_parts, axis=0)  # [n, b, h, sq]
    m = jnp.max(lse, axis=0)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    w = jnp.exp(lse - m[None])  # [n, b, h, sq]
    denom = jnp.sum(w, axis=0)
    o = jnp.stack([x.astype(jnp.float32) for x in o_parts], axis=0)
    o_merged = jnp.sum(o * w[..., None], axis=0) / jnp.where(
        denom == 0.0, 1.0, denom
    )[..., None]
    lse_merged = jnp.where(denom == 0.0, -jnp.inf, m + jnp.log(denom))
    return o_merged.astype(o_parts[0].dtype), lse_merged

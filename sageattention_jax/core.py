"""Public API & dispatch (reference: sageattention/core.py).

``sageattn(q, k, v, ...)`` is a drop-in scaled-dot-product-attention
replacement (reference: core.py:80-158).  Every call quantizes Q/K (and
optionally V) with ``quant.py`` — plain jnp that XLA fuses into one pass
per tensor — and then runs one of two forward paths:

* ``impl="pallas"`` — the fused Hopper kernel (ops/attention_triton.py,
  Pallas through Triton).  It takes causal, GQA, ragged lengths,
  ``return_lse`` and every ``pv_dtype``.
* ``impl="xla"``    — the plain blockwise path (ops/blockwise.py): the
  quantized arithmetic over KV chunks, merged by LSE, never an [sq, sk]
  tensor.  It takes every option, including bool masks, additive biases,
  segment ids / varlen, positions, sliding windows, ``smooth_q`` and the
  per-row quantization granularities.
* ``impl="auto"``   — :func:`choose_impl`: the kernel on a GPU when the
  call's options are all kernel features, the blockwise path otherwise
  and on the CPU.

All entry points accept HND ([b, h, s, d]) or NHD ([b, s, h, d]) layouts
(reference: core.py tensor_layout), GQA (h_q a multiple of h_kv), causal
masking, and ``return_lse`` (natural-log logsumexp, the ring-attention merge
contract, reference: core.py:122-124).
"""

from __future__ import annotations

import functools
from typing import Literal, NamedTuple

import jax
import jax.numpy as jnp

from sageattention_jax import quant as quant_mod
from sageattention_jax.ops import attention_triton, blockwise

LOG2E = 1.4426950408889634

Layout = Literal["HND", "NHD"]


def choose_impl(
    impl: str,
    *,
    backend: str,
    kernel_ok: bool,
    interpret: bool = False,
) -> str:
    """The forward path of one call: "pallas" (the fused kernel) or
    "xla" (the blockwise plain path).

    ``kernel_ok`` says whether every option of the call is a kernel
    feature (see :func:`kernel_features_ok`).  ``auto`` takes the kernel
    on a GPU when it can and the blockwise path otherwise; on the CPU it
    always takes the blockwise path.  An explicit ``impl="pallas"`` off
    the GPU needs ``interpret=True`` (the tests' switch)."""
    if impl == "auto":
        if backend == "gpu":
            return "pallas" if kernel_ok else "xla"
        if backend == "cpu":
            return "xla"
        raise ValueError(
            f"sageattn has no path for the {backend!r} backend: it runs "
            "on a GPU (fused kernel) or the CPU (plain blockwise path)"
        )
    if impl == "pallas":
        if not kernel_ok:
            raise ValueError(
                "impl='pallas' takes causal, GQA, ragged lengths, "
                "return_lse and pv_dtype only; masks, biases, segment "
                "ids, positions, window, smooth_q and per-row "
                "granularities run with impl='xla' (or 'auto')"
            )
        if backend != "gpu" and not interpret:
            raise ValueError(
                "impl='pallas' compiles for the GPU; pass interpret=True "
                "to run the kernel in the Pallas interpreter"
            )
        return "pallas"
    if impl == "xla":
        return "xla"
    raise ValueError(f"impl must be 'auto', 'pallas' or 'xla', got {impl!r}")


def kernel_features_ok(
    *,
    masked: bool,
    segments: bool,
    positions: bool,
    window: int | None,
    smooth_q: bool,
    qk_quant_gran: str,
) -> bool:
    """True when every option of a call is one the fused kernel takes."""
    return not (
        masked or segments or positions or window is not None or smooth_q
    ) and qk_quant_gran == "auto"


def default_blocks(head_dim: int) -> tuple[int, int]:
    """(block_q, block_k) for a head dim.  block_k is also the K
    quantization group on both paths, so they share one numerics."""
    bq, bk, _, _ = attention_triton.DEFAULT_TILES[
        attention_triton.padded_head_dim(head_dim)
    ]
    return bq, bk


def _to_hnd(x: jax.Array, layout: Layout) -> jax.Array:
    if layout == "HND":
        return x
    if layout == "NHD":
        return jnp.swapaxes(x, 1, 2)
    raise ValueError(f"tensor_layout must be 'HND' or 'NHD', got {layout!r}")


def _from_hnd(x: jax.Array, layout: Layout) -> jax.Array:
    return x if layout == "HND" else jnp.swapaxes(x, 1, 2)


class Quantized(NamedTuple):
    """The quantized operands of one call (HND, unpadded)."""

    q_i8: jax.Array          # [b, hq, sq, d] int8
    q_scale: jax.Array       # [b, hq, sq] f32, sm_scale * log2e folded in
    k_i8: jax.Array          # [b, hkv, sk, d] int8 (smoothed)
    k_scale: jax.Array       # [b, hkv, n_tiles] per tile, or [b, hkv, sk]
    km: jax.Array | None     # [b, hkv, d] K mean (smooth_k)
    v_q: jax.Array           # [b, hkv, sk, d] bf16 / int8 / fp8
    v_scale: jax.Array | None
    v_mean: jax.Array | None
    score_col_bias: jax.Array | None  # [b, hq, sk] base-2 (smooth_q)
    k_group: int             # K rows per k_scale entry (1: per row)

    def k_scale_rows(self) -> jax.Array:
        """K scales expanded to one per key row [b, hkv, sk]."""
        if self.k_group == 1:
            return self.k_scale
        sk = self.k_i8.shape[2]
        return jnp.repeat(self.k_scale, self.k_group, axis=-1)[..., :sk]

    def v_eff(self) -> jax.Array:
        """The V the forward multiplies by P: dequantized codes plus the
        smooth_v mean, in f32."""
        v = self.v_q.astype(jnp.float32)
        if self.v_scale is not None:
            v = v * self.v_scale[..., None, :]
        if self.v_mean is not None:
            v = v + self.v_mean[..., None, :]
        return v


def quantize_operands(
    q, k, v, *, sm_scale: float, qk_quant_gran: str, pv_dtype: str,
    smooth_k: bool, smooth_q: bool, smooth_v: bool, qk_bits: int,
    k_group: int,
) -> Quantized:
    """Q/K/V quantization shared by the forward and the backward, so the
    backward recomputes exactly the codes the forward used.

    ``qk_quant_gran="auto"``: per-token Q scales and one K scale per
    ``k_group`` rows of mean-smoothed K (the kernel's KV tile).  The
    other granularities give per-row scales (blockwise path only)."""
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    km = jnp.mean(k.astype(jnp.float32), axis=-2) if smooth_k else None
    score_col_bias = None
    q_in = q
    if smooth_q:
        # SageAttention2's Q-mean smoothing: quantize q - qm and add the
        # per-column correction qm . k_smoothed back to the logits (q . k
        # = (q-qm).(k-km) + qm.(k-km) + row constants the softmax drops;
        # PAPERS.md arXiv 2411.10958)
        qm = jnp.mean(q.astype(jnp.float32), axis=-2)  # [b, hq, d]
        q_in = (q.astype(jnp.float32) - qm[..., None, :]).astype(q.dtype)
        k_c = k.astype(jnp.float32)
        if km is not None:
            k_c = k_c - km[..., None, :]
        # grouped einsum: no repeat of K across the query-head group
        qm_g = qm.reshape(b, hkv, hq // hkv, d)
        score_col_bias = (
            jnp.einsum("bhgd,bhsd->bhgs", qm_g, k_c).reshape(b, hq, -1)
            * sm_scale * LOG2E
        )
    if qk_quant_gran == "auto":
        k_sm = k.astype(jnp.float32) - km[..., None, :] if smooth_k else k
        q_i8, q_scale = quant_mod.quant_int8(
            q_in, granularity="per_token", scale_fold=sm_scale * LOG2E,
            bits=qk_bits,
        )
        k_i8, k_scale = quant_mod.quant_int8_block_scales(
            k_sm, group=k_group, bits=qk_bits
        )
    else:
        k_group = 1
        q_i8, q_scale, k_i8, k_scale, km = quant_mod.quantize_qk(
            q_in, k, sm_scale=sm_scale, granularity=qk_quant_gran,
            smooth_k=smooth_k, bits=qk_bits,
        )
    v_scale = v_mean = None
    if pv_dtype in ("int8", "fp8", "fp8_e5m2"):
        # both reference fp8 codings (numeric_conversion.cuh:80-113)
        dtype = {
            "int8": jnp.int8,
            "fp8": jnp.float8_e4m3fn,
            "fp8_e5m2": jnp.float8_e5m2,
        }[pv_dtype]
        v_q, v_scale, v_mean = quant_mod.per_channel_quant(
            v, dtype=dtype, smooth=smooth_v
        )
    elif pv_dtype == "bf16":
        if smooth_v:
            v_c, v_mean = quant_mod.sub_mean(v)
            v_q = v_c.astype(jnp.bfloat16)
        else:
            v_q = v.astype(jnp.bfloat16)
    else:
        raise ValueError(f"unknown pv_dtype {pv_dtype!r}")
    return Quantized(q_i8, q_scale, k_i8, k_scale, km, v_q, v_scale,
                     v_mean, score_col_bias, k_group)


def _normalize_mask(m, name: str, b: int, hq: int, sq: int, sk: int):
    """Bring a bool mask or additive bias to [b, 1|hq, sq, sk] (the
    reference broadcast-expands both forms the same way, reference:
    core.py:306-316).  Size-1 query/key dims (torch-style (B,1,1,S)
    key-padding masks) broadcast lazily under jit."""
    if m.ndim == 2:
        m = m[None, None]
    elif m.ndim == 3:
        m = m[:, None]
    if m.shape[0] == 1 and b > 1:
        m = jnp.broadcast_to(m, (b,) + m.shape[1:])
    if m.shape[1] not in (1, hq):
        raise ValueError(f"{name} head dim {m.shape[1]} must be 1 or {hq}")
    if m.shape[-2:] != (sq, sk):
        if not all(ms in (1, full) for ms, full in zip(m.shape[-2:], (sq, sk))):
            raise ValueError(
                f"{name} trailing dims {m.shape[-2:]} must be ({sq}, {sk}) "
                "or broadcastable (size 1)"
            )
        m = jnp.broadcast_to(m, m.shape[:-2] + (sq, sk))
    return m


@functools.partial(
    jax.jit,
    static_argnames=(
        "is_causal", "sm_scale", "qk_quant_gran", "pv_dtype", "smooth_k",
        "smooth_q", "smooth_v", "return_lse", "block_q", "block_k",
        "impl", "qk_bits", "window", "interpret",
    ),
)
def _sageattn_hnd(
    q,
    k,
    v,
    q_segment_ids,
    kv_segment_ids,
    q_positions,
    kv_positions,
    attn_bias,
    attn_mask,
    *,
    is_causal: bool,
    sm_scale: float | None,
    qk_quant_gran: str,
    pv_dtype: str,
    smooth_k: bool,
    smooth_v: bool,
    return_lse: bool,
    smooth_q: bool = False,
    block_q: int | None = None,
    block_k: int | None = None,
    impl: str = "auto",
    qk_bits: int = 8,
    window: int | None = None,
    interpret: bool = False,
):
    """Quantize-then-attend pipeline on HND tensors (the call sequence of
    reference core.py:655-905: quant(Q, K, V) + one attention pass)."""
    out_dtype = q.dtype
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d**-0.5
    # segment ids / positions only mean anything in pairs; a lone side
    # would be silently ignored
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError(
            "q_segment_ids and kv_segment_ids must be passed together"
        )
    if (q_positions is None) != (kv_positions is None):
        raise ValueError(
            "q_positions and kv_positions must be passed together"
        )
    if window is not None and not is_causal:
        raise ValueError("window (sliding-window attention) requires "
                         "is_causal=True")
    if attn_mask is not None and attn_mask.dtype != jnp.bool_:
        # float masks are additive biases (the reference accepts both on
        # its triton path, reference: core.py:306-316)
        attn_bias = attn_mask if attn_bias is None else attn_bias + attn_mask
        attn_mask = None
    if attn_mask is not None:
        attn_mask = _normalize_mask(attn_mask, "attn_mask", b, hq, sq, sk)
    if attn_bias is not None:
        attn_bias = _normalize_mask(attn_bias, "attn_bias", b, hq, sq, sk)

    bq_auto, bk_auto = default_blocks(d)
    block_q = block_q or bq_auto
    block_k = block_k or bk_auto
    impl = choose_impl(
        impl,
        backend=jax.default_backend(),
        kernel_ok=kernel_features_ok(
            masked=attn_mask is not None or attn_bias is not None,
            segments=q_segment_ids is not None,
            positions=q_positions is not None,
            window=window,
            smooth_q=smooth_q,
            qk_quant_gran=qk_quant_gran,
        ),
        interpret=interpret,
    )
    qz = quantize_operands(
        q, k, v, sm_scale=sm_scale, qk_quant_gran=qk_quant_gran,
        pv_dtype=pv_dtype, smooth_k=smooth_k, smooth_q=smooth_q,
        smooth_v=smooth_v, qk_bits=qk_bits, k_group=block_k,
    )
    if impl == "pallas":
        out = attention_triton.sage_attention_fwd(
            qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale, qz.v_q, qz.v_scale,
            qz.v_mean, is_causal=is_causal, return_lse=return_lse,
            block_q=block_q, block_k=block_k, out_dtype=out_dtype,
            interpret=interpret,
        )
        o, lse2 = out if return_lse else (out, None)
    else:
        score_bias = None
        if attn_bias is not None:
            # -inf bias entries are masked keys; keeping them out of the
            # logits keeps fully-dead rows NaN-free
            dead = attn_bias == -jnp.inf
            keep = jnp.logical_not(dead)
            attn_mask = keep if attn_mask is None else attn_mask & keep
            score_bias = jnp.where(dead, 0.0, attn_bias.astype(jnp.float32))
            score_bias = score_bias * LOG2E
        o, lse2 = blockwise.attention_fwd(
            qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale_rows(), qz.v_q,
            qz.v_scale, qz.v_mean, is_causal=is_causal, window=window,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            q_positions=q_positions, kv_positions=kv_positions,
            attn_mask=attn_mask, score_bias=score_bias,
            score_col_bias=qz.score_col_bias,
            chunk=blockwise.default_chunk(block_k), out_dtype=out_dtype,
        )
    if not return_lse:
        return o
    lse = lse2 / LOG2E
    if qz.km is not None:
        # smoothing shifts every logit of row i by q_i . km (reference:
        # core.py:281-285, 795-799)
        lse = lse + jnp.einsum(
            "bhqd,bhd->bhq", q.astype(jnp.float32),
            jnp.repeat(qz.km, hq // hkv, axis=1),
        ) * sm_scale
    return o, lse


def _entry(
    q,
    k,
    v,
    tensor_layout: Layout = "HND",
    is_causal: bool = False,
    sm_scale: float | None = None,
    return_lse: bool = False,
    *,
    qk_quant_gran: str = "auto",
    pv_dtype: str = "int8",
    smooth_k: bool = True,
    smooth_q: bool = False,
    smooth_v: bool = False,
    q_segment_ids=None,
    kv_segment_ids=None,
    q_positions=None,
    kv_positions=None,
    attn_bias=None,
    attn_mask=None,
    block_q: int | None = None,
    block_k: int | None = None,
    impl: str = "auto",
    qk_bits: int = 8,
    window: int | None = None,
    interpret: bool = False,
):
    out = _sageattn_hnd(
        _to_hnd(q, tensor_layout),
        _to_hnd(k, tensor_layout),
        _to_hnd(v, tensor_layout),
        q_segment_ids,
        kv_segment_ids,
        q_positions,
        kv_positions,
        attn_bias,
        attn_mask,
        is_causal=is_causal,
        sm_scale=sm_scale,
        qk_quant_gran=qk_quant_gran,
        pv_dtype=pv_dtype,
        smooth_k=smooth_k,
        smooth_q=smooth_q,
        smooth_v=smooth_v,
        return_lse=return_lse,
        block_q=block_q,
        block_k=block_k,
        impl=impl,
        qk_bits=qk_bits,
        window=window,
        interpret=interpret,
    )
    if return_lse:
        o, lse = out
        return _from_hnd(o, tensor_layout), lse
    return _from_hnd(out, tensor_layout)


_TENSOR_ARGS = ("q_segment_ids", "kv_segment_ids", "q_positions",
                "kv_positions", "attn_bias", "attn_mask")


def sageattn(
    q,
    k,
    v,
    tensor_layout: Layout = "HND",
    is_causal: bool = False,
    sm_scale: float | None = None,
    return_lse: bool = False,
    **kwargs,
):
    """Auto-dispatch entry point (reference: core.py:80-158 ``sageattn``).

    Drop-in replacement for scaled-dot-product attention: int8 Q·Kᵀ
    (per-token Q scales, per-tile K scales, K mean-smoothing) and bf16
    P·V by default — the reference's accuracy-first choice; pass
    ``pv_dtype="int8"`` / ``"fp8"`` (or call the explicit entry points)
    for quantized V.  :func:`choose_impl` picks the forward path.

    Differentiable w.r.t. q/k/v (quantized forward, straight-through
    blockwise backward — see ops/autodiff.py) whenever no segment /
    position / mask tensors are passed, and w.r.t. an additive
    ``attn_bias`` too; the reference is forward-only.
    """
    kwargs.setdefault("pv_dtype", "bf16")
    from sageattention_jax.ops import autodiff

    bias = kwargs.get("attn_bias")
    bias_only = (
        bias is not None
        and all(kwargs.get(a) is None for a in _TENSOR_ARGS if a != "attn_bias")
        and getattr(bias, "dtype", None) != jnp.bool_
    )
    if all(kwargs.get(a) is None for a in _TENSOR_ARGS) or bias_only:
        kwargs = {k_: v_ for k_, v_ in kwargs.items()
                  if v_ is not None and k_ != "attn_bias"}
        qh, kh, vh = (_to_hnd(x, tensor_layout) for x in (q, k, v))
        statics = dict(is_causal=is_causal, sm_scale=sm_scale,
                       return_lse=return_lse, **kwargs)
        if bias_only:
            out = autodiff.differentiable_sageattn_bias(qh, kh, vh, bias,
                                                        **statics)
        else:
            out = autodiff.differentiable_sageattn(qh, kh, vh, **statics)
        if return_lse:
            return _from_hnd(out[0], tensor_layout), out[1]
        return _from_hnd(out, tensor_layout)
    return _entry(
        q, k, v, tensor_layout, is_causal, sm_scale, return_lse, **kwargs
    )


def sageattn_qk_int8_pv_int8(q, k, v, tensor_layout="HND", is_causal=False,
                             sm_scale=None, return_lse=False, **kw):
    """INT8 QK^T + INT8 PV with per-channel V scales (the int8 analogue of
    the reference FP8 path ``sageattn_qk_int8_pv_fp8_cuda``, reference:
    core.py:655-905).  The kernel casts the V codes to bf16 in registers
    for the P·V product."""
    kw.setdefault("pv_dtype", "int8")
    return _entry(q, k, v, tensor_layout, is_causal, sm_scale, return_lse, **kw)


def sageattn_qk_int8_pv_bf16(q, k, v, tensor_layout="HND", is_causal=False,
                             sm_scale=None, return_lse=False, **kw):
    """INT8 QK^T + bf16 PV (fp32 accum) — the accuracy-fallback analogue of
    ``sageattn_qk_int8_pv_fp16_cuda/_triton`` (reference: core.py:160-360,
    479-653).  Supports smooth_v (reference: core.py:636-638)."""
    kw.setdefault("pv_dtype", "bf16")
    return _entry(q, k, v, tensor_layout, is_causal, sm_scale, return_lse, **kw)


def sageattn_qk_int8_pv_fp8(q, k, v, tensor_layout="HND", is_causal=False,
                            sm_scale=None, return_lse=False, **kw):
    """INT8 QK^T + FP8(e4m3) V (reference: core.py:655-905).

    V is stored e4m3 with per-channel scales (half the bytes of bf16 V);
    the kernel casts the codes to bf16 in registers for P·V.  Pass
    ``pv_dtype="fp8_e5m2"`` for the e5m2 coding (the reference converts
    both, csrc/numeric_conversion.cuh:80-113)."""
    kw.setdefault("pv_dtype", "fp8")
    return _entry(q, k, v, tensor_layout, is_causal, sm_scale, return_lse, **kw)


def sageattn_varlen(
    q,
    k,
    v,
    cu_seqlens_q,
    cu_seqlens_k,
    max_seqlen_q: int | None = None,
    max_seqlen_k: int | None = None,
    is_causal: bool = False,
    sm_scale: float | None = None,
    return_lse: bool = False,
    *,
    smooth_k_mode: str = "global",
    **kwargs,
):
    """Ragged-batch attention over FlashAttention-style packed tensors
    (reference: core.py:362-477 ``sageattn_varlen``).

    q/k/v: [total_tokens, heads, head_dim]; cu_seqlens_*: [batch+1] int32
    cumulative sequence starts.  Internally this is segment-id masking on
    the blockwise path.  ``max_seqlen_q/k`` are accepted for signature
    parity and not needed.

    ``smooth_k_mode``: "global" matches the reference — ONE K mean over
    all packed tokens (reference: core.py:462 and its caveat comment);
    "per_segment" centers each sequence by its own K mean (exactly valid:
    rows only attend within their segment, so the subtracted constant is
    per-row) — strictly better quantization for heterogeneous batches.
    """
    del max_seqlen_q, max_seqlen_k
    if is_causal:
        # Causal varlen requires identical packing of q and k so absolute
        # positions order correctly within each segment.
        if q.shape[0] != k.shape[0]:
            raise ValueError("causal varlen requires matching q/k packing")
        if cu_seqlens_q.shape != cu_seqlens_k.shape:
            raise ValueError(
                "causal varlen requires cu_seqlens_q and cu_seqlens_k of "
                f"the same shape, got {cu_seqlens_q.shape} vs "
                f"{cu_seqlens_k.shape}"
            )
        import numpy as _np

        try:  # concrete cu_seqlens (the common case): check values
            cq, ck_ = _np.asarray(cu_seqlens_q), _np.asarray(cu_seqlens_k)
            if not _np.array_equal(cq, ck_):
                raise ValueError(
                    "causal varlen requires cu_seqlens_q == cu_seqlens_k "
                    "(mismatched packings would silently compute wrong "
                    "causal masks)"
                )
        except jax.errors.TracerArrayConversionError:
            pass  # traced: shape-checked above, values are the caller's
            # contract
    total_q, h, d = q.shape
    total_k = k.shape[0]
    seg_q = jnp.searchsorted(
        cu_seqlens_q, jnp.arange(total_q, dtype=jnp.int32), side="right"
    ).astype(jnp.int32)
    seg_k = jnp.searchsorted(
        cu_seqlens_k, jnp.arange(total_k, dtype=jnp.int32), side="right"
    ).astype(jnp.int32)
    qh = jnp.swapaxes(q, 0, 1)[None]  # [1, h, total_q, d]
    kh = jnp.swapaxes(k, 0, 1)[None]
    vh = jnp.swapaxes(v, 0, 1)[None]

    smooth_k = kwargs.pop("smooth_k", True)
    lse_corr_seg = None
    if smooth_k and smooth_k_mode == "per_segment":
        # center K by per-segment means; exact because attention never
        # crosses segments (the per-row constant drops in softmax).  The
        # pipeline then runs with smooth_k=False on pre-centered K.
        n_seg = cu_seqlens_k.shape[0]  # upper bound on segment count
        kf = k.astype(jnp.float32)  # [total_k, hkv, d]
        seg_sum = jax.ops.segment_sum(kf, seg_k, num_segments=n_seg + 1)
        counts = jax.ops.segment_sum(
            jnp.ones((total_k,), jnp.float32), seg_k, num_segments=n_seg + 1
        )
        km_seg = seg_sum / jnp.maximum(counts, 1.0)[:, None, None]
        kh = jnp.swapaxes(kf - km_seg[seg_k], 0, 1)[None].astype(k.dtype)
        smooth_k = False
        if return_lse:
            # lse correction per row: q_i . km(segment of i) * sm_scale
            sm = sm_scale if sm_scale is not None else d**-0.5
            km_q_rows = jnp.repeat(km_seg[seg_q], h // k.shape[1], axis=1)
            lse_corr_seg = (
                jnp.einsum(
                    "thd,thd->th", q.astype(jnp.float32), km_q_rows
                ).T[None]
                * sm
            )  # [1, h, total_q]
    elif smooth_k_mode not in ("global", "per_segment"):
        raise ValueError(f"unknown smooth_k_mode {smooth_k_mode!r}")

    hnd_kwargs = dict(
        qk_quant_gran=kwargs.pop("qk_quant_gran", "auto"),
        pv_dtype=kwargs.pop("pv_dtype", "int8"),
        smooth_v=kwargs.pop("smooth_v", False),
        block_q=kwargs.pop("block_q", None),
        block_k=kwargs.pop("block_k", None),
        impl=kwargs.pop("impl", "auto"),
        qk_bits=kwargs.pop("qk_bits", 8),
        smooth_q=kwargs.pop("smooth_q", False),
    )
    if kwargs:
        # silently dropping e.g. window=... would compute the wrong
        # attention pattern; fail BEFORE dispatching the attention
        raise TypeError(
            f"sageattn_varlen got unexpected kwargs {sorted(kwargs)}"
        )
    out = _sageattn_hnd(
        qh, kh, vh, seg_q[None], seg_k[None], None, None, None, None,
        is_causal=is_causal, sm_scale=sm_scale, smooth_k=smooth_k,
        return_lse=return_lse, **hnd_kwargs,
    )
    if return_lse:
        o, lse = out
        if lse_corr_seg is not None:
            lse = lse + lse_corr_seg
        return jnp.swapaxes(o[0], 0, 1), lse[0]
    return jnp.swapaxes(out[0], 0, 1)

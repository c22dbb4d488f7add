"""Autodiff support: quantized forward, straight-through blockwise backward.

The reference is forward-only (inference kernels; no backward exists,
SURVEY.md §2).  Training/fine-tuning through sage attention is still
useful (QAT-style), so the framework defines a custom VJP: the forward is
the quantized attention (fused kernel or blockwise path, core.py), the
backward is ``blockwise.attention_bwd`` — the straight-through gradient
of that forward, recomputing P per KV chunk from the saved LSE and the
same quantized Q/K codes (``core.quantize_operands`` recomputes them
bit for bit).  Residuals are (q, k, v, o, lse): O(s * d), like flash
attention.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sageattention_jax.ops import blockwise

LOG2E = 1.4426950408889634

# forward options the backward does not need (they pick a forward path or
# tile, not the arithmetic being differentiated)
_FWD_ONLY = ("impl", "block_q", "interpret")


def _grads(q, k, v, o, lse_nat, do, dlse, fwd_kwargs, bias=None,
           need_dbias=False):
    """Blockwise straight-through VJP of ``core._entry(q, k, v, **kw)``."""
    from sageattention_jax import core

    kw = {k_: v_ for k_, v_ in fwd_kwargs.items() if k_ not in _FWD_ONLY}
    d = q.shape[-1]
    sm_scale = kw.get("sm_scale") or d**-0.5
    block_k = kw.get("block_k") or core.default_blocks(d)[1]
    qz = core.quantize_operands(
        q, k, v, sm_scale=sm_scale,
        qk_quant_gran=kw.get("qk_quant_gran", "auto"),
        pv_dtype=kw.get("pv_dtype", "int8"),
        smooth_k=kw.get("smooth_k", True),
        smooth_q=kw.get("smooth_q", False),
        smooth_v=kw.get("smooth_v", False),
        qk_bits=kw.get("qk_bits", 8),
        k_group=block_k,
    )
    # the forward's natural-log LSE back to the kernel's base-2 LSE of
    # the smoothed logits
    lse = lse_nat
    if qz.km is not None:
        hq, hkv = q.shape[1], k.shape[1]
        lse = lse - jnp.einsum(
            "bhqd,bhd->bhq", q.astype(jnp.float32),
            jnp.repeat(qz.km, hq // hkv, axis=1),
        ) * sm_scale
    score_bias = None
    if bias is not None:
        score_bias = core._normalize_mask(
            bias, "attn_bias", q.shape[0], q.shape[1], q.shape[2],
            k.shape[2],
        ).astype(jnp.float32) * LOG2E
    out = blockwise.attention_bwd(
        q, k, qz.v_eff(), o, lse * LOG2E, do, dlse, qz.q_i8, qz.q_scale,
        qz.k_i8, qz.k_scale_rows(), sm_scale=sm_scale,
        is_causal=kw.get("is_causal", False), window=kw.get("window"),
        score_bias=score_bias, score_col_bias=qz.score_col_bias,
        need_dbias=need_dbias, chunk=blockwise.default_chunk(block_k),
    )
    dq, dk, dv = out[:3]
    grads = (dq, dk, dv.astype(v.dtype))
    if need_dbias:
        return grads + (_sum_to_shape(out[3], bias.shape).astype(bias.dtype),)
    return grads


def _sum_to_shape(x: jax.Array, shape: tuple) -> jax.Array:
    """Reduce a [b, h, sq, sk] cotangent to a broadcastable bias shape
    (2-D [sq, sk], 3-D [b, sq, sk] or 4-D with size-1 dims)."""
    if len(shape) == 2:
        return x.sum(axis=(0, 1))
    if len(shape) == 3:
        x = x.sum(axis=1)
    axes = tuple(i for i, n in enumerate(shape) if n == 1 and x.shape[i] != 1)
    return x.sum(axis=axes, keepdims=True)


def attention_vjp(q, k, v, do, dlse=None, *, bias=None, **fwd_kwargs):
    """Gradients of ``core._entry(q, k, v, **fwd_kwargs)`` (HND) for the
    cotangents ``do`` and, optionally, ``dlse`` of the natural-log LSE:
    the custom VJP's backward, callable directly.  With ``bias`` the
    additive bias's cotangent is returned as a fourth gradient."""
    from sageattention_jax import core

    fwd_kwargs.pop("return_lse", None)
    o, lse = core._entry(q, k, v, attn_bias=bias, return_lse=True,
                         **fwd_kwargs)
    return _grads(q, k, v, o, lse, do, dlse, fwd_kwargs, bias=bias,
                  need_dbias=bias is not None)


@functools.lru_cache(maxsize=None)
def _cached(fwd_statics):
    fwd_kwargs = dict(fwd_statics)
    return_lse = fwd_kwargs.get("return_lse", False)

    from sageattention_jax import core

    @jax.custom_vjp
    def f(q, k, v):
        return core._entry(q, k, v, **fwd_kwargs)

    def fwd(q, k, v):
        o, lse = core._entry(q, k, v, **{**fwd_kwargs, "return_lse": True})
        out = (o, lse) if return_lse else o
        return out, (q, k, v, o, lse)

    def bwd(res, ct):
        q, k, v, o, lse = res
        do, dlse = ct if return_lse else (ct, None)
        return _grads(q, k, v, o, lse, do, dlse, fwd_kwargs)

    f.defvjp(fwd, bwd)
    return f


@functools.lru_cache(maxsize=None)
def _cached_bias(fwd_statics):
    """custom_vjp over (q, k, v, attn_bias): the bias cotangent is dS, a
    [b, h, sq, sk] tensor — its footprint is inherent to asking for
    dBias.  Beyond the reference (forward-only): trainable
    relative-position / ALiBi-style biases."""
    fwd_kwargs = dict(fwd_statics)
    return_lse = fwd_kwargs.get("return_lse", False)

    from sageattention_jax import core

    @jax.custom_vjp
    def f(q, k, v, bias):
        return core._entry(q, k, v, attn_bias=bias, **fwd_kwargs)

    def fwd(q, k, v, bias):
        o, lse = core._entry(
            q, k, v, attn_bias=bias, **{**fwd_kwargs, "return_lse": True}
        )
        out = (o, lse) if return_lse else o
        return out, (q, k, v, bias, o, lse)

    def bwd(res, ct):
        q, k, v, bias, o, lse = res
        do, dlse = ct if return_lse else (ct, None)
        return _grads(q, k, v, o, lse, do, dlse, fwd_kwargs, bias=bias,
                      need_dbias=True)

    f.defvjp(fwd, bwd)
    return f


def differentiable_sageattn_bias(q, k, v, bias, **kwargs):
    """sageattn with an additive bias, differentiable w.r.t. q, k, v AND
    the bias.  HND layout; kwargs must be hashable statics."""
    return _cached_bias(tuple(sorted(kwargs.items())))(q, k, v, bias)


def differentiable_sageattn(q, k, v, **kwargs):
    """sageattn with gradients (w.r.t. q, k, v).

    kwargs must be hashable statics (no segment/position/bias tensors).
    """
    layout = kwargs.pop("tensor_layout", "HND")
    if layout == "NHD":
        # normalize here so the VJP always sees HND
        q, k, v = (jnp.swapaxes(x, 1, 2) for x in (q, k, v))
    elif layout != "HND":
        raise ValueError(f"tensor_layout must be 'HND' or 'NHD', got {layout!r}")
    out = _cached(tuple(sorted(kwargs.items())))(q, k, v)
    if layout == "NHD":
        if kwargs.get("return_lse", False):
            return jnp.swapaxes(out[0], 1, 2), out[1]
        return jnp.swapaxes(out, 1, 2)
    return out

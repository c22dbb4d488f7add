"""Drop-in for ``jax.nn.dot_product_attention``.

The reference's integration story is "assign our op over the framework's
SDPA entry point" (reference: example/cogvideox-2b.py:16-23 monkey-patches
``torch.nn.functional.scaled_dot_product_attention``).  The torch-side
analogue here is :mod:`sageattention_jax.interop.torch_adapter`; this
module is the JAX-ecosystem side: a function with the exact signature of
:func:`jax.nn.dot_product_attention` (flax / MaxText-style [B, T, N, H]
tensors) that runs the fused quantized Pallas kernel, plus
:func:`patch_jax_sdpa` to install it globally so existing flax models
switch without touching their code.

Signature mapping (jax.nn name -> sageattn kwarg):

* BTNH layout               -> ``tensor_layout="NHD"``
* ``bias`` (additive float) -> ``attn_bias``   (XLA fallback path)
* ``mask`` (bool, True=keep)-> ``attn_mask``   (in-kernel block-skip)
* ``scale``                 -> ``sm_scale``
* ``query_seq_lengths`` /
  ``key_value_seq_lengths`` -> segment ids (padded q/kv rows live in
  distinct never-matching segments; padded query rows are zeroed in the
  output, where jax.nn leaves them unspecified)
* ``local_window_size``     -> causal: the native sliding-band kernel
  (``window = left + 1``); non-causal: an explicit band mask
* ``return_residual``       -> ``return_lse`` (natural-log LSE,
  transposed to jax.nn's [B, T, N])
* ``implementation``        -> accepted and ignored ('xla'/'cudnn' name
  *that* library's backends; everything here runs the one Pallas family)

Extra ``**sage_kwargs`` (``pv_dtype``, ``qk_quant_gran``, ``smooth_k``,
``qk_bits``, ...) pass straight through to :func:`sageattention_jax.sageattn`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sageattention_jax import core

__all__ = ["dot_product_attention", "patch_jax_sdpa"]


def _seq_length_segments(lengths, seq_len: int, pad_segment: int):
    """[B] lengths -> [B, seq_len] int32 segment ids: valid rows 0, padded
    rows ``pad_segment`` (chosen distinct per side so padding never
    attends anything)."""
    lengths = jnp.asarray(lengths)
    pos = jnp.arange(seq_len, dtype=jnp.int32)[None, :]
    return jnp.where(pos < lengths[:, None], 0, pad_segment).astype(jnp.int32)


def dot_product_attention(
    query,
    key,
    value,
    bias=None,
    mask=None,
    *,
    scale: float | None = None,
    is_causal: bool = False,
    query_seq_lengths=None,
    key_value_seq_lengths=None,
    local_window_size: int | tuple[int, int] | None = None,
    implementation: str | None = None,
    return_residual: bool = False,
    **sage_kwargs,
):
    """``jax.nn.dot_product_attention``-compatible quantized attention.

    Inputs are [B, T, N, H] / [B, S, K, H] (K may divide N: GQA).  See the
    module docstring for the parameter mapping.  ``implementation`` is
    accepted for signature compatibility and ignored.
    """
    del implementation
    if query.ndim != 4 or key.ndim != 4 or value.ndim != 4:
        raise ValueError(
            "expected [B, T, N, H] rank-4 query/key/value, got ranks "
            f"{query.ndim}/{key.ndim}/{value.ndim}"
        )
    b, sq = query.shape[0], query.shape[1]
    sk = key.shape[1]

    kwargs = dict(sage_kwargs)
    if bias is not None:
        kwargs["attn_bias"] = jnp.asarray(bias)
    if mask is not None:
        mask = jnp.asarray(mask)
        if mask.dtype != jnp.bool_:
            raise ValueError(
                "mask must be boolean (True = attend); pass additive float "
                "masks as bias"
            )

    window = None
    if local_window_size is not None:
        if isinstance(local_window_size, int):
            left = right = int(local_window_size)
        else:
            left, right = (int(x) for x in local_window_size)
        if is_causal:
            # causal discards the right span; the native band kernel's
            # ``window=N`` keeps cols in (row - N, row] == [row-left, row]
            window = left + 1
        else:
            # non-causal band: explicit bool mask (in-kernel block-skip).
            # col - row must lie in [-left, right].
            delta = (
                jnp.arange(sk, dtype=jnp.int32)[None, :]
                - jnp.arange(sq, dtype=jnp.int32)[:, None]
            )
            band = (delta >= -left) & (delta <= right)
            band = band[None, None]  # [1, 1, sq, sk]
            mask = band if mask is None else (mask & band)
    if mask is not None:
        kwargs["attn_mask"] = mask

    if query_seq_lengths is not None or key_value_seq_lengths is not None:
        q_seg = (
            _seq_length_segments(query_seq_lengths, sq, pad_segment=1)
            if query_seq_lengths is not None
            else jnp.zeros((b, sq), jnp.int32)
        )
        kv_seg = (
            _seq_length_segments(key_value_seq_lengths, sk, pad_segment=2)
            if key_value_seq_lengths is not None
            else jnp.zeros((b, sk), jnp.int32)
        )
        kwargs["q_segment_ids"] = q_seg
        kwargs["kv_segment_ids"] = kv_seg

    out = core.sageattn(
        query,
        key,
        value,
        tensor_layout="NHD",
        is_causal=is_causal,
        sm_scale=scale,
        return_lse=return_residual,
        window=window,
        **kwargs,
    )
    lse = None
    if return_residual:
        out, lse = out
        lse = jnp.transpose(lse, (0, 2, 1))  # [b, h, sq] -> jax.nn's BTN
    if query_seq_lengths is not None:
        # jax.nn leaves padded query rows unspecified; make them
        # deterministic zeros (they matched no kv segment above)
        valid = (
            jnp.arange(sq, dtype=jnp.int32)[None, :]
            < jnp.asarray(query_seq_lengths)[:, None]
        )
        out = jnp.where(valid[..., None, None], out, 0)
    if return_residual:
        return out, lse
    return out


def patch_jax_sdpa(**defaults):
    """Install :func:`dot_product_attention` as
    ``jax.nn.dot_product_attention`` so existing flax/JAX models pick up
    quantized attention without code changes — the JAX analogue of the
    reference's ``F.scaled_dot_product_attention = sageattn`` integration
    (reference: example/cogvideox-2b.py:16-23).

    ``defaults`` become default ``sage_kwargs`` for every call (a caller's
    explicit kwargs win).  Returns an ``undo()`` restoring the original.
    """
    original = jax.nn.dot_product_attention

    def patched(*args, **kw):
        merged = {**defaults, **kw}
        return dot_product_attention(*args, **merged)

    patched.__wrapped_original__ = original
    jax.nn.dot_product_attention = patched

    def undo():
        jax.nn.dot_product_attention = original

    return undo

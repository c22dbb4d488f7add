"""Torch drop-in adapter (reference parity: the reference's public API
is torch — ``sageattn(q, k, v)`` on torch tensors, installed as
``F.scaled_dot_product_attention = sageattn``, reference
example/cogvideox-2b.py:16-23 and core.py:80-158).

Torch tensors cross into JAX via DLPack (zero-copy on CPU) and results
come back as torch tensors.  The adapter is a convenience bridge for
users migrating from the reference: each call syncs at the framework
boundary, so native JAX pipelines should call
:func:`sageattention_jax.sageattn` directly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_TENSOR_KWARGS = (
    "attn_mask",
    "attn_bias",
    "q_segment_ids",
    "kv_segment_ids",
    "q_positions",
    "kv_positions",
)


def from_torch(t):
    """torch.Tensor -> jax.Array (DLPack; bool routed via uint8 since
    DLPack has no bool dtype in torch's exporter).

    The imported array is re-committed to JAX's default device: a DLPack
    import of a CPU torch tensor is committed to the jax *CPU* backend,
    which on a GPU host would pin the whole computation (and the kernel
    launch) to CPU."""
    import torch

    if not isinstance(t, torch.Tensor):
        return t
    t = t.detach()
    if t.dtype == torch.bool:
        a = jnp.from_dlpack(t.to(torch.uint8).contiguous()).astype(jnp.bool_)
    else:
        a = jnp.from_dlpack(t.contiguous())
    default = jax.devices()[0]
    if a.devices() != {default}:
        a = jax.device_put(a, default)
    return a


def to_torch(a):
    """jax.Array -> torch.Tensor.  Device arrays (GPU) are pulled to the
    JAX CPU backend first, then exported zero-copy via DLPack — this
    preserves bfloat16 exactly (a numpy hop would not: numpy has no
    bf16)."""
    import torch

    cpu = jax.devices("cpu")[0]
    if a.devices() != {cpu}:
        a = jax.device_put(a, cpu)
    if a.dtype == jnp.bool_:
        return torch.from_dlpack(a.astype(jnp.uint8)).to(torch.bool)
    return torch.from_dlpack(a)


def sageattn_torch(
    q,
    k,
    v,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    sm_scale: float | None = None,
    return_lse: bool = False,
    **kwargs,
):
    """``sageattn`` with torch tensors in and out (reference signature,
    core.py:80-158).  All keyword tensors (attn_mask, segment ids,
    positions) may be torch tensors too."""
    from sageattention_jax import core

    for name in _TENSOR_KWARGS:
        if kwargs.get(name) is not None:
            kwargs[name] = from_torch(kwargs[name])
    out = core.sageattn(
        from_torch(q),
        from_torch(k),
        from_torch(v),
        tensor_layout=tensor_layout,
        is_causal=is_causal,
        sm_scale=sm_scale,
        return_lse=return_lse,
        **kwargs,
    )
    if return_lse:
        o, lse = out
        return to_torch(o), to_torch(lse)
    return to_torch(out)


def patch_torch_sdpa(**default_kwargs):
    """Install :func:`sageattn_torch` as
    ``torch.nn.functional.scaled_dot_product_attention`` — the
    reference's documented integration (example/cogvideox-2b.py:16-23).

    ``default_kwargs`` are forwarded to every call (e.g.
    ``pv_dtype="int8"``).  Returns an ``undo()`` that restores the
    original SDPA.  GQA (``enable_gqa``) works natively — the kernel
    groups KV heads itself.  Dropout is rejected like the reference
    (its kernels have no dropout either).
    """
    import torch.nn.functional as F

    orig = F.scaled_dot_product_attention

    def _sdpa(
        query,
        key,
        value,
        attn_mask=None,
        dropout_p: float = 0.0,
        is_causal: bool = False,
        scale: float | None = None,
        enable_gqa: bool = False,
    ):
        import torch

        del enable_gqa  # the kernel handles hq != hkv natively
        if dropout_p != 0.0:
            raise NotImplementedError(
                "sageattn has no attention dropout (reference parity); "
                "got dropout_p={}".format(dropout_p)
            )
        # torch SDPA accepts (..., L, E) with ANY leading batch dims;
        # normalize to the kernel's 4-D (b, h, L, E) and restore after
        lead = query.shape[:-2]
        if query.dim() == 3:
            query, key, value = (
                x.unsqueeze(1) for x in (query, key, value)
            )
        elif query.dim() > 4:
            query = query.reshape(-1, *query.shape[-3:])
            key = key.reshape(-1, *key.shape[-3:])
            value = value.reshape(-1, *value.shape[-3:])
        elif query.dim() < 3:
            raise ValueError(
                f"scaled_dot_product_attention needs >= 3 dims, got "
                f"{tuple(query.shape)}"
            )
        kw = dict(default_kwargs)
        if attn_mask is not None:
            # torch SDPA accepts any mask broadcastable to (N, H, L, S)
            # (e.g. a (B, 1, 1, S) key-padding mask); core requires the
            # trailing dims to be exactly (sq, sk), so expand them here.
            m = attn_mask
            if m.dtype != torch.bool and bool(
                ((m == 0) | (m <= torch.finfo(m.dtype).min / 2)).all()
            ):
                # a two-valued {0, -inf/min} float mask (the HF padding
                # convention) is really a bool mask: convert so the
                # fused in-kernel mask path runs instead of the
                # score-materializing additive-bias fallback
                m = m == 0
            while m.dim() < 4:
                m = m.unsqueeze(0)
            # core broadcasts size-1 sq/sk dims lazily — no host-side
            # expand/contiguous materialization needed here
            kw["attn_mask"] = m  # bool or additive; core sorts it
        out = sageattn_torch(
            query,
            key,
            value,
            tensor_layout="HND",  # torch SDPA layout is (b, h, s, d)
            is_causal=is_causal,
            sm_scale=scale,
            **kw,
        )
        if len(lead) == 1:        # 3-D input: drop the head axis back
            return out.squeeze(1)
        if len(lead) > 2:         # >4-D: restore the leading batch dims
            return out.reshape(*lead, *out.shape[-2:])
        return out

    F.scaled_dot_product_attention = _sdpa

    def undo():
        F.scaled_dot_product_attention = orig

    return undo

"""Ring (context-parallel) attention over a mesh axis.

The reference exposes only the hook for this — per-row logsumexp output so
an *external* ring loop (xDiT) can merge partial attentions (reference:
core.py:122-124, example/run_parallel.sh:37-41).  Here the ring itself is a
first-class, in-repo capability: KV shards rotate around the mesh axis via
``jax.lax.ppermute`` (point-to-point, NCCL on the GPU) while each device attends
its local Q against the block in hand, merging partials with the online
LSE rule.  The ``ppermute`` for step t+1 is issued before step t's compute
so XLA can overlap the transfer with the attention.

The ring is **differentiable end-to-end**: each step runs the
``differentiable_sageattn`` custom-VJP (blockwise backward, LSE
cotangent folded into the D vector — see ops/blockwise.py),
the LSE merge is plain jnp, and ``ppermute`` has a transpose rule, so
``jax.grad`` through the ring yields per-step fused backwards with the
KV-shard gradients rotating home automatically.  No global score
materialization at any point (the reference is forward-only; this is the
framework's beyond-reference axis).

Causal masking across rotated blocks is a per-step three-way
``lax.switch``: shards from earlier devices attend fully, the device's
own shard runs aligned causal attention, later shards
are fully masked (weight-0 in the merge).  This replaces the round-1
position-id masking — it is faster (the bulk runs unmasked or
static-diagonal) and keeps every branch differentiable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sageattention_jax.ops import autodiff

# Finite "masked" LSE sentinel: exp(_NEG - m) underflows to exactly 0 for
# any real m, with zero gradient — unlike -inf, whose (-inf) - (-inf)
# arithmetic NaN-poisons the backward through jnp.where.
_NEG = -1e30


def _merge(o_acc, lse_acc, o_i, lse_i):
    """Streaming LSE merge of attention partials (natural log).

    With finite ``_NEG`` sentinels the weights are plain exponentials
    (the max's own weight is exactly 1, so denom >= 1: no zero-division
    and no NaN in either direction of autodiff)."""
    m = jnp.maximum(lse_acc, lse_i)
    w_acc = jnp.exp(lse_acc - m)
    w_i = jnp.exp(lse_i - m)
    denom = w_acc + w_i
    o = (o_acc * w_acc[..., None] + o_i * w_i[..., None]) / denom[..., None]
    lse = m + jnp.log(denom)
    return o, lse


def ring_sageattn(
    q,
    k,
    v,
    axis_name: str,
    *,
    is_causal: bool = False,
    sm_scale: float | None = None,
    return_lse: bool = False,
    **attn_kwargs,
):
    """Ring attention body — call INSIDE ``shard_map``.  Differentiable.

    q, k, v: local HND shards [b, h, s_local, d]; the global sequence is
    the concatenation over ``axis_name`` in axis-index order.
    """
    attn_kwargs.setdefault("pv_dtype", "bf16")  # match sageattn's default
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    b, hq, s_loc, d_og = q.shape
    if sm_scale is None:
        sm_scale = d_og**-0.5
    perm = [(i, (i + 1) % n) for i in range(n)]

    def step_full(q, kb, vb):
        return autodiff.differentiable_sageattn(
            q, kb, vb, sm_scale=sm_scale, return_lse=True, **attn_kwargs
        )

    def step_aligned(q, kb, vb):
        return autodiff.differentiable_sageattn(
            q, kb, vb, is_causal=True, sm_scale=sm_scale, return_lse=True,
            **attn_kwargs
        )

    def step_masked(q, kb, vb):
        return (
            jnp.zeros((b, hq, s_loc, d_og), q.dtype),
            jnp.full((b, hq, s_loc), _NEG, jnp.float32),
        )

    o_acc = jnp.zeros((b, hq, s_loc, d_og), jnp.float32)
    lse_acc = jnp.full((b, hq, s_loc), _NEG, jnp.float32)

    kb, vb = k, v
    for step in range(n):
        if step < n - 1:
            # issue the rotation before computing: XLA overlaps the
            # transfer with the attention below.
            kb_next = jax.lax.ppermute(kb, axis_name, perm)
            vb_next = jax.lax.ppermute(vb, axis_name, perm)
        src = (idx - step) % n  # whose KV shard we hold this step
        if is_causal:
            # earlier shards: full; own shard: aligned diagonal-split
            # causal; later shards: masked out (weight 0 in the merge)
            case = jnp.where(src == idx, 1, jnp.where(src < idx, 0, 2))
            o_i, lse_i = jax.lax.switch(
                case, (step_full, step_aligned, step_masked), q, kb, vb
            )
        else:
            o_i, lse_i = step_full(q, kb, vb)
        o_acc, lse_acc = _merge(
            o_acc, lse_acc, o_i.astype(jnp.float32), lse_i
        )
        if step < n - 1:
            kb, vb = kb_next, vb_next

    o = o_acc.astype(q.dtype)
    if return_lse:
        # restore the public contract: fully-masked rows report -inf
        lse = jnp.where(lse_acc < _NEG / 2, -jnp.inf, lse_acc)
        return o, lse
    return o


def make_ring_attention(
    mesh,
    axis_name: str = "seq",
    *,
    is_causal: bool = False,
    data_axis: str | None = "data",
    **attn_kwargs,
):
    """shard_map-wrapped ring attention: global [b, h, S, d] -> [b, h, S, d]
    with the sequence sharded over ``axis_name`` and batch over
    ``data_axis``."""
    from jax.sharding import PartitionSpec as P

    if axis_name not in mesh.axis_names:
        raise ValueError(
            f"mesh has no axis {axis_name!r} (axes: {mesh.axis_names})"
        )
    if data_axis is not None and data_axis not in mesh.axis_names:
        data_axis = None  # compose away like the other axes
    return_lse = bool(attn_kwargs.get("return_lse", False))
    spec = P(data_axis, None, axis_name, None)
    lse_spec = P(data_axis, None, axis_name)

    def fn(q, k, v):
        return ring_sageattn(
            q, k, v, axis_name, is_causal=is_causal, **attn_kwargs
        )

    return jax.jit(
        jax.shard_map(
            fn,
            mesh=mesh,
            in_specs=(spec, spec, spec),
            out_specs=(spec, lse_spec) if return_lse else spec,
            check_vma=False,
        )
    )


def allgather_sageattn(
    q,
    k,
    v,
    axis_name: str,
    *,
    is_causal: bool = False,
    sm_scale: float | None = None,
    return_lse: bool = False,
    **attn_kwargs,
):
    """All-gather-KV context parallelism — call INSIDE ``shard_map``.

    Simpler than the ring (one fused all-gather, no per-step merge); best
    when KV fits replicated and the sequence shard per device is small.
    Causal uses position-id masking (the q offset vs the gathered KV is
    device-dependent), so this path is forward-only; use the ring for
    training.
    """
    from sageattention_jax import core

    attn_kwargs.setdefault("pv_dtype", "bf16")  # match sageattn's default
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    b, hq, s_loc, d_og = q.shape
    if sm_scale is None:
        sm_scale = d_og**-0.5
    k_full = jax.lax.all_gather(k, axis_name, axis=2, tiled=True)
    v_full = jax.lax.all_gather(v, axis_name, axis=2, tiled=True)
    kwargs = dict(attn_kwargs)
    if is_causal:
        local_pos = jnp.arange(s_loc, dtype=jnp.int32)
        kwargs["q_positions"] = jnp.broadcast_to(
            idx * s_loc + local_pos, (b, s_loc)
        )
        kwargs["kv_positions"] = jnp.broadcast_to(
            jnp.arange(n * s_loc, dtype=jnp.int32), (b, n * s_loc)
        )
    return core._entry(
        q, k_full, v_full, "HND", False, sm_scale, return_lse, **kwargs
    )

"""Ulysses sequence parallelism (head all-to-all) over a mesh axis.

The reference reaches this through xDiT's --ulysses_degree (reference:
example/parallel_sageattn_cogvideo.py:32-36): activations arrive
sequence-sharded; an all-to-all swaps the shard dimension from sequence to
heads so every device runs *full-sequence* attention on a head subset,
then a second all-to-all swaps back: one ``jax.lax.all_to_all`` pair.

Because each device sees the full sequence, the static causal early-exit
and all single-device features apply unchanged — this is the
preferred strategy when head count is divisible by the axis size.

Differentiable end-to-end: the local attention is the public
``sageattn`` (custom VJP, blockwise backward) and ``all_to_all``
transposes to ``all_to_all``.
"""

from __future__ import annotations

import jax

from sageattention_jax import core

def ulysses_sageattn(
    q,
    k,
    v,
    axis_name: str,
    *,
    is_causal: bool = False,
    sm_scale: float | None = None,
    return_lse: bool = False,
    inner=None,
    **attn_kwargs,
):
    """Ulysses attention body — call INSIDE ``shard_map``.  Differentiable.

    q, k, v: local HND shards [b, h, s_local, d] (sequence-sharded over
    ``axis_name``).  h and h_kv must be divisible by the axis size.

    ``inner``: optional attention over the gathered full-sequence shards
    [b, h/n, S, d] (defaults to the local sage attention) — the
    composition hook api.py uses to run a ring inside Ulysses.  It must
    honor ``return_lse`` (returning (o, lse) with lse [b, h/n, S]).
    """
    attn_kwargs.setdefault("pv_dtype", "bf16")  # match sageattn's default
    n = jax.lax.axis_size(axis_name)
    hq, hkv = q.shape[1], k.shape[1]
    if hq % n or hkv % n:
        raise ValueError(
            f"Ulysses requires heads ({hq}) and kv heads ({hkv}) divisible "
            f"by axis size {n}; shard fewer ways or use ring attention"
        )
    if inner is None:
        def inner(qg, kg, vg):
            return core.sageattn(
                qg, kg, vg, is_causal=is_causal, sm_scale=sm_scale,
                return_lse=return_lse, **attn_kwargs
            )
    if n == 1:
        return inner(q, k, v)

    def seq_to_head(x):
        # [b, h, s/n, d] -> [b, h/n, s, d]
        return jax.lax.all_to_all(
            x, axis_name, split_axis=1, concat_axis=2, tiled=True
        )

    def head_to_seq(x):
        return jax.lax.all_to_all(
            x, axis_name, split_axis=2, concat_axis=1, tiled=True
        )

    qg, kg, vg = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    out = inner(qg, kg, vg)
    if return_lse:
        o, lse = out
        # lse is [b, h/n, S]; bring back to [b, h, s/n]
        lse_back = jax.lax.all_to_all(
            lse, axis_name, split_axis=2, concat_axis=1, tiled=True
        )
        return head_to_seq(o), lse_back
    return head_to_seq(out)


def make_ulysses_attention(
    mesh,
    axis_name: str = "heads",
    *,
    is_causal: bool = False,
    data_axis: str | None = "data",
    **attn_kwargs,
):
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
        return ulysses_sageattn(
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

"""Composed parallel attention: DP/CFG x ring x Ulysses on one mesh.

The equivalent of the xDiT launch matrix (reference:
example/parallel_sageattn_cogvideo.py:89-95, run_parallel.sh:37-42):
--use_cfg_parallel -> the "data" mesh axis, --ring_degree -> the "seq"
axis (KV rotation), --ulysses_degree -> the "heads" axis (head
all-to-all).  Input activations are sequence-sharded over seq x heads and
batch-sharded over data, exactly like xDiT shards DiT activations.
"""

from __future__ import annotations

import jax
from jax.sharding import PartitionSpec as P

from sageattention_jax import core  # noqa: F401  (re-export convenience)
from sageattention_jax.ops import autodiff
from sageattention_jax.parallel.ring import ring_sageattn
from sageattention_jax.parallel.ulysses import ulysses_sageattn


def make_parallel_sageattn(
    mesh,
    *,
    data_axis: str | None = "data",
    ring_axis: str | None = "seq",
    ulysses_axis: str | None = "heads",
    is_causal: bool = False,
    sm_scale: float | None = None,
    tensor_layout: str = "HND",
    **attn_kwargs,
):
    """Build a jitted, shard_mapped drop-in attention over ``mesh``.

    Global tensors (HND [b, h, S, d] or NHD) enter batch-sharded on
    ``data_axis`` and sequence-sharded over (ring_axis, ulysses_axis);
    the output is sharded the same way.  Axes with size 1 (or None)
    compose away.

    Differentiable end-to-end: every leaf is the custom-VJP sage
    attention (blockwise backward), the ring rotates KV-shard
    gradients home through ppermute's transpose, and the Ulysses
    all-to-alls transpose to all-to-alls — so a training step can
    jax.grad straight through this function (the round-1 version
    substituted a score-materializing global reference VJP).
    """
    attn_kwargs.setdefault("pv_dtype", "bf16")  # match sageattn's default
    return_lse = bool(attn_kwargs.pop("return_lse", False))
    axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if data_axis is not None and data_axis not in axis_sizes:
        data_axis = None  # compose away like the other axes
    ring_n = axis_sizes.get(ring_axis, 1) if ring_axis else 1
    uly_n = axis_sizes.get(ulysses_axis, 1) if ulysses_axis else 1

    seq_axes = tuple(
        a for a, n in ((ring_axis, ring_n), (ulysses_axis, uly_n)) if n > 1
    )
    seq_spec = seq_axes if seq_axes else None
    if tensor_layout == "HND":
        spec = P(data_axis, None, seq_spec, None)
    elif tensor_layout == "NHD":
        spec = P(data_axis, seq_spec, None, None)
    else:
        raise ValueError(f"bad tensor_layout {tensor_layout!r}")
    lse_spec = P(data_axis, None, seq_spec)  # lse is [b, h, s] either way

    def leaf(q, k, v):
        """Local or ring attention on (possibly head-sharded) full-seq
        shards — the Ulysses ``inner`` hook."""
        if ring_n > 1:
            return ring_sageattn(
                q, k, v, ring_axis, is_causal=is_causal,
                sm_scale=sm_scale, return_lse=return_lse, **attn_kwargs,
            )
        return autodiff.differentiable_sageattn(
            q, k, v, is_causal=is_causal, sm_scale=sm_scale,
            return_lse=return_lse, **attn_kwargs,
        )

    def local_fn(q, k, v):
        if tensor_layout == "NHD":
            q, k, v = (jax.numpy.swapaxes(x, 1, 2) for x in (q, k, v))
        if uly_n > 1:
            # Ulysses gathers the sequence over its axis (head swap); the
            # inner attention is then ring over ring_axis (or local).
            out = ulysses_sageattn(
                q, k, v, ulysses_axis, is_causal=is_causal,
                sm_scale=sm_scale, return_lse=return_lse, inner=leaf,
            )
        else:
            out = leaf(q, k, v)
        o, lse = out if return_lse else (out, None)
        if tensor_layout == "NHD":
            o = jax.numpy.swapaxes(o, 1, 2)
        return (o, lse) if return_lse else o

    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(spec, spec, spec),
            out_specs=(spec, lse_spec) if return_lse else spec,
            check_vma=False,
        )
    )

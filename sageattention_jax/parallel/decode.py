"""Sequence-parallel serving decode: the KV cache sharded over cards.

Long-context serving runs out of one card's HBM before it runs out of
FLOPs — a 32-layer 7B model at 1M tokens of int8 cache is ~64 GB.  The
answer is to shard the CACHE over the sequence axis of a mesh and
decode in parallel: every device decodes its shard
(``kvcache.sageattn_decode(..., return_state=True)``) and the partials
reduce with one exact LSE merge (the same merge the ring forward uses —
reference analogue: the `return_lse` ring hook, core.py:118,153).

Correctness under sharding is free by construction:

* Every mask in the decode compares LOCAL key columns against a
  LOCAL length; passing ``local_len = length - shard_offset`` shifts
  both sides of every comparison by the same offset, so length, causal
  tail, and sliding-window masks all stay exact (a local length above
  the shard size just means "the whole shard is live", negative means
  "nothing here yet").
* Appends route to exactly one shard: token j lives on shard
  j // S_local, and `append_kv`'s clamped dynamic_update_slice writes
  degenerate out-of-range appends harmlessly at the shard edge — but to
  keep scales untouched we mask fully-off-shard appends explicitly.
* The calibrated V-mean add-back commutes with the merge (the merge
  weights sum to one), so ``calibrate``-d caches shard exactly too.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from sageattention_jax import kvcache


def _merge_over_axis(o, m, l, axis: str):
    """The exact cross-shard LSE reduce (one pmax + two psums), shared
    by the dense and paged sharded decoders so their numerics are
    identical by construction.  A row no shard contributed to
    (den == 0) yields 0, matching a single decode's empty rows — an
    f32 subnormal epsilon would be flushed to 0 by XLA and emit NaN."""
    m_g = jax.lax.pmax(m, axis)
    w = l * jnp.exp2(m - m_g)                      # [b, hq, t_q]
    den = jax.lax.psum(w, axis)
    den = jnp.where(den == 0.0, 1.0, den)
    num = jax.lax.psum(w[..., None] * o.astype(jnp.float32), axis)
    return (num / den[..., None]).astype(o.dtype)


def local_shard_decode(
    q: jax.Array,
    cache_shard: kvcache.QuantKVCache,
    lengths: jax.Array,
    *,
    axis: str,
    sm_scale: float | None = None,
    window: int | None = None,
):
    """Per-device body (call inside shard_map): decode over this
    device's sequence-shard of the cache, then LSE-merge over ``axis``.

    ``q`` and ``lengths`` are replicated (global values); the cache
    arrays are the local shards.  Returns the replicated global output.
    """
    s_local = cache_shard.max_len
    idx = jax.lax.axis_index(axis)
    local_len = lengths.astype(jnp.int32) - idx * s_local
    o, m, l = kvcache.sageattn_decode(
        q, cache_shard, local_len,
        sm_scale=sm_scale, window=window, return_state=True,
    )
    return _merge_over_axis(o, m, l, axis)


def cache_shard_specs(
    axis: str | None, head_axis: str | None = None
) -> kvcache.QuantKVCache:
    """PartitionSpec pytree sharding a QuantKVCache on its sequence
    axis (K/V data axis 2, scale axis 2) and optionally its kv-head
    axis (tensor-parallel serving); calibrated means shard with heads."""
    return kvcache.QuantKVCache(
        k_i8=P(None, head_axis, axis, None),
        k_scale=P(None, head_axis, axis),
        v_i8=P(None, head_axis, axis, None),
        v_scale=P(None, head_axis, axis),
        k_mean=P(None, head_axis, None, None),
        v_mean=P(None, head_axis, None, None),
    )


def make_sharded_decode(
    mesh: jax.sharding.Mesh,
    *,
    axis: str | None = "seq",
    head_axis: str | None = None,
    sm_scale: float | None = None,
    window: int | None = None,
):
    """Build a jitted mesh-parallel ``sageattn_decode``.

    ``axis``: sequence-parallel — cache sequence-sharded, q/lengths
    replicated along it, partials LSE-merged (one pmax + two psums).
    ``head_axis``: tensor-parallel — heads shard with the cache heads
    (GQA groups stay whole), no collective at all; q and the output are
    head-sharded along it.  Both compose on one mesh (TP x SP serving).
    Numerics match the single-device decode exactly up to the
    (associative, fp32) LSE merge."""
    if axis is not None:
        fn = functools.partial(
            local_shard_decode, axis=axis, sm_scale=sm_scale,
            window=window,
        )
    else:
        def fn(q, cache_shard, lengths):
            return kvcache.sageattn_decode(
                q, cache_shard, lengths, sm_scale=sm_scale, window=window,
            )
    qspec = P(None, head_axis, None, None)
    return jax.jit(
        jax.shard_map(
            fn,
            mesh=mesh,
            in_specs=(qspec, cache_shard_specs(axis, head_axis), P()),
            out_specs=qspec,
            check_vma=False,
        )
    )


def make_sharded_append(
    mesh: jax.sharding.Mesh,
    *,
    axis: str | None = "seq",
    head_axis: str | None = None,
):
    """Build a jitted sequence-parallel ``append_kv``: each device
    intersects the global append range [length, length + t) with its
    own shard and writes only its slice (quantization happens once per
    device on the overlapping rows; scales stay per-token so the result
    is bit-identical to a single-device append of the same rows).
    ``head_axis`` shards the kv heads (TP) — new K/V enter head-sharded."""

    def local_append(cache_shard, lengths, k_new, v_new):
        s_local = cache_shard.max_len
        idx = jax.lax.axis_index(axis) if axis is not None else 0
        t = k_new.shape[2]
        # row j of the new block belongs at LOCAL position off + j; a
        # range that straddles shard edges lands partly out of range
        # (a whole-prompt prefill can even span several shards).  Exact
        # O(min(t, s_local)) scheme per shard: slice the w-row window
        # of the block that intersects this shard, write it at the
        # clamped start pre-rolled by the clamp residual so every
        # in-range row sits at its true position, then mask-restore the
        # rows the window covers but this shard doesn't own.
        # match append_kv's overflow semantics (clamp and overwrite the
        # TOTAL cache tail, never drop tokens): cap the global write
        # start so the block always fits the combined capacity
        n_sh = mesh.shape[axis] if axis is not None else 1
        glen = jnp.minimum(
            lengths.astype(jnp.int32), max(n_sh * s_local - t, 0)
        )
        off = glen - idx * s_local                            # [b]
        w = min(t, s_local)
        start_j = jnp.clip(-off, 0, t - w)  # [b] window start in block
        offw = off + start_j                # local pos of window row 0
        start = jnp.clip(offw, 0, max(s_local - w, 0))
        shift = offw - start    # rolled[r] = win[(r - shift) mod w]

        # slice THIS shard's w-row window first, quantize only it:
        # scales are strictly per-token, so slice-then-quantize is
        # bit-identical to quantize-then-slice at 1/n_shards the work
        def slice4(new, sj):  # [h, t, d] -> [h, w, d]
            return jax.lax.dynamic_slice(
                new, (0, sj, 0), (new.shape[0], w, new.shape[2])
            )

        k_win = jax.vmap(slice4)(k_new, start_j)
        v_win = jax.vmap(slice4)(v_new, start_j)
        k_q, k_s = kvcache.quant_calibrated(
            k_win, cache_shard.k_mean, cache_shard.bits
        )
        v_q, v_s = kvcache.quant_calibrated(
            v_win, cache_shard.v_mean, cache_shard.bits
        )

        def upd4(buf, win, st, sh):  # [h, s_local, d], [h, w, d]
            return jax.lax.dynamic_update_slice(
                buf, jnp.roll(win, sh, axis=1), (0, st, 0)
            )

        def upd3(buf, win, st, sh):  # [h, s_local], [h, w]
            return jax.lax.dynamic_update_slice(
                buf, jnp.roll(win, sh, axis=1), (0, st)
            )

        if cache_shard.bits == 4:
            # token-pair-packed shard data: write_rows_packed drops
            # out-of-shard rows itself (it bound-checks every token
            # position), so no roll / mask-restore pass is needed
            u4 = lambda buf, win: jax.vmap(kvcache.write_rows_packed)(
                buf, win, offw
            )
        else:
            u4 = lambda buf, win: jax.vmap(upd4)(buf, win, start, shift)
        u3 = lambda buf, win: jax.vmap(upd3)(buf, win, start, shift)
        written = kvcache.QuantKVCache(
            k_i8=u4(cache_shard.k_i8, k_q),
            k_scale=u3(cache_shard.k_scale, k_s),
            v_i8=u4(cache_shard.v_i8, v_q),
            v_scale=u3(cache_shard.v_scale, v_s),
            k_mean=cache_shard.k_mean,
            v_mean=cache_shard.v_mean,
        )

        row = jax.lax.broadcasted_iota(jnp.int32, (off.shape[0], s_local), 1)
        keep = (row >= jnp.maximum(offw[:, None], 0)) & (
            row < offw[:, None] + w
        )   # [b, s_local]: true target rows on this shard

        def pick(new, old, scale_like):
            m = keep[:, None] if scale_like else keep[:, None, :, None]
            return jnp.where(m, new, old)

        merged = kvcache.QuantKVCache(
            k_i8=written.k_i8 if cache_shard.bits == 4
            else pick(written.k_i8, cache_shard.k_i8, False),
            k_scale=pick(written.k_scale, cache_shard.k_scale, True),
            v_i8=written.v_i8 if cache_shard.bits == 4
            else pick(written.v_i8, cache_shard.v_i8, False),
            v_scale=pick(written.v_scale, cache_shard.v_scale, True),
            k_mean=cache_shard.k_mean,
            v_mean=cache_shard.v_mean,
        )
        return merged, lengths + t

    specs = cache_shard_specs(axis, head_axis)
    kvspec = P(None, head_axis, None, None)
    return jax.jit(
        jax.shard_map(
            local_append,
            mesh=mesh,
            in_specs=(specs, P(), kvspec, kvspec),
            out_specs=(specs, P()),
            check_vma=False,
        )
    )


# ---------------------------------------------------------------------------
# Sharded PAGED pool: vLLM-style paging at multi-card scale.  The page
# pool shards over the mesh (pages [j*pp, (j+1)*pp) live on device j);
# the page table stays replicated (it is tiny), and each device decodes
# only the logical pages whose physical page it owns.  Partials merge
# with the same exact LSE reduce as the dense sharded decode.
# ---------------------------------------------------------------------------


def paged_shard_specs(
    axis: str | None, head_axis: str | None = None
) -> kvcache.PagedKVCache:
    """PartitionSpec pytree: page pool sharded on its page axis (dim 0)
    and optionally kv heads (dim 1); the page table replicates."""
    return kvcache.PagedKVCache(
        pages_k=P(axis, head_axis, None, None),
        pages_k_scale=P(axis, head_axis, None),
        pages_v=P(axis, head_axis, None, None),
        pages_v_scale=P(axis, head_axis, None),
        page_table=P(),
        k_mean=P(None, head_axis, None, None),
        v_mean=P(None, head_axis, None, None),
    )


def make_sharded_paged_decode(
    mesh: jax.sharding.Mesh,
    *,
    axis: str = "seq",
    head_axis: str | None = None,
    sm_scale: float | None = None,
    window: int | None = None,
):
    """Build a jitted ``sageattn_paged_decode`` over a page pool sharded
    on ``axis`` (and heads on ``head_axis``): per-shard partial decode
    via the ownership mask + local page table, one exact LSE merge.  Matches the single-pool decode up to fp32 merge order."""

    def local_fn(q, cache_shard, lengths):
        pp = cache_shard.pages_k.shape[0]
        idx = jax.lax.axis_index(axis)
        pt = cache_shard.page_table
        owned = (pt >= idx * pp) & (pt < (idx + 1) * pp)
        lpt = jnp.where(owned, pt - idx * pp, 0)
        o, m, l = kvcache.sageattn_paged_decode(
            q, cache_shard, lengths,
            owned=owned.astype(jnp.int32), page_table=lpt,
            sm_scale=sm_scale, window=window, return_state=True,
        )
        return _merge_over_axis(o, m, l, axis)

    qspec = P(None, head_axis, None, None)
    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(qspec, paged_shard_specs(axis, head_axis), P()),
            out_specs=qspec,
            check_vma=False,
        )
    )


def make_sharded_paged_append(
    mesh: jax.sharding.Mesh,
    *,
    axis: str = "seq",
    head_axis: str | None = None,
    prefill: bool = False,
):
    """Sharded paged writes: each device scatters only the rows whose
    destination page it owns (``pool_start`` + drop-mode scatter in
    kvcache.paged_append/paged_prefill) — bit-identical to the global
    pool.  ``prefill=True`` builds the page-granular bulk loader
    (t % page_size == 0, empty sequences) instead of the token scatter."""

    def local_append(cache_shard, lengths, k_new, v_new):
        pp = cache_shard.pages_k.shape[0]
        start = jax.lax.axis_index(axis) * pp
        if prefill:
            return kvcache.paged_prefill(
                cache_shard, k_new, v_new, pool_start=start
            )
        return kvcache.paged_append(
            cache_shard, lengths, k_new, v_new, pool_start=start
        )

    specs = paged_shard_specs(axis, head_axis)
    kvspec = P(None, head_axis, None, None)
    return jax.jit(
        jax.shard_map(
            local_append,
            mesh=mesh,
            in_specs=(specs, P(), kvspec, kvspec),
            out_specs=(specs, P()),
            check_vma=False,
        )
    )

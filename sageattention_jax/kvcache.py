"""Quantized KV cache for decode serving (beyond the reference).

The reference accelerates diffusion and LLM *prefill*; this module adds
the serving decode loop: an int8 KV cache with **per-token scales** so
appends are pure quantized writes — no chunk requantization, no
clipping against stale amax, no drift — plus the decode attention
over it (plain jnp: dequantize + dot, left to XLA).  The int8 cache
halves the HBM footprint (2x batch or context per card), and a decode
step is bandwidth-bound on one read of the cache.

Usage:

    cache = init_kv_cache(b, h_kv, max_len, head_dim)
    cache, lengths = append_kv(cache, lengths, k_new, v_new)   # prefill
    o = sageattn_decode(q, cache, lengths)                     # per step

``cache`` is a pytree (dataclass of arrays) — jit/scan/pmap-friendly.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from sageattention_jax import quant as quant_mod

LOG2E = 1.4426950408889634
# the merge-state max of a row with no live key: finite, so merges of
# empty shards stay NaN-free
NEG_INIT = -1e30


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QuantKVCache:
    """int8 (or 4-bit, ``bits=4``) K/V with per-token scales;
    [b, h_kv, max_len, d] + [b, h_kv, max_len].  The 4-bit cache packs
    two TOKENS per int8 byte (see ``pack_token_pairs``) — half the HBM
    footprint without the ``jnp.int4`` dtype anywhere at rest; decode
    unpacks the nibbles with two shifts (``unpack_token_pairs``).

    ``k_mean`` / ``v_mean`` ([b, h_kv, 1, d], default zero) hold fixed
    per-channel means subtracted before quantization (``calibrate``):
    the K shift is softmax-invariant (every key's score moves by the
    same q·km), and the V shift adds back exactly because softmax rows
    sum to one — so both corrections are FREE, and the quantizer only
    has to cover the residual range.  The means must be frozen before
    the first append (mixing means across appends would break the K
    invariance)."""

    k_i8: jax.Array
    k_scale: jax.Array
    v_i8: jax.Array
    v_scale: jax.Array
    k_mean: jax.Array
    v_mean: jax.Array

    @property
    def max_len(self) -> int:
        # scales are always per token; K/V data rows are token PAIRS in
        # the packed 4-bit cache
        return self.k_scale.shape[2]

    @property
    def bits(self) -> int:
        # the 4-bit cache packs token pairs: data token axis is half the
        # scale token axis
        return 4 if self.k_i8.shape[2] != self.k_scale.shape[2] else 8


def pack_token_pairs(q: jax.Array) -> jax.Array:
    """Pack int8 values in [-8, 7] two-tokens-per-byte along the token
    axis (axis -2): byte (t, c) holds token 2t's channel c in the low
    nibble and token 2t+1's in the high nibble, so unpacking restores
    the natural [t, d] token order."""
    t = q.shape[-2]
    assert t % 2 == 0, t
    lo = q[..., 0::2, :].astype(jnp.int8)
    hi = q[..., 1::2, :].astype(jnp.int8)
    return (hi << 4) | (lo & 0x0F)


def unpack_token_pairs(p: jax.Array) -> jax.Array:
    """Inverse of pack_token_pairs (cache writers use it for
    read-modify-write overlays, decode to read the 4-bit cache)."""
    x = p.astype(jnp.int32)
    lo = (x << 28) >> 28
    hi = x >> 4
    out = jnp.stack([lo, hi], axis=-2)            # [..., t/2, 2, d]
    return out.reshape(*p.shape[:-2], -1, p.shape[-1]).astype(jnp.int8)


def _cache_zeros(shape, bits: int) -> jax.Array:
    if bits == 4:
        assert shape[-2] % 2 == 0, shape
        shape = shape[:-2] + (shape[-2] // 2, shape[-1])
    return jnp.zeros(shape, jnp.int8)


def init_kv_cache(
    b: int, h_kv: int, max_len: int, head_dim: int, bits: int = 8
) -> QuantKVCache:
    """``bits=4`` stores the cache nibble-packed (2 TOKENS per int8
    byte, ``pack_token_pairs``): half the HBM footprint, at ±7
    quantization levels: 2x contexts per HBM byte.  Its decode time on
    the card is not measured.  See bench_decode --bits 4 for the
    accuracy trade.  ``max_len`` must be even for the 4-bit cache."""
    assert bits in (8, 4), bits
    assert bits == 8 or max_len % 2 == 0, max_len
    return QuantKVCache(
        k_i8=_cache_zeros((b, h_kv, max_len, head_dim), bits),
        k_scale=jnp.full((b, h_kv, max_len), 1e-30, jnp.float32),
        v_i8=_cache_zeros((b, h_kv, max_len, head_dim), bits),
        v_scale=jnp.full((b, h_kv, max_len), 1e-30, jnp.float32),
        k_mean=jnp.zeros((b, h_kv, 1, head_dim), jnp.float32),
        v_mean=jnp.zeros((b, h_kv, 1, head_dim), jnp.float32),
    )


@jax.jit
def calibrate(cache, k_sample: jax.Array, v_sample: jax.Array,
              lengths: jax.Array | None = None):
    """Freeze per-channel K/V means from sample tokens [b, h_kv, t, d]
    (typically the prompt, before the prefill append).  Subtracting a
    fixed channel mean rescues coarse quantizers (esp. ``bits=4``) from
    channel bias — the corrections are mathematically free (see
    QuantKVCache).  Works on QuantKVCache and PagedKVCache alike; must
    run on an EMPTY cache — already-cached tokens were quantized
    against the OLD means, and mixing means across keys breaks the
    softmax invariance of the K shift.  Pass ``lengths`` to enforce
    that per batch under jit: rows with lengths > 0 keep their frozen
    means (so a re-prefill over a live cache is a no-op, not silent
    corruption)."""
    k_m = jnp.mean(k_sample.astype(jnp.float32), axis=2, keepdims=True)
    v_m = jnp.mean(v_sample.astype(jnp.float32), axis=2, keepdims=True)
    if lengths is not None:
        empty = (lengths.astype(jnp.int32) == 0)[:, None, None, None]
        k_m = jnp.where(empty, k_m, cache.k_mean)
        v_m = jnp.where(empty, v_m, cache.v_mean)
    return dataclasses.replace(cache, k_mean=k_m, v_mean=v_m)


def _quant_rows(x: jax.Array, bits: int = 8):
    """Per-token (row) int8 / int4 quantization of [b, h, t, d].
    Always returns UNPACKED int8 rows (±127, or ±7 for ``bits=4``);
    the writers pack token pairs at write time (packing needs the
    write offset's parity, which only the writer knows)."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1)
    qmax = 127.0 if bits == 8 else 7.0
    scale, r = quant_mod.inv_scale(amax, qmax)
    q = jnp.clip(
        quant_mod.round_half_away(xf * r[..., None]), -qmax, qmax
    ).astype(jnp.int8)
    return q, scale


def quant_calibrated(x: jax.Array, mean: jax.Array, bits: int):
    """THE cache-write quantization recipe (every append/prefill path,
    dense/paged/sharded, uses exactly this): fp32 cast, subtract the
    frozen per-channel mean, per-token int8/int4 rows (unpacked)."""
    return _quant_rows(x.astype(jnp.float32) - mean, bits)


def write_rows_packed(
    buf: jax.Array,      # [h, S/2, d] int8 token-pair-packed
    rows: jax.Array,     # [h, w, d] int8 in [-8, 7]
    off: jax.Array,      # scalar int32: target token position of row 0
):
    """Write ``rows[j]`` to token position ``off + j`` of a token-pair-
    packed buffer; positions outside [0, S) drop (``off`` may be
    negative — the sequence-parallel shard writers rely on this).
    jit-friendly read-modify-write: slice the fixed-size byte window the
    rows can touch, unpack, overlay, repack, write back — the nibble a
    row shares a byte with is always preserved."""
    h, half, d = buf.shape
    w = rows.shape[1]
    wb = min(w // 2 + 1, half)
    off = off.astype(jnp.int32)
    # first in-range target token's byte, clamped so the window fits
    first = jnp.clip(off, 0, 2 * half - 1) // 2
    b0 = jnp.clip(first, 0, half - wb)
    old = jax.lax.dynamic_slice(buf, (0, b0, 0), (h, wb, d))
    toks = unpack_token_pairs(old)                    # [h, 2wb, d]
    pos = 2 * b0 + jnp.arange(2 * wb, dtype=jnp.int32)  # global tokens
    j = pos - off                                     # source row index
    use = (j >= 0) & (j < w)
    new = jnp.take(rows, jnp.clip(j, 0, w - 1), axis=1)
    merged = jnp.where(use[None, :, None], new, toks)
    return jax.lax.dynamic_update_slice(
        buf, pack_token_pairs(merged), (0, b0, 0)
    )


@jax.jit
def _vmean_addback(o: jax.Array, lengths: jax.Array,
                   v_mean: jax.Array) -> jax.Array:
    """Exact V-mean add-back (softmax rows sum to 1); K's mean shift is
    softmax-invariant and needs no correction.  Zero-length slots have
    no softmax mass (decode emits 0 rows) — keep them 0, not mean.
    Shared by every decode wrapper so the empty-slot invariant (and the
    merge-commutativity it protects) cannot desynchronize."""
    group = o.shape[1] // v_mean.shape[1]
    live = (lengths.astype(jnp.int32) > 0)[:, None, None, None]
    vm = jnp.where(live, jnp.repeat(v_mean, group, axis=1), 0.0)
    return o + vm.astype(o.dtype)


def append_kv(
    cache: QuantKVCache,
    lengths: jax.Array,       # [b] int32: tokens already in the cache
    k_new: jax.Array,         # [b, h_kv, t, d]
    v_new: jax.Array,         # [b, h_kv, t, d]
) -> tuple[QuantKVCache, jax.Array]:
    """Quantize and write ``t`` new tokens at each batch's ``lengths``
    offset.  Returns (cache, lengths + t).  Works for prefill (large t)
    and decode (t = 1) alike.

    The caller owns capacity: offsets are dynamic-update-slice semantics,
    so an append past ``max_len`` clamps to the end and overwrites the
    tail rather than raising (jit-compatible); size the cache for the
    longest sequence."""
    k_q, k_s = quant_calibrated(k_new, cache.k_mean, cache.bits)
    v_q, v_s = quant_calibrated(v_new, cache.v_mean, cache.bits)
    # match dynamic_update_slice clamping for the packed writer too
    off = jnp.minimum(
        lengths.astype(jnp.int32),
        max(cache.max_len - k_new.shape[2], 0),
    )

    if cache.bits == 4:
        upd4 = write_rows_packed
    else:
        def upd4(buf, new, o):
            return jax.lax.dynamic_update_slice(buf, new, (0, o, 0))

    def upd3(buf, new, o):
        return jax.lax.dynamic_update_slice(buf, new, (0, o))

    cache = dataclasses.replace(
        cache,
        k_i8=jax.vmap(upd4)(cache.k_i8, k_q, off),
        k_scale=jax.vmap(upd3)(cache.k_scale, k_s, off),
        v_i8=jax.vmap(upd4)(cache.v_i8, v_q, off),
        v_scale=jax.vmap(upd3)(cache.v_scale, v_s, off),
    )
    return cache, lengths + k_new.shape[2]


def decode_attention(
    q: jax.Array,          # [b, hq, t_q, d]
    k_i8: jax.Array,       # [b, hkv, S, d] int8 (unpacked)
    k_scale: jax.Array,    # [b, hkv, S] f32 per token
    v_i8: jax.Array,       # [b, hkv, S, d] int8 (unpacked)
    v_scale: jax.Array,    # [b, hkv, S] f32 per token
    lengths: jax.Array,    # [b] int32 live lengths; values OUTSIDE
                           # [0, S] are part of the contract (sequence-
                           # parallel shards pass local_len = len - off,
                           # negative on unreached shards and > S on
                           # fully-live ones) — the masks handle both ends
    *,
    sm_scale: float | None = None,
    window: int | None = None,
    key_live: jax.Array | None = None,   # [b, S] bool, extra key mask
):
    """Decode attention of a few query tokens against int8 K/V rows.

    Queries attend keys [0, length) per batch; with t_q > 1 the t-th
    query row additionally observes the causal tail (keys
    < length - t_q + 1 + t) — the speculative/chunked-decode contract.
    ``window``: each query position p attends keys in (p - window, p].

    Plain jnp, left to XLA: the query rows of a GQA group share one pass
    over the cache; Q quantizes per row; the int8 codes enter the dots as
    bf16, which is exact (|code| <= 127, and the f32 accumulation of
    127 * 127 * d stays far below 2^24).  Returns (o, m, l): o normalized
    [b, hq, t_q, d] in q.dtype, and the base-2 softmax merge state m
    (running max, ``NEG_INIT`` for rows with no live key) and l (exp-sum),
    each [b, hq, t_q]."""
    b, hq, t_q, d = q.shape
    hkv, S = k_i8.shape[1], k_i8.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = d**-0.5
    rows = group * t_q
    qf = q.astype(jnp.float32).reshape(b, hkv, rows, d)
    q_scale, r = quant_mod.inv_scale(jnp.max(jnp.abs(qf), axis=-1), 127.0)
    q_i8 = jnp.clip(quant_mod.round_half_away(qf * r[..., None]), -127, 127)
    s = jnp.einsum(
        "bhrd,bhsd->bhrs", q_i8.astype(jnp.bfloat16),
        k_i8.astype(jnp.bfloat16), preferred_element_type=jnp.float32,
    )
    s = s * (q_scale * (sm_scale * LOG2E))[..., None] * k_scale[:, :, None, :]

    length = lengths.astype(jnp.int32)[:, None, None, None]
    col = jnp.arange(S, dtype=jnp.int32)[None, None, None, :]
    trow = (jnp.arange(rows, dtype=jnp.int32) % t_q)[None, None, :, None]
    # query row t sits at position length - t_q + t
    pos = length - t_q + trow
    live = col <= pos
    if window is not None:
        live = live & (col > pos - window)
    if key_live is not None:
        live = live & key_live[:, None, None, :]
    m = jnp.max(jnp.where(live, s, -jnp.inf), axis=-1)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    p = jnp.where(live, jnp.exp2(s - m_safe[..., None]), 0.0)
    l = jnp.sum(p, axis=-1)
    pv = jnp.einsum(
        "bhrs,bhsd->bhrd", p * v_scale[:, :, None, :],
        v_i8.astype(jnp.bfloat16), preferred_element_type=jnp.float32,
    )
    o = pv * jnp.where(l == 0.0, 0.0, 1.0 / l)[..., None]
    m = jnp.where(l == 0.0, NEG_INIT, m_safe)

    def heads(x):
        return x.reshape((b, hq, t_q) + x.shape[3:])

    return heads(o).astype(q.dtype), heads(m), heads(l)


def merge_decode_partials(o_parts, m_parts, l_parts, out_dtype=None):
    """Exactly combine normalized partial decodes over DISJOINT cache
    shards (``return_state=True`` outputs, stacked on a leading axis):
    o = sum_i w_i * o_i / sum_i w_i with w_i = l_i * 2^(m_i - max m).
    Empty shards (m = NEG_INIT, l = 0) contribute zero weight.  This is
    the LSE merge the ring forward uses, specialized to decode — the
    reduction for sequence-parallel serving (see parallel/decode.py)."""
    out_dtype = out_dtype or o_parts.dtype
    m_g = jnp.max(m_parts, axis=0)
    w = l_parts * jnp.exp2(m_parts - m_g)            # [n, b, hq, t_q]
    den = jnp.sum(w, axis=0)
    # a fully-empty row has den == 0 -> emit 0 like a single decode does
    den = jnp.where(den == 0.0, 1.0, den)
    num = jnp.sum(w[..., None] * o_parts.astype(jnp.float32), axis=0)
    return (num / den[..., None]).astype(out_dtype)


def _unpacked(x: jax.Array, bits: int) -> jax.Array:
    return unpack_token_pairs(x) if bits == 4 else x


@functools.partial(
    jax.jit, static_argnames=("sm_scale", "window", "return_state")
)
def sageattn_decode(
    q: jax.Array,            # [b, hq, t_q, d]
    cache: QuantKVCache,
    lengths: jax.Array,      # [b] int32 live lengths INCLUDING the new
                             # tokens q corresponds to
    *,
    sm_scale: float | None = None,
    window: int | None = None,
    return_state: bool = False,
):
    """Decode attention of the current query tokens against the cache.

    The caller appends the step's K/V first (append_kv), then calls this
    with the updated lengths; with t_q > 1 the causal tail applies
    within the new tokens (speculative / chunked decode).  ``window``
    (Mistral/Gemma-style sliding window): each query attends only its
    last ``window`` keys.

    ``return_state=True`` returns ``(o, m, l)`` — the softmax merge
    state for combining partial decodes over disjoint cache shards
    (``merge_decode_partials`` / ``parallel.decode``).  The V-mean
    add-back commutes with the merge (weights sum to one), so calibrated
    shards combine exactly too."""
    o, m, l = decode_attention(
        q, _unpacked(cache.k_i8, cache.bits), cache.k_scale,
        _unpacked(cache.v_i8, cache.bits), cache.v_scale, lengths,
        sm_scale=sm_scale, window=window,
    )
    o = _vmean_addback(o, lengths, cache.v_mean)
    return (o, m, l) if return_state else o


# ---------------------------------------------------------------------------
# Paged cache (vLLM-style): a shared pool of fixed-size pages + per-sequence
# page tables; decode gathers each sequence's physical pages with
# jnp.take (sageattn_paged_decode).
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PagedKVCache:
    """Page pool [num_pages, h_kv, page, d] int8 + per-token scales and
    the [b, max_pages] page table.  Physical page assignment is the
    caller's policy (any permutation works; entries past the live
    length are read but masked)."""

    pages_k: jax.Array
    pages_k_scale: jax.Array
    pages_v: jax.Array
    pages_v_scale: jax.Array
    page_table: jax.Array
    k_mean: jax.Array
    v_mean: jax.Array

    @property
    def page_size(self) -> int:
        # scales are per token; packed 4-bit pages hold token PAIRS
        return self.pages_k_scale.shape[2]

    @property
    def bits(self) -> int:
        return 4 if self.pages_k.shape[2] != self.pages_k_scale.shape[2] else 8


def init_paged_kv_cache(
    num_pages: int, h_kv: int, head_dim: int, page_table: jax.Array,
    page_size: int = 1024, bits: int = 8,
) -> PagedKVCache:
    assert bits in (8, 4), bits
    assert bits == 8 or page_size % 2 == 0, page_size
    b = page_table.shape[0]
    return PagedKVCache(
        pages_k=_cache_zeros((num_pages, h_kv, page_size, head_dim),
                             bits),
        pages_k_scale=jnp.full((num_pages, h_kv, page_size), 1e-30,
                               jnp.float32),
        pages_v=_cache_zeros((num_pages, h_kv, page_size, head_dim),
                             bits),
        pages_v_scale=jnp.full((num_pages, h_kv, page_size), 1e-30,
                               jnp.float32),
        page_table=page_table.astype(jnp.int32),
        k_mean=jnp.zeros((b, h_kv, 1, head_dim), jnp.float32),
        v_mean=jnp.zeros((b, h_kv, 1, head_dim), jnp.float32),
    )


@jax.jit
def paged_append(
    cache: PagedKVCache,
    lengths: jax.Array,      # [b]
    k_new: jax.Array,        # [b, h_kv, t, d]
    v_new: jax.Array,        # [b, h_kv, t, d]
    pool_start: jax.Array | int = 0,
) -> tuple[PagedKVCache, jax.Array]:
    """Quantize and write ``t`` tokens per sequence at ``lengths``,
    following the page table across page boundaries.  Pure quantized
    writes (per-token scales), like the dense append.

    ``pool_start``: when the page pool is SHARDED over devices
    (parallel/decode.py), each shard passes its first global page id;
    page-table entries resolve to pool-local indices and writes to
    pages another shard owns drop (scatter mode="drop") — every token
    lands on exactly one shard, bit-identically to the global pool."""
    page = cache.page_size
    k_q, k_s = quant_calibrated(k_new, cache.k_mean, cache.bits)
    v_q, v_s = quant_calibrated(v_new, cache.v_mean, cache.bits)
    # [b,h,t,d], [b,h,t]
    b, h, t, d = k_q.shape
    n_pool = cache.pages_k.shape[0]

    # destination of token j of sequence i: physical page
    # page_table[i, (lengths[i]+j)//page], row (lengths[i]+j) % page.
    # Appends past the table's span clamp to the end and overwrite the
    # tail — the same dynamic-update-slice semantics as append_kv (the
    # caller owns capacity); without the clamp the write would silently
    # drop while lengths still advanced.
    span = cache.page_table.shape[1] * page
    start = jnp.minimum(lengths, span - t)
    pos = start[:, None] + jnp.arange(t)[None, :]          # [b, t]
    phys = jnp.take_along_axis(
        cache.page_table, pos // page, axis=1
    ) - pool_start                                         # [b, t]
    # negative (another shard's) indices would WRAP under numpy
    # semantics — push them out of range so mode="drop" drops them
    phys = jnp.where(phys < 0, n_pool, phys)
    off = pos % page                                        # [b, t]

    def scatter_pool(pool, rows, phys_ix, row_ix, n):
        # pool [P, h, rows_pp, d?]; rows [b, h, n, (d)] -> (b*n) rows
        rows_flat = jnp.moveaxis(rows, 1, 2).reshape(
            (b * n, h) + rows.shape[3:]
        )  # [(b n), h, d?]
        return pool.at[phys_ix.reshape(-1), :, row_ix.reshape(-1)].set(
            rows_flat, mode="drop"
        )

    if cache.bits == 4:
        # token-pair-packed pool: read-modify-write the byte window the
        # append touches (each byte couples two adjacent tokens).  The
        # window is logical bytes [start//2, ...) — contiguous in token
        # space, scattered physically through the page table.
        nb = min(t // 2 + 1, span // 2)
        b0 = jnp.clip(start // 2, 0, span // 2 - nb)       # [b]
        lb = b0[:, None] + jnp.arange(nb)[None, :]         # [b, nb]
        tok0 = 2 * lb
        bphys = jnp.take_along_axis(
            cache.page_table, tok0 // page, axis=1
        ) - pool_start                                     # [b, nb]
        brow = (tok0 % page) // 2                          # [b, nb]
        gather_ix = jnp.clip(bphys, 0, n_pool - 1)

        gpos = tok0[:, :, None] + jnp.arange(2)[None, None, :]
        gpos = gpos.reshape(b, 2 * nb)                     # [b, 2nb]
        j = gpos - start[:, None]                          # [b, 2nb]
        use = (j >= 0) & (j < t)

        def rmw_pool(pool, rows):
            old = pool[gather_ix.reshape(-1), :,
                       brow.reshape(-1)]                   # [(b nb), h, d]
            old = jnp.moveaxis(
                old.reshape(b, nb, h, d), 2, 1
            )                                              # [b, h, nb, d]
            toks = unpack_token_pairs(old)                 # [b, h, 2nb, d]
            new = jnp.take_along_axis(
                rows, jnp.clip(j, 0, t - 1)[:, None, :, None], axis=2
            )
            merged = jnp.where(use[:, None, :, None], new, toks)
            packed = pack_token_pairs(merged)              # [b, h, nb, d]
            drop = jnp.where(bphys < 0, n_pool, bphys)
            return scatter_pool(pool, packed, drop, brow, nb)

        pages_k = rmw_pool(cache.pages_k, k_q)
        pages_v = rmw_pool(cache.pages_v, v_q)
    else:
        pages_k = scatter_pool(cache.pages_k, k_q, phys, off, t)
        pages_v = scatter_pool(cache.pages_v, v_q, phys, off, t)

    cache = dataclasses.replace(
        cache,
        pages_k=pages_k,
        pages_k_scale=scatter_pool(cache.pages_k_scale, k_s, phys, off, t),
        pages_v=pages_v,
        pages_v_scale=scatter_pool(cache.pages_v_scale, v_s, phys, off, t),
    )
    return cache, lengths + t


@jax.jit
def paged_prefill(
    cache: PagedKVCache,
    k: jax.Array,            # [b, h_kv, t, d], t a multiple of page_size
    v: jax.Array,
    pool_start: jax.Array | int = 0,
) -> tuple[PagedKVCache, jax.Array]:
    """Bulk-load empty sequences: writes whole pages through the page
    table (page-granular scatter — token-granular paged_append is for
    decode steps; a 32k-token prefill would otherwise scatter 32k rows).
    Requires t % page_size == 0 and empty sequences."""
    page = cache.page_size
    b, h, t, _ = k.shape
    assert t % page == 0, (t, page)
    n_used = t // page
    k_q, k_s = quant_calibrated(k, cache.k_mean, cache.bits)
    v_q, v_s = quant_calibrated(v, cache.v_mean, cache.bits)

    ids = cache.page_table[:, :n_used].reshape(-1) - pool_start
    ids = jnp.where(ids < 0, cache.pages_k.shape[0], ids)

    def put(pool, rows, has_d):
        # rows [b, h, rows_pp*n_used, (d)] -> [b*n_used, h, rows_pp, (d)]
        # where rows_pp = page (scales / int8 data) or page/2 (token-
        # pair-packed 4-bit data)
        if has_d:
            if cache.bits == 4:
                rows = pack_token_pairs(rows)
            d = rows.shape[-1]
            rpp = rows.shape[2] // n_used
            r = rows.reshape(b, h, n_used, rpp, d)
            r = jnp.moveaxis(r, 2, 1).reshape(b * n_used, h, rpp, d)
        else:
            r = rows.reshape(b, h, n_used, page)
            r = jnp.moveaxis(r, 2, 1).reshape(b * n_used, h, page)
        return pool.at[ids].set(r, mode="drop")

    cache = dataclasses.replace(
        cache,
        pages_k=put(cache.pages_k, k_q, True),
        pages_k_scale=put(cache.pages_k_scale, k_s, False),
        pages_v=put(cache.pages_v, v_q, True),
        pages_v_scale=put(cache.pages_v_scale, v_s, False),
    )
    return cache, jnp.full((b,), t, jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("sm_scale", "window", "return_state")
)
def sageattn_paged_decode(
    q: jax.Array,            # [b, hq, t_q, d]
    cache: PagedKVCache,
    lengths: jax.Array,      # [b]
    *,
    owned: jax.Array | None = None,
    page_table: jax.Array | None = None,
    sm_scale: float | None = None,
    window: int | None = None,
    return_state: bool = False,
):
    """Decode attention through the page table (same query semantics as
    sageattn_decode, including ``window``).  Each sequence's logical
    pages are gathered from the pool with ``jnp.take`` and decoded like
    a dense cache.

    ``owned``/``page_table``/``return_state``: the sharded-pool hooks —
    a LOCAL page table overriding the cache's own, an ownership mask
    [b, max_pages] restricting which logical pages this shard
    contributes, and the (o, m, l) merge state for the exact
    cross-shard LSE reduce (see parallel/decode.py)."""
    if owned is not None and not return_state:
        # a normalized shard partial is indistinguishable from a full
        # decode output — refuse the silent footgun
        raise ValueError(
            "owned= runs a PARTIAL decode over a pool shard; it requires "
            "return_state=True so the caller can merge the partials "
            "(merge_decode_partials)"
        )
    table = cache.page_table if page_table is None else page_table
    b, n_pages = table.shape
    page = cache.page_size

    def gather(pool):  # [P, h, rows, (d)] -> [b, h, n_pages * rows, (d)]
        x = jnp.take(pool, table.reshape(-1), axis=0)
        x = x.reshape((b, n_pages) + pool.shape[1:])
        x = jnp.moveaxis(x, 1, 2)
        return x.reshape(x.shape[:2] + (-1,) + x.shape[4:])

    key_live = None
    if owned is not None:
        key_live = jnp.repeat(owned.astype(bool), page, axis=1)
    o, m, l = decode_attention(
        q, _unpacked(gather(cache.pages_k), cache.bits),
        gather(cache.pages_k_scale),
        _unpacked(gather(cache.pages_v), cache.bits),
        gather(cache.pages_v_scale), lengths, sm_scale=sm_scale,
        window=window, key_live=key_live,
    )
    o = _vmean_addback(o, lengths, cache.v_mean)
    return (o, m, l) if return_state else o

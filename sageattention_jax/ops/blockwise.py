"""Plain-JAX blockwise SageAttention: forward and backward over KV chunks.

This is the path XLA compiles for every option the fused kernel does not
take (bool masks, additive biases, segment ids / varlen, positions,
sliding windows, ``smooth_q``'s column bias, per-row quantization
granularities), the CPU path, and the one backward.  Neither direction
ever builds an [sq, sk] tensor: a ``lax.scan`` walks KV chunks of
``chunk`` keys, so the largest intermediate is [b, h, sq, chunk].

Forward: each chunk runs ``reference.quantized_attention_reference`` on
its slice of the quantized operands, and ``reference.merge_attention_
partials`` folds the chunk into the running (o, lse) — the spec's own
arithmetic, chunk by chunk.

Backward: flash-style.  P is recomputed per chunk from the forward's
quantized logits and saved base-2 LSE (the straight-through gradient of
the quantized forward: rows of P sum to one by construction), the LSE
cotangent folds into D as ``dS = P * (dP - (D - dlse))``, dQ accumulates
in the scan carry and dK/dV are emitted per chunk.  Memory is O(s * d)
plus one chunk of scores.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sageattention_jax.ops import reference

LOG2E = 1.4426950408889634


def default_chunk(block_k: int, target: int = 512) -> int:
    """KV keys per scan step: a multiple of the K quantization group."""
    return block_k * max(1, target // block_k)


def _split(x: jax.Array, axis: int, n: int, chunk: int) -> jax.Array:
    """Pad ``axis`` to n * chunk and move the chunk index to axis 0."""
    pad = n * chunk - x.shape[axis]
    if pad:
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        x = jnp.pad(x, widths)
    x = x.reshape(x.shape[:axis] + (n, chunk) + x.shape[axis + 1:])
    return jnp.moveaxis(x, axis, 0)


def _band_mask(cols, sq: int, sk: int, is_causal: bool,
               window: int | None) -> jax.Array:
    """[1, 1, sq, chunk] bool: key columns ``cols`` that are real (below
    sk), at or left of the diagonal (causal, top-left aligned) and inside
    the last ``window`` keys of each row (reference.window_band_mask's
    convention)."""
    rows = jnp.arange(sq, dtype=jnp.int32)[:, None]
    live = jnp.broadcast_to(cols[None, :] < sk, (sq, cols.shape[0]))
    if is_causal:
        live = live & (cols[None, :] <= rows)
    if window is not None:
        live = live & (cols[None, :] > rows - window)
    return live[None, None]


def attention_fwd(
    q_i8: jax.Array,       # [b, hq, sq, d] int8
    q_scale: jax.Array,    # [b, hq, sq] f32, sm_scale * log2e folded in
    k_i8: jax.Array,       # [b, hkv, sk, d] int8
    k_scale: jax.Array,    # [b, hkv, sk] f32 per key row
    v_q: jax.Array,        # [b, hkv, sk, d]
    v_scale: jax.Array | None = None,
    v_mean: jax.Array | None = None,
    *,
    is_causal: bool = False,
    window: int | None = None,
    q_segment_ids=None,
    kv_segment_ids=None,
    q_positions=None,
    kv_positions=None,
    attn_mask=None,        # [b, 1|hq, sq, sk] bool
    score_bias=None,       # [b, 1|hq, sq, sk] base-2 additive
    score_col_bias=None,   # [b, hq, sk] base-2 additive
    chunk: int = 512,
    out_dtype=jnp.bfloat16,
):
    """Quantized attention over KV chunks; returns (o, base-2 lse).

    Rows with no live key return o = 0 and lse = -inf."""
    b, hq, sq, d = q_i8.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    chunk = min(chunk, sk)
    n = -(-sk // chunk)
    xs = {
        "cols": jnp.arange(n * chunk, dtype=jnp.int32).reshape(n, chunk),
        "k": _split(k_i8, 2, n, chunk),
        "ks": _split(k_scale, 2, n, chunk),
        "v": _split(v_q, 2, n, chunk),
    }
    if kv_segment_ids is not None:
        xs["kv_seg"] = _split(kv_segment_ids, 1, n, chunk)
    if kv_positions is not None:
        xs["kv_pos"] = _split(kv_positions, 1, n, chunk)
    if attn_mask is not None:
        xs["mask"] = _split(attn_mask, 3, n, chunk)
    if score_bias is not None:
        xs["bias"] = _split(score_bias, 3, n, chunk)
    if score_col_bias is not None:
        xs["col_bias"] = _split(score_col_bias, 2, n, chunk)

    def step(carry, c):
        o_acc, lse_acc = carry
        mask = _band_mask(c["cols"], sq, sk, is_causal, window)
        if "mask" in c:
            mask = mask & c["mask"]
        o_c, lse2_c = reference.quantized_attention_reference(
            q_i8, q_scale, c["k"], c["ks"], c["v"], v_scale,
            q_segment_ids=q_segment_ids, kv_segment_ids=c.get("kv_seg"),
            q_positions=q_positions, kv_positions=c.get("kv_pos"),
            attn_mask=mask, score_col_bias=c.get("col_bias"),
            score_bias=c.get("bias"), return_lse=True,
            out_dtype=jnp.float32,
        )
        # a row with no live key in this chunk has a MASK_VALUE-scale
        # LSE: give it zero weight
        lse_c = jnp.where(
            lse2_c > 0.5 * reference.MASK_VALUE, lse2_c / LOG2E, -jnp.inf
        )
        return reference.merge_attention_partials(
            [o_acc, o_c], [lse_acc, lse_c]
        ), None

    init = (
        jnp.zeros((b, hq, sq, d), jnp.float32),
        jnp.full((b, hq, sq), -jnp.inf, jnp.float32),
    )
    (o, lse), _ = jax.lax.scan(step, init, xs)
    if v_mean is not None:
        live = jnp.isfinite(lse)[..., None]
        o = o + jnp.where(live, jnp.repeat(v_mean, hq // hkv, axis=1)[
            ..., None, :], 0.0)
    return o.astype(out_dtype), lse * LOG2E


def attention_bwd(
    q: jax.Array,          # [b, hq, sq, d] the forward's real inputs
    k: jax.Array,          # [b, hkv, sk, d]
    v_eff: jax.Array,      # [b, hkv, sk, d] the V the forward multiplied
    o: jax.Array,          # [b, hq, sq, d] forward output
    lse2: jax.Array,       # [b, hq, sq] forward base-2 LSE (smoothed)
    do: jax.Array,         # [b, hq, sq, d]
    dlse: jax.Array | None,  # [b, hq, sq] natural-log LSE cotangent
    q_i8: jax.Array,
    q_scale: jax.Array,
    k_i8: jax.Array,
    k_scale: jax.Array,    # [b, hkv, sk] per key row
    *,
    sm_scale: float,
    is_causal: bool = False,
    window: int | None = None,
    score_bias=None,       # [b, 1|hq, sq, sk] base-2 additive
    score_col_bias=None,   # [b, hq, sk] base-2 additive
    need_dbias: bool = False,
    chunk: int = 512,
):
    """Straight-through gradients of the quantized forward.

    Returns (dq, dk, dv) and, with ``need_dbias``, dS [b, hq, sq, sk]
    (the natural-log bias cotangent)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    chunk = min(chunk, sk)
    n = -(-sk // chunk)

    def grouped(x):  # [b, hq, ...] -> [b, hkv, g, ...]
        return x.reshape((b, hkv, g) + x.shape[2:])

    qf = grouped(q.astype(jnp.float32))
    dof = grouped(do.astype(jnp.float32))
    qi, qs = grouped(q_i8), grouped(q_scale)
    dvec = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    if dlse is not None:
        dvec = dvec - dlse.astype(jnp.float32)
    dvec = grouped(dvec)
    live_row = jnp.isfinite(lse2)
    lse2 = grouped(jnp.where(live_row, lse2, 0.0))
    live_row = grouped(live_row)

    xs = {
        "cols": jnp.arange(n * chunk, dtype=jnp.int32).reshape(n, chunk),
        "k": _split(k.astype(jnp.float32), 2, n, chunk),
        "ki": _split(k_i8, 2, n, chunk),
        "ks": _split(k_scale, 2, n, chunk),
        "v": _split(v_eff.astype(jnp.float32), 2, n, chunk),
    }
    if score_bias is not None:
        xs["bias"] = _split(
            jnp.broadcast_to(score_bias, (b, hq, sq, sk)), 3, n, chunk
        )
    if score_col_bias is not None:
        xs["col_bias"] = _split(score_col_bias, 2, n, chunk)

    def step(dq, c):
        s_i32 = jnp.einsum(
            "bhgqd,bhkd->bhgqk", qi, c["ki"],
            preferred_element_type=jnp.int32,
        )
        s = s_i32.astype(jnp.float32) * qs[..., None] * c["ks"][:, :, None, None, :]
        if "col_bias" in c:
            s = s + grouped(c["col_bias"])[..., None, :]
        if "bias" in c:
            s = s + grouped(c["bias"])
        live = _band_mask(c["cols"], sq, sk, is_causal, window)[:, None]
        live = live & live_row[..., None]
        p = jnp.where(live, jnp.exp2(s - lse2[..., None]), 0.0)
        dp = jnp.einsum("bhgqd,bhkd->bhgqk", dof, c["v"])
        ds = p * (dp - dvec[..., None])
        dq = dq + sm_scale * jnp.einsum("bhgqk,bhkd->bhgqd", ds, c["k"])
        dk = sm_scale * jnp.einsum("bhgqk,bhgqd->bhkd", ds, qf)
        dv = jnp.einsum("bhgqk,bhgqd->bhkd", p, dof)
        return dq, (dk, dv, ds.reshape(b, hq, sq, -1) if need_dbias else None)

    dq, (dk, dv, ds) = jax.lax.scan(step, jnp.zeros_like(qf), xs)

    def merge(x):  # [n, b, hkv, chunk, d] -> [b, hkv, sk, d]
        x = jnp.moveaxis(x, 0, 2).reshape(b, hkv, n * chunk, d)
        return x[:, :, :sk]

    grads = (
        dq.reshape(b, hq, sq, d).astype(q.dtype),
        merge(dk).astype(k.dtype),
        merge(dv).astype(v_eff.dtype),
    )
    if need_dbias:
        ds = jnp.moveaxis(ds, 0, 3).reshape(b, hq, sq, n * chunk)[..., :sk]
        return grads + (ds,)
    return grads

"""Fused SageAttention forward for Hopper: Pallas through Triton.

One program per (query tile, batch * query head).  The program keeps its
int8 Q tile and per-token Q scales in registers and walks the KV tiles in
a ``lax.fori_loop``, carrying the online-softmax state (acc, m, l):

* Q·Kᵀ is an int8 x int8 -> int32 ``pl.dot`` (the card's integer tensor
  cores).  The dequantization is one multiply per score by
  ``q_scale[row] * k_scale[tile]``, with ``sm_scale * log2(e)`` already
  folded into ``q_scale``, so the softmax runs on ``exp2``.
* K carries one scale per KV tile (the quantization group equals
  ``block_k``).
* P is cast to bf16 for P·V.  int8 and fp8 V codes are cast to bf16 in
  registers (exact: both code sets are bf16 values); the per-channel V
  scale and mean are applied once, in the epilogue.
* Causal: the KV loop stops at the diagonal and only the tiles that
  straddle it (or the ragged KV tail) pay for a mask.
* GQA: the K/V head of query head ``h`` is ``h // group``, in the index
  maps; nothing is repeated in memory.
* ``return_lse`` writes the base-2 LSE ``m + log2(l)`` of the smoothed
  logits (core.py converts it to the natural-log contract).

The arithmetic is ``reference.quantized_attention_reference``'s, up to
the order of fp32 sums and the bf16 rounding of P.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from sageattention_jax.ops.reference import MASK_VALUE

# Tile sizes and launch parameters by padded head dim, chosen on an H100
# (PERF.md, "Findings").
DEFAULT_TILES = {
    # head_dim: (block_q, block_k, num_warps, num_stages)
    16: (128, 64, 4, 3),
    32: (128, 64, 4, 3),
    64: (128, 64, 4, 3),
    128: (128, 64, 4, 3),
    256: (64, 64, 8, 2),
}


def padded_head_dim(d: int) -> int:
    """Triton tiles are powers of two; 16 is the smallest MMA depth."""
    return max(16, pl.next_power_of_2(d))


def _q_tile(i, n_q: int, causal: bool):
    """Query tile of grid step ``i``.  Causal grids run the heaviest
    tiles (the last ones, which walk the most KV tiles) first."""
    return n_q - 1 - i if causal else i


def _fwd_kernel(
    q_ref,    # [BQ, D] int8
    qs_ref,   # [BQ] f32, sm_scale * log2e folded in
    k_ref,    # [SK, D] int8 (the whole KV row of this head)
    ks_ref,   # [n_kv_tiles] f32, one scale per KV tile
    v_ref,    # [SK, D] bf16 / int8 / fp8
    vs_ref,   # [D] f32 per-channel V scale (ones for bf16 V)
    vm_ref,   # [D] f32 per-channel V mean (zeros without smooth_v)
    o_ref,    # [BQ, D]
    *lse_ref,  # optional [BQ] f32
    block_q: int,
    block_k: int,
    kv_len: int,
    n_q: int,
    causal: bool,
):
    i = _q_tile(pl.program_id(0), n_q, causal)
    q = q_ref[...]
    qs = qs_ref[...]
    d = q.shape[-1]

    def tile(t, carry, masked: bool):
        acc, m, l = carry
        k = k_ref[pl.ds(t * block_k, block_k), :]
        s = pl.dot(q, k, trans_b=True).astype(jnp.float32)
        s = s * (qs * ks_ref[t])[:, None]
        if masked:
            col = t * block_k + lax.broadcasted_iota(
                jnp.int32, (block_q, block_k), 1
            )
            live = col < kv_len
            if causal:
                row = i * block_q + lax.broadcasted_iota(
                    jnp.int32, (block_q, block_k), 0
                )
                live = jnp.logical_and(live, col <= row)
            s = jnp.where(live, s, MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = jnp.exp2(s - m_new[:, None])
        l = l * alpha + jnp.sum(p, axis=1)
        v = v_ref[pl.ds(t * block_k, block_k), :]
        if v.dtype != jnp.bfloat16:
            v = v.astype(jnp.bfloat16)
        acc = acc * alpha[:, None] + pl.dot(p.astype(jnp.bfloat16), v)
        return acc, m_new, l

    n_tiles = pl.cdiv(kv_len, block_k)
    if causal:
        # tiles wholly at or below every row's diagonal run unmasked
        first_row = i * block_q
        n_full = jnp.minimum(
            lax.div(first_row + 1, block_k), kv_len // block_k
        )
        n_live = jnp.minimum(
            lax.div(first_row + block_q + block_k - 1, block_k), n_tiles
        )
    else:
        n_full = kv_len // block_k
        n_live = n_tiles
    carry = (
        jnp.zeros((block_q, d), jnp.float32),
        jnp.full((block_q,), -jnp.inf, jnp.float32),
        jnp.zeros((block_q,), jnp.float32),
    )
    carry = lax.fori_loop(
        0, n_full, functools.partial(tile, masked=False), carry
    )
    acc, m, l = lax.fori_loop(
        n_full, n_live, functools.partial(tile, masked=True), carry
    )
    o = acc / l[:, None] * vs_ref[...][None, :] + vm_ref[...][None, :]
    o_ref[...] = o.astype(o_ref.dtype)
    if lse_ref:
        lse_ref[0][...] = m + jnp.log2(l)


def _pad_to(x, axis, to):
    pad = to - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


@functools.partial(
    jax.jit,
    static_argnames=(
        "is_causal", "return_lse", "block_q", "block_k", "num_warps",
        "num_stages", "out_dtype", "interpret",
    ),
)
def sage_attention_fwd(
    q_i8: jax.Array,      # [b, hq, sq, d] int8
    q_scale: jax.Array,   # [b, hq, sq] f32, sm_scale * log2e folded in
    k_i8: jax.Array,      # [b, hkv, sk, d] int8, smoothed
    k_scale: jax.Array,   # [b, hkv, ceil(sk / block_k)] f32
    v: jax.Array,         # [b, hkv, sk, d] bf16 / int8 / fp8
    v_scale: jax.Array | None = None,   # [b, hkv, d]
    v_mean: jax.Array | None = None,    # [b, hkv, d]
    *,
    is_causal: bool = False,
    return_lse: bool = False,
    block_q: int | None = None,
    block_k: int | None = None,
    num_warps: int | None = None,
    num_stages: int | None = None,
    out_dtype=jnp.bfloat16,
    interpret: bool = False,
):
    """Quantized attention forward; returns o [b, hq, sq, d] and, with
    ``return_lse``, the base-2 LSE [b, hq, sq].

    ``k_scale`` must hold one scale per ``block_k`` rows of K, i.e. the
    K quantization group is the kernel's KV tile.  Sequence lengths may
    be ragged (padded here, masked in the kernel); head dims pad to a
    power of two."""
    b, hq, sq, d = q_i8.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    dp = padded_head_dim(d)
    bq0, bk0, nw0, ns0 = DEFAULT_TILES[dp]
    block_q = block_q or bq0
    block_k = block_k or bk0
    if k_scale.shape[-1] != pl.cdiv(sk, block_k):
        raise ValueError(
            f"k_scale has {k_scale.shape[-1]} tile scales; block_k={block_k} "
            f"over sk={sk} needs {pl.cdiv(sk, block_k)}"
        )
    n_q = pl.cdiv(sq, block_q)
    sq_p = n_q * block_q
    sk_p = pl.cdiv(sk, block_k) * block_k
    q_i8 = _pad_to(_pad_to(q_i8, 3, dp), 2, sq_p)
    q_scale = _pad_to(q_scale.astype(jnp.float32), 2, sq_p)
    k_i8 = _pad_to(_pad_to(k_i8, 3, dp), 2, sk_p)
    v = _pad_to(_pad_to(v, 3, dp), 2, sk_p)
    if v_scale is None:
        v_scale = jnp.ones((b, hkv, d), jnp.float32)
    if v_mean is None:
        v_mean = jnp.zeros((b, hkv, d), jnp.float32)
    v_scale = _pad_to(v_scale.astype(jnp.float32), 2, dp)
    v_mean = _pad_to(v_mean.astype(jnp.float32), 2, dp)

    def q_map(i, j):
        return (j // hq, j % hq, _q_tile(i, n_q, is_causal), 0)

    def row_map(i, j):
        return (j // hq, j % hq, _q_tile(i, n_q, is_causal))

    def kv_map(i, j):
        return (j // hq, (j % hq) // group, 0, 0)

    def kv_vec_map(i, j):
        return (j // hq, (j % hq) // group, 0)

    in_specs = [
        pl.BlockSpec((None, None, block_q, dp), q_map),
        pl.BlockSpec((None, None, block_q), row_map),
        pl.BlockSpec((None, None, sk_p, dp), kv_map),
        pl.BlockSpec((None, None, k_scale.shape[-1]), kv_vec_map),
        pl.BlockSpec((None, None, sk_p, dp), kv_map),
        pl.BlockSpec((None, None, dp), kv_vec_map),
        pl.BlockSpec((None, None, dp), kv_vec_map),
    ]
    out_specs = [pl.BlockSpec((None, None, block_q, dp), q_map)]
    out_shape = [jax.ShapeDtypeStruct((b, hq, sq_p, dp), out_dtype)]
    if return_lse:
        out_specs.append(pl.BlockSpec((None, None, block_q), row_map))
        out_shape.append(jax.ShapeDtypeStruct((b, hq, sq_p), jnp.float32))
    kernel = functools.partial(
        _fwd_kernel, block_q=block_q, block_k=block_k, kv_len=sk, n_q=n_q,
        causal=is_causal,
    )
    res = pl.pallas_call(
        kernel,
        grid=(n_q, b * hq),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=plt.CompilerParams(
            num_warps=num_warps or nw0, num_stages=num_stages or ns0
        ),
        backend="triton",
        interpret=interpret,
        name="sage_attention_fwd",
    )(q_i8, q_scale, k_i8, k_scale.astype(jnp.float32), v, v_scale, v_mean)
    o = res[0][:, :, :sq, :d]
    if return_lse:
        return o, res[1][:, :, :sq]
    return o

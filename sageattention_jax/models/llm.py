"""Decoder-only LLM — SageAttention's second headline use case (causal
attention, reference bench sweep: bench_qk_int8_pv_fp8_cuda.py
is_causal=True shapes).

Llama-style: RMSNorm, RoPE, GQA, SwiGLU, causal sage attention via the
pluggable backend.  Two paths:

* prefill — full-sequence causal attention (the reference's use case),
  optionally filling the int8 KV caches as it goes;
* decode — token-at-a-time generation over the quantized KV cache
  (kvcache.sageattn_decode), beyond the reference (its kernels are
  prefill/training-shape only).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sageattention_jax import kvcache
from sageattention_jax.models import layers as L
from sageattention_jax.models.attention import (
    attention as _attention,
)
from sageattention_jax.models.configs import LLMConfig


def rope(x, positions, base=10000.0):
    """x: [b, h, s, d]; rotate pairs (d/2)."""
    d = x.shape[-1]
    half = d // 2
    freqs = base ** (-jnp.arange(half, dtype=jnp.float32) / half)
    ang = positions.astype(jnp.float32)[:, None, :, None] * freqs  # [b,1,s,half]
    sin, cos = jnp.sin(ang), jnp.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate(
        [
            (x1 * cos - x2 * sin).astype(x.dtype),
            (x2 * cos + x1 * sin).astype(x.dtype),
        ],
        axis=-1,
    )


def _init_layer(key, c: LLMConfig) -> dict:
    kg = L.KeyGen(key)
    mh = c.mlp_hidden or 4 * c.hidden
    return {
        "attn_norm": L.init_norm(c.hidden, bias=False),
        "q": L.init_dense(kg(), c.hidden, c.heads * c.head_dim, bias=False),
        "k": L.init_dense(kg(), c.hidden, c.kv_heads * c.head_dim,
                          bias=False),
        "v": L.init_dense(kg(), c.hidden, c.kv_heads * c.head_dim,
                          bias=False),
        "o_proj": L.init_dense(kg(), c.heads * c.head_dim, c.hidden,
                               bias=False),
        "mlp_norm": L.init_norm(c.hidden, bias=False),
        "gate": L.init_dense(kg(), c.hidden, mh, bias=False),
        "up": L.init_dense(kg(), c.hidden, mh, bias=False),
        "down": L.init_dense(kg(), mh, c.hidden, bias=False),
    }


def _layer(p, x, positions, c: LLMConfig, dtype, cache=None, lengths=None,
           decode=False):
    b, s, _ = x.shape
    h = L.rms_norm(p["attn_norm"], x, dtype)
    q = rope(L.split_heads(L.dense(p["q"], h, dtype), c.heads, c.head_dim),
             positions)
    k = rope(L.split_heads(L.dense(p["k"], h, dtype), c.kv_heads,
                           c.head_dim), positions)
    v = L.split_heads(L.dense(p["v"], h, dtype), c.kv_heads, c.head_dim)
    W = c.window
    wkw = {} if W is None else {"window": W}
    if decode and cache is None:
        # decoding without a cache would attend only the current
        # token(s) — context-free logits that LOOK valid; fail loudly
        raise ValueError(
            "decode=True requires caches (init_caches / "
            "init_paged_caches); got None"
        )
    new_cache = None
    if cache is not None and cache.bits == 4 and lengths is not None:
        # int4 cache: freeze per-channel K/V means on each batch's
        # FIRST write (lengths == 0) — prefill or the first chunked-
        # prefill block alike; live batches keep their frozen means
        # (the calibrate empty-cache contract, enforced per batch).
        # The corrections are exact — see kvcache.calibrate
        cache = kvcache.calibrate(cache, k, v, lengths)
    if isinstance(cache, kvcache.PagedKVCache):
        # vLLM-style paged serving: appends follow the page table.  The
        # non-decode path is a whole-prompt prefill (lengths == 0
        # contract) — write page-granular bulk pages when the shape
        # allows instead of scattering s individual token rows
        if not decode and s % cache.page_size == 0:
            new_cache, new_len = kvcache.paged_prefill(cache, k, v)
        else:
            new_cache, new_len = kvcache.paged_append(cache, lengths, k, v)
        if decode:
            o = kvcache.sageattn_paged_decode(q, new_cache, new_len,
                                              window=W)
        else:
            o = _attention(q, k, v, is_causal=True, **wkw)
    elif cache is not None:
        new_cache, new_len = kvcache.append_kv(cache, lengths, k, v)
        if decode:
            o = kvcache.sageattn_decode(q, new_cache, new_len, window=W)
        else:
            # prefill: attend the prompt directly (faster than reading
            # the cache back); the cache is now filled
            o = _attention(q, k, v, is_causal=True, **wkw)
    else:
        o = _attention(q, k, v, is_causal=True, **wkw)
    x = x + L.dense(p["o_proj"], L.merge_heads(o), dtype)

    h = L.rms_norm(p["mlp_norm"], x, dtype)
    act = jax.nn.silu(L.dense(p["gate"], h, dtype)) * L.dense(p["up"], h,
                                                             dtype)
    return x + L.dense(p["down"], act, dtype), new_cache


class CausalLM:
    """Llama-style decoder: ``init(key, tokens)`` -> {"params": ...},
    ``apply(params, tokens, caches=None, lengths=None, decode=False)``."""

    def __init__(self, cfg: LLMConfig, dtype=jnp.bfloat16):
        self.cfg = cfg
        self.dtype = dtype

    def init(self, key, tokens, *args, **kwargs) -> dict:
        del tokens, args, kwargs
        c, kg = self.cfg, L.KeyGen(key)
        params = {
            "embed": {"embedding": jax.random.normal(
                kg(), (c.vocab, c.hidden), jnp.float32) * c.hidden**-0.5},
            "final_norm": L.init_norm(c.hidden, bias=False),
            "lm_head": L.init_dense(kg(), c.hidden, c.vocab, bias=False),
        }
        for i in range(c.depth):
            params[f"layer_{i}"] = _init_layer(kg(), c)
        return {"params": params}

    def apply(self, params, tokens, caches=None, lengths=None, decode=False):
        """Prefill: ``apply(params, tokens)`` -> logits; with ``caches``
        (a list of per-layer QuantKVCache) the prompt is also written into
        them (expects lengths == 0 — the non-decode path attends only the
        given tokens).  Decode/continuation: ``decode=True`` with the
        current ``lengths`` -> (logits, new_caches) attending the int8
        cache (t > 1 gets the causal tail, so chunked prefill continuation
        also goes through decode=True)."""
        c, p = self.cfg, params["params"]
        b, s = tokens.shape
        x = jnp.take(p["embed"]["embedding"], tokens, axis=0).astype(
            self.dtype
        )
        if lengths is None:
            if caches is not None:
                # the advertised prefill form: caches given, lengths
                # defaulting to empty sequences
                lengths = jnp.zeros((b,), jnp.int32)
            positions = jnp.broadcast_to(jnp.arange(s), (b, s))
        else:
            positions = lengths[:, None] + jnp.arange(s)[None, :]
        new_caches = [] if caches is not None else None
        for i in range(c.depth):
            cache_i = caches[i] if caches is not None else None
            x, nc = _layer(p[f"layer_{i}"], x, positions, c, self.dtype,
                           cache=cache_i, lengths=lengths, decode=decode)
            if new_caches is not None:
                new_caches.append(nc)
        x = L.rms_norm(p["final_norm"], x)
        logits = L.dense(p["lm_head"], x, jnp.float32)
        if caches is not None:
            return logits, new_caches
        return logits
    def init_caches(self, b: int, max_len: int, bits: int = 8):
        c = self.cfg
        return [
            kvcache.init_kv_cache(
                b, c.kv_heads, max_len, c.head_dim, bits=bits
            )
            for _ in range(c.depth)
        ]

    def init_paged_caches(
        self, b: int, max_len: int, page_size: int = 1024,
        page_table: jax.Array | None = None, bits: int = 8,
    ):
        """Per-layer paged pools sized for ``b`` sequences of ``max_len``
        tokens.  Default policy: a linear page table (sequence i owns
        pages [i*n, (i+1)*n)); pass ``page_table`` [b, n] for any other
        physical assignment — decode gathers through it either way."""
        c = self.cfg
        n = -(-max_len // page_size)
        if page_table is None:
            page_table = jnp.arange(b * n, dtype=jnp.int32).reshape(b, n)
        return [
            kvcache.init_paged_kv_cache(
                b * n, c.kv_heads, c.head_dim, page_table,
                page_size=page_size, bits=bits,
            )
            for _ in range(c.depth)
        ]

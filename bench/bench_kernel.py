#!/usr/bin/env python
"""Fused sage-attention kernel TOPS sweep (reference:
bench/bench_qk_int8_pv_fp8_cuda.py, bench_qk_int8_pv_fp16_cuda.py).

Replicates the reference protocol: b=4, h=32, hd in {64,128},
seq 1k-32k, causal and non-causal, kernel-only (quantization excluded,
reference: bench/README.md:63).  Variants map the reference's accumulator
matrix to this framework's V-storage dtypes:

    pv int8  ~ qk_int8_sv_f8  (quantized V, per-channel scales)
    pv bf16  ~ qk_int8_sv_f16 (high-accuracy fallback)
    pv fp8   ~ qk_int8_sv_f8  (e4m3 V storage)

The kernel is the Pallas-through-Triton one (ops/attention_triton.py);
``--block_q/--block_k/--num_warps/--num_stages`` override its tile table.

Usage: python bench/bench_kernel.py [--pv_dtype int8] [--causal]
         [--head_dim 128] [--seqs 1024,...]
"""

import argparse
import functools
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from bench.utils import attention_flops, card, require_gpu, time_ms
from sageattention_jax import core
from sageattention_jax.ops import attention_triton


def bench_one(b, h, s, d, *, causal, pv_dtype, block_q=None, block_k=None,
              num_warps=None, num_stages=None):
    q = jax.random.normal(jax.random.PRNGKey(0), (b, h, s, d), jnp.bfloat16)
    k = jax.random.normal(jax.random.PRNGKey(1), (b, h, s, d), jnp.bfloat16)
    v = jax.random.normal(jax.random.PRNGKey(2), (b, h, s, d), jnp.bfloat16)
    block_k = block_k or core.default_blocks(d)[1]
    qz = core.quantize_operands(
        q, k, v, sm_scale=d**-0.5, qk_quant_gran="auto", pv_dtype=pv_dtype,
        smooth_k=True, smooth_q=False, smooth_v=False, qk_bits=8,
        k_group=block_k,
    )
    f = jax.jit(functools.partial(
        attention_triton.sage_attention_fwd, is_causal=causal,
        block_q=block_q, block_k=block_k, num_warps=num_warps,
        num_stages=num_stages,
    ))
    ms = time_ms(f, qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale, qz.v_q,
                 qz.v_scale, qz.v_mean)
    return attention_flops(b, h, s, d, causal) / (ms * 1e-3) / 1e12, ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--head_dim", type=int, default=128)
    ap.add_argument("--seqs", default="1024,2048,4096,8192,16384,32768")
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--pv_dtype", default="int8",
                    choices=["int8", "bf16", "fp8"])
    ap.add_argument("--block_q", type=int, default=None)
    ap.add_argument("--block_k", type=int, default=None)
    ap.add_argument("--num_warps", type=int, default=None)
    ap.add_argument("--num_stages", type=int, default=None)
    args = ap.parse_args()
    require_gpu()

    print(f"# {card()}: pv={args.pv_dtype} causal={args.causal} "
          f"b={args.batch} h={args.heads} hd={args.head_dim}")
    for s in (int(x) for x in args.seqs.split(",")):
        tops, ms = bench_one(
            args.batch, args.heads, s, args.head_dim, causal=args.causal,
            pv_dtype=args.pv_dtype, block_q=args.block_q,
            block_k=args.block_k, num_warps=args.num_warps,
            num_stages=args.num_stages,
        )
        print(f"seq {s:6d}: {ms:8.3f} ms  {tops:7.1f} TOPS", flush=True)


if __name__ == "__main__":
    main()

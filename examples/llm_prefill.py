#!/usr/bin/env python
"""LLM prefill with causal sage attention — SageAttention's second headline
use case (reference: the causal bench sweeps, bench_qk_int8_pv_fp8_cuda.py
is_causal=True).

Runs a llama-7B-shaped (or GQA llama-3-8B-shaped) decoder prefill and
reports per-forward time and logit parity vs the sdpa backend.
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from sageattention_jax import models
from sageattention_jax.models.configs import MODEL_CONFIGS
from sageattention_jax.models.llm import CausalLM
from sageattention_jax.utils.compare import cosine_similarity


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llm-7b",
                    choices=["llm-7b", "llm-8b-gqa"])
    ap.add_argument("--attention_type", default="sage",
                    choices=["sage", "sage_bf16", "sage_fp8", "sdpa"])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--depth", type=int, default=4,
                    help="layers to run (full model: 32)")
    ap.add_argument("--compare", action="store_true")
    args = ap.parse_args()

    cfg = MODEL_CONFIGS[args.model].scaled(depth=args.depth)
    models.set_attention_backend(args.attention_type)
    model = CausalLM(cfg)
    tokens = jax.random.randint(
        jax.random.PRNGKey(0), (args.batch, args.seq), 0, cfg.vocab
    )
    params = model.init(jax.random.PRNGKey(1), tokens)

    fwd = jax.jit(model.apply)

    sync = jax.block_until_ready

    t0 = time.time()
    logits = fwd(params, tokens)
    sync(logits)
    print(f"compile+first prefill: {time.time()-t0:.2f} s")

    t0 = time.time()
    n = 3
    for _ in range(n):
        logits = fwd(params, tokens)
    sync(logits)
    tok_s = args.batch * args.seq / ((time.time() - t0) / n)
    print(f"prefill: {(time.time()-t0)/n*1e3:.1f} ms "
          f"({tok_s/1e3:.1f}k tok/s, seq {args.seq}, depth {cfg.depth}, "
          f"backend {args.attention_type})")

    if args.compare:
        models.set_attention_backend("sdpa")
        ref = jax.jit(model.apply)(params, tokens)
        print(f"logit parity vs sdpa: cosine="
              f"{cosine_similarity(logits, ref):.6f}")


if __name__ == "__main__":
    main()

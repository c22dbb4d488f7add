#!/usr/bin/env python
"""LLM serving loop: prefill + token-at-a-time decode over the int8 KV
cache (beyond the reference, which covers prefill only).

The decode step streams the quantized cache once per token — int8 K/V
halves the bytes and the footprint vs a bf16 cache, which is the decode
bottleneck at long context.

``--paged`` switches the per-layer caches to the vLLM-style paged pool
(page-table appends + scalar-prefetch decode gather) — same loop, same
tokens, pages can live anywhere in the pool.

Usage: python examples/llm_decode.py [--scale 0.1] [--prompt_len 512]
       [--gen 32] [--max_len 4096] [--paged] [--page_size 1024]
       [--bits 4]
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from sageattention_jax import models
from sageattention_jax.models.configs import MODEL_CONFIGS


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1,
                    help="model size factor vs llm-7b (1.0 = full)")
    ap.add_argument("--prompt_len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max_len", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV pool (vLLM-style)")
    ap.add_argument("--page_size", type=int, default=1024)
    ap.add_argument("--bits", type=int, default=8, choices=(8, 4),
                    help="cache storage width (4 = packed int4: half "
                         "the footprint and cache-read bytes; means "
                         "auto-calibrated on the prompt)")
    ap.add_argument("--chunked_prefill", type=int, default=0,
                    metavar="N",
                    help="prefill the prompt in N-token extend blocks "
                         "through the quantized cache (the vLLM extend "
                         "phase) instead of one full-attention pass")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decoding mechanics demo: draft K "
                         "tokens (self-draft on a throwaway cache "
                         "copy), verify them in ONE t_q=K+1 extend "
                         "step (greedy acceptance + free rollback)")
    args = ap.parse_args()

    base = MODEL_CONFIGS["llm-7b"]
    heads = max(4, int(base.heads * args.scale) // 2 * 2)
    if args.scale >= 1.0:
        kv_heads = base.kv_heads  # full model: the advertised architecture
    else:
        kv_heads = max(2, heads // 4)  # keep hq a multiple of hkv (GQA)
    cfg = base.scaled(
        depth=max(2, int(base.depth * args.scale)),
        hidden=max(128, int(base.hidden * args.scale) // 128 * 128),
        heads=heads,
        kv_heads=kv_heads,
    )
    print(f"model: depth={cfg.depth} hidden={cfg.hidden} heads={cfg.heads} "
          f"kv_heads={cfg.kv_heads} head_dim={cfg.head_dim}")
    model = models.CausalLM(cfg)
    b = args.batch
    toks = jax.random.randint(
        jax.random.PRNGKey(0), (b, args.prompt_len), 0, cfg.vocab
    )
    params = model.init(jax.random.PRNGKey(1), toks[:, :8])

    if args.paged:
        caches = model.init_paged_caches(
            b, args.max_len, page_size=args.page_size, bits=args.bits
        )
    else:
        caches = model.init_caches(b, args.max_len, bits=args.bits)
    lengths = jnp.zeros((b,), jnp.int32)

    prefill = jax.jit(
        lambda p, t, c, ln: model.apply(p, t, caches=c, lengths=ln)
    )
    decode = jax.jit(
        lambda p, t, c, ln: model.apply(
            p, t, caches=c, lengths=ln, decode=True
        )
    )

    t0 = time.time()
    if args.chunked_prefill:
        n = args.chunked_prefill
        assert args.prompt_len % n == 0, (args.prompt_len, n)
        for i in range(0, args.prompt_len, n):
            logits, caches = decode(
                params, toks[:, i:i + n], caches, lengths
            )
            lengths = lengths + n
        mode = f"chunked ({n}-token extend blocks)"
    else:
        logits, caches = prefill(params, toks, caches, lengths)
        lengths = lengths + args.prompt_len
        mode = "one-shot"
    cur = jnp.argmax(logits[:, -1:], axis=-1)
    cur.block_until_ready()
    print(f"prefill {args.prompt_len} tokens ({mode}): "
          f"{time.time()-t0:.2f}s (includes compile)")

    kind = (f"paged int{args.bits} cache, {args.page_size}-token pages"
            if args.paged else f"int{args.bits} KV cache")
    if args.speculate:
        from sageattention_jax.speculative import speculative_verify

        # the demo records one token stream; per-batch acceptance
        # counts would need per-batch bookkeeping
        assert b == 1, "--speculate demo supports --batch 1"
        K = args.speculate
        out, accepted, rounds = [cur], 0, 0
        t0 = time.time()
        while len(out) - 1 < args.gen:
            # draft K tokens on a throwaway copy (caches are immutable
            # pytrees — the "copy" is free)
            dcaches, dlen, dcur = caches, lengths, cur
            drafts = []
            for _ in range(K):
                dl, dcaches = decode(params, dcur, dcaches, dlen)
                dlen = dlen + 1
                dcur = jnp.argmax(dl[:, -1:], axis=-1)
                drafts.append(dcur)
            block = jnp.concatenate([cur] + drafts, axis=1)  # [b, K+1]
            # ONE extend step verifies the whole draft (and appends it;
            # rollback below is just the lengths arithmetic)
            logits, caches = decode(params, block, caches, lengths)
            n_acc, nxt = speculative_verify(
                jnp.concatenate(drafts, axis=1), logits
            )
            na = int(n_acc[0])
            out.extend(drafts[:na] + [nxt[:, None]])
            accepted += na
            rounds += 1
            lengths = lengths + 1 + na      # roll back the rejected tail
            cur = nxt[:, None]
            if rounds == 1:
                cur.block_until_ready()
                t0 = time.time()   # exclude the two jit compiles
                warm = len(out)    # timed tokens start here
        cur.block_until_ready()
        dt = time.time() - t0
        n = len(out) - warm
        print(f"decode: {n} tokens (post-compile) in {dt:.3f}s, "
              f"speculative K={K}: {accepted}/{rounds * K} drafts "
              f"accepted ({kind}, context {int(lengths[0])})")
    else:
        out = [cur]
        t0 = time.time()
        for i in range(args.gen):
            logits, caches = decode(params, cur, caches, lengths)
            lengths = lengths + 1
            cur = jnp.argmax(logits[:, -1:], axis=-1)
            out.append(cur)
            if i == 0:
                cur.block_until_ready()
                t0 = time.time()  # restart after the decode compile
        cur.block_until_ready()
        dt = time.time() - t0
        n = args.gen - 1
        print(f"decode: {n} tokens in {dt:.3f}s = "
              f"{n * b / max(dt, 1e-9):.1f} tok/s "
              f"({kind}, context {int(lengths[0])})")
    print("generated token ids:", [int(t[0, 0]) for t in out][:16], "...")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Sequence/tensor-parallel serving: one attention layer's KV cache
sharded over a device mesh (parallel/decode.py).

Long-context serving exhausts one card's HBM long before its FLOPs —
this demo shards the int8 (or ``--bits 4``) cache over a TP x SP mesh:
each device holds 1/(tp*sp) of the cache, decodes its shard, and one
exact LSE merge combines the partials.  Appends route to the owning
shard bit-exactly, so the loop below produces the same numbers a single
giant-memory card would.

It runs on the GPUs JAX finds; ``--cpu`` rehearses it on a virtual mesh
of tp*sp CPU devices.

Usage: python examples/sharded_serving.py [--tp 2] [--sp 4]
       [--context 8192] [--gen 8] [--bits 4] [--window 1024]
       [--paged [--page_size 256]]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tp", type=int, default=2,
                    help="tensor-parallel degree (kv-head sharding)")
    ap.add_argument("--sp", type=int, default=4,
                    help="sequence-parallel degree (cache sharding)")
    ap.add_argument("--context", type=int, default=8192)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--bits", type=int, default=8, choices=(8, 4))
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--paged", action="store_true",
                    help="shard a vLLM-style paged pool instead of the "
                         "dense cache (scrambled physical pages; each "
                         "device owns a block of pages and reads only "
                         "those)")
    ap.add_argument("--page_size", type=int, default=256)
    ap.add_argument("--cpu", action="store_true",
                    help="run on a virtual mesh of tp*sp CPU devices")
    args = ap.parse_args()
    n = args.tp * args.sp

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n}"
        ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    import jax.numpy as jnp
    import numpy as np

    assert len(jax.devices()) >= n, (len(jax.devices()), n)
    devs = np.array(jax.devices()[:n]).reshape(args.tp, args.sp)
    mesh = jax.sharding.Mesh(devs, ("tp", "sp"))

    import sageattention_jax as sa
    from sageattention_jax import parallel

    b, hq, hkv, d = 1, 8, 4, 128
    assert hkv % args.tp == 0 and args.context % args.sp == 0
    rng = lambda i, sh: jax.random.normal(
        jax.random.PRNGKey(i), sh, jnp.bfloat16
    )

    prompt_len = args.context - args.gen
    if args.paged:
        # the page-granular bulk loader wants whole pages; the tail of
        # the prompt would arrive via append in a real serving loop
        prompt_len = prompt_len // args.page_size * args.page_size
    k = rng(1, (b, hkv, prompt_len, d))
    v = rng(2, (b, hkv, prompt_len, d))

    if args.paged:
        page = args.page_size
        assert args.context % page == 0
        n_pg = b * (args.context // page)
        assert n_pg % args.sp == 0
        # scrambled physical pages: the stress case for the gather
        table = jax.random.permutation(
            jax.random.PRNGKey(42), n_pg
        ).reshape(b, -1).astype(jnp.int32)
        cache = sa.init_paged_kv_cache(
            n_pg, hkv, d, table, page_size=page, bits=args.bits
        )
        if args.bits == 4:
            cache = sa.calibrate(cache, k, v)
        prefill = parallel.make_sharded_paged_append(
            mesh, axis="sp", head_axis="tp", prefill=True
        )
        append = parallel.make_sharded_paged_append(
            mesh, axis="sp", head_axis="tp"
        )
        decode = parallel.make_sharded_paged_decode(
            mesh, axis="sp", head_axis="tp", window=args.window,
        )
        cache, lengths = prefill(
            cache, jnp.zeros((b,), jnp.int32), k, v
        )
        nbytes = 2 * cache.pages_k.size * args.bits / 8
        kind = f"paged int{args.bits}, {page}-token pages"
    else:
        cache = sa.init_kv_cache(
            b, hkv, args.context, d, bits=args.bits
        )
        if args.bits == 4:
            cache = sa.calibrate(cache, k, v)
        append = parallel.make_sharded_append(
            mesh, axis="sp", head_axis="tp"
        )
        decode = parallel.make_sharded_decode(
            mesh, axis="sp", head_axis="tp", window=args.window,
        )
        lengths = jnp.zeros((b,), jnp.int32)
        cache, lengths = append(cache, lengths, k, v)
        nbytes = 2 * cache.k_i8.size * args.bits / 8
        kind = f"int{args.bits}"
    print(f"prefilled {int(lengths[0])} tokens into a "
          f"{args.tp}x{args.sp} mesh "
          f"({nbytes / n / 2**20:.1f} MiB cache/device, {kind})")

    if args.gen < 1:
        print("nothing to decode (--gen 0)")
        return
    t0 = time.time()
    for step in range(args.gen):
        q = rng(100 + step, (b, hq, 1, d))
        k_new = rng(200 + step, (b, hkv, 1, d))
        v_new = rng(300 + step, (b, hkv, 1, d))
        cache, lengths = append(cache, lengths, k_new, v_new)
        o = decode(q, cache, lengths)
    o.block_until_ready()
    dt = time.time() - t0
    w = f", window={args.window}" if args.window else ""
    print(f"decoded {args.gen} steps at context {int(lengths[0])}{w}: "
          f"{dt / args.gen * 1e3:.1f} ms/step (virtual-mesh timing is "
          f"mechanics, not perf)")
    print("output head norm:",
          float(jnp.linalg.norm(o.astype(jnp.float32))))


if __name__ == "__main__":
    main()

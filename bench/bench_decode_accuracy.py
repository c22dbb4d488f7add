#!/usr/bin/env python
"""Decode-path accuracy sweep: cache storage width x calibration x
input distribution, against the fp32 softmax oracle.

The serving analogue of bench_accuracy.py: quantifies what the int8 /
packed-int4 KV cache (and the free ``calibrate`` channel-mean
correction) cost in decode output accuracy — the evidence behind the
bits=4 guidance in the README.

Usage: python bench/bench_decode_accuracy.py [--seq 2048]
       [--head_dim 128] [--group 4]
"""

import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp
import numpy as np

from sageattention_jax import kvcache


def make_kv(dist, b, hkv, s, d):
    k = jax.random.normal(jax.random.PRNGKey(1), (b, hkv, s, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (b, hkv, s, d))
    if dist == "biased":
        # random per-channel means (the transformer activation regime);
        # a smooth ramp would just dominate the output norm and hide
        # quantization error from the cosine metric
        k = k + 4.0 * jax.random.normal(
            jax.random.PRNGKey(7), (1, hkv, 1, d)
        )
        v = v + 4.0 * jax.random.normal(
            jax.random.PRNGKey(8), (1, hkv, 1, d)
        )
    elif dist == "outlier":
        spikes = (jnp.arange(d) % 37 == 0).astype(jnp.float32) * 8.0
        k = k + spikes[None, None, None, :]
        v = v * (1.0 + spikes[None, None, None, :])
    return k, v


def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--head_dim", type=int, default=128)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--kv_heads", type=int, default=2)
    args = ap.parse_args()
    b, hkv, s, d = 2, args.kv_heads, args.seq, args.head_dim
    hq = hkv * args.group

    q = jax.random.normal(jax.random.PRNGKey(0), (b, hq, 1, d))
    print(f"decode accuracy vs fp32 oracle  (b={b} hq={hq} hkv={hkv} "
          f"s={s} d={d})")
    print(f"{'dist':>8} {'bits':>5} {'calib':>6} {'cosine':>10}"
          f" {'rel-l2':>9}")
    for dist in ("normal", "biased", "outlier"):
        k, v = make_kv(dist, b, hkv, s, d)
        kr = jnp.repeat(k, args.group, axis=1).astype(jnp.float32)
        vr = jnp.repeat(v, args.group, axis=1).astype(jnp.float32)
        sc = jnp.einsum(
            "bhqd,bhkd->bhqk", q.astype(jnp.float32), kr
        ) * d**-0.5
        ref = jnp.einsum(
            "bhqk,bhkd->bhqd", jax.nn.softmax(sc, -1), vr
        )
        for bits in (8, 4):
            for calib in (False, True):
                cache = kvcache.init_kv_cache(b, hkv, s, d, bits=bits)
                if calib:
                    cache = kvcache.calibrate(cache, k, v)
                cache, lengths = kvcache.append_kv(
                    cache, jnp.zeros((b,), jnp.int32), k, v
                )
                o = kvcache.sageattn_decode(q, cache, lengths)
                rel = float(
                    np.linalg.norm(
                        np.asarray(o, np.float64) -
                        np.asarray(ref, np.float64)
                    ) / np.linalg.norm(np.asarray(ref, np.float64))
                )
                print(f"{dist:>8} {bits:>5} {str(calib):>6} "
                      f"{cosine(o, ref):>10.6f} {rel:>9.4f}",
                      flush=True)


if __name__ == "__main__":
    main()

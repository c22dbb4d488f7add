#!/usr/bin/env python
"""Accuracy sweep: every quantization config vs exact fp32 attention
(the runnable form of the reference's dumped-tensor diff workflow,
reference: utils/count.py / count_per_row.py and bench/README.md's
"lossless" claims).

Prints a table of cosine similarity, rel-err rate @0.002, and worst-row
cosine for each configuration on CogVideoX-shaped inputs.

Usage: python bench/bench_accuracy.py [--seq 1024] [--head_dim 64]
       [--dist normal|biased|outlier]
"""

import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from sageattention_jax import baselines, sageattn
from sageattention_jax.ops import reference
from sageattention_jax.utils.compare import compare_report

CONFIGS = [
    ("int8 default (smooth_k)", dict()),
    ("int8 + smooth_q", dict(smooth_q=True)),
    ("int8 + smooth_v", dict(smooth_v=True)),
    ("int8 no smoothing", dict(smooth_k=False)),
    ("bf16 PV", dict(pv_dtype="bf16")),
    ("fp8 PV", dict(pv_dtype="fp8")),
    ("per-token gran", dict(qk_quant_gran="per_token")),
    ("per-subtile gran", dict(qk_quant_gran="per_subtile")),
    ("per-block gran", dict(qk_quant_gran="per_block")),
    ("int4 QK", dict(qk_bits=4)),
    ("int4 QK + smooth_q", dict(qk_bits=4, smooth_q=True)),
]


def make_inputs(dist, b, h, s, d):
    q = jax.random.normal(jax.random.PRNGKey(0), (b, h, s, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (b, h, s, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (b, h, s, d))
    if dist == "biased":
        # strong channel means on Q and K (the smoothing-relevant regime)
        q = q + jnp.linspace(-5, 5, d)[None, None, None, :]
        k = k + jnp.linspace(3, -3, d)[None, None, None, :]
    elif dist == "outlier":
        spikes = (
            jax.random.bernoulli(jax.random.PRNGKey(3), 0.001, k.shape) * 30
        )
        k = k + spikes
        v = v + spikes
    elif dist == "outlier_channel":
        # a few K channels with 20x variance: mean-smoothing cannot remove
        # them, so they stress the coarse per-chunk K scales directly
        chans = jnp.zeros((d,)).at[jnp.array([3, 37, 101 % d])].set(1.0)
        k = k * (1.0 + 19.0 * chans)[None, None, None, :]
    elif dist == "spread":
        # attention-logit-growth pathology: a late run of keys aligned
        # with every query at large magnitude, planting a within-block
        # base-2 logit spread of ~80 against the early keys
        q = q.at[:, :, :, 0].set(jnp.abs(q[:, :, :, 0]) + 1.0)
        hot = 80.0 / 1.4426950408889634 * d**0.5 / 2.0
        k = k.at[:, :, -max(8, s // 64):, 0].set(hot)
    return (
        q.astype(jnp.bfloat16),
        k.astype(jnp.bfloat16),
        v.astype(jnp.bfloat16),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head_dim", type=int, default=64)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--dist", default="normal",
                    choices=["normal", "biased", "outlier"])
    args = ap.parse_args()

    q, k, v = make_inputs(
        args.dist, args.batch, args.heads, args.seq, args.head_dim
    )
    ref = reference.attention_reference(
        q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32),
        is_causal=args.causal,
    )

    print(f"# accuracy vs fp32 SDPA  dist={args.dist} causal={args.causal} "
          f"b={args.batch} h={args.heads} s={args.seq} hd={args.head_dim}")
    print(f"{'config':26s} {'cosine':>10s} {'relerr@2e-3':>12s} "
          f"{'worst row':>10s} {'maxabs':>8s}")
    rows = []
    for name, kw in CONFIGS:
        o = sageattn(q, k, v, is_causal=args.causal, **kw)
        r = compare_report(o, ref, name=name)
        rows.append(r)
        print(f"{name:26s} {r['cosine']:10.6f} {r['rel_err_rate']:12.4f} "
              f"{r['worst_row_cosine']:10.6f} {r['max_abs_err']:8.4f}",
              flush=True)
    # the coarse per-tensor baseline the reference's fa3_fp8 represents
    o = baselines.int8_pertensor(q, k, v, is_causal=args.causal)
    r = compare_report(o, ref, name="per-tensor int8 (strawman)")
    print(f"{'per-tensor int8 strawman':26s} {r['cosine']:10.6f} "
          f"{r['rel_err_rate']:12.4f} {r['worst_row_cosine']:10.6f} "
          f"{r['max_abs_err']:8.4f}")


if __name__ == "__main__":
    main()

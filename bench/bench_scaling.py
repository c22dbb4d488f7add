#!/usr/bin/env python
"""Sequence-parallel scaling benchmark.

Measures ring-KV / Ulysses / composed attention over an N-device mesh
against the single-device kernel on the same *global* problem:

    efficiency = t_single / (t_parallel * n_devices_used_for_seq)

On the cards of one host this is the scaling number; on a CPU host it
runs on virtual devices (SAGE_CPU_DEVICES=8) and validates mechanics
only — CPU wall times are not a device metric.

Usage:
  python bench/bench_scaling.py --seq 8192 --ring 4          # ring CP
  python bench/bench_scaling.py --seq 8192 --ulysses 4       # head a2a
  SAGE_CPU_DEVICES=8 python bench/bench_scaling.py ...       # CPU mesh
"""

import argparse
import os
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

if os.environ.get("SAGE_CPU_DEVICES"):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count="
        f"{os.environ['SAGE_CPU_DEVICES']}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp

from bench.utils import attention_flops, time_ms
from sageattention_jax import sageattn
from sageattention_jax.parallel import make_mesh, make_parallel_sageattn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head_dim", type=int, default=128)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--ring", type=int, default=1)
    ap.add_argument("--ulysses", type=int, default=1)
    ap.add_argument("--causal", action="store_true")
    args = ap.parse_args()

    n_sp = args.ring * args.ulysses
    if n_sp > len(jax.devices()):
        raise SystemExit(
            f"need {n_sp} devices for ring {args.ring} x ulysses "
            f"{args.ulysses}, have {len(jax.devices())}"
        )
    b, h, s, d = args.batch, args.heads, args.seq, args.head_dim
    q = jax.random.normal(jax.random.PRNGKey(0), (b, h, s, d), jnp.bfloat16)
    k = jax.random.normal(jax.random.PRNGKey(1), (b, h, s, d), jnp.bfloat16)
    v = jax.random.normal(jax.random.PRNGKey(2), (b, h, s, d), jnp.bfloat16)
    fl = attention_flops(b, h, s, d, args.causal)

    # single device, global problem
    t1 = time_ms(jax.jit(lambda q, k, v: sageattn(
        q, k, v, is_causal=args.causal)), q, k, v, n=5) * 1e-3
    print(f"single device: {t1*1e3:8.3f} ms  ({fl/t1/1e12:6.1f} TOPS)",
          flush=True)

    mesh = make_mesh(
        data=1, seq=args.ring, heads=args.ulysses,
        devices=jax.devices()[:n_sp],
    )
    fp = make_parallel_sageattn(
        mesh, data_axis=None, is_causal=args.causal
    )

    tp = time_ms(fp, q, k, v, n=5) * 1e-3
    eff = t1 / (tp * n_sp)
    print(f"ring={args.ring} ulysses={args.ulysses} over {n_sp} devices: "
          f"{tp*1e3:8.3f} ms  scaling efficiency {eff*100:5.1f}%",
          flush=True)
    if jax.default_backend() == "cpu":
        print("(CPU virtual mesh: mechanics-only; efficiency numbers are "
              "not meaningful)")


if __name__ == "__main__":
    main()

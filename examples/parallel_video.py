#!/usr/bin/env python
"""Multi-chip video DiT inference: DP/CFG x ring x Ulysses sage attention
(reference: example/parallel_sageattn_cogvideo.py + run_parallel.sh).

Where the reference launches xDiT under torchrun with --ulysses_degree /
--ring_degree / --use_cfg_parallel, here the degrees are axes of one JAX
device mesh and the model's attention runs through the in-repo
``sage_parallel`` backend (shard_map: ppermute KV ring + head all-to-all +
batch-sharded data/CFG axis).

It runs on the GPUs JAX finds.  To rehearse on a CPU host, ask for a
virtual mesh of N CPU devices with SAGE_CPU_DEVICES=N:
  SAGE_CPU_DEVICES=8 python examples/parallel_video.py \\
      --ring_degree 2 --ulysses_degree 2 --cfg_parallel
"""

import argparse
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

# virtual CPU mesh, only when asked for: set before JAX's backends start
if os.environ.get("SAGE_CPU_DEVICES"):
    _n = os.environ["SAGE_CPU_DEVICES"]
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={_n}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from examples.common import scaled_config
from sageattention_jax.models.configs import MODEL_CONFIGS
from sageattention_jax import models
from sageattention_jax.parallel import make_mesh


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--model", default="cogvideox-2b",
        choices=[
            n for n, c in MODEL_CONFIGS.items() if hasattr(c, "patch")
        ],  # video DiTs only (LLM configs have their own examples)
    )
    ap.add_argument("--ring_degree", type=int, default=2,
                    help="KV-ring (context parallel) degree "
                    "(reference: run_parallel.sh --ring_degree)")
    ap.add_argument("--ulysses_degree", type=int, default=1,
                    help="head all-to-all degree "
                    "(reference: --ulysses_degree)")
    ap.add_argument("--cfg_parallel", action="store_true",
                    help="shard the CFG pair over the data axis "
                    "(reference: --use_cfg_parallel)")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--smoke", action="store_true",
                    help="shrink hidden/heads too (CPU-mesh validation: "
                    "the virtual-device backend enforces a hard 40 s "
                    "collective timeout, so full-width layers can abort "
                    "under host load)")
    args = ap.parse_args()

    n_dev = len(jax.devices())
    data = 2 if args.cfg_parallel else 1
    need = data * args.ring_degree * args.ulysses_degree
    if need > n_dev:
        raise SystemExit(
            f"need {need} devices (data {data} x ring {args.ring_degree} x "
            f"ulysses {args.ulysses_degree}), have {n_dev}"
        )
    mesh = make_mesh(
        data=data, seq=args.ring_degree, heads=args.ulysses_degree,
        devices=jax.devices()[:need],
    )
    print(f"mesh: data={data} ring={args.ring_degree} "
          f"ulysses={args.ulysses_degree} over {need} devices")

    cfg = scaled_config(args.model, args.scale)
    if args.smoke:
        cfg = cfg.scaled(hidden=256, heads=4, head_dim=64)
    # head count must divide by the ulysses degree and the sequence by the
    # total sequence-parallel degree (the reference validates the same,
    # reference: parallel_sageattn_cogvideo.py:32-36); pad the text length
    # to align the sequence.
    if cfg.heads % max(args.ulysses_degree, 1):
        raise SystemExit(
            f"heads ({cfg.heads}) must be divisible by ulysses degree"
        )
    sp = args.ring_degree * args.ulysses_degree
    if cfg.seq_len % sp:
        cfg = cfg.scaled(text_len=cfg.text_len + (-cfg.seq_len) % sp)
    models.set_mesh(mesh)
    models.set_attention_backend("sage_parallel")
    model = models.VideoDiT(cfg)

    # CFG = 2 prompt branches in the batch (sharded over "data" when
    # cfg_parallel; the reference's cfg_degree=2, run_parallel.sh:40-42)
    b = 2
    lat = jax.random.normal(
        jax.random.PRNGKey(0),
        (b, cfg.latent_frames, cfg.latent_height, cfg.latent_width, 16),
        jnp.bfloat16,
    )
    txt = jax.random.normal(
        jax.random.PRNGKey(1), (b, cfg.text_len, 512), jnp.bfloat16
    )
    params = model.init(jax.random.PRNGKey(2), lat, txt, jnp.array([999] * b))
    params = jax.device_put(params, NamedSharding(mesh, P()))
    lat, txt = (
        jax.device_put(x, NamedSharding(mesh, P("data")))
        for x in (lat, txt)
    )

    @jax.jit
    def denoise_step(params, lat, txt, t):
        eps = model.apply(params, lat, txt, t)
        return lat - (1.0 / 50) * eps.astype(lat.dtype)

    def sync(x):
        _ = np.asarray(jax.tree.leaves(x)[0].ravel()[0])

    t0 = time.time()
    lat = denoise_step(params, lat, txt, jnp.array([999] * b))
    sync(lat)
    print(f"compile+first step: {time.time()-t0:.2f} s (seq {cfg.seq_len})")

    t0 = time.time()
    for i in range(args.steps):
        lat = denoise_step(params, lat, txt, jnp.array([500] * b))
    sync(lat)
    print(f"avg parallel denoise step: "
          f"{(time.time()-t0)/args.steps*1e3:.1f} ms")

    models.set_attention_backend("sage")
    models.set_mesh(None)


if __name__ == "__main__":
    main()

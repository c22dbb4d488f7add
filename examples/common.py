"""Shared example runner (reference: example/cogvideox-2b.py structure —
model load, attention backend switch, timed denoise loop, wall-clock and
peak-memory report, reference: parallel_sageattn_cogvideo.py:70-108).

The reference runs real diffusers pipelines off HuggingFace weights; this
environment has no weight downloads, so the examples run the in-repo
natively-implemented model families (sageattention_jax.models) at the real
model geometry (or ``--scale`` reduced) with randomly initialized weights —
the attention workload, shapes, and backend switching are identical to the
reference's usage; only the weights differ.
"""

from __future__ import annotations

import argparse
import os
import time

import jax
import jax.numpy as jnp

from sageattention_jax import models
from sageattention_jax.models.configs import MODEL_CONFIGS
from sageattention_jax.utils.compare import cosine_similarity


def use_compile_cache() -> None:
    """Keep JAX's compile cache where $JAX_COMPILATION_CACHE_DIR says, or
    else in the fixed <repo>/.jax_cache (git-ignored)."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(repo, ".jax_cache"))


def base_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument(
        "--attention_type",
        default="sage",
        choices=["sage", "sage_bf16", "sage_fp8", "sdpa", "flash", "reference"],
        help="attention backend (reference: example/cogvideox-2b.py:13-23 "
        "attention_type in {sdpa, sage, fa3, fa3_fp8})",
    )
    ap.add_argument("--steps", type=int, default=4,
                    help="denoise steps to run (timed)")
    ap.add_argument("--scale", type=float, default=0.25,
                    help="geometry scale for smoke runs; 1.0 = full model")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--compare", action="store_true",
                    help="also run the flash (cuDNN) backend on a GPU, sdpa "
                         "elsewhere, and report output parity")
    ap.add_argument("--profile", default=None,
                    help="write a jax.profiler trace to this directory")
    return ap


def scaled_config(name: str, scale: float):
    cfg = MODEL_CONFIGS[name]
    if scale >= 1.0:
        return cfg
    def s(x, q=1):
        return max(q, int(x * scale) // q * q)
    pt = getattr(cfg, "patch_t", 1)
    return cfg.scaled(
        depth=max(2, int(cfg.depth * scale)),
        # frames stay a multiple of the temporal patch
        latent_frames=max(2, s(cfg.latent_frames, pt)),
        latent_height=s(cfg.latent_height, 2),
        latent_width=s(cfg.latent_width, 2),
        text_len=max(16, int(cfg.text_len * scale)),
    )


def run_video_example(name: str, args, model_cls=None) -> None:
    use_compile_cache()
    cfg = scaled_config(name, args.scale)
    model_cls = model_cls or models.VideoDiT
    print(f"model={name} ({model_cls.__name__}) seq_len={cfg.seq_len} "
          f"heads={cfg.heads} head_dim={cfg.head_dim} depth={cfg.depth} "
          f"backend={args.attention_type}")
    models.set_attention_backend(args.attention_type)
    model = model_cls(cfg)

    b = args.batch
    lat = jax.random.normal(
        jax.random.PRNGKey(0),
        (b, cfg.latent_frames, cfg.latent_height, cfg.latent_width, 16),
        jnp.bfloat16,
    )
    txt = jax.random.normal(
        jax.random.PRNGKey(1), (b, cfg.text_len, 512), jnp.bfloat16
    )
    params = model.init(jax.random.PRNGKey(2), lat, txt, jnp.array([999]))

    @jax.jit
    def denoise_step(params, lat, txt, t):
        """One Euler step of the (mock) flow: x <- x - dt * eps(x, t)."""
        eps = model.apply(params, lat, txt, t)
        return lat - (1.0 / 50) * eps.astype(lat.dtype)

    sync = jax.block_until_ready

    # warm (compile)
    t0 = time.time()
    lat = denoise_step(params, lat, txt, jnp.array([999] * b))
    sync(lat)
    print(f"compile+first step: {time.time()-t0:.2f} s")

    if args.profile:
        from sageattention_jax.utils.profiling import trace

        with trace(args.profile):
            lat = denoise_step(params, lat, txt, jnp.array([500] * b))
            sync(lat)
        print(f"profile written to {args.profile}")

    t0 = time.time()
    for i in range(args.steps):
        t = jnp.array([999 - i * (999 // max(args.steps, 1))] * b)
        lat = denoise_step(params, lat, txt, t)
    sync(lat)
    if args.steps > 0:
        dt = (time.time() - t0) / args.steps
        print(f"avg denoise step: {dt*1e3:.1f} ms "
              f"({args.steps} steps, seq {cfg.seq_len})")

    if args.compare:
        # XLA's sdpa materializes the [b, h, s, s] scores (38 GB at
        # CogVideoX's 17776): compare against cuDNN on a GPU
        ref = "flash" if jax.default_backend() == "gpu" else "sdpa"
        models.set_attention_backend(ref)
        eps_ref = model.apply(params, lat, txt, jnp.array([500] * b))
        models.set_attention_backend(args.attention_type)
        eps = model.apply(params, lat, txt, jnp.array([500] * b))
        print(f"output parity vs {ref}: cosine="
              f"{cosine_similarity(eps, eps_ref):.6f}")

    stats = jax.local_devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        print(f"peak device memory: "
              f"{stats['peak_bytes_in_use']/2**30:.2f} GiB")

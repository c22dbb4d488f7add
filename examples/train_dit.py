#!/usr/bin/env python
"""Training loop: diffusion (flow-matching) training of the video DiT
with sage attention end-to-end — the quantized forward AND the
straight-through blockwise backward (ops/blockwise.py).

The reference is inference-only; training is this framework's
beyond-reference axis: `jax.grad` through `sageattn` runs the custom
VJP.  This loop demonstrates the whole story: optax AdamW, jitted train
step, loss going down, optional multi-device data parallelism.

Checkpoint/resume (the reference has no persistence at all — SURVEY §5):
`--ckpt_dir` saves params/opt_state with ``utils.checkpoint`` (numpy
.npz) every `--ckpt_every` steps and resumes from the latest checkpoint
on restart, so a preempted job continues where it stopped.

Usage: python examples/train_dit.py [--steps 20] [--scale 0.1]
       [--attention_type sage] [--dp N] [--lr 1e-4]
       [--ckpt_dir /tmp/dit_ckpt --ckpt_every 5]
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from examples.common import base_parser, scaled_config

import jax
import jax.numpy as jnp
import optax

from sageattention_jax import models
from sageattention_jax.utils import checkpoint


def main():
    ap = base_parser("train a CogVideoX-shaped DiT with sage attention")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel degree (devices); gradients "
                         "psum over the mesh")
    ap.add_argument("--ckpt_dir", default=None,
                    help="checkpoint directory; resumes from the "
                         "latest step if one exists")
    ap.add_argument("--ckpt_every", type=int, default=5,
                    help="save a checkpoint every N steps")
    args = ap.parse_args()
    assert args.steps >= 2, "need >= 2 steps to check the loss trend"

    models.set_attention_backend(args.attention_type)
    # small smoke geometry by default; --scale 1.0 trains the real shape
    cfg = scaled_config("cogvideox-2b", args.scale)
    model = models.VideoDiT(cfg)

    b = max(1, args.dp)
    rng = jax.random.PRNGKey(0)
    lat_shape = (b, cfg.latent_frames, cfg.latent_height,
                 cfg.latent_width, model.latent_channels)
    lat = jax.random.normal(rng, lat_shape, jnp.bfloat16)
    txt = jax.random.normal(
        jax.random.PRNGKey(1), (b, cfg.text_len, 512), jnp.bfloat16
    )
    params = model.init(jax.random.PRNGKey(2), lat, txt,
                        jnp.zeros((b,), jnp.int32))
    n_params = sum(x.size for x in jax.tree.leaves(params))
    print(f"model: depth={cfg.depth} hidden={cfg.hidden} "
          f"heads={cfg.heads} seq={cfg.seq_len} "
          f"params={n_params/1e6:.1f}M attention={args.attention_type}")

    tx = optax.adamw(args.lr, weight_decay=0.01)
    opt_state = tx.init(params)

    # -- checkpoint/resume ---------------------------------------------
    start = 0
    latest = checkpoint.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if latest is not None:
        restored = checkpoint.restore(
            args.ckpt_dir, latest, {"params": params, "opt_state": opt_state}
        )
        params, opt_state = restored["params"], restored["opt_state"]
        start = latest + 1
        print(f"resumed from {args.ckpt_dir} at step {latest}")

    def loss_fn(params, x0, txt, key):
        """Rectified-flow matching: x_t = (1-t) x0 + t eps, the model
        regresses the velocity (eps - x0)."""
        kt, ke = jax.random.split(key)
        t = jax.random.uniform(kt, (x0.shape[0],))
        eps = jax.random.normal(ke, x0.shape, jnp.float32)
        tb = t[:, None, None, None, None].astype(jnp.float32)
        x_t = ((1 - tb) * x0.astype(jnp.float32) + tb * eps).astype(
            x0.dtype
        )
        pred = model.apply(
            params, x_t, txt, (t * 1000).astype(jnp.int32)
        )
        target = eps - x0.astype(jnp.float32)
        return jnp.mean(
            (pred.astype(jnp.float32) - target) ** 2
        )

    def train_step(params, opt_state, x0, txt, key, axis=None):
        if axis is not None:
            # the key enters replicated (in_specs P()): decorrelate the
            # shards or every DP replica draws the same (t, eps) sample
            key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        loss, grads = jax.value_and_grad(loss_fn)(params, x0, txt, key)
        if axis is not None:
            grads = jax.lax.pmean(grads, axis)
            loss = jax.lax.pmean(loss, axis)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    if args.dp > 1:
        import functools

        from jax.sharding import PartitionSpec as P

        mesh = jax.sharding.Mesh(
            jax.devices()[: args.dp], ("data",)
        )
        step = jax.jit(jax.shard_map(
            functools.partial(train_step, axis="data"),
            mesh=mesh,
            in_specs=(P(), P(), P("data"), P("data"), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        ))
    else:
        step = jax.jit(train_step)

    if start >= args.steps:
        print(f"checkpoint already at step {start - 1}; nothing to do")
        return

    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        params, opt_state, loss = step(
            params, opt_state, lat, txt, jax.random.PRNGKey(100 + i)
        )
        losses.append(float(loss))
        if i == start:
            jax.block_until_ready(loss)
            print(f"step {start} (compile): {time.time()-t0:.1f}s "
                  f"loss {losses[0]:.4f}")
            t0 = time.time()
        if args.ckpt_dir and (
            (i + 1) % args.ckpt_every == 0 or i == args.steps - 1
        ):
            checkpoint.save(args.ckpt_dir, i,
                            {"params": params, "opt_state": opt_state})
    if args.ckpt_dir:
        print(f"checkpointed through step "
              f"{checkpoint.latest_step(args.ckpt_dir)} in {args.ckpt_dir}")
    jax.block_until_ready(loss)
    n = max(1, args.steps - 1 - start)
    print(f"steps {start + 1}..{args.steps - 1}: "
          f"{(time.time()-t0)/n*1e3:.0f} "
          f"ms/step, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if start == 0:
        assert losses[-1] < losses[0], "loss did not decrease"
        print("loss decreased OK (quantized fwd + blockwise bwd)")


if __name__ == "__main__":
    main()

"""Video DiT as a parameter pytree plus pure functions — the model family
the reference accelerates.

A CogVideoX-style joint text-video diffusion transformer (reference
integration: example/cogvideox-2b.py — the reference patches attention in
diffusers' CogVideoXTransformer3D; here the transformer is implemented
natively so every attention call goes through
``models.attention.attention`` and the backend switch applies).

Architecture (CogVideoX family): 3D patch embedding of video latents,
text tokens prepended, adaLN-zero conditioning from the timestep
embedding, joint self-attention over [text; video] tokens (non-causal),
GELU MLP, unpatchify head.  The blocks run under ``lax.scan`` over
depth-stacked parameters, so a 30-layer model compiles one block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sageattention_jax.models import layers as L
from sageattention_jax.models.attention import (
    SageAttnProcessor,
    attention as _attention,
)
from sageattention_jax.models.configs import DiTConfig


def init_trunk(kg: L.KeyGen, cfg: DiTConfig, latents, text_emb) -> dict:
    """Parameters of the shared DiT entry and exit: patch / position /
    text / timestep embeddings, final norm and unpatchify head."""
    c = latents.shape[-1]
    voxels = cfg.patch_t * cfg.patch * cfg.patch * c
    h = cfg.hidden
    return {
        "patch_embed": L.init_dense(kg(), voxels, h),
        "pos_embed": jax.random.normal(
            kg(), (1, cfg.video_tokens, h), jnp.float32
        ) * 0.02,
        "text_embed": L.init_dense(kg(), text_emb.shape[-1], h),
        "t_embed": {
            "dense_0": L.init_dense(kg(), 2 * (h // 8), h),
            "dense_1": L.init_dense(kg(), h, h),
        },
        "final_norm": L.init_norm(h),
        "unpatchify": L.init_dense(kg(), h, voxels),
    }


def embed_video_text(params, cfg: DiTConfig, dtype, latents, text_emb):
    """Shared DiT trunk entry: 3D patchify (pt*p*p*C voxels per token,
    pt = cfg.patch_t temporal patch — CogVideoX-1.5 style) +
    patch/positional embedding of video, linear embedding of text.
    Returns (xt, xv)."""
    b, F, H, W, C = latents.shape
    p, pt = cfg.patch, cfg.patch_t
    xv = latents.reshape(b, F // pt, pt, H // p, p, W // p, p, C)
    xv = jnp.transpose(xv, (0, 1, 3, 5, 2, 4, 6, 7)).reshape(
        b, (F // pt) * (H // p) * (W // p), pt * p * p * C
    )
    xv = L.dense(params["patch_embed"], xv, dtype)
    xv = xv + params["pos_embed"][:, : xv.shape[1]].astype(dtype)
    xt = L.dense(params["text_embed"], text_emb, dtype)
    return xt, xv


def timestep_embed(params, t, dim: int):
    half = dim // 8
    freqs = jnp.exp(
        -jnp.log(10000.0) * jnp.arange(half, dtype=jnp.float32) / half
    )
    ang = t.astype(jnp.float32)[:, None] * freqs[None, :]
    emb = jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)
    emb = jax.nn.silu(L.dense(params["dense_0"], emb, jnp.float32))
    return L.dense(params["dense_1"], emb, jnp.float32)


def finalize_video(params, xv, video_shape, p: int, pt: int = 1):
    """Shared DiT trunk exit: final norm + unpatchify projection back to
    the latent video shape.  Per-token ops, so callers may slice video
    tokens out of a joint sequence before or after equivalently."""
    b, F, H, W, C = video_shape
    xv = L.layer_norm(params["final_norm"], xv)
    out = L.dense(params["unpatchify"], xv, jnp.float32)
    out = out.reshape(b, F // pt, H // p, W // p, pt, p, p, C)
    return jnp.transpose(out, (0, 1, 4, 2, 5, 3, 6, 7)).reshape(
        b, F, H, W, C
    )


def attend(q, k, v, processor: SageAttnProcessor | None):
    """Non-causal attention through the processor or the global backend."""
    if processor is not None:
        return processor(q, k, v)
    return _attention(q, k, v, is_causal=False)


def _init_block(key, cfg: DiTConfig) -> dict:
    kg = L.KeyGen(key)
    h, inner = cfg.hidden, cfg.heads * cfg.head_dim
    mlp = int(h * cfg.mlp_ratio)
    return {
        "adaln": L.init_dense(kg(), h, 6 * h),
        "qkv": L.init_dense(kg(), h, 3 * inner),
        "q_norm": L.init_norm(cfg.head_dim),
        "k_norm": L.init_norm(cfg.head_dim),
        "out": L.init_dense(kg(), inner, h),
        "mlp_up": L.init_dense(kg(), h, mlp),
        "mlp_down": L.init_dense(kg(), mlp, h),
    }


def _block(p, x, cond, cfg: DiTConfig, processor):
    dt = x.dtype
    # adaLN-zero: 6 modulation vectors from the conditioning embedding
    mods = L.dense(p["adaln"], jax.nn.silu(cond), jnp.float32)
    sh1, sc1, g1, sh2, sc2, g2 = jnp.split(mods[:, None, :], 6, axis=-1)
    h = (L.layer_norm(None, x) * (1 + sc1) + sh1).astype(dt)
    q, k, v = (
        L.split_heads(t, cfg.heads, cfg.head_dim)
        for t in jnp.split(L.dense(p["qkv"], h, dt), 3, axis=-1)
    )
    # qk-norm (CogVideoX / Wan use it; also tames INT8 ranges)
    q = L.layer_norm(p["q_norm"], q, dt)
    k = L.layer_norm(p["k_norm"], k, dt)
    o = L.merge_heads(attend(q, k, v, processor))
    x = x + g1.astype(dt) * L.dense(p["out"], o, dt)
    h = (L.layer_norm(None, x) * (1 + sc2) + sh2).astype(dt)
    m = L.dense(p["mlp_down"], jax.nn.gelu(L.dense(p["mlp_up"], h, dt)), dt)
    return x + g2.astype(dt) * m


class VideoDiTBase:
    """``init(key, latents, text_emb, t)`` -> {"params": ...} over the
    shared trunk plus ``cfg.depth`` blocks of ``_init_block``, stacked
    for ``lax.scan``; subclasses define ``apply``."""

    _init_block = None

    def __init__(self, cfg: DiTConfig, latent_channels: int = 16,
                 dtype=jnp.bfloat16,
                 processor: SageAttnProcessor | None = None):
        self.cfg = cfg
        self.latent_channels = latent_channels
        self.dtype = dtype
        self.processor = processor

    def init(self, key, latents, text_emb, t) -> dict:
        del t
        kg = L.KeyGen(key)
        params = init_trunk(kg, self.cfg, latents, text_emb)
        init_block = type(self)._init_block
        params["blocks"] = L.stack_init(
            kg(), self.cfg.depth, lambda k: init_block(k, self.cfg)
        )
        return {"params": params}


class VideoDiT(VideoDiTBase):
    """Joint text-video diffusion transformer.

    ``apply(params, latents [b, F, H, W, C], text_emb [b, Lt, E], t [b])``
    -> predicted noise [b, F, H, W, C].
    """

    _init_block = staticmethod(_init_block)

    def apply(self, params, latents, text_emb, t):
        c, p = self.cfg, params["params"]
        xt, xv = embed_video_text(p, c, self.dtype, latents, text_emb)
        x = jnp.concatenate([xt, xv], axis=1)
        cond = timestep_embed(p["t_embed"], t, c.hidden)

        def body(x, bp):
            return _block(bp, x, cond, c, self.processor), None

        x, _ = jax.lax.scan(body, x, p["blocks"])
        # finalize_video's norm is per-token: slicing before == after
        return finalize_video(p, x[:, xt.shape[1]:], latents.shape, c.patch,
                              c.patch_t)

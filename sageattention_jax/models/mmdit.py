"""Dual-stream and cross-attention DiT variants.

The reference accelerates several distinct video-DiT architectures
(reference: example/):

* **Dual-stream MMDiT** (HunyuanVideo's dual-stream phase, Mochi-1's
  AsymmDiT): text and video tokens keep separate projection/MLP weights;
  attention is *joint* over the concatenated sequence (one softmax over
  [text; video]) — so a single sage-attention call still serves it
  (reference: example/mochi.py:11-50 installs the processor on exactly
  that joint attention).
* **Cross-attention DiT** (Wan2.1: self-attention over video tokens plus
  a separate cross-attention reading text; reference:
  example/modify_model/modify_wan.py:9-40 patches both call sites).
  Cross-attention has sq != sk — exercising the rectangular path.

Both route every attention through ``models.attention.attention`` so the
global backend switch and per-layer processors apply.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sageattention_jax.models import layers as L
from sageattention_jax.models.configs import DiTConfig
from sageattention_jax.models.dit import (
    VideoDiTBase,
    attend,
    embed_video_text,
    finalize_video,
    timestep_embed,
)


def _modulate(x, shift, scale):
    return (L.layer_norm(None, x) * (1 + scale) + shift).astype(x.dtype)


def _init_dual_block(key, cfg: DiTConfig) -> dict:
    kg = L.KeyGen(key)
    h, inner = cfg.hidden, cfg.heads * cfg.head_dim
    mlp = int(h * cfg.mlp_ratio)
    p = {
        "adaln": L.init_dense(kg(), h, 12 * h),
        "q_norm": L.init_norm(cfg.head_dim, bias=False),
        "k_norm": L.init_norm(cfg.head_dim, bias=False),
    }
    for s in ("text", "video"):
        p[f"qkv_{s}"] = L.init_dense(kg(), h, 3 * inner)
        p[f"out_{s}"] = L.init_dense(kg(), inner, h)
        p[f"mlp_{s}_up"] = L.init_dense(kg(), h, mlp)
        p[f"mlp_{s}_down"] = L.init_dense(kg(), mlp, h)
    return p


def _dual_block(p, xt, xv, cond, cfg: DiTConfig, processor):
    """One MMDiT block: separate text/video qkv+mlp weights, joint softmax
    (HunyuanVideo dual-stream / Mochi AsymmDiT structure)."""
    dt = xv.dtype
    mods = L.dense(p["adaln"], jax.nn.silu(cond), jnp.float32)[:, None, :]
    (tsh1, tsc1, tg1, tsh2, tsc2, tg2,
     vsh1, vsc1, vg1, vsh2, vsc2, vg2) = jnp.split(mods, 12, axis=-1)

    def heads(x):
        return L.split_heads(x, cfg.heads, cfg.head_dim)

    # separate projections per stream (the "dual-stream" part)
    qt, kt, vt = jnp.split(
        L.dense(p["qkv_text"], _modulate(xt, tsh1, tsc1), dt), 3, axis=-1
    )
    qv, kv, vv = jnp.split(
        L.dense(p["qkv_video"], _modulate(xv, vsh1, vsc1), dt), 3, axis=-1
    )
    q = jnp.concatenate([heads(qt), heads(qv)], axis=2)
    k = jnp.concatenate([heads(kt), heads(kv)], axis=2)
    v = jnp.concatenate([heads(vt), heads(vv)], axis=2)
    q = L.rms_norm(p["q_norm"], q, dt)
    k = L.rms_norm(p["k_norm"], k, dt)

    # ONE joint softmax over [text; video] — the call the reference's
    # processor intercepts (example/mochi.py:24-47)
    o = L.merge_heads(attend(q, k, v, processor))
    st = xt.shape[1]
    xt = xt + tg1.astype(dt) * L.dense(p["out_text"], o[:, :st], dt)
    xv = xv + vg1.astype(dt) * L.dense(p["out_video"], o[:, st:], dt)

    def mlp(x, name):
        up = L.dense(p[f"{name}_up"], x, dt)
        return L.dense(p[f"{name}_down"], jax.nn.gelu(up), dt)

    xt = xt + tg2.astype(dt) * mlp(_modulate(xt, tsh2, tsc2), "mlp_text")
    xv = xv + vg2.astype(dt) * mlp(_modulate(xv, vsh2, vsc2), "mlp_video")
    return xt, xv


def _init_cross_block(key, cfg: DiTConfig) -> dict:
    kg = L.KeyGen(key)
    h, inner = cfg.hidden, cfg.heads * cfg.head_dim
    mlp = int(h * cfg.mlp_ratio)
    return {
        "adaln": L.init_dense(kg(), h, 6 * h),
        "self_qkv": L.init_dense(kg(), h, 3 * inner),
        "q_norm": L.init_norm(cfg.head_dim, bias=False),
        "k_norm": L.init_norm(cfg.head_dim, bias=False),
        "self_out": L.init_dense(kg(), inner, h),
        "cross_q": L.init_dense(kg(), h, inner),
        "cross_k": L.init_dense(kg(), h, inner),
        "cross_v": L.init_dense(kg(), h, inner),
        "cross_q_norm": L.init_norm(cfg.head_dim, bias=False),
        "cross_k_norm": L.init_norm(cfg.head_dim, bias=False),
        "cross_out": L.init_dense(kg(), inner, h),
        "mlp_up": L.init_dense(kg(), h, mlp),
        "mlp_down": L.init_dense(kg(), mlp, h),
    }


def _cross_block(p, xv, text, cond, cfg: DiTConfig, processor):
    """Wan-style block: video self-attention + text cross-attention + MLP
    (reference: modify_wan.py patches WanAttnProcessor2_0 on both)."""
    dt = xv.dtype
    mods = L.dense(p["adaln"], jax.nn.silu(cond), jnp.float32)[:, None, :]
    sh1, sc1, g1, sh2, sc2, g2 = jnp.split(mods, 6, axis=-1)

    def heads(x):
        return L.split_heads(x, cfg.heads, cfg.head_dim)

    # self-attention over video tokens
    q, k, v = (heads(x) for x in jnp.split(
        L.dense(p["self_qkv"], _modulate(xv, sh1, sc1), dt), 3, axis=-1
    ))
    q = L.rms_norm(p["q_norm"], q, dt)
    k = L.rms_norm(p["k_norm"], k, dt)
    o = L.merge_heads(attend(q, k, v, processor))
    xv = xv + g1.astype(dt) * L.dense(p["self_out"], o, dt)

    # cross-attention: video queries, text keys/values (sq != sk), with
    # qk-norm as Wan2.1 applies it (tames INT8 ranges on outlier text
    # channels)
    h = L.layer_norm(None, xv).astype(dt)
    qc = L.rms_norm(p["cross_q_norm"], heads(L.dense(p["cross_q"], h, dt)), dt)
    kc = L.rms_norm(p["cross_k_norm"],
                    heads(L.dense(p["cross_k"], text, dt)), dt)
    vc = heads(L.dense(p["cross_v"], text, dt))
    o = L.merge_heads(attend(qc, kc, vc, processor))
    xv = xv + L.dense(p["cross_out"], o, dt)

    up = L.dense(p["mlp_up"], _modulate(xv, sh2, sc2), dt)
    return xv + g2.astype(dt) * L.dense(p["mlp_down"], jax.nn.gelu(up), dt)


class DualStreamVideoDiT(VideoDiTBase):
    """HunyuanVideo/Mochi-shaped dual-stream video DiT."""

    _init_block = staticmethod(_init_dual_block)

    def apply(self, params, latents, text_emb, t):
        c, p = self.cfg, params["params"]
        xt, xv = embed_video_text(p, c, self.dtype, latents, text_emb)
        cond = timestep_embed(p["t_embed"], t, c.hidden)

        def body(carry, bp):
            return _dual_block(bp, *carry, cond, c, self.processor), None

        (xt, xv), _ = jax.lax.scan(body, (xt, xv), p["blocks"])
        return finalize_video(p, xv, latents.shape, c.patch, c.patch_t)


class CrossAttnVideoDiT(VideoDiTBase):
    """Wan2.1-shaped video DiT (self-attn over video + text cross-attn)."""

    _init_block = staticmethod(_init_cross_block)

    def apply(self, params, latents, text_emb, t):
        c, p = self.cfg, params["params"]
        text, xv = embed_video_text(p, c, self.dtype, latents, text_emb)
        cond = timestep_embed(p["t_embed"], t, c.hidden)

        def body(xv, bp):
            return _cross_block(bp, xv, text, cond, c, self.processor), None

        xv, _ = jax.lax.scan(body, xv, p["blocks"])
        return finalize_video(p, xv, latents.shape, c.patch, c.patch_t)

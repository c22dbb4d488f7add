"""Layers as parameter pytrees plus pure functions (no module framework).

``init_<layer>(key, ...)`` returns the layer's parameters as a dict of
f32 arrays; ``<layer>(params, x, ...)`` applies them, computing in the
given dtype.  Models compose these into one nested dict and expose the
``Model(cfg).init(key, *inputs) -> {"params": ...}`` /
``.apply(params, *inputs)`` call shape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


class KeyGen:
    """Hands out fresh PRNG keys split from one seed key."""

    def __init__(self, key):
        self._key = key

    def __call__(self):
        self._key, sub = jax.random.split(self._key)
        return sub


def init_dense(key, n_in: int, n_out: int, bias: bool = True) -> dict:
    """LeCun-normal kernel [n_in, n_out], zero bias."""
    p = {"kernel": jax.random.normal(key, (n_in, n_out), jnp.float32)
         * n_in**-0.5}
    if bias:
        p["bias"] = jnp.zeros((n_out,), jnp.float32)
    return p


def dense(p: dict, x: jax.Array, dtype) -> jax.Array:
    y = jnp.dot(x.astype(dtype), p["kernel"].astype(dtype))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def init_norm(n: int, bias: bool = True) -> dict:
    p = {"scale": jnp.ones((n,), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((n,), jnp.float32)
    return p


def layer_norm(p: dict | None, x: jax.Array, dtype=jnp.float32,
               eps: float = 1e-6) -> jax.Array:
    """LayerNorm over the last axis in f32; ``p=None`` is the affine-free
    form adaLN modulates."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    if p is not None:
        y = y * p["scale"]
        if "bias" in p:
            y = y + p["bias"]
    return y.astype(dtype)


def rms_norm(p: dict, x: jax.Array, dtype=jnp.float32,
             eps: float = 1e-6) -> jax.Array:
    xf = x.astype(jnp.float32)
    y = xf * jax.lax.rsqrt(jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
                           + eps)
    return (y * p["scale"]).astype(dtype)


def split_heads(x: jax.Array, heads: int, head_dim: int) -> jax.Array:
    """[b, s, h * d] -> HND [b, h, s, d]."""
    b, s, _ = x.shape
    return jnp.swapaxes(x.reshape(b, s, heads, head_dim), 1, 2)


def merge_heads(x: jax.Array) -> jax.Array:
    """HND [b, h, s, d] -> [b, s, h * d]."""
    b, h, s, d = x.shape
    return jnp.swapaxes(x, 1, 2).reshape(b, s, h * d)


def stack_init(key, n: int, init_fn):
    """Parameters of ``n`` identical layers, stacked on a leading axis
    (for ``lax.scan`` over depth)."""
    return jax.vmap(init_fn)(jax.random.split(key, n))

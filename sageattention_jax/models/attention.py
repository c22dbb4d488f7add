"""Pluggable attention backend — the drop-in integration point.

The reference integrates with models two ways (reference: example/README.md
:8-13):

1. globally replacing ``F.scaled_dot_product_attention = sageattn``
   (reference: example/cogvideox-2b.py:16-23) — here,
   :func:`set_attention_backend` switches every model in this package;
2. injecting a per-layer attention processor (reference:
   example/modify_model/modify_wan.py:9-40, example/mochi.py:11-50) —
   here, :class:`SageAttnProcessor` instances passed to a module.

Backends:
  "sage"          — ``sageattn``: int8 Q·Kᵀ, bf16 P·V (the default)
  "sage_bf16"     — int8-QK / bf16-PV (explicit entry point)
  "sage_fp8"      — int8-QK / fp8-stored V
  "sage_parallel" — DP x ring x Ulysses over a bound mesh (``set_mesh``)
  "flash"         — cuDNN's bf16 fused attention (NVIDIA's library
                    kernel, GPU only; the bar)
  "sdpa"          — XLA dot-product attention
  "reference"     — exact fp32 oracle (tests)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

import sageattention_jax as sa
from sageattention_jax.ops import reference as ref_mod

_BACKENDS: dict[str, Callable] = {}
_CURRENT = "sage"


def register_backend(name: str, fn: Callable) -> None:
    _BACKENDS[name] = fn


def set_attention_backend(name: str) -> None:
    """Globally select the attention implementation (the analogue of
    monkey-patching F.scaled_dot_product_attention)."""
    global _CURRENT
    if name not in _BACKENDS:
        raise ValueError(f"unknown backend {name!r}; have {sorted(_BACKENDS)}")
    _CURRENT = name


def get_attention_backend() -> str:
    return _CURRENT


def attention(q, k, v, *, is_causal=False, sm_scale=None, backend=None, **kw):
    """Scaled-dot-product attention on HND [b, h, s, d] tensors through the
    selected backend."""
    name = backend or _CURRENT
    if name not in _BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; have {sorted(_BACKENDS)}"
        )
    return _BACKENDS[name](
        q, k, v, is_causal=is_causal, sm_scale=sm_scale, **kw
    )


def _sdpa(q, k, v, *, is_causal, sm_scale, window=None, **kw):
    if kw:
        # silently dropping a kwarg (e.g. a mask) would answer with the
        # wrong attention; refuse instead
        raise TypeError(f"sdpa backend does not support {sorted(kw)}")
    if window is not None and not is_causal:
        raise ValueError("window requires is_causal=True")
    qn, kn, vn = (jnp.swapaxes(x, 1, 2) for x in (q, k, v))
    o = jax.nn.dot_product_attention(
        qn, kn, vn, is_causal=is_causal, scale=sm_scale,
        # core's window semantics: each query sees its last `window`
        # keys inclusive of itself -> (window-1, 0)
        local_window_size=None if window is None else (window - 1, 0),
        implementation="xla",
    )
    return jnp.swapaxes(o, 1, 2)


register_backend(
    "sage",
    lambda q, k, v, *, is_causal, sm_scale, **kw: sa.sageattn(
        q, k, v, is_causal=is_causal, sm_scale=sm_scale, **kw
    ),
)
register_backend(
    "sage_bf16",
    lambda q, k, v, *, is_causal, sm_scale, **kw: sa.sageattn_qk_int8_pv_bf16(
        q, k, v, is_causal=is_causal, sm_scale=sm_scale, **kw
    ),
)
register_backend(
    "sage_fp8",
    lambda q, k, v, *, is_causal, sm_scale, **kw: sa.sageattn_qk_int8_pv_fp8(
        q, k, v, is_causal=is_causal, sm_scale=sm_scale, **kw
    ),
)
register_backend("sdpa", _sdpa)


def _flash(q, k, v, *, is_causal, sm_scale, **kw):
    from sageattention_jax import baselines

    if kw:
        raise TypeError(f"flash backend does not support {sorted(kw)}")
    return baselines.cudnn(q, k, v, is_causal=is_causal, sm_scale=sm_scale)


register_backend("flash", _flash)

# --- mesh-aware parallel backend -------------------------------------
_MESH = None
_MESH_AXES = ("data", "seq", "heads")
_PARALLEL_CACHE: dict = {}


def set_mesh(mesh, data_axis="data", ring_axis="seq", ulysses_axis="heads"):
    """Bind a device mesh; the "sage_parallel" backend then runs every
    attention as DP x ring x Ulysses over it (the in-model analogue of
    running the whole pipeline under xDiT, reference:
    example/parallel_sageattn_cogvideo.py)."""
    global _MESH, _MESH_AXES
    _MESH = mesh
    _MESH_AXES = (data_axis, ring_axis, ulysses_axis)
    _PARALLEL_CACHE.clear()


def _sage_parallel(q, k, v, *, is_causal, sm_scale, **kw):
    if _MESH is None:
        raise RuntimeError("call models.set_mesh(mesh) before using the "
                           "'sage_parallel' backend")
    from sageattention_jax.parallel.api import make_parallel_sageattn

    key = (is_causal, sm_scale, tuple(sorted(kw.items())))
    if key not in _PARALLEL_CACHE:
        data_axis, ring_axis, ulysses_axis = _MESH_AXES
        # Differentiable as-is: every leaf of make_parallel_sageattn is
        # the custom-VJP sage attention (blockwise backward, per shard /
        # per ring step), so gradients flow through the ring's ppermute
        # and the Ulysses all-to-alls without ever building a global
        # score matrix.
        _PARALLEL_CACHE[key] = make_parallel_sageattn(
            _MESH,
            data_axis=data_axis,
            ring_axis=ring_axis,
            ulysses_axis=ulysses_axis,
            is_causal=is_causal,
            sm_scale=sm_scale,
            **kw,
        )
    return _PARALLEL_CACHE[key](q, k, v)


register_backend("sage_parallel", _sage_parallel)
register_backend(
    "reference",
    lambda q, k, v, *, is_causal, sm_scale, **kw: ref_mod.attention_reference(
        q, k, v, is_causal=is_causal, sm_scale=sm_scale, **kw
    ),
)


def sage_attention_fn(
    query,
    key,
    value,
    bias=None,
    mask=None,
    *,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    is_causal: bool = False,
    sm_scale: float | None = None,
    dtype=None,
    **sage_kwargs,
):
    """``flax.linen.dot_product_attention``-compatible attention function.

    The flax-native analogue of the reference's global SDPA monkey-patch
    (reference: example/cogvideox-2b.py:16-23): ANY flax model built on
    ``nn.MultiHeadDotProductAttention`` switches to sage attention with

        nn.MultiHeadDotProductAttention(
            num_heads=h, attention_fn=sage_attention_fn)

    (or ``functools.partial(sage_attention_fn, is_causal=True, ...)`` to
    fix options).  Accepts flax's calling convention: q/k/v shaped
    ``[batch..., length, num_heads, head_dim]``, bool ``mask`` and
    additive ``bias`` broadcastable to ``[batch..., heads, sq, sk]``.
    Extra flax kwargs (precision, dropout plumbing, einsum overrides) are
    accepted and ignored — except attention dropout, which is rejected
    like the reference's kernels (they have none).
    """
    # keep only kwargs sageattn understands (a partial() fixing sage
    # options); anything else is flax's evolving internal plumbing
    # (precision, dropout rngs, einsum overrides, ...) — ignored, as
    # documented, instead of chasing flax's call signature by name
    _sage_opts = {
        "pv_dtype", "qk_quant_gran", "qk_bits", "smooth_k", "smooth_q",
        "smooth_v", "window", "block_q", "block_k", "impl",
    }
    sage_kwargs = {
        k_: v_ for k_, v_ in sage_kwargs.items() if k_ in _sage_opts
    }
    if dropout_rate != 0.0 and not deterministic:
        raise NotImplementedError(
            "sage attention has no attention-weight dropout (reference "
            "parity: the reference kernels have none either)"
        )
    *batch, sq, h, d = query.shape
    sk = key.shape[-3]
    bsz = 1
    for n in batch:
        bsz *= n

    def flat(x):  # [batch..., s, h, d] -> NHD [b, s, h, d]
        return x.reshape((bsz,) + x.shape[len(batch):])

    def flat_mask(m):
        # broadcast trailing dims to (sq, sk), heads to 1-or-h, then
        # collapse leading batch dims to b (core handles [b,1|h,sq,sk])
        while m.ndim < len(batch) + 3:
            m = m[None]
        tgt = tuple(batch) + (m.shape[-3], sq, sk)
        m = jnp.broadcast_to(m, tgt) if m.shape != tgt else m
        return m.reshape((bsz,) + m.shape[len(batch):])

    kw = dict(sage_kwargs)
    if mask is not None:
        # flax mask semantics are boolean (nonzero = attend) whatever the
        # dtype — nn.make_attention_mask returns float32 0/1.  core treats
        # a non-bool attn_mask as an ADDITIVE bias (torch semantics), so
        # cast here or a float mask silently becomes a +1 logit bias.
        kw["attn_mask"] = flat_mask(mask).astype(jnp.bool_)
    if bias is not None:
        kw["attn_bias"] = flat_mask(bias)
    out = sa.sageattn(
        flat(query),
        flat(key),
        flat(value),
        tensor_layout="NHD",
        is_causal=is_causal,
        sm_scale=sm_scale,
        **kw,
    )
    out = out.reshape(tuple(batch) + out.shape[1:])
    return out.astype(dtype) if dtype is not None else out


@dataclasses.dataclass
class SageAttnProcessor:
    """Per-layer attention processor (the analogue of the reference's
    WanAttnProcessor2_0 / MochiAttnProcessor2_0 injection, reference:
    example/modify_model/modify_wan.py:9-40)."""

    backend: str = "sage"
    is_causal: bool = False
    kwargs: dict = dataclasses.field(default_factory=dict)

    def __call__(self, q, k, v, sm_scale=None):
        return attention(
            q,
            k,
            v,
            is_causal=self.is_causal,
            sm_scale=sm_scale,
            backend=self.backend,
            **self.kwargs,
        )

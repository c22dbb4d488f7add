"""jax.nn.dot_product_attention drop-in adapter (interop.jax_sdpa).

Golden model: ``jax.nn.dot_product_attention(..., implementation='xla')``
in fp32 — the JAX-side analogue of the torch-SDPA parity tests in
test_interop.py (reference integration: example/cogvideox-2b.py:16-23).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sageattention_jax.interop import dot_product_attention, patch_jax_sdpa
from sageattention_jax.utils.compare import cosine_similarity

B, T, S, N, H = 2, 192, 256, 4, 64


def _rand(shape, seed):
    x = jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)
    return x.astype(jnp.bfloat16)


def _qkv(n_kv=N, t=T, s=S, h=H, b=B):
    return (
        _rand((b, t, N, h), 0),
        _rand((b, s, n_kv, h), 1),
        _rand((b, s, n_kv, h), 2),
    )


def _golden(q, k, v, **kw):
    return jax.nn.dot_product_attention(
        q.astype(jnp.float32),
        k.astype(jnp.float32),
        v.astype(jnp.float32),
        implementation="xla",
        **kw,
    )


def _check(ours, ref, min_cos=0.999):
    cos = cosine_similarity(np.asarray(ours, np.float32), np.asarray(ref))
    assert cos > min_cos, cos


class TestSignatureParity:
    def test_plain(self):
        q, k, v = _qkv()
        _check(dot_product_attention(q, k, v), _golden(q, k, v))

    def test_causal_and_scale(self):
        q, k, v = _qkv(t=S)  # causal needs square here
        _check(
            dot_product_attention(q, k, v, is_causal=True, scale=0.09),
            _golden(q, k, v, is_causal=True, scale=0.09),
        )

    def test_gqa(self):
        q, k, v = _qkv(n_kv=2)
        _check(dot_product_attention(q, k, v), _golden(q, k, v))

    def test_bool_mask(self):
        q, k, v = _qkv()
        mask = jax.random.bernoulli(
            jax.random.PRNGKey(5), 0.8, (1, 1, T, S)
        )
        # guarantee no empty rows (golden would emit uniform-softmax rows)
        mask = mask.at[..., 0].set(True)
        _check(
            dot_product_attention(q, k, v, mask=mask),
            _golden(q, k, v, mask=mask),
        )

    def test_additive_bias(self):
        q, k, v = _qkv()
        bias = (
            jax.random.normal(jax.random.PRNGKey(7), (1, N, T, S)) * 2.0
        ).astype(jnp.float32)
        _check(
            dot_product_attention(q, k, v, bias=bias),
            _golden(q, k, v, bias=bias),
        )

    def test_seq_lengths_pad_rows_zeroed(self):
        q, k, v = _qkv()
        qlen = jnp.array([T - 64, T])
        kvlen = jnp.array([S, S - 96])
        ours = dot_product_attention(
            q, k, v, query_seq_lengths=qlen, key_value_seq_lengths=kvlen
        )
        ref = _golden(
            q, k, v, query_seq_lengths=qlen, key_value_seq_lengths=kvlen
        )
        # valid region matches the golden; padded query rows are exact zeros
        for bi, ql in enumerate([T - 64, T]):
            _check(ours[bi, :ql], ref[bi, :ql])
        assert not np.any(np.asarray(ours[0, T - 64:], np.float32))

    def test_local_window_causal_uses_native_band(self):
        q, k, v = _qkv(t=S)
        ref = _golden(q, k, v, is_causal=True, local_window_size=(63, 0))
        ours = dot_product_attention(
            q, k, v, is_causal=True, local_window_size=(63, 0)
        )
        _check(ours, ref)
        # int == symmetric window; right span is dead under causal
        ours_int = dot_product_attention(
            q, k, v, is_causal=True, local_window_size=63
        )
        _check(ours_int, ref)

    def test_local_window_noncausal_band_mask(self):
        q, k, v = _qkv(t=S)
        ref = _golden(q, k, v, local_window_size=(32, 17))
        ours = dot_product_attention(q, k, v, local_window_size=(32, 17))
        _check(ours, ref)

    def test_return_residual_shape_and_value(self):
        q, k, v = _qkv()
        ours, lse = dot_product_attention(q, k, v, return_residual=True)
        assert lse.shape == (B, T, N)  # jax.nn's BTN
        # LSE must be the natural-log logsumexp of the true logits
        logits = jnp.einsum(
            "btnh,bsnh->bnts",
            q.astype(jnp.float32),
            k.astype(jnp.float32),
        ) * (H**-0.5)
        want = jax.scipy.special.logsumexp(logits, axis=-1)  # [b, n, t]
        np.testing.assert_allclose(
            np.asarray(lse, np.float32),
            np.asarray(jnp.transpose(want, (0, 2, 1))),
            rtol=0.02,
            atol=0.05,
        )

    def test_rank_validation(self):
        q, k, v = _qkv()
        with pytest.raises(ValueError, match="rank-4"):
            dot_product_attention(q[0], k, v)

    def test_float_mask_rejected(self):
        q, k, v = _qkv()
        with pytest.raises(ValueError, match="boolean"):
            dot_product_attention(q, k, v, mask=jnp.zeros((1, 1, T, S)))


class TestPatch:
    def test_patch_and_undo(self):
        q, k, v = _qkv()
        before = jax.nn.dot_product_attention
        ref = _golden(q, k, v)
        undo = patch_jax_sdpa()
        try:
            assert jax.nn.dot_product_attention is not before
            _check(jax.nn.dot_product_attention(q, k, v), ref)
        finally:
            undo()
        assert jax.nn.dot_product_attention is before

    def test_patch_defaults_forwarded(self):
        q, k, v = _qkv()
        undo = patch_jax_sdpa(pv_dtype="int8")
        try:
            out = jax.nn.dot_product_attention(q, k, v)
        finally:
            undo()
        _check(out, _golden(q, k, v), min_cos=0.998)

    def test_patched_signature_superset(self):
        # callers passing jax.nn's own kwargs must not break
        q, k, v = _qkv(t=S)
        undo = patch_jax_sdpa()
        try:
            out = jax.nn.dot_product_attention(
                q, k, v, is_causal=True, implementation="cudnn"
            )
        finally:
            undo()
        _check(out, _golden(q, k, v, is_causal=True))

"""Golden-model self-consistency tests (SURVEY.md §4 step 1)."""

import jax
import jax.numpy as jnp
import numpy as np

from sageattention_jax import quant
from sageattention_jax.ops import reference

LOG2E = 1.4426950408889634


def rand(key, shape, scale=1.0):
    return jax.random.normal(jax.random.PRNGKey(key), shape) * scale


def naive_attention(q, k, v, sm_scale, causal=False):
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, precision="highest") * sm_scale
    if causal:
        sq, sk = s.shape[-2:]
        mask = jnp.tril(jnp.ones((sq, sk), bool))
        s = jnp.where(mask, s, -jnp.inf)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p, v)


class TestAttentionReference:
    def test_matches_naive(self):
        q, k, v = (rand(i, (2, 3, 64, 32)) for i in range(3))
        o = reference.attention_reference(q, k, v, sm_scale=0.2)
        np.testing.assert_allclose(
            np.asarray(o), np.asarray(naive_attention(q, k, v, 0.2)), atol=1e-5
        )

    def test_causal(self):
        q, k, v = (rand(i + 3, (1, 2, 48, 16)) for i in range(3))
        o = reference.attention_reference(q, k, v, is_causal=True)
        np.testing.assert_allclose(
            np.asarray(o),
            np.asarray(naive_attention(q, k, v, 16**-0.5, causal=True)),
            atol=1e-5,
        )

    def test_gqa(self):
        q = rand(6, (1, 4, 32, 16))
        k, v = rand(7, (1, 2, 32, 16)), rand(8, (1, 2, 32, 16))
        o = reference.attention_reference(q, k, v)
        o2 = reference.attention_reference(
            q, jnp.repeat(k, 2, 1), jnp.repeat(v, 2, 1)
        )
        np.testing.assert_allclose(np.asarray(o), np.asarray(o2), atol=1e-6)

    def test_lse(self):
        q, k, v = (rand(i + 9, (1, 1, 32, 16)) for i in range(3))
        o, lse = reference.attention_reference(q, k, v, return_lse=True)
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k, precision="highest") * 16**-0.5
        expect = jax.scipy.special.logsumexp(s, axis=-1)
        np.testing.assert_allclose(np.asarray(lse), np.asarray(expect), atol=1e-5)

    def test_segments(self):
        q, k, v = (rand(i + 12, (1, 1, 32, 16)) for i in range(3))
        seg = jnp.concatenate([jnp.zeros(16, jnp.int32), jnp.ones(16, jnp.int32)])
        o = reference.attention_reference(
            q, k, v, q_segment_ids=seg[None], kv_segment_ids=seg[None]
        )
        # block-diagonal: each half attends only within itself
        o0 = reference.attention_reference(
            q[:, :, :16], k[:, :, :16], v[:, :, :16], sm_scale=16**-0.5
        )
        np.testing.assert_allclose(
            np.asarray(o[:, :, :16]), np.asarray(o0), atol=1e-5
        )


class TestQuantizedOracle:
    def test_exact_on_integer_inputs(self):
        """Feeding exactly-representable int8 data, the oracle equals the
        dequantized float attention (base-2 softmax identity)."""
        kq = jax.random.randint(jax.random.PRNGKey(0), (1, 2, 32, 16), -20, 20)
        kk = jax.random.randint(jax.random.PRNGKey(1), (1, 2, 32, 16), -20, 20)
        q_i8, k_i8 = kq.astype(jnp.int8), kk.astype(jnp.int8)
        qs = jnp.full((1, 2, 32), 0.07 * LOG2E)
        ks = jnp.full((1, 2, 32), 0.11)
        v = rand(2, (1, 2, 32, 16))
        o = reference.quantized_attention_reference(
            q_i8, qs, k_i8, ks, v, out_dtype=jnp.float32
        )
        o_f = naive_attention(
            q_i8.astype(jnp.float32) * 0.07,
            k_i8.astype(jnp.float32) * 0.11,
            v,
            sm_scale=1.0,
        )
        np.testing.assert_allclose(np.asarray(o), np.asarray(o_f), atol=1e-4)

    def test_full_pipeline_cosine(self):
        """Quant -> oracle ~ fp32 attention (the accuracy contract)."""
        q, k, v = (rand(i + 20, (2, 4, 128, 64)) for i in range(3))
        sm = 64**-0.5
        q_i8, qs, k_i8, ks, km = quant.quantize_qk(q, k, sm_scale=sm)
        vq, vs, _ = quant.per_channel_quant(v, dtype=jnp.int8)
        o = reference.quantized_attention_reference(
            q_i8, qs, k_i8, ks, vq, vs, out_dtype=jnp.float32
        )
        o_ref = reference.attention_reference(q, k, v, sm_scale=sm)
        cos = jnp.sum(o * o_ref) / (
            jnp.linalg.norm(o) * jnp.linalg.norm(o_ref)
        )
        assert float(cos) > 0.999

    def test_smoothing_invariance(self):
        """Subtracting km from K leaves softmax attention invariant; the
        quantized pipeline with smoothing must track the same reference."""
        q = rand(30, (1, 2, 64, 32))
        k = rand(31, (1, 2, 64, 32)) + 4.0  # large K mean
        v = rand(32, (1, 2, 64, 32))
        sm = 32**-0.5
        q_i8, qs, k_i8, ks, km = quant.quantize_qk(q, k, sm_scale=sm, smooth_k=True)
        vq, vs, _ = quant.per_channel_quant(v, dtype=jnp.int8)
        o = reference.quantized_attention_reference(
            q_i8, qs, k_i8, ks, vq, vs, out_dtype=jnp.float32
        )
        o_ref = reference.attention_reference(q, k, v, sm_scale=sm)
        err_s = float(jnp.max(jnp.abs(o - o_ref)))
        # without smoothing the same pipeline is worse
        q_i8n, qsn, k_i8n, ksn, _ = quant.quantize_qk(
            q, k, sm_scale=sm, smooth_k=False
        )
        on = reference.quantized_attention_reference(
            q_i8n, qsn, k_i8n, ksn, vq, vs, out_dtype=jnp.float32
        )
        err_n = float(jnp.max(jnp.abs(on - o_ref)))
        assert err_s < err_n

    def test_lse_base2(self):
        q, k, v = (rand(i + 40, (1, 1, 32, 16)) for i in range(3))
        q_i8, qs, k_i8, ks, _ = quant.quantize_qk(
            q, k, sm_scale=1.0, smooth_k=False
        )
        _, lse2 = reference.quantized_attention_reference(
            q_i8, qs, k_i8, ks, v, return_lse=True, out_dtype=jnp.float32
        )
        # lse2/log2e should approximate natural lse of dequantized logits
        s = (
            jnp.einsum("bhqd,bhkd->bhqk", q_i8.astype(jnp.float32),
                       k_i8.astype(jnp.float32), precision="highest")
            * qs[..., :, None] * ks[..., None, :] / LOG2E
        )
        expect = jax.scipy.special.logsumexp(s, axis=-1)
        np.testing.assert_allclose(
            np.asarray(lse2 / LOG2E), np.asarray(expect), atol=1e-4
        )


class TestMerge:
    def test_ring_merge_identity(self):
        """Splitting KV into shards and LSE-merging equals full attention —
        the ring-attention contract (reference: core.py:122-124)."""
        q, k, v = (rand(i + 50, (1, 2, 32, 16)) for i in range(3))
        o_full, lse_full = reference.attention_reference(
            q, k, v, return_lse=True
        )
        parts = []
        for sl in (slice(0, 16), slice(16, 32)):
            parts.append(
                reference.attention_reference(
                    q, k[:, :, sl], v[:, :, sl], return_lse=True,
                    sm_scale=16**-0.5,
                )
            )
        o_m, lse_m = reference.merge_attention_partials(
            [p[0] for p in parts], [p[1] for p in parts]
        )
        np.testing.assert_allclose(np.asarray(o_m), np.asarray(o_full), atol=1e-4)
        np.testing.assert_allclose(np.asarray(lse_m), np.asarray(lse_full), atol=1e-4)

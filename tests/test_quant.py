"""Quantizer unit tests (spec: reference quant.py / csrc/fused/fused.cu)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sageattention_jax import quant

LOG2E = 1.4426950408889634


def rand(key, shape, scale=3.0):
    return jax.random.normal(jax.random.PRNGKey(key), shape) * scale


class TestRoundHalfAway:
    def test_halves(self):
        x = jnp.array([0.5, -0.5, 1.5, -1.5, 2.4, -2.4, 0.0])
        np.testing.assert_array_equal(
            np.asarray(quant.round_half_away(x)),
            [1.0, -1.0, 2.0, -2.0, 2.0, -2.0, 0.0],
        )


class TestQuantInt8:
    @pytest.mark.parametrize("gran", ["per_token", "per_subtile", "per_block"])
    def test_roundtrip_error_bound(self, gran):
        x = rand(0, (2, 3, 160, 64))
        q, s = quant.quant_int8(x, granularity=gran)
        deq = q.astype(jnp.float32) * s[..., None]
        # max error is half a quantization step per group
        err = jnp.abs(deq - x)
        step = s[..., None]
        assert jnp.all(err <= 0.5 * step + 1e-6)

    def test_scale_shapes_are_per_row(self):
        x = rand(1, (2, 3, 160, 64))
        for gran in ["per_token", "per_subtile", "per_block"]:
            _, s = quant.quant_int8(x, granularity=gran)
            assert s.shape == (2, 3, 160)

    def test_per_token_at_least_as_accurate(self):
        x = rand(2, (1, 2, 256, 64))
        errs = {}
        for gran in ["per_token", "per_subtile", "per_block"]:
            q, s = quant.quant_int8(x, granularity=gran)
            deq = q.astype(jnp.float32) * s[..., None]
            errs[gran] = float(jnp.mean((deq - x) ** 2))
        assert errs["per_token"] <= errs["per_subtile"] <= errs["per_block"]

    def test_range(self):
        x = rand(3, (1, 1, 64, 32), scale=100.0)
        q, _ = quant.quant_int8(x)
        assert int(jnp.max(jnp.abs(q.astype(jnp.int32)))) <= 127

    def test_int4_range(self):
        x = rand(4, (1, 1, 64, 32))
        q, _ = quant.quant_int8(x, bits=4)
        assert int(jnp.max(jnp.abs(q.astype(jnp.int32)))) <= 7

    def test_scale_fold(self):
        x = rand(5, (1, 1, 32, 32))
        _, s1 = quant.quant_int8(x)
        _, s2 = quant.quant_int8(x, scale_fold=2.5)
        np.testing.assert_allclose(np.asarray(s2), np.asarray(s1) * 2.5, rtol=1e-6)


class TestSubMean:
    def test_centers(self):
        x = rand(6, (2, 2, 100, 16))
        c, m = quant.sub_mean(x)
        np.testing.assert_allclose(
            np.asarray(jnp.mean(c, axis=-2)), 0.0, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(m), np.asarray(jnp.mean(x, axis=-2)), rtol=1e-5
        )


class TestPerChannel:
    def test_int8_roundtrip(self):
        v = rand(7, (2, 2, 96, 32))
        vq, vs, vm = quant.per_channel_quant(v, dtype=jnp.int8)
        assert vm is None
        deq = vq.astype(jnp.float32) * vs[..., None, :]
        err = jnp.abs(deq - v)
        assert jnp.all(err <= 0.5 * vs[..., None, :] + 1e-6)

    def test_smooth(self):
        v = rand(8, (1, 2, 64, 16)) + 5.0  # big mean -> smoothing helps
        vq, vs, vm = quant.per_channel_quant(v, dtype=jnp.int8, smooth=True)
        deq = vq.astype(jnp.float32) * vs[..., None, :] + vm[..., None, :]
        vq2, vs2, _ = quant.per_channel_quant(v, dtype=jnp.int8, smooth=False)
        deq2 = vq2.astype(jnp.float32) * vs2[..., None, :]
        assert float(jnp.mean((deq - v) ** 2)) < float(jnp.mean((deq2 - v) ** 2))

    def test_fp8(self):
        v = rand(9, (1, 1, 64, 16))
        vq, vs, _ = quant.per_channel_quant(v, dtype=jnp.float8_e4m3fn)
        assert vq.dtype == jnp.float8_e4m3fn
        deq = vq.astype(jnp.float32) * vs[..., None, :]
        # e4m3 relative precision ~2^-3 worst case near max
        assert float(jnp.max(jnp.abs(deq - v))) < 0.1 * float(jnp.max(jnp.abs(v)))


class TestQuantizeQK:
    def test_fold_and_smoothing(self):
        q = rand(10, (1, 2, 128, 64))
        k = rand(11, (1, 2, 128, 64)) + 2.0
        sm = 64**-0.5
        q_i8, q_s, k_i8, k_s, km = quant.quantize_qk(q, k, sm_scale=sm)
        np.testing.assert_allclose(
            np.asarray(km), np.asarray(jnp.mean(k, axis=-2)), rtol=1e-5
        )
        # unfold: q roundtrips through q_scale / (sm*log2e)
        deq = q_i8.astype(jnp.float32) * (q_s / (sm * LOG2E))[..., None]
        assert float(jnp.max(jnp.abs(deq - q))) < 0.1
        # k quantizes the smoothed k
        deq_k = k_i8.astype(jnp.float32) * k_s[..., None]
        np.testing.assert_allclose(
            np.asarray(deq_k), np.asarray(k - km[..., None, :]), atol=0.1
        )


class TestFp8Experiments:
    """FP8 quantization experiments (reference: quant.py:324-437)."""

    def test_per_token_fp8_round_trip(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (1, 2, 64, 32))
        xq, scale = quant.per_token_quant_fp8(x)
        assert xq.dtype == jnp.float8_e4m3fn
        rec = xq.astype(jnp.float32) * scale[..., None]
        rel = np.abs(np.asarray(rec - x)) / (np.abs(np.asarray(x)) + 1e-3)
        assert float(np.median(rel)) < 0.05

    def test_autoalpha_beats_or_matches_alpha1(self):
        # heavy-tailed channels: saturation (alpha < 1) should win
        key = jax.random.PRNGKey(1)
        v = jax.random.normal(key, (1, 2, 256, 16))
        spikes = jax.random.bernoulli(jax.random.PRNGKey(2), 0.002,
                                      v.shape) * 50.0
        v = v + spikes
        vq, scale, mean, alpha = quant.per_channel_fp8_affine_autoalpha(
            v, loss="rmse"
        )
        rec = (vq.astype(jnp.float32) * scale[..., None, :]
               + mean[..., None, :])
        vq1, s1, m1, _ = quant.per_channel_fp8_affine_autoalpha(
            v, loss="rmse", n_alpha=1, alpha_min=1.0
        )
        rec1 = (vq1.astype(jnp.float32) * s1[..., None, :]
                + m1[..., None, :])
        err = float(jnp.mean((rec - v) ** 2))
        err1 = float(jnp.mean((rec1 - v) ** 2))
        assert err <= err1 * 1.0001
        assert float(alpha.min()) < 1.0  # the search actually saturated

    def test_autoalpha_huber(self):
        v = jax.random.normal(jax.random.PRNGKey(3), (1, 1, 128, 8))
        vq, scale, mean, alpha = quant.per_channel_fp8_affine_autoalpha(v)
        assert vq.shape == v.shape and scale.shape == (1, 1, 8)

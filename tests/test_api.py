"""Public API tests: sageattn / sageattn_varlen drop-in semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sageattention_jax as sa
from sageattention_jax.ops import reference


def rand(key, shape, scale=1.0, dtype=jnp.float32):
    return (jax.random.normal(jax.random.PRNGKey(key), shape) * scale).astype(dtype)


def cosine(a, b):
    a = jnp.asarray(a, jnp.float32).ravel()
    b = jnp.asarray(b, jnp.float32).ravel()
    return float(jnp.dot(a, b) / (jnp.linalg.norm(a) * jnp.linalg.norm(b)))


class TestSageattn:
    def test_matches_sdpa_reference(self):
        q, k, v = (rand(i, (2, 4, 256, 64)) for i in range(3))
        o = sa.sageattn(q, k, v)
        o_ref = reference.attention_reference(q, k, v)
        assert cosine(o, o_ref) > 0.999

    def test_nhd_layout(self):
        q, k, v = (rand(i + 3, (1, 128, 4, 64)) for i in range(3))
        o = sa.sageattn(q, k, v, tensor_layout="NHD")
        assert o.shape == q.shape
        o_hnd = sa.sageattn(
            *(jnp.swapaxes(x, 1, 2) for x in (q, k, v)), tensor_layout="HND"
        )
        np.testing.assert_allclose(
            np.asarray(jnp.swapaxes(o, 1, 2)), np.asarray(o_hnd), atol=1e-5
        )

    def test_unpadded_lengths(self):
        """Non-multiple-of-128 seq lens go through the pad+mask path
        (reference pads kv to x128, core.py:822-828)."""
        q, k, v = (rand(i + 6, (1, 2, 200, 48)) for i in range(3))
        o = sa.sageattn(q, k, v, pv_dtype="bf16")
        assert o.shape == (1, 2, 200, 48)
        o_ref = reference.attention_reference(q, k, v)
        assert cosine(o, o_ref) > 0.999

    def test_causal_unpadded(self):
        q, k, v = (rand(i + 9, (1, 2, 200, 64)) for i in range(3))
        o = sa.sageattn(q, k, v, is_causal=True)
        o_ref = reference.attention_reference(q, k, v, is_causal=True)
        assert cosine(o, o_ref) > 0.999

    def test_return_lse_with_smoothing_correction(self):
        """Natural-log LSE must be exact under K-smoothing (the ring
        contract, reference: core.py:281-285, 358)."""
        q = rand(12, (1, 2, 256, 64))
        k = rand(13, (1, 2, 256, 64)) + 1.5
        v = rand(14, (1, 2, 256, 64))
        o, lse = sa.sageattn(q, k, v, return_lse=True, pv_dtype="bf16")
        _, lse_ref = reference.attention_reference(q, k, v, return_lse=True)
        np.testing.assert_allclose(
            np.asarray(lse), np.asarray(lse_ref), atol=0.05, rtol=0.01
        )

    def test_bf16_inputs(self):
        q, k, v = (rand(i + 15, (1, 2, 128, 64), dtype=jnp.bfloat16) for i in range(3))
        o = sa.sageattn(q, k, v)
        assert o.dtype == jnp.bfloat16

    def test_gqa(self):
        q = rand(18, (1, 8, 128, 64))
        k, v = rand(19, (1, 2, 128, 64)), rand(20, (1, 2, 128, 64))
        o = sa.sageattn(q, k, v, pv_dtype="bf16")
        o_ref = reference.attention_reference(q, k, v)
        assert cosine(o, o_ref) > 0.999

    def test_sm_scale_override(self):
        q, k, v = (rand(i + 21, (1, 2, 128, 64)) for i in range(3))
        o = sa.sageattn(q, k, v, sm_scale=0.05, pv_dtype="bf16")
        o_ref = reference.attention_reference(q, k, v, sm_scale=0.05)
        assert cosine(o, o_ref) > 0.999

    def test_xla_impl_parity(self):
        q, k, v = (rand(i + 24, (1, 2, 128, 64)) for i in range(3))
        o_p = sa.sageattn(q, k, v, impl="pallas", pv_dtype="bf16",
                          interpret=True)
        o_x = sa.sageattn(q, k, v, impl="xla", pv_dtype="bf16")
        np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_x), atol=2e-2)

    def test_attn_bias(self):
        # additive bias rides the quantized blockwise path (the bias
        # joins the dequantized logits, reference:
        # attn_qk_int8_per_thread.py:49-56), so parity is at
        # quantization accuracy, not machine precision
        q, k, v = (rand(i + 27, (1, 2, 64, 32)) for i in range(3))
        bias = rand(30, (1, 2, 64, 64), scale=2.0)
        o = sa.sageattn(q, k, v, attn_bias=bias)
        o_ref = reference.attention_reference(q, k, v, attn_bias=bias)
        assert cosine(o, o_ref) > 0.999

    def test_attn_bias_pallas_vs_xla(self):
        # the default (auto) bias path against an explicit impl="xla":
        # both are the blockwise path
        q, k, v = (rand(i + 61, (1, 2, 128, 64)) for i in range(3))
        bias = rand(64, (1, 2, 128, 128), scale=2.0)
        o_p = sa.sageattn(q, k, v, attn_bias=bias, pv_dtype="bf16")
        o_x = sa.sageattn(
            q, k, v, attn_bias=bias, pv_dtype="bf16", impl="xla"
        )
        assert cosine(o_p, o_x) > 0.999


class TestVarlen:
    def test_matches_per_sequence(self):
        """Packed varlen == looping over the individual sequences
        (reference: core.py:362-477)."""
        lens = [60, 100, 96]
        total = sum(lens)
        h, d = 2, 64
        q = rand(40, (total, h, d))
        k = rand(41, (total, h, d))
        v = rand(42, (total, h, d))
        cu = jnp.array([0, 60, 160, 256], jnp.int32)
        o = sa.sageattn_varlen(q, k, v, cu, cu, pv_dtype="bf16", smooth_k=False)
        assert o.shape == (total, h, d)
        start = 0
        for n in lens:
            sl = slice(start, start + n)
            o_ref = reference.attention_reference(
                jnp.swapaxes(q[sl], 0, 1)[None],
                jnp.swapaxes(k[sl], 0, 1)[None],
                jnp.swapaxes(v[sl], 0, 1)[None],
            )[0]
            got = jnp.swapaxes(o[sl], 0, 1)
            assert cosine(got, o_ref) > 0.999, f"seq at {start}"
            start += n

    def test_causal_mismatched_cu_seqlens_raises(self):
        """Regression: equal totals with different packings must raise
        (would silently compute wrong causal masks)."""
        q, k, v = (rand(i + 55, (256, 2, 32)) for i in range(3))
        cu_q = jnp.array([0, 128, 256], jnp.int32)
        cu_k = jnp.array([0, 100, 256], jnp.int32)
        with pytest.raises(ValueError, match="cu_seqlens"):
            sa.sageattn_varlen(q, k, v, cu_q, cu_k, is_causal=True)

    def test_varlen_gqa_ragged(self):
        """Ragged packing + grouped KV heads through the varlen path."""
        lens = [70, 130, 56]
        total = sum(lens)
        hq, hkv, d = 4, 2, 64
        q = rand(80, (total, hq, d))
        k = rand(81, (total, hkv, d))
        v = rand(82, (total, hkv, d))
        cu = jnp.array([0, 70, 200, 256], jnp.int32)
        o = sa.sageattn_varlen(
            q, k, v, cu, cu, max_seqlen_q=130, max_seqlen_k=130,
            pv_dtype="bf16", smooth_k=False,
        )
        start = 0
        for n in lens:
            sl = slice(start, start + n)
            kr = jnp.repeat(jnp.swapaxes(k[sl], 0, 1)[None], 2, axis=1)
            vr = jnp.repeat(jnp.swapaxes(v[sl], 0, 1)[None], 2, axis=1)
            o_ref = reference.attention_reference(
                jnp.swapaxes(q[sl], 0, 1)[None], kr, vr
            )[0]
            assert cosine(jnp.swapaxes(o[sl], 0, 1), o_ref) > 0.999
            start += n

    def test_varlen_per_segment_smoothing(self):
        """per-segment K centering: exact (rows never cross segments) and
        strictly finer than the reference's global-mean caveat; LSE
        correction per segment."""
        lens = [100, 156]
        total = sum(lens)
        q, kk, v = (rand(i + 90, (total, 2, 64)) for i in range(3))
        # give segment 1 a big K offset so global smoothing is poor
        kk = kk.at[100:].add(5.0)
        cu = jnp.array([0, 100, 256], jnp.int32)
        o, lse = sa.sageattn_varlen(
            q, kk, v, cu, cu, pv_dtype="bf16",
            smooth_k_mode="per_segment", return_lse=True,
        )
        start = 0
        for n in lens:
            sl = slice(start, start + n)
            o_ref, lse_ref = reference.attention_reference(
                jnp.swapaxes(q[sl], 0, 1)[None],
                jnp.swapaxes(kk[sl], 0, 1)[None],
                jnp.swapaxes(v[sl], 0, 1)[None],
                return_lse=True,
            )
            assert cosine(jnp.swapaxes(o[sl], 0, 1), o_ref[0]) > 0.999
            np.testing.assert_allclose(
                np.asarray(lse[:, sl]), np.asarray(lse_ref[0]),
                rtol=1e-2, atol=5e-2,
            )
            start += n

    def test_varlen_rejects_unknown_kwargs(self):
        """Unsupported kwargs (e.g. window) must raise, not silently run
        the wrong attention pattern."""
        q, k, v = (rand(i, (64, 2, 32)) for i in range(3))
        cu = jnp.array([0, 64], jnp.int32)
        with pytest.raises(TypeError, match="window"):
            sa.sageattn_varlen(q, k, v, cu, cu, is_causal=True, window=32)

    def test_varlen_forwards_qk_bits_and_smooth_q(self):
        q, k, v = (rand(i + 70, (128, 2, 32)) for i in range(3))
        cu = jnp.array([0, 50, 128], jnp.int32)
        # qk_bits reaches the quantizer (±7 codes in int8 storage)
        jax.eval_shape(
            lambda *a: sa.sageattn_varlen(*a, qk_bits=4), q, k, v, cu, cu
        )
        o = sa.sageattn_varlen(q, k, v, cu, cu, smooth_q=True)
        for sl in (slice(0, 50), slice(50, 128)):
            o_ref = reference.attention_reference(
                jnp.swapaxes(q[sl], 0, 1)[None],
                jnp.swapaxes(k[sl], 0, 1)[None],
                jnp.swapaxes(v[sl], 0, 1)[None],
            )
            assert cosine(jnp.swapaxes(o[sl], 0, 1), o_ref[0]) > 0.99

    def test_causal_varlen(self):
        lens = [128, 128]
        total = sum(lens)
        q, k, v = (rand(i + 50, (total, 2, 32)) for i in range(3))
        cu = jnp.array([0, 128, 256], jnp.int32)
        o = sa.sageattn_varlen(
            q, k, v, cu, cu, is_causal=True, pv_dtype="bf16", smooth_k=False
        )
        start = 0
        for n in lens:
            sl = slice(start, start + n)
            o_ref = reference.attention_reference(
                jnp.swapaxes(q[sl], 0, 1)[None],
                jnp.swapaxes(k[sl], 0, 1)[None],
                jnp.swapaxes(v[sl], 0, 1)[None],
                is_causal=True,
            )[0]
            assert cosine(jnp.swapaxes(o[sl], 0, 1), o_ref) > 0.999
            start += n


class TestAttnMask:
    def test_bool_mask_matches_reference(self):
        q = jax.random.normal(jax.random.PRNGKey(0), (1, 2, 128, 64))
        k = jax.random.normal(jax.random.PRNGKey(1), (1, 2, 128, 64))
        v = jax.random.normal(jax.random.PRNGKey(2), (1, 2, 128, 64))
        mask = jax.random.bernoulli(
            jax.random.PRNGKey(3), 0.8, (1, 1, 128, 128)
        )
        o = sa.sageattn(q, k, v, attn_mask=mask)
        o_ref = reference.attention_reference(q, k, v, attn_mask=mask)
        assert cosine(o, o_ref) > 0.999

    def test_bool_mask_multistep_block_skip(self):
        """Several KV chunks with a fully-masked KV region and a fully
        dead row (which must come out exactly 0)."""
        q = jax.random.normal(jax.random.PRNGKey(10), (1, 2, 512, 64))
        k = jax.random.normal(jax.random.PRNGKey(11), (1, 2, 512, 64))
        v = jax.random.normal(jax.random.PRNGKey(12), (1, 2, 512, 64))
        mask = jax.random.bernoulli(
            jax.random.PRNGKey(13), 0.7, (1, 1, 512, 512)
        )
        # a whole 128-column KV block dead for every q block
        mask = mask.at[:, :, :, 128:256].set(False)
        # plus one fully-dead q row
        mask = mask.at[:, :, 7, :].set(False)
        o = sa.sageattn(
            q, k, v, attn_mask=mask, block_q=128, block_k=128
        )
        o_ref = reference.attention_reference(q, k, v, attn_mask=mask)
        live = jnp.asarray(mask[0, 0].any(axis=-1))
        assert cosine(o[:, :, live], o_ref[:, :, live]) > 0.999
        assert float(jnp.max(jnp.abs(o[:, :, 7]))) == 0.0

    def test_bool_mask_per_head_and_causal(self):
        q = jax.random.normal(jax.random.PRNGKey(20), (2, 2, 128, 64))
        k = jax.random.normal(jax.random.PRNGKey(21), (2, 2, 128, 64))
        v = jax.random.normal(jax.random.PRNGKey(22), (2, 2, 128, 64))
        mask = jax.random.bernoulli(
            jax.random.PRNGKey(23), 0.9, (2, 2, 128, 128)
        )
        o = sa.sageattn(q, k, v, attn_mask=mask, is_causal=True)
        o_ref = reference.attention_reference(
            q, k, v, attn_mask=mask, is_causal=True
        )
        # rows whose causal+mask intersection is empty are 0 here, NaN in
        # a naive softmax; compare live rows only
        tri = jnp.tril(jnp.ones((128, 128), bool))
        live = jnp.asarray((mask & tri).any(axis=-1))  # [b,h,sq]
        ol = jnp.where(live[..., None], o, 0)
        rl = jnp.where(live[..., None], jnp.nan_to_num(o_ref), 0)
        assert cosine(ol, rl) > 0.999

    def test_bool_mask_odd_lengths_padding(self):
        """Mask + sequence padding: pads must stay dropped."""
        q = jax.random.normal(jax.random.PRNGKey(30), (1, 2, 200, 64))
        k = jax.random.normal(jax.random.PRNGKey(31), (1, 2, 170, 64))
        v = jax.random.normal(jax.random.PRNGKey(32), (1, 2, 170, 64))
        mask = jax.random.bernoulli(
            jax.random.PRNGKey(33), 0.8, (1, 1, 200, 170)
        )
        o = sa.sageattn(q, k, v, attn_mask=mask)
        o_ref = reference.attention_reference(q, k, v, attn_mask=mask)
        assert cosine(o, o_ref) > 0.999

    def test_segments_xla_path_b_not_h(self):
        """Segment masking through the XLA fallback with b != h (the
        [b, sq, sk] mask used to misbroadcast against [b, h, sq, sk]
        scores)."""
        b, h, s, d = 2, 4, 64, 32
        q, k, v = (rand(i + 60, (b, h, s, d)) for i in range(3))
        seg = jnp.concatenate(
            [jnp.zeros((b, s // 2), jnp.int32),
             jnp.ones((b, s // 2), jnp.int32)], axis=1
        )
        o = sa.sageattn(
            q, k, v, q_segment_ids=seg, kv_segment_ids=seg, impl="xla"
        )
        o_ref = reference.attention_reference(
            q, k, v, q_segment_ids=seg, kv_segment_ids=seg
        )
        assert cosine(o, o_ref) > 0.999
        # and segment + bool-mask combination broadcasts correctly too
        m = jnp.ones((b, 1, s, s), bool).at[:, :, :, -8:].set(False)
        o2 = sa.sageattn(
            q, k, v, q_segment_ids=seg, kv_segment_ids=seg,
            attn_mask=m, impl="xla",
        )
        assert np.isfinite(np.asarray(o2, np.float32)).all()

    def test_lone_segment_or_position_arg_raises(self):
        q, k, v = (rand(i, (1, 2, 64, 32)) for i in range(3))
        seg = jnp.zeros((1, 64), jnp.int32)
        with pytest.raises(ValueError, match="together"):
            sa.sageattn(q, k, v, kv_segment_ids=seg)
        with pytest.raises(ValueError, match="together"):
            sa.sageattn(q, k, v, q_positions=seg)

    def test_bias_path_honors_positions(self):
        """Shifted positions must still shape the causal mask alongside
        an additive bias."""
        b, h, s, d = 1, 2, 64, 32
        q, k, v = (rand(i + 40, (b, h, s, d)) for i in range(3))
        bias = jnp.zeros((1, 1, s, s))
        pos_q = jnp.arange(s)[None] + 32  # queries live 32 tokens later
        pos_k = jnp.arange(s)[None]
        # convention (see parallel/ring.py allgather): positions REPLACE
        # is_causal — the mask is kv_pos <= q_pos in shifted coordinates
        o = sa.sageattn(
            q, k, v, attn_bias=bias,
            q_positions=pos_q, kv_positions=pos_k,
        )
        # reference: causal in the SHIFTED coordinates
        mask = pos_k[0][None, :] <= pos_q[0][:, None]
        o_ref = reference.attention_reference(
            q, k, v, attn_mask=mask[None, None]
        )
        assert cosine(o, o_ref) > 0.9999

    def test_float_mask_is_additive_bias(self):
        q = jax.random.normal(jax.random.PRNGKey(4), (1, 2, 128, 64))
        k = jax.random.normal(jax.random.PRNGKey(5), (1, 2, 128, 64))
        v = jax.random.normal(jax.random.PRNGKey(6), (1, 2, 128, 64))
        bias = jax.random.normal(jax.random.PRNGKey(7), (1, 1, 128, 128))
        o = sa.sageattn(q, k, v, attn_mask=bias)
        o_ref = reference.attention_reference(q, k, v, attn_bias=bias)
        assert cosine(o, o_ref) > 0.999

    def test_bias_causal_multistep(self):
        """Additive bias + causal over several KV chunks."""
        q = jax.random.normal(jax.random.PRNGKey(50), (1, 2, 512, 64))
        k = jax.random.normal(jax.random.PRNGKey(51), (1, 2, 512, 64))
        v = jax.random.normal(jax.random.PRNGKey(52), (1, 2, 512, 64))
        bias = jax.random.normal(
            jax.random.PRNGKey(53), (1, 2, 512, 512)
        ) * 2.0
        o = sa.sageattn(
            q, k, v, attn_bias=bias, is_causal=True,
            block_q=128, block_k=128, pv_dtype="bf16",
        )
        o_ref = reference.attention_reference(
            q, k, v, attn_bias=bias, is_causal=True
        )
        assert cosine(o, o_ref) > 0.999

    def test_bias_neg_inf_acts_as_mask(self):
        """-inf bias entries drop scores; fully -inf rows produce exact
        zero output (not NaN)."""
        q = jax.random.normal(jax.random.PRNGKey(54), (1, 2, 128, 64))
        k = jax.random.normal(jax.random.PRNGKey(55), (1, 2, 128, 64))
        v = jax.random.normal(jax.random.PRNGKey(56), (1, 2, 128, 64))
        keep = jax.random.bernoulli(
            jax.random.PRNGKey(57), 0.7, (1, 1, 128, 128)
        )
        bias = jnp.where(keep, 0.0, -jnp.inf)
        bias = bias.at[:, :, 5, :].set(-jnp.inf)  # fully-dead q row
        o = sa.sageattn(q, k, v, attn_bias=bias, pv_dtype="bf16")
        o_ref = reference.attention_reference(
            q, k, v, attn_mask=keep
        )
        live = jnp.asarray(keep[0, 0].any(axis=-1)).at[5].set(False)
        assert cosine(o[:, :, live], o_ref[:, :, live]) > 0.999
        assert float(jnp.max(jnp.abs(o[:, :, 5]))) == 0.0
        assert not bool(jnp.any(jnp.isnan(o)))

    def test_bias_odd_lengths_padding(self):
        """Bias + ragged sequence padding: pad KV columns must stay
        dead (the id-form pad mask coexists with the bias)."""
        q = jax.random.normal(jax.random.PRNGKey(58), (1, 2, 200, 64))
        k = jax.random.normal(jax.random.PRNGKey(59), (1, 2, 170, 64))
        v = jax.random.normal(jax.random.PRNGKey(60), (1, 2, 170, 64))
        bias = jax.random.normal(
            jax.random.PRNGKey(61), (1, 1, 200, 170)
        ) * 2.0
        o = sa.sageattn(q, k, v, attn_bias=bias, pv_dtype="bf16")
        o_ref = reference.attention_reference(q, k, v, attn_bias=bias)
        assert cosine(o, o_ref) > 0.999

    def test_bias_with_bool_mask(self):
        """Both mask forms together: bool mask gates, bias shifts."""
        q = jax.random.normal(jax.random.PRNGKey(62), (1, 2, 128, 64))
        k = jax.random.normal(jax.random.PRNGKey(63), (1, 2, 128, 64))
        v = jax.random.normal(jax.random.PRNGKey(64), (1, 2, 128, 64))
        mask = jax.random.bernoulli(
            jax.random.PRNGKey(65), 0.8, (1, 1, 128, 128)
        )
        bias = jax.random.normal(jax.random.PRNGKey(66), (1, 1, 128, 128))
        o = sa.sageattn(
            q, k, v, attn_mask=mask, attn_bias=bias, pv_dtype="bf16"
        )
        o_ref = reference.attention_reference(
            q, k, v, attn_mask=mask, attn_bias=bias
        )
        assert cosine(o, o_ref) > 0.999


class TestFeatureInteractions:
    """Cross-feature coverage: rowsum lane (hd<=64) x causal x segments."""

    def test_hd64_causal_segments(self):
        q = jax.random.normal(jax.random.PRNGKey(0), (1, 2, 300, 64))
        k = jax.random.normal(jax.random.PRNGKey(1), (1, 2, 300, 64))
        v = jax.random.normal(jax.random.PRNGKey(2), (1, 2, 300, 64))
        seg = (jnp.arange(300) // 150).astype(jnp.int32)[None]
        o = sa.sageattn(
            q, k, v, is_causal=True,
            q_segment_ids=seg, kv_segment_ids=seg,
        )
        o_ref = reference.attention_reference(
            q, k, v, is_causal=True, q_segment_ids=seg, kv_segment_ids=seg
        )
        assert cosine(o, o_ref) > 0.999

    def test_hd32_gqa_smooth_v(self):
        q = jax.random.normal(jax.random.PRNGKey(3), (1, 4, 256, 32))
        k = jax.random.normal(jax.random.PRNGKey(4), (1, 2, 256, 32))
        v = jax.random.normal(jax.random.PRNGKey(5), (1, 2, 256, 32)) + 2.0
        o = sa.sageattn(q, k, v, smooth_v=True)
        o_ref = reference.attention_reference(q, k, v)
        assert cosine(o, o_ref) > 0.999

    def test_varlen_causal(self):
        total, h, d = 512, 2, 64
        q = jax.random.normal(jax.random.PRNGKey(6), (total, h, d))
        k = jax.random.normal(jax.random.PRNGKey(7), (total, h, d))
        v = jax.random.normal(jax.random.PRNGKey(8), (total, h, d))
        cu = jnp.array([0, 200, 512], jnp.int32)
        o = sa.sageattn_varlen(q, k, v, cu, cu, is_causal=True)
        # oracle per segment
        import numpy as _np
        for lo, hi in [(0, 200), (200, 512)]:
            qs = jnp.swapaxes(q[lo:hi], 0, 1)[None]
            ks = jnp.swapaxes(k[lo:hi], 0, 1)[None]
            vs = jnp.swapaxes(v[lo:hi], 0, 1)[None]
            ref = reference.attention_reference(qs, ks, vs, is_causal=True)
            got = jnp.swapaxes(o[lo:hi], 0, 1)[None]
            assert cosine(got, ref) > 0.999


class TestSmoothQ:
    """SageAttention2's Q-mean smoothing (per-column score correction)."""

    def _biased_inputs(self):
        # Q with large per-channel means: the case smooth_q exists for
        q = jax.random.normal(jax.random.PRNGKey(0), (1, 2, 256, 64))
        q = q + jnp.linspace(-6, 6, 64)[None, None, None, :]
        k = jax.random.normal(jax.random.PRNGKey(1), (1, 2, 256, 64))
        v = jax.random.normal(jax.random.PRNGKey(2), (1, 2, 256, 64))
        return q, k, v

    def test_matches_reference(self):
        q, k, v = self._biased_inputs()
        o = sa.sageattn(q, k, v, smooth_q=True)
        o_ref = reference.attention_reference(q, k, v)
        assert cosine(o, o_ref) > 0.999

    def test_improves_accuracy_on_biased_q(self):
        q, k, v = self._biased_inputs()
        o_ref = reference.attention_reference(q, k, v)
        c_plain = cosine(sa.sageattn(q, k, v), o_ref)
        c_smooth = cosine(sa.sageattn(q, k, v, smooth_q=True), o_ref)
        assert c_smooth >= c_plain - 1e-6

    def test_with_causal_and_gqa(self):
        q, k, v = self._biased_inputs()
        k, v = k[:, :1], v[:, :1]
        o = sa.sageattn(q, k, v, is_causal=True, smooth_q=True)
        o_ref = reference.attention_reference(q, k, v, is_causal=True)
        assert cosine(o, o_ref) > 0.999

    def test_matches_xla_oracle_path(self):
        q, k, v = self._biased_inputs()
        o = sa.sageattn(q, k, v, smooth_q=True)
        o_x = sa.sageattn(q, k, v, smooth_q=True, impl="xla")
        np.testing.assert_allclose(
            np.asarray(o, np.float32), np.asarray(o_x, np.float32),
            atol=3e-2,
        )


class TestSlidingWindow:
    """Causal sliding-window attention (Mistral/Gemma-style): key j
    visible iff q - window < j <= q; band masks per KV chunk."""

    def _band_ref(self, q, k, v, w):
        sq, sk = q.shape[2], k.shape[2]
        band = (jnp.arange(sk)[None, :] > jnp.arange(sq)[:, None] - w)
        return reference.attention_reference(
            q, k, v, is_causal=True, attn_mask=band[None, None]
        )

    def test_window_matches_reference(self):
        q, k, v = (rand(i + 200, (1, 2, 512, 64)) for i in range(3))
        o = sa.sageattn(q, k, v, is_causal=True, window=100,
                        pv_dtype="bf16")
        assert cosine(o, self._band_ref(q, k, v, 100)) > 0.999

    def test_window_multistep_block_skip(self):
        """Window smaller than a KV block at a multi-block grid: blocks
        outside the band must skip without changing results."""
        q, k, v = (rand(i + 210, (1, 2, 2048, 64)) for i in range(3))
        o = sa.sageattn(q, k, v, is_causal=True, window=300,
                        pv_dtype="bf16", block_q=256, block_k=256)
        assert cosine(o, self._band_ref(q, k, v, 300)) > 0.999

    def test_window_diag_split_interior_blocks(self):
        """Window wide enough (W > 2*block) that the diagonal-split path
        runs fully-unmasked interior blocks between the two band edges;
        checks interior / edge / dead-block classification at equal
        Q/KV blocks."""
        q, k, v = (rand(i + 240, (1, 2, 2048, 64)) for i in range(3))
        o = sa.sageattn(q, k, v, is_causal=True, window=1024,
                        pv_dtype="bf16", block_q=256, block_k=256)
        assert cosine(o, self._band_ref(q, k, v, 1024)) > 0.999

    def test_window_gqa_gradients(self):
        q = rand(220, (1, 4, 256, 64))
        k, v = rand(221, (1, 2, 256, 64)), rand(222, (1, 2, 256, 64))

        def loss(q, k, v):
            return jnp.sum(
                sa.sageattn(q, k, v, is_causal=True, window=64,
                            pv_dtype="bf16") ** 2
            )

        def loss_ref(q, k, v):
            kr, vr = (jnp.repeat(x, 2, axis=1) for x in (k, v))
            return jnp.sum(self._band_ref(q, kr, vr, 64) ** 2)

        g = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
        g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        for a, r in zip(g, g_ref):
            assert cosine(a, r) > 0.99

    def test_window_requires_causal(self):
        q, k, v = (rand(i + 230, (1, 1, 128, 64)) for i in range(3))
        with pytest.raises(ValueError, match="window"):
            sa.sageattn(q, k, v, window=32)

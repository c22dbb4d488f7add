"""Model-layer tests: backend switching, DiT / LLM forward, output parity.

The reference's end-to-end check is "generate a video and look at it"
(SURVEY.md §4.5); here it is quantitative: the DiT forward with sage
attention must stay close (cosine) to the same weights run with exact
attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sageattention_jax import models
from sageattention_jax.models.configs import MODEL_CONFIGS


def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def tiny_dit():
    cfg = MODEL_CONFIGS["cogvideox-2b"].scaled(
        depth=2, latent_frames=2, latent_height=16, latent_width=16,
        text_len=16, hidden=256, heads=4, head_dim=64,
    )
    model = models.VideoDiT(cfg)
    lat = jax.random.normal(jax.random.PRNGKey(0), (1, 2, 16, 16, 16), jnp.bfloat16)
    txt = jax.random.normal(jax.random.PRNGKey(1), (1, 16, 512))
    t = jnp.array([500])
    params = model.init(jax.random.PRNGKey(2), lat, txt, t)
    return model, params, (lat, txt, t)


class TestBackendSwitch:
    def test_registry(self):
        models.set_attention_backend("sdpa")
        assert models.get_attention_backend() == "sdpa"
        models.set_attention_backend("sage")
        assert models.get_attention_backend() == "sage"

    def test_unknown_backend(self):
        with pytest.raises(ValueError):
            models.set_attention_backend("cuda")


class TestFlaxAttentionFn:
    """sage_attention_fn plugs into flax's nn.MultiHeadDotProductAttention
    (the flax-native analogue of the reference's SDPA monkey-patch)."""

    def _mha(self, attention_fn=None):
        import flax.linen as nn

        kw = {"attention_fn": attention_fn} if attention_fn else {}
        return nn.MultiHeadDotProductAttention(
            num_heads=4, qkv_features=256, deterministic=True, **kw
        )

    def test_matches_flax_default(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (2, 128, 256))
        ref_mha = self._mha()
        params = ref_mha.init(jax.random.PRNGKey(1), x)
        ref = ref_mha.apply(params, x)
        out = self._mha(models.sage_attention_fn).apply(params, x)
        assert out.shape == ref.shape
        assert cosine(out, ref) > 0.999

    def test_padding_mask(self):
        import flax.linen as nn

        x = jax.random.normal(jax.random.PRNGKey(2), (2, 128, 256))
        lengths = jnp.array([96, 128])
        valid = jnp.arange(128)[None] < lengths[:, None]  # [b, sk]
        mask = nn.make_attention_mask(valid, valid)  # [b, 1, sq, sk]
        ref_mha = self._mha()
        params = ref_mha.init(jax.random.PRNGKey(3), x)
        ref = ref_mha.apply(params, x, mask=mask)
        out = self._mha(models.sage_attention_fn).apply(
            params, x, mask=mask
        )
        valid_rows = np.asarray(valid)[:, :, None]
        assert (
            cosine(
                np.asarray(out) * valid_rows, np.asarray(ref) * valid_rows
            )
            > 0.999
        )

    def test_direct_call_causal_and_bias(self):
        q = jax.random.normal(jax.random.PRNGKey(4), (2, 64, 4, 64))
        k = jax.random.normal(jax.random.PRNGKey(5), (2, 64, 4, 64))
        v = jax.random.normal(jax.random.PRNGKey(6), (2, 64, 4, 64))
        import flax.linen as nn

        ref = nn.dot_product_attention(
            q, k, v,
            mask=nn.make_causal_mask(jnp.zeros((2, 64))),
        )
        out = models.sage_attention_fn(q, k, v, is_causal=True)
        assert cosine(out, ref) > 0.999
        bias = jax.random.normal(jax.random.PRNGKey(7), (1, 1, 64, 64))
        ref_b = nn.dot_product_attention(q, k, v, bias=bias)
        out_b = models.sage_attention_fn(q, k, v, bias=bias)
        assert cosine(out_b, ref_b) > 0.999

    def test_dropout_rejected(self):
        q = jax.random.normal(jax.random.PRNGKey(8), (1, 64, 2, 64))
        with pytest.raises(NotImplementedError):
            models.sage_attention_fn(
                q, q, q, dropout_rate=0.1, deterministic=False
            )


class TestVideoDiT:
    def test_forward_shape(self, tiny_dit):
        model, params, (lat, txt, t) = tiny_dit
        out = model.apply(params, lat, txt, t)
        assert out.shape == lat.shape

    def test_sage_vs_exact_parity(self, tiny_dit):
        """The 'lossless video' claim, made quantitative (reference:
        example/README.md:22)."""
        model, params, (lat, txt, t) = tiny_dit
        models.set_attention_backend("reference")
        out_ref = model.apply(params, lat, txt, t)
        models.set_attention_backend("sage")
        out_sage = model.apply(params, lat, txt, t)
        assert cosine(out_sage, out_ref) > 0.999

    def test_processor_injection(self, tiny_dit):
        _, params, (lat, txt, t) = tiny_dit
        cfg = MODEL_CONFIGS["cogvideox-2b"].scaled(
            depth=2, latent_frames=2, latent_height=16, latent_width=16,
            text_len=16, hidden=256, heads=4, head_dim=64,
        )
        proc = models.SageAttnProcessor(backend="sage_bf16")
        model2 = models.VideoDiT(cfg, processor=proc)
        out = model2.apply(params, lat, txt, t)
        assert out.shape == lat.shape


class TestCausalLM:
    def test_prefill_parity(self):
        cfg = MODEL_CONFIGS["llm-8b-gqa"].scaled(
            depth=2, hidden=256, heads=8, kv_heads=2, head_dim=32,
            vocab=1000, mlp_hidden=512,
        )
        model = models.CausalLM(cfg)
        toks = jax.random.randint(jax.random.PRNGKey(0), (2, 256), 0, 1000)
        params = model.init(jax.random.PRNGKey(1), toks)
        models.set_attention_backend("reference")
        logits_ref = model.apply(params, toks)
        models.set_attention_backend("sage")
        logits_sage = model.apply(params, toks)
        assert cosine(logits_sage, logits_ref) > 0.999
        # Strict causality check on the exact backend.  (The quantized
        # path is causal in its attention pattern but its quantization
        # statistics — K mean, per-channel V scales — are whole-sequence,
        # so later tokens perturb earlier logits at quant-error magnitude;
        # the reference shares this property, see its global-km caveat at
        # reference core.py:462.)
        models.set_attention_backend("reference")
        logits_ref1 = model.apply(params, toks)
        toks2 = toks.at[:, 200].set((toks[:, 200] + 1) % 1000)
        logits_ref2 = model.apply(params, toks2)
        models.set_attention_backend("sage")
        np.testing.assert_allclose(
            np.asarray(logits_ref2[:, :150], np.float32),
            np.asarray(logits_ref1[:, :150], np.float32),
            atol=1e-3,
        )
        # and the quantized path stays within quant-noise of itself
        logits_sage2 = model.apply(params, toks2)
        assert cosine(logits_sage2[:, :150], logits_sage[:, :150]) > 0.999

    def test_decode_without_cache_raises(self):
        cfg = MODEL_CONFIGS["llm-8b-gqa"].scaled(
            depth=1, hidden=128, heads=4, kv_heads=2, head_dim=32,
            vocab=100, mlp_hidden=256,
        )
        model = models.CausalLM(cfg)
        toks = jax.random.randint(jax.random.PRNGKey(0), (1, 4), 0, 100)
        params = model.init(jax.random.PRNGKey(1), toks)
        with pytest.raises(ValueError, match="decode=True requires"):
            model.apply(params, toks, decode=True)

    def test_prefill_lengths_default_to_zeros(self):
        """The advertised prefill form — caches given, lengths omitted —
        behaves exactly like explicit zero lengths."""
        cfg = MODEL_CONFIGS["llm-8b-gqa"].scaled(
            depth=1, hidden=128, heads=4, kv_heads=2, head_dim=32,
            vocab=100, mlp_hidden=256,
        )
        model = models.CausalLM(cfg)
        toks = jax.random.randint(jax.random.PRNGKey(0), (2, 64), 0, 100)
        params = model.init(jax.random.PRNGKey(1), toks)
        models.set_attention_backend("sage")
        c1 = model.init_caches(2, 128)
        c2 = model.init_caches(2, 128)
        lo1, cc1 = model.apply(params, toks, caches=c1)
        lo2, cc2 = model.apply(
            params, toks, caches=c2, lengths=jnp.zeros((2,), jnp.int32)
        )
        np.testing.assert_array_equal(np.asarray(lo1), np.asarray(lo2))
        np.testing.assert_array_equal(
            np.asarray(cc1[0].k_i8), np.asarray(cc2[0].k_i8)
        )

    def test_windowed_prefill_matches_windowed_decode_backends(self):
        """A windowed config answers identically (up to quant noise)
        whether the baseline backend computes prefill or the sage path
        does — guards against a backend silently dropping `window`."""
        cfg = MODEL_CONFIGS["llm-8b-gqa"].scaled(
            depth=1, hidden=128, heads=4, kv_heads=2, head_dim=32,
            vocab=100, mlp_hidden=256, window=32,
        )
        model = models.CausalLM(cfg)
        toks = jax.random.randint(jax.random.PRNGKey(0), (1, 128), 0, 100)
        params = model.init(jax.random.PRNGKey(1), toks)
        models.set_attention_backend("sage")
        lo_sage = model.apply(params, toks)
        models.set_attention_backend("sdpa")
        lo_sdpa = model.apply(params, toks)
        models.set_attention_backend("sage")
        # both honor window=32: identical pattern, quant-level noise
        assert cosine(lo_sage, lo_sdpa) > 0.999
        # and sdpa's window actually masks: a full-causal sdpa differs
        cfg_full = cfg.scaled(window=None)
        model_full = models.CausalLM(cfg_full)
        models.set_attention_backend("sdpa")
        lo_full = model_full.apply(params, toks)
        models.set_attention_backend("sage")
        assert float(np.max(np.abs(
            np.asarray(lo_full[:, -1], np.float32)
            - np.asarray(lo_sdpa[:, -1], np.float32)
        ))) > 1e-3

    def test_temporal_patch_model_roundtrip(self):
        """CogVideoX-1.5-style temporal patching (patch_t=2): the trunk
        patchifies/unpatchifies consistently and the token count matches
        the config's video_tokens."""
        cfg = MODEL_CONFIGS["cogvideox1.5-5b"].scaled(
            depth=1, latent_frames=4, latent_height=8, latent_width=8,
            text_len=8, hidden=64, heads=2, head_dim=32,
        )
        assert cfg.patch_t == 2
        assert cfg.video_tokens == (4 // 2) * 4 * 4
        model = models.VideoDiT(cfg)
        lat = jax.random.normal(jax.random.PRNGKey(0), (1, 4, 8, 8, 16))
        txt = jax.random.normal(jax.random.PRNGKey(1), (1, 8, 512))
        t = jnp.array([500])
        models.set_attention_backend("sage")
        params = model.init(jax.random.PRNGKey(2), lat, txt, t)
        out = model.apply(params, lat, txt, t)
        assert out.shape == lat.shape
        assert np.isfinite(np.asarray(out, np.float32)).all()
        # pos_embed sized to the patched token count
        pos = params["params"]["pos_embed"]
        assert pos.shape[1] == cfg.video_tokens

    def test_all_configs_instantiate(self):
        for name, cfg in MODEL_CONFIGS.items():
            assert cfg.name == name
            if hasattr(cfg, "video_tokens"):
                assert cfg.seq_len > cfg.text_len


class TestArchitectureVariants:
    """Dual-stream MMDiT (HunyuanVideo/Mochi) and cross-attention (Wan)."""

    def _inputs(self, cfg, b=1):
        lat = jax.random.normal(
            jax.random.PRNGKey(0),
            (b, cfg.latent_frames, cfg.latent_height, cfg.latent_width, 16),
            jnp.bfloat16,
        )
        txt = jax.random.normal(
            jax.random.PRNGKey(1), (b, cfg.text_len, 512), jnp.bfloat16
        )
        return lat, txt, jnp.array([500] * b)

    def test_dual_stream_runs_and_matches_sdpa(self):
        cfg = MODEL_CONFIGS["hunyuanvideo"].scaled(
            depth=2, latent_frames=2, latent_height=8, latent_width=8,
            text_len=16, hidden=128, heads=2, head_dim=64,
        )
        model = models.DualStreamVideoDiT(cfg)
        lat, txt, t = self._inputs(cfg)
        params = model.init(jax.random.PRNGKey(2), lat, txt, t)
        models.set_attention_backend("sage")
        out = model.apply(params, lat, txt, t)
        models.set_attention_backend("sdpa")
        ref = model.apply(params, lat, txt, t)
        models.set_attention_backend("sage")
        assert out.shape == lat.shape
        assert cosine(out, ref) > 0.999

    def test_cross_attn_runs_and_matches_sdpa(self):
        cfg = MODEL_CONFIGS["wan2.1-t2v-1.3b"].scaled(
            depth=2, latent_frames=2, latent_height=8, latent_width=8,
            text_len=16, hidden=128, heads=2, head_dim=64,
        )
        model = models.CrossAttnVideoDiT(cfg)
        lat, txt, t = self._inputs(cfg)
        params = model.init(jax.random.PRNGKey(2), lat, txt, t)
        models.set_attention_backend("sage")
        out = model.apply(params, lat, txt, t)
        models.set_attention_backend("sdpa")
        ref = model.apply(params, lat, txt, t)
        models.set_attention_backend("sage")
        assert out.shape == lat.shape
        assert cosine(out, ref) > 0.999

"""Decode attention over the quantized KV cache (beyond the reference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sageattention_jax import kvcache


def rand(key, shape, dtype=jnp.float32):
    return jax.random.normal(jax.random.PRNGKey(key), shape).astype(dtype)


def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def oracle(qb, kb, vb, group):
    """[hq, t, d] x [hkv, L, d] fp32 decode oracle."""
    kr = jnp.repeat(kb, group, axis=0).astype(jnp.float32)
    vr = jnp.repeat(vb, group, axis=0).astype(jnp.float32)
    d = qb.shape[-1]
    s = jnp.einsum("hqd,hkd->hqk", qb.astype(jnp.float32), kr) * d**-0.5
    return jnp.einsum("hqk,hkd->hqd", jax.nn.softmax(s, axis=-1), vr)


class TestDecode:
    def test_ragged_lengths_gqa(self):
        b, hq, hkv, d, S = 2, 8, 2, 64, 512
        cache = kvcache.init_kv_cache(b, hkv, S, d)
        lengths = jnp.zeros((b,), jnp.int32)
        k = rand(1, (b, hkv, 300, d))
        v = rand(2, (b, hkv, 300, d))
        cache, lengths = kvcache.append_kv(cache, lengths, k, v)
        # batch 1 logically holds only 200 tokens
        lengths = jnp.array([300, 200], jnp.int32)
        q = rand(3, (b, hq, 1, d))
        o = kvcache.sageattn_decode(q, cache, lengths)
        assert o.shape == (b, hq, 1, d)
        for bi, L in enumerate([300, 200]):
            ref = oracle(q[bi], k[bi, :, :L], v[bi, :, :L], hq // hkv)
            assert cosine(o[bi], ref) > 0.999

    def test_int4_cache_matches_oracle(self):
        """bits=4 cache (nibble-packed int8, half the HBM bytes):
        coarser ±7 levels still track the fp32 oracle, just looser
        than int8."""
        b, hq, hkv, d, S = 2, 8, 2, 64, 512
        cache = kvcache.init_kv_cache(b, hkv, S, d, bits=4)
        # packed storage: two TOKENS per int8 byte, never jnp.int4 at
        # rest (the dtype cannot cross jit boundaries on this backend)
        assert cache.bits == 4
        assert cache.k_i8.dtype == jnp.int8
        assert cache.k_i8.shape[2] == S // 2
        assert cache.k_i8.shape[-1] == d
        lengths = jnp.zeros((b,), jnp.int32)
        k = rand(1, (b, hkv, 300, d))
        v = rand(2, (b, hkv, 300, d))
        cache, lengths = kvcache.append_kv(cache, lengths, k, v)
        q = rand(3, (b, hq, 1, d))
        o = kvcache.sageattn_decode(q, cache, lengths)
        for bi in range(b):
            ref = oracle(q[bi], k[bi], v[bi], hq // hkv)
            # ±7 levels on zero-mean gaussian data lands ~0.988; real
            # (channel-biased) data with calibrate() exceeds 0.999 —
            # see test_calibrated_means_rescue_channel_bias
            assert cosine(o[bi], ref) > 0.98

    def test_nibble_pack_roundtrip(self):
        """pack_token_pairs / unpack_token_pairs are exact inverses over
        the whole [-8, 7] nibble range, with tokens in natural order."""
        rng = np.random.default_rng(7)
        x = rng.integers(-8, 8, size=(16, 128)).astype(np.int8)
        packed = kvcache.pack_token_pairs(jnp.asarray(x))
        assert packed.shape == (8, 128) and packed.dtype == jnp.int8
        out = np.asarray(kvcache.unpack_token_pairs(packed))
        np.testing.assert_array_equal(out, x)
        # token 2t sits in the low nibble of byte t, 2t+1 in the high one
        np.testing.assert_array_equal(
            np.asarray(packed[0]).astype(np.int32) & 0x0F, x[0] & 0x0F
        )

    def test_packed_write_parity(self):
        """write_rows_packed: odd offsets, odd lengths, out-of-range
        (negative / past-end) rows — every nibble a write shares a byte
        with survives, every in-range row lands at its position."""
        h, S, d = 2, 32, 8
        rng = np.random.default_rng(3)
        base = rng.integers(-7, 8, size=(h, S, d)).astype(np.int8)
        buf = kvcache.pack_token_pairs(jnp.asarray(base))
        for off, w in [(0, 4), (1, 4), (3, 5), (-2, 6), (29, 5), (31, 2),
                       (-6, 3), (40, 4)]:
            rows = rng.integers(-7, 8, size=(h, w, d)).astype(np.int8)
            got = kvcache.write_rows_packed(
                buf, jnp.asarray(rows), jnp.int32(off)
            )
            exp = base.copy()
            for j in range(w):
                if 0 <= off + j < S:
                    exp[:, off + j] = rows[:, j]
            np.testing.assert_array_equal(
                np.asarray(kvcache.unpack_token_pairs(got)), exp,
                err_msg=f"off={off} w={w}",
            )

    def test_int4_paged_matches_int4_dense(self):
        """Paged int4 pool: same numerics as the dense int4 cache."""
        b, hq, hkv, d, S, page = 2, 4, 2, 64, 512, 128
        k = rand(21, (b, hkv, S, d))
        v = rand(22, (b, hkv, S, d))
        q = rand(23, (b, hq, 1, d))
        lengths = jnp.array([S, 300], jnp.int32)

        dense = kvcache.init_kv_cache(b, hkv, S, d, bits=4)
        dense, _ = kvcache.append_kv(
            dense, jnp.zeros((b,), jnp.int32), k, v
        )
        o_dense = kvcache.sageattn_decode(q, dense, lengths)

        n_pages = b * (S // page)
        table = jnp.arange(n_pages, dtype=jnp.int32).reshape(
            b, S // page
        )
        paged = kvcache.init_paged_kv_cache(
            n_pages, hkv, d, table, page_size=page, bits=4
        )
        paged, _ = kvcache.paged_prefill(paged, k, v)
        o_paged = kvcache.sageattn_paged_decode(q, paged, lengths)
        np.testing.assert_allclose(
            np.asarray(o_dense, np.float32),
            np.asarray(o_paged, np.float32), atol=2e-2, rtol=0,
        )

    def test_calibrated_means_rescue_channel_bias(self):
        """Fixed per-channel mean subtraction (calibrate): the K shift
        is softmax-invariant and the V shift adds back exactly, so
        calibration must sharply improve int4 accuracy on
        channel-biased K/V — and int8 must stay accurate with the means
        active (the corrections are exact, not approximations)."""
        b, hq, hkv, d, L, S = 1, 4, 2, 64, 300, 512
        bias = 4.0 * jax.random.normal(
            jax.random.PRNGKey(7), (1, hkv, 1, d)
        )
        k = rand(1, (b, hkv, L, d)) + bias
        v = rand(2, (b, hkv, L, d)) + bias
        q = rand(3, (b, hq, 1, d))
        lengths = jnp.full((b,), L, jnp.int32)
        ref = oracle(q[0], k[0], v[0], hq // hkv)

        def run(bits, cal):
            c = kvcache.init_kv_cache(b, hkv, S, d, bits=bits)
            if cal:
                c = kvcache.calibrate(c, k, v)
            c, _ = kvcache.append_kv(
                c, jnp.zeros((b,), jnp.int32), k, v
            )
            return cosine(kvcache.sageattn_decode(q, c, lengths)[0],
                          ref)

        plain4, cal4 = run(4, False), run(4, True)
        assert cal4 > 0.999, (plain4, cal4)
        assert cal4 > plain4
        assert run(8, True) > 0.9999

    def test_incremental_append_equals_prefill(self):
        """Appending token-by-token must equal one prefill append (the
        per-token scales make appends exact, no requantization)."""
        b, hkv, d, S = 1, 2, 32, 256
        k = rand(10, (b, hkv, 10, d))
        v = rand(11, (b, hkv, 10, d))
        c1 = kvcache.init_kv_cache(b, hkv, S, d)
        c1, l1 = kvcache.append_kv(c1, jnp.zeros((b,), jnp.int32), k, v)
        c2 = kvcache.init_kv_cache(b, hkv, S, d)
        l2 = jnp.zeros((b,), jnp.int32)
        for t in range(10):
            c2, l2 = kvcache.append_kv(
                c2, l2, k[:, :, t:t + 1], v[:, :, t:t + 1]
            )
        np.testing.assert_array_equal(np.asarray(c1.k_i8),
                                      np.asarray(c2.k_i8))
        np.testing.assert_array_equal(np.asarray(c1.v_i8),
                                      np.asarray(c2.v_i8))
        np.testing.assert_allclose(np.asarray(c1.k_scale),
                                   np.asarray(c2.k_scale), rtol=1e-7)
        assert bool(jnp.all(l1 == l2))

    def test_multi_token_causal_tail(self):
        """t_q > 1 (speculative / chunked decode): row t attends keys
        < length - t_q + 1 + t."""
        b, hq, hkv, d, S, L, T = 1, 4, 2, 64, 256, 100, 4
        cache = kvcache.init_kv_cache(b, hkv, S, d)
        k = rand(20, (b, hkv, L, d))
        v = rand(21, (b, hkv, L, d))
        cache, lengths = kvcache.append_kv(
            cache, jnp.zeros((b,), jnp.int32), k, v
        )
        q = rand(22, (b, hq, T, d))
        o = kvcache.sageattn_decode(q, cache, lengths)
        for t in range(T):
            Lt = L - (T - 1) + t
            ref = oracle(q[0, :, t:t + 1], k[0, :, :Lt], v[0, :, :Lt],
                         hq // hkv)
            assert cosine(o[0, :, t:t + 1], ref) > 0.999, f"t={t}"

    def test_decode_loop_matches_full_attention(self):
        """A miniature serving loop: prefill then 4 decode steps; each
        step's output matches full causal attention's last row."""
        from sageattention_jax.ops import reference

        b, hq, hkv, d, S = 1, 4, 4, 32, 128
        n_prefill, n_steps = 20, 4
        keys = rand(30, (b, hkv, n_prefill + n_steps, d))
        vals = rand(31, (b, hkv, n_prefill + n_steps, d))
        qs = rand(32, (b, hq, n_prefill + n_steps, d))

        cache = kvcache.init_kv_cache(b, hkv, S, d)
        cache, lengths = kvcache.append_kv(
            cache, jnp.zeros((b,), jnp.int32),
            keys[:, :, :n_prefill], vals[:, :, :n_prefill],
        )
        for t in range(n_prefill, n_prefill + n_steps):
            cache, lengths = kvcache.append_kv(
                cache, lengths, keys[:, :, t:t + 1], vals[:, :, t:t + 1]
            )
            o = kvcache.sageattn_decode(
                qs[:, :, t:t + 1], cache, lengths
            )
            ref = oracle(
                qs[0, :, t:t + 1], keys[0, :, :t + 1], vals[0, :, :t + 1],
                hq // hkv,
            )
            assert cosine(o[0], ref) > 0.999, f"step {t}"


class TestWindowedDecode:
    """Sliding-window decode: only the last `window` keys attend, and
    the kernel reads only the chunks the window reaches."""

    def test_window_matches_truncated_oracle(self):
        b, hq, hkv, d, S, W = 2, 8, 2, 64, 1024, 200
        cache = kvcache.init_kv_cache(b, hkv, S, d)
        lengths = jnp.zeros((b,), jnp.int32)
        k = rand(40, (b, hkv, 700, d))
        v = rand(41, (b, hkv, 700, d))
        cache, lengths = kvcache.append_kv(cache, lengths, k, v)
        lengths = jnp.array([700, 350], jnp.int32)
        q = rand(42, (b, hq, 1, d))
        o = kvcache.sageattn_decode(q, cache, lengths, window=W)
        for bi, L in enumerate([700, 350]):
            ref = oracle(
                q[bi], k[bi, :, L - W:L], v[bi, :, L - W:L], hq // hkv
            )
            assert cosine(o[bi], ref) > 0.999, bi

    def test_window_multitoken_causal_tail(self):
        """t_q > 1: each query row's window slides with its position."""
        b, hq, hkv, d, S, W, t = 1, 4, 2, 32, 512, 100, 3
        cache = kvcache.init_kv_cache(b, hkv, S, d)
        lengths = jnp.zeros((b,), jnp.int32)
        k = rand(43, (b, hkv, 300, d))
        v = rand(44, (b, hkv, 300, d))
        cache, lengths = kvcache.append_kv(cache, lengths, k, v)
        q = rand(45, (b, hq, t, d))
        o = kvcache.sageattn_decode(q, cache, lengths, window=W)
        L = 300
        for ti in range(t):
            p = L - t + ti  # this query row's position (0-indexed)
            ref = oracle(
                q[0, :, ti:ti + 1],
                k[0, :, p + 1 - W:p + 1],
                v[0, :, p + 1 - W:p + 1],
                hq // hkv,
            )
            assert cosine(o[0, :, ti], ref[:, 0]) > 0.999, ti

    def test_window_wider_than_context_equals_full(self):
        b, hq, hkv, d, S = 1, 4, 2, 32, 256
        cache = kvcache.init_kv_cache(b, hkv, S, d)
        lengths = jnp.zeros((b,), jnp.int32)
        k = rand(46, (b, hkv, 150, d))
        v = rand(47, (b, hkv, 150, d))
        cache, lengths = kvcache.append_kv(cache, lengths, k, v)
        q = rand(48, (b, hq, 1, d))
        o_w = kvcache.sageattn_decode(q, cache, lengths, window=4096)
        o_f = kvcache.sageattn_decode(q, cache, lengths)
        np.testing.assert_allclose(
            np.asarray(o_w, np.float32), np.asarray(o_f, np.float32),
            atol=1e-5,
        )

    def test_paged_window_matches_dense_window(self):
        """Windowed decode through scrambled pages == windowed dense."""
        b, hq, hkv, d, S, W, page = 2, 8, 2, 64, 512, 100, 64
        n_pages = S // page
        k = rand(50, (b, hkv, 448, d))
        v = rand(51, (b, hkv, 448, d))
        q = rand(52, (b, hq, 1, d))

        dense = kvcache.init_kv_cache(b, hkv, S, d)
        lengths = jnp.zeros((b,), jnp.int32)
        dense, lengths = kvcache.append_kv(dense, lengths, k, v)
        lengths = jnp.array([448, 320], jnp.int32)
        o_d = kvcache.sageattn_decode(q, dense, lengths, window=W)

        perm = jax.random.permutation(
            jax.random.PRNGKey(53), b * n_pages
        ).reshape(b, n_pages).astype(jnp.int32)
        paged = kvcache.init_paged_kv_cache(
            b * n_pages, hkv, d, perm, page_size=page
        )
        paged, pl_ = kvcache.paged_append(
            paged, jnp.zeros((b,), jnp.int32), k, v
        )
        o_p = kvcache.sageattn_paged_decode(q, paged, lengths, window=W)
        # different chunk partitioning (3 pages of 64 vs one 512 chunk)
        # reorders the online merge, so agreement is fp32-roundoff-level,
        # not bitwise
        assert cosine(o_p, o_d) > 0.9999
        np.testing.assert_allclose(
            np.asarray(o_p, np.float32), np.asarray(o_d, np.float32),
            atol=2e-2,
        )

    @pytest.mark.slow
    def test_windowed_llm_loop_matches_band_refeed(self):
        """CausalLM with cfg.window: the cached decode loop must pick
        the same tokens as re-running windowed prefill each step."""
        from sageattention_jax import models
        from sageattention_jax.models.configs import MODEL_CONFIGS

        cfg = MODEL_CONFIGS["llm-7b"].scaled(
            depth=2, hidden=128, heads=4, kv_heads=2, head_dim=32,
            vocab=128, mlp_hidden=256, window=24,
        )
        model = models.CausalLM(cfg)
        b, n_prompt, n_gen, max_len = 1, 40, 4, 96
        toks = jax.random.randint(
            jax.random.PRNGKey(7), (b, n_prompt), 0, 128
        )
        params = model.init(jax.random.PRNGKey(8), toks)

        caches = model.init_caches(b, max_len)
        lengths = jnp.zeros((b,), jnp.int32)
        logits, caches = model.apply(
            params, toks, caches=caches, lengths=lengths
        )
        lengths = lengths + n_prompt
        seq = toks
        cur = jnp.argmax(logits[:, -1:], axis=-1)
        for _ in range(n_gen):
            seq = jnp.concatenate([seq, cur], axis=1)
            logits_d, caches = model.apply(
                params, cur, caches=caches, lengths=lengths, decode=True
            )
            lengths = lengths + 1
            cur = jnp.argmax(logits_d[:, -1:], axis=-1)

        seq_ref = toks
        for _ in range(n_gen):
            logits_f = model.apply(params, seq_ref)
            nxt = jnp.argmax(logits_f[:, -1:], axis=-1)
            seq_ref = jnp.concatenate([seq_ref, nxt], axis=1)

        np.testing.assert_array_equal(
            np.asarray(seq[:, n_prompt:]),
            np.asarray(seq_ref[:, n_prompt:]),
        )


class TestCachedGeneration:
    @pytest.mark.slow
    def test_decode_loop_matches_refeed(self):
        """Greedy generation with the int8 KV cache must pick the same
        tokens as re-running the full prefill each step."""
        from sageattention_jax import models
        from sageattention_jax.models.configs import MODEL_CONFIGS

        cfg = MODEL_CONFIGS["llm-7b"].scaled(
            depth=2, hidden=128, heads=4, kv_heads=2, head_dim=32,
            vocab=128, mlp_hidden=256,
        )
        model = models.CausalLM(cfg)
        b, n_prompt, n_gen, max_len = 1, 16, 5, 64
        toks = jax.random.randint(
            jax.random.PRNGKey(0), (b, n_prompt), 0, 128
        )
        params = model.init(jax.random.PRNGKey(1), toks)

        # cached path: prefill then token-at-a-time decode
        caches = model.init_caches(b, max_len)
        lengths = jnp.zeros((b,), jnp.int32)
        logits, caches = model.apply(
            params, toks, caches=caches, lengths=lengths
        )
        lengths = lengths + n_prompt
        seq = toks
        cur = jnp.argmax(logits[:, -1:], axis=-1)
        for _ in range(n_gen):
            seq = jnp.concatenate([seq, cur], axis=1)
            logits_d, caches = model.apply(
                params, cur, caches=caches, lengths=lengths, decode=True
            )
            lengths = lengths + 1
            cur = jnp.argmax(logits_d[:, -1:], axis=-1)

        # reference path: re-feed the whole sequence each step
        seq_ref = toks
        for _ in range(n_gen):
            logits_f = model.apply(params, seq_ref)
            nxt = jnp.argmax(logits_f[:, -1:], axis=-1)
            seq_ref = jnp.concatenate([seq_ref, nxt], axis=1)

        np.testing.assert_array_equal(
            np.asarray(seq[:, n_prompt:]), np.asarray(seq_ref[:, n_prompt:])
        )


    @pytest.mark.slow
    def test_paged_loop_matches_dense_loop(self):
        """The generate loop over paged caches (page-table appends +
        scalar-prefetch decode) must produce the same tokens as the
        dense int8-cache loop."""
        from sageattention_jax import models
        from sageattention_jax.models.configs import MODEL_CONFIGS

        cfg = MODEL_CONFIGS["llm-7b"].scaled(
            depth=2, hidden=128, heads=4, kv_heads=2, head_dim=32,
            vocab=128, mlp_hidden=256,
        )
        model = models.CausalLM(cfg)
        b, n_prompt, n_gen, max_len = 2, 12, 5, 64
        toks = jax.random.randint(
            jax.random.PRNGKey(3), (b, n_prompt), 0, 128
        )
        params = model.init(jax.random.PRNGKey(4), toks)

        def run(caches):
            lengths = jnp.zeros((b,), jnp.int32)
            logits, caches = model.apply(
                params, toks, caches=caches, lengths=lengths
            )
            lengths = lengths + n_prompt
            out = []
            cur = jnp.argmax(logits[:, -1:], axis=-1)
            for _ in range(n_gen):
                out.append(cur)
                logits_d, caches = model.apply(
                    params, cur, caches=caches, lengths=lengths,
                    decode=True,
                )
                lengths = lengths + 1
                cur = jnp.argmax(logits_d[:, -1:], axis=-1)
            return np.asarray(jnp.concatenate(out, axis=1))

        dense = run(model.init_caches(b, max_len))
        # scrambled physical pages: permute the default linear table
        n_pages = -(-max_len // 16)
        perm = jax.random.permutation(
            jax.random.PRNGKey(5), b * n_pages
        ).reshape(b, n_pages).astype(jnp.int32)
        paged = run(model.init_paged_caches(
            b, max_len, page_size=16, page_table=perm
        ))
        np.testing.assert_array_equal(dense, paged)


class TestPagedDecode:
    """vLLM-style paged cache: scalar-prefetch page-table gather."""

    def test_scrambled_pages_match_dense(self):
        b, hq, hkv, d, page = 2, 8, 2, 64, 128
        pt = jnp.array([[7, 3, 11, 0], [2, 9, 5, 14]], jnp.int32)
        cache = kvcache.init_paged_kv_cache(16, hkv, d, pt,
                                            page_size=page)
        k = rand(1, (b, hkv, 300, d))
        v = rand(2, (b, hkv, 300, d))
        cache, lengths = kvcache.paged_append(
            cache, jnp.zeros((b,), jnp.int32), k, v
        )
        lengths = jnp.array([300, 200], jnp.int32)
        q = rand(3, (b, hq, 1, d))
        o = kvcache.sageattn_paged_decode(q, cache, lengths)
        for bi, L in enumerate([300, 200]):
            ref = oracle(q[bi], k[bi, :, :L], v[bi, :, :L], hq // hkv)
            assert cosine(o[bi], ref) > 0.999

    def test_paged_prefill_equals_token_appends(self):
        """Page-granular bulk prefill writes the same quantized pages as
        token-granular appends."""
        b, hkv, d, page = 1, 2, 32, 64
        pt = jnp.array([[5, 1, 3, 7]], jnp.int32)
        k = rand(10, (b, hkv, 128, d))
        v = rand(11, (b, hkv, 128, d))
        c1 = kvcache.init_paged_kv_cache(8, hkv, d, pt, page_size=page)
        c1, l1 = kvcache.paged_prefill(c1, k, v)
        c2 = kvcache.init_paged_kv_cache(8, hkv, d, pt, page_size=page)
        c2, l2 = kvcache.paged_append(
            c2, jnp.zeros((b,), jnp.int32), k, v
        )
        np.testing.assert_array_equal(np.asarray(c1.pages_k),
                                      np.asarray(c2.pages_k))
        np.testing.assert_array_equal(np.asarray(c1.pages_v),
                                      np.asarray(c2.pages_v))
        assert bool(jnp.all(l1 == l2))

    def test_paged_decode_step_appends_across_page_boundary(self):
        """Decode appends that cross a page boundary land in the right
        physical page."""
        b, hq, hkv, d, page = 1, 4, 2, 32, 64
        pt = jnp.array([[3, 0, 2, 1]], jnp.int32)
        cache = kvcache.init_paged_kv_cache(4, hkv, d, pt, page_size=page)
        k = rand(20, (b, hkv, 63, d))
        v = rand(21, (b, hkv, 63, d))
        cache, lengths = kvcache.paged_append(
            cache, jnp.zeros((b,), jnp.int32), k, v
        )
        ks, vs_, qs = [k], [v], []
        for t in range(3):  # appends at 63, 64, 65 (boundary at 64)
            kn, vn = rand(30 + t, (b, hkv, 1, d)), rand(40 + t,
                                                        (b, hkv, 1, d))
            cache, lengths = kvcache.paged_append(cache, lengths, kn, vn)
            ks.append(kn)
            vs_.append(vn)
            q = rand(50 + t, (b, hq, 1, d))
            o = kvcache.sageattn_paged_decode(q, cache, lengths)
            kf = jnp.concatenate(ks, axis=2)
            vf = jnp.concatenate(vs_, axis=2)
            ref = oracle(q[0], kf[0], vf[0], hq // hkv)
            assert cosine(o[0], ref) > 0.999, f"append {t}"

    def test_paged_append_overflow_clamps_like_dense(self):
        """Appending past the page table's span clamps to the end and
        overwrites the tail (append_kv's dynamic-update-slice
        semantics) instead of silently dropping the write."""
        b, hkv, d, page = 1, 2, 32, 64
        pt = jnp.array([[1, 0]], jnp.int32)  # span = 128 tokens
        cache = kvcache.init_paged_kv_cache(2, hkv, d, pt, page_size=page)
        k = rand(60, (b, hkv, 128, d))
        v = rand(61, (b, hkv, 128, d))
        cache, lengths = kvcache.paged_append(
            cache, jnp.zeros((b,), jnp.int32), k, v
        )
        kn, vn = rand(62, (b, hkv, 1, d)), rand(63, (b, hkv, 1, d))
        cache, lengths = kvcache.paged_append(cache, lengths, kn, vn)
        # the overflow token overwrote the final row (physical page 0,
        # the table's last entry), exactly like the dense tail clamp
        dense = kvcache.init_kv_cache(b, hkv, 128, d)
        dense, dl = kvcache.append_kv(
            dense, jnp.zeros((b,), jnp.int32), k, v
        )
        dense, dl = kvcache.append_kv(dense, dl, kn, vn)
        np.testing.assert_array_equal(
            np.asarray(cache.pages_k[0, :, -1]),
            np.asarray(dense.k_i8[0, :, -1]),
        )
        np.testing.assert_array_equal(
            np.asarray(cache.pages_v[0, :, -1]),
            np.asarray(dense.v_i8[0, :, -1]),
        )

    def test_calibrate_lengths_guard(self):
        """calibrate(..., lengths) must keep frozen means for batches
        with live tokens (re-prefill over a live cache is a no-op) and
        zero-length decode slots must stay 0, not v_mean."""
        b, hq, hkv, d, S = 2, 4, 2, 64, 256
        k = rand(1, (b, hkv, 100, d)) + 1.0
        v = rand(2, (b, hkv, 100, d)) + 2.0
        cache = kvcache.init_kv_cache(b, hkv, S, d, bits=4)
        cache = kvcache.calibrate(cache, k, v)
        m0 = np.asarray(cache.k_mean)
        # batch 0 live, batch 1 empty
        lengths = jnp.array([100, 0], jnp.int32)
        cache2 = kvcache.calibrate(cache, k + 5.0, v + 5.0, lengths)
        np.testing.assert_array_equal(
            np.asarray(cache2.k_mean)[0], m0[0]
        )   # live slot kept its frozen means
        assert np.all(np.asarray(cache2.k_mean)[1] != m0[1])

        # zero-length slot: output must be exactly 0 even though
        # v_mean != 0 (no softmax mass to carry the add-back)
        cache, _ = kvcache.append_kv(
            cache, jnp.zeros((b,), jnp.int32), k, v
        )
        q = rand(3, (b, hq, 1, d))
        o = kvcache.sageattn_decode(q, cache, lengths)
        assert np.all(np.asarray(o[1]) == 0.0)
        assert np.any(np.asarray(o[0]) != 0.0)


class TestChunkedPrefill:
    """The vLLM "extend" phase: a block of hundreds of new tokens
    attends the quantized cache + itself causally (t_q >> 1)."""

    def test_extend_block_matches_causal_oracle(self):
        b, hq, hkv, d, S, t_q = 1, 4, 2, 64, 1024, 128
        L_prev = 700
        k_all = rand(1, (b, hkv, L_prev + t_q, d))
        v_all = rand(2, (b, hkv, L_prev + t_q, d))
        cache = kvcache.init_kv_cache(b, hkv, S, d)
        cache, lengths = kvcache.append_kv(
            cache, jnp.zeros((b,), jnp.int32), k_all, v_all
        )
        q = rand(3, (b, hq, t_q, d))
        o = kvcache.sageattn_decode(q, cache, lengths)

        # causal oracle: query row t (global pos L_prev + t) sees keys
        # <= its own position
        L = L_prev + t_q
        group = hq // hkv
        kr = jnp.repeat(k_all[0], group, axis=0).astype(jnp.float32)
        vr = jnp.repeat(v_all[0], group, axis=0).astype(jnp.float32)
        s = jnp.einsum(
            "hqd,hkd->hqk", q[0].astype(jnp.float32), kr
        ) * d**-0.5
        col = jnp.arange(L)[None, None, :]
        row = jnp.arange(t_q)[None, :, None]
        s = jnp.where(col <= L_prev + row, s, -jnp.inf)
        ref = jnp.einsum(
            "hqk,hkd->hqd", jax.nn.softmax(s, axis=-1), vr
        )
        assert cosine(o[0], ref) > 0.999

    def test_chunked_prefill_equals_one_shot(self):
        """Prefilling in two extend blocks == one-shot prefill+decode."""
        b, hq, hkv, d, S = 1, 4, 2, 64, 512
        t1, t2 = 200, 100
        k = rand(11, (b, hkv, t1 + t2, d))
        v = rand(12, (b, hkv, t1 + t2, d))
        q2 = rand(13, (b, hq, t2, d))

        # chunked: block 1 appended; block 2 appended then extended
        c = kvcache.init_kv_cache(b, hkv, S, d)
        c, ln = kvcache.append_kv(
            c, jnp.zeros((b,), jnp.int32), k[:, :, :t1], v[:, :, :t1]
        )
        c, ln = kvcache.append_kv(c, ln, k[:, :, t1:], v[:, :, t1:])
        o_chunked = kvcache.sageattn_decode(q2, c, ln)

        # one-shot: same cache contents (per-token scales => identical)
        c2 = kvcache.init_kv_cache(b, hkv, S, d)
        c2, ln2 = kvcache.append_kv(c2, jnp.zeros((b,), jnp.int32), k, v)
        o_once = kvcache.sageattn_decode(q2, c2, ln2)
        np.testing.assert_array_equal(
            np.asarray(o_chunked), np.asarray(o_once)
        )

    def test_model_chunked_prefill_matches_tokens(self):
        """CausalLM: prefilling through the cache in extend blocks
        (decode=True per chunk) then decoding must generate the same
        tokens as the one-shot prefill path."""
        from sageattention_jax import models
        from sageattention_jax.models.configs import MODEL_CONFIGS

        cfg = MODEL_CONFIGS["llm-7b"].scaled(
            depth=2, hidden=128, heads=4, kv_heads=2, head_dim=32,
            vocab=128, mlp_hidden=256,
        )
        model = models.CausalLM(cfg)
        b, n_prompt, n_gen, max_len = 1, 16, 4, 64
        toks = jax.random.randint(
            jax.random.PRNGKey(0), (b, n_prompt), 0, 128
        )
        params = model.init(jax.random.PRNGKey(1), toks)

        def generate(chunked):
            caches = model.init_caches(b, max_len)
            lengths = jnp.zeros((b,), jnp.int32)
            if chunked:
                for i in range(0, n_prompt, 8):
                    logits, caches = model.apply(
                        params, toks[:, i:i + 8], caches=caches,
                        lengths=lengths, decode=True,
                    )
                    lengths = lengths + 8
            else:
                logits, caches = model.apply(
                    params, toks, caches=caches, lengths=lengths
                )
                lengths = lengths + n_prompt
            cur = jnp.argmax(logits[:, -1:], axis=-1)
            out = [int(cur[0, 0])]
            for _ in range(n_gen):
                logits, caches = model.apply(
                    params, cur, caches=caches, lengths=lengths,
                    decode=True,
                )
                lengths = lengths + 1
                cur = jnp.argmax(logits[:, -1:], axis=-1)
                out.append(int(cur[0, 0]))
            return out

        assert generate(True) == generate(False)


class TestPrefixSharing:
    def test_shared_prefix_pages_alias(self):
        """vLLM-style prefix caching: sequences sharing a prompt prefix
        point their page-table entries at the SAME physical pages (no
        copy).  Reads are pure gathers, pages are read-only after fill,
        so aliasing is safe by construction — each sequence still gets
        exactly its own attention output."""
        hq, hkv, d, page = 4, 2, 64, 128
        n_prefix, n_tail = 2, 1          # 256 shared + 128 own tokens
        S = (n_prefix + n_tail) * page

        k_pre = rand(201, (1, hkv, n_prefix * page, d))
        v_pre = rand(202, (1, hkv, n_prefix * page, d))
        tails_k = [rand(203 + i, (1, hkv, page, d)) for i in range(2)]
        tails_v = [rand(205 + i, (1, hkv, page, d)) for i in range(2)]

        # pool: pages 0,1 = shared prefix; 2,3 = per-sequence tails
        # both sequences' tables alias the prefix pages
        table = jnp.array([[0, 1, 2], [0, 1, 3]], jnp.int32)
        pool = kvcache.init_paged_kv_cache(
            4, hkv, d, table, page_size=page
        )
        # fill the prefix ONCE through a one-row view of the table,
        # then serve both sequences through the aliasing table
        import dataclasses
        view = dataclasses.replace(
            pool, page_table=table[:1, :2],
            k_mean=pool.k_mean[:1], v_mean=pool.v_mean[:1],
        )
        view, _ = kvcache.paged_prefill(view, k_pre, v_pre)
        pool = dataclasses.replace(
            pool, pages_k=view.pages_k,
            pages_k_scale=view.pages_k_scale, pages_v=view.pages_v,
            pages_v_scale=view.pages_v_scale,
        )
        lengths = jnp.full((2,), n_prefix * page, jnp.int32)
        k2 = jnp.concatenate(tails_k, axis=0)
        v2 = jnp.concatenate(tails_v, axis=0)
        pool, lengths = kvcache.paged_append(pool, lengths, k2, v2)

        q = rand(210, (2, hq, 1, d))
        o = kvcache.sageattn_paged_decode(q, pool, lengths)

        for i in range(2):
            k_full = jnp.concatenate([k_pre[0], tails_k[i][0]], axis=1)
            v_full = jnp.concatenate([v_pre[0], tails_v[i][0]], axis=1)
            ref = oracle(q[i], k_full, v_full, hq // hkv)
            assert cosine(o[i], ref) > 0.999, i


class TestSpeculative:
    """Draft-block verification + free cache rollback (speculative
    decoding on the quantized cache)."""

    def test_greedy_verify(self):
        from sageattention_jax.speculative import speculative_verify
        V = 16
        draft = jnp.array([[3, 5, 7]], jnp.int32)
        # target agrees at 0 and 1, wants token 9 at position 2,
        # bonus row wants 11
        tl = jnp.full((1, 4, V), -10.0)
        tl = tl.at[0, 0, 3].set(5.0).at[0, 1, 5].set(5.0)
        tl = tl.at[0, 2, 9].set(5.0).at[0, 3, 11].set(5.0)
        n, nxt = speculative_verify(draft, tl)
        assert int(n[0]) == 2 and int(nxt[0]) == 9
        # full acceptance -> bonus token
        tl2 = tl.at[0, 2, 9].set(-10.0).at[0, 2, 7].set(5.0)
        n2, nxt2 = speculative_verify(draft, tl2)
        assert int(n2[0]) == 3 and int(nxt2[0]) == 11

    def test_sampling_verify_identical_dists_accepts_all(self):
        from sageattention_jax.speculative import speculative_verify
        b, k, V = 2, 4, 32
        logits = jax.random.normal(jax.random.PRNGKey(0), (b, k, V))
        tl = jnp.concatenate(
            [logits, jax.random.normal(jax.random.PRNGKey(1), (b, 1, V))],
            axis=1,
        )
        draft = jnp.argmax(logits, axis=-1)
        # p == q -> u*q < p always (u < 1): every draft token accepted
        n, nxt = speculative_verify(
            draft, tl, draft_logits=logits,
            key=jax.random.PRNGKey(2), greedy=False,
        )
        assert np.all(np.asarray(n) == k)

    def test_sampling_verify_disjoint_rejects_first(self):
        from sageattention_jax.speculative import speculative_verify
        V = 8
        draft = jnp.array([[2, 3]], jnp.int32)
        dl = jnp.full((1, 2, V), -10.0).at[:, :, 2].set(5.0)
        dl = dl.at[0, 1, 3].set(10.0)
        # target puts ~zero mass on token 2 at position 0
        tl = jnp.full((1, 3, V), -10.0).at[0, 0, 6].set(10.0)
        tl = tl.at[0, 1, 3].set(10.0).at[0, 2, 1].set(10.0)
        n, nxt = speculative_verify(
            draft, tl, draft_logits=dl,
            key=jax.random.PRNGKey(3), greedy=False,
        )
        # rejected at 0; residual = target (draft mass elsewhere) -> 6
        assert int(n[0]) == 0 and int(nxt[0]) == 6

    def test_cache_rollback_is_free(self):
        """Appending a rejected draft tail, rolling lengths back, and
        appending the corrected token == never having speculated
        (per-token scales leave no state in stale rows)."""
        b, hkv, d, S = 1, 2, 32, 128
        base_k = rand(301, (b, hkv, 10, d))
        base_v = rand(302, (b, hkv, 10, d))
        draft_k = rand(303, (b, hkv, 4, d))
        draft_v = rand(304, (b, hkv, 4, d))
        good_k = rand(305, (b, hkv, 1, d))
        good_v = rand(306, (b, hkv, 1, d))

        c1 = kvcache.init_kv_cache(b, hkv, S, d)
        c1, l1 = kvcache.append_kv(
            c1, jnp.zeros((b,), jnp.int32), base_k, base_v
        )
        c1, _ = kvcache.append_kv(c1, l1, draft_k, draft_v)  # speculate
        l1 = l1 + 2            # accept only 2 of 4 draft tokens
        # the corrected token simply overwrites the rejected tail
        c1, l1 = kvcache.append_kv(c1, l1, good_k, good_v)

        c2 = kvcache.init_kv_cache(b, hkv, S, d)
        c2, l2 = kvcache.append_kv(
            c2, jnp.zeros((b,), jnp.int32), base_k, base_v
        )
        c2, l2 = kvcache.append_kv(c2, l2, draft_k[:, :, :2],
                                   draft_v[:, :, :2])
        c2, l2 = kvcache.append_kv(c2, l2, good_k, good_v)

        q = rand(307, (b, 4, 1, d))
        np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
        np.testing.assert_array_equal(
            np.asarray(kvcache.sageattn_decode(q, c1, l1)),
            np.asarray(kvcache.sageattn_decode(q, c2, l2)),
        )


class TestContinuousBatching:
    def test_slot_eviction_and_reuse(self):
        """Continuous batching: when a sequence finishes, its batch slot
        resets (lengths[i] = 0) and a new request takes it over — no
        cache scrubbing needed (per-token scales, stale rows are
        overwritten; calibrate(lengths) refreshes only the empty
        slot's means on an int4 cache)."""
        b, hq, hkv, d, S = 2, 4, 2, 64, 256
        cache = kvcache.init_kv_cache(b, hkv, S, d, bits=4)
        k1 = rand(401, (b, hkv, 100, d)) + 1.0
        v1 = rand(402, (b, hkv, 100, d)) - 1.0
        cache = kvcache.calibrate(cache, k1, v1,
                                  jnp.zeros((b,), jnp.int32))
        cache, lengths = kvcache.append_kv(
            cache, jnp.zeros((b,), jnp.int32), k1, v1
        )

        # slot 1 finishes; a new request (different stats) arrives
        lengths = lengths.at[1].set(0)
        k2 = rand(403, (b, hkv, 80, d)) - 2.0
        v2 = rand(404, (b, hkv, 80, d)) + 2.0
        cache = kvcache.calibrate(cache, k2, v2, lengths)
        cache, lengths = kvcache.append_kv(cache, lengths, k2, v2)
        # slot 0 kept its sequence: appended at its old length
        assert int(lengths[0]) == 180 and int(lengths[1]) == 80

        q = rand(405, (b, hq, 1, d))
        o = kvcache.sageattn_decode(q, cache, lengths)
        # slot 0: old 100 tokens + 80 new; slot 1: only the new 80
        ref0 = oracle(
            q[0],
            jnp.concatenate([k1[0], k2[0]], axis=1),
            jnp.concatenate([v1[0], v2[0]], axis=1),
            hq // hkv,
        )
        ref1 = oracle(q[1], k2[1], v2[1], hq // hkv)
        assert cosine(o[0], ref0) > 0.99    # slot 0 means frozen on k1
        assert cosine(o[1], ref1) > 0.999   # slot 1 recalibrated


class TestMergeDecodePartials:
    def test_shard_partials_merge_to_full_decode(self):
        """Decodes over disjoint halves of the cache, merged through their
        (m, l) state, equal the one decode over the whole cache; an empty
        shard carries zero weight."""
        b, hq, hkv, d, S = 2, 4, 2, 32, 256
        cache = kvcache.init_kv_cache(b, hkv, S, d)
        k, v = rand(81, (b, hkv, S, d)), rand(82, (b, hkv, S, d))
        cache, _ = kvcache.append_kv(cache, jnp.zeros((b,), jnp.int32), k, v)
        lengths = jnp.array([S, 100], jnp.int32)
        q = rand(83, (b, hq, 1, d))
        full = kvcache.sageattn_decode(q, cache, lengths)
        halves = []
        for lo in (0, S // 2):
            part = kvcache.QuantKVCache(
                k_i8=cache.k_i8[:, :, lo:lo + S // 2],
                k_scale=cache.k_scale[:, :, lo:lo + S // 2],
                v_i8=cache.v_i8[:, :, lo:lo + S // 2],
                v_scale=cache.v_scale[:, :, lo:lo + S // 2],
                k_mean=cache.k_mean, v_mean=cache.v_mean,
            )
            halves.append(kvcache.sageattn_decode(
                q, part, lengths - lo, return_state=True))
        o, m, l = (jnp.stack(x) for x in zip(*halves))
        assert float(l[1, 1].max()) == 0.0  # batch 1 never reaches shard 1
        merged = kvcache.merge_decode_partials(o, m, l)
        np.testing.assert_allclose(np.asarray(merged), np.asarray(full),
                                   atol=1e-5)

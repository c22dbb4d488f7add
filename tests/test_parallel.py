"""Distribution layer tests on the 8-device virtual CPU mesh.

The reference has no in-repo distributed tests (SURVEY.md §4: "Distributed
testing: none below xDiT") — these cover what xDiT provided externally:
ring (context parallel), Ulysses (head all-to-all), and the composed
DP x ring x Ulysses matrix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sageattention_jax.ops import reference
from sageattention_jax.parallel import (
    make_mesh,
    make_parallel_sageattn,
    make_ring_attention,
    make_ulysses_attention,
)
import sageattention_jax as sa


def rand(key, shape, dtype=jnp.float32):
    return jax.random.normal(jax.random.PRNGKey(key), shape).astype(dtype)


def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


B, H, S, D = 2, 4, 512, 64


@pytest.fixture(scope="module")
def qkv():
    return tuple(rand(i, (B, H, S, D)) for i in range(3))


class TestRing:
    @pytest.mark.parametrize("causal", [False, True])
    def test_ring_matches_reference(self, qkv, causal):
        q, k, v = qkv
        mesh = make_mesh(data=1, seq=8, heads=1)
        fn = make_ring_attention(
            mesh, "seq", is_causal=causal, data_axis=None, pv_dtype="bf16"
        )
        o = fn(q, k, v)
        o_ref = reference.attention_reference(q, k, v, is_causal=causal)
        assert cosine(o, o_ref) > 0.999

    def test_ring_equals_single_device_quality(self, qkv):
        """Ring output must be as accurate as the single-device op (the
        per-shard K smoothing must not degrade it)."""
        q, k, v = qkv
        k = k + 2.0  # K mean matters
        mesh = make_mesh(data=1, seq=4, heads=1, devices=jax.devices()[:4])
        fn = make_ring_attention(mesh, "seq", data_axis=None, pv_dtype="bf16")
        o_ring = fn(q, k, v)
        o_ref = reference.attention_reference(q, k, v)
        o_single = sa.sageattn(q, k, v, pv_dtype="bf16")
        c_ring = cosine(o_ring, o_ref)
        c_single = cosine(o_single, o_ref)
        assert c_ring > 0.999
        assert c_ring >= c_single - 1e-4


class TestUlysses:
    @pytest.mark.parametrize("causal", [False, True])
    def test_ulysses_matches_reference(self, qkv, causal):
        q, k, v = qkv
        mesh = make_mesh(data=1, seq=1, heads=4, devices=jax.devices()[:4])
        fn = make_ulysses_attention(
            mesh, "heads", is_causal=causal, data_axis=None, pv_dtype="bf16"
        )
        o = fn(q, k, v)
        o_ref = reference.attention_reference(q, k, v, is_causal=causal)
        assert cosine(o, o_ref) > 0.999

    def test_ulysses_equals_single_device_exactly(self, qkv):
        """Ulysses is pure data movement around the same single-device op:
        outputs must match the unsharded call to fp32 tolerance."""
        q, k, v = qkv
        mesh = make_mesh(data=1, seq=1, heads=4, devices=jax.devices()[:4])
        fn = make_ulysses_attention(mesh, "heads", data_axis=None, pv_dtype="bf16")
        o = fn(q, k, v)
        o_single = sa.sageattn(q, k, v, pv_dtype="bf16")
        np.testing.assert_allclose(
            np.asarray(o, np.float32), np.asarray(o_single, np.float32),
            atol=2e-2,
        )

    def test_ulysses_head_divisibility_error(self, qkv):
        q, k, v = qkv
        mesh = make_mesh(data=1, seq=1, heads=8)
        fn = make_ulysses_attention(mesh, "heads", data_axis=None)
        with pytest.raises(Exception):
            jax.block_until_ready(fn(q, k, v))  # 4 heads not divisible by 8


class TestFactoryContracts:
    def test_ring_return_lse(self, qkv):
        """return_lse=True through the factory: (o, lse) both sharded,
        matching the single-device contract."""
        q, k, v = qkv
        mesh = make_mesh(data=1, seq=4, heads=1, devices=jax.devices()[:4])
        fn = make_ring_attention(
            mesh, "seq", data_axis=None, return_lse=True
        )
        o, lse = fn(q, k, v)
        o_ref, lse_ref = reference.attention_reference(
            q, k, v, return_lse=True
        )
        assert cosine(o, o_ref) > 0.999
        np.testing.assert_allclose(
            np.asarray(lse), np.asarray(lse_ref), rtol=1e-2, atol=5e-2
        )

    def test_ulysses_return_lse_and_grad(self, qkv):
        """Ulysses factory: LSE comes back re-sharded, and the path is
        differentiable (custom-VJP leaf, like the ring and composed
        paths)."""
        q, k, v = qkv
        mesh = make_mesh(data=1, seq=1, heads=4, devices=jax.devices()[:4])
        fn = make_ulysses_attention(
            mesh, "heads", data_axis=None, return_lse=True
        )
        o, lse = fn(q, k, v)
        _, lse_ref = reference.attention_reference(q, k, v, return_lse=True)
        np.testing.assert_allclose(
            np.asarray(lse), np.asarray(lse_ref), rtol=1e-2, atol=5e-2
        )
        fn_plain = make_ulysses_attention(mesh, "heads", data_axis=None)
        g = jax.grad(lambda q: fn_plain(q, k, v).astype(jnp.float32).sum())(q)
        g_ref = jax.grad(
            lambda q: reference.attention_reference(q, k, v)
            .astype(jnp.float32).sum()
        )(q)
        assert cosine(g, g_ref) > 0.99

    def test_missing_data_axis_composes_away(self, qkv):
        """A mesh without a 'data' axis must work with the default
        data_axis (it composes away like the other axes)."""
        q, k, v = qkv
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:4]), ("seq",)
        )
        fn = make_parallel_sageattn(mesh)
        o = fn(q, k, v)
        o_ref = reference.attention_reference(q, k, v)
        assert cosine(o, o_ref) > 0.999

    def test_unknown_ring_axis_raises(self, qkv):
        mesh = make_mesh(data=1, seq=4, heads=1, devices=jax.devices()[:4])
        with pytest.raises(ValueError, match="no axis"):
            make_ring_attention(mesh, "nonexistent")

    def test_parallel_defaults_match_sageattn(self, qkv):
        """The parallel wrappers default to the same pv_dtype as the
        public sageattn (bf16) — no silent accuracy downgrade."""
        q, k, v = qkv
        mesh = make_mesh(data=1, seq=1, heads=4, devices=jax.devices()[:4])
        fn = make_ulysses_attention(mesh, "heads", data_axis=None)
        o = fn(q, k, v)
        o_single = sa.sageattn(q, k, v)  # defaults to pv_dtype="bf16"
        np.testing.assert_allclose(
            np.asarray(o, np.float32), np.asarray(o_single, np.float32),
            atol=2e-2,
        )


class TestComposed:
    def test_dp_ring_ulysses(self, qkv):
        """The full xDiT-style matrix: cfg/data x ring x ulysses = 2x2x2."""
        q, k, v = qkv
        mesh = make_mesh(data=2, seq=2, heads=2)
        fn = make_parallel_sageattn(mesh, pv_dtype="bf16")
        o = fn(q, k, v)
        o_ref = reference.attention_reference(q, k, v)
        assert o.shape == q.shape
        assert cosine(o, o_ref) > 0.999

    def test_dp_ring_ulysses_causal(self, qkv):
        q, k, v = qkv
        mesh = make_mesh(data=2, seq=2, heads=2)
        fn = make_parallel_sageattn(mesh, is_causal=True, pv_dtype="bf16")
        o = fn(q, k, v)
        o_ref = reference.attention_reference(q, k, v, is_causal=True)
        assert cosine(o, o_ref) > 0.999

    def test_ring_only_mesh(self, qkv):
        q, k, v = qkv
        mesh = make_mesh(data=1, seq=8, heads=1)
        fn = make_parallel_sageattn(mesh, data_axis=None, pv_dtype="bf16")
        o = fn(q, k, v)
        o_ref = reference.attention_reference(q, k, v)
        assert cosine(o, o_ref) > 0.999


class TestPositions:
    def test_position_masking_equals_causal(self, qkv):
        """Explicit positions == static causal on aligned inputs (the
        kernel path ring attention uses)."""
        q, k, v = qkv
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
        o_pos = sa.sageattn(
            q, k, v, q_positions=pos, kv_positions=pos, pv_dtype="bf16"
        )
        o_causal = sa.sageattn(q, k, v, is_causal=True, pv_dtype="bf16")
        # on a GPU causal rides the kernel (bf16 P) and positions the
        # blockwise path, so agreement is to that precision, not ULPs
        np.testing.assert_allclose(
            np.asarray(o_pos, np.float32),
            np.asarray(o_causal, np.float32),
            atol=4e-2,
        )


class TestParallelGradients:
    """The ring/composed paths are differentiable end-to-end: per-step
    fused backwards, KV-shard gradients rotating home through ppermute's
    transpose (round 1 substituted a score-materializing global VJP)."""

    @pytest.mark.parametrize("causal", [False, True])
    def test_ring_grad_matches_global_exact(self, qkv, causal):
        q, k, v = qkv
        mesh = make_mesh(data=1, seq=4, heads=1, devices=jax.devices()[:4])
        fn = make_ring_attention(
            mesh, "seq", is_causal=causal, data_axis=None, pv_dtype="bf16"
        )

        def loss(q, k, v):
            return jnp.sum(fn(q, k, v) ** 2)

        def loss_ref(q, k, v):
            return jnp.sum(
                reference.attention_reference(q, k, v, is_causal=causal) ** 2
            )

        g = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
        g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        for a, r in zip(g, g_ref):
            assert cosine(a, r) > 0.99

    def test_composed_parallel_grad(self, qkv):
        q, k, v = qkv
        mesh = make_mesh(data=2, seq=2, heads=2)
        fn = make_parallel_sageattn(mesh, pv_dtype="bf16")

        def loss(q, k, v):
            return jnp.sum(fn(q, k, v) ** 2)

        g = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

        def loss_ref(q, k, v):
            return jnp.sum(
                reference.attention_reference(q, k, v) ** 2
            )

        g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        for a, r in zip(g, g_ref):
            assert cosine(a, r) > 0.99


class TestShardedDecode:
    """Sequence-parallel serving: the KV cache sharded over the mesh
    (parallel/decode.py) — each device decodes its shard, one LSE merge
    combines the partials."""

    @staticmethod
    def _golden(q, cache, lengths, *, window=None):
        return sa.sageattn_decode(q, cache, lengths, window=window)

    @staticmethod
    def _filled(b, hkv, d, S, L):
        cache = sa.init_kv_cache(b, hkv, S, d)
        k = rand(31, (b, hkv, max(L), d))
        v = rand(32, (b, hkv, max(L), d))
        # ragged: append the full block, lengths mark the live prefix
        cache, _ = sa.append_kv(cache, jnp.zeros((b,), jnp.int32), k, v)
        return cache, jnp.array(L, jnp.int32)

    def test_matches_single_device(self):
        b, hq, hkv, d, S = 2, 8, 2, 64, 1024
        cache, lengths = self._filled(b, hkv, d, S, [700, 300])
        q = rand(33, (b, hq, 1, d))
        # single-device golden: only the (fp32, associative) merge
        # order differs
        o_single = self._golden(q, cache, lengths)

        mesh = make_mesh(data=1, seq=8, heads=1)
        mesh = jax.sharding.Mesh(mesh.devices.reshape(8), ("seq",))
        fn = sa.parallel.make_sharded_decode(mesh, axis="seq")
        o_shard = fn(q, cache, lengths)
        np.testing.assert_allclose(
            np.asarray(o_single, np.float32),
            np.asarray(o_shard, np.float32), atol=1e-4, rtol=0,
        )

    @pytest.mark.parametrize("L", [500, 130])
    def test_multi_token_causal_tail(self, L):
        """t_q > 1 (speculative decode): the causal-tail mask shifts
        with the shard offset exactly — including when the tail itself
        straddles a shard boundary (L=130 over 128-row shards)."""
        b, hq, hkv, d, S, t_q = 1, 4, 2, 64, 512, 4
        cache, lengths = self._filled(b, hkv, d, S, [L])
        q = rand(34, (b, hq, t_q, d))
        o_single = self._golden(q, cache, lengths)
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))
        fn = sa.parallel.make_sharded_decode(mesh, axis="seq")
        np.testing.assert_allclose(
            np.asarray(o_single, np.float32),
            np.asarray(fn(q, cache, lengths), np.float32),
            atol=1e-4, rtol=0,
        )

    def test_window_sharded(self):
        """Sliding window across shard boundaries."""
        b, hq, hkv, d, S = 2, 4, 2, 64, 1024
        cache, lengths = self._filled(b, hkv, d, S, [900, 520])
        q = rand(35, (b, hq, 1, d))
        o_single = self._golden(
            q, cache, lengths, window=256
        )
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))
        fn = sa.parallel.make_sharded_decode(
            mesh, axis="seq", window=256
        )
        np.testing.assert_allclose(
            np.asarray(o_single, np.float32),
            np.asarray(fn(q, cache, lengths), np.float32),
            atol=1e-4, rtol=0,
        )

    def test_sharded_append_bitexact(self):
        """Appends that straddle shard boundaries write every row at
        its true position — bit-identical to the single-device cache."""
        b, hkv, d, S = 2, 2, 32, 512    # 4 shards of 128
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))
        app = sa.parallel.make_sharded_append(mesh, axis="seq")

        cache_s = sa.init_kv_cache(b, hkv, S, d)
        cache_g = sa.init_kv_cache(b, hkv, S, d)
        lengths = jnp.zeros((b,), jnp.int32)
        glengths = lengths
        for i, t in enumerate([300, 100, 60, 1, 1]):   # 300 spans 3
            # shards (prefill >> shard size), later appends straddle
            k = rand(40 + i, (b, hkv, t, d))
            v = rand(50 + i, (b, hkv, t, d))
            cache_s, lengths = app(cache_s, lengths, k, v)
            cache_g, glengths = sa.append_kv(cache_g, glengths, k, v)
        np.testing.assert_array_equal(np.asarray(lengths),
                                      np.asarray(glengths))
        for f in ("k_i8", "v_i8"):
            np.testing.assert_array_equal(
                np.asarray(getattr(cache_s, f)),
                np.asarray(getattr(cache_g, f)), err_msg=f)
        for f in ("k_scale", "v_scale"):
            np.testing.assert_array_equal(
                np.asarray(getattr(cache_s, f)),
                np.asarray(getattr(cache_g, f)), err_msg=f)

    def test_sharded_decode_calibrated_int8(self):
        """Calibrated means commute with the shard merge."""
        b, hq, hkv, d, S = 1, 4, 2, 64, 512
        k = rand(61, (b, hkv, 400, d)) + 2.0
        v = rand(62, (b, hkv, 400, d)) - 1.0
        cache = sa.init_kv_cache(b, hkv, S, d)
        cache = sa.calibrate(cache, k, v)
        cache, lengths = sa.append_kv(
            cache, jnp.zeros((b,), jnp.int32), k, v
        )
        q = rand(63, (b, hq, 1, d))
        # calibrated shards: compare at the decode path's accuracy level
        o_single = sa.sageattn_decode(q, cache, lengths)
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))
        fn = sa.parallel.make_sharded_decode(mesh, axis="seq")
        o_shard = fn(q, cache, lengths)
        np.testing.assert_allclose(
            np.asarray(o_single, np.float32),
            np.asarray(o_shard, np.float32), atol=2e-2, rtol=0,
        )
        assert cosine(o_single, o_shard) > 0.9995

    def test_tp_sp_composed(self):
        """TP (head-sharded cache) x SP (sequence-sharded cache) on one
        mesh: heads need no collective, sequence merges via LSE."""
        b, hq, hkv, d, S = 1, 8, 2, 64, 512
        cache, lengths = self._filled(b, hkv, d, S, [400])
        q = rand(71, (b, hq, 1, d))
        o_single = self._golden(q, cache, lengths)
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()).reshape(2, 4), ("tp", "sp")
        )
        fn = sa.parallel.make_sharded_decode(
            mesh, axis="sp", head_axis="tp"
        )
        np.testing.assert_allclose(
            np.asarray(o_single, np.float32),
            np.asarray(fn(q, cache, lengths), np.float32),
            atol=1e-4, rtol=0,
        )

    def test_tp_sharded_append(self):
        """Head-sharded appends stay bit-identical too."""
        b, hkv, d, S = 2, 2, 32, 256
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:4]).reshape(2, 2), ("tp", "sp")
        )
        app = sa.parallel.make_sharded_append(
            mesh, axis="sp", head_axis="tp"
        )
        cache_s = sa.init_kv_cache(b, hkv, S, d)
        cache_g = sa.init_kv_cache(b, hkv, S, d)
        lengths = jnp.zeros((b,), jnp.int32)
        glengths = lengths
        for i, t in enumerate([100, 60]):
            k = rand(80 + i, (b, hkv, t, d))
            v = rand(90 + i, (b, hkv, t, d))
            cache_s, lengths = app(cache_s, lengths, k, v)
            cache_g, glengths = sa.append_kv(cache_g, glengths, k, v)
        for f in ("k_i8", "v_i8", "k_scale", "v_scale"):
            np.testing.assert_array_equal(
                np.asarray(getattr(cache_s, f)),
                np.asarray(getattr(cache_g, f)), err_msg=f)

    def test_sharded_int4_append_bitexact(self):
        """Packed-int4 caches shard too (roll/where on int4 storage)."""
        b, hkv, hq, d, S = 1, 2, 4, 64, 512
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))
        app = sa.parallel.make_sharded_append(mesh, axis="seq")
        k = rand(101, (b, hkv, 300, d))
        v = rand(102, (b, hkv, 300, d))
        c4 = sa.init_kv_cache(b, hkv, S, d, bits=4)
        c4 = sa.calibrate(c4, k, v)
        c4, lengths = app(c4, jnp.zeros((b,), jnp.int32), k, v)
        cg = sa.init_kv_cache(b, hkv, S, d, bits=4)
        cg = sa.calibrate(cg, k, v)
        cg, _ = sa.append_kv(cg, jnp.zeros((b,), jnp.int32), k, v)
        for f in ("k_i8", "v_i8"):
            np.testing.assert_array_equal(
                np.asarray(getattr(c4, f).astype(jnp.int8)),
                np.asarray(getattr(cg, f).astype(jnp.int8)), err_msg=f)
        q = rand(103, (b, hq, 1, d))
        o = sa.parallel.make_sharded_decode(mesh, axis="seq")(
            q, c4, lengths
        )
        og = sa.sageattn_decode(q, cg, lengths)
        assert cosine(o, og) > 0.999

    def test_sharded_append_overflow_matches_dense(self):
        """Appending past total capacity clamps and overwrites the tail
        (append_kv semantics), it must not drop tokens."""
        b, hkv, d, S = 1, 2, 32, 256
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))
        app = sa.parallel.make_sharded_append(mesh, axis="seq")
        cache_s = sa.init_kv_cache(b, hkv, S, d)
        cache_g = sa.init_kv_cache(b, hkv, S, d)
        k = rand(110, (b, hkv, 100, d))
        v = rand(111, (b, hkv, 100, d))
        lengths = jnp.array([200], jnp.int32)   # 200 + 100 > 256
        cache_s, ls = app(cache_s, lengths, k, v)
        cache_g, lg = sa.append_kv(cache_g, lengths, k, v)
        np.testing.assert_array_equal(np.asarray(ls), np.asarray(lg))
        for f in ("k_i8", "v_i8", "k_scale", "v_scale"):
            np.testing.assert_array_equal(
                np.asarray(getattr(cache_s, f)),
                np.asarray(getattr(cache_g, f)), err_msg=f)


class TestShardedPaged:
    """vLLM-at-scale: the page pool sharded over the mesh; each device
    decodes only the logical pages it owns (forward-filled local page
    tables elide unowned DMAs) and writes only its own pages."""

    def _pool(self, b, hkv, d, S, page, key, bits=8):
        n_pg = b * (S // page)
        # scrambled physical pages
        table = jax.random.permutation(
            jax.random.PRNGKey(key), n_pg
        ).reshape(b, S // page).astype(jnp.int32)
        return sa.init_paged_kv_cache(
            n_pg, hkv, d, table, page_size=page, bits=bits
        )

    def test_paged_decode_matches_single_pool(self):
        import sageattention_jax.kvcache as kvc
        b, hq, hkv, d, S, page = 2, 8, 2, 64, 1024, 128
        k = rand(121, (b, hkv, S, d))
        v = rand(122, (b, hkv, S, d))
        q = rand(123, (b, hq, 1, d))
        lengths = jnp.array([S, 600], jnp.int32)

        single = self._pool(b, hkv, d, S, page, key=9)
        single, _ = kvc.paged_prefill(single, k, v)
        o_single = kvc.sageattn_paged_decode(q, single, lengths)

        mesh = jax.sharding.Mesh(np.array(jax.devices()), ("seq",))
        dec = sa.parallel.make_sharded_paged_decode(mesh, axis="seq")
        o_shard = dec(q, single, lengths)
        np.testing.assert_allclose(
            np.asarray(o_single, np.float32),
            np.asarray(o_shard, np.float32), atol=1e-4, rtol=0,
        )

    def test_paged_sharded_writes_bitexact(self):
        """Sharded prefill + boundary-crossing appends == global pool."""
        import sageattention_jax.kvcache as kvc
        b, hkv, d, S, page = 2, 2, 32, 512, 128
        k = rand(131, (b, hkv, 256, d))
        v = rand(132, (b, hkv, 256, d))
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))
        pre = sa.parallel.make_sharded_paged_append(
            mesh, axis="seq", prefill=True
        )
        app = sa.parallel.make_sharded_paged_append(mesh, axis="seq")

        pool_s = self._pool(b, hkv, d, S, page, key=10)
        pool_g = self._pool(b, hkv, d, S, page, key=10)
        pool_s, ls = pre(pool_s, jnp.zeros((b,), jnp.int32), k, v)
        pool_g, lg = kvc.paged_prefill(pool_g, k, v)
        for i, t in enumerate([100, 60, 1]):   # crosses page boundaries
            kn = rand(140 + i, (b, hkv, t, d))
            vn = rand(150 + i, (b, hkv, t, d))
            pool_s, ls = app(pool_s, ls, kn, vn)
            pool_g, lg = kvc.paged_append(pool_g, lg, kn, vn)
        np.testing.assert_array_equal(np.asarray(ls), np.asarray(lg))
        for f in ("pages_k", "pages_v", "pages_k_scale",
                  "pages_v_scale"):
            np.testing.assert_array_equal(
                np.asarray(getattr(pool_s, f)),
                np.asarray(getattr(pool_g, f)), err_msg=f)

    def test_paged_sharded_window(self):
        import sageattention_jax.kvcache as kvc
        b, hq, hkv, d, S, page = 1, 4, 2, 64, 1024, 128
        k = rand(161, (b, hkv, 900, d))
        v = rand(162, (b, hkv, 900, d))
        q = rand(163, (b, hq, 1, d))
        single = self._pool(b, hkv, d, S, page, key=11)
        single, _ = kvc.paged_prefill(
            single,
            jnp.pad(k, ((0, 0), (0, 0), (0, S - 900), (0, 0))),
            jnp.pad(v, ((0, 0), (0, 0), (0, S - 900), (0, 0))),
        )
        lengths = jnp.array([900], jnp.int32)
        o_single = kvc.sageattn_paged_decode(
            q, single, lengths, window=256
        )
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))
        dec = sa.parallel.make_sharded_paged_decode(
            mesh, axis="seq", window=256
        )
        np.testing.assert_allclose(
            np.asarray(o_single, np.float32),
            np.asarray(dec(q, single, lengths), np.float32),
            atol=1e-4, rtol=0,
        )

    def test_empty_slot_yields_zero_not_nan(self):
        """An evicted slot (lengths == 0) must decode to 0 across every
        sharded path — a subnormal merge epsilon used to flush to 0
        under XLA and emit NaN."""
        import sageattention_jax.kvcache as kvc
        b, hq, hkv, d, S, page = 2, 4, 2, 64, 512, 128
        k = rand(171, (b, hkv, S, d))
        v = rand(172, (b, hkv, S, d))
        q = rand(173, (b, hq, 1, d))
        lengths = jnp.array([S, 0], jnp.int32)   # slot 1 evicted
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))

        pool = self._pool(b, hkv, d, S, page, key=12)
        pool, _ = kvc.paged_prefill(pool, k, v)
        o_paged = sa.parallel.make_sharded_paged_decode(
            mesh, axis="seq"
        )(q, pool, lengths)
        assert np.all(np.isfinite(np.asarray(o_paged, np.float32)))
        assert np.all(np.asarray(o_paged, np.float32)[1] == 0.0)

        dense = sa.init_kv_cache(b, hkv, S, d)
        dense, _ = sa.append_kv(dense, jnp.zeros((b,), jnp.int32), k, v)
        o_dense = sa.parallel.make_sharded_decode(mesh, axis="seq")(
            q, dense, lengths
        )
        assert np.all(np.asarray(o_dense, np.float32)[1] == 0.0)

    def test_tp_only_decode(self):
        """head_axis alone (axis=None): pure tensor-parallel decode,
        no collective at all."""
        b, hq, hkv, d, S = 1, 8, 2, 64, 512
        cache, lengths = TestShardedDecode._filled(b, hkv, d, S, [400])
        q = rand(181, (b, hq, 1, d))
        o_single = sa.sageattn_decode(q, cache, lengths)
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("tp",))
        fn = sa.parallel.make_sharded_decode(
            mesh, axis=None, head_axis="tp"
        )
        np.testing.assert_allclose(
            np.asarray(o_single, np.float32),
            np.asarray(fn(q, cache, lengths), np.float32),
            atol=1e-4, rtol=0,
        )

"""Gradient support (quantized forward / straight-through blockwise
backward)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sageattention_jax as sa
from sageattention_jax.ops import reference


def rand(key, shape):
    return jax.random.normal(jax.random.PRNGKey(key), shape)


class TestGrad:
    def test_grad_matches_exact_attention_grad(self):
        q, k, v = (rand(i, (1, 2, 128, 64)) for i in range(3))

        def loss_sage(q, k, v):
            return jnp.sum(sa.sageattn(q, k, v, pv_dtype="bf16") ** 2)

        def loss_ref(q, k, v):
            return jnp.sum(
                reference.attention_reference(q, k, v) ** 2
            )

        g_sage = jax.grad(loss_sage, argnums=(0, 1, 2))(q, k, v)
        g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        # the cotangent entering the bwd comes from the quantized output,
        # so gradients match to quantization error, not exactly
        for gs, gr in zip(g_sage, g_ref):
            cos = float(
                jnp.sum(gs * gr)
                / (jnp.linalg.norm(gs) * jnp.linalg.norm(gr))
            )
            assert cos > 0.99

    def test_grad_causal(self):
        q, k, v = (rand(i + 5, (1, 2, 128, 32)) for i in range(3))
        g = jax.grad(
            lambda q: jnp.sum(sa.sageattn(q, k, v, is_causal=True))
        )(q)
        assert g.shape == q.shape
        assert bool(jnp.all(jnp.isfinite(g)))

    def test_value_and_grad_through_model_step(self):
        """The dryrun training-step contract in miniature."""
        from sageattention_jax import models
        from sageattention_jax.models.configs import MODEL_CONFIGS

        cfg = MODEL_CONFIGS["llm-7b"].scaled(
            depth=1, hidden=128, heads=4, kv_heads=4, head_dim=32,
            vocab=256, mlp_hidden=256,
        )
        model = models.CausalLM(cfg)
        toks = jax.random.randint(jax.random.PRNGKey(0), (1, 128), 0, 256)
        params = model.init(jax.random.PRNGKey(1), toks)

        def loss_fn(p):
            logits = model.apply(p, toks)
            return jnp.mean(logits**2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        assert jnp.isfinite(loss)
        flat = jax.tree.leaves(grads)
        assert all(bool(jnp.all(jnp.isfinite(g))) for g in flat)
        assert any(float(jnp.max(jnp.abs(g))) > 0 for g in flat)


def exact_vjp(q, k, v, do, *, is_causal=False, mask=None, dlse=None,
              bias=None):
    """VJP of exact fp32 attention (GQA by repeat inside the function)."""
    g = q.shape[1] // k.shape[1]

    def f(q, k, v, *b):
        kr, vr = (jnp.repeat(x, g, axis=1) for x in (k, v))
        return reference.attention_reference(
            q, kr, vr, is_causal=is_causal, attn_mask=mask,
            attn_bias=b[0] if b else None, return_lse=dlse is not None,
        )

    args = (q, k, v) + ((bias,) if bias is not None else ())
    _, vjp = jax.vjp(f, *args)
    return vjp((do, dlse) if dlse is not None else do)


def assert_close_grads(got, ref, thresh=0.999):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert bool(jnp.all(jnp.isfinite(g)))
        c = float(jnp.sum(g * r)
                  / (jnp.linalg.norm(g) * jnp.linalg.norm(r) + 1e-30))
        assert c > thresh, c


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("is_causal", [False, True])
def test_blockwise_backward_matches_exact_vjp(is_causal, gqa, with_dlse):
    """The blockwise backward (P recomputed per KV chunk from the saved
    LSE, dS = P * (dP - (D - dlse))) vs the exact VJP, with GQA and an
    LSE cotangent; 300 keys span several chunks plus a ragged tail."""
    from sageattention_jax.ops import autodiff

    q = rand(110, (1, 4, 300, 64))
    k, v = (rand(111 + i, (1, 2 if gqa else 4, 300, 64)) for i in range(2))
    do = rand(113, (1, 4, 300, 64))
    dlse = rand(114, (1, 4, 300)) if with_dlse else None
    got = autodiff.attention_vjp(q, k, v, do, dlse, is_causal=is_causal,
                                 pv_dtype="bf16", block_k=32)
    ref = exact_vjp(q, k, v, do, is_causal=is_causal, dlse=dlse)
    assert_close_grads(got, ref)


class TestFusedBackward:
    """The custom VJP's backward: the straight-through gradient of the
    quantized forward, blockwise over KV chunks (ops/blockwise.py)."""

    def test_matches_exact_gradients(self):
        from sageattention_jax.ops import autodiff

        q, k, v = (rand(i + 20, (1, 2, 256, 64)) for i in range(3))
        do = rand(30, (1, 2, 256, 64))
        got = autodiff.attention_vjp(q, k, v, do, is_causal=True)
        assert_close_grads(got, exact_vjp(q, k, v, do, is_causal=True))

    def test_k_quant_group_matches_forward_chunk(self):
        """The backward re-quantizes K with the FORWARD's group (block_k),
        so the recomputed P rows sum to 1 and the smooth-k mean cannot
        leak into dQ.  A large K mean makes any such leak dominant."""
        from sageattention_jax.ops import autodiff

        q, k, v = (rand(i + 40, (1, 1, 1024, 64)) for i in range(3))
        k = k + 3.0  # substantial mean: any rowsum(dS) != 0 leaks km
        do = rand(44, (1, 1, 1024, 64))
        for block_k in (32, 128):
            got = autodiff.attention_vjp(q, k, v, do, block_k=block_k)
            assert_close_grads(got, exact_vjp(q, k, v, do))

    def test_nhd_layout_gradients(self):
        """Regression: differentiable path must transpose NHD before the
        VJP (gradients previously treated axis 1 as heads)."""
        from sageattention_jax.ops import autodiff

        q, k, v = (rand(i + 50, (1, 2, 128, 64)) for i in range(3))

        def loss_hnd(q, k, v):
            return jnp.sum(autodiff.differentiable_sageattn(q, k, v) ** 2)

        def loss_nhd(q, k, v):
            o = autodiff.differentiable_sageattn(
                jnp.swapaxes(q, 1, 2),
                jnp.swapaxes(k, 1, 2),
                jnp.swapaxes(v, 1, 2),
                tensor_layout="NHD",
            )
            return jnp.sum(jnp.swapaxes(o, 1, 2) ** 2)

        g_h = jax.grad(loss_hnd, argnums=(0, 1, 2))(q, k, v)
        g_n = jax.grad(loss_nhd, argnums=(0, 1, 2))(q, k, v)
        for a, b in zip(g_h, g_n):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5
            )

    def test_gqa_group_sum_in_kernel(self):
        """GQA backward: dK/dV sum over the query-head group (grouped
        einsums, no jnp.repeat); must match the exact VJP."""
        from sageattention_jax.ops import autodiff

        q = rand(60, (1, 4, 256, 64))
        k, v = rand(61, (1, 2, 256, 64)), rand(62, (1, 2, 256, 64))
        do = rand(63, (1, 4, 256, 64))
        got = autodiff.attention_vjp(q, k, v, do, is_causal=True)
        assert got[1].shape == k.shape and got[2].shape == v.shape
        assert_close_grads(got, exact_vjp(q, k, v, do, is_causal=True))

    def test_return_lse_gradients_fused(self):
        """return_lse=True: the LSE cotangent folds into the D vector
        (dS = P*(dP - (D - dlse))) — no score materialization."""
        from sageattention_jax.ops import autodiff

        q, k, v = (rand(i + 70, (1, 2, 256, 64)) for i in range(3))
        w = rand(73, (1, 2, 256))  # weight so dlse is nontrivial

        def loss_sage(q, k, v):
            o, lse = autodiff.differentiable_sageattn(
                q, k, v, return_lse=True
            )
            return jnp.sum(o**2) + jnp.sum(w * lse**2)

        def loss_ref(q, k, v):
            o, lse = reference.attention_reference(q, k, v, return_lse=True)
            return jnp.sum(o**2) + jnp.sum(w * lse**2)

        g_sage = jax.grad(loss_sage, argnums=(0, 1, 2))(q, k, v)
        g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        assert_close_grads(g_sage, g_ref, 0.99)

    def test_int8_v_and_smooth_q_gradients(self):
        """Every forward option has the one backward: int8 V (dV through
        the dequantized V), smooth_q's column bias, per-block grans."""
        from sageattention_jax.ops import autodiff

        q, k, v = (rand(i + 75, (1, 2, 192, 64)) for i in range(3))
        q = q + 2.0
        do = rand(79, (1, 2, 192, 64))
        ref = exact_vjp(q, k, v, do, is_causal=True)
        for kw in ({"pv_dtype": "int8"}, {"smooth_q": True},
                   {"qk_quant_gran": "per_block"}):
            got = autodiff.attention_vjp(q, k, v, do, is_causal=True, **kw)
            assert_close_grads(got, ref, 0.998)


class TestWindowedBackward:
    def test_fused_causal_backward_cross_length(self):
        """Causal sq != sk (top-left aligned) in both directions."""
        from sageattention_jax.ops import autodiff

        for sq, sk in ((512, 256), (128, 512)):
            q = rand(70, (1, 2, sq, 64))
            k = rand(71, (1, 2, sk, 64))
            v = rand(72, (1, 2, sk, 64))
            do = rand(73, (1, 2, sq, 64))
            got = autodiff.attention_vjp(q, k, v, do, is_causal=True)
            assert_close_grads(got, exact_vjp(q, k, v, do, is_causal=True))

    def test_fused_window_backward_band_overrun(self):
        """Rows whose window lies wholly past the KV length see nothing:
        their output, LSE and dq are exactly zero / -inf / zero, and the
        live rows match the banded reference."""
        from sageattention_jax import core
        from sageattention_jax.ops import autodiff

        sq, sk, W, d = 512, 256, 64, 64
        q = rand(75, (1, 2, sq, d))
        k = rand(76, (1, 2, sk, d))
        v = rand(77, (1, 2, sk, d))
        do = rand(78, (1, 2, sq, d))
        o, lse = core._entry(q, k, v, is_causal=True, window=W,
                             return_lse=True, pv_dtype="bf16")
        dead_from = sk + W - 1  # first row with window start >= sk
        assert float(jnp.max(jnp.abs(o[:, :, dead_from:]))) == 0.0
        assert bool(jnp.all(jnp.isneginf(lse[:, :, dead_from:])))
        dq, dk, dv = autodiff.attention_vjp(
            q, k, v, do, is_causal=True, window=W, pv_dtype="bf16"
        )
        assert float(jnp.max(jnp.abs(dq[:, :, dead_from:]))) == 0.0
        band = jnp.logical_and(
            jnp.arange(sk)[None, :] <= jnp.arange(sq)[:, None],
            jnp.arange(sk)[None, :] > jnp.arange(sq)[:, None] - W,
        )[None, None]
        # the reference's fully-masked rows degenerate to a uniform
        # softmax whose vjp pollutes dK/dV; zero their cotangent
        do_live = do.at[:, :, dead_from:].set(0.0)
        ref = exact_vjp(q, k, v, do_live, mask=band)
        live = slice(0, sk)
        assert_close_grads((dq[:, :, live],), (ref[0][:, :, live],))
        assert_close_grads((dk, dv), ref[1:])

    def test_fused_window_backward_multiblock(self):
        """Sliding-window gradients over several KV chunks vs the banded
        exact reference."""
        from sageattention_jax.ops import autodiff

        q, k, v = (rand(i + 80, (1, 2, 1024, 64)) for i in range(3))
        do = rand(84, (1, 2, 1024, 64))
        W = 200
        got = autodiff.attention_vjp(q, k, v, do, is_causal=True, window=W)
        band = (jnp.arange(1024)[None, :]
                > jnp.arange(1024)[:, None] - W)[None, None]
        assert_close_grads(
            got, exact_vjp(q, k, v, do, is_causal=True, mask=band)
        )


class TestBiasGradients:
    def test_bias_path_differentiable_all_args(self):
        """sageattn(attn_bias=...) is differentiable w.r.t. q/k/v AND
        the bias (beyond the forward-only reference); gradients match
        the exact reference VJP."""
        q, k, v = (rand(i + 90, (1, 2, 128, 64)) for i in range(3))
        bias = rand(93, (1, 2, 128, 128)) * 0.5
        do = rand(94, (1, 2, 128, 64))

        f = lambda q, k, v, b: jnp.vdot(
            sa.sageattn(q, k, v, attn_bias=b), do)
        g = jax.grad(f, argnums=(0, 1, 2, 3))(q, k, v, bias)
        fe = lambda q, k, v, b: jnp.vdot(
            reference.attention_reference(q, k, v, attn_bias=b), do)
        ge = jax.grad(fe, argnums=(0, 1, 2, 3))(q, k, v, bias)
        assert_close_grads(g, ge)

    def test_fused_bias_backward_blockwise(self):
        """The blockwise dS (== dBias) output across causal / non-causal
        / GQA and a head-broadcast bias, vs the exact VJP."""
        from sageattention_jax.ops import autodiff

        for causal, hkv, hb in [(False, 2, 2), (True, 2, 2), (False, 1, 1)]:
            b, h, s, d = 1, 2, 256, 64
            q = rand(100, (b, h, s, d))
            k = rand(101, (b, hkv, s, d))
            v = rand(102, (b, hkv, s, d))
            bias = rand(103, (b, hb, s, s)) * 0.5
            do = rand(104, (b, h, s, d))
            got = autodiff.attention_vjp(q, k, v, do, bias=bias,
                                         is_causal=causal, pv_dtype="bf16")
            assert got[3].shape == bias.shape
            ref = exact_vjp(q, k, v, do, is_causal=causal, bias=bias)
            assert_close_grads(got, ref)

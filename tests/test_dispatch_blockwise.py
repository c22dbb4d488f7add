"""The path choice of core.py, and the blockwise plain path against the
materialized quantized reference on the same codes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sageattention_jax as sa
from sageattention_jax import core
from sageattention_jax.ops import blockwise, reference

LOG2E = 1.4426950408889634

NONE = dict(masked=False, segments=False, positions=False, window=None,
            smooth_q=False, qk_quant_gran="auto")


@pytest.mark.parametrize("features,backend,expected", [
    ({}, "gpu", "pallas"),
    ({}, "cpu", "xla"),
    ({"masked": True}, "gpu", "xla"),
    ({"segments": True}, "gpu", "xla"),
    ({"positions": True}, "gpu", "xla"),
    ({"window": 128}, "gpu", "xla"),
    ({"smooth_q": True}, "gpu", "xla"),
    ({"qk_quant_gran": "per_token"}, "gpu", "xla"),
    ({"masked": True}, "cpu", "xla"),
])
def test_auto_dispatch_rule(features, backend, expected):
    ok = core.kernel_features_ok(**{**NONE, **features})
    assert core.choose_impl("auto", backend=backend, kernel_ok=ok) == expected


@pytest.mark.parametrize("impl,backend,ok,interpret,expected", [
    ("pallas", "gpu", True, False, "pallas"),
    ("pallas", "cpu", True, True, "pallas"),
    ("xla", "gpu", True, False, "xla"),
    ("xla", "cpu", False, False, "xla"),
])
def test_explicit_impl(impl, backend, ok, interpret, expected):
    assert core.choose_impl(impl, backend=backend, kernel_ok=ok,
                            interpret=interpret) == expected


@pytest.mark.parametrize("impl,backend,ok,match", [
    ("auto", "tpu", True, "no path"),
    ("pallas", "gpu", False, "impl='pallas' takes"),
    ("pallas", "cpu", True, "interpret=True"),
    ("cuda", "gpu", True, "impl must be"),
])
def test_dispatch_errors(impl, backend, ok, match):
    with pytest.raises(ValueError, match=match):
        core.choose_impl(impl, backend=backend, kernel_ok=ok)


def _inputs(b=1, hq=2, hkv=2, sq=150, sk=150, d=64, seed=0, pv="int8",
            smooth_q=False, gran="auto"):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(ks[0], (b, hq, sq, d))
    k = jax.random.normal(ks[1], (b, hkv, sk, d))
    v = jax.random.normal(ks[2], (b, hkv, sk, d))
    qz = core.quantize_operands(
        q, k, v, sm_scale=d**-0.5, qk_quant_gran=gran, pv_dtype=pv,
        smooth_k=True, smooth_q=smooth_q, smooth_v=False, qk_bits=8,
        k_group=32,
    )
    return qz


def _seg(s, cut):
    return (jnp.arange(s) >= cut).astype(jnp.int32)[None]


CASES = {
    "mask": lambda sq, sk: dict(attn_mask=jax.random.bernoulli(
        jax.random.PRNGKey(5), 0.7, (1, 1, sq, sk))),
    "bias": lambda sq, sk: dict(score_bias=jax.random.normal(
        jax.random.PRNGKey(6), (1, 2, sq, sk)) * LOG2E),
    "segments": lambda sq, sk: dict(q_segment_ids=_seg(sq, 60),
                                    kv_segment_ids=_seg(sk, 60)),
    "positions": lambda sq, sk: dict(
        q_positions=jnp.arange(sq, dtype=jnp.int32)[None] + 40,
        kv_positions=jnp.arange(sk, dtype=jnp.int32)[None]),
    "causal": lambda sq, sk: dict(is_causal=True),
    "causal_mask": lambda sq, sk: dict(is_causal=True, attn_mask=(
        jax.random.bernoulli(jax.random.PRNGKey(7), 0.8, (1, 2, sq, sk)))),
}


@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_matches_quantized_reference(case, gqa):
    """Chunked over KV (chunk 64, ragged tail) and merged by LSE, the
    blockwise path is the reference's arithmetic to fp32 roundoff."""
    qz = _inputs(hq=2, hkv=1 if gqa else 2)
    sq, sk = qz.q_i8.shape[2], qz.k_i8.shape[2]
    kw = CASES[case](sq, sk)
    args = (qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale_rows(), qz.v_q,
            qz.v_scale)
    o, lse = blockwise.attention_fwd(*args, chunk=64, out_dtype=jnp.float32,
                                     **kw)
    o_r, lse_r = reference.quantized_attention_reference(
        *args, return_lse=True, out_dtype=jnp.float32, **kw)
    live = np.asarray(jnp.isfinite(lse))
    assert live.any()
    np.testing.assert_allclose(np.asarray(o)[live], np.asarray(o_r)[live],
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(lse)[live],
                               np.asarray(lse_r)[live], atol=2e-4)


def test_blockwise_window_matches_band_reference():
    qz = _inputs(sq=200, sk=200)
    args = (qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale_rows(), qz.v_q,
            qz.v_scale)
    o, _ = blockwise.attention_fwd(*args, is_causal=True, window=50,
                                   chunk=64, out_dtype=jnp.float32)
    o_r = reference.quantized_attention_reference(
        *args, is_causal=True, attn_mask=reference.window_band_mask(
            200, 200, 50), out_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_r), atol=2e-5)


def test_blockwise_smooth_q_and_per_token_gran():
    """smooth_q's column bias and a per-row K granularity ride the
    blockwise path unchanged."""
    qz = _inputs(smooth_q=True, gran="per_token")
    assert qz.score_col_bias is not None and qz.k_group == 1
    args = (qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale_rows(), qz.v_q,
            qz.v_scale)
    o, _ = blockwise.attention_fwd(*args, score_col_bias=qz.score_col_bias,
                                   chunk=64, out_dtype=jnp.float32)
    o_r = reference.quantized_attention_reference(
        *args, score_col_bias=qz.score_col_bias, out_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_r), atol=2e-5)


def test_blockwise_dead_rows_are_zero():
    """Rows with no live key in any chunk: o = 0 and lse = -inf (not the
    reference's uniform average over masked keys)."""
    qz = _inputs(sq=100, sk=100)
    mask = jnp.ones((1, 1, 100, 100), bool).at[:, :, 7].set(False)
    args = (qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale_rows(), qz.v_q,
            qz.v_scale)
    o, lse = blockwise.attention_fwd(*args, attn_mask=mask, chunk=32,
                                     out_dtype=jnp.float32)
    assert float(jnp.max(jnp.abs(o[:, :, 7]))) == 0.0
    assert bool(jnp.all(jnp.isneginf(lse[:, :, 7])))
    assert bool(jnp.all(jnp.isfinite(jnp.delete(lse, 7, axis=2))))


def test_varlen_routes_to_blockwise():
    """sageattn_varlen is segment masking on the blockwise path and equals
    attention per sequence."""
    lens, h, d = [40, 88], 2, 32
    q, k, v = (jax.random.normal(jax.random.PRNGKey(i), (128, h, d))
               for i in range(3))
    cu = jnp.array([0, 40, 128], jnp.int32)
    o = sa.sageattn_varlen(q, k, v, cu, cu, pv_dtype="bf16")
    for lo, hi in ((0, 40), (40, 128)):
        ref = reference.attention_reference(
            *(jnp.swapaxes(x[lo:hi], 0, 1)[None] for x in (q, k, v)))
        got = jnp.swapaxes(o[lo:hi], 0, 1)[None]
        c = float(jnp.sum(got * ref) / (jnp.linalg.norm(got)
                                        * jnp.linalg.norm(ref)))
        assert c > 0.999

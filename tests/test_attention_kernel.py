"""The fused Hopper kernel (Pallas through Triton) vs the unfused oracle,
in the Pallas interpreter on CPU.

The correctness contract: the kernel must match
``reference.quantized_attention_reference`` on the same quantized
operands up to the order of fp32 sums and the bf16 rounding of P (the
kernel's P·V operand); against the exact fp32 reference it must reach
the quantization-level cosine.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sageattention_jax as sa
from sageattention_jax import core
from sageattention_jax.ops import attention_triton, reference

LOG2E = 1.4426950408889634


def rand(key, shape, scale=1.0):
    return jax.random.normal(jax.random.PRNGKey(key), shape) * scale


def make_inputs(b=1, h=2, hkv=None, sq=128, sk=128, d=64, seed=0):
    hkv = hkv or h
    q = rand(seed, (b, h, sq, d))
    k = rand(seed + 1, (b, hkv, sk, d))
    v = rand(seed + 2, (b, hkv, sk, d))
    return q, k, v


def quantize_all(q, k, v, pv="bf16", block_k=64, smooth_v=False):
    return core.quantize_operands(
        q, k, v, sm_scale=q.shape[-1] ** -0.5, qk_quant_gran="auto",
        pv_dtype=pv, smooth_k=True, smooth_q=False, smooth_v=smooth_v,
        qk_bits=8, k_group=block_k,
    )


def kernel(qz, *, is_causal=False, return_lse=True, block_q=64,
           block_k=64):
    return attention_triton.sage_attention_fwd(
        qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale, qz.v_q, qz.v_scale,
        qz.v_mean, is_causal=is_causal, return_lse=return_lse,
        block_q=block_q, block_k=block_k, out_dtype=jnp.float32,
        interpret=True,
    )


def oracle(qz, *, is_causal=False):
    return reference.quantized_attention_reference(
        qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale_rows(), qz.v_q,
        qz.v_scale, qz.v_mean, is_causal=is_causal, return_lse=True,
        out_dtype=jnp.float32,
    )


def cosine(a, b):
    a = jnp.asarray(a, jnp.float32).ravel()
    b = jnp.asarray(b, jnp.float32).ravel()
    return float(jnp.dot(a, b) / (jnp.linalg.norm(a) * jnp.linalg.norm(b)))


def max_abs(a, b):
    return float(jnp.max(jnp.abs(jnp.asarray(a, jnp.float32)
                                 - jnp.asarray(b, jnp.float32))))


# bf16 rounding of P (|P| <= 1, 8 significant bits) bounds the kernel's
# difference from the f32 oracle; outputs here are O(1)
O_ATOL = 1e-2
LSE_ATOL = 1e-4


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("pv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("is_causal", [False, True])
def test_kernel_matches_quantized_oracle(is_causal, gqa, pv, ragged, d):
    """causal x GQA x pv_dtype x ragged length x head dim."""
    s = 100 if ragged else 128
    q, k, v = make_inputs(h=4, hkv=2 if gqa else 4, sq=s, sk=s, d=d,
                          seed=7)
    qz = quantize_all(q, k, v, pv=pv)
    o, lse = kernel(qz, is_causal=is_causal)
    o_r, lse_r = oracle(qz, is_causal=is_causal)
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    assert max_abs(o, o_r) < O_ATOL
    assert max_abs(lse, lse_r) < LSE_ATOL
    assert cosine(o, o_r) > 0.9999


class TestFusedVsOracle:
    @pytest.mark.parametrize("is_causal", [False, True])
    def test_bf16_pv(self, is_causal):
        q, k, v = make_inputs(sq=256, sk=256)
        qz = quantize_all(q, k, v)
        o, _ = kernel(qz, is_causal=is_causal)
        o_r, _ = oracle(qz, is_causal=is_causal)
        assert max_abs(o, o_r) < O_ATOL

    def test_lse(self):
        """Base-2 LSE of the smoothed logits, exactly the oracle's."""
        q, k, v = make_inputs(sq=192, sk=256)
        qz = quantize_all(q, k, v)
        _, lse = kernel(qz)
        _, lse_r = oracle(qz)
        np.testing.assert_allclose(
            np.asarray(lse), np.asarray(lse_r), atol=LSE_ATOL
        )

    def test_gqa(self):
        q, k, v = make_inputs(h=8, hkv=2)
        qz = quantize_all(q, k, v)
        o, _ = kernel(qz)
        o_r, _ = oracle(qz)
        assert max_abs(o, o_r) < O_ATOL

    def test_segments(self):
        """Segment ids are not a kernel feature: auto sends them to the
        blockwise path even on a GPU, and impl='pallas' refuses them."""
        q, k, v = make_inputs(sq=128, sk=128)
        seg = (jnp.arange(128) // 50).astype(jnp.int32)[None]
        assert core.choose_impl(
            "auto", backend="gpu",
            kernel_ok=core.kernel_features_ok(
                masked=False, segments=True, positions=False, window=None,
                smooth_q=False, qk_quant_gran="auto"),
        ) == "xla"
        with pytest.raises(ValueError, match="impl='pallas'"):
            sa.sageattn(q, k, v, q_segment_ids=seg, kv_segment_ids=seg,
                        impl="pallas", interpret=True)
        o = sa.sageattn(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
        o_ref = reference.attention_reference(
            q, k, v, q_segment_ids=seg, kv_segment_ids=seg
        )
        assert cosine(o, o_ref) > 0.999

    def test_int8_pv_with_vscale_and_vmean(self):
        """Per-channel V scale and smooth_v mean ride the epilogue."""
        q, k, v = make_inputs()
        v = v + 3.0
        qz = quantize_all(q, k, v, pv="int8", smooth_v=True)
        assert qz.v_mean is not None
        o, _ = kernel(qz)
        o_r, _ = oracle(qz)
        assert max_abs(o, o_r) < O_ATOL

    def test_int8_pv_accuracy_vs_fp32(self):
        q, k, v = make_inputs(sq=256, sk=256)
        qz = quantize_all(q, k, v, pv="int8")
        o, _ = kernel(qz)
        assert cosine(o, reference.attention_reference(q, k, v)) > 0.999

    def test_causal_matches_fp32_reference(self):
        q, k, v = make_inputs(sq=256, sk=256, d=128)
        qz = quantize_all(q, k, v)
        o, _ = kernel(qz, is_causal=True)
        o_ref = reference.attention_reference(q, k, v, is_causal=True)
        assert cosine(o, o_ref) > 0.999

    def test_causal_fold_grid_multiblock(self):
        """Causal over many q tiles, with block_q != block_k: the KV loop
        bound and the unmasked/diagonal split per q tile."""
        q, k, v = make_inputs(sq=384, sk=384)
        for bq, bk in ((64, 32), (32, 64)):
            qz = quantize_all(q, k, v, block_k=bk)
            o, lse = kernel(qz, is_causal=True, block_q=bq, block_k=bk)
            o_r, lse_r = oracle(qz, is_causal=True)
            assert max_abs(o, o_r) < O_ATOL, (bq, bk)
            assert max_abs(lse, lse_r) < LSE_ATOL, (bq, bk)

    def test_rectangular_kv(self):
        """sq != sk both ways, non-causal and causal (top-left aligned)."""
        for sq, sk in ((96, 200), (200, 96)):
            q, k, v = make_inputs(sq=sq, sk=sk)
            qz = quantize_all(q, k, v)
            for causal in (False, True):
                o, _ = kernel(qz, is_causal=causal)
                o_r, _ = oracle(qz, is_causal=causal)
                assert max_abs(o, o_r) < O_ATOL, (sq, sk, causal)

    def test_matches_prologue_path(self):
        """The public entry on impl='pallas' (quantize + kernel) equals
        the kernel fed by quantize_operands, and the blockwise path on
        the same codes to the kernel's bf16-P precision."""
        q, k, v = make_inputs(h=4, hkv=2, sq=160, sk=160)
        o_p, lse_p = core._entry(q, k, v, return_lse=True, pv_dtype="int8",
                                 impl="pallas", interpret=True)
        qz = quantize_all(q, k, v, pv="int8",
                          block_k=core.default_blocks(64)[1])
        o_k = attention_triton.sage_attention_fwd(
            qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale, qz.v_q, qz.v_scale,
            qz.v_mean, out_dtype=jnp.float32, interpret=True,
        )
        np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_k),
                                   atol=1e-6)
        o_x, lse_x = core._entry(q, k, v, return_lse=True, pv_dtype="int8",
                                 impl="xla")
        assert max_abs(o_p, o_x) < O_ATOL
        assert max_abs(lse_p, lse_x) < LSE_ATOL


def test_kernel_rejects_mismatched_k_group():
    q, k, v = make_inputs()
    qz = quantize_all(q, k, v, block_k=32)
    with pytest.raises(ValueError, match="tile scales"):
        kernel(qz, block_k=64)


@pytest.mark.parametrize("d,dp", [(16, 16), (48, 64), (64, 64), (96, 128),
                                  (128, 128), (200, 256)])
def test_padded_head_dim(d, dp):
    assert attention_triton.padded_head_dim(d) == dp


def test_kernel_head_dim_padding():
    """A head dim that is not a power of two pads inside the wrapper and
    crops on the way out."""
    q, k, v = make_inputs(d=48, sq=72, sk=72)
    qz = quantize_all(q, k, v)
    o, lse = kernel(qz)
    o_r, lse_r = oracle(qz)
    assert o.shape == q.shape
    assert max_abs(o, o_r) < O_ATOL
    assert max_abs(lse, lse_r) < LSE_ATOL


@pytest.mark.gpu
def test_gpu_kernel_compiles_and_matches(gpu):
    """On the card: the kernel compiled by Triton (no interpreter) at a
    real width matches the quantized oracle."""
    q, k, v = make_inputs(h=4, hkv=2, sq=1024, sk=1024, d=128)
    qz = quantize_all(q, k, v, pv="int8")
    o, lse = jax.jit(functools.partial(
        attention_triton.sage_attention_fwd, is_causal=True,
        return_lse=True, out_dtype=jnp.float32,
    ))(qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale, qz.v_q, qz.v_scale,
       qz.v_mean)
    with jax.default_matmul_precision("highest"):
        o_r, lse_r = oracle(qz, is_causal=True)
    assert max_abs(o, o_r) < O_ATOL
    assert max_abs(lse, lse_r) < LSE_ATOL

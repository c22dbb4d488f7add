"""Torch interop adapter tests (reference parity: the reference API is
torch — core.py:80-158 — and its documented integration is
``F.scaled_dot_product_attention = sageattn``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from sageattention_jax.interop import (
    from_torch,
    patch_torch_sdpa,
    sageattn_torch,
    to_torch,
)


def _cosine(a, b):
    a = a.float().flatten()
    b = b.float().flatten()
    return float((a @ b) / (a.norm() * b.norm() + 1e-30))


def _rand(*shape, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float32).to(dtype)


class TestDlpackBridge:
    def test_round_trip_dtypes(self):
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            t = (torch.arange(24).reshape(2, 3, 4) % 7).to(dtype)
            back = to_torch(from_torch(t))
            assert back.dtype == dtype
            assert torch.equal(back, t)

    def test_bool_round_trip(self):
        t = torch.tensor([[True, False], [False, True]])
        j = from_torch(t)
        assert j.dtype == jnp.bool_
        assert torch.equal(to_torch(j), t)

    def test_noncontiguous_and_grad(self):
        t = _rand(4, 8, dtype=torch.float32).t()  # non-contiguous
        t.requires_grad_(True)
        j = from_torch(t)
        np.testing.assert_allclose(
            np.asarray(j), t.detach().numpy(), rtol=0, atol=0
        )


class TestSageattnTorch:
    def test_matches_torch_sdpa(self):
        q = _rand(2, 4, 128, 64, seed=0)
        k = _rand(2, 4, 128, 64, seed=1)
        v = _rand(2, 4, 128, 64, seed=2)
        out = sageattn_torch(q, k, v)
        ref = torch.nn.functional.scaled_dot_product_attention(
            q.float(), k.float(), v.float()
        )
        assert isinstance(out, torch.Tensor)
        assert out.shape == ref.shape
        assert _cosine(out, ref) > 0.999

    def test_causal_gqa(self):
        q = _rand(1, 8, 128, 64, seed=3)
        k = _rand(1, 2, 128, 64, seed=4)
        v = _rand(1, 2, 128, 64, seed=5)
        out = sageattn_torch(q, k, v, is_causal=True)
        ref = torch.nn.functional.scaled_dot_product_attention(
            q.float(), k.float(), v.float(), is_causal=True,
            enable_gqa=True,
        )
        assert _cosine(out, ref) > 0.999

    def test_bool_mask(self):
        q = _rand(1, 2, 64, 64, seed=6)
        k = _rand(1, 2, 64, 64, seed=7)
        v = _rand(1, 2, 64, 64, seed=8)
        mask = torch.rand(64, 64, generator=torch.Generator()
                          .manual_seed(9)) > 0.3
        mask |= torch.eye(64, dtype=torch.bool)  # no fully-masked rows
        out = sageattn_torch(q, k, v, attn_mask=mask)
        ref = torch.nn.functional.scaled_dot_product_attention(
            q.float(), k.float(), v.float(), attn_mask=mask
        )
        assert _cosine(out, ref) > 0.999

    def test_return_lse_torch_tensors(self):
        q = _rand(1, 2, 64, 64, seed=10)
        k = _rand(1, 2, 64, 64, seed=11)
        v = _rand(1, 2, 64, 64, seed=12)
        o, lse = sageattn_torch(q, k, v, return_lse=True)
        assert isinstance(o, torch.Tensor)
        assert isinstance(lse, torch.Tensor)
        assert lse.shape == (1, 2, 64)


class TestPatchSdpa:
    def test_patch_and_undo(self):
        import torch.nn.functional as F

        orig = F.scaled_dot_product_attention
        q = _rand(1, 2, 64, 64, seed=13)
        k = _rand(1, 2, 64, 64, seed=14)
        v = _rand(1, 2, 64, 64, seed=15)
        undo = patch_torch_sdpa()
        try:
            assert F.scaled_dot_product_attention is not orig
            patched = F.scaled_dot_product_attention(q, k, v,
                                                     is_causal=True)
            direct = sageattn_torch(q, k, v, is_causal=True)
            assert torch.equal(patched, direct)
            with pytest.raises(NotImplementedError):
                F.scaled_dot_product_attention(q, k, v, dropout_p=0.1)
        finally:
            undo()
        assert F.scaled_dot_product_attention is orig

    def test_broadcast_padding_mask(self):
        # the ubiquitous HF key-padding mask: (B, 1, 1, S) broadcastable
        # to (N, H, L, S) — torch SDPA semantics the patch must honor
        import torch.nn.functional as F

        q = _rand(2, 2, 64, 64, seed=19)
        k = _rand(2, 2, 64, 64, seed=20)
        v = _rand(2, 2, 64, 64, seed=21)
        mask = torch.ones(2, 1, 1, 64, dtype=torch.bool)
        mask[0, :, :, 48:] = False  # batch 0: last 16 keys padded
        undo = patch_torch_sdpa()
        try:
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        finally:
            undo()
        ref = torch.nn.functional.scaled_dot_product_attention(
            q.float(), k.float(), v.float(), attn_mask=mask
        )
        assert _cosine(out, ref) > 0.999

    def test_default_kwargs_forwarded(self):
        q = _rand(1, 2, 64, 64, seed=16)
        k = _rand(1, 2, 64, 64, seed=17)
        v = _rand(1, 2, 64, 64, seed=18)
        undo = patch_torch_sdpa(pv_dtype="int8")
        try:
            import torch.nn.functional as F

            out = F.scaled_dot_product_attention(q, k, v)
        finally:
            undo()
        ref = torch.nn.functional.scaled_dot_product_attention(
            q.float(), k.float(), v.float()
        )
        assert _cosine(out, ref) > 0.999

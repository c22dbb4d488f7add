"""Native host library (csrc/host) vs numpy fallback parity, and the
varlen pipeline contract between host prep and device segment ids."""

import numpy as np
import pytest

from sageattention_jax import native


@pytest.fixture(scope="module")
def lens():
    return [5, 1, 17, 128, 3]


def _seqs(lens, trailing=(4, 8), dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, *trailing)).astype(dtype) for n in lens]


class TestPackRagged:
    def test_round_trip(self, lens):
        seqs = _seqs(lens)
        packed, cu = native.pack_ragged(seqs)
        assert packed.shape == (sum(lens), 4, 8)
        assert list(cu) == list(np.concatenate([[0], np.cumsum(lens)]))
        outs = native.unpack_ragged(packed, cu)
        for a, b in zip(outs, seqs):
            np.testing.assert_array_equal(a, b)

    def test_matches_numpy_fallback(self, lens, monkeypatch):
        seqs = _seqs(lens, dtype=np.int8, seed=1)
        packed_n, cu_n = None, None
        # force the fallback
        monkeypatch.setattr(native, "_load", lambda: None)
        packed_n, cu_n = native.pack_ragged(seqs)
        monkeypatch.undo()
        packed, cu = native.pack_ragged(seqs)
        np.testing.assert_array_equal(packed, packed_n)
        np.testing.assert_array_equal(cu, cu_n)

    def test_bf16_via_uint16_view(self, lens):
        # arbitrary dtypes pack byte-wise; emulate bf16 as uint16
        seqs = _seqs(lens, trailing=(8,), dtype=np.float32)
        seqs = [x.view(np.uint32).astype(np.uint16) for x in seqs]
        packed, cu = native.pack_ragged(seqs)
        outs = native.unpack_ragged(packed, cu)
        for a, b in zip(outs, seqs):
            np.testing.assert_array_equal(a, b)


class TestExpandCuSeqlens:
    def test_matches_searchsorted(self, lens):
        cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        total = int(cu[-1])
        seg, pos = native.expand_cu_seqlens(cu)
        idx = np.arange(total)
        ref_seg = np.searchsorted(cu, idx, side="right")
        np.testing.assert_array_equal(seg, ref_seg)
        # positions restart at each boundary
        starts = cu[ref_seg - 1]
        np.testing.assert_array_equal(pos, idx - starts)

    def test_padding_tail(self, lens):
        cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        total = int(cu[-1]) + 7
        seg, pos = native.expand_cu_seqlens(cu, total=total)
        assert (seg[int(cu[-1]):] == len(lens) + 1).all()
        np.testing.assert_array_equal(pos[int(cu[-1]):], np.arange(7))

    def test_fallback_matches_native(self, lens, monkeypatch):
        cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        total = int(cu[-1]) + 3
        seg_a, pos_a = native.expand_cu_seqlens(cu, total=total)
        monkeypatch.setattr(native, "_load", lambda: None)
        seg_b, pos_b = native.expand_cu_seqlens(cu, total=total)
        np.testing.assert_array_equal(seg_a, seg_b)
        np.testing.assert_array_equal(pos_a, pos_b)

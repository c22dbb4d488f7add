"""Randomized serving-stack sweep: decode paths vs the fp32 oracle.

Walks seeded random combinations of context lengths, GQA ratios, query
tile sizes (decode / speculative / chunked prefill), sliding windows,
cache bit widths, and dense-vs-paged storage — the interactions no
hand-picked geometry covers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sageattention_jax as sa


pytestmark = pytest.mark.fuzz

def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def _case(seed):
    r = np.random.RandomState(1000 + seed)
    b = int(r.choice([1, 2]))
    hkv = int(r.choice([1, 2]))
    group = int(r.choice([1, 2, 4]))
    d = int(r.choice([32, 64, 128]))
    max_len = 512
    lens = r.randint(8, max_len - 65, size=b)
    t_q = int(r.choice([1, 1, 3, 16]))  # decode / speculative / extend
    window = int(r.choice([0, 0, 64, 100]))
    bits = int(r.choice([8, 8, 4]))
    paged = bool(r.rand() < 0.4)
    return b, hkv, group, d, max_len, lens, t_q, window, bits, paged


@pytest.mark.parametrize("seed", range(16))
def test_random_decode_matches_oracle(seed):
    b, hkv, group, d, max_len, lens, t_q, window, bits, paged = _case(seed)
    hq = hkv * group
    key = jax.random.PRNGKey(seed)
    kk, kv_, kq = jax.random.split(key, 3)
    fill = int(lens.max())
    k = jax.random.normal(kk, (b, hkv, fill, d))
    v = jax.random.normal(kv_, (b, hkv, fill, d))
    q = jax.random.normal(kq, (b, hq, t_q, d))

    if paged:
        page = 128
        npages = b * (max_len // page)
        rng = np.random.RandomState(seed)
        table = jnp.asarray(
            rng.permutation(npages).reshape(b, max_len // page), jnp.int32
        )
        cache = sa.init_paged_kv_cache(npages, hkv, d, table,
                                       page_size=page, bits=bits)
        if bits == 4:
            cache = sa.calibrate(cache, k, v)
        cache, _ = sa.paged_append(
            cache, jnp.zeros((b,), jnp.int32), k, v
        )
        decode = sa.sageattn_paged_decode
    else:
        cache = sa.init_kv_cache(b, hkv, max_len, d, bits=bits)
        if bits == 4:
            cache = sa.calibrate(cache, k, v)
        cache, _ = sa.append_kv(cache, jnp.zeros((b,), jnp.int32), k, v)
        decode = sa.sageattn_decode

    lengths = jnp.asarray(lens, jnp.int32)
    kw = {} if window == 0 else {"window": window}
    o = decode(q, cache, lengths, **kw)

    thresh = 0.97 if bits == 4 else 0.995
    for bi in range(b):
        L = int(lens[bi])
        kr = jnp.repeat(k[bi:bi + 1, :, :L], group, axis=1)
        vr = jnp.repeat(v[bi:bi + 1, :, :L], group, axis=1)
        s = jnp.einsum(
            "bhqd,bhkd->bhqk", q[bi:bi + 1].astype(jnp.float32),
            kr.astype(jnp.float32),
        ) * d**-0.5
        col = jnp.arange(L)[None, None, None, :]
        row = jnp.arange(t_q)[None, None, :, None]
        pos = L - t_q + row  # global position of each query row
        valid = col <= pos   # causal tail within the new tokens
        if window:
            valid = jnp.logical_and(valid, col > pos - window)
        s = jnp.where(valid, s, -jnp.float32(1e30))
        o_ref = jnp.einsum(
            "bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1),
            vr.astype(jnp.float32),
        )
        c = cosine(o[bi], o_ref[0])
        assert c > thresh, (
            f"seed={seed} b={bi} L={L} t_q={t_q} window={window} "
            f"bits={bits} paged={paged} group={group} d={d} cos={c}"
        )
        assert np.isfinite(np.asarray(o[bi], np.float32)).all()

"""Randomized shape/config sweep: the public API vs the fp32 oracle.

The deterministic tests pin known-interesting geometries; this sweep
walks a seeded random sample of the full config space (odd lengths,
GQA ratios, head dims off the 64/128 grid, causal/window/masks,
pv dtypes) so padding and edge interactions that no hand-picked case
covers still get exercised on every CPU run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sageattention_jax as sa
from sageattention_jax.ops import reference


pytestmark = pytest.mark.fuzz

def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def _case(seed):
    """Deterministic pseudo-random case from the seed (no global RNG)."""
    r = np.random.RandomState(seed)
    hkv = int(r.choice([1, 2]))
    group = int(r.choice([1, 2, 4]))
    d = int(r.choice([32, 48, 64, 80, 128]))
    sq = int(r.randint(3, 400))
    is_causal = bool(r.rand() < 0.5)
    sk = sq if is_causal else int(r.randint(3, 400))
    b = int(r.choice([1, 2]))
    kw = {}
    kind = r.choice(
        ["plain", "window", "mask", "bf16pv", "smoothv", "bias"]
    )
    if kind == "window" and is_causal:
        kw["window"] = int(r.randint(1, sq + 1))
    elif kind == "mask" and not is_causal:
        kw["attn_mask"] = None  # filled below with shapes known
    elif kind == "bias":
        kw["attn_bias"] = None  # filled below (rides the fused kernel)
    elif kind == "bf16pv":
        kw["pv_dtype"] = "bf16"
    elif kind == "smoothv":
        kw["smooth_v"] = True
    return b, hkv, group, d, sq, sk, is_causal, kw, kind


@pytest.mark.parametrize("seed", range(24))
def test_random_case_matches_oracle(seed):
    b, hkv, group, d, sq, sk, is_causal, kw, kind = _case(seed)
    hq = hkv * group
    key = jax.random.PRNGKey(seed)
    kq, kk, kv_, km_ = jax.random.split(key, 4)
    q = jax.random.normal(kq, (b, hq, sq, d))
    k = jax.random.normal(kk, (b, hkv, sk, d))
    v = jax.random.normal(kv_, (b, hkv, sk, d))
    mask = None
    if kind == "mask" and not is_causal:
        # random bool mask with every query row guaranteed one live key
        mask = jax.random.bernoulli(km_, 0.6, (b, 1, sq, sk))
        mask = mask.at[..., 0].set(True)
        kw["attn_mask"] = mask
    bias = None
    if kind == "bias":
        hb = int(np.random.RandomState(seed + 1).choice([1, hq]))
        bias = jax.random.normal(km_, (b, hb, sq, sk)) * 2.0
        kw["attn_bias"] = bias

    o = sa.sageattn(q, k, v, is_causal=is_causal, **kw)

    kr = jnp.repeat(k, group, axis=1)
    vr = jnp.repeat(v, group, axis=1)
    s = jnp.einsum(
        "bhqd,bhkd->bhqk", q.astype(jnp.float32), kr.astype(jnp.float32)
    ) * d**-0.5
    neg = jnp.float32(-1e30)
    if is_causal:
        cm = jnp.arange(sk)[None, :] <= jnp.arange(sq)[:, None]
        if "window" in kw:
            cm = jnp.logical_and(
                cm, jnp.arange(sk)[None, :]
                > jnp.arange(sq)[:, None] - kw["window"]
            )
        s = jnp.where(cm, s, neg)
    if mask is not None:
        s = jnp.where(mask, s, neg)
    if bias is not None:
        s = s + bias.astype(jnp.float32)
    o_ref = jnp.einsum(
        "bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), vr.astype(jnp.float32)
    )
    c = cosine(o, o_ref)
    assert c > 0.995, (
        f"seed={seed} kind={kind} b={b} hq={hq} hkv={hkv} d={d} "
        f"sq={sq} sk={sk} causal={is_causal} kw={list(kw)} cos={c}"
    )
    assert np.isfinite(np.asarray(o, np.float32)).all()

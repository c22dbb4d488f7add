"""Randomized gradient sweep: jax.grad through sageattn vs the exact
oracle's gradients.

The deterministic autodiff tests pin known geometries; this walks seeded
random (shape, causal, window, GQA, pv_dtype) combinations so the fused
backward's config re-derivation, padding, and fallback routing get
exercised off the hand-picked grid.  Quantization noise bounds the
cosine, not equality.
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
    r = np.random.RandomState(2000 + seed)
    b = 1
    hkv = int(r.choice([1, 2]))
    group = int(r.choice([1, 2]))
    d = int(r.choice([32, 64, 128]))
    sq = int(r.choice([128, 192, 256, 300]))
    is_causal = bool(r.rand() < 0.6)
    sk = sq if is_causal else int(r.choice([128, 256, 320]))
    window = 0
    if is_causal and r.rand() < 0.3:
        window = int(r.choice([64, 128]))
    pv = str(r.choice(["bf16", "int8"]))
    return b, hkv, group, d, sq, sk, is_causal, window, pv


@pytest.mark.parametrize("seed", range(12))
def test_random_grads_match_oracle(seed):
    b, hkv, group, d, sq, sk, is_causal, window, pv = _case(seed)
    hq = hkv * group
    key = jax.random.PRNGKey(seed)
    kq, kk, kv_, kd = jax.random.split(key, 4)
    q = jax.random.normal(kq, (b, hq, sq, d))
    k = jax.random.normal(kk, (b, hkv, sk, d))
    v = jax.random.normal(kv_, (b, hkv, sk, d))
    do = jax.random.normal(kd, (b, hq, sq, d))
    kw = {"is_causal": is_causal, "pv_dtype": pv}
    if window:
        kw["window"] = window

    def f_sage(q, k, v):
        return jnp.vdot(
            sa.sageattn(q, k, v, **kw).astype(jnp.float32), do
        )

    def f_ref(q, k, v):
        kr = jnp.repeat(k, group, axis=1)
        vr = jnp.repeat(v, group, axis=1)
        s = jnp.einsum(
            "bhqd,bhkd->bhqk", q.astype(jnp.float32),
            kr.astype(jnp.float32),
        ) * d**-0.5
        if is_causal:
            m = jnp.arange(sk)[None, :] <= jnp.arange(sq)[:, None]
            if window:
                m = jnp.logical_and(
                    m,
                    jnp.arange(sk)[None, :]
                    > jnp.arange(sq)[:, None] - window,
                )
            s = jnp.where(m, s, -jnp.float32(1e30))
        o = jnp.einsum(
            "bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1),
            vr.astype(jnp.float32),
        )
        return jnp.vdot(o, do)

    gs = jax.grad(f_sage, argnums=(0, 1, 2))(q, k, v)
    gr = jax.grad(f_ref, argnums=(0, 1, 2))(q, k, v)
    for name, a, r_ in zip("qkv", gs, gr):
        c = cosine(a, r_)
        assert c > 0.98, (
            f"seed={seed} d{name}: hq={hq} hkv={hkv} d={d} sq={sq} "
            f"sk={sk} causal={is_causal} window={window} pv={pv} cos={c}"
        )
        assert np.isfinite(np.asarray(a, np.float32)).all()

#!/usr/bin/env python
"""Smoke test of the system's main paths on one NVIDIA GPU.

    python chip_smoke.py              # one card: the four phases below
    python chip_smoke.py --cards 4    # four cards: the multi-card paths

One card:

1. kernel   — the fused Hopper kernel, as Triton compiles it, at real
               widths (CogVideoX-2B: hd64, 17,776 tokens; llm-8b-gqa
               prefill: hd128, 32/8 heads, 8,192 tokens, causal, LSE),
               for each pv_dtype, against the quantized reference on the
               same codes and against the exact fp32 oracle;
2. main     — two jitted denoise steps of the full 30-layer CogVideoX-2B
               ``VideoDiT`` at batch 2 (a CFG pair) through
               ``models.set_attention_backend("sage")``, against cuDNN;
3. decode   — int8 dense and paged caches at llm-8b-gqa widths, b4, 32k
               context: an append plus 8 decode steps against the oracle;
4. training — ``jax.grad`` through ``sageattn`` (hd128, s4096, 32/8
               heads) against the exact VJP, timed beside cuDNN's.

Four cards: the CogVideoX-2B step under ``sage_parallel`` on a
(data 1, seq 2, heads 2) mesh against the one-card ``sage`` result, and
``parallel.make_sharded_decode`` on a tp x sp mesh against the one-card
decode.

Weights and data are random, made from ``--seed``.  Every number is
printed beside the card's name and power limit.  A failed check ends the
run with a non-zero exit; the last line, printed only when every phase
passed, is the JSON device record.  There is no CPU fallback: the script
exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

CARD = ""  # "name, power limit" of the card, filled in by main()

# Shapes of the phases (the published widths; see the docstring).
KERNEL_CASES = [
    # name, b, hq, hkv, s, d, causal
    ("cogvideox-2b_2heads", 1, 2, 2, 17776, 64, False),
    ("llm-8b-gqa_prefill", 1, 32, 8, 8192, 128, True),
]
DIT_CONFIG = "cogvideox-2b"
DECODE_SHAPE = dict(b=4, hq=32, hkv=8, d=128, S=32768, page=1024)
TRAIN_SHAPE = dict(b=1, hq=32, hkv=8, s=4096, d=128)


def report(**kw) -> None:
    print(json.dumps({**kw, "card": CARD}), flush=True)


def check(name: str, ok: bool, **detail) -> None:
    if not ok:
        raise AssertionError(f"{name} failed: {detail}")


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def max_abs(a, b) -> float:
    return float(jnp.max(jnp.abs(jnp.asarray(a, jnp.float32)
                                 - jnp.asarray(b, jnp.float32))))


def timed_ms(f, *args, n: int = 5) -> float:
    """Median wall time of ``f(*args)`` over n warm calls, each ended by
    block_until_ready."""
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def use_compile_cache() -> None:
    """$JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".jax_cache"),
        )


# -- phase 1: the kernel at real widths -----------------------------------

def phase_kernel(key) -> None:
    from sageattention_jax import core
    from sageattention_jax.ops import attention_triton, reference

    for name, b, hq, hkv, s, d, causal in KERNEL_CASES:
        kq, kk, kv, key = jax.random.split(key, 4)
        # f32 activations: the exact oracle then measures the quantizers
        # alone (bf16 inputs add their own rounding, PERF.md)
        q = jax.random.normal(kq, (b, hq, s, d), jnp.float32)
        k = jax.random.normal(kk, (b, hkv, s, d), jnp.float32)
        v = jax.random.normal(kv, (b, hkv, s, d), jnp.float32)
        block_k = core.default_blocks(d)[1]
        for pv in ("bf16", "int8", "fp8"):
            qz = core.quantize_operands(
                q, k, v, sm_scale=d**-0.5, qk_quant_gran="auto",
                pv_dtype=pv, smooth_k=True, smooth_q=False, smooth_v=False,
                qk_bits=8, k_group=block_k,
            )
            fwd = jax.jit(functools.partial(
                attention_triton.sage_attention_fwd, is_causal=causal,
                return_lse=True, out_dtype=jnp.bfloat16,
            ))
            args = (qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale, qz.v_q,
                    qz.v_scale, qz.v_mean)
            t0 = time.perf_counter()
            o, lse2 = jax.block_until_ready(fwd(*args))
            compile_s = time.perf_counter() - t0
            ms = timed_ms(fwd, *args)
            # references one kv-head group at a time: their [sq, sk]
            # scores must fit beside everything else
            g = hq // hkv
            stats = {"cos_q": [], "max_q": [], "lse_q": [], "cos_x": [],
                     "max_x": []}
            k_rows = qz.k_scale_rows()
            with jax.default_matmul_precision("highest"):
                for h in range(hkv):
                    qs = slice(h * g, (h + 1) * g)
                    ks = slice(h, h + 1)
                    o_r, lse_r = jax.jit(functools.partial(
                        reference.quantized_attention_reference,
                        is_causal=causal, return_lse=True,
                        out_dtype=jnp.float32,
                    ))(qz.q_i8[:, qs], qz.q_scale[:, qs], qz.k_i8[:, ks],
                       k_rows[:, ks], qz.v_q[:, ks],
                       None if qz.v_scale is None else qz.v_scale[:, ks],
                       None if qz.v_mean is None else qz.v_mean[:, ks])
                    o_x = reference.attention_reference(
                        q[:, qs], jnp.repeat(k[:, ks], g, axis=1),
                        jnp.repeat(v[:, ks], g, axis=1), is_causal=causal,
                    )
                    stats["cos_q"].append(cosine(o[:, qs], o_r))
                    stats["max_q"].append(max_abs(o[:, qs], o_r))
                    stats["lse_q"].append(max_abs(lse2[:, qs], lse_r))
                    stats["cos_x"].append(cosine(o[:, qs], o_x))
                    stats["max_x"].append(max_abs(o[:, qs], o_x))
                    del o_r, lse_r, o_x
            res = dict(
                phase="kernel", case=name, pv_dtype=pv,
                compile_s=compile_s, kernel_ms=ms,
                cos_vs_quantized_ref=min(stats["cos_q"]),
                max_abs_vs_quantized_ref=max(stats["max_q"]),
                lse_max_abs_vs_quantized_ref=max(stats["lse_q"]),
                cos_vs_exact=min(stats["cos_x"]),
                max_abs_vs_exact=max(stats["max_x"]),
            )
            report(**res)
            # against the same codes: fp32 sum order and bf16 P / output
            check(name, res["cos_vs_quantized_ref"] >= 0.99999, **res)
            check(name, res["max_abs_vs_quantized_ref"] <= 1e-2, **res)
            check(name, res["lse_max_abs_vs_quantized_ref"] <= 1e-3, **res)
            # against exact attention the quantization dominates; e4m3
            # keeps 3 mantissa bits, so a row that attends few keys copies
            # their V with up to 2^-4 relative error (|v| reaches ~4.5)
            check(name, res["cos_vs_exact"] >= 0.999, **res)
            check(name, res["max_abs_vs_exact"]
                  <= (0.3 if pv == "fp8" else 0.05), **res)


# -- phase 2: the full CogVideoX-2B denoise step ---------------------------

def cogvideox_inputs(key, b: int = 2):
    from sageattention_jax import models
    from sageattention_jax.models.configs import MODEL_CONFIGS

    cfg = MODEL_CONFIGS[DIT_CONFIG]
    model = models.VideoDiT(cfg)
    k1, k2, k3 = jax.random.split(key, 3)
    lat = jax.random.normal(
        k1, (b, cfg.latent_frames, cfg.latent_height, cfg.latent_width,
             model.latent_channels), jnp.bfloat16)
    # T5-XXL text embeddings (4096 wide), as CogVideoX conditions on
    txt = jax.random.normal(k2, (b, cfg.text_len, 4096), jnp.bfloat16)
    t = jnp.full((b,), 999, jnp.int32)
    params = jax.jit(model.init)(k3, lat, txt, t)
    return cfg, model, params, lat, txt, t


def phase_main(key) -> None:
    from sageattention_jax import models

    cfg, model, params, lat, txt, t = cogvideox_inputs(key)
    n_params = sum(x.size for x in jax.tree.leaves(params))

    def make_step():
        # a fresh function per backend: jit caches traces per function,
        # and the backend is read when the step is traced
        def denoise_step(params, lat, txt, t):
            eps = model.apply(params, lat, txt, t)
            return lat - (1.0 / 50) * eps.astype(lat.dtype), eps

        return jax.jit(denoise_step)

    results = {}
    for backend in ("sage", "flash"):
        models.set_attention_backend(backend)
        step = make_step()
        lowered = step.lower(params, lat, txt, t)
        if backend == "sage":
            # the main path runs the fused kernel, not the plain path
            check("main", "sage_attention_fwd" in lowered.as_text(),
                  note="sage_attention_fwd missing from the lowered step")
        t0 = time.perf_counter()
        compiled = lowered.compile()
        compile_s = time.perf_counter() - t0
        x, eps = compiled(params, lat, txt, t)
        x, _ = jax.block_until_ready(compiled(params, x, txt, t - 20))
        step_ms = timed_ms(compiled, params, lat, txt, t, n=3)
        finite = bool(jnp.all(jnp.isfinite(eps.astype(jnp.float32)))
                      & jnp.all(jnp.isfinite(x.astype(jnp.float32))))
        results[backend] = eps
        report(phase="main", backend=backend, model=cfg.name,
               depth=cfg.depth, batch=lat.shape[0], seq=cfg.seq_len,
               params=n_params, compile_s=compile_s, step_ms=step_ms,
               peak_bytes_in_use=(jax.devices()[0].memory_stats() or {}).get(
                   "peak_bytes_in_use"),
               finite=finite)
        check("main", finite, backend=backend)
    models.set_attention_backend("sage")
    c = cosine(results["sage"], results["flash"])
    report(phase="main", eps_cos_sage_vs_cudnn=c)
    check("main", c >= 0.999, eps_cos_sage_vs_cudnn=c)


# -- phase 3: decode over int8 caches ---------------------------------------

def decode_oracle(q, k, v):
    """Exact fp32 decode: q [b, hq, 1, d] over k/v [b, hkv, L, d]."""
    g = q.shape[1] // k.shape[1]
    with jax.default_matmul_precision("highest"):
        s = jnp.einsum("bhgd,bhld->bhgl",
                       q.reshape(q.shape[0], k.shape[1], g, -1), k)
        p = jax.nn.softmax(s * q.shape[-1] ** -0.5, axis=-1)
        o = jnp.einsum("bhgl,bhld->bhgd", p, v)
    return o.reshape(q.shape)


def phase_decode(key) -> None:
    import sageattention_jax as sa

    b, hq, hkv, d, S, page = (DECODE_SHAPE[x] for x in
                              ("b", "hq", "hkv", "d", "S", "page"))
    steps = 8
    kk, kv, kq, kp, key = jax.random.split(key, 5)
    k_all = jax.random.normal(kk, (b, hkv, S, d), jnp.bfloat16)
    v_all = jax.random.normal(kv, (b, hkv, S, d), jnp.bfloat16)
    q_all = jax.random.normal(kq, (steps, b, hq, 1, d), jnp.bfloat16)
    L0 = S - steps

    dense = sa.init_kv_cache(b, hkv, S, d)
    dense, lengths = jax.jit(sa.append_kv)(
        dense, jnp.zeros((b,), jnp.int32), k_all[:, :, :L0], v_all[:, :, :L0]
    )
    n_pages = S // page
    table = jax.random.permutation(kp, b * n_pages).reshape(b, n_pages)
    paged = sa.init_paged_kv_cache(b * n_pages, hkv, d, table.astype(
        jnp.int32), page_size=page)
    n_full = L0 // page * page
    paged, plen = sa.paged_prefill(paged, k_all[:, :, :n_full],
                                   v_all[:, :, :n_full])
    paged, plen = sa.paged_append(paged, plen, k_all[:, :, n_full:L0],
                                  v_all[:, :, n_full:L0])

    @jax.jit
    def dense_step(cache, lengths, q, k_new, v_new):
        cache, lengths = sa.append_kv(cache, lengths, k_new, v_new)
        return cache, lengths, sa.sageattn_decode(q, cache, lengths)

    @jax.jit
    def paged_step(cache, lengths, q, k_new, v_new):
        cache, lengths = sa.paged_append(cache, lengths, k_new, v_new)
        return cache, lengths, sa.sageattn_paged_decode(q, cache, lengths)

    worst = {"dense": 1.0, "paged": 1.0}
    for i in range(steps):
        sl = slice(L0 + i, L0 + i + 1)
        k_new, v_new = k_all[:, :, sl], v_all[:, :, sl]
        dense, lengths, o_d = dense_step(dense, lengths, q_all[i], k_new,
                                         v_new)
        paged, plen, o_p = paged_step(paged, plen, q_all[i], k_new, v_new)
        ref = decode_oracle(q_all[i].astype(jnp.float32),
                            k_all[:, :, :L0 + i + 1].astype(jnp.float32),
                            v_all[:, :, :L0 + i + 1].astype(jnp.float32))
        worst["dense"] = min(worst["dense"], cosine(o_d, ref))
        worst["paged"] = min(worst["paged"], cosine(o_p, ref))
    check("decode", int(lengths[0]) == S and int(plen[0]) == S,
          lengths=int(lengths[0]), paged_lengths=int(plen[0]))

    # one decode step over the full cache, timed alone; the bytes it must
    # read are the int8 K/V codes plus their f32 per-token scales
    q = q_all[-1]
    ms_dense = timed_ms(jax.jit(sa.sageattn_decode), q, dense, lengths,
                        n=20)
    ms_paged = timed_ms(jax.jit(sa.sageattn_paged_decode), q, paged, plen,
                        n=20)
    cache_bytes = 2 * b * hkv * S * (d + 4)
    for kind, ms in (("dense", ms_dense), ("paged", ms_paged)):
        report(phase="decode", cache=kind, batch=b, context=S, kv_heads=hkv,
               head_dim=d, cos_vs_oracle_min=worst[kind], step_ms=ms,
               cache_bytes=cache_bytes,
               share_of_3_35_TBps=cache_bytes / (ms * 1e-3) / 3.35e12)
        check("decode", worst[kind] >= 0.999, cache=kind, cos=worst[kind])


# -- phase 4: training through sageattn -------------------------------------

def phase_training(key) -> None:
    import sageattention_jax as sa
    from sageattention_jax.ops import reference

    b, hq, hkv, s, d = (TRAIN_SHAPE[x] for x in ("b", "hq", "hkv", "s", "d"))
    kq, kk, kv, kd = jax.random.split(key, 4)
    q = jax.random.normal(kq, (b, hq, s, d), jnp.bfloat16)
    k = jax.random.normal(kk, (b, hkv, s, d), jnp.bfloat16)
    v = jax.random.normal(kv, (b, hkv, s, d), jnp.bfloat16)
    do = jax.random.normal(kd, (b, hq, s, d), jnp.bfloat16)

    def loss_sage(q, k, v):
        o = sa.sageattn(q, k, v, is_causal=True)
        return jnp.vdot(o.astype(jnp.float32), do.astype(jnp.float32))

    def loss_exact(q, k, v):
        g = hq // hkv
        o = reference.attention_reference(
            q, jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1),
            is_causal=True,
        )
        return jnp.vdot(o.astype(jnp.float32), do.astype(jnp.float32))

    def loss_cudnn(q, k, v):
        o = jax.nn.dot_product_attention(
            *(jnp.swapaxes(x, 1, 2) for x in (q, k, v)), is_causal=True,
            implementation="cudnn",
        )
        return jnp.vdot(jnp.swapaxes(o, 1, 2).astype(jnp.float32),
                        do.astype(jnp.float32))

    grad_sage = jax.jit(jax.grad(loss_sage, argnums=(0, 1, 2)))
    grad_cudnn = jax.jit(jax.grad(loss_cudnn, argnums=(0, 1, 2)))
    g_sage = grad_sage(q, k, v)
    with jax.default_matmul_precision("highest"):
        g_ref = jax.jit(jax.grad(loss_exact, argnums=(0, 1, 2)))(
            *(x.astype(jnp.float32) for x in (q, k, v)))
    cos = [cosine(a, r) for a, r in zip(g_sage, g_ref)]
    del g_ref
    report(phase="training", heads=f"{hq}/{hkv}", seq=s, head_dim=d,
           causal=True, cos_dq_dk_dv_vs_exact=cos)
    check("training", min(cos) >= 0.999, cos=cos)
    report(phase="training", sage_fwd_bwd_ms=timed_ms(grad_sage, q, k, v),
           cudnn_fwd_bwd_ms=timed_ms(grad_cudnn, q, k, v))


# -- four cards ---------------------------------------------------------------

def phase_cards4_dit(key) -> None:
    from sageattention_jax import models, parallel

    cfg, model, params, lat, txt, t = cogvideox_inputs(key)
    # one function object per backend: jit caches traces per function
    models.set_attention_backend("sage")
    one = jax.block_until_ready(
        jax.jit(lambda *a: model.apply(*a))(params, lat, txt, t))
    models.set_mesh(parallel.make_mesh(data=1, seq=2, heads=2))
    models.set_attention_backend("sage_parallel")
    apply4 = jax.jit(lambda *a: model.apply(*a))
    t0 = time.perf_counter()
    four = jax.block_until_ready(apply4(params, lat, txt, t))
    first_s = time.perf_counter() - t0
    step_ms = timed_ms(apply4, params, lat, txt, t, n=3)
    models.set_attention_backend("sage")
    c = cosine(four, one)
    finite = bool(jnp.all(jnp.isfinite(four.astype(jnp.float32))))
    report(phase="cards4_dit", mesh="data1 x seq2 x heads2",
           model=cfg.name, batch=lat.shape[0], seq=cfg.seq_len,
           compile_and_first_s=first_s, step_ms=step_ms,
           eps_cos_vs_one_card=c, finite=finite)
    check("cards4_dit", finite and c >= 0.999, cos=c)


def phase_cards4_decode(key) -> None:
    import sageattention_jax as sa
    from jax.sharding import Mesh

    b, hq, hkv, d, S = (DECODE_SHAPE[x] for x in ("b", "hq", "hkv", "d", "S"))
    kk, kv, kq = jax.random.split(key, 3)
    k = jax.random.normal(kk, (b, hkv, S, d), jnp.bfloat16)
    v = jax.random.normal(kv, (b, hkv, S, d), jnp.bfloat16)
    q = jax.random.normal(kq, (b, hq, 1, d), jnp.bfloat16)
    cache = sa.init_kv_cache(b, hkv, S, d)
    cache, lengths = jax.jit(sa.append_kv)(
        cache, jnp.zeros((b,), jnp.int32), k, v)
    lengths = jnp.array([S, S - S // 32, S // 2, S // 40], jnp.int32)
    one = sa.sageattn_decode(q, cache, lengths)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("tp", "sp"))
    fn = sa.parallel.make_sharded_decode(mesh, axis="sp", head_axis="tp")
    four = fn(q, cache, lengths)
    c = cosine(four, one)
    m = max_abs(four, one)
    report(phase="cards4_decode", mesh="tp2 x sp2", batch=b, context=S,
           cos_vs_one_card=c, max_abs_vs_one_card=m,
           step_ms=timed_ms(fn, q, cache, lengths, n=10))
    # the shards' partials merge exactly up to fp32 order and the bf16
    # output rounding
    check("cards4_decode", c >= 0.9999 and m <= 2e-2, cos=c, max_abs=m)


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found "
              f"{devices[0].platform}", file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX found "
              f"{len(devices)} devices", file=sys.stderr)
        return 2
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    use_compile_cache()
    print(CARD, flush=True)
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
          flush=True)

    key = jax.random.PRNGKey(args.seed)
    phases = (
        [phase_cards4_dit, phase_cards4_decode] if args.cards == 4
        else [phase_kernel, phase_main, phase_decode, phase_training]
    )
    for i, phase in enumerate(phases):
        t0 = time.perf_counter()
        phase(jax.random.fold_in(key, i))
        report(phase=phase.__name__, wall_s=time.perf_counter() - t0)

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

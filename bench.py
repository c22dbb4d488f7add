#!/usr/bin/env python
"""Benchmark of sageattention_jax on one NVIDIA GPU.

Prints one JSON line per metric to stdout:

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {...}, "card": "<name>, <power limit>"}

``vs_baseline`` is (baseline time) / (sage time) on the same shape, where
the baseline is cuDNN's bf16 fused attention
(``jax.nn.dot_product_attention(implementation="cudnn")``, NVIDIA's
library kernel); null where a metric has no baseline.  The attention TOPS
follow the reference protocol (bench/README.md:33-63):
4*h*b*hd*s^2/(2 if causal)/time.  Times are medians of warm calls, each
ended by ``block_until_ready``.

Sections (``--only a,b`` runs a subset): headline, roofline, decode,
accuracy, e2e, train, op_total, window, matrix.  A section that raises is
reported as FAILED in the closing ``summary_all`` line and the script
exits non-zero.

Usage: python bench.py [--only e2e,matrix]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

from bench.utils import (
    attention_flops,
    card,
    device_record,
    require_gpu,
    time_ms,
    use_compile_cache,
)

CARD = ""
DEVICE = {}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(metric: str, value, unit: str, vs_baseline=None) -> None:
    print(json.dumps({
        "metric": metric, "value": value, "unit": unit,
        "vs_baseline": vs_baseline, "device": DEVICE, "card": CARD,
    }), flush=True)


def qkv(key, b, hq, hkv, s, d, dtype=jnp.bfloat16):
    kq, kk, kv = jax.random.split(key, 3)
    return (jax.random.normal(kq, (b, hq, s, d), dtype),
            jax.random.normal(kk, (b, hkv, s, d), dtype),
            jax.random.normal(kv, (b, hkv, s, d), dtype))


def cudnn_fn(causal: bool):
    """cuDNN's bf16 fused attention on HND tensors."""
    from sageattention_jax import baselines

    return jax.jit(functools.partial(baselines.cudnn, is_causal=causal))


def sage_fn(causal: bool, **kw):
    import sageattention_jax as sa

    return jax.jit(lambda q, k, v: sa.sageattn(q, k, v, is_causal=causal,
                                               **kw))


def attention_row(name, b, hq, hkv, s, d, causal, **kw):
    """sageattn (quant prologue + attention) vs cuDNN at one shape."""
    q, k, v = qkv(jax.random.PRNGKey(s + d), b, hq, hkv, s, d)
    t_sage = time_ms(sage_fn(causal, **kw), q, k, v)
    t_base = time_ms(cudnn_fn(causal), q, k, v)
    tops = attention_flops(b, hq, s, d, causal) / (t_sage * 1e-3) / 1e12
    emit(name, tops, "TOPS", t_base / t_sage)
    log(f"{name}: sage {t_sage:.3f} ms, cudnn {t_base:.3f} ms")


def sec_headline():
    attention_row("sage_TOPS_s4096_hd128", 4, 32, 32, 4096, 128, False)


def sec_op_total():
    attention_row("sage_op_total_TOPS_s4096_hd64", 4, 32, 32, 4096, 64,
                  False)


def sec_matrix():
    """The kernel alone (operands quantized outside the timing) vs cuDNN:
    b4 h32, hd 64/128, 1k-16k, +-causal."""
    from sageattention_jax import core
    from sageattention_jax.ops import attention_triton

    for d in (64, 128):
        for s in (1024, 4096, 16384):
            for causal in (False, True):
                q, k, v = qkv(jax.random.PRNGKey(s), 4, 32, 32, s, d)
                qz = core.quantize_operands(
                    q, k, v, sm_scale=d**-0.5, qk_quant_gran="auto",
                    pv_dtype="bf16", smooth_k=True, smooth_q=False,
                    smooth_v=False, qk_bits=8,
                    k_group=core.default_blocks(d)[1],
                )
                f = jax.jit(functools.partial(
                    attention_triton.sage_attention_fwd, is_causal=causal))
                t = time_ms(f, qz.q_i8, qz.q_scale, qz.k_i8, qz.k_scale,
                            qz.v_q, qz.v_scale, qz.v_mean)
                t_base = time_ms(cudnn_fn(causal), q, k, v)
                tops = attention_flops(4, 32, s, d, causal) / (t * 1e-3)
                emit(f"sage_kernel_TOPS_s{s}_hd{d}"
                     f"{'_causal' if causal else ''}", tops / 1e12, "TOPS",
                     t_base / t)


def sec_roofline():
    """What plain XLA products and a copy reach on this card."""
    n = 8192
    ka, kb = jax.random.split(jax.random.PRNGKey(1))
    a = jax.random.normal(ka, (n, n), jnp.bfloat16)
    b = jax.random.normal(kb, (n, n), jnp.bfloat16)
    for name, dt, acc in (("bf16", jnp.bfloat16, jnp.float32),
                          ("int8", jnp.int8, jnp.int32),
                          ("fp8_e4m3", jnp.float8_e4m3fn, jnp.float32)):
        x, y = (a.astype(dt), b.astype(dt)) if name != "int8" else (
            jnp.clip(a * 30, -127, 127).astype(dt),
            jnp.clip(b * 30, -127, 127).astype(dt))
        f = jax.jit(lambda x, y: jax.lax.dot_general(
            x, y, (((1,), (0,)), ((), ())), preferred_element_type=acc))
        t = time_ms(f, x, y)
        emit(f"roofline_matmul_{name}_TFLOPs", 2 * n**3 / (t * 1e-3) / 1e12,
             "TFLOP/s")
    big = jnp.ones((2**28,), jnp.float32)  # 1 GiB
    t = time_ms(jax.jit(lambda x: x * 2.0), big)
    emit("roofline_copy_TBps", 2 * big.nbytes / (t * 1e-3) / 1e12, "TB/s")


def sec_decode():
    """One decode step over int8 caches, llm-8b-gqa widths, b4, 32k."""
    import sageattention_jax as sa

    b, hq, hkv, d, S = 4, 32, 8, 128, 32768
    k, v = qkv(jax.random.PRNGKey(3), b, hkv, hkv, S, d)[1:]
    q = jax.random.normal(jax.random.PRNGKey(4), (b, hq, 1, d), jnp.bfloat16)
    cache = sa.init_kv_cache(b, hkv, S, d)
    cache, lengths = jax.jit(sa.append_kv)(
        cache, jnp.zeros((b,), jnp.int32), k, v)
    table = jax.random.permutation(
        jax.random.PRNGKey(5), b * (S // 1024)).reshape(b, -1)
    paged = sa.init_paged_kv_cache(b * (S // 1024), hkv, d,
                                   table.astype(jnp.int32))
    paged, plen = sa.paged_prefill(paged, k, v)
    cache_bytes = 2 * b * hkv * S * (d + 4)
    for name, fn, c, ln in (
        ("sage_decode_us_b4_32k_int8", sa.sageattn_decode, cache, lengths),
        ("sage_paged_decode_us_b4_32k_int8", sa.sageattn_paged_decode,
         paged, plen),
    ):
        t = time_ms(jax.jit(fn), q, c, ln, n=20)
        emit(name, t * 1e3, "us")
        emit(name.replace("_us_", "_share_of_3_35TBps_"),
             cache_bytes / (t * 1e-3) / 3.35e12, "fraction")


def sec_accuracy():
    """Cosine to the fp32 oracle with outlier K channels (the case K
    smoothing exists for); vs_baseline = sage cos / cuDNN bf16 cos."""
    from sageattention_jax.ops import reference

    q, k, v = qkv(jax.random.PRNGKey(6), 1, 8, 8, 4096, 128, jnp.float32)
    k = k + 8.0 * (jnp.arange(128) % 16 == 0)
    with jax.default_matmul_precision("highest"):
        ref = reference.attention_reference(q, k, v)

    def cos(o):
        a, r = np.asarray(o, np.float64).ravel(), np.asarray(ref).ravel()
        return float(a @ r / np.linalg.norm(a) / np.linalg.norm(r))

    bf = [x.astype(jnp.bfloat16) for x in (q, k, v)]
    c_sage = cos(sage_fn(False)(*bf))
    c_base = cos(cudnn_fn(False)(*bf))
    emit("sage_accuracy_cos_outlierch_s4096_hd128", c_sage, "cosine",
         c_sage / c_base)


def sec_e2e():
    """The full CogVideoX-2B denoise step (30 layers, batch 2 as a CFG
    pair, 17,776 tokens): the fused kernel, the blockwise plain path, and
    cuDNN as the attention."""
    from sageattention_jax import models
    from sageattention_jax.models.configs import MODEL_CONFIGS

    cfg = MODEL_CONFIGS["cogvideox-2b"]
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    lat = jax.random.normal(k1, (2, cfg.latent_frames, cfg.latent_height,
                                 cfg.latent_width, 16), jnp.bfloat16)
    txt = jax.random.normal(k2, (2, cfg.text_len, 4096), jnp.bfloat16)
    t = jnp.full((2,), 999, jnp.int32)
    params = jax.jit(models.VideoDiT(cfg).init)(k3, lat, txt, t)
    times = {}
    for name, backend, kw in (
        ("cudnn", "flash", {}),
        ("kernel", "sage", {}),
        ("blockwise", "sage", {"impl": "xla"}),
    ):
        proc = models.SageAttnProcessor(backend=backend, kwargs=kw)
        model = models.VideoDiT(cfg, processor=proc)
        step = jax.jit(lambda p, x, y, s: model.apply(p, x, y, s))
        t0 = time.perf_counter()
        jax.block_until_ready(step(params, lat, txt, t))
        log(f"e2e {name}: compile + first step "
            f"{time.perf_counter() - t0:.1f} s")
        times[name] = time_ms(step, params, lat, txt, t, n=3)
        emit(f"e2e_step_ms_cogvideox2b_b2_{name}", times[name], "ms",
             times["cudnn"] / times[name])


def sec_train():
    """fwd+bwd through sageattn vs cuDNN, hd128, s4096, 32/8 heads."""
    import sageattention_jax as sa

    q, k, v = qkv(jax.random.PRNGKey(8), 1, 32, 8, 4096, 128)

    def loss(attn):
        return lambda q, k, v: jnp.sum(attn(q, k, v).astype(jnp.float32))

    sage = jax.jit(jax.grad(loss(
        lambda q, k, v: sa.sageattn(q, k, v, is_causal=True)),
        argnums=(0, 1, 2)))
    cudnn = jax.jit(jax.grad(loss(cudnn_fn(True)), argnums=(0, 1, 2)))
    t = time_ms(sage, q, k, v)
    emit("sage_fwdbwd_ms_s4096_hd128_causal", t, "ms",
         time_ms(cudnn, q, k, v) / t)


def sec_window():
    """Causal sliding window (blockwise path) vs full causal (kernel) at
    s16384: vs_baseline = full-causal time / window time."""
    q, k, v = qkv(jax.random.PRNGKey(9), 1, 32, 8, 16384, 128)
    t_w = time_ms(sage_fn(True, window=4096), q, k, v, n=3)
    t_full = time_ms(sage_fn(True), q, k, v, n=3)
    emit("sage_window_ms_s16384_W4096", t_w, "ms", t_full / t_w)


SECTIONS = {
    "headline": sec_headline, "roofline": sec_roofline,
    "decode": sec_decode, "accuracy": sec_accuracy, "e2e": sec_e2e,
    "train": sec_train, "op_total": sec_op_total, "window": sec_window,
    "matrix": sec_matrix,
}


def main() -> int:
    global CARD, DEVICE
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(SECTIONS))
    args = ap.parse_args()
    require_gpu()
    use_compile_cache()
    CARD, DEVICE = card(), device_record()
    log(f"{CARD}; jax {jax.__version__}")
    summary = {}
    for name in args.only.split(","):
        t0 = time.perf_counter()
        try:
            SECTIONS[name]()
            summary[name] = "ok"
        except Exception:  # reported, and the run exits non-zero
            traceback.print_exc()
            summary[name] = "FAILED"
        log(f"section {name}: {summary[name]} "
            f"({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"metric": "summary_all", "value": summary,
                      "device": DEVICE, "card": CARD}), flush=True)
    return 0 if all(v == "ok" for v in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

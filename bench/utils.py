"""Timing and bookkeeping shared by the benchmark scripts.

Times are host wall clock around work that ends in ``block_until_ready``
(JAX returns before the device finishes, so a timing without it measures
the enqueue).  Every result names the device it ran on.
"""

from __future__ import annotations

import os
import subprocess
import time

import jax
import numpy as np


def time_ms(fn, *args, n: int = 10) -> float:
    """Median wall time in ms of ``fn(*args)`` over ``n`` warm calls."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def attention_flops(b: int, h: int, s: int, d: int, causal: bool) -> int:
    """The reference's TOPS metric: 4*h*b*hd*s^2 / (2 if causal)
    (reference: bench/bench_qk_int8_pv_fp8_cuda.py:71)."""
    return 4 * b * h * d * s * s // (2 if causal else 1)


def card() -> str:
    """``name, power limit`` of the first GPU as nvidia-smi reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def device_record() -> dict:
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def require_gpu() -> None:
    """Measurements are of the card: refuse to run anywhere else."""
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX found {jax.devices()[0].platform}"
        )


def use_compile_cache() -> None:
    """$JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(repo, ".jax_cache"))

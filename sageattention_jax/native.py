"""Native host runtime: ctypes binding for csrc/host (C++), with numpy
fallbacks.

The compute path of this framework is Pallas/XLA on the GPU; the *host*
work around it — ragged-batch packing and cu_seqlens expansion for the
varlen pipeline (reference: sageattention/core.py:362-477 and the
host-side scale-offset computation in triton/quant_per_block_varlen.py:
72-79) — runs as native multithreaded C++ (csrc/host/varlen_pack.cpp).

The shared library is built on demand by :func:`ensure_built` (plain g++,
no Python headers needed) or by ``pip install`` via setup.py; when neither
is available every function falls back to an equivalent numpy
implementation, so the package never hard-requires the toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc",
    "host",
    "varlen_pack.cpp",
)
_LIB_NAME = "libsagehost.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _lib_paths():
    root = os.path.dirname(_SRC)
    yield os.path.join(root, _LIB_NAME)
    yield os.path.join(
        os.path.expanduser("~"), ".cache", "sageattention_jax", _LIB_NAME
    )


def ensure_built(force: bool = False) -> str | None:
    """Build csrc/host into a shared library if a C++ toolchain exists.
    Returns the library path, or None when unavailable."""
    for path in _lib_paths():
        if not force and os.path.exists(path):
            return path
    if not os.path.exists(_SRC):
        return None
    for path in _lib_paths():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # per-process temp name: concurrent builders (multi-process data
        # loaders, multi-host launch) must not interleave g++ writes into
        # one file and os.replace garbage into place
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            "-o", tmp, _SRC, "-lpthread",
        ]
        try:
            subprocess.run(
                cmd, check=True, capture_output=True, timeout=120
            )
            os.replace(tmp, path)
            return path
        except (OSError, subprocess.SubprocessError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            continue
    return None


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = ensure_built()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.sage_pack_ragged.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.sage_unpack_ragged.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32,
        ]
        lib.sage_expand_cu_seqlens.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def has_native() -> bool:
    return _load() is not None


_THREADS = min(16, os.cpu_count() or 1)


def pack_ragged(seqs: list[np.ndarray], threads: int | None = None):
    """Pack ragged [len_i, ...] arrays into ([sum(len), ...], cu_seqlens).

    The host prep for ``sageattn_varlen`` (reference: core.py:362-477).
    """
    if not seqs:
        raise ValueError("need at least one sequence")
    trailing = seqs[0].shape[1:]
    dtype = seqs[0].dtype
    for x in seqs:
        if x.shape[1:] != trailing or x.dtype != dtype:
            raise ValueError("sequences must share trailing shape and dtype")
    lens = np.array([x.shape[0] for x in seqs], np.int64)
    total = int(lens.sum())
    cu = np.zeros(len(seqs) + 1, np.int32)
    out = np.empty((total, *trailing), dtype)
    lib = _load()
    seqs = [np.ascontiguousarray(x) for x in seqs]
    if lib is None:
        np.cumsum(lens, out=cu[1:])
        off = 0
        for x in seqs:
            out[off:off + x.shape[0]] = x
            off += x.shape[0]
        return out, cu
    row_bytes = dtype.itemsize * int(np.prod(trailing, dtype=np.int64))
    srcs = (ctypes.c_void_p * len(seqs))(
        *(x.ctypes.data for x in seqs)
    )
    lib.sage_pack_ragged(
        srcs,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(seqs),
        row_bytes,
        out.ctypes.data_as(ctypes.c_void_p),
        cu.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads or _THREADS,
    )
    return out, cu


def unpack_ragged(packed: np.ndarray, cu_seqlens: np.ndarray,
                  threads: int | None = None) -> list[np.ndarray]:
    """Split a packed [total, ...] array back into per-sequence arrays."""
    packed = np.ascontiguousarray(packed)
    cu = np.ascontiguousarray(cu_seqlens, np.int32)
    n = len(cu) - 1
    outs = [
        np.empty((int(cu[i + 1] - cu[i]), *packed.shape[1:]), packed.dtype)
        for i in range(n)
    ]
    lib = _load()
    if lib is None:
        for i, o in enumerate(outs):
            o[...] = packed[int(cu[i]):int(cu[i + 1])]
        return outs
    row_bytes = packed.dtype.itemsize * int(
        np.prod(packed.shape[1:], dtype=np.int64)
    )
    dsts = (ctypes.c_void_p * n)(*(o.ctypes.data for o in outs))
    lib.sage_unpack_ragged(
        packed.ctypes.data_as(ctypes.c_void_p),
        cu.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, row_bytes, dsts, threads or _THREADS,
    )
    return outs


def expand_cu_seqlens(cu_seqlens: np.ndarray, total: int | None = None,
                      threads: int | None = None):
    """cu_seqlens -> (segment_ids [total] int32 1-based, positions [total]).

    Matches ``jnp.searchsorted(cu, arange(total), side="right")`` for the
    segment ids (what sageattn_varlen computes on device) plus the
    intra-segment position vector used for causal varlen.
    """
    cu = np.ascontiguousarray(cu_seqlens, np.int32)
    n = len(cu) - 1
    if total is None:
        total = int(cu[-1])
    seg = np.empty(total, np.int32)
    pos = np.empty(total, np.int32)
    lib = _load()
    if lib is None:
        idx = np.arange(total, dtype=np.int64)
        seg[:] = np.searchsorted(cu, idx, side="right").astype(np.int32)
        starts = cu[np.clip(seg - 1, 0, n)]  # pad tail restarts at cu[n]
        pos[:] = (idx - starts).astype(np.int32)
        return seg, pos
    lib.sage_expand_cu_seqlens(
        cu.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, total,
        seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads or _THREADS,
    )
    return seg, pos

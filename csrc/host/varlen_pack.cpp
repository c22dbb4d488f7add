// Host-side varlen batch preparation (the native data-loader tier).
//
// The reference's varlen path prepares FlashAttention-style ragged batches
// host-side: cumulative sequence offsets and the derived per-scale offsets
// (reference: sageattention/triton/quant_per_block_varlen.py:72-79 computes
// cu_seqlens_scale on the host; sageattention/core.py:362-477 consumes
// cu_seqlens).  Here attention consumes segment ids instead of offset
// arithmetic, so the host work is: packing N ragged sequences into one
// contiguous buffer and expanding cu_seqlens into segment-id / position
// vectors.  Those are memory-bound loops over potentially hundreds of MB of
// activations per batch — this C++ implementation runs them multithreaded
// at memcpy speed (sageattention_jax/native.py holds the ctypes binding and
// a numpy fallback).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libsagehost.so varlen_pack.cpp -lpthread
// (driven by setup.py / sageattention_jax.native.ensure_built()).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) over up to `threads` workers.
template <typename F>
void parallel_for(int64_t n, F fn, int threads) {
  if (n <= 0) return;
  int nt = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(threads, n)));
  if (nt == 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Pack n_seq ragged sequences (row-major [len_i, row_bytes] each) into one
// contiguous [sum(len), row_bytes] buffer and fill cu_seqlens[n_seq + 1].
void sage_pack_ragged(const void** srcs, const int64_t* lens, int64_t n_seq,
                      int64_t row_bytes, void* dst, int32_t* cu_seqlens,
                      int32_t threads) {
  std::vector<int64_t> offs(n_seq + 1, 0);
  for (int64_t i = 0; i < n_seq; ++i) offs[i + 1] = offs[i] + lens[i];
  for (int64_t i = 0; i <= n_seq; ++i)
    cu_seqlens[i] = static_cast<int32_t>(offs[i]);
  parallel_for(
      n_seq,
      [&](int64_t i) {
        std::memcpy(static_cast<char*>(dst) + offs[i] * row_bytes, srcs[i],
                    static_cast<size_t>(lens[i]) * row_bytes);
      },
      threads);
}

// Inverse of sage_pack_ragged: split a packed buffer back into per-sequence
// destination buffers.
void sage_unpack_ragged(const void* src, const int32_t* cu_seqlens,
                        int64_t n_seq, int64_t row_bytes, void** dsts,
                        int32_t threads) {
  parallel_for(
      n_seq,
      [&](int64_t i) {
        int64_t lo = cu_seqlens[i], hi = cu_seqlens[i + 1];
        std::memcpy(dsts[i], static_cast<const char*>(src) + lo * row_bytes,
                    static_cast<size_t>(hi - lo) * row_bytes);
      },
      threads);
}

// Expand cu_seqlens into per-token segment ids (1-based, matching
// jnp.searchsorted(cu, arange, side="right")) and intra-segment positions.
void sage_expand_cu_seqlens(const int32_t* cu_seqlens, int64_t n_seq,
                            int64_t total, int32_t* segment_ids,
                            int32_t* positions, int32_t threads) {
  parallel_for(
      n_seq,
      [&](int64_t i) {
        int64_t lo = cu_seqlens[i];
        int64_t hi = std::min<int64_t>(cu_seqlens[i + 1], total);
        for (int64_t t = lo; t < hi; ++t) {
          if (segment_ids) segment_ids[t] = static_cast<int32_t>(i + 1);
          if (positions) positions[t] = static_cast<int32_t>(t - lo);
        }
      },
      threads);
  // tail tokens beyond the last boundary (padding) get segment n_seq + 1
  int64_t last = std::min<int64_t>(cu_seqlens[n_seq], total);
  for (int64_t t = last; t < total; ++t) {
    if (segment_ids) segment_ids[t] = static_cast<int32_t>(n_seq + 1);
    if (positions) positions[t] = static_cast<int32_t>(t - last);
  }
}

}  // extern "C"

// SiM search on Hopper: Q masked 64-bit equality queries against N pages,
// one packed 512-bit match bitmap per (query, page).  The pages are read in
// place from the PlaneStore arena through a row index.
//
// Replaces the TPU kernel src/repro/kernels/sim_search/sim_search.py
// (_search_kernel, launched by _sim_search_call / sim_search_kernel).
//
// What bounds it on the H100: the page planes are read once (4 KiB a page)
// and 64 B of bitmap is written per (query, page), so at Q = 64 the work is
// about 8 integer operations per (query, page, slot) against 128 B of traffic
// per page-slot pair of planes: the 32-bit integer issue rate, not HBM, is
// the bound once Q is more than a handful.  At the replay's burst shapes
// (N = 64 pages) that bound is under a microsecond, so a launch is bound by
// its latency: the launch itself, then one chain of dependent memory trips
// (row index -> planes and stream operands, cold in device memory on the
// replay, since the arena is larger than the 50 MB L2).
//
// Design:
// * In place.  `rows` (N,) maps page i of the launch to its arena row, so
//   the flush issues no gather copies before the launch.  A null `rows`
//   means rows 0..N-1 (pre-gathered planes, as the quickstart passes).
//   The host checks every index against the resident rows before it
//   uploads them; the kernel trusts them.  The kernel reads the arena when
//   it runs, not when it was queued: every arena write (staging, growth)
//   and every launch go to the same CUDA stream, so stream order keeps a
//   launch reading the planes of its flush.
// * Chip axis.  The sharded backend searches C chips in one launch, the
//   counterpart of jax.vmap over the TPU kernel (src/repro/backend/
//   sharded.py, _stacked_search): chip c has its own (Q, 2) queries and
//   masks, its own N rows of the arena (`rows` is (C, N)) and its own
//   (Q, N, 16) block of the output.  The grid's z axis is the chip; nothing
//   else changes, and a single-chip search is C = 1.  A null `rows` means
//   rows c * N .. c * N + N - 1 for chip c (pre-gathered planes).
// * Grid (page, query tile, chip).  A block is one page and up to 64
//   queries; the tile halves (64, 32, 16, 8) until the grid has at least
//   one block per SM, so the burst shape Q = N = 64 runs 256 blocks of 16 queries instead
//   of 64 blocks.  Each block regenerates its page's stream, so the stream
//   (39 operations a slot) runs Q / tile times: at Q = 64, tile 16, a slot
//   costs 4 x (39 + 16 x 6) = 540 operations against 39 + 64 x 6 = 423
//   with one block a page, 1.28x the work for 4x the blocks.
// * 256 threads a block, two slots a thread (slots t and t + 256; 512 and
//   128 threads were slower when timed in turns on the H100, as were
//   tiles of 64 and 8 queries; PERF.md).  Each thread loads its lo/hi words
//   once and XORs the §IV-C1 stream into them instead of into every query
//   ((w ^ (q ^ s)) == ((w ^ s) ^ q)), so the query loop costs no mixing;
//   the page stays in registers across the tile (§IV-E batching).
// * The tile's queries and masks are staged once in shared memory as
//   uint4 (q_lo, q_hi, m_lo, m_hi); the loop reads each with one broadcast
//   16-byte load.  __ballot_sync packs a warp's 32 match bits into a bitmap
//   word: ballot k of warp w is word v = 8k + w, whose lane i is slot
//   32v + i (the TPU kernel's bit order); lane 0 puts it in shared memory.
// * After one barrier the tile's bitmaps leave as 16-byte stores by
//   consecutive threads: each (query, page) row of 64 B is four of them.
//   Pad queries (q = 0, m = 0) match every slot and are written like any.

#include "sim_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = sim::kSlots / kThreads;   // slots t + kThreads k
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) search_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const uint2* __restrict__ queries, const uint2* __restrict__ masks,
    const uint32_t* __restrict__ page_ids,
    const uint32_t* __restrict__ page_seeds, const int32_t* __restrict__ rows,
    uint32_t* __restrict__ out, int n_pages, int n_queries, int query_tile,
    int randomized) {
  __shared__ uint4 tile_qm[sim::kMaxQueryTile];
  __shared__ __align__(16)
      uint32_t tile_bits[sim::kMaxQueryTile][sim::kBitmapWords];
  const int chip = blockIdx.z;             // this chip's queries and output
  queries += static_cast<size_t>(chip) * n_queries;
  masks += static_cast<size_t>(chip) * n_queries;
  out += static_cast<size_t>(chip) * n_queries * n_pages * sim::kBitmapWords;
  const int page = blockIdx.x;
  const int q0 = blockIdx.y * query_tile;
  const int nq = min(query_tile, n_queries - q0);
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;

  for (int i = t; i < nq; i += kThreads) {
    const uint2 q = queries[q0 + i];
    const uint2 m = masks[q0 + i];
    tile_qm[i] = make_uint4(q.x, q.y, m.x, m.y);
  }
  const size_t at = static_cast<size_t>(chip) * n_pages + page;
  const size_t row = rows ? static_cast<uint32_t>(rows[at])
                          : static_cast<uint32_t>(at);
  uint32_t d_lo[kPerThread], d_hi[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const size_t word = row * sim::kSlots + t + k * kThreads;
    d_lo[k] = lo[word];
    d_hi[k] = hi[word];
  }
  if (randomized) {
    const uint32_t id = page_ids[row];
    const uint32_t seed = page_seeds[row];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const uint32_t ctr = sim::stream_ctr(id, seed, t + k * kThreads);
      d_lo[k] ^= sim::mix2_32(ctr, sim::kLoSalt);
      d_hi[k] ^= sim::mix2_32(ctr, sim::kHiSalt);
    }
  }
  __syncthreads();                       // tile_qm is staged

#pragma unroll 8
  for (int q = 0; q < nq; ++q) {
    const uint4 qm = tile_qm[q];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const bool hit =
          (((d_lo[k] ^ qm.x) & qm.z) | ((d_hi[k] ^ qm.y) & qm.w)) == 0u;
      const uint32_t bits = __ballot_sync(0xFFFFFFFFu, hit);
      if (lane == 0) tile_bits[q][k * kWarps + warp] = bits;
    }
  }
  __syncthreads();                       // tile_bits is complete

  for (int i = t; i < 4 * nq; i += kThreads) {
    const int q = i >> 2;
    const int part = i & 3;
    uint4* dst = reinterpret_cast<uint4*>(
        out + (static_cast<size_t>(q0 + q) * n_pages + page) * sim::kBitmapWords);
    dst[part] = reinterpret_cast<const uint4*>(tile_bits[q])[part];
  }
}

}  // namespace

// lo, hi: (cap, 512) arena planes; page_ids, page_seeds: (cap,);
// rows: (C, N) int32 arena rows, or null for rows c * N + i; queries,
// masks: (C, Q, 2); out: (C, Q, N, 16).  uint32 unless noted, contiguous,
// on `device`.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sim_search_launch(const void* lo, const void* hi,
                                 const void* queries, const void* masks,
                                 const void* page_ids, const void* page_seeds,
                                 const void* rows, void* out, int n_pages,
                                 int n_queries, int n_chips, int randomized,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = sim::query_tile(n_pages * n_chips, n_queries, device);
  const dim3 grid(n_pages, (n_queries + tile - 1) / tile, n_chips);
  search_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint2*>(queries), static_cast<const uint2*>(masks),
      static_cast<const uint32_t*>(page_ids),
      static_cast<const uint32_t*>(page_seeds),
      static_cast<const int32_t*>(rows), static_cast<uint32_t*>(out), n_pages,
      n_queries, tile, randomized);
  return static_cast<int>(cudaGetLastError());
}

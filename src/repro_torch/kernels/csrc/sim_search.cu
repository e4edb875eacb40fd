// SiM search on Hopper: Q masked 64-bit equality queries against N pages,
// one packed 512-bit match bitmap per (query, page).
//
// Replaces the TPU kernel src/repro/kernels/sim_search/sim_search.py
// (_search_kernel, launched by _sim_search_call / sim_search_kernel).
//
// What bounds it on the H100: the page planes are read once (4 KiB a page)
// and 64 B of bitmap is written per (query, page), so at Q = 64 the work is
// about 8 integer operations per (query, page, slot) against 128 B of traffic
// per page-slot pair of planes: the 32-bit integer issue rate, not HBM, is
// the bound once Q is more than a handful.  At the replay's burst shapes
// (N = 64 pages) the grid is only 64 blocks, fewer than the 132 SMs, so a
// launch is latency-bound in practice.
//
// Design: one block per page, one thread per slot (512 threads, 16 warps).
// Each thread loads its lo/hi words once and regenerates the §IV-C1 stream
// once per (page, slot); the stream is XORed into the stored words instead
// of into every query ((w ^ (q ^ s)) == ((w ^ s) ^ q)), so the Q-loop costs
// no mixing.  The loop over queries keeps the page in registers, which is
// the batch-matching amortisation of §IV-E, and __ballot_sync turns a warp's
// 32 match bits into one bitmap word: lane i is slot 32w + i, the packing
// order of the TPU kernel (bit i of word w = slot 32w + i).

#include "sim_common.cuh"

namespace {

__global__ void __launch_bounds__(sim::kSlots) search_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const uint32_t* __restrict__ queries, const uint32_t* __restrict__ masks,
    const uint32_t* __restrict__ page_ids,
    const uint32_t* __restrict__ page_seeds, uint32_t* __restrict__ out,
    int n_pages, int n_queries, int randomized) {
  const int page = blockIdx.x;
  const int slot = threadIdx.x;
  const int warp = slot >> 5;
  const int lane = slot & 31;
  const size_t word = static_cast<size_t>(page) * sim::kSlots + slot;
  uint32_t d_lo = lo[word];
  uint32_t d_hi = hi[word];
  if (randomized) {
    const uint32_t ctr = sim::stream_ctr(page_ids[page], page_seeds[page], slot);
    d_lo ^= sim::mix2_32(ctr, sim::kLoSalt);
    d_hi ^= sim::mix2_32(ctr, sim::kHiSalt);
  }
  uint32_t* page_out = out + static_cast<size_t>(page) * sim::kBitmapWords + warp;
  const size_t query_stride = static_cast<size_t>(n_pages) * sim::kBitmapWords;
  for (int q = 0; q < n_queries; ++q) {
    const uint32_t q_lo = __ldg(queries + 2 * q);
    const uint32_t q_hi = __ldg(queries + 2 * q + 1);
    const uint32_t m_lo = __ldg(masks + 2 * q);
    const uint32_t m_hi = __ldg(masks + 2 * q + 1);
    const bool hit = (((d_lo ^ q_lo) & m_lo) | ((d_hi ^ q_hi) & m_hi)) == 0u;
    const uint32_t bits = __ballot_sync(0xFFFFFFFFu, hit);
    if (lane == 0) page_out[q * query_stride] = bits;
  }
}

}  // namespace

// lo, hi: (N, 512); queries, masks: (Q, 2); page_ids, page_seeds: (N,);
// out: (Q, N, 16).  All uint32, contiguous, on `device`.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int sim_search_launch(const void* lo, const void* hi,
                                 const void* queries, const void* masks,
                                 const void* page_ids, const void* page_seeds,
                                 void* out, int n_pages, int n_queries,
                                 int randomized, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  search_kernel<<<n_pages, sim::kSlots, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint32_t*>(queries), static_cast<const uint32_t*>(masks),
      static_cast<const uint32_t*>(page_ids),
      static_cast<const uint32_t*>(page_seeds), static_cast<uint32_t*>(out),
      n_pages, n_queries, randomized);
  return static_cast<int>(cudaGetLastError());
}

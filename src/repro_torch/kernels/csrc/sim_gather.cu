// SiM gather on Hopper: per page, front-pack the 64 B chunks a 64-bit chunk
// bitmap selects, in chunk order, and report how many were selected.
//
// Replaces the TPU kernel src/repro/kernels/sim_gather/sim_gather.py
// (_gather_kernel, launched by sim_gather_kernel).  The TPU version routes
// the one-hot compaction through the MXU as split-16 float products; that
// trick exists only to reach the TPU's matrix unit and is not carried over.
//
// What bounds it on the H100: bytes.  It does a popcount per chunk and moves
// each selected chunk once (64 B read, 64 B written) plus the zero rows of
// the (N, max_out, 16) output; there is no arithmetic to speak of.  At the
// replay's shapes (N = 64 rows, one selected chunk a row, max_out = 64) the
// output's zero fill is most of the traffic and a launch is latency-bound.
//
// Design: one block per page, one thread per chunk j.  Thread j finds its
// output row with __popcll over the selected bits below it and copies its
// chunk as four 16-byte vectors; threads then zero the rows from
// min(count, max_out) on.  Counts include the selections dropped past
// max_out, as the TPU kernel's do.  Every output word is written, so the
// wrapper allocates the outputs uninitialised.

#include "sim_common.cuh"

namespace {

constexpr int kThreads = sim::kChunks;
constexpr int kVecPerChunk = sim::kChunkWords / 4;   // uint4 vectors a chunk

__global__ void __launch_bounds__(kThreads) gather_kernel(
    const uint4* __restrict__ chunks, const uint32_t* __restrict__ bitmap,
    uint4* __restrict__ out, int32_t* __restrict__ counts, int max_out) {
  const int page = blockIdx.x;
  const int j = threadIdx.x;
  const uint64_t bm = static_cast<uint64_t>(bitmap[2 * page]) |
                      (static_cast<uint64_t>(bitmap[2 * page + 1]) << 32);
  const int count = __popcll(bm);
  const int kept = min(count, max_out);
  uint4* page_out = out + static_cast<size_t>(page) * max_out * kVecPerChunk;
  if ((bm >> j) & 1ull) {
    const int pos = __popcll(bm & ((1ull << j) - 1ull));
    if (pos < max_out) {
      const uint4* src =
          chunks + (static_cast<size_t>(page) * sim::kChunks + j) * kVecPerChunk;
      uint4* dst = page_out + static_cast<size_t>(pos) * kVecPerChunk;
#pragma unroll
      for (int v = 0; v < kVecPerChunk; ++v) dst[v] = src[v];
    }
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int r = kept + j; r < max_out; r += kThreads) {
    uint4* dst = page_out + static_cast<size_t>(r) * kVecPerChunk;
#pragma unroll
    for (int v = 0; v < kVecPerChunk; ++v) dst[v] = zero;
  }
  if (j == 0) counts[page] = count;
}

}  // namespace

// chunks: (N, 64, 16) uint32; bitmap: (N, 2) uint32; out: (N, max_out, 16)
// uint32; counts: (N,) int32.  Contiguous, 16-byte aligned, on `device`.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int sim_gather_launch(const void* chunks, const void* bitmap,
                                 void* out, void* counts, int n_pages,
                                 int max_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_kernel<<<n_pages, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(chunks), static_cast<const uint32_t*>(bitmap),
      static_cast<uint4*>(out), static_cast<int32_t*>(counts), max_out);
  return static_cast<int>(cudaGetLastError());
}

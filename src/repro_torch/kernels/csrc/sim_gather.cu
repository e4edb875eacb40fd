// SiM gather on Hopper: per page, front-pack the 64 B chunks a 64-bit chunk
// bitmap selects, in chunk order, and report how many were selected.  The
// pages are read in place from the PlaneStore arena through a row index.
//
// Replaces the TPU kernel src/repro/kernels/sim_gather/sim_gather.py
// (_gather_kernel, launched by sim_gather_kernel).  The TPU version routes
// the one-hot compaction through the MXU as split-16 float products; that
// trick exists only to reach the TPU's matrix unit and is not carried over.
//
// What bounds it on the H100: latency.  The work is a popcount per chunk,
// each selected chunk read once (32 B from each plane) and the
// (N, max_out, 16) output written once, zero rows included: at the
// replay's shape (N = 64 rows, one selected chunk a row, max_out = 64)
// about 0.27 MB, under 0.1 us at 3.35 TB/s.  A launch waits for the launch
// itself and one chain of dependent trips: the row index and bitmap
// (loaded together), then the selected chunk (cold in device memory on the
// replay, since the arena is larger than the 50 MB L2), then the store.
//
// Design:
// * In place.  `rows` (N,) maps page i of the launch to its arena row, so
//   the flush issues no gather or layout copy before the launch.  A null
//   `rows` means rows 0..N-1.  The host checks every index against the
//   resident rows before it uploads them; the kernel trusts them.  The
//   kernel reads the arena when it runs: every arena write and every
//   launch go to the same CUDA stream, and stream order keeps a launch
//   reading the planes of its flush.
// * One block of 64 threads a page, thread j owning chunk j (a warp a page
//   with four lanes an output row was 0.2-0.6 us slower when timed in
//   turns on the H100; PERF.md).  A selected chunk j finds its output row
//   with __popcll over the selected bits below it and, when that row is
//   below max_out, reads only its own words: two 16-byte loads from each
//   plane (slots 8j..8j+7), issued before anything is stored.  While they
//   are in flight, consecutive threads zero the rows from
//   min(count, max_out) on with 16-byte stores to consecutive addresses
//   (those depend on the bitmap only); then the chunk, interleaved per
//   slot into the chunk layout (word 2s is slot 8j + s's lo word, 2s + 1
//   its hi word, as in sim_lookup.cu), leaves as four 16-byte stores.
//   Storing the zeros after the chunk instead cost 0.1 us warm and 0.2 us
//   cold.  Stores are streaming (__stcs): the host copies the output out
//   and the card does not read it again.
// * Counts include the selections dropped past max_out.  The bitmap is
//   taken as given: the header chunk is not masked.  Chunks leave as
//   stored (still randomized); the host tail de-randomizes them.  Pad rows
//   (row 0, bitmap 0) gather nothing.  Every output word is written, so
//   the wrapper allocates the outputs uninitialised.

#include "sim_common.cuh"

namespace {

constexpr int kThreads = sim::kChunks;
constexpr int kVecPerChunk = sim::kChunkWords / 4;   // uint4 vectors a chunk

__global__ void __launch_bounds__(kThreads) gather_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const int32_t* __restrict__ rows, const uint2* __restrict__ bitmap,
    uint4* __restrict__ out, int32_t* __restrict__ counts, int max_out) {
  const int page = blockIdx.x;
  const int j = threadIdx.x;
  const size_t row = rows ? static_cast<uint32_t>(rows[page])
                          : static_cast<uint32_t>(page);
  const uint2 b = bitmap[page];
  const uint64_t bm =
      static_cast<uint64_t>(b.x) | (static_cast<uint64_t>(b.y) << 32);
  const int count = __popcll(bm);
  const int kept = min(count, max_out);
  uint4* page_out = out + static_cast<size_t>(page) * max_out * kVecPerChunk;
  const int pos = __popcll(bm & ((1ull << j) - 1ull));
  const bool copy = ((bm >> j) & 1ull) && pos < max_out;
  uint4 l0, l1, h0, h1;
  if (copy) {                       // loads first: they are the long trip
    const size_t word = row * sim::kSlots + j * sim::kSlotsPerChunk;
    const uint4* l = reinterpret_cast<const uint4*>(lo + word);
    const uint4* h = reinterpret_cast<const uint4*>(hi + word);
    l0 = l[0]; l1 = l[1]; h0 = h[0]; h1 = h[1];
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int v = kept * kVecPerChunk + j; v < max_out * kVecPerChunk;
       v += kThreads) {
    __stcs(page_out + v, zero);
  }
  if (copy) {
    uint4* dst = page_out + static_cast<size_t>(pos) * kVecPerChunk;
    __stcs(dst + 0, make_uint4(l0.x, h0.x, l0.y, h0.y));
    __stcs(dst + 1, make_uint4(l0.z, h0.z, l0.w, h0.w));
    __stcs(dst + 2, make_uint4(l1.x, h1.x, l1.y, h1.y));
    __stcs(dst + 3, make_uint4(l1.z, h1.z, l1.w, h1.w));
  }
  if (j == 0) counts[page] = count;
}

}  // namespace

// lo, hi: (cap, 512) arena planes; rows: (N,) int32 arena rows, or null for
// rows 0..N-1; bitmap: (N, 2); out: (N, max_out, 16); counts: (N,) int32.
// uint32 unless noted, contiguous, 16-byte aligned, on `device`.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int sim_gather_launch(const void* lo, const void* hi,
                                 const void* rows, const void* bitmap,
                                 void* out, void* counts, int n_pages,
                                 int max_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_kernel<<<n_pages, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const int32_t*>(rows), static_cast<const uint2*>(bitmap),
      static_cast<uint4*>(out), static_cast<int32_t*>(counts), max_out);
  return static_cast<int>(cudaGetLastError());
}

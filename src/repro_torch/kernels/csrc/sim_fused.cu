// SiM fused search + gather on Hopper, the cross-product form: Q masked
// 64-bit equality queries against N pages; each (query, page) cell gets its
// packed 512-bit match bitmap, the 64 B chunks of the same page that hold a
// match, front-packed in chunk order, and the number of such chunks.
//
// Replaces the TPU kernel src/repro/kernels/sim_fused/sim_fused.py
// (_fused_kernel, launched by sim_fused_kernel).  The TPU version compacts
// chunks with a one-hot product on the MXU in split-16 float halves; here a
// chunk goes straight to its output row, as in sim_gather.cu.
//
// Chunk selection differs from the paired lookup (sim_lookup.cu): a chunk is
// selected when any of its 8 slots matched, and the header chunk (slots
// 0..7) is NOT masked.  The count is the full number of selected chunks,
// those past max_out included.  Gathered chunks leave the kernel randomized,
// as stored: the host de-randomizes them.
//
// What bounds it on the H100: bytes.  Each cell writes 64 B of bitmap,
// max_out * 64 B of gathered rows (zero-filled past the count) and a count,
// so at Q = 64, N = 2048, max_out = 16 the output is 143 MB against 8 MiB of
// planes read once; the match itself is about 6 integer operations per
// (query, slot) plus the stream once per (page, slot).
//
// Design: one block per page, one thread per slot (512 threads).  Each
// thread loads its lo/hi words once, keeps a copy of the stored (still
// randomized) words in shared memory for the gather, and cancels the
// §IV-C1 stream out of its own words once, so the loop over queries costs
// no mixing (as in sim_search.cu).  Per query: __ballot_sync gives a warp's
// bitmap word (lane i = slot 32w + i), which also goes to shared memory;
// threads 0..63 each own one chunk, rebuild the 64-bit chunk selection from
// the 16 words (chunk j is byte j & 3 of word j >> 2), and a selected chunk
// j records itself at output row __popcll(sel & ((1 << j) - 1)) when that
// row is below max_out.  Then all 512 threads write the cell's
// (max_out, 16) rows with consecutive words on consecutive threads: word w
// of row r is slot 8 * chunk + w / 2, its lo word when w is even and its hi
// word when odd, or 0 past the kept rows.

#include "sim_common.cuh"

namespace {

constexpr int kThreads = sim::kSlots;

__global__ void __launch_bounds__(kThreads) fused_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const uint32_t* __restrict__ queries, const uint32_t* __restrict__ masks,
    const uint32_t* __restrict__ page_ids,
    const uint32_t* __restrict__ page_seeds, uint32_t* __restrict__ bitmap_out,
    uint32_t* __restrict__ gathered_out, int32_t* __restrict__ count_out,
    int n_pages, int n_queries, int max_out, int randomized) {
  __shared__ uint32_t stored_lo[sim::kSlots];
  __shared__ uint32_t stored_hi[sim::kSlots];
  __shared__ uint32_t words[sim::kBitmapWords];
  __shared__ int chunk_at[sim::kChunks];   // output row -> source chunk
  __shared__ int kept;                     // rows of the cell that hold a chunk

  const int page = blockIdx.x;
  const int slot = threadIdx.x;
  const int warp = slot >> 5;
  const int lane = slot & 31;
  const size_t word = static_cast<size_t>(page) * sim::kSlots + slot;
  uint32_t d_lo = lo[word];
  uint32_t d_hi = hi[word];
  stored_lo[slot] = d_lo;
  stored_hi[slot] = d_hi;
  if (randomized) {
    const uint32_t ctr = sim::stream_ctr(page_ids[page], page_seeds[page], slot);
    d_lo ^= sim::mix2_32(ctr, sim::kLoSalt);
    d_hi ^= sim::mix2_32(ctr, sim::kHiSalt);
  }
  const int out_words = max_out * sim::kChunkWords;

  for (int q = 0; q < n_queries; ++q) {
    const uint32_t q_lo = __ldg(queries + 2 * q);
    const uint32_t q_hi = __ldg(queries + 2 * q + 1);
    const uint32_t m_lo = __ldg(masks + 2 * q);
    const uint32_t m_hi = __ldg(masks + 2 * q + 1);
    const bool hit = (((d_lo ^ q_lo) & m_lo) | ((d_hi ^ q_hi) & m_hi)) == 0u;
    const uint32_t bits = __ballot_sync(0xFFFFFFFFu, hit);
    const size_t cell = static_cast<size_t>(q) * n_pages + page;
    if (lane == 0) {
      words[warp] = bits;
      bitmap_out[cell * sim::kBitmapWords + warp] = bits;
    }
    __syncthreads();                       // words (and stored_*) are complete

    if (slot < sim::kChunks) {
      uint64_t sel = 0;
#pragma unroll
      for (int w = 0; w < sim::kBitmapWords; ++w) {
        const uint32_t bw = words[w];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if ((bw >> (8 * b)) & 0xFFu) sel |= 1ull << (4 * w + b);
        }
      }
      const int j = slot;
      if ((sel >> j) & 1ull) {
        const int pos = __popcll(sel & ((1ull << j) - 1ull));
        if (pos < max_out) chunk_at[pos] = j;
      }
      if (j == 0) {
        const int count = __popcll(sel);
        kept = min(count, max_out);
        count_out[cell] = count;
      }
    }
    __syncthreads();                       // chunk_at and kept are complete

    const int rows = kept;
    uint32_t* cell_out = gathered_out + cell * static_cast<size_t>(out_words);
    for (int t = slot; t < out_words; t += kThreads) {
      const int r = t >> 4;
      const int w = t & 15;
      uint32_t v = 0u;
      if (r < rows) {
        const int s = chunk_at[r] * sim::kSlotsPerChunk + (w >> 1);
        v = (w & 1) ? stored_hi[s] : stored_lo[s];
      }
      cell_out[t] = v;
    }
    __syncthreads();                       // the next query rewrites words
  }
}

}  // namespace

// lo, hi: (N, 512); queries, masks: (Q, 2); page_ids, page_seeds: (N,);
// bitmap_out: (Q, N, 16); gathered_out: (Q, N, max_out, 16); count_out:
// (Q, N) int32.  uint32 unless noted, contiguous, on `device`.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int sim_fused_launch(const void* lo, const void* hi,
                                const void* queries, const void* masks,
                                const void* page_ids, const void* page_seeds,
                                void* bitmap_out, void* gathered_out,
                                void* count_out, int n_pages, int n_queries,
                                int max_out, int randomized, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_kernel<<<n_pages, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint32_t*>(queries), static_cast<const uint32_t*>(masks),
      static_cast<const uint32_t*>(page_ids),
      static_cast<const uint32_t*>(page_seeds),
      static_cast<uint32_t*>(bitmap_out), static_cast<uint32_t*>(gathered_out),
      static_cast<int32_t*>(count_out), n_pages, n_queries, max_out,
      randomized);
  return static_cast<int>(cudaGetLastError());
}

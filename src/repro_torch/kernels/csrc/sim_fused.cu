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
// What bounds it on the H100: bytes written.  Each cell writes 64 B of
// bitmap, max_out * 64 B of gathered rows (zero-filled past the count) and
// a count, so at Q = 64, N = 2048, max_out = 16 the output is 143 MB
// against 8 MiB of planes read once; the match is about 6 integer
// operations per (query, slot) plus the stream once per (page, slot).
//
// Design:
// * Grid (page, query tile), 8 warps a block.  The tile halves (64, 32,
//   16, 8) until the grid has a block per SM; a page whose queries span
//   several tiles regenerates its stream in each.
// * Once a block: the page's stored words and its words with the §IV-C1
//   stream cancelled go to shared memory (4 KiB each), the stream computed
//   once per (page, slot); the tile's queries and masks are staged as
//   uint4.  This is the kernel's one __syncthreads.
// * Then a warp a (query, page) cell, with no block barrier in the query
//   loop.  Lane l owns chunks l and l + 32 (slots 8l..8l+7 and
//   256+8l..256+8l+7) and keeps their 32 de-randomized words in registers
//   for every cell of the tile.  Per cell it matches its 16 slots into two
//   8-bit masks; two ballots of "any slot matched" are the cell's 64-bit
//   chunk selection, with no scan and no shared-memory word.  The bitmap
//   words come from the masks by a 4-lane OR butterfly (word w holds lanes
//   4w..4w+3's first masks, word 8 + w their second ones; bit i of word w
//   is slot 32w + i, the TPU kernel's order) and leave as 4-byte stores of
//   16 lanes to one 64 B row.
// * Each selected chunk's lane ranks it with __popc over the selected bits
//   below it and, below max_out, writes its index into the warp's row table
//   in shared memory; after __syncwarp the warp writes the cell's
//   (max_out, 16) rows as 16-byte streaming stores (__stcs, the output is
//   larger than L2 and not read back on the card), consecutive lanes on
//   consecutive 16 B: vector v is part v & 3 of row v >> 2, slots
//   8c + 2(v & 3) and the next of chunk c = table[v >> 2] read as stored
//   from shared memory and interleaved lo/hi per slot, or zeros past the
//   kept rows.

#include "sim_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kVecPerChunk = sim::kChunkWords / 4;   // uint4 vectors a chunk
constexpr uint32_t kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads) fused_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const uint2* __restrict__ queries, const uint2* __restrict__ masks,
    const uint32_t* __restrict__ page_ids,
    const uint32_t* __restrict__ page_seeds, uint32_t* __restrict__ bitmap_out,
    uint4* __restrict__ gathered_out, int32_t* __restrict__ count_out,
    int n_pages, int n_queries, int max_out, int query_tile, int randomized) {
  __shared__ __align__(16) uint32_t stored_lo[sim::kSlots];
  __shared__ __align__(16) uint32_t stored_hi[sim::kSlots];
  __shared__ __align__(16) uint32_t plain_lo[sim::kSlots];
  __shared__ __align__(16) uint32_t plain_hi[sim::kSlots];
  __shared__ uint4 tile_qm[sim::kMaxQueryTile];
  __shared__ uint8_t chunk_at[kWarps][sim::kChunks];   // row -> chunk

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
  {
    // Thread t stages slots 2t and 2t + 1.
    const size_t word = static_cast<size_t>(page) * sim::kSlots + 2 * t;
    uint2 a = *reinterpret_cast<const uint2*>(lo + word);
    uint2 b = *reinterpret_cast<const uint2*>(hi + word);
    *reinterpret_cast<uint2*>(stored_lo + 2 * t) = a;
    *reinterpret_cast<uint2*>(stored_hi + 2 * t) = b;
    if (randomized) {
      const uint32_t id = page_ids[page];
      const uint32_t seed = page_seeds[page];
      const uint32_t c0 = sim::stream_ctr(id, seed, 2 * t);
      const uint32_t c1 = sim::stream_ctr(id, seed, 2 * t + 1);
      a.x ^= sim::mix2_32(c0, sim::kLoSalt);
      a.y ^= sim::mix2_32(c1, sim::kLoSalt);
      b.x ^= sim::mix2_32(c0, sim::kHiSalt);
      b.y ^= sim::mix2_32(c1, sim::kHiSalt);
    }
    *reinterpret_cast<uint2*>(plain_lo + 2 * t) = a;
    *reinterpret_cast<uint2*>(plain_hi + 2 * t) = b;
  }
  __syncthreads();                  // the page and the tile are staged
  if (warp >= nq) return;

  // Lane l's words: slots 8l..8l+7 (chunk l), then 256+8l.. (chunk l + 32).
  uint32_t d_lo[2 * sim::kSlotsPerChunk], d_hi[2 * sim::kSlotsPerChunk];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s0 = (h * 32 + lane) * sim::kSlotsPerChunk;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint4 a = *reinterpret_cast<const uint4*>(plain_lo + s0 + 4 * k);
      const uint4 b = *reinterpret_cast<const uint4*>(plain_hi + s0 + 4 * k);
      const int r = h * sim::kSlotsPerChunk + 4 * k;
      d_lo[r] = a.x; d_lo[r + 1] = a.y; d_lo[r + 2] = a.z; d_lo[r + 3] = a.w;
      d_hi[r] = b.x; d_hi[r + 1] = b.y; d_hi[r + 2] = b.z; d_hi[r + 3] = b.w;
    }
  }
  const uint32_t below = (1u << lane) - 1u;
  const int group = lane & 3;
  uint8_t* table = chunk_at[warp];

  for (int i = warp; i < nq; i += kWarps) {
    const uint4 qm = tile_qm[i];
    uint32_t ma = 0u, mb = 0u;     // match bits of chunks lane, lane + 32
#pragma unroll
    for (int s = 0; s < sim::kSlotsPerChunk; ++s) {
      const int u = s + sim::kSlotsPerChunk;
      ma |= static_cast<uint32_t>(
                (((d_lo[s] ^ qm.x) & qm.z) | ((d_hi[s] ^ qm.y) & qm.w)) == 0u)
            << s;
      mb |= static_cast<uint32_t>(
                (((d_lo[u] ^ qm.x) & qm.z) | ((d_hi[u] ^ qm.y) & qm.w)) == 0u)
            << s;
    }
    const uint32_t sel_lo = __ballot_sync(kFull, ma != 0u);
    const uint32_t sel_hi = __ballot_sync(kFull, mb != 0u);
    const int n_lo = __popc(sel_lo);
    const int count = n_lo + __popc(sel_hi);
    const int kept = min(count, max_out);
    const size_t cell = static_cast<size_t>(q0 + i) * n_pages + page;

    uint32_t wa = ma << (8 * group), wb = mb << (8 * group);
    wa |= __shfl_xor_sync(kFull, wa, 1);
    wb |= __shfl_xor_sync(kFull, wb, 1);
    wa |= __shfl_xor_sync(kFull, wa, 2);
    wb |= __shfl_xor_sync(kFull, wb, 2);
    uint32_t* bm_row = bitmap_out + cell * sim::kBitmapWords;
    if (group == 0) __stcs(bm_row + (lane >> 2), wa);
    if (group == 1) __stcs(bm_row + 8 + (lane >> 2), wb);
    if (lane == 0) count_out[cell] = count;

    __syncwarp();                   // the last cell's table reads are done
    if (ma != 0u) {
      const int pos = __popc(sel_lo & below);
      if (pos < max_out) table[pos] = static_cast<uint8_t>(lane);
    }
    if (mb != 0u) {
      const int pos = n_lo + __popc(sel_hi & below);
      if (pos < max_out) table[pos] = static_cast<uint8_t>(lane + 32);
    }
    __syncwarp();                   // the table is complete

    uint4* cell_out =
        gathered_out + cell * static_cast<size_t>(max_out) * kVecPerChunk;
    for (int v = lane; v < max_out * kVecPerChunk; v += 32) {
      const int r = v >> 2;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < kept) {
        const int s = table[r] * sim::kSlotsPerChunk + 2 * (v & 3);
        const uint2 a = *reinterpret_cast<const uint2*>(stored_lo + s);
        const uint2 b = *reinterpret_cast<const uint2*>(stored_hi + s);
        val = make_uint4(a.x, b.x, a.y, b.y);
      }
      __stcs(cell_out + v, val);
    }
  }
}

}  // namespace

// lo, hi: (N, 512); queries, masks: (Q, 2); page_ids, page_seeds: (N,);
// bitmap_out: (Q, N, 16); gathered_out: (Q, N, max_out, 16); count_out:
// (Q, N) int32.  uint32 unless noted, contiguous, 16-byte aligned, on
// `device`.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sim_fused_launch(const void* lo, const void* hi,
                                const void* queries, const void* masks,
                                const void* page_ids, const void* page_seeds,
                                void* bitmap_out, void* gathered_out,
                                void* count_out, int n_pages, int n_queries,
                                int max_out, int randomized, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = sim::query_tile(n_pages, n_queries, device);
  const dim3 grid(n_pages, (n_queries + tile - 1) / tile);
  fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint2*>(queries), static_cast<const uint2*>(masks),
      static_cast<const uint32_t*>(page_ids),
      static_cast<const uint32_t*>(page_seeds),
      static_cast<uint32_t*>(bitmap_out), static_cast<uint4*>(gathered_out),
      static_cast<int32_t*>(count_out), n_pages, n_queries, max_out, tile,
      randomized);
  return static_cast<int>(cudaGetLastError());
}

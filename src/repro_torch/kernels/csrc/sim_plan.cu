// SiM fused range plan on Hopper: G plan groups of P masked-equality passes
// against N pages, ONE combined 512-bit bitmap per (group, page): the OR of
// the include passes' matches AND-NOT the OR of the exclude passes' matches
// (paper Fig 10, the in-latch accumulation of a §V-C range decomposition).
//
// Replaces the TPU kernel src/repro/kernels/sim_plan/sim_plan.py
// (_plan_kernel, launched by _sim_plan_call / sim_plan_kernel).
//
// What bounds it on the H100: the page planes are read once (4 KiB a page)
// and 64 B of bitmap is written per (group, page), while every real pass
// costs about 7 integer operations per slot; with a few passes the 32-bit
// integer issue rate, not HBM, is the bound.  At the replay's shapes (one
// group, one or two pages padded to 32) a launch does far less work than
// the launch itself costs, so the time there is the launch floor plus the
// dependent latency of one block: loads, the stream, the pass loop, the
// store.
//
// Design: a 2-D grid, one block per (page, group), one thread per slot (512
// threads, 16 warps), so G x N blocks share the SMs and no block walks the
// groups in series.  Each thread requests its lo/hi words, the page's
// stream address and seed and its row of the group's first 512 pass rows
// at once, so the block waits for one round trip before it computes, and
// XORs the §IV-C1 stream into its words once, not into every pass.  The TPU kernel keeps a
// (P, pages, 512) match intermediate in VMEM and reduces it; here each
// thread keeps two booleans: `inc` ORs the include matches and `exc` the
// exclude matches.
//
// Branch-free passes: while staging up to 512 pass rows (one a thread), the
// block splits them by flag into an include list and an exclude list in
// shared memory (a ballot and a prefix count within each warp, then the
// counts of the earlier warps).  The pass loops then run over the two
// lists with no flag test, PAD rows take no iteration, and the loops unroll
// by 4 over uint4 (q_lo, q_hi, m_lo, m_hi) broadcasts.  A PASS_PAD row has
// q = 0 and m = 0, which matches every slot, so it is dropped by its flag,
// never by its value.  Any P works: rows past 512 are staged and split 512
// at a time.  A group of at most 512 rows with no include row (an all-PAD
// group, or exclude passes only) skips the passes and writes zeros; its
// page words were already requested, since the loads overlap the pass
// rows' (a check of the flags first would cost a round trip and a barrier
// on every launch); a longer one runs its exclude passes to zeros.
// __ballot_sync(inc && !exc) packs one bitmap word per warp (bit i of word
// w = slot 32w + i).
//
// Chip axis.  The sharded backend evaluates C chips' plans in one launch,
// the counterpart of jax.vmap over the TPU kernel (src/repro/backend/
// sharded.py, _stacked_plan): chip c has its own N pages, its own G groups
// of P pass rows and its own (G, N, 16) block of the output.  The grid's z
// axis is the chip; a single-chip plan is C = 1.

#include "sim_common.cuh"

namespace {

constexpr int kPassTile = sim::kSlots;  // pass rows staged a tile: one a thread
constexpr int kWarps = sim::kSlots / 32;
constexpr uint32_t kPassInclude = 1u;   // kernels/sim_plan/ref.py PASS_*
constexpr uint32_t kPassExclude = 2u;

__device__ __forceinline__ bool hit(uint32_t lo, uint32_t hi, const uint4& qm) {
  return (((lo ^ qm.x) & qm.z) | ((hi ^ qm.y) & qm.w)) == 0u;
}

// OR of the matches of rows [0, n) of a staged list, four rows an
// iteration.
__device__ __forceinline__ bool any_hit(const uint4* rows, int n, uint32_t lo,
                                        uint32_t hi) {
  bool any = false;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    const uint4 a = rows[i], b = rows[i + 1], c = rows[i + 2], d = rows[i + 3];
    any |= hit(lo, hi, a) | hit(lo, hi, b) | hit(lo, hi, c) | hit(lo, hi, d);
  }
  for (; i < n; ++i) any |= hit(lo, hi, rows[i]);
  return any;
}

// Pass row p of the group starting at row0 (flag 0, PASS_PAD, past P).
__device__ __forceinline__ void load_row(const uint32_t* queries,
                                         const uint32_t* masks,
                                         const uint32_t* flags, size_t row0,
                                         int p, int n_passes, uint32_t& f,
                                         uint4& qm) {
  f = 0u;
  qm = make_uint4(0u, 0u, 0u, 0u);
  if (p < n_passes) {
    const size_t r = row0 + p;
    f = flags[r];
    qm = make_uint4(queries[2 * r], queries[2 * r + 1], masks[2 * r],
                    masks[2 * r + 1]);
  }
}

__global__ void __launch_bounds__(sim::kSlots) plan_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const uint32_t* __restrict__ queries, const uint32_t* __restrict__ masks,
    const uint32_t* __restrict__ flags, const uint32_t* __restrict__ page_ids,
    const uint32_t* __restrict__ page_seeds, uint32_t* __restrict__ out,
    int n_pages, int n_groups, int n_passes, int randomized) {
  __shared__ uint4 s_inc[kPassTile];    // (q_lo, q_hi, m_lo, m_hi)
  __shared__ uint4 s_exc[kPassTile];
  // Include rows | exclude rows << 16, a warp.
  __shared__ __align__(16) uint32_t s_count[kWarps];
  const size_t page = static_cast<size_t>(blockIdx.z) * n_pages + blockIdx.x;
  const size_t g = static_cast<size_t>(blockIdx.z) * n_groups + blockIdx.y;
  const int slot = threadIdx.x;
  const int warp = slot >> 5;
  const int lane = slot & 31;
  const size_t word = page * sim::kSlots + slot;
  uint32_t d_lo = lo[word];
  uint32_t d_hi = hi[word];
  const uint32_t page_id = randomized ? page_ids[page] : 0u;
  const uint32_t seed = randomized ? page_seeds[page] : 0u;
  const size_t row0 = g * n_passes;
  uint32_t* dst = out + (g * n_pages + blockIdx.x) * sim::kBitmapWords + warp;

  // This thread's row of the first tile, requested with the page words.
  uint32_t f = 0u;
  uint4 qm = make_uint4(0u, 0u, 0u, 0u);
  load_row(queries, masks, flags, row0, slot, n_passes, f, qm);
  if (randomized) {
    const uint32_t ctr = sim::stream_ctr(page_id, seed, slot);
    d_lo ^= sim::mix2_32(ctr, sim::kLoSalt);
    d_hi ^= sim::mix2_32(ctr, sim::kHiSalt);
  }

  const unsigned lt = (1u << lane) - 1u;
  bool inc = false;
  bool exc = false;
  for (int p0 = 0; p0 < n_passes; p0 += kPassTile) {
    if (p0 > 0) {
      load_row(queries, masks, flags, row0, p0 + slot, n_passes, f, qm);
    }
    const unsigned b_inc = __ballot_sync(0xFFFFFFFFu, f == kPassInclude);
    const unsigned b_exc = __ballot_sync(0xFFFFFFFFu, f == kPassExclude);
    if (lane == 0) s_count[warp] = __popc(b_inc) | (__popc(b_exc) << 16);
    // The counts are in, and every thread is done with the last tile's lists.
    __syncthreads();
    uint32_t before = 0u, all = 0u;
#pragma unroll
    for (int w4 = 0; w4 < kWarps / 4; ++w4) {
      const uint4 c = reinterpret_cast<const uint4*>(s_count)[w4];
      const uint32_t cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        all += cw[e];
        before += 4 * w4 + e < warp ? cw[e] : 0u;
      }
    }
    const int at_inc = __popc(b_inc & lt) + static_cast<int>(before & 0xFFFFu);
    const int at_exc = __popc(b_exc & lt) + static_cast<int>(before >> 16);
    const int n_inc = static_cast<int>(all & 0xFFFFu);
    const int n_exc = static_cast<int>(all >> 16);
    if (n_inc == 0 && n_passes <= kPassTile) {   // no include row at all
      if (lane == 0) *dst = 0u;
      return;
    }
    if (f == kPassInclude) s_inc[at_inc] = qm;
    if (f == kPassExclude) s_exc[at_exc] = qm;
    __syncthreads();
    inc |= any_hit(s_inc, n_inc, d_lo, d_hi);
    exc |= any_hit(s_exc, n_exc, d_lo, d_hi);
  }
  const uint32_t bits = __ballot_sync(0xFFFFFFFFu, inc && !exc);
  if (lane == 0) *dst = bits;
}

}  // namespace

// lo, hi: (C, N, 512); queries, masks: (C, G, P, 2); flags: (C, G, P);
// page_ids, page_seeds: (C, N); out: (C, G, N, 16).  All uint32,
// contiguous, on `device`.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int sim_plan_launch(const void* lo, const void* hi,
                               const void* queries, const void* masks,
                               const void* flags, const void* page_ids,
                               const void* page_seeds, void* out, int n_pages,
                               int n_groups, int n_passes, int n_chips,
                               int randomized, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_pages, n_groups, n_chips);
  plan_kernel<<<grid, sim::kSlots, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint32_t*>(queries), static_cast<const uint32_t*>(masks),
      static_cast<const uint32_t*>(flags),
      static_cast<const uint32_t*>(page_ids),
      static_cast<const uint32_t*>(page_seeds), static_cast<uint32_t*>(out),
      n_pages, n_groups, n_passes, randomized);
  return static_cast<int>(cudaGetLastError());
}

// Flash attention on Hopper: tiled online-softmax attention with GQA,
// causal and sliding-window masks, for prefill (Sq = Sk) and decode (Sq = 1
// against a cache) alike.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (_attn_kernel, launched by flash_attention_kernel).  The TPU version walks
// its k tiles as a sequential grid axis and carries (acc, m, l) in VMEM
// scratch between grid steps; here the warps of a block take the key tiles
// in parallel, each with its own (m, l, acc) in registers, and merge them
// through shared memory at the end.  Unlike the TPU wrapper, which falls
// back to dense XLA attention for shapes that do not tile, this kernel
// takes any Sq and Sk.
//
// Semantics (held against ref.py::attention_ref): q (B, Sq, H, D), k/v
// (B, Sk, Hkv, D), the layout of the wrapper's callers, read in place; q
// head h reads kv head h / group, group = H / Hkv.
// Query row i sits at absolute position q_offset + i and sees key j when
// j <= q_offset + i (causal) and j > q_offset + i - window (window > 0).
// Logits, running max, denominator and accumulator are float32; masked
// logits are -1e30 and enter with probability 0; a row that sees no key
// gives 0.  The output is rounded once, to q's dtype.  Optionally the
// kernel also writes each row's log-sum-exp, float32 (B, Sq, H): M + log L
// in natural-log units of the scaled, masked logits, or -1e30 for a row
// that sees no key.  A caller that splits the keys over several launches
// (decode attention split along the cache over a mesh axis) merges their
// outputs by it.
//
// What bounds it on the H100: at the serve path's shapes (qwen3-4b prefill
// Sq = Sk <= 16; decode Sq = 1 against a 128-slot cache) the bytes: q, k
// and v read once and the output written once, tens of KB a launch, so a
// launch is latency-bound and what counts is how many SMs share the loads
// and how few dependent steps each warp takes.  At the JAX sweep shape
// (Sq = Sk = 256) the multiply-adds bound it; in bf16 they run on the
// tensor cores, in float32 on the CUDA cores (TF32 would break the 2e-6
// tolerance against the plain version).
//
// Design:
// - In place.  The kernel reads q, k and v in the (B, S, H, D) layout the
//   model holds them in (k and v are the cache itself at decode) and
//   writes the output in that layout, so the wrapper copies nothing: a
//   head-major flattening would cost two copies of the cache a call.
// - GQA packing.  A block serves all `group` q heads of one (b, kv head):
//   its rows are the (position, q head) pairs of the Sq x group rows of
//   that kv head, position-major (a position's group heads are adjacent
//   in memory), 16 rows a warp-row.  Each K/V row is read from device
//   memory once per kv head and block, not once per q head.  Grid (row
//   tiles, Hkv, B).
// - Key-parallel warps.  A block has 4 warps: `row_warps` (1, 2 or 4) row
//   tiles of 16 times 4 / row_warps key splits.  A warp takes keys a step
//   at a time (32 in bf16, 16 in float32); within a staged chunk, warp
//   (rw, ks) takes steps ks, ks + 4 / row_warps, ...  With few rows (a
//   decode step: group rows) the warps split the keys, so no warp walks
//   the key range alone.  The launcher takes the largest row_warps that
//   still gives every SM a block, else 1.  With one split, or one step of
//   keys in the block, the warp that took it writes its output rows
//   straight from registers.  Otherwise every warp stashes (m, l) and its
//   accumulator in shared memory, and after one barrier each warp of a
//   row tile sums its share of the output fragments over the splits,
//   times exp(m_s - M) / L.  Warps whose rows are all padding skip the key
//   steps.
// - Asynchronous copies.  Q, K and V tiles arrive by cp.async, 16 bytes a
//   thread, double-buffered over chunks of keys (128 in bf16, 64 in
//   float32; one barrier a chunk), and stay in the input dtype in shared
//   memory (rows padded by 16 bytes, which keeps ldmatrix and the float32
//   path's vector loads free of bank conflicts).  Only the rows of the
//   steps a block visits are staged; those outside its visible key range
//   are zero-filled.  Shared memory is dynamic (up to 210,944 bytes at
//   float32, D = 128).
// - Short critical path.  At a decode step one warp's chain of dependent
//   instructions is the kernel's time, so the loads walk rows by pointer
//   steps, each row's visible key range is computed once, divisions by the
//   group size are a multiply and a shift, the first step skips the
//   rescale of a zero accumulator, fragments load ahead of their mma, and
//   exp2 is one ex2.approx in bf16.
// - bf16 on the tensor cores.  S = Q K^T and O += P V run as
//   mma.sync.m16n8k16 bf16 -> f32 fed by ldmatrix (V through .trans); the
//   online softmax runs on the accumulator fragments in registers and P is
//   rounded to bf16 for the product, as the JAX _attend does.  wgmma and
//   TMA are not used: the blocks have 16-64 rows.
// - float32 on the CUDA cores, with the same packing and key splits: lane
//   (rr, kk) scores rows 4rr..4rr+3 against keys kk and kk + 8 of a step
//   with float4 loads, and accumulates dims 2kk + 16i, 2kk + 16i + 1.
// - Templated on the element type (float, bf16) and on D, every multiple
//   of 16 from 16 to 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 16 * kWarps;
constexpr int kPadBytes = 16;        // per staged row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (relative error about 2^-22; the bf16 path
// rounds P to 8 bits of mantissa anyway).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// n / d for 0 <= n < 2^31 by a multiply and a shift, d fixed at launch
// (a division by a runtime int costs some 20 dependent instructions).
struct FastDiv {
  uint32_t d, m, s;
  FastDiv() = default;
  __host__ explicit FastDiv(uint32_t divisor) : d(divisor), s(0) {
    while ((1u << s) < d) ++s;
    m = static_cast<uint32_t>(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    const uint32_t u = static_cast<uint32_t>(n);
    return static_cast<int>((__umulhi(u, m) + u) >> s);
  }
};

// Everything a warp needs to know about the block's rows and keys.
struct Tile {
  FastDiv group;
  int sk, total_rows, row0;
  size_t q_off;           // elements to the block's (b, first q head), row 0
  size_t kv_off;          // elements to the block's (b, kv head), row 0
  int q_stride;           // elements between two positions of q (H * D)
  int kv_stride;          // elements between two positions of k, v (Hkv * D)
  int causal, window, q_offset;
  int k_begin, k_end;     // keys any row of the block can see
  float scale;
  size_t lse_off;         // elements to the block's (b, first q head) in lse
};

// The keys [lo, hi) that row r of the block (0 <= r < 16 * row_warps)
// sees: causal, window and the cache end, from its absolute position; none
// for a padding row past the last real one.
__device__ __forceinline__ int2 row_cols(const Tile& t, int r) {
  const int rg = t.row0 + r;
  if (rg >= t.total_rows) return make_int2(0, 0);
  const int pos = t.q_offset + t.group.div(rg);
  return make_int2(t.window > 0 ? max(0, pos - t.window + 1) : 0,
                   t.causal ? min(t.sk, pos + 1) : t.sk);
}

__device__ __forceinline__ bool sees(int2 cols, int col) {
  return col >= cols.x && col < cols.y;
}

// Bytes between two staged rows of D elements of T.
template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return D * static_cast<int>(sizeof(T)) + kPadBytes;
}

// Keys staged a chunk (two chunk buffers, double-buffered) and keys a warp
// takes a step.  bf16 steps are 32 keys (four 8-key mma tiles: one
// softmax round for twice the keys); float32 steps are 16.
constexpr int kStages = 2;
template <typename T>
struct Keys;
template <>
struct Keys<__nv_bfloat16> {
  static constexpr int kChunk = 128, kStep = 32;
};
template <>
struct Keys<float> {
  static constexpr int kChunk = 64, kStep = 16;
};

// Per warp, for the merge of key splits: its (m, l) of each row it holds
// (4 x 32 float2 at most) and its accumulator (16 D floats).
template <int D>
__host__ __device__ constexpr int merge_bytes() {
  return kWarps * (4 * 32 * 8 + 64 * D);
}

template <typename T, int D>
__host__ __device__ constexpr int smem_bytes(int rows) {
  return rows * row_stride<T, D>() +
         2 * kStages * Keys<T>::kChunk * row_stride<T, D>() +
         merge_bytes<D>() +
         (sizeof(T) == 4 ? kWarps * 16 * (Keys<T>::kStep + 4) * 4 : 0);
}

// Element offset of block row rg, (position rg / group, q head rg % group
// of the block's kv head), in q and out.
template <int D>
__device__ __forceinline__ size_t q_row(const Tile& t, int rg) {
  const int i = t.group.div(rg);
  return t.q_off + static_cast<size_t>(i) * t.q_stride +
         static_cast<size_t>(rg - i * static_cast<int>(t.group.d)) * D;
}

// Stage the block's real q rows.  Padding rows stay as they are: every
// logit of theirs is masked (row_cols), so their contents never count.
// Element offset of block row rg in the log-sum-exp (B, Sq, H).
__device__ __forceinline__ size_t lse_row(const Tile& t, int rg, int heads) {
  const int i = t.group.div(rg);
  return t.lse_off + static_cast<size_t>(i) * heads +
         (rg - i * static_cast<int>(t.group.d));
}

template <typename T, int D>
__device__ __forceinline__ void load_q(char* q_s, const T* q, const Tile& t,
                                       int rows) {
  constexpr int kVecs = D * static_cast<int>(sizeof(T)) / 16;
  const int real = min(rows, t.total_rows - t.row0);
  for (int i = threadIdx.x; i < real * kVecs; i += kThreads) {
    const int r = i / kVecs, c = i % kVecs;
    cp_async16(q_s + r * row_stride<T, D>() + 16 * c,
               reinterpret_cast<const char*>(q + q_row<D>(t, t.row0 + r)) +
                   16 * c,
               16);
  }
}

// Whether the warps visit the step of keys at column col.
template <typename T>
__device__ __forceinline__ bool visited(const Tile& t, int col) {
  return col < t.k_end && col + Keys<T>::kStep > t.k_begin;
}

// Stage the keys of the chunk at c0 that a visited step reads (a contiguous
// run of 16-key steps); those outside [k_begin, k_end) are zero-filled (a
// masked key enters with p = 0, and 0 times a stale NaN would not be 0).
// Thread i copies 16-byte column i % kVecs of every kThreads / kVecs-th
// row, walking the rows by pointer steps: a warp runs this alone at a
// decode step, so every instruction here is on the critical path.
template <typename T, int D>
__device__ __forceinline__ void load_kv(char* k_s, char* v_s, const T* k,
                                        const T* v, const Tile& t, int c0) {
  constexpr int kVecs = D * static_cast<int>(sizeof(T)) / 16;
  constexpr int kPass = kThreads / kVecs;           // rows a pass covers
  constexpr int kStep = Keys<T>::kStep;
  const int lo = (max(t.k_begin - c0, 0) / kStep) * kStep;
  const int hi =
      min(Keys<T>::kChunk, ((t.k_end - c0 + kStep - 1) / kStep) * kStep);
  const int in_lo = t.k_begin - c0, in_hi = t.k_end - c0;
  const int c = threadIdx.x % kVecs;
  int r = lo + threadIdx.x / kVecs;
  const size_t step = static_cast<size_t>(kPass) * t.kv_stride * sizeof(T);
  const size_t first = (t.kv_off + static_cast<size_t>(c0 + r) * t.kv_stride) *
                           sizeof(T) + 16 * c;
  const char* kp = reinterpret_cast<const char*>(k) + first;
  const char* vp = reinterpret_cast<const char*>(v) + first;
  char* ks = k_s + r * row_stride<T, D>() + 16 * c;
  char* vs = v_s + r * row_stride<T, D>() + 16 * c;
  for (; r < hi; r += kPass) {
    const bool in = r >= in_lo && r < in_hi;
    cp_async16(ks, in ? kp : reinterpret_cast<const char*>(k), in ? 16 : 0);
    cp_async16(vs, in ? vp : reinterpret_cast<const char*>(v), in ? 16 : 0);
    kp += step;
    vp += step;
    ks += kPass * row_stride<T, D>();
    vs += kPass * row_stride<T, D>();
  }
}

// ---------------------------------------------------------------- bf16 path
// A warp's 16 rows as mma fragments: this thread holds rows g and g + 8
// (g = lane / 4), columns 2t, 2t + 1 of every 8-wide tile (t = lane % 4).
template <int D>
struct WarpBf16 {
  static constexpr int kSpan = 4;      // lanes sharing a row
  static constexpr int kRows = 2;      // rows a thread holds
  // m is in log2 units: exp(logit - max) = exp2(m' - max').
  static __device__ float exp_m(float x) { return fast_exp2(x); }
  // The row's natural log-sum-exp from its max m and denominator l.
  static __device__ float lse(float m, float l) {
    return l > 0.f ? (m + log2f(l)) * kLn2 : kNegInf;
  }
  uint32_t qa[D / 16][4];
  float acc[D / 8][4];
  float m[2], l[2];
  int2 cols[2];
  bool started = false;                // a step has run (warp-uniform)

  // Before the loads land: the row state.  After: q's fragments.
  __device__ void setup(const char*, const Tile& t, int rw, int lane, float*) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
      cols[h] = row_cols(t, rw * 16 + (lane >> 2) + 8 * h);
    }
  }
  __device__ void load_q_frags(const char* q_s, int rw, int lane) {
    constexpr int kStride = row_stride<__nv_bfloat16, D>();
    const int r = rw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      ldsm_x4(qa[kd], q_s + r * kStride + 2 * (kd * 16 + (lane >> 4) * 8));
    }
  }

  // Keys [kb, kb + 32) of the staged chunk, absolute column col0 + kb: S
  // as four 8-key tiles, one softmax round, then P V as two 16-key halves.
  __device__ void step(const char* k_s, const char* v_s, const Tile& t,
                       int kb, int col0, int lane) {
    constexpr int kStride = row_stride<__nv_bfloat16, D>();
    float s[4][4] = {};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // Even and odd 16-dim slices in separate chains, summed at the end,
      // halve the dependent mma chain.  All fragments load first: the asm
      // is volatile, so the compiler keeps program order, and an mma right
      // behind its load would wait for it.
      float s_odd[2][4] = {};
      const char* kp = k_s +
                       (kb + 16 * half + (lane & 7) + ((lane >> 4) << 3)) *
                           kStride +
                       2 * (((lane >> 3) & 1) * 8);
      uint32_t b[D / 16][4];
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) ldsm_x4(b[kd], kp + 2 * kd * 16);
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        if (kd % 2) {
          mma_bf16(s_odd[0], qa[kd], b[kd][0], b[kd][1]);
          mma_bf16(s_odd[1], qa[kd], b[kd][2], b[kd][3]);
        } else {
          mma_bf16(s[2 * half], qa[kd], b[kd][0], b[kd][1]);
          mma_bf16(s[2 * half + 1], qa[kd], b[kd][2], b[kd][3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s[2 * half + e / 4][e % 4] += s_odd[e / 4][e % 4];
      }
    }
    // V's first half loads while the softmax runs.
    const char* vp = v_s + (kb + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                     2 * ((lane >> 4) * 8);
    uint32_t b[D / 16][4];
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) ldsm_x4_trans(b[nd], vp + 2 * nd * 16);
    const int tq = lane & 3;
    const float scale2 = t.scale * kLog2e;  // logits in log2 units
    float p[4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + kb + 8 * j + 2 * tq + e;
          float& x = s[j][2 * h + e];
          x = sees(cols[h], col) ? x * scale2 : kNegInf;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float corr = fast_exp2(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * h + e];
          p[j][2 * h + e] = x == kNegInf ? 0.f : fast_exp2(x - m_new);
          sum += p[j][2 * h + e];
        }
      }
      l[h] = l[h] * corr + sum;
      m[h] = m_new;
      if (started) {                   // before the first step acc is 0
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          acc[i][2 * h] *= corr;
          acc[i][2 * h + 1] *= corr;
        }
      }
    }
    started = true;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (half == 1) {
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          ldsm_x4_trans(b[nd], vp + 16 * kStride + 2 * nd * 16);
        }
      }
      const float(&p0)[4] = p[2 * half];
      const float(&p1)[4] = p[2 * half + 1];
      const uint32_t pa[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                              pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        mma_bf16(acc[2 * nd], pa, b[nd][0], b[nd][1]);
        mma_bf16(acc[2 * nd + 1], pa, b[nd][2], b[nd][3]);
      }
    }
  }

  __device__ int row(int h, int rw, int lane) const {
    return rw * 16 + (lane >> 2) + 8 * h;
  }
  // Write this thread's accumulator of row h times f into a row of D
  // elements (shared float32, or the output).
  template <typename U>
  __device__ void write(U* red_row, int h, float f, int lane) const {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      store_pair(red_row + 8 * i + 2 * (lane & 3), acc[i][2 * h] * f,
                 acc[i][2 * h + 1] * f);
    }
  }

  // The accumulator in lane-major order (16 D floats a warp), for a partner
  // warp to add: consecutive lanes touch consecutive 16 bytes.
  __device__ void stash(float* buf, int lane) const {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      reinterpret_cast<float4*>(buf)[i * 32 + lane] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  // Output fragments ks, ks + splits, ... of this lane's rows: the sum
  // over the splits' stashes (warp rw + sp * row_warps) times f[sp][row].
  template <typename U>
  static __device__ void merge_write(const float* acc_buf, int rw,
                                     int row_warps, int splits, int ks,
                                     int lane, float (&f)[kWarps][2],
                                     U* const* dst) {
    for (int i = ks; i < D / 8; i += splits) {
      float a[4] = {};
#pragma unroll
      for (int sp = 0; sp < kWarps; ++sp) {
        if (sp >= splits) break;
        const float4 x = reinterpret_cast<const float4*>(
            acc_buf + (rw + sp * row_warps) * 16 * D)[i * 32 + lane];
        a[0] += x.x * f[sp][0];
        a[1] += x.y * f[sp][0];
        a[2] += x.z * f[sp][1];
        a[3] += x.w * f[sp][1];
      }
      if (dst[0]) store_pair(dst[0] + 8 * i + 2 * (lane & 3), a[0], a[1]);
      if (dst[1]) store_pair(dst[1] + 8 * i + 2 * (lane & 3), a[2], a[3]);
    }
  }
};

// ------------------------------------------------------------- float32 path
// Lane (rr, kk) = (lane / 8, lane % 8) holds rows 4rr .. 4rr + 3 of the
// warp's 16, keys kk and kk + 8 of a step, dims 2kk + 16i and 2kk + 16i + 1.
template <int D>
struct WarpF32 {
  static constexpr int kSpan = 8;
  static constexpr int kRows = 4;
  static __device__ float exp_m(float x) { return expf(x); }
  static __device__ float lse(float m, float l) {
    return l > 0.f ? m + logf(l) : kNegInf;
  }
  float2 acc[4][D / 16];
  float m[4], l[4];
  int2 cols[4];
  bool started = false;
  const float* q_rows;     // the lane's first q row in shared memory
  float* p_s;              // the warp's 16 x (16 + 4) probabilities

  __device__ void setup(const char* q_s, const Tile& t, int rw, int lane,
                        float* p_warp) {
    constexpr int kStride = row_stride<float, D>();
    q_rows = reinterpret_cast<const float*>(q_s + (rw * 16 + 4 * (lane >> 3)) *
                                                      kStride);
    p_s = p_warp;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = kNegInf;
      l[j] = 0.f;
      cols[j] = row_cols(t, rw * 16 + 4 * (lane >> 3) + j);
#pragma unroll
      for (int i = 0; i < D / 16; ++i) acc[j][i] = make_float2(0.f, 0.f);
    }
  }
  __device__ void load_q_frags(const char*, int, int) {}   // q stays in smem

  __device__ void step(const char* k_s, const char* v_s, const Tile& t,
                       int kb, int col0, int lane) {
    constexpr int kStride = row_stride<float, D>();
    constexpr int kRow = kStride / 4;          // floats between rows
    const int rr = lane >> 3, kk = lane & 7;
    const float* k0 = reinterpret_cast<const float*>(k_s) + (kb + kk) * kRow;
    float s[4][2] = {};
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = *reinterpret_cast<const float4*>(q_rows + j * kRow + d);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        kv[c] = *reinterpret_cast<const float4*>(k0 + 8 * c * kRow + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          s[j][c] += qv[j].x * kv[c].x + qv[j].y * kv[c].y +
                     qv[j].z * kv[c].z + qv[j].w * kv[c].w;
        }
      }
    }
    float* p_rows = p_s + 4 * rr * (Keys<float>::kStep + 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + kb + kk + 8 * c;
        s[j][c] = sees(cols[j], col) ? s[j][c] * t.scale : kNegInf;
        mx = fmaxf(mx, s[j][c]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      }
      const float m_new = fmaxf(m[j], mx);
      const float corr = expf(m[j] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = s[j][c] == kNegInf ? 0.f : expf(s[j][c] - m_new);
        p_rows[j * (Keys<float>::kStep + 4) + kk + 8 * c] = p;
        sum += p;
      }
      l[j] = l[j] * corr + sum;
      m[j] = m_new;
      if (started) {                   // before the first step acc is 0
#pragma unroll
        for (int i = 0; i < D / 16; ++i) {
          acc[j][i].x *= corr;
          acc[j][i].y *= corr;
        }
      }
    }
    started = true;
    __syncwarp();
    const float* v0 = reinterpret_cast<const float*>(v_s) + kb * kRow + 2 * kk;
#pragma unroll
    for (int key = 0; key < Keys<float>::kStep; key += 4) {
      float4 pv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pv[j] = *reinterpret_cast<const float4*>(
            p_rows + j * (Keys<float>::kStep + 4) + key);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = v0 + (key + u) * kRow;
#pragma unroll
        for (int i = 0; i < D / 16; ++i) {
          const float2 vv = *reinterpret_cast<const float2*>(vr + 16 * i);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float pj = u == 0 ? pv[j].x : u == 1 ? pv[j].y
                           : u == 2 ? pv[j].z : pv[j].w;
            acc[j][i].x += pj * vv.x;
            acc[j][i].y += pj * vv.y;
          }
        }
      }
    }
    __syncwarp();                        // p_s is rewritten by the next step
  }

  __device__ int row(int j, int rw, int lane) const {
    return rw * 16 + 4 * (lane >> 3) + j;
  }
  template <typename U>
  __device__ void write(U* red_row, int j, float f, int lane) const {
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      store_pair(red_row + 16 * i + 2 * (lane & 7), acc[j][i].x * f,
                 acc[j][i].y * f);
    }
  }

  __device__ void stash(float* buf, int lane) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        reinterpret_cast<float2*>(buf)[(j * (D / 16) + i) * 32 + lane] =
            acc[j][i];
      }
    }
  }
  template <typename U>
  static __device__ void merge_write(const float* acc_buf, int rw,
                                     int row_warps, int splits, int ks,
                                     int lane, float (&f)[kWarps][4],
                                     U* const* dst) {
    for (int i = ks; i < D / 16; i += splits) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int sp = 0; sp < kWarps; ++sp) {
          if (sp >= splits) break;
          const float2* stashed = reinterpret_cast<const float2*>(
              acc_buf + (rw + sp * row_warps) * 16 * D);
          const float2 x = stashed[(j * (D / 16) + i) * 32 + lane];
          a += x.x * f[sp][j];
          b += x.y * f[sp][j];
        }
        if (dst[j]) store_pair(dst[j] + 16 * i + 2 * (lane & 7), a, b);
      }
    }
  }
};

template <typename T, int D>
struct WarpOf;
template <int D>
struct WarpOf<__nv_bfloat16, D> {
  using type = WarpBf16<D>;
};
template <int D>
struct WarpOf<float, D> {
  using type = WarpF32<D>;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int sq, int sk,
    FastDiv group, int kv_heads, float scale, int causal, int window,
    int q_offset, int row_warps) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kStride = row_stride<T, D>();
  const int rows = 16 * row_warps;
  const int splits = kWarps / row_warps;
  char* q_s = smem;
  constexpr int kChunk = Keys<T>::kChunk;
  constexpr int kStep = Keys<T>::kStep;
  char* kv_s = smem + rows * kStride;            // [stage][k | v][64 rows]
  char* merge_s = kv_s + 2 * kStages * kChunk * kStride;
  float* p_s = reinterpret_cast<float*>(merge_s + merge_bytes<D>());

  Tile t;
  t.sk = sk;
  t.group = group;
  t.total_rows = sq * static_cast<int>(group.d);
  t.row0 = blockIdx.x * rows;
  const int b = blockIdx.z, hk = blockIdx.y;
  t.q_stride = kv_heads * static_cast<int>(group.d) * D;
  t.kv_stride = kv_heads * D;
  t.q_off = static_cast<size_t>(b) * sq * t.q_stride +
            static_cast<size_t>(hk) * group.d * D;
  t.kv_off = static_cast<size_t>(b) * sk * t.kv_stride +
             static_cast<size_t>(hk) * D;
  const int heads = kv_heads * static_cast<int>(group.d);
  t.lse_off = static_cast<size_t>(b) * sq * heads +
              static_cast<size_t>(hk) * group.d;
  t.causal = causal;
  t.window = window;
  t.q_offset = q_offset;
  t.scale = scale;
  const int first_pos = q_offset + group.div(t.row0);
  const int last_pos =
      q_offset + group.div(min(t.row0 + rows, t.total_rows) - 1);
  t.k_end = max(0, causal ? min(sk, last_pos + 1) : sk);
  t.k_begin = window > 0 ? max(0, first_pos - window + 1) : 0;
  const int c_first = (t.k_begin / kChunk) * kChunk;
  const int n_chunks =
      t.k_end > t.k_begin ? (t.k_end - c_first + kChunk - 1) / kChunk : 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % row_warps, ks = warp / row_warps;
  const bool idle = t.row0 + 16 * rw >= t.total_rows;   // padding rows only

  // The ring: chunk c goes to stage c % kStages; one commit group a chunk
  // (the first also holds q), empty groups past the last chunk.
  load_q<T, D>(q_s, q, t, rows);
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) {
      char* buf = kv_s + c * 2 * kChunk * kStride;
      load_kv<T, D>(buf, buf + kChunk * kStride, k, v, t,
                    c_first + c * kChunk);
    }
    cp_async_commit();
  }

  typename WarpOf<T, D>::type w;
  w.setup(q_s, t, rw, lane, p_s + warp * 16 * (Keys<float>::kStep + 4));
  for (int it = 0; it < n_chunks || it == 0; ++it) {
    cp_async_wait<kStages - 2>();     // chunk it (and q) have landed
    __syncthreads();                  // ... for every thread; chunk it - 1
                                      // is consumed, its stage free
    if (it == 0) w.load_q_frags(q_s, rw, lane);
    const int nxt = it + kStages - 1;
    if (nxt < n_chunks) {
      char* buf = kv_s + (nxt % kStages) * 2 * kChunk * kStride;
      load_kv<T, D>(buf, buf + kChunk * kStride, k, v, t,
                    c_first + nxt * kChunk);
    }
    cp_async_commit();
    if (it < n_chunks && !idle) {
      const int c0 = c_first + it * kChunk;
      const char* k_b = kv_s + (it % kStages) * 2 * kChunk * kStride;
      for (int st = ks; st < kChunk / kStep; st += splits) {
        const int col = c0 + st * kStep;
        if (!visited<T>(t, col)) continue;
        w.step(k_b, k_b + kChunk * kStride, t, st * kStep, c0, lane);
      }
    }
  }
  cp_async_wait<0>();

  // Each thread's rows: the denominator summed over the lanes that share a
  // row.
  using Warp = typename WarpOf<T, D>::type;
  float l_row[Warp::kRows];
#pragma unroll
  for (int j = 0; j < Warp::kRows; ++j) {
    l_row[j] = w.l[j];
#pragma unroll
    for (int o = 1; o < Warp::kSpan; o <<= 1) {
      l_row[j] += __shfl_xor_sync(kFull, l_row[j], o);
    }
  }
  T* dst[Warp::kRows];
#pragma unroll
  for (int j = 0; j < Warp::kRows; ++j) {
    const int rg = t.row0 + w.row(j, rw, lane);
    dst[j] = rg < t.total_rows ? out + q_row<D>(t, rg) : nullptr;
  }
  // One split, or a block with at most one step of keys to see (a prefill
  // of 16, a short decode): the warp that took the step writes its rows
  // straight from registers, and their log-sum-exps from one lane a row;
  // the others hold nothing.
  const int n_steps = t.k_end > t.k_begin
                          ? (t.k_end - 1) / kStep - t.k_begin / kStep + 1
                          : 0;
  if (splits == 1 || n_steps <= 1) {
    const int owner =
        n_steps == 1 ? (t.k_begin / kStep) % (kChunk / kStep) % splits : 0;
    if (ks != owner) return;
#pragma unroll
    for (int j = 0; j < Warp::kRows; ++j) {
      if (dst[j]) {
        w.write(dst[j], j, l_row[j] > 0.f ? 1.f / l_row[j] : 0.f, lane);
        if (lse && lane % Warp::kSpan == 0) {
          lse[lse_row(t, t.row0 + w.row(j, rw, lane), heads)] =
              Warp::lse(w.m[j], l_row[j]);
        }
      }
    }
    return;
  }
  // Otherwise every warp stashes (m, l) of its rows and its accumulator in
  // lane-major order, and after one barrier each warp of a row tile sums
  // its share of the output fragments over the splits' stashes, times
  // f = exp(m_s - M) / L; the first split's warp writes the log-sum-exps
  // M + log L.
  float2* ml = reinterpret_cast<float2*>(merge_s);        // [warp][row][lane]
  float* acc_buf = reinterpret_cast<float*>(merge_s + kWarps * 4 * 32 * 8);
#pragma unroll
  for (int j = 0; j < Warp::kRows; ++j) {
    ml[(warp * 4 + j) * 32 + lane] = make_float2(w.m[j], l_row[j]);
  }
  w.stash(acc_buf + warp * 16 * D, lane);
  __syncthreads();                    // ... and every key stage is consumed
  float f[kWarps][Warp::kRows];
  float row_lse[Warp::kRows];
#pragma unroll
  for (int j = 0; j < Warp::kRows; ++j) {
    float mx = kNegInf;
#pragma unroll
    for (int sp = 0; sp < kWarps; ++sp) {
      f[sp][j] = 0.f;
      if (sp < splits) {
        mx = fmaxf(mx, ml[((rw + sp * row_warps) * 4 + j) * 32 + lane].x);
      }
    }
    float den = 0.f;
#pragma unroll
    for (int sp = 0; sp < kWarps; ++sp) {
      if (sp >= splits) break;
      const float2 x = ml[((rw + sp * row_warps) * 4 + j) * 32 + lane];
      f[sp][j] = Warp::exp_m(x.x - mx);
      den += x.y * f[sp][j];
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;
#pragma unroll
    for (int sp = 0; sp < kWarps; ++sp) f[sp][j] *= inv;
    row_lse[j] = Warp::lse(mx, den);
  }
  Warp::merge_write(acc_buf, rw, row_warps, splits, ks, lane, f, dst);
  if (lse && ks == 0 && lane % Warp::kSpan == 0) {
#pragma unroll
    for (int j = 0; j < Warp::kRows; ++j) {
      if (dst[j]) {
        lse[lse_row(t, t.row0 + w.row(j, rw, lane), heads)] = row_lse[j];
      }
    }
  }
}

// Blocks a launch must reach before the launcher packs more row tiles into
// a block: one a SM.
int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n <= 0) {
      n = 132;
    }
    counts[device] = n;
  }
  return counts[device];
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 float* lse, int batch, int sq, int sk, int group,
                 int kv_heads, float scale, int causal, int window,
                 int q_offset, int device, cudaStream_t stream) {
  static unsigned long long attr_set = 0;      // devices, one bit each
  const unsigned long long bit = 1ull << (device & 63);
  if (!(attr_set & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<T, D>(kMaxRows));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= bit;
  }
  const int n_kv = batch * kv_heads;
  const int total = sq * group;
  // The largest row_warps that still gives every SM a block, else 1 (the
  // most blocks; their spare warps split the keys).
  int row_warps = 1;
  for (int rw = kWarps; rw > 1; rw >>= 1) {
    if (static_cast<long long>((total + 16 * rw - 1) / (16 * rw)) * n_kv >=
        sm_count(device)) {
      row_warps = rw;
      break;
    }
  }
  const int rows = 16 * row_warps;
  attn_kernel<T, D><<<dim3((total + rows - 1) / rows, kv_heads, batch),
                      kThreads, smem_bytes<T, D>(rows), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk,
      FastDiv(static_cast<uint32_t>(group)), kv_heads, scale, causal, window,
      q_offset, row_warps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* out,
               float* lse, int batch, int sq, int sk, int d, int group,
               int kv_heads, float scale, int causal, int window,
               int q_offset, int device, cudaStream_t stream) {
#define FA_CASE(DIM)                                                         \
  case DIM:                                                                  \
    return launch_typed<T, DIM>(q, k, v, out, lse, batch, sq, sk, group,    \
                                kv_heads, scale, causal, window, q_offset,   \
                                device, stream);
  switch (d) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(48)
    FA_CASE(64)
    FA_CASE(80)
    FA_CASE(96)
    FA_CASE(112)
    FA_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_CASE
}

}  // namespace

// q, out: (batch, sq, heads, d); k, v: (batch, sk, kv_heads, d); all of
// one element type, dtype 0 = float32, 1 = bfloat16; heads a multiple of
// kv_heads; d a multiple of 16 from 16 to 128; window 0 = none.  lse:
// float32 (batch, sq, heads), each row's log-sum-exp, or null for none.
// Contiguous, 16-byte aligned, on `device`.  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a dtype, d or head
// count it does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int batch, int sq, int sk, int d,
                                      int heads,
                                      int kv_heads, float scale, int causal,
                                      int window, int q_offset, int dtype,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kv_heads <= 0 || heads % kv_heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = heads / kv_heads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_dim<float>(q, k, v, out, static_cast<float*>(lse), batch,
                             sq, sk, d, group, kv_heads, scale, causal, window,
                             q_offset, device, s);
  }
  if (dtype == 1) {
    return launch_dim<__nv_bfloat16>(q, k, v, out, static_cast<float*>(lse),
                                     batch, sq, sk, d, group, kv_heads, scale,
                                     causal, window, q_offset, device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Paged decode attention: one new token per sequence attends over a KV cache
// kept in pages and addressed through a block table.
//
// Replaces the Pallas kernel src/repro/kernels/paged_attention/kernel.py::
// paged_attention (body _paged_kernel).  For q (B, Hq, D), k_pages and
// v_pages (P, page_size, Hkv, D), block_table (B, pages_per_seq) int32 and
// seq_lens (B,) int32, f32 or bf16, with g = Hq / Hkv query rows per KV head:
//   s = (q * sm_scale) . k^T in f32 over positions pos < seq_lens[b], the
//       row of position pos being row pos % page_size of page
//       block_table[b, pos / page_size];
//   out = softmax(s) . v, accumulated in f32, divided by max(l, 1e-30) and
//       rounded once to q's type, so a sequence of length 0 gives 0.
// No row at or past seq_lens[b] is read, so pages past the live length (and
// their table entries) are never touched; the last page is masked inside.
//
// What bounds it on an H100: bytes.  Each live row's K and V are read once
// (D values of one KV head at a stride of Hkv * D), and the g query rows of
// a KV head share them: about g flops a byte (7 at qwen2-7b's GQA, 1 at
// zamba2-1.2b's MHA).  What keeps a kernel from that bound is latency: a
// row's address is known only after its page id is read, and a block that
// waits for its loads before it computes leaves the memory idle meanwhile.
//
// The TPU kernel walks the pages on a sequential grid axis, its DMA engine
// chasing block_table[b, p] from scalar prefetch, with (m, l, acc) in VMEM.
// Blocks run in no order here, and one block per (b, KV head) would fill only
// B * Hkv blocks (64 at qwen2-7b's decode shape, of 132 SMs).  So the grid is
// (splits, Hkv, B): each block walks one contiguous range of split_len
// positions of its sequence (the wrapper picks split_len from this call's
// live lengths, for about sixteen blocks of work per SM, which keeps the
// last wave short) and writes an f32 partial (m, l, acc[g, D]) to a
// workspace; paged_combine_kernel then merges the splits of each query row
// and writes out.  Blocks past their sequence's end exit at once.
//
// bf16 (paged_mma_kernel): four warps a block, each on its own chunks of
// 16 positions (chunk i of warp w starts at 16 (4 i + w)), with no block
// barrier until the warps' partials are merged:
//   * loads in flight while a chunk computes: each warp keeps a ring of
//     three chunk stages of K and V in shared memory, filled by cp.async
//     (16 bytes a lane, rows padded by 16 bytes), two chunks ahead of the
//     one it computes; rows past the sequence's end are zero-filled and
//     read nothing;
//   * the page ids ahead of the loads: lane r holds the page id of row r of
//     the next chunk to load, read one chunk before it is needed, so the
//     indirection's latency hides behind a chunk's compute;
//   * scores on the tensor cores: the g query rows are one mma.sync
//     m16n8k16 A fragment padded to 16 rows, held in registers for the
//     whole walk, and K comes from shared memory by ldmatrix; s stays in
//     the accumulator registers for the online softmax (exp2 of the score
//     times scale * log2 e; q is not rounded again);
//   * p . v on the tensor cores too: p rounded once to bf16 (as the bf16
//     flash kernel does) is the A fragment straight from the score
//     registers, v comes by ldmatrix.trans, acc[16, D] is f32 in registers;
//   * the four warps' (m, l, acc) are merged through shared memory once,
//     when the block ends.
// Tiles are D padded to 64 or 128 columns (zero-filled), so any D of the
// wrapper's works.
//
// f32 (paged_partial_kernel; its 2e-5 limit is too tight for bf16 products),
// per tile of 64 positions a block of 128 threads
//   1. reads the tile's page ids and turns them into row offsets;
//   2. copies the K and V rows into shared memory as 16-byte vectors
//      (neighbouring threads on neighbouring addresses, 16 loads in flight a
//      thread), rows padded by 16 bytes;
//   3. scores: two threads a position, each half of D, the g query rows on
//      the f32 FMA lanes (q scaled, in f32, in shared memory, read as a
//      broadcast);
//   4. online softmax, one warp a query row;
//   5. acc = acc * alpha + p . v: each thread owns one column of 4 of every
//      query row and walks a share of the positions, so each V element
//      leaves shared memory once for all g rows; the shares are summed when
//      the block ends.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;                  // positions per tile
constexpr int kParts = kThreads / kTile;   // threads a position in the score pass
constexpr int kBatch = 8;                  // 16-byte loads of K (and of V) in flight a thread
constexpr float kNegInf = -1e30f;
static_assert(kParts == 2, "the score pass splits D in two halves");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  return x;
}

// K and V rows are kept in shared memory as they are in device memory, each
// row padded by 16 bytes (so that lanes reading one column of many rows
// spread over the banks)
__host__ __device__ constexpr int row_pitch(int D) { return D + 4; }

template <int MAXG>
size_t smem_bytes(int g, int D) {
  return sizeof(long long) * kTile +
         sizeof(float) * ((size_t)g * D + (size_t)kParts * g * kTile + (size_t)kTile * MAXG +
                          3 * (size_t)g) +
         2 * sizeof(float) * (size_t)kTile * row_pitch(D);
}

// The K and V rows of a tile's n positions (row offsets in roff) into ks and
// vs (n rows of pitch P), 16 bytes a load, kBatch loads of each in flight.
__device__ __forceinline__ void load_tile(const float* __restrict__ kp,
                                          const float* __restrict__ vp, const long long* roff,
                                          float* ks, float* vs, int n, int nvec, int P) {
  constexpr int VN = 4;  // floats a 16-byte load
  const int total = n * nvec;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    uint4 rk[kBatch], rv[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      if (i < total) {
        const int t = i / nvec;
        const long long off = roff[t] + (long long)(i - t * nvec) * VN;
        rk[j] = __ldg(reinterpret_cast<const uint4*>(kp + off));
        rv[j] = __ldg(reinterpret_cast<const uint4*>(vp + off));
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      if (i < total) {
        const int t = i / nvec;
        const int o = t * P + (i - t * nvec) * VN;
        *reinterpret_cast<uint4*>(ks + o) = rk[j];
        *reinterpret_cast<uint4*>(vs + o) = rv[j];
      }
    }
  }
}

// One split of one (b, KV head): the f32 partial (m, l, acc) of its g query
// rows over positions [split * split_len, min(seq_len, (split + 1) * split_len)).
// MAXG bounds g (1, 2, 4, 8 or 16).
template <int MAXG>
__global__ void __launch_bounds__(kThreads, MAXG <= 8 ? 4 : 2)
paged_partial_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                     const float* __restrict__ vp,
                     const int* __restrict__ block_table, const int* __restrict__ seq_lens,
                     float* __restrict__ part_acc, float* __restrict__ part_ml, int Hkv, int g,
                     int D, int page_size, int pps, int split_len, float scale) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long len = seq_lens[b];
  const long long lo = (long long)split * split_len;
  const long long hi = min(len, lo + split_len);
  if (lo >= hi) return;  // past the sequence: the combine reads no partial of it

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* roff = reinterpret_cast<long long*>(smem_raw);  // kTile
  float* qs = reinterpret_cast<float*>(roff + kTile);         // g x D, scaled
  float* ss = qs + g * D;                                     // kParts x g x kTile
  float* pt = ss + kParts * g * kTile;                        // kTile x MAXG: p, by position
  const int P = row_pitch(D);
  float* ks = pt + kTile * MAXG;                              // kTile x P
  float* vs = ks + kTile * P;                                 // kTile x P
  float* ms = vs + kTile * P;                                 // g: running max
  float* ls = ms + g;                                         // g: running sum
  float* as = ls + g;                                         // g: this tile's rescale

  const int tid = threadIdx.x;
  const int nvec = D / 4;  // 16-byte vectors a row
  const int D4 = D / 4;                        // columns of 4 elements a row

  const float* qb = q + ((long long)b * Hkv + h) * g * D;  // query rows h * g .. h * g + g - 1
  for (int i = tid; i < g * D4; i += kThreads) {
    float4 x = load4(qb + 4 * i);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(qs + 4 * i) = x;
  }
  for (int i = tid; i < g; i += kThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }

  // p . v: this thread owns column c (4 elements) of every query row, for
  // the positions pg, pg + groups, ...; the groups are summed at the end
  const int groups = kThreads / D4;
  const int pg = tid / D4, c = tid - pg * D4;
  const bool active = pg < groups;
  float4 acc[MAXG];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) acc[gi] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int* bt = block_table + (long long)b * pps;
  const int t_score = tid % kTile, part = tid / kTile;
  const int half = (D4 + 1) / 2;
  const int cbeg = part * half, cend = min(D4, cbeg + half);
  const int warp = tid / 32, lane = tid % 32;

  for (long long t0 = lo; t0 < hi; t0 += kTile) {
    const int n = (int)min((long long)kTile, hi - t0);
    // 1. the page indirection
    if (tid < n) {
      const long long pos = t0 + tid;
      const int page = bt[pos / page_size];
      roff[tid] = (((long long)page * page_size + pos % page_size) * Hkv + h) * D;
    }
    __syncthreads();
    // 2. K and V rows
    load_tile(kp, vp, roff, ks, vs, n, nvec, P);
    __syncthreads();
    // 3. partial scores over half of D, two threads a position
    if (t_score < n) {
      float s[MAXG];
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) s[gi] = 0.f;
      const float* kr = ks + t_score * P;
      for (int cc = cbeg; cc < cend; ++cc) {
        const float4 k4 = load4(kr + 4 * cc);
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi) {
          if (gi < g) {
            const float4 q4 = *reinterpret_cast<const float4*>(qs + gi * D + 4 * cc);
            s[gi] = fmaf(q4.x, k4.x, s[gi]);
            s[gi] = fmaf(q4.y, k4.y, s[gi]);
            s[gi] = fmaf(q4.z, k4.z, s[gi]);
            s[gi] = fmaf(q4.w, k4.w, s[gi]);
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi)
        if (gi < g) ss[(part * g + gi) * kTile + t_score] = s[gi];
    }
    __syncthreads();
    // 4. online softmax, one warp a query row; p goes to pt by position
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      const float* row0 = ss + gi * kTile;
      const float* row1 = ss + (g + gi) * kTile;
      const float s0 = lane < n ? row0[lane] + row1[lane] : kNegInf;
      const float s1 = lane + 32 < n ? row0[lane + 32] + row1[lane + 32] : kNegInf;
      const float m_prev = ms[gi];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
      pt[lane * MAXG + gi] = p0;
      pt[(lane + 32) * MAXG + gi] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        as[gi] = alpha;
        ls[gi] = ls[gi] * alpha + sum;
        ms[gi] = m_new;
      }
    }
    __syncthreads();
    // 5. acc = acc * alpha + p . v, each v column read once for all g rows
    if (active) {
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        if (gi < g) {
          const float a = as[gi];
          acc[gi].x *= a;
          acc[gi].y *= a;
          acc[gi].z *= a;
          acc[gi].w *= a;
        }
      }
      for (int t = pg; t < n; t += groups) {
        const float4 v4 = load4(vs + t * P + 4 * c);
        const float* pr = pt + t * MAXG;
        if constexpr (MAXG >= 4) {
#pragma unroll
          for (int g4 = 0; g4 < MAXG; g4 += 4) {
            if (g4 < g) {
              const float4 p4 = *reinterpret_cast<const float4*>(pr + g4);
              fma4(acc[g4], p4.x, v4);
              if (g4 + 1 < g) fma4(acc[g4 + 1], p4.y, v4);
              if (g4 + 2 < g) fma4(acc[g4 + 2], p4.z, v4);
              if (g4 + 3 < g) fma4(acc[g4 + 3], p4.w, v4);
            }
          }
        } else {
#pragma unroll
          for (int gi = 0; gi < MAXG; ++gi)
            if (gi < g) fma4(acc[gi], pr[gi], v4);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites roff, ks, vs, ss and pt
  }

  // the partial: each query row's columns summed over the position groups
  // (through ks, free now: groups x D4 <= kThreads float4s), then written
  const long long pid = ((long long)b * Hkv + h) * gridDim.x + split;
  float4* pacc = reinterpret_cast<float4*>(part_acc + pid * g * D);
  float4* red = reinterpret_cast<float4*>(ks);
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    if (gi < g) {
      if (active) red[pg * D4 + c] = acc[gi];
      __syncthreads();
      if (tid < D4) {
        float4 x = red[tid];
        for (int k = 1; k < groups; ++k) {
          const float4 y = red[k * D4 + tid];
          x.x += y.x;
          x.y += y.y;
          x.z += y.z;
          x.w += y.w;
        }
        pacc[gi * D4 + tid] = x;
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < g; i += kThreads) {
    part_ml[(pid * g + i) * 2] = ms[i];
    part_ml[(pid * g + i) * 2 + 1] = ls[i];
  }
}

// ---------------------------------------------------------------------------
// bf16: cp.async ring a warp, scores and p . v on mma.sync (see the note)
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;  // positions a warp's chunk: the k of the p . v product
constexpr int kStages = 3;  // a warp's ring: two chunks in flight while one computes

template <int DP>  // D padded to 64 or 128 columns
struct MmaTile {
  static constexpr int kPitch = DP + 8;                     // bf16 a shared row: 16 bytes of pad
  static constexpr int kStage = 2 * kChunk * kPitch;        // K rows, then V rows
  static constexpr int kRing = kStages * kStage;            // a warp's ring
  static constexpr int kVecs = DP / 8;                      // 16-byte vectors a row
  static constexpr int kLoads = kChunk * kVecs / 32;        // of K (and of V) a lane a chunk
  static constexpr int kSteps = DP / 16;                    // k steps of the scores
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * kWarps * kRing + sizeof(float) * kWarps * kChunk * 2;
  static_assert(kWarps * kChunk * DP * sizeof(float) <= sizeof(__nv_bfloat16) * kWarps * kRing,
                "the warps' accumulators are merged in the ring");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, or 16 zero bytes (nothing read) where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// One split of one (b, KV head), as paged_partial_kernel, but (m, l) in the
// log2 domain of s * scale * log2(e).
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 4 : 2)
paged_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                 const __nv_bfloat16* __restrict__ vp, const int* __restrict__ block_table,
                 const int* __restrict__ seq_lens, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int Hkv, int g, int D, int page_size, int pps,
                 int split_len, float scale_log2) {
  using Tile = MmaTile<DP>;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  // positions stay below 2^30 (the wrapper checks), so lo and hi fit an int
  const long long lo64 = (long long)split * split_len;
  const int lo = (int)min(lo64, (long long)seq_lens[b]);
  const int hi = (int)min((long long)seq_lens[b], lo64 + split_len);
  if (lo >= hi) return;  // past the sequence: the combine reads no partial of it

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * Tile::kRing;
  float* ml = reinterpret_cast<float*>(reinterpret_cast<__nv_bfloat16*>(smem_raw) +
                                       kWarps * Tile::kRing);  // kWarps x 16 x (m, l)
  const int fr = lane / 4, fc = lane % 4;  // the mma fragments' row and column pair
  const int* bt = block_table + (long long)b * pps;
  const long long row_stride = (long long)Hkv * D;

  // the g query rows as the A fragment of every k step, zero past g and D
  uint32_t qa[Tile::kSteps][4];
  const __nv_bfloat16* qb = q + ((long long)b * Hkv + h) * g * D;
#pragma unroll
  for (int kk = 0; kk < Tile::kSteps; ++kk) {
    const int c0 = 16 * kk + 2 * fc;
    const bool lo_ok = 16 * kk < D, hi_ok = 16 * kk + 8 < D;
    qa[kk][0] = fr < g && lo_ok ? ld_u32(qb + fr * D + c0) : 0u;
    qa[kk][1] = fr + 8 < g && lo_ok ? ld_u32(qb + (fr + 8) * D + c0) : 0u;
    qa[kk][2] = fr < g && hi_ok ? ld_u32(qb + fr * D + c0 + 8) : 0u;
    qa[kk][3] = fr + 8 < g && hi_ok ? ld_u32(qb + (fr + 8) * D + c0 + 8) : 0u;
  }

  // this warp's chunks: i = 0 .. mine - 1 at positions lo + 16 (4 i + warp)
  const int chunks = (hi - lo + kChunk - 1) / kChunk;
  const int mine = chunks > warp ? (chunks - warp + kWarps - 1) / kWarps : 0;
  const int my_row = lane % kChunk;  // the row whose page id this lane reads
  auto chunk_pos = [&](int i) { return lo + kChunk * (kWarps * i + warp); };
  // the page id of row my_row of chunk i, or -1 past the sequence (no read)
  auto page_of = [&](int i) {
    const int pos = chunk_pos(i) + my_row;
    return i < mine && pos < hi ? __ldg(bt + pos / page_size) : -1;
  };
  // chunk i into its stage, rows' page ids in pid (lane r: row r)
  auto issue = [&](int i, int pid) {
    __nv_bfloat16* ks = ring + (i % kStages) * Tile::kStage;
    __nv_bfloat16* vs = ks + kChunk * Tile::kPitch;
    const int pos0 = chunk_pos(i);
    const long long my_off =
        pid < 0 ? -1
                : ((long long)pid * page_size + (pos0 + my_row) % page_size) * row_stride +
                      (long long)h * D;
#pragma unroll
    for (int j = 0; j < Tile::kLoads; ++j) {
      const int v = lane + 32 * j;
      const int row = v / Tile::kVecs, col = 8 * (v % Tile::kVecs);
      const long long off = __shfl_sync(0xFFFFFFFFu, my_off, row);
      const bool ok = off >= 0 && col < D;
      const long long src = ok ? off + col : 0;
      cp_async16(ks + row * Tile::kPitch + col, kp + src, ok);
      cp_async16(vs + row * Tile::kPitch + col, vp + src, ok);
    }
  };

  float acc[2 * Tile::kSteps][4];
#pragma unroll
  for (int n = 0; n < 2 * Tile::kSteps; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows fr and fr + 8

  // ldmatrix addresses: K (non-transposed) and V (transposed), lane's row and column
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  // the prologue: chunks 0 and 1 in flight, chunk 2's page ids on their way
  // (a group is committed for every chunk, empty past the last)
  int pid_next = page_of(0);
  const int pid1 = page_of(1);
  if (mine > 0) issue(0, pid_next);
  cp_async_commit();
  if (mine > 1) issue(1, pid1);
  cp_async_commit();
  pid_next = page_of(2);

  for (int i = 0; i < mine; ++i) {
    // chunk i + 2 into the stage that chunk i - 1 left, then chunk i + 3's page ids
    if (i + 2 < mine) issue(i + 2, pid_next);
    cp_async_commit();
    pid_next = page_of(i + 3);
    cp_async_wait<kStages - 1>();  // this lane's copies of chunk i have landed
    __syncwarp();                  // and every lane's
    const __nv_bfloat16* ks = ring + (i % kStages) * Tile::kStage;
    const __nv_bfloat16* vs = ks + kChunk * Tile::kPitch;

    // s[16 rows, 16 positions] = q . k^T: two n tiles of 8 positions
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < Tile::kSteps; ++kk) {
      if (16 * kk < D) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + k_row * Tile::kPitch + 16 * kk + k_col);
        mma_bf16(s[0], qa[kk], kb[0], kb[1]);
        mma_bf16(s[1], qa[kk], kb[2], kb[3]);
      }
    }
    // online softmax in registers: s[j][0..1] row fr, s[j][2..3] row fr + 8,
    // at positions pos0 + 8 j + 2 fc + {0, 1}
    const int pos = chunk_pos(i) + 2 * fc;
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = pos + 8 * j + (e & 1) < hi ? s[j][e] * scale_log2 : -INFINITY;
      }
      t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
      t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      t0 = fmaxf(t0, __shfl_xor_sync(0xFFFFFFFFu, t0, o));
      t1 = fmaxf(t1, __shfl_xor_sync(0xFFFFFFFFu, t1, o));
    }
    const float mn0 = fmaxf(m0, t0), mn1 = fmaxf(m1, t1);  // finite: a chunk holds a live row
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // p, rounded once to bf16, is the A fragment of p . v (k = the 16 positions)
    uint32_t pa[4];
    pa[0] = pack_bf16(exp2_approx(s[0][0] - mn0), exp2_approx(s[0][1] - mn0));
    pa[1] = pack_bf16(exp2_approx(s[0][2] - mn1), exp2_approx(s[0][3] - mn1));
    pa[2] = pack_bf16(exp2_approx(s[1][0] - mn0), exp2_approx(s[1][1] - mn0));
    pa[3] = pack_bf16(exp2_approx(s[1][2] - mn1), exp2_approx(s[1][3] - mn1));
    l0 = l0 * a0 + (bf16_lo(pa[0]) + bf16_hi(pa[0]) + bf16_lo(pa[2]) + bf16_hi(pa[2]));
    l1 = l1 * a1 + (bf16_lo(pa[1]) + bf16_hi(pa[1]) + bf16_lo(pa[3]) + bf16_hi(pa[3]));
#pragma unroll
    for (int n = 0; n < 2 * Tile::kSteps; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    // acc += p . v: two n tiles of 8 columns an ldmatrix
#pragma unroll
    for (int kk = 0; kk < Tile::kSteps; ++kk) {
      if (16 * kk < D) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + v_row * Tile::kPitch + 16 * kk + v_col);
        mma_bf16(acc[2 * kk], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * kk + 1], pa, vb[2], vb[3]);
      }
    }
    __syncwarp();  // every lane is done with the stage before it is filled again
  }
  cp_async_wait<0>();  // the empty groups past the last chunk

  // the warps' partials merged: row sums over the quad, then (m, l) by warp
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xFFFFFFFFu, l0, o);
    l1 += __shfl_xor_sync(0xFFFFFFFFu, l1, o);
  }
  if (fc == 0) {
    ml[(warp * kChunk + fr) * 2] = m0;
    ml[(warp * kChunk + fr) * 2 + 1] = l0;
    ml[(warp * kChunk + fr + 8) * 2] = m1;
    ml[(warp * kChunk + fr + 8) * 2 + 1] = l1;
  }
  __syncthreads();  // every warp's ring is idle now, and ml is complete
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    mx0 = fmaxf(mx0, ml[(w * kChunk + fr) * 2]);
    mx1 = fmaxf(mx1, ml[(w * kChunk + fr + 8) * 2]);
  }
  // a warp with no chunk has m = -inf and acc = 0: its share is 0
  const float f0 = exp2_approx(m0 - mx0), f1 = exp2_approx(m1 - mx1);
  float* red = reinterpret_cast<float*>(smem_raw);  // kWarps x 16 x DP, over the rings
  float* mine_red = red + warp * kChunk * DP;
#pragma unroll
  for (int n = 0; n < 2 * Tile::kSteps; ++n) {
    const int col = 8 * n + 2 * fc;
    if (fr < g)
      *reinterpret_cast<float2*>(mine_red + fr * DP + col) = make_float2(acc[n][0] * f0, acc[n][1] * f0);
    if (fr + 8 < g)
      *reinterpret_cast<float2*>(mine_red + (fr + 8) * DP + col) =
          make_float2(acc[n][2] * f1, acc[n][3] * f1);
  }
  __syncthreads();
  const long long pid = ((long long)b * Hkv + h) * gridDim.x + split;
  float* pacc = part_acc + pid * g * D;
  for (int i = threadIdx.x; i < g * (D / 4); i += kThreads) {
    const int row = i / (D / 4), col = 4 * (i - row * (D / 4));
    float4 x = *reinterpret_cast<const float4*>(red + row * DP + col);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 y = *reinterpret_cast<const float4*>(red + (w * kChunk + row) * DP + col);
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    *reinterpret_cast<float4*>(pacc + row * D + col) = x;
  }
  if ((int)threadIdx.x < g) {
    const int row = threadIdx.x;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, ml[(w * kChunk + row) * 2]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      l += ml[(w * kChunk + row) * 2 + 1] * exp2_approx(ml[(w * kChunk + row) * 2] - m);
    part_ml[(pid * g + row) * 2] = m;
    part_ml[(pid * g + row) * 2 + 1] = l;
  }
}

// out[b, hq] from the partials of the splits that cover sequence b; a
// sequence of length 0 has none and gives 0.  Grid (Hq, B).  LOG2: the
// partials' m is in the log2 domain (paged_mma_kernel's).
template <typename T, bool LOG2>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     const int* __restrict__ seq_lens, T* __restrict__ out, int Hkv, int g, int D,
                     int split_len, int splits) {
  const int hq = blockIdx.x, b = blockIdx.y;
  const int h = hq / g, gi = hq - h * g;
  const int used = (int)(((long long)seq_lens[b] + split_len - 1) / split_len);
  const long long base = ((long long)b * Hkv + h) * splits;
  auto ex = [](float x) { return LOG2 ? exp2f(x) : expf(x); };
  float m = kNegInf;
  for (int s = 0; s < used; ++s) m = fmaxf(m, part_ml[((base + s) * g + gi) * 2]);
  float l = 0.f;
  for (int s = 0; s < used; ++s) {
    const long long i = ((base + s) * g + gi) * 2;
    l += part_ml[i + 1] * ex(part_ml[i] - m);
  }
  const float denom = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < used; ++s) {
      const long long i = (base + s) * g + gi;
      acc = fmaf(part_acc[i * D + d], ex(part_ml[i * 2] - m), acc);
    }
    store_f32(out + ((long long)b * Hkv * g + hq) * D + d, acc / denom);
  }
}

template <typename T, bool LOG2>
cudaError_t launch_combine(const float* part_acc, const float* part_ml, const int* sl, void* out,
                           int B, int Hkv, int g, int D, int split_len, int splits,
                           cudaStream_t stream) {
  paged_combine_kernel<T, LOG2><<<dim3(Hkv * g, B), kThreads, 0, stream>>>(
      part_acc, part_ml, sl, static_cast<T*>(out), Hkv, g, D, split_len, splits);
  return cudaGetLastError();
}

template <int MAXG>
cudaError_t launch_f32(const void* q, const void* kp, const void* vp, const int* bt, const int* sl,
                       float* part_acc, float* part_ml, void* out, int B, int Hkv, int g, int D,
                       int page_size, int pps, int split_len, int splits, float scale,
                       cudaStream_t stream) {
  auto kern = paged_partial_kernel<MAXG>;
  const size_t smem = smem_bytes<MAXG>(g, D);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp), static_cast<const float*>(vp),
      bt, sl, part_acc, part_ml, Hkv, g, D, page_size, pps, split_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<float, false>(part_acc, part_ml, sl, out, B, Hkv, g, D, split_len, splits,
                                      stream);
}

cudaError_t dispatch_f32(const void* q, const void* kp, const void* vp, const int* bt,
                         const int* sl, float* part_acc, float* part_ml, void* out, int B, int Hkv,
                         int g, int D, int page_size, int pps, int split_len, int splits,
                         float scale, cudaStream_t st) {
#define RT_PAGED_LAUNCH(G)                                                                       \
  return launch_f32<G>(q, kp, vp, bt, sl, part_acc, part_ml, out, B, Hkv, g, D, page_size, pps, \
                       split_len, splits, scale, st)
  if (g <= 1) RT_PAGED_LAUNCH(1);
  if (g <= 2) RT_PAGED_LAUNCH(2);
  if (g <= 4) RT_PAGED_LAUNCH(4);
  if (g <= 8) RT_PAGED_LAUNCH(8);
  RT_PAGED_LAUNCH(16);
#undef RT_PAGED_LAUNCH
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* kp, const void* vp, const int* bt,
                        const int* sl, float* part_acc, float* part_ml, void* out, int B, int Hkv,
                        int g, int D, int page_size, int pps, int split_len, int splits,
                        float scale, cudaStream_t stream) {
  using Bf = __nv_bfloat16;
  auto kern = paged_mma_kernel<DP>;
  constexpr size_t smem = MmaTile<DP>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const Bf*>(q), static_cast<const Bf*>(kp), static_cast<const Bf*>(vp), bt, sl,
      part_acc, part_ml, Hkv, g, D, page_size, pps, split_len, scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<Bf, true>(part_acc, part_ml, sl, out, B, Hkv, g, D, split_len, splits,
                                  stream);
}

// Host tables onto the card, for the wrapper's host route: the SMs read a
// pinned host buffer (mapped into the card's address space) in stream
// order, 16 bytes a thread.  A copy engine's cudaMemcpyAsync of the same
// buffer, queued behind work still running, started up to 0.8 ms after that
// work ended on an H100 (PERF.md); a kernel starts when it ends.
__global__ void paged_stage_kernel(const int4* __restrict__ src, int4* __restrict__ dst, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    dst[i] = src[i];
}

}  // namespace

// host: pinned host memory (from cudaHostAlloc, as PyTorch's pinned tensors
// are), dev: device memory, bytes a multiple of 16, both 16-byte aligned.
// Launches one copy kernel on ``stream``; returns its cudaError_t.
extern "C" int rt_paged_stage_tables(const void* host, void* dev, long long bytes, void* stream) {
  void* src = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&src, const_cast<void*>(host), 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = static_cast<int>(bytes / 16);
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads < 132 ? (n + kThreads - 1) / kThreads : 132;
    paged_stage_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(src), static_cast<int4*>(dev), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// q, out (B, Hkv * g, D); k_pages, v_pages (P, page_size, Hkv, D), of one
// dtype (0: f32, 1: bf16), contiguous and 16-byte aligned; block_table
// (B, pps) and seq_lens (B,) int32, every live page id in [0, P) and
// 0 <= seq_lens <= pps * page_size (the wrapper checks both); part_acc
// (B, Hkv, splits, g, D) and part_ml (B, Hkv, splits, g, 2) f32 workspace;
// 1 <= g <= 16; D a multiple of 8 in 8..128; splits * split_len covers the
// longest sequence.  Launches the two kernels on ``stream``; returns
// cudaGetLastError().
extern "C" int rt_paged_attention(const void* q, const void* kp, const void* vp, const void* bt,
                                  const void* sl, void* part_acc, void* part_ml, void* out, int B,
                                  int Hkv, int g, int D, int page_size, int pps, int split_len,
                                  int splits, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bti = static_cast<const int*>(bt);
  const int* sli = static_cast<const int*>(sl);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == 1) {
    if (D <= 64)
      return launch_bf16<64>(q, kp, vp, bti, sli, pa, pm, out, B, Hkv, g, D, page_size, pps,
                             split_len, splits, scale, st);
    return launch_bf16<128>(q, kp, vp, bti, sli, pa, pm, out, B, Hkv, g, D, page_size, pps,
                            split_len, splits, scale, st);
  }
  return dispatch_f32(q, kp, vp, bti, sli, pa, pm, out, B, Hkv, g, D, page_size, pps, split_len,
                      splits, scale, st);
}

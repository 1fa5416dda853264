// Forward attention with an online softmax: causal, sliding-window and GQA.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (body _flash_fwd_kernel).  For q (B, Hq, Sq, D) and k, v
// (B, Hkv, Sk, D), f32 or bf16, it computes
//   s = (q * sm_scale) . k^T  in f32,
//   masked where k_pos >= Sk, or k_pos > q_pos (causal), or
//   k_pos <= q_pos - window (sliding window); k positions count from 0
//   and q positions from q_offset (0 but for a block of a sequence-parallel
//   layout, whose q rows are the tokens from q_offset on),
//   out = softmax(s) . v, accumulated in f32 and rounded once to q's type.
// q head h reads KV head h / (Hq / Hkv); no repeated K/V is materialised.
// A masked score contributes p = 0, so a row whose keys are all masked
// gives acc = 0, l = 0 and out = 0 / max(l, 1e-30) = 0, not NaN.  KV tiles
// that the causal or window mask hides from every row of a q tile are never
// loaded.  The TPU's sequential KV grid axis becomes a loop inside the
// block, and its VMEM scratch carries (m, l, acc) become registers.
//
// What bounds it on an H100: operations.  At the qwen2-7b prefill shape
// (B 2, Hq 28, S 4096, D 128, bf16, causal) it needs 2.4e11 flop over
// 134 MB, 0.24 ms at the tensor cores' bf16 rate (989 TFLOP/s); the
// softmax's exponents (16 a clock an SM) come next.  Two paths:
//
// * bf16 (the models' path): flash_fwd_wgmma_kernel, built only for sm_90a.
//   One block of 3 warpgroups (384 threads) per (128 q rows, q head,
//   batch); the grid hands out the last q tile of every head first, so
//   under a causal mask the heaviest blocks start first.
//   - Warpgroup 0 is the producer: it drops to 24 registers (setmaxnreg)
//     and one thread issues TMA loads, q once, then K and V tiles of 128
//     keys into a ring of 2 stages in shared memory (at D 128: q 32 KB +
//     2 x (32 + 32) KB = 160 KB; a deeper ring timed no faster), each
//     stage with a "full" mbarrier (the TMA's byte count) and an "empty"
//     one (the 256 consumer threads' release).
//   - Warpgroups 1 and 2 are consumers, 64 q rows each, at 240 registers.
//     S = q . k^T is wgmma m64n128k16 with both operands in shared memory
//     (K-major, 128-byte swizzle, as the TMA writes them); the online
//     softmax runs on the accumulator's own layout (row max and sum over
//     the 4 lanes of a row, 2^(s * sm_scale * log2 e - m) in one FMA and
//     one ex2), the mask only on tiles that cross the diagonal, the
//     window's edge or Sk; then O += P . V is wgmma in RS form: P from
//     registers as bf16 pairs (the accumulator layout is the A-operand
//     layout), V from shared memory as an MN-major operand.  After the
//     wgmma wait each consumer thread arrives on the stage's "empty"
//     barrier.
//   - Tensor maps are 3-D (D, S, B * H) with boxes of 64 columns x 128
//     rows: rows past Sq or Sk and columns past D come in as zeros, never
//     as the next head's rows.  A D of 128 is two 64-column boxes, and the
//     descriptors step between the two halves (LBO of V = 16 KB).
//   - P is rounded once to bf16 for P . V, as scaled_dot_product_attention
//     does.  Splitting it into bf16 hi + lo parts (two P . V products, half
//     again the tensor work) was slower and held no gate better (PERF.md).
// * f32: flash_fwd_kernel, every product an f32 FMA on the CUDA cores
//   (67 TFLOP/s peak), as the TPU kernel's _compute does, so f32 holds 2e-5
//   against the plain version.  One block of 256 threads per (q tile of 64 rows, q head,
//   batch); per KV tile of 64 keys it stages K and V (zero-padded past Sk
//   and past D) in shared memory, computes the 64 x 64 score tile
//   with each thread owning rows ty + 16 i and keys tx + 16 j (i, j < 4;
//   float4 reads along D, so a half-warp's K reads hit distinct banks),
//   reduces row max and row sum over the 16 threads of a row with warp
//   shuffles, writes p over the K tile and accumulates p . v with each
//   thread owning 4 rows x D/16 columns.  Shared memory is 3 tiles of
//   64 x (D + 4) floats (101 KB at D = 128), above the 48 KB default, so the
//   launch raises the limit with cudaFuncSetAttribute.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "the tile loaders stage 64-row tiles of q, k and v alike");

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

// rows [row0, row0 + 64) of a (len, D) row-major matrix into a 64 x LD
// tile, times `scale`; zeros past `len` and past D
template <int DP>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src, int row0,
                                          int len, int d, float scale) {
  constexpr int LD = DP + 4;
  constexpr int C4 = DP / 4;
  for (int idx = threadIdx.x; idx < kBQ * C4; idx += kThreads) {
    const int r = idx / C4;
    const int c = (idx - r * C4) * 4;
    const int gr = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < len && c < d) {
      x = *reinterpret_cast<const float4*>(src + static_cast<long long>(gr) * d + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(tile + r * LD + c) = x;
  }
}

__device__ __forceinline__ float row16_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row16_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq, int hkv, int sq,
                 int sk, int d, float sm_scale, int causal, int has_window, int window,
                 int q_pos0) {
  constexpr int LD = DP + 4;    // tile row stride in floats (float4-aligned)
  constexpr int LDP = kBK + 4;  // p tile row stride
  constexpr int NC = DP / 64;   // float4 column groups of the accumulator
  static_assert(kBQ * LDP <= kBK * LD, "the p tile must fit over the K tile");

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = ks;  // p overwrites K once the scores are taken

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const long long q_off = (static_cast<long long>(b) * hq + h) * sq * d;
  const long long kv_off = (static_cast<long long>(b) * hkv + kvh) * sk * d;

  load_tile<DP>(qs, q + q_off, q0, sq, d, sm_scale);

  float m[4], l[4], acc[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  // KV tiles some row of this q tile can see (its rows at positions
  // q_pos0 + q0 onwards)
  int k_end = sk;
  if (causal) k_end = min(k_end, q_pos0 + q0 + kBQ);
  int k_begin = 0;
  if (has_window) k_begin = max(0, q_pos0 + q0 - window + 1);
  const int t_end = (k_end + kBK - 1) / kBK;

  for (int t = k_begin / kBK; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's p and V are no longer read
    load_tile<DP>(ks, k + kv_off, k0, sk, d, 1.f);
    load_tile<DP>(vs, v + kv_off, k0, sk, d, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; dd += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_pos0 + q0 + ty + 16 * i;
      bool ok[4];
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < sk && (!causal || kp <= qp) && (!has_window || kp > qp - window);
        s[i][j] = ok[j] ? s[i][j] : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = row16_max(rmax);
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        psum += p;
      }
      psum = row16_sum(psum);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + (c + cc) * LD + n * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pr[i].x : cc == 1 ? pr[i].y : cc == 2 ? pr[i].z : pr[i].w;
            acc[i][n * 4 + 0] = fmaf(p, vv.x, acc[i][n * 4 + 0]);
            acc[i][n * 4 + 1] = fmaf(p, vv.y, acc[i][n * 4 + 1]);
            acc[i][n * 4 + 2] = fmaf(p, vv.z, acc[i][n * 4 + 2]);
            acc[i][n * 4 + 3] = fmaf(p, vv.w, acc[i][n * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* row = o + q_off + static_cast<long long>(qp) * d;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 64 + tx * 4 + e;
        if (col < d) row[col] = acc[i][n * 4 + e] / denom;
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA, mbarriers, wgmma, warp-specialised (see the note above)
// ---------------------------------------------------------------------------

constexpr int kBM = 128;           // q rows per block, 64 per consumer warpgroup
constexpr int kBN = 128;           // keys per KV tile
constexpr int kWg = 128;           // threads per warpgroup
constexpr int kWsThreads = 3 * kWg;  // producer + two consumers
constexpr int kRowBytes = 128;     // one 64-column bf16 row of a swizzled box
constexpr int kHalfTile = 128 * kRowBytes;  // a 128-row, 64-column box: 16 KB
constexpr int kStages = 2;        // K/V ring depth: 3 at D 128, 4 or 6 at D 64 timed alike
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 3-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (+)= a . b for a 64 x 16 tile of A and a 16 x 128 tile of B, both in shared
// memory (K-major, 128-byte swizzle); d is the m64n128 f32 accumulator
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a . b for a 64 x 16 tile of A in registers (the bf16 pairs of the
// accumulator layout) and a 16 x 64 tile of B in shared memory, MN-major
// (transposed), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a . b for a 64 x 16 tile of A in registers (the bf16 pairs of the
// accumulator layout) and a 16 x 128 tile of B in shared memory, MN-major
// (transposed), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// pins registers that an asynchronous wgmma writes: nothing reads them
// before the wait that precedes this
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) asm volatile("" : "+f"(r[j])::"memory");
}

// s = q . k^T for this warpgroup's 64 rows and one 128-key tile, both from
// shared memory (K-major); the first k-step overwrites s
template <int DP>
__device__ __forceinline__ void qk_issue(float (&s)[64], uint32_t qa, uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk / 4) * kHalfTile + (kk % 4) * 32;
    wgmma_ss_n128(s, sw128_desc(qa + off, 16, 1024), sw128_desc(ks + off, 16, 1024), kk);
  }
}

// acc += p . v: the accumulator fragments of two 8-key groups are the A
// fragment of one 16-key step; V is an MN-major operand, LBO steps to the
// second 64-column box, SBO to the next 8 keys
template <int DP>
__device__ __forceinline__ void pv_issue(float (&acc)[DP / 2], const uint32_t (&pa)[8][4],
                                         uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs<DP>(acc, pa[kk], sw128_desc(vs + kk * 16 * kRowBytes, kHalfTile, 1024));
}

// The online-softmax step on one score tile in the accumulator layout
// (this thread: rows at positions `row` and row + 8, keys k0 + 8 n + cq +
// {0, 1}):
// scores become p = 2^(s * scale_log2 - m) in one FMA, m and l move on,
// and alpha (the factor for acc) is returned per row.  The mask runs only
// where the tile crosses the diagonal, the window's edge or Sk.
struct Rows {
  float m[2] = {-INFINITY, -INFINITY};  // running max of s * scale_log2
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
};

__device__ __forceinline__ void softmax_tile(float (&sc)[64], Rows& r, float (&alpha)[2], bool edge,
                                             int k0, int row, int cq, int sk, int causal,
                                             int has_window, int window, float scale_log2) {
  if (scale_log2 <= 0.f) {  // fold the sign (or a zero scale) into s, so masked stays -inf
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = scale_log2 == 0.f ? 0.f : -sc[i];
    scale_log2 = scale_log2 == 0.f ? 1.f : -scale_log2;
  }
  if (edge) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * n + cq + (e & 1);
        const int qp = row + 8 * (e >> 1);
        const bool vis = kp < sk && (!causal || kp <= qp) && (!has_window || kp > qp - window);
        if (!vis) sc[4 * n + e] = -INFINITY;
      }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 16; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * hr], sc[4 * n + 2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(r.m[hr], mx * scale_log2);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
    alpha[hr] = ex2(r.m[hr] - m_use);
    r.m[hr] = m_new;
    float ps = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * n + 2 * hr + e];
        x = ex2(fmaf(x, scale_log2, -m_use));
        ps += x;
      }
    r.l[hr] = r.l[hr] * alpha[hr] + ps;
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    acc[4 * n] *= alpha[0];
    acc[4 * n + 1] *= alpha[0];
    acc[4 * n + 2] *= alpha[1];
    acc[4 * n + 3] *= alpha[1];
  }
}

// p as bf16 pairs, rounded once, in the A-fragment order of the 8 k-steps
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int j = 4 * (2 * kk + (f >> 1)) + 2 * (f & 1);
      pa[kk][f] = bf16x2(sc[j], sc[j + 1]);
    }
}

// One block per (128 q rows, q head, batch): warpgroup 0 loads, warpgroups
// 1 and 2 each own 64 of the rows.  DP is the head dim padded to 64 or 128
// (one or two 64-column boxes).  The q rows sit at positions from
// q_pos0 (0 but for a block of the sequence-parallel layout).
template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                       int hq, int hkv, int sq, int sk, int d, float scale_log2, int causal,
                       int has_window, int window, int q_pos0) {
  constexpr int H = DP / 64;                // 64-column boxes per row
  constexpr int kTileBytes = H * kHalfTile;  // one 128-row tile of q, k or v
  constexpr int kStageBytes = 2 * kTileBytes;
  constexpr int NO = DP / 2;                // output accumulator floats a thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle wants 1 KB
  const uint32_t qs = base;
  const uint32_t ring = qs + kTileBytes;
  const uint32_t q_full = ring + kStages * kStageBytes;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  // q tiles from the last: under a causal mask the heaviest go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int bh = blockIdx.x;  // b * hq + h
  const int kvbh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);

  // KV tiles some row of this block can see (its rows at positions
  // q_pos0 + q0 onwards)
  int k_end = sk;
  if (causal) k_end = min(k_end, q_pos0 + q0 + kBM);
  const int k_begin = has_window ? max(0, q_pos0 + q0 - window + 1) : 0;
  const int t_begin = k_begin / kBN;
  const int n_tiles = max(0, (k_end + kBN - 1) / kBN - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kTileBytes);
#pragma unroll
      for (int hh = 0; hh < H; ++hh) tma_load_3d(qs + hh * kHalfTile, &q_map, q_full, hh * 64, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t ks = ring + s * kStageBytes;
        const uint32_t bar = full0 + 8 * s;
        const int k0 = (t_begin + i) * kBN;
        mbar_expect_tx(bar, kStageBytes);  // full boxes, zero-filled bytes included
#pragma unroll
        for (int hh = 0; hh < H; ++hh) {
          tma_load_3d(ks + hh * kHalfTile, &k_map, bar, hh * 64, k0, kvbh);
          tma_load_3d(ks + kTileBytes + hh * kHalfTile, &v_map, bar, hh * 64, k0, kvbh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / kWg - 1;  // consumer 0 or 1
    const int t = threadIdx.x % kWg;
    const int rlo = q0 + cw * 64;          // this warpgroup's first q row
    const int plo = q_pos0 + rlo;          // and its position
    const int row = rlo + (t >> 5) * 16 + ((t & 31) >> 2);  // this thread's rows: row, row + 8
    const int cq = (t & 3) * 2;            // its column pair in each 8-column group
    const uint32_t qa = qs + cw * 64 * kRowBytes;

    float acc[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j] = 0.f;
    float sc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) sc[j] = 0.f;
    uint32_t pa[8][4];
    float alpha[2];
    Rows r;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = (t_begin + i) * kBN;
      mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      // a tile no row of this warpgroup sees is only released
      const bool dead = k0 >= sk || (causal && k0 > plo + 63) ||
                        (has_window && k0 + kBN - 1 <= plo - window);
      if (!dead) {
        const uint32_t ks = ring + s * kStageBytes;
        wgmma_fence();
        qk_issue<DP>(sc, qa, ks);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        const bool edge = k0 + kBN > sk || (causal && k0 + kBN - 1 > plo) ||
                          (has_window && k0 <= plo + 63 - window);
        softmax_tile(sc, r, alpha, edge, k0, q_pos0 + row, cq, sk, causal, has_window, window,
                     scale_log2);
        rescale(acc, alpha);
        pack_p(sc, pa);
        wgmma_fence();
        pv_issue<DP>(acc, pa, ks + kTileBytes);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
      }
      mbar_arrive(empty0 + 8 * s);
    }

    // out = acc / max(l, 1e-30), rounded once; rows past Sq never written
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lt = r.l[hr];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      const int qp = row + 8 * hr;
      if (qp >= sq) continue;
      __nv_bfloat16* out_row = o + (static_cast<long long>(bh) * sq + qp) * d;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = 8 * n + cq;
        if (col < d)
          *reinterpret_cast<uint32_t*>(out_row + col) =
              bf16x2(acc[4 * n + 2 * hr] * inv, acc[4 * n + 2 * hr + 1] * inv);
      }
    }
  }
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int hq,
                       int hkv, int sq, int sk, int d, float sm_scale, int causal, int has_window,
                       int window, int q_pos0, cudaStream_t stream) {
  constexpr int smem = 3 * kBQ * (DP + 4) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), hq, hkv, sq, sk, d, sm_scale, causal, has_window, window, q_pos0);
  return cudaGetLastError();
}


// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, rows, planes) bf16 tensor as 3-D boxes of 64 columns x 128 rows x 1
// plane, 128-byte swizzle: reads past D or past `rows` come in as zeros and
// never as the next plane's rows.  Returns the encoder's CUresult.
int encode_map(CUtensorMap* map, const void* ptr, int d, int rows, long long planes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(d) * 2 * rows};
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return static_cast<int>(encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                                 dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

constexpr int kEncodeFailed = 20000;  // + the CUresult of a refused tensor map

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
                int sq, int sk, int d, float sm_scale, int causal, int has_window, int window,
                int q_pos0, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int res = encode_map(&qm, q, d, sq, static_cast<long long>(b) * hq);
  if (res == 0) res = encode_map(&km, k, d, sk, static_cast<long long>(b) * hkv);
  if (res == 0) res = encode_map(&vm, v, d, sk, static_cast<long long>(b) * hkv);
  if (res != 0) return kEncodeFailed + res;
  // q, the ring of K and V tiles, 1 KB of alignment slack and the barriers
  constexpr int smem = (DP / 64) * kHalfTile * (1 + 2 * kStages) + 1024 + 8 * (1 + 2 * kStages);
  auto kernel = flash_fwd_wgmma_kernel<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (sq + kBM - 1) / kBM);
  constexpr float kLog2e = 1.4426950408889634f;
  kernel<<<grid, kWsThreads, smem, stream>>>(qm, km, vm, static_cast<__nv_bfloat16*>(o), hq, hkv,
                                              sq, sk, d, sm_scale * kLog2e, causal, has_window,
                                              window, q_pos0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The wrapper has checked the shapes and
// pointers: D % 8 == 0, D <= 128, Hq % Hkv == 0, every size >= 1, 16-byte
// aligned data, q_offset >= 0 and q_offset + Sq within int.  The head dim
// is padded to 64 or 128 inside the kernel.
// Any sm_scale is taken: the bf16 softmax folds a negative or zero scale
// into the scores before its row max.  Returns a cudaError_t, or 20000 plus the CUresult of a
// tensor map that cuTensorMapEncodeTiled refused.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int b,
                                  int hq, int hkv, int sq, int sk, int d, float sm_scale,
                                  int causal, int has_window, int window, int q_offset,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(d <= 64 ? launch_f32<64>(q, k, v, o, b, hq, hkv, sq, sk, d, sm_scale,
                                                     causal, has_window, window, q_offset, st)
                                    : launch_f32<128>(q, k, v, o, b, hq, hkv, sq, sk, d, sm_scale,
                                                      causal, has_window, window, q_offset, st));
  if (dtype == 1)
    return d <= 64 ? launch_bf16<64>(q, k, v, o, b, hq, hkv, sq, sk, d, sm_scale, causal,
                                     has_window, window, q_offset, st)
                   : launch_bf16<128>(q, k, v, o, b, hq, hkv, sq, sk, d, sm_scale, causal,
                                      has_window, window, q_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

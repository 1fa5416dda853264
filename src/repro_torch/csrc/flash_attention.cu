// Forward attention with an online softmax: causal, sliding-window and GQA.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (body _flash_fwd_kernel).  For q (B, Hq, Sq, D) and k, v
// (B, Hkv, Sk, D), f32 or bf16, it computes
//   s = (q * sm_scale) . k^T  in f32,
//   masked where k_pos >= Sk, or k_pos > q_pos (causal), or
//   k_pos <= q_pos - window (sliding window); positions count from 0 for
//   both q and k,
//   out = softmax(s) . v, accumulated in f32 and rounded once to q's type.
// q head h reads KV head h / (Hq / Hkv); no repeated K/V is materialised.
// A masked score contributes p = 0, so a row whose keys are all masked
// gives acc = 0, l = 0 and out = 0 / max(l, 1e-30) = 0, not NaN.  KV tiles
// that the causal or window mask hides from every row of a q tile are never
// loaded.  The TPU's sequential KV grid axis becomes a loop inside the
// block, and its VMEM scratch carries (m, l, acc) become registers.
//
// What bounds it on an H100: operations.  At the prefill shape (B 2, Hq 28,
// S 4096, D 128, bf16, causal) it needs 2.4e11 flop over 134 MB, 0.24 ms at
// the tensor cores' bf16 rate.  Two paths:
//
// * bf16 (the model's path): flash_fwd_mma_kernel, on the tensor cores
//   with mma.sync (see its note).  q and k enter the products as the bf16
//   values they are, so s is exact up to f32 summation; p is split into two
//   bf16 parts so that p . v keeps about 16 bits of p.
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
//
// Neither path pipelines its loads (no cp.async or TMA) or uses wgmma; that
// is a later PR's work.

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
                 int sk, int d, float sm_scale, int causal, int has_window, int window) {
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

  // KV tiles some row of this q tile can see
  int k_end = sk;
  if (causal) k_end = min(k_end, q0 + kBQ);
  int k_begin = 0;
  if (has_window) k_begin = max(0, q0 - window + 1);
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
      const int qp = q0 + ty + 16 * i;
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
// bf16 on the tensor cores (mma.sync.m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps, 16 q rows each

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(const void* p, unsigned& r0, unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(const void* p, unsigned& r0, unsigned& r1,
                                              unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

// d += a . b for one 16 x 8 tile: a is 16 x 16 (row-major fragment), b 16 x 8
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) as a bf16 pair hi plus the bf16 pair of what hi leaves out, so
// that hi + lo carries x and y to about 16 bits
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// rows [row0, row0 + 64) of a (len, D) bf16 matrix into a 64 x LDS tile as
// they are; zeros past `len` and past D (D % 8 == 0, so rows are 16-byte aligned)
template <int DP>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* __restrict__ src, int row0,
                                          int len, int d) {
  constexpr int LDS = DP + 8;
  constexpr int C8 = DP / 8;
  for (int idx = threadIdx.x; idx < kBQ * C8; idx += kMmaThreads) {
    const int r = idx / C8;
    const int c = (idx - r * C8) * 8;
    const int gr = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (gr < len && c < d)
      x = *reinterpret_cast<const uint4*>(src + static_cast<long long>(gr) * d + c);
    *reinterpret_cast<uint4*>(tile + r * LDS + c) = x;
  }
}

// The same function for bf16.  q . k^T is exact in the products (bf16 x
// bf16 fits f32) and summed in f32, then scaled, so s matches the f32 path
// to rounding.  p . v splits p into two bf16 parts (hi + lo) and issues both
// products, so p keeps about 16 bits instead of bf16's 8 and the output
// stays within an output rounding of the plain version.  Per KV tile: K and V copied to shared memory as bf16 (rows padded by 16
// bytes, so ldmatrix reads are conflict-free), each warp takes 16 q rows,
// S (16 x 64) from ldmatrix fragments of Q (kept in registers) and K, the
// online softmax on the accumulator fragments (row max and sum over the 4
// lanes of a row), then O += P . V with V read through ldmatrix.trans.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int hq,
                     int hkv, int sq, int sk, int d, float sm_scale, int causal, int has_window,
                     int window) {
  constexpr int LDS = DP + 8;  // bf16 row stride: 16-byte rows, distinct banks
  constexpr int KS = DP / 16;  // k-steps of q . k^T over the head dim
  constexpr int NT = DP / 8;   // 8-wide column tiles of the output
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* ks = qs + kBQ * LDS;
  __nv_bfloat16* vs = ks + kBK * LDS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the fragment row this lane holds (and g + 8)
  const int c = lane & 3;   // its column pair 2c, 2c + 1 in each 8-wide tile
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const long long q_off = (static_cast<long long>(b) * hq + h) * sq * d;
  const long long kv_off = (static_cast<long long>(b) * hkv + kvh) * sk * d;

  copy_tile<DP>(qs, q + q_off, q0, sq, d);
  __syncthreads();
  unsigned qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + kk * 16 + (lane >> 4) * 8,
            qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int k_end = sk;
  if (causal) k_end = min(k_end, q0 + kBQ);
  int k_begin = 0;
  if (has_window) k_begin = max(0, q0 - window + 1);
  const int t_end = (k_end + kBK - 1) / kBK;

  for (int t = k_begin / kBK; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // every warp is done with the previous K and V
    copy_tile<DP>(ks, k + kv_off, k0, sk, d);
    copy_tile<DP>(vs, v + kv_off, k0, sk, d);
    __syncthreads();

    // s = q . k^T: 8 column tiles of 8 keys, accumulator fragments
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b0, b1, b2, b3;
        ldsm_x4(ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 + ((lane >> 3) & 1) * 8,
                b0, b1, b2, b3);
        mma_bf16(s[2 * np], qa[kk], b0, b1);
        mma_bf16(s[2 * np + 1], qa[kk], b2, b3);
      }

    // scale and mask, then the online-softmax update of rows g and g + 8
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qp = q0 + warp * 16 + g + hr * 8;
      unsigned ok = 0;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + j * 8 + 2 * c + e;
          const bool vis = kp < sk && (!causal || kp <= qp) && (!has_window || kp > qp - window);
          ok |= static_cast<unsigned>(vis) << (j * 2 + e);
          float& x = s[j][hr * 2 + e];
          x = vis ? x * sm_scale : kNegInf;
          rmax = fmaxf(rmax, x);
        }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m[hr], rmax);
      const float alpha = expf(m[hr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][hr * 2 + e];
          x = (ok >> (j * 2 + e)) & 1u ? expf(x - m_new) : 0.f;
          psum += x;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l[hr] = l[hr] * alpha + psum;
      m[hr] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][hr * 2] *= alpha;
        acc[n][hr * 2 + 1] *= alpha;
      }
    }

    // o += p . v, 16 keys per step; the accumulator fragments of two key
    // tiles are the A fragment of one step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        unsigned b0, b1, b2, b3;
        ldsm_x4_trans(vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + dp * 16 +
                          (lane >> 4) * 8,
                      b0, b1, b2, b3);
        mma_bf16(acc[2 * dp], ph, b0, b1);
        mma_bf16(acc[2 * dp], pl, b0, b1);
        mma_bf16(acc[2 * dp + 1], ph, b2, b3);
        mma_bf16(acc[2 * dp + 1], pl, b2, b3);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = q0 + warp * 16 + g + hr * 8;
    if (qp >= sq) continue;
    const float denom = fmaxf(l[hr], 1e-30f);
    __nv_bfloat16* row = o + q_off + static_cast<long long>(qp) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * c;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[n][hr * 2] / denom, acc[n][hr * 2 + 1] / denom);
    }
  }
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int hq,
                       int hkv, int sq, int sk, int d, float sm_scale, int causal, int has_window,
                       int window, cudaStream_t stream) {
  constexpr int smem = 3 * kBQ * (DP + 4) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), hq, hkv, sq, sk, d, sm_scale, causal, has_window, window);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int hq,
                        int hkv, int sq, int sk, int d, float sm_scale, int causal,
                        int has_window, int window, cudaStream_t stream) {
  constexpr int smem = 3 * kBQ * (DP + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_mma_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), hq, hkv, sq, sk, d,
      sm_scale, causal, has_window, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The wrapper has checked the shapes and
// pointers: D % 8 == 0, D <= 128, Hq % Hkv == 0, every size >= 1, 16-byte
// aligned data.  The head dim is padded to 64 or 128 inside the kernel.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int b,
                                  int hq, int hkv, int sq, int sk, int d, float sm_scale,
                                  int causal, int has_window, int window, int dtype,
                                  void* stream) {
  using Launch = cudaError_t (*)(const void*, const void*, const void*, void*, int, int, int,
                                 int, int, int, float, int, int, int, cudaStream_t);
  Launch launch;
  if (dtype == 0)
    launch = d <= 64 ? &launch_f32<64> : &launch_f32<128>;
  else if (dtype == 1)
    launch = d <= 64 ? &launch_bf16<64> : &launch_bf16<128>;
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(q, k, v, o, b, hq, hkv, sq, sk, d, sm_scale, causal,
                                 has_window, window, static_cast<cudaStream_t>(stream)));
}

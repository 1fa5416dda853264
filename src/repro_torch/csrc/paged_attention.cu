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
// zamba2-1.2b's MHA), under the f32 lanes' 20 flops a byte at 3.35 TB/s.
//
// The TPU kernel walks the pages on a sequential grid axis, its DMA engine
// chasing block_table[b, p] from scalar prefetch, with (m, l, acc) in VMEM.
// Blocks run in no order here, and one block per (b, KV head) would fill only
// B * Hkv blocks (64 at qwen2-7b's decode shape, of 132 SMs).  So the grid is
// (splits, Hkv, B): each block walks one contiguous range of split_len
// positions of its sequence (the wrapper picks split_len from this call's
// live lengths, for about sixteen blocks of work per SM, which keeps the
// last wave short), loads the page ids of its positions itself (the
// indirection), and writes an f32 partial (m, l, acc[g, D]) to a
// workspace; paged_combine_kernel then merges the splits of each query row
// and writes out.  Blocks past their sequence's end exit at once.
//
// Per tile of 64 positions a block of 128 threads
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
//      leaves shared memory once for all g rows (a first version that read
//      it once per query row took 1.4x this one's time at g = 7 on an
//      H100); the shares are summed when the block ends.
// No wgmma, TMA or pipelined loads: a later PR's work.

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

// 4 consecutive elements of T in shared or device memory as f32 (a bf16 is
// the high half of the f32 of the same value)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xFFFF0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xFFFF0000u));
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
template <typename T>
__host__ __device__ constexpr int row_pitch(int D) {
  return D + 16 / (int)sizeof(T);
}

template <typename T, int MAXG>
size_t smem_bytes(int g, int D) {
  return sizeof(long long) * kTile +
         sizeof(float) * ((size_t)g * D + (size_t)kParts * g * kTile + (size_t)kTile * MAXG +
                          3 * (size_t)g) +
         2 * sizeof(T) * (size_t)kTile * row_pitch<T>(D);
}

// The K and V rows of a tile's n positions (row offsets in roff) into ks and
// vs (n rows of pitch P), 16 bytes a load, kBatch loads of each in flight.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ kp, const T* __restrict__ vp,
                                          const long long* roff, T* ks, T* vs, int n, int nvec,
                                          int P) {
  constexpr int VN = 16 / sizeof(T);
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
template <typename T, int MAXG>
__global__ void __launch_bounds__(kThreads, MAXG <= 8 ? 4 : 2)
paged_partial_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
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
  const int P = row_pitch<T>(D);
  T* ks = reinterpret_cast<T*>(pt + kTile * MAXG);            // kTile x P
  T* vs = ks + kTile * P;                                     // kTile x P
  float* ms = reinterpret_cast<float*>(vs + kTile * P);       // g: running max
  float* ls = ms + g;                                         // g: running sum
  float* as = ls + g;                                         // g: this tile's rescale

  const int tid = threadIdx.x;
  const int nvec = D / (16 / (int)sizeof(T));  // 16-byte vectors a row
  const int D4 = D / 4;                        // columns of 4 elements a row

  const T* qb = q + ((long long)b * Hkv + h) * g * D;  // query rows h * g .. h * g + g - 1
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
    load_tile<T>(kp, vp, roff, ks, vs, n, nvec, P);
    __syncthreads();
    // 3. partial scores over half of D, two threads a position
    if (t_score < n) {
      float s[MAXG];
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) s[gi] = 0.f;
      const T* kr = ks + t_score * P;
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

// out[b, hq] from the partials of the splits that cover sequence b; a
// sequence of length 0 has none and gives 0.  Grid (Hq, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     const int* __restrict__ seq_lens, T* __restrict__ out, int Hkv, int g, int D,
                     int split_len, int splits) {
  const int hq = blockIdx.x, b = blockIdx.y;
  const int h = hq / g, gi = hq - h * g;
  const int used = (int)(((long long)seq_lens[b] + split_len - 1) / split_len);
  const long long base = ((long long)b * Hkv + h) * splits;
  float m = kNegInf;
  for (int s = 0; s < used; ++s) m = fmaxf(m, part_ml[((base + s) * g + gi) * 2]);
  float l = 0.f;
  for (int s = 0; s < used; ++s) {
    const long long i = ((base + s) * g + gi) * 2;
    l += part_ml[i + 1] * expf(part_ml[i] - m);
  }
  const float denom = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < used; ++s) {
      const long long i = (base + s) * g + gi;
      acc = fmaf(part_acc[i * D + d], expf(part_ml[i * 2] - m), acc);
    }
    store_f32(out + ((long long)b * Hkv * g + hq) * D + d, acc / denom);
  }
}

template <typename T, int MAXG>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* bt, const int* sl,
                   float* part_acc, float* part_ml, void* out, int B, int Hkv, int g, int D,
                   int page_size, int pps, int split_len, int splits, float scale,
                   cudaStream_t stream) {
  auto kern = paged_partial_kernel<T, MAXG>;
  const size_t smem = smem_bytes<T, MAXG>(g, D);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt, sl,
      part_acc, part_ml, Hkv, g, D, page_size, pps, split_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T><<<dim3(Hkv * g, B), kThreads, 0, stream>>>(
      part_acc, part_ml, sl, static_cast<T*>(out), Hkv, g, D, split_len, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kp, const void* vp, const int* bt, const int* sl,
                     float* part_acc, float* part_ml, void* out, int B, int Hkv, int g, int D,
                     int page_size, int pps, int split_len, int splits, float scale,
                     cudaStream_t st) {
#define RT_PAGED_LAUNCH(G)                                                                     \
  return launch<T, G>(q, kp, vp, bt, sl, part_acc, part_ml, out, B, Hkv, g, D, page_size, pps, \
                      split_len, splits, scale, st)
  if (g <= 1) RT_PAGED_LAUNCH(1);
  if (g <= 2) RT_PAGED_LAUNCH(2);
  if (g <= 4) RT_PAGED_LAUNCH(4);
  if (g <= 8) RT_PAGED_LAUNCH(8);
  RT_PAGED_LAUNCH(16);
#undef RT_PAGED_LAUNCH
}

}  // namespace

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
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, kp, vp, bti, sli, pa, pm, out, B, Hkv, g, D, page_size, pps,
                                   split_len, splits, scale, st);
  return dispatch<float>(q, kp, vp, bti, sli, pa, pm, out, B, Hkv, g, D, page_size, pps, split_len,
                         splits, scale, st);
}

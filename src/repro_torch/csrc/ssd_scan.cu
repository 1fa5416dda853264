// Chunked gated linear-attention / SSD state scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan/kernel.py::ssd_scan
// (body _ssd_kernel).  Per (batch, head), with decay w_t in (0, 1]^K:
//
//   H_t = diag(w_t) H_{t-1} + k_t v_t^T        (f32 K x V state)
//   y_t = q_t . H_t,  or q_t . H_{t-1} when strict
//
// computed chunk by chunk as repro's linear_scan_chunked does: within a
// chunk of C steps, L is the cumulative log-decay log(max(w, 1e-30)), Lq is
// L (or, when strict, L - log w), and every exponent is <= 0:
//
//   y_t   = (q_t * e^{Lq_t}) . H_in + sum_s S[t, s] v_s
//   S[t,s]= sum_k q_t[k] k_s[k] e^{min(Lq_t[k] - L_s[k], 0)}   (s <= t, or s < t)
//   H_out = diag(e^{L_C}) H_in + sum_t (k_t * e^{L_C - L_t}) v_t^T
//
// With scalar_decay the decay is the same in every channel (column 0 of w,
// which may be one column wide: Mamba-2's form), so S is (q k^T) * D with one
// (C, C) decay matrix D.  Additions over the TPU kernel, both what the model
// path needs: an optional f32 initial state h0 and an optional f32 final
// state hT.
//
// Design.  The TPU kernel walks the chunks on a sequential grid axis with the
// state resident in VMEM; blocks here run in parallel and in no order, so the
// scan is the three passes of Mamba-2's SSD (arXiv:2405.21060):
//
//   1. chunk states, one block of 8 warps per (b, h, chunk): dH_c = (k *
//      e^{L_C - L})^T v, written f32 to a scratch buffer, and e^{L_C};
//   2. the state pass, one thread per (b, h, state entry): walks the chunks
//      in order, writes H_in[c] over dH_c and carries H = e^{L_C} H + dH_c
//      from h0 (or 0) to hT;
//   3. chunk outputs, one block of 8 warps per (b, h, chunk): S, then
//      y = q_hat . H_in + S . v, written once.  Its 16-byte loads of q, k,
//      w and v are in flight together (v's held in registers while its
//      region holds Lq), and H_in comes by cp.async, waited for only before
//      the products.
//
// The scratch is f32 K x V per chunk (plus the decays): 84 MB at rwkv6-3b's
// prefill shape (B 2, H 40, S 4096, K = V = 64, chunk 64) and 134 MB at
// zamba2-1.2b's (H 64), written by pass 1, read and overwritten by pass 2
// and read by pass 3 (about 0.10 and 0.16 ms of device-memory traffic at
// 3.35 TB/s), and alive only during the call: the prefill's peak grows by
// that much at most.
//
// The per-channel intra-chunk term (rwkv6) in bf16 uses sub-chunks of 16
// (GLA, arXiv:2312.06635 s4).  For t in sub-chunk i and s in an earlier
// sub-chunk j, with b_i the step before sub-chunk i and e_j the last step of
// sub-chunk j, e^{Lq_t - L_s} = e^{Lq_t - L_{b_i}} e^{L_{b_i} - L_{e_j}}
// e^{L_{e_j} - L_s}, every exponent <= 0: q~ = q e^{Lq - L_b} and k~ = k
// e^{L_e - L} take one scaling each and the pair (i, j) one K-vector d_ij, so
// the off-diagonal 16 x 16 blocks are products (q~ * d_ij) k~^T on the tensor
// cores, and only the diagonal blocks keep the (16, 16, K) pairwise
// exponents: 35 k needed a chunk of 64 at K 64 (was 129 k), 49 k taken (a
// warp takes half a block; in the first half only 8 columns hold terms).  A
// factor that underflows to 0 has a product that underflows too.
//
// Products.  bf16 inputs: every product on the tensor cores with an f32
// accumulator, mma.sync m16n8k8 TF32 where an operand is an f32 product
// (k^, q~ * d, k~, S, q^, H_in; the bf16 values of v are exact in TF32) and
// m16n8k16 bf16 for q k^T of the scalar mode (both operands inputs).  bf16
// operands for the scaled products were tried on the card too: they held
// the bf16 limit and took no less time, so the scaled operands keep TF32's
// 10-bit mantissa (bf16 has 7).  chip_smoke.py's phase 11 reports how
// close y comes to the limit beside an f32 result rounded once to bf16.
// f32 inputs run only in the comparison runs and the f32-copy gates, held at
// 1e-4: their products stay on the FMA lanes, tiled in registers (each lane
// the four outputs of an mma accumulator per 16 x 8 tile, operands reused),
// and their per-channel scores keep the plain version's per-pair exponent for
// every pair, so that they round as it does.
//
// Rounding shared with the plain version: in both dtypes L is the sequential
// f32 sum down each channel (as torch.cumsum's outer-dimension scan takes
// it) and Lq = L - log w, and f32 runs take logf/expf of the same arguments;
// with L at -650 after steps of decay 1e-30, another order of the sum moves
// the exponents' differences by more than the f32 1e-4 gate allows.  The sum
// runs one thread per channel, 16 steps from registers at a time.  A
// parallel sum for the bf16 runs (threads splitting a channel's steps,
// joined by a shuffle scan) was timed on the card against this one: slower
// in the per-channel mode, where 64 channels already run in parallel, and
// about 1% of the scalar mode's pass time faster, so there is one sum.
//
// What bounds it on an H100: the function needs only its bytes (q, k, v, w
// read and y written once); the design moves about three times those (k, v
// and w read twice, the scratch written twice and read twice), and takes
// seven to nine times the bytes' time.  Most of it is the chunk-output pass,
// whose blocks (two of 8 warps an SM: 109 KB of shared memory at K = V =
// 64) spend it in latency: their loads, all started at once and converted
// into f32 tiles, the diagonal blocks' exponents on the SFUs, and the
// products' fragment loads.  Rows of the shared tiles are padded so that
// the mma fragment loads of a warp do not share a bank.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // passes 1 and 3: eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kStateThreads = 256;  // pass 2
constexpr int kSub = 16;            // the sub-chunk, and the rows of an mma tile
constexpr int kMaxSmem = 232448;    // 227 KB, the most a block may have

enum Prec { kF32, kTF32, kBF16 };

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// two outputs at p[0], p[1] (p 4- or 8-byte aligned)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// e^x: the libdevice expf in f32 runs (the plain version's), the SFU's in bf16 runs
template <bool EXACT>
__device__ __forceinline__ float ex(float x) {
  return EXACT ? expf(x) : __expf(x);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One warp: acc[ni] += A[m0, m0 + 16) x B[., n0 + 8 ni + [0, 8)) over the
// reduction [0, kd), kd a multiple of 16.  A(i, r) and B(r, j) read shared
// memory in any layout.  acc is in the mma accumulator layout whatever P is
// (lane = 4 g + q: rows g and g + 8, columns 2 q and 2 q + 1 of each 16 x 8
// tile), so the epilogues are the same for the FMA lanes and the tensor
// cores.
template <int P, int NT, class FA, class FB>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], const FA& A, const FB& B, int m0,
                                         int n0, int kd) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = m0 + g, r1 = m0 + g + 8;
  if constexpr (P == kF32) {
#pragma unroll 4
    for (int r = 0; r < kd; ++r) {
      const float a0 = A(r0, r), a1 = A(r1, r);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int c = n0 + 8 * ni + 2 * tq;
        const float b0 = B(r, c), b1 = B(r, c + 1);
        acc[ni][0] = fmaf(a0, b0, acc[ni][0]);
        acc[ni][1] = fmaf(a0, b1, acc[ni][1]);
        acc[ni][2] = fmaf(a1, b0, acc[ni][2]);
        acc[ni][3] = fmaf(a1, b1, acc[ni][3]);
      }
    }
  } else if constexpr (P == kTF32) {
#pragma unroll 2
    for (int r = 0; r < kd; r += 8) {
      const uint32_t a[4] = {to_tf32(A(r0, r + tq)), to_tf32(A(r1, r + tq)),
                             to_tf32(A(r0, r + tq + 4)), to_tf32(A(r1, r + tq + 4))};
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int c = n0 + 8 * ni + g;
        const uint32_t b[2] = {to_tf32(B(r + tq, c)), to_tf32(B(r + tq + 4, c))};
        mma_tf32(acc[ni], a, b);
      }
    }
  } else {
#pragma unroll 2
    for (int r = 0; r < kd; r += 16) {
      const int k0 = r + 2 * tq;
      const uint32_t a[4] = {pack_bf16(A(r0, k0), A(r0, k0 + 1)),
                             pack_bf16(A(r1, k0), A(r1, k0 + 1)),
                             pack_bf16(A(r0, k0 + 8), A(r0, k0 + 9)),
                             pack_bf16(A(r1, k0 + 8), A(r1, k0 + 9))};
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int c = n0 + 8 * ni + g;
        const uint32_t b[2] = {pack_bf16(B(k0, c), B(k0 + 1, c)),
                               pack_bf16(B(k0 + 8, c), B(k0 + 9, c))};
        mma_bf16(acc[ni], a, b);
      }
    }
  }
}

// acc (the layout above) into rows m0.., columns n0.. of a shared tile
template <int NT>
__device__ __forceinline__ void acc_to_smem(float* dst, int ld, const float (&acc)[NT][4], int m0,
                                            int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int c = n0 + 8 * ni + 2 * tq;
    store2(dst + (m0 + g) * ld + c, acc[ni][0], acc[ni][1]);
    store2(dst + (m0 + g + 8) * ld + c, acc[ni][2], acc[ni][3]);
  }
}

// acc into a row-major rows x cols array in device memory, inside its bounds
template <typename T, int NT>
__device__ __forceinline__ void acc_to_global(T* dst, int rows, int cols,
                                              const float (&acc)[NT][4], int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const bool pairs = (cols & 1) == 0;  // then c even and c + 1 < cols: one aligned store
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int c = n0 + 8 * ni + 2 * tq;
    if (c >= cols) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h;
      if (r >= rows) continue;
      T* p = dst + (long long)r * cols + c;
      if (pairs) {
        store2(p, acc[ni][2 * h], acc[ni][2 * h + 1]);
      } else {
        p[0] = from_f32<T>(acc[ni][2 * h]);
        if (c + 1 < cols) p[1] = from_f32<T>(acc[ni][2 * h + 1]);
      }
    }
  }
}

// out = A . B over the reduction [0, kd(mi)) for every 16-row tile mi <
// mtiles and 8 NT columns: items of one warp each, the row tiles in the
// order 0, last, 1, last - 1, ... so that neighbouring items pair cheap and
// dear reductions; out is row-major rows x cols in device memory.  A
// second product A2 . B2 over [0, kd2(mi)) adds in when kd2 is given.
template <int P, int NT, typename T, class FA, class FB, class FA2, class FB2, class KD, class KD2>
__device__ __forceinline__ void products_to_global(T* out, int rows, int cols, int mtiles,
                                                   int ncols_p, const FA& A, const FB& B,
                                                   const KD& kd, const FA2& A2, const FB2& B2,
                                                   const KD2& kd2) {
  const int warp = threadIdx.x >> 5, ngroups = ncols_p / (8 * NT);
  for (int it = warp; it < ngroups * mtiles; it += kWarps) {
    const int r = it / ngroups, ng = it - r * ngroups;
    const int mi = r & 1 ? mtiles - 1 - (r >> 1) : r >> 1;
    float acc[NT][4] = {};
    mma_rows<P, NT>(acc, A, B, 16 * mi, 8 * NT * ng, kd(mi));
    if (kd2(mi)) mma_rows<P, NT>(acc, A2, B2, 16 * mi, 8 * NT * ng, kd2(mi));
    acc_to_global<T, NT>(out, rows, cols, acc, 16 * mi, 8 * NT * ng);
  }
}

// log(clamp(w, min=1e-30)) where log is set: the plain version's logf for
// f32 inputs, the SFU's for bf16 ones
template <typename T>
__device__ __forceinline__ float prep(float x, bool log) {
  if (!log) return x;
  return std::is_same<T, float>::value ? logf(fmaxf(x, 1e-30f)) : __logf(fmaxf(x, 1e-30f));
}

// One tile of a chunk: dst[r * ld + c] = prep(src[r * cols + c]) for r <
// rows, c < cols, and 0 on the rest of [0, rows_p) x [0, cols_p).
template <typename T>
struct Tile {
  float* dst;
  int ld;
  const T* src;
  int rows, cols, rows_p, cols_p;
  bool log;
};

template <typename T>
__device__ __forceinline__ void zero_pad(const Tile<T>& t) {
  const int pc = t.cols_p - t.cols;
  for (int i = threadIdx.x; i < t.rows * pc; i += kThreads) {
    const int r = i / pc;
    t.dst[r * t.ld + t.cols + i - r * pc] = 0.f;
  }
  for (int i = threadIdx.x; i < (t.rows_p - t.rows) * t.cols_p; i += kThreads) {
    const int r = i / t.cols_p;
    t.dst[(t.rows + r) * t.ld + i - r * t.cols_p] = 0.f;
  }
}

// the 16 bytes of T at piece i of a tile (cols a multiple of 16 bytes' worth)
template <typename T>
__device__ __forceinline__ uint4 piece(const Tile<T>& t, int i) {
  constexpr int kVec = 16 / sizeof(T);
  const int cv = t.cols / kVec, r = i / cv;
  return __ldg(reinterpret_cast<const uint4*>(t.src + (long long)r * t.cols + (i - r * cv) * kVec));
}

template <typename T>
__device__ __forceinline__ void store_piece(const Tile<T>& t, int i, const uint4& raw) {
  constexpr int kVec = 16 / sizeof(T);
  const int cv = t.cols / kVec, r = i / cv, c = (i - r * cv) * kVec;
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec; j += 4)
    *reinterpret_cast<float4*>(t.dst + r * t.ld + c + j) =
        make_float4(prep<T>(to_f32(e[j]), t.log), prep<T>(to_f32(e[j + 1]), t.log),
                    prep<T>(to_f32(e[j + 2]), t.log), prep<T>(to_f32(e[j + 3]), t.log));
}

// A thread's first H 16-byte pieces of each tile (vec as below), loaded into
// registers ahead of their use...
template <typename T, int N, int H>
__device__ __forceinline__ void fetch(uint4 (&held)[N][H], const Tile<T> (&tl)[N], bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (!vec) return;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < tl[n].rows * tl[n].cols / kVec) held[n][j] = piece(tl[n], i);
    }
}

// ...and stored into their tiles with the rest of each, loaded now, and
// their padding.  vec: each tile's cols is a multiple of 16 bytes' worth of
// T and its src 16-byte aligned, so that a thread moves 16 bytes at a time;
// else one value, and nothing is held.
template <typename T, int N, int H>
__device__ __forceinline__ void land(const uint4 (&held)[N][H], const Tile<T> (&tl)[N], bool vec) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const Tile<T>& t = tl[n];
    if (vec) {
      const int pieces = t.rows * t.cols / kVec;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if (i < pieces) store_piece(t, i, held[n][j]);
      }
      for (int i = threadIdx.x + H * kThreads; i < pieces; i += kThreads)
        store_piece(t, i, piece(t, i));
    } else {
      for (int i = threadIdx.x; i < t.rows * t.cols; i += kThreads) {
        const int r = i / t.cols;
        t.dst[r * t.ld + i - r * t.cols] = prep<T>(to_f32(t.src[i]), t.log);
      }
    }
    zero_pad(t);
  }
}

// N tiles now, every tile's first loads in flight together
template <typename T, int N>
__device__ __forceinline__ void load_tiles(const Tile<T> (&tl)[N], bool vec) {
  uint4 held[N][2];
  fetch(held, tl, vec);
  land(held, tl, vec);
}

// the scalar mode's log-decays: column 0 of each step's Kw values, 0 on padding
template <typename T>
__device__ __forceinline__ void load_scalar_log_decay(float* L, const T* __restrict__ w, int C,
                                                      int Kw, int Cp) {
  for (int t = threadIdx.x; t < Cp; t += kThreads)
    L[t] = t < C ? prep<T>(to_f32(w[(long long)t * Kw]), true) : 0.f;
}

// x[t * ld + kk] *= f(t, kk) on [0, Cp) x [0, Kp): four rows a lane at a
// time, every load before any store, so that their latencies overlap
template <class F>
__device__ __forceinline__ void scale_rows(float* x, int ld, int Cp, int Kp, const F& f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t0 = warp; t0 < Cp; t0 += 4 * kWarps)
    for (int kk = lane; kk < Kp; kk += 32) {
      float r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = min(t0 + kWarps * u, Cp - 1);
        r[u] = x[t * ld + kk] * f(t, kk);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (t0 + kWarps * u < Cp) x[(t0 + kWarps * u) * ld + kk] = r[u];
    }
}

// L[t] = L[t - 1] + L[t] down each column c < ncols of rows [0, rows), rows a
// multiple of 16, in place over the log-decays; Lq[t] = L[t] - log w_t where
// Lq is given (the strict readout's exclusive sum, as the plain version forms
// it).  One thread a column, in the order of the plain version's sequential
// f32 scan, 16 steps from registers at a time.
__device__ __forceinline__ void cumsum_cols(float* L, float* Lq, int ld, int rows, int ncols) {
  for (int c = threadIdx.x; c < ncols; c += kThreads) {
    float acc = 0.f;
    for (int t0 = 0; t0 < rows; t0 += kSub) {
      float lg[kSub];
#pragma unroll
      for (int u = 0; u < kSub; ++u) lg[u] = L[(t0 + u) * ld + c];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        acc += lg[u];
        L[(t0 + u) * ld + c] = acc;
        if (Lq) Lq[(t0 + u) * ld + c] = acc - lg[u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// shared-memory layouts (host and device compute the same offsets)
// ---------------------------------------------------------------------------

struct Dims {
  int Cp, Kp, Vp, nsub, npairs;
  __host__ __device__ Dims(int C, int K, int V)
      : Cp(round16(C)), Kp(round16(K)), Vp(round16(V)), nsub(round16(C) / kSub),
        npairs(round16(C) / kSub * (round16(C) / kSub - 1) / 2) {}
};

// pass 1: k (then k^, the A operand read down its columns), v (B, row-major), L
struct StateLayout {
  int ldk, ldv, ldL, ok, ov, oL, total;
  __host__ __device__ StateLayout(const Dims& d, bool scalar) {
    ldk = d.Kp + 8;
    ldv = d.Vp + 8;
    ldL = scalar ? 1 : d.Kp + 4;
    ok = 0;
    ov = ok + d.Cp * ldk;
    oL = ov + d.Cp * ldv;
    total = oL + d.Cp * ldL;
  }
};

// pass 3: q (A, row-major), k (B as [s][k]), L, v (B, row-major; its region
// holds Lq first when that is a separate array), S (A, row-major), H_in (B,
// row-major), then the scalar mode's L and Lq columns, or the per-channel
// boundary decays e^{L_b} (nsub x Kp) and pair decays d_ij (npairs x Kp)
struct OutLayout {
  int ldq, ldk, ldL, ldv, ldS, ldH, oq, ok, oL, ov, oS, oH, oX, total;
  bool lq_in_v;
  __host__ __device__ OutLayout(const Dims& d, bool scalar, bool strict) {
    ldq = d.Kp + 4;
    ldk = d.Kp + 4;
    ldL = scalar ? 1 : d.Kp + 4;
    ldv = d.Vp + 8;
    ldS = d.Cp + 4;
    ldH = d.Vp + 8;
    lq_in_v = strict && !scalar;
    oq = 0;
    ok = oq + d.Cp * ldq;
    oL = ok + d.Cp * ldk;
    ov = oL + d.Cp * ldL;
    const int v_region = d.Cp * (lq_in_v && ldL > ldv ? ldL : ldv);
    oS = ov + v_region;
    oH = oS + d.Cp * ldS;
    oX = oH + d.Kp * ldH;
    total = oX + (scalar ? d.Cp : d.Kp * (d.nsub + d.npairs));
  }
};

// ---------------------------------------------------------------------------
// pass 1: chunk states
// ---------------------------------------------------------------------------

template <typename T, bool SCALAR>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ w,
                       float* __restrict__ st, float* __restrict__ dec, int S, int K, int V,
                       int C, int Kw, int nc, int vec) {
  constexpr int P = std::is_same<T, float>::value ? kF32 : kTF32;
  constexpr bool kExact = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  const Dims d(C, K, V);
  const StateLayout lay(d, SCALAR);
  float* ks = smem + lay.ok;
  float* vs = smem + lay.ov;
  float* Ls = smem + lay.oL;
  const int ldk = lay.ldk, ldv = lay.ldv, ldL = lay.ldL;

  const long long bh = blockIdx.x / nc;
  const int c = blockIdx.x - (int)(bh * nc);
  const long long row0 = bh * S + (long long)c * C;
  if constexpr (SCALAR) {
    const Tile<T> tl[2] = {{ks, ldk, k + row0 * K, C, K, d.Cp, d.Kp, false},
                           {vs, ldv, v + row0 * V, C, V, d.Cp, d.Vp, false}};
    load_tiles(tl, vec);
    load_scalar_log_decay(Ls, w + row0 * Kw, C, Kw, d.Cp);
  } else {
    const Tile<T> tl[3] = {{ks, ldk, k + row0 * K, C, K, d.Cp, d.Kp, false},
                           {vs, ldv, v + row0 * V, C, V, d.Cp, d.Vp, false},
                           {Ls, ldL, w + row0 * K, C, K, d.Cp, d.Kp, true}};
    load_tiles(tl, vec);
  }
  __syncthreads();
  cumsum_cols(Ls, nullptr, ldL, d.Cp, SCALAR ? 1 : K);
  __syncthreads();

  // k^ = k e^{L_C - L} in place (padded rows carry L_C, so L_C is row Cp - 1)
  const float* Lc = Ls + (d.Cp - 1) * ldL;
  scale_rows(ks, ldk, d.Cp, d.Kp, [&](int t, int kk) {
    const int kl = SCALAR ? 0 : kk;
    return ex<kExact>(Lc[kl] - Ls[t * ldL + kl]);
  });
  const int kd = SCALAR ? 1 : K;
  for (int kk = threadIdx.x; kk < kd; kk += kThreads)
    dec[(bh * nc + c) * kd + kk] = ex<kExact>(Lc[kk]);
  __syncthreads();

  // dH = k^T v: rows kk, columns vv, the reduction over the chunk's steps
  float* stb = st + (bh * nc + c) * (long long)K * V;
  auto A = [&](int kk, int t) { return ks[t * ldk + kk]; };
  auto B = [&](int t, int vv) { return vs[t * ldv + vv]; };
  auto steps = [&](int) { return d.Cp; };
  auto none = [](int) { return 0; };
  if (d.Vp % 32 == 0)
    products_to_global<P, 4>(stb, K, V, d.Kp / 16, d.Vp, A, B, steps, A, B, none);
  else
    products_to_global<P, 2>(stb, K, V, d.Kp / 16, d.Vp, A, B, steps, A, B, none);
}

// ---------------------------------------------------------------------------
// pass 2: the state pass, in place over the chunk states
// ---------------------------------------------------------------------------

template <bool SCALAR>
__global__ void __launch_bounds__(kStateThreads)
ssd_state_pass_kernel(float* __restrict__ st, const float* __restrict__ dec,
                      const float* __restrict__ h0, float* __restrict__ hT, int K, int V, int nc,
                      int tiles) {
  const long long bh = blockIdx.x / tiles;
  const int KV = K * V;
  const int e = (blockIdx.x - (int)(bh * tiles)) * kStateThreads + threadIdx.x;
  if (e >= KV) return;
  const int kd = SCALAR ? 1 : K;
  float h = h0 ? h0[bh * KV + e] : 0.f;
  float* sp = st + bh * nc * (long long)KV + e;
  const float* dp = dec + bh * nc * kd + (SCALAR ? 0 : e / V);
  constexpr int kU = 16;  // chunks whose loads are in flight together
  int c = 0;
  for (; c + kU <= nc; c += kU) {
    float x[kU], a[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      x[u] = sp[(long long)(c + u) * KV];
      a[u] = dp[(long long)(c + u) * kd];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      sp[(long long)(c + u) * KV] = h;
      h = fmaf(a[u], h, x[u]);
    }
  }
  for (; c < nc; ++c) {
    const float x = sp[(long long)c * KV], a = dp[(long long)c * kd];
    sp[(long long)c * KV] = h;
    h = fmaf(a, h, x);
  }
  if (hT) hT[bh * KV + e] = h;
}

// ---------------------------------------------------------------------------
// pass 3: chunk outputs
// ---------------------------------------------------------------------------

// S[t, s] with the per-pair exponent of every k, for this lane's column s
// and rows t0 + tstep u, u < NR; s > t (s >= t when strict) gives 0.
template <bool STRICT, bool EXACT, int NR>
__device__ __forceinline__ void pairwise_rows(float* Ss, int ldS, const float* qs, int ldq,
                                              const float* ks, int ldk, const float* Ls,
                                              const float* LQ, int ldL, int Kp, int s, int t0,
                                              int tstep) {
  float acc[NR] = {};
  const float* kr = ks + s * ldk;
  const float* lr = Ls + s * ldL;
#pragma unroll 2
  for (int kk = 0; kk < Kp; kk += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + kk);
    const float4 lv = *reinterpret_cast<const float4*>(lr + kk);
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      const int t = t0 + tstep * u;
      const float4 qv = *reinterpret_cast<const float4*>(qs + t * ldq + kk);
      const float4 lq = *reinterpret_cast<const float4*>(LQ + t * ldL + kk);
      acc[u] = fmaf(qv.x * kv.x, ex<EXACT>(fminf(lq.x - lv.x, 0.f)), acc[u]);
      acc[u] = fmaf(qv.y * kv.y, ex<EXACT>(fminf(lq.y - lv.y, 0.f)), acc[u]);
      acc[u] = fmaf(qv.z * kv.z, ex<EXACT>(fminf(lq.z - lv.z, 0.f)), acc[u]);
      acc[u] = fmaf(qv.w * kv.w, ex<EXACT>(fminf(lq.w - lv.w, 0.f)), acc[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < NR; ++u) {
    const int t = t0 + tstep * u;
    Ss[t * ldS + s] = (STRICT ? s < t : s <= t) ? acc[u] : 0.f;
  }
}

// S on half h of the block (i, j), j <= i: rows 16 i + 8 h + [0, 8), columns
// 16 j + [0, 16), one warp.  In the first half of a diagonal block only the
// first 8 columns can hold a term: they get the lanes (two rows each), the
// other 8 are 0; elsewhere a lane takes a column and four rows.
template <bool STRICT, bool EXACT>
__device__ __forceinline__ void pairwise_half(float* Ss, int ldS, const float* qs, int ldq,
                                              const float* ks, int ldk, const float* Ls,
                                              const float* LQ, int ldL, int Kp, int i, int j,
                                              int h) {
  const int lane = threadIdx.x & 31;
  if (i == j && h == 0) {
    const int s = 16 * j + (lane & 7), t0 = 16 * i + (lane >> 3);
    pairwise_rows<STRICT, EXACT, 2>(Ss, ldS, qs, ldq, ks, ldk, Ls, LQ, ldL, Kp, s, t0, 4);
    Ss[t0 * ldS + s + 8] = 0.f;
    Ss[(t0 + 4) * ldS + s + 8] = 0.f;
  } else {
    pairwise_rows<STRICT, EXACT, 4>(Ss, ldS, qs, ldq, ks, ldk, Ls, LQ, ldL, Kp,
                                    16 * j + (lane & 15), 16 * i + 8 * h + (lane >> 4), 2);
  }
}

// The scalar mode's S = (q k^T) e^{min(Lq_t - L_s, 0)} (0 above the
// diagonal, s > t or s >= t when strict) on each row tile's columns up to
// its diagonal: items of 16 rows and 8 NT columns, one a warp.
template <int P, int NT, bool STRICT, bool EXACT>
__device__ __forceinline__ void scalar_scores(float* Ss, int ldS, const float* qs, int ldq,
                                              const float* ks, int ldk, const float* Ls,
                                              const float* LQ, int nsub, int Kp) {
  constexpr int W = 8 * NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  auto A = [&](int t, int r) { return qs[t * ldq + r]; };
  auto B = [&](int r, int s) { return ks[s * ldk + r]; };
  auto groups = [](int i) { return (16 * i + 15) / W + 1; };  // row tile i's column groups
  int items = 0;
  for (int i = 0; i < nsub; ++i) items += groups(i);
  for (int it = warp; it < items; it += kWarps) {
    int i = 0, first = 0;
    while (first + groups(i) <= it) first += groups(i++);
    const int c0 = W * (it - first);
    float acc[NT][4] = {};
    mma_rows<P, NT>(acc, A, B, 16 * i, c0, Kp);
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * i + g + 8 * (e >> 1), s = c0 + 8 * ni + 2 * tq + (e & 1);
        const bool keep = STRICT ? s < t : s <= t;
        Ss[t * ldS + s] = keep ? acc[ni][e] * ex<EXACT>(fminf(LQ[t] - Ls[s], 0.f)) : 0.f;
      }
  }
}

// the pair (i, j), j < i, of sub-chunks numbered p = i (i - 1) / 2 + j
__device__ __forceinline__ void pair_of(int p, int& i, int& j) {
  i = 1;
  while ((i + 1) * i / 2 <= p) ++i;
  j = p - i * (i - 1) / 2;
}

template <typename T, bool STRICT, bool SCALAR>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_out_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ w, const float* __restrict__ st, T* __restrict__ y,
                     int S, int K, int V, int C, int Kw, int nc, int vec) {
  constexpr bool kExact = std::is_same<T, float>::value;
  constexpr int PS = kExact ? kF32 : kTF32;  // products with an f32 operand
  constexpr int PR = kExact ? kF32 : kBF16;  // q k^T of the scalar mode
  extern __shared__ __align__(16) float smem[];
  const Dims d(C, K, V);
  const OutLayout lay(d, SCALAR, STRICT);
  float* qs = smem + lay.oq;
  float* ks = smem + lay.ok;
  float* Ls = smem + lay.oL;
  float* vs = smem + lay.ov;
  float* Ss = smem + lay.oS;
  float* Hs = smem + lay.oH;
  float* X = smem + lay.oX;
  const int ldq = lay.ldq, ldk = lay.ldk, ldL = lay.ldL, ldv = lay.ldv, ldS = lay.ldS,
            ldH = lay.ldH;
  // Lq: L itself, or L - log w in the v region (v lands after its last use)
  // or, in the scalar mode, a column of its own
  float* LQ = !STRICT ? Ls : (SCALAR ? X : vs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the chunk's tiles: q, k, v (, log w), and H_in; every first load in
  // flight together, v's held in registers where its region holds Lq
  const long long chunk = blockIdx.x;
  const long long row0 = (chunk / nc) * S + (chunk % nc) * (long long)C;
  const Tile<T> tqk[2] = {{qs, ldq, q + row0 * K, C, K, d.Cp, d.Kp, false},
                          {ks, ldk, k + row0 * K, C, K, d.Cp, d.Kp, false}};
  const Tile<T> tv[1] = {{vs, ldv, v + row0 * V, C, V, d.Cp, d.Vp, false}};
  const Tile<T> tw[1] = {{Ls, ldL, w + row0 * Kw, C, K, d.Cp, d.Kp, true}};  // per channel
  // H_in: 16-byte copies that need no registers, waited for before the
  // products (where V % 4 == 0: the scratch is the wrapper's, aligned)
  const Tile<float> th[1] = {{Hs, ldH, st + chunk * (long long)K * V, K, V, d.Kp, d.Vp, false}};
  if ((V & 3) == 0) {
    for (int i = threadIdx.x; i < K * V / 4; i += kThreads) {
      const int r = i / (V / 4), c4 = (i - r * (V / 4)) * 4;
      cp_async16(Hs + r * ldH + c4, th[0].src + (long long)r * V + c4);
    }
    zero_pad(th[0]);
  } else {
    load_tiles(th, false);
  }
  uint4 held_qk[2][2], held_v[1][2], held_w[1][2];
  fetch(held_qk, tqk, vec);
  fetch(held_v, tv, vec);
  if constexpr (!SCALAR) fetch(held_w, tw, vec);
  if constexpr (SCALAR) load_scalar_log_decay(Ls, w + row0 * Kw, C, Kw, d.Cp);
  land(held_qk, tqk, vec);
  if constexpr (!SCALAR) land(held_w, tw, vec);
  if (!lay.lq_in_v) land(held_v, tv, vec);
  __syncthreads();
  cumsum_cols(Ls, STRICT ? LQ : nullptr, ldL, d.Cp, SCALAR ? 1 : K);
  __syncthreads();

  if constexpr (SCALAR) {
    if (d.Cp % 32 == 0)
      scalar_scores<PR, 4, STRICT, kExact>(Ss, ldS, qs, ldq, ks, ldk, Ls, LQ, d.nsub, d.Kp);
    else
      scalar_scores<PR, 2, STRICT, kExact>(Ss, ldS, qs, ldq, ks, ldk, Ls, LQ, d.nsub, d.Kp);
    __syncthreads();
    // q^ = q e^{Lq} in place
    scale_rows(qs, ldq, d.Cp, d.Kp, [&](int t, int) { return ex<kExact>(LQ[t]); });
  } else if constexpr (kExact) {
    // f32: every block (i, j <= i) with its per-pair exponents, as the plain version
    for (int it = warp; it < d.nsub * (d.nsub + 1); it += kWarps) {
      const int b = it >> 1;
      int i = 0;
      while ((i + 1) * (i + 2) / 2 <= b) ++i;
      pairwise_half<STRICT, true>(Ss, ldS, qs, ldq, ks, ldk, Ls, LQ, ldL, d.Kp, i,
                                  b - i * (i + 1) / 2, it & 1);
    }
    __syncthreads();
    scale_rows(qs, ldq, d.Cp, d.Kp, [&](int t, int kk) { return expf(LQ[t * ldL + kk]); });
  } else {
    // bf16, per channel: the diagonal blocks pairwise, the others factorized
    float* eB = X;                    // e^{L_b}: nsub x Kp
    float* dp = X + d.nsub * d.Kp;    // d_ij:    npairs x Kp
    for (int a = warp; a < d.nsub; a += kWarps)
      for (int kk = lane; kk < d.Kp; kk += 32)
        eB[a * d.Kp + kk] = a ? __expf(Ls[(16 * a - 1) * ldL + kk]) : 1.f;
    for (int p = warp; p < d.npairs; p += kWarps) {
      int a, b;
      pair_of(p, a, b);
      for (int kk = lane; kk < d.Kp; kk += 32)
        dp[p * d.Kp + kk] = __expf(Ls[(16 * a - 1) * ldL + kk] - Ls[(16 * b + 15) * ldL + kk]);
    }
    // block it % nsub, half it / nsub: the two halves of a block on warps w
    // and w + 4, which share a scheduler, so that each scheduler has one light
    // and one heavy half
    for (int it = warp; it < 2 * d.nsub; it += kWarps)
      pairwise_half<STRICT, false>(Ss, ldS, qs, ldq, ks, ldk, Ls, LQ, ldL, d.Kp, it % d.nsub,
                                   it % d.nsub, it / d.nsub);
    __syncthreads();
    // q~ = q e^{min(Lq - L_b, 0)} and k~ = k e^{L_e - L} in place (the clamp
    // takes Lq's rounding above L_b to 0, as the plain version's does)
    // (four rows a lane at a time, every load before any store)
    for (int t0 = warp; t0 < d.Cp; t0 += 4 * kWarps)
      for (int kk = lane; kk < d.Kp; kk += 32) {
        float fq[4], fk[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = min(t0 + kWarps * u, d.Cp - 1), a = t >> 4;
          const float lb = a ? Ls[(16 * a - 1) * ldL + kk] : 0.f;
          fq[u] = qs[t * ldq + kk] * __expf(fminf(LQ[t * ldL + kk] - lb, 0.f));
          fk[u] = ks[t * ldk + kk] * __expf(Ls[(16 * a + 15) * ldL + kk] - Ls[t * ldL + kk]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + kWarps * u;
          if (t < d.Cp) {
            qs[t * ldq + kk] = fq[u];
            ks[t * ldk + kk] = fk[u];
          }
        }
      }
    __syncthreads();
    // the blocks (i, j < i): (q~ * d_ij) k~^T, one a warp
    for (int p = warp; p < d.npairs; p += kWarps) {
      int i, j;
      pair_of(p, i, j);
      const float* dd = dp + p * d.Kp;
      auto A = [&](int t, int r) { return qs[t * ldq + r] * dd[r]; };
      auto B = [&](int r, int s) { return ks[s * ldk + r]; };
      float acc[2][4] = {};
      mma_rows<PS, 2>(acc, A, B, 16 * i, 16 * j, d.Kp);
      acc_to_smem<2>(Ss, ldS, acc, 16 * i, 16 * j);
    }
    __syncthreads();
    // q^ = q~ e^{L_b}
    scale_rows(qs, ldq, d.Cp, d.Kp, [&](int t, int kk) { return eB[(t >> 4) * d.Kp + kk]; });
  }
  if (lay.lq_in_v) {
    __syncthreads();  // the last reads of Lq are done
    land(held_v, tv, vec);
  }
  cp_async_wait_all();
  __syncthreads();

  // y = q^ . H_in + S . v (S . v of row tile mi over its first 16 (mi + 1) steps)
  T* yb = y + row0 * V;
  auto Aq = [&](int t, int r) { return qs[t * ldq + r]; };
  auto Bh = [&](int r, int vv) { return Hs[r * ldH + vv]; };
  auto As = [&](int t, int s) { return Ss[t * ldS + s]; };
  auto Bv = [&](int s, int vv) { return vs[s * ldv + vv]; };
  auto kq = [&](int) { return d.Kp; };
  auto ks_of = [](int mi) { return 16 * (mi + 1); };
  if (d.Vp % 32 == 0)
    products_to_global<PS, 4>(yb, C, V, d.nsub, d.Vp, Aq, Bh, kq, As, Bv, ks_of);
  else
    products_to_global<PS, 2>(yb, C, V, d.nsub, d.Vp, Aq, Bh, kq, As, Bv, ks_of);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <class Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, bool STRICT, bool SCALAR>
cudaError_t launch(int pass, const void* q, const void* k, const void* v, const void* w, void* y,
                   const void* h0, void* hT, void* scratch, int BH, int S, int K, int V, int C,
                   int Kw, int vec, cudaStream_t stream) {
  const int nc = S / C;
  const Dims d(C, K, V);
  float* st = static_cast<float*>(scratch);
  float* dec = st + (size_t)BH * nc * K * V;
  const unsigned blocks = (unsigned)((long long)BH * nc);
  cudaError_t err = cudaSuccess;
  if (pass == 0) {
    auto k1 = ssd_chunk_state_kernel<T, SCALAR>;
    const size_t s1 = sizeof(float) * (size_t)StateLayout(d, SCALAR).total;
    if ((err = allow_smem(k1, s1)) != cudaSuccess) return err;
    k1<<<blocks, kThreads, s1, stream>>>(static_cast<const T*>(k), static_cast<const T*>(v),
                                         static_cast<const T*>(w), st, dec, S, K, V, C, Kw, nc,
                                         vec);
  } else if (pass == 1) {
    const int tiles = (K * V + kStateThreads - 1) / kStateThreads;
    ssd_state_pass_kernel<SCALAR>
        <<<(unsigned)((long long)BH * tiles), kStateThreads, 0, stream>>>(
            st, dec, static_cast<const float*>(h0), static_cast<float*>(hT), K, V, nc, tiles);
  } else if (pass == 2) {
    auto k3 = ssd_chunk_out_kernel<T, STRICT, SCALAR>;
    const size_t s3 = sizeof(float) * (size_t)OutLayout(d, SCALAR, STRICT).total;
    if ((err = allow_smem(k3, s3)) != cudaSuccess) return err;
    k3<<<blocks, kThreads, s3, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<const T*>(w), st,
                                         static_cast<T*>(y), S, K, V, C, Kw, nc, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int pass, const void* q, const void* k, const void* v, const void* w, void* y,
                     const void* h0, void* hT, void* scratch, int BH, int S, int K, int V, int C,
                     int Kw, int strict, int scalar, cudaStream_t stream) {
  // 16-byte loads of q, k, v (and w per channel) where every chunk's rows allow them
  constexpr int kVec = 16 / sizeof(T);
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = K % kVec == 0 && V % kVec == 0 && aligned(q) && aligned(k) && aligned(v) &&
                  (scalar || aligned(w));
  if (strict && scalar)
    return launch<T, true, true>(pass, q, k, v, w, y, h0, hT, scratch, BH, S, K, V, C, Kw, vec,
                                 stream);
  if (strict)
    return launch<T, true, false>(pass, q, k, v, w, y, h0, hT, scratch, BH, S, K, V, C, Kw, vec,
                                  stream);
  if (scalar)
    return launch<T, false, true>(pass, q, k, v, w, y, h0, hT, scratch, BH, S, K, V, C, Kw, vec,
                                  stream);
  return launch<T, false, false>(pass, q, k, v, w, y, h0, hT, scratch, BH, S, K, V, C, Kw, vec,
                                 stream);
}

}  // namespace

// Pass ``pass`` of the scan (0: chunk states, 1: the state pass, 2: chunk
// outputs), one launch on ``stream``; a call of the scan is the three in
// order on the same arguments.  q, k (BH, S, K), w (BH, S, Kw) and v, y (BH,
// S, V), contiguous, of one dtype (0: f32, 1: bf16); Kw is K, or 1 with
// scalar; h0 and hT f32 (BH, K, V) or null; scratch f32, BH * (S / C) * (K *
// V + (scalar ? 1 : K)) values.  1 <= K, V <= 128, 1 <= C <= 64, S a multiple
// of C.  Returns cudaGetLastError().
extern "C" int rt_ssd_scan(int pass, const void* q, const void* k, const void* v, const void* w,
                           void* y, const void* h0, void* hT, void* scratch, int BH, int S, int K,
                           int V, int C, int Kw, int strict, int scalar, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(pass, q, k, v, w, y, h0, hT, scratch, BH, S, K, V, C, Kw,
                                   strict, scalar, st);
  return dispatch<float>(pass, q, k, v, w, y, h0, hT, scratch, BH, S, K, V, C, Kw, strict, scalar,
                         st);
}

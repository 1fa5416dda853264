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
// L (or, when strict, its exclusive sum), and every exponent is <= 0:
//
//   y_t   = (q_t * e^{Lq_t}) . H_in + sum_s S[t, s] v_s
//   S[t,s]= sum_k q_t[k] k_s[k] e^{min(Lq_t[k] - L_s[k], 0)}   (s <= t, or s < t)
//   H_out = diag(e^{L_C}) H_in + sum_t (k_t * e^{L_C - L_t}) v_t^T
//
// With scalar_decay the decay is the same in every channel, so the pairwise
// factor is one (C, C) matrix from column 0 of L, as the TPU kernel does; w
// may then be one column wide (one decay per step, Mamba-2's form), and only
// column 0 is loaded.
// Additions over the TPU kernel, both what the model path needs: an optional
// f32 initial state h0 (B, H, K, V) and an optional f32 final state hT.
//
// What bounds it on an H100: per-channel, the exps of the (C, C, K) pairwise
// decay (C(C+-1)/2 * K per chunk), which run on the SFUs at 16 a clock per
// SM; scalar, the bytes of q, k, v and y (w is one value a step).  The TPU kernel walks the chunks
// on a sequential grid axis with the state resident in VMEM; blocks run in no
// order here, so this first design gives each (b, h) one block that walks its
// chunks in a loop, with the state, the chunk's q, k, log-decay, v and the
// (C, C) scores in shared memory (K, V <= 128, C <= 64: at most 209 KB).
// Inputs are read once and y written once; the state never leaves the SM.
// It fills only B*H blocks (80 for rwkv6-3b at B 2, 128 for zamba2-1.2b) of
// 132 SMs: a parallel intra-chunk pass over (b, h, chunk) followed by a short
// sequential state pass is the next step.  Rows of q, k and the log-decay are
// padded by one float so that lanes reading one column of many rows do not
// share a bank.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

size_t smem_bytes(int C, int K, int V) {
  return sizeof(float) * (3 * (size_t)C * (K + 1) + (size_t)C * V + (size_t)K * V +
                          (size_t)C * C);
}

template <typename T, bool STRICT, bool SCALAR>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ w, T* __restrict__ y, const float* __restrict__ h0,
                float* __restrict__ hT, int S, int K, int V, int C, int Kw) {
  extern __shared__ float smem[];
  const int Kp = K + 1;
  float* qs = smem;          // C x Kp: q, then q * e^{Lq}
  float* ks = qs + C * Kp;   // C x Kp: k, then k * e^{L_C - L}
  float* Ls = ks + C * Kp;   // C x Kp: log w, then its within-chunk cumsum L
                             // (column 0 only when SCALAR)
  float* vs = Ls + C * Kp;   // C x V
  float* hs = vs + C * V;    // K x V: the carried state
  float* ss = hs + K * V;    // C x C: the intra-chunk scores

  const long long bh = blockIdx.x;
  const int tid = threadIdx.x;
  const T* qb = q + bh * S * K;
  const T* kb = k + bh * S * K;
  const T* wb = w + bh * S * Kw;  // Kw: K, or 1 when SCALAR
  const T* vb = v + bh * S * V;
  T* yb = y + bh * S * V;

  for (int i = tid; i < K * V; i += kThreads) hs[i] = h0 ? h0[bh * K * V + i] : 0.f;

  for (int c0 = 0; c0 < S; c0 += C) {
    // the chunk's inputs, upcast to f32
    const long long ok = (long long)c0 * K;
    for (int i = tid; i < C * K; i += kThreads) {
      const int t = i / K, kk = i - t * K;
      qs[t * Kp + kk] = to_f32(qb[ok + i]);
      ks[t * Kp + kk] = to_f32(kb[ok + i]);
      if (!SCALAR) Ls[t * Kp + kk] = logf(fmaxf(to_f32(wb[ok + i]), 1e-30f));
    }
    if (SCALAR)
      for (int t = tid; t < C; t += kThreads)
        Ls[t * Kp] = logf(fmaxf(to_f32(wb[(long long)(c0 + t) * Kw]), 1e-30f));
    const long long ov = (long long)c0 * V;
    for (int i = tid; i < C * V; i += kThreads) vs[i] = to_f32(vb[ov + i]);
    __syncthreads();

    // L: the within-chunk cumulative log-decay, one channel a thread
    for (int kk = tid; kk < (SCALAR ? 1 : K); kk += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += Ls[t * Kp + kk];
        Ls[t * Kp + kk] = acc;
      }
    }
    __syncthreads();

    // the pairwise decayed scores; under strict Lq_t = L_{t-1} (s < t, so t >= 1)
    for (int i = tid; i < C * C; i += kThreads) {
      const int t = i / C, s = i - t * C;
      float acc = 0.f;
      if (STRICT ? s < t : s <= t) {
        const float* qt = qs + t * Kp;
        const float* kr = ks + s * Kp;
        const float* ls = Ls + s * Kp;
        const float* lq = Ls + (STRICT ? t - 1 : t) * Kp;
        if (SCALAR) {
          for (int kk = 0; kk < K; ++kk) acc = fmaf(qt[kk], kr[kk], acc);
          acc *= __expf(fminf(lq[0] - ls[0], 0.f));
        } else {
          for (int kk = 0; kk < K; ++kk)
            acc = fmaf(qt[kk] * kr[kk], __expf(fminf(lq[kk] - ls[kk], 0.f)), acc);
        }
      }
      ss[i] = acc;
    }
    __syncthreads();

    // fold the decays into q (to the chunk start) and k (to the chunk end)
    const float* Lc = Ls + (C - 1) * Kp;
    for (int i = tid; i < C * K; i += kThreads) {
      const int t = i / K, kk = i - t * K, kl = SCALAR ? 0 : kk;
      const float l = Ls[t * Kp + kl];
      const float lq = STRICT ? (t > 0 ? Ls[(t - 1) * Kp + kl] : 0.f) : l;
      qs[t * Kp + kk] *= __expf(lq);
      ks[t * Kp + kk] *= __expf(Lc[kl] - l);
    }
    __syncthreads();

    // readout: the carried state, then the intra-chunk term
    for (int i = tid; i < C * V; i += kThreads) {
      const int t = i / V, vv = i - t * V;
      const float* qt = qs + t * Kp;
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) acc = fmaf(qt[kk], hs[kk * V + vv], acc);
      const float* st = ss + t * C;
      const int send = STRICT ? t : t + 1;
      for (int s = 0; s < send; ++s) acc = fmaf(st[s], vs[s * V + vv], acc);
      yb[ov + i] = from_f32<T>(acc);
    }
    __syncthreads();

    // the state update
    for (int i = tid; i < K * V; i += kThreads) {
      const int kk = i / V, vv = i - kk * V;
      float acc = hs[i] * __expf(Lc[SCALAR ? 0 : kk]);
      for (int t = 0; t < C; ++t) acc = fmaf(ks[t * Kp + kk], vs[t * V + vv], acc);
      hs[i] = acc;
    }
    __syncthreads();
  }

  if (hT)
    for (int i = tid; i < K * V; i += kThreads) hT[bh * K * V + i] = hs[i];
}

template <typename T, bool STRICT, bool SCALAR>
cudaError_t launch(const void* q, const void* k, const void* v, const void* w, void* y,
                   const void* h0, void* hT, int BH, int S, int K, int V, int C, int Kw,
                   cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T, STRICT, SCALAR>;
  const size_t smem = smem_bytes(C, K, V);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<T*>(y), static_cast<const float*>(h0),
      static_cast<float*>(hT), S, K, V, C, Kw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* w, void* y,
                     const void* h0, void* hT, int BH, int S, int K, int V, int C, int Kw,
                     int strict, int scalar, cudaStream_t stream) {
  if (strict && scalar)
    return launch<T, true, true>(q, k, v, w, y, h0, hT, BH, S, K, V, C, Kw, stream);
  if (strict) return launch<T, true, false>(q, k, v, w, y, h0, hT, BH, S, K, V, C, Kw, stream);
  if (scalar) return launch<T, false, true>(q, k, v, w, y, h0, hT, BH, S, K, V, C, Kw, stream);
  return launch<T, false, false>(q, k, v, w, y, h0, hT, BH, S, K, V, C, Kw, stream);
}

}  // namespace

// q, k (BH, S, K), w (BH, S, Kw) and v, y (BH, S, V), contiguous, of one
// dtype (0: f32, 1: bf16); Kw is K, or 1 with scalar; h0 and hT f32 (BH, K,
// V) or null.  1 <= K, V <= 128, 1 <= C <= 64,
// S a multiple of C.  Launches on ``stream``; returns cudaGetLastError().
extern "C" int rt_ssd_scan(const void* q, const void* k, const void* v, const void* w, void* y,
                           const void* h0, void* hT, int BH, int S, int K, int V, int C,
                           int Kw, int strict, int scalar, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, w, y, h0, hT, BH, S, K, V, C, Kw, strict, scalar, st);
  return dispatch<float>(q, k, v, w, y, h0, hT, BH, S, K, V, C, Kw, strict, scalar, st);
}

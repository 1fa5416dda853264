// One BFS level for S source frontiers at once: the traversal hot loop.
//
// Replaces the Pallas kernel repro/kernels/frontier/kernel.py::frontier_expand
// (body _expand_kernel): out[s, d] = min src[e] over edges e with dst[e] == d
// and frontier[s, src[e]] set, NBR_INF where there is none.  The caller
// pre-fills out with NBR_INF.
//
// What bounds it on an H100: bytes.  Every edge's (src, dst) pair is read for
// every source row and the frontier is gathered at src; the S x C output is
// written by the fill.  The TPU kernel kept a frontier tile and an output
// block in VMEM and padded C to 128 lanes; neither has a purpose here.  One
// thread per (source row, edge) with the edge index fastest, so the src/dst
// reads coalesce and repeat from L2 across rows, and only edges whose source
// is on the frontier do an atomicMin into the output.  Min is commutative and
// associative, so the result does not depend on the order the atomics land.

#include "common.cuh"

namespace {

__global__ void frontier_expand_kernel(const uint8_t* __restrict__ frontier, int n_src,
                                       long long c, const int* __restrict__ src,
                                       const int* __restrict__ dst, long long n_edges,
                                       int* __restrict__ out) {
  const long long total = static_cast<long long>(n_src) * n_edges;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long s = idx / n_edges;
    const long long e = idx - s * n_edges;
    const int u = __ldg(src + e);
    if (frontier[s * c + u]) atomicMin(out + s * c + __ldg(dst + e), u);
  }
}

}  // namespace

extern "C" int rt_frontier_expand(const void* frontier, int n_src, long long c,
                                  const void* src, const void* dst, long long n_edges,
                                  void* out, void* stream) {
  constexpr int kBlock = 256;
  const long long total = static_cast<long long>(n_src) * n_edges;
  if (total > 0) {
    long long grid = (total + kBlock - 1) / kBlock;
    if (grid > 132LL * 32) grid = 132LL * 32;  // grid-stride: 32 blocks per SM
    frontier_expand_kernel<<<static_cast<int>(grid), kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(frontier), n_src, c, static_cast<const int*>(src),
        static_cast<const int*>(dst), n_edges, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

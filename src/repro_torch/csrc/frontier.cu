// One BFS level for S source frontiers at once: the traversal hot loop.
//
// Replaces the Pallas kernel repro/kernels/frontier/kernel.py::frontier_expand
// (body _expand_kernel): out[s, d] = min src[e] over edges e with dst[e] == d
// and frontier[s, src[e]] set, NBR_INF where there is none.
//
// What bounds it on an H100: bytes.  The function must read the S x C
// frontier bytes and the Ce (src, dst) pairs once and write the S x C int32
// output once.  The TPU kernel kept a frontier tile and an output block in
// VMEM and streamed the edges past every tile of source rows; neither has a
// purpose here.  Read once a source row, the edges alone would be S x 8 Ce
// bytes (1 GB at S 16 and Ce 2^23, 16 GB at S 256), each row's from device
// memory again, since 64 MB of edges do not stay in the 50 MB L2.  So a call
// is two launches that read each edge once:
//
// 1. pack and fill: a block takes 32 source rows of 1,024 columns, brings
//    each row's bytes into shared memory by 16-byte loads (C is odd at the
//    main path's 2^23 + 1, so a row starts anywhere: the loads start at the
//    16-byte boundary below it), and each thread gathers its column down the
//    rows into one word bits[w, u] of W = ceil(S / 32), one bit a source row.
//    The same blocks write NBR_INF over the whole output, flat (rows do not
//    start on 16 bytes either), 16 bytes a store.  (Byte loads down a column
//    move only 32 bytes a warp a load: too few in flight for the card's
//    rate.)
// 2. expand: one thread an edge reads (src[e], dst[e]) once, the W words of
//    its source column, and does one atomicMin(out[s, dst[e]], src[e]) for
//    every set bit s.  The CSR sorts src, so the word gathers coalesce; the
//    result does not depend on that order, nor on the order the atomics land
//    (min is commutative and associative).
//
// The bytes are S C + 4 S C + 8 W C + 8 Ce, plus one atomic a set bit of an
// edge's source; every output and word offset is 64-bit (S C reaches 2^31 at
// S 256).

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // expand: grid-stride, 16 blocks an SM
constexpr int kPackCols = 1024;               // pack: columns a block, one a thread
constexpr int kPackPitch = kPackCols + 16;    // a row's bytes in shared memory
constexpr int kPackVecs = kPackPitch / 16;

// Block (tile, w) packs rows 32 w .. 32 w + 31 of columns [tile * 1024, +1024)
// into one word a column.  Each row's bytes come in as 16-byte loads from the
// 16-byte boundary at or below the row's first byte (rows start anywhere:
// C is odd), into shared memory; a thread then gathers its column's bytes
// down the rows.  The block also writes NBR_INF over its share of the flat
// output, 16 bytes a store.
__global__ void __launch_bounds__(kPackCols)
frontier_pack_kernel(const uint8_t* __restrict__ frontier, int n_src, long long c, int n_words,
                     uint32_t* __restrict__ bits, int* __restrict__ out) {
  __shared__ __align__(16) uint8_t tile[32 * kPackPitch];
  const int w = static_cast<int>(blockIdx.x % n_words);
  const long long u0 = static_cast<long long>(blockIdx.x / n_words) * kPackCols;
  const int s0 = w * 32;
  const int rows = min(32, n_src - s0);
  const long long n_bytes = static_cast<long long>(n_src) * c;
  const uintptr_t base = reinterpret_cast<uintptr_t>(frontier);
  for (int k = threadIdx.x; k < rows * kPackVecs; k += blockDim.x) {
    const int row = k / kPackVecs;
    const long long first = (s0 + row) * c + u0;  // the row's first byte of the tile
    const long long a = static_cast<long long>(((base + first) & ~uintptr_t{15}) - base) +
                        16LL * (k - row * kPackVecs);
    uint4 v;
    if (a >= 0 && a + 16 <= n_bytes) {
      v = *reinterpret_cast<const uint4*>(frontier + a);
    } else {  // the array's ragged ends, byte by byte
      union {
        uint4 v;
        uint8_t b[16];
      } edge;
#pragma unroll
      for (int x = 0; x < 16; ++x)
        edge.b[x] = a + x >= 0 && a + x < n_bytes ? frontier[a + x] : 0;
      v = edge.v;
    }
    *reinterpret_cast<uint4*>(tile + row * kPackPitch + 16 * (k - row * kPackVecs)) = v;
  }

  // NBR_INF over this block's share of the flat output: scalars up to a
  // 16-byte address (block 0), int4 stores, the last few scalars (block 0)
  const long long n_out = static_cast<long long>(n_src) * c;
  const long long head =
      min(n_out, static_cast<long long>(((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / 4));
  const long long n_vec = (n_out - head) / 4;
  const long long per_block = (n_vec + gridDim.x - 1) / gridDim.x;
  const long long v0 = blockIdx.x * per_block;
  const long long v1 = min(n_vec, v0 + per_block);
  const int4 inf4 = make_int4(rt::kInt32Max, rt::kInt32Max, rt::kInt32Max, rt::kInt32Max);
  int4* out4 = reinterpret_cast<int4*>(out + head);
  for (long long k = v0 + threadIdx.x; k < v1; k += blockDim.x) out4[k] = inf4;
  if (blockIdx.x == 0 && threadIdx.x < head) out[threadIdx.x] = rt::kInt32Max;
  if (blockIdx.x == 0 && head + 4 * n_vec + threadIdx.x < n_out)
    out[head + 4 * n_vec + threadIdx.x] = rt::kInt32Max;  // fewer than 4
  __syncthreads();

  const long long u = u0 + threadIdx.x;
  if (u < c) {
    uint32_t word = 0;
    for (int row = 0; row < rows; ++row) {
      const int shift = static_cast<int>((base + (s0 + row) * c + u0) & 15);
      word |= static_cast<uint32_t>(tile[row * kPackPitch + shift + threadIdx.x] != 0) << row;
    }
    bits[w * c + u] = word;
  }
}

__global__ void __launch_bounds__(kBlock)
frontier_expand_kernel(const uint32_t* __restrict__ bits, int n_words, long long c,
                       const int* __restrict__ src, const int* __restrict__ dst,
                       long long n_edges, int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n_edges;
       e += stride) {
    const int u = __ldg(src + e);
    int v = -1;  // read only where a bit is set
    for (int w = 0; w < n_words; ++w) {
      uint32_t b = __ldg(bits + w * c + u);
      if (b && v < 0) v = __ldg(dst + e);
      while (b) {
        const long long s = w * 32 + __ffs(b) - 1;
        b &= b - 1;
        atomicMin(out + s * c + v, u);
      }
    }
  }
}

long long grid_of(long long n) {
  const long long g = (n + kBlock - 1) / kBlock;
  return g < 1 ? 1 : (g > kMaxBlocks ? kMaxBlocks : g);
}

}  // namespace

// pass 0: pack and fill; pass 1: expand.  bits holds ceil(S / 32) x C words.
extern "C" int rt_frontier_expand(int pass, const void* frontier, int n_src, long long c,
                                  const void* src, const void* dst, long long n_edges, void* bits,
                                  void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_words = (n_src + 31) / 32;
  if (pass == 0) {
    const long long blocks = (c + kPackCols - 1) / kPackCols * n_words;
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    frontier_pack_kernel<<<static_cast<unsigned>(blocks), kPackCols, 0, st>>>(
        static_cast<const uint8_t*>(frontier), n_src, c, n_words, static_cast<uint32_t*>(bits),
        static_cast<int*>(out));
  } else {
    frontier_expand_kernel<<<static_cast<int>(grid_of(n_edges)), kBlock, 0, st>>>(
        static_cast<const uint32_t*>(bits), n_words, c, static_cast<const int*>(src),
        static_cast<const int*>(dst), n_edges, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

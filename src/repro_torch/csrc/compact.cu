// State-maintenance compaction primitives: masked_compact and probe_place.
//
// masked_compact replaces repro/kernels/compact/kernel.py::masked_compact
// (body _compact_kernel): a stable stream compaction of R int32 rows by one
// bool mask.  Survivors go first in lane order, the tail is `fill`, and the
// count is written.  The TPU kernel ran its grid in order and carried a
// running offset from one block to the next; blocks on this card run in no
// order, so one launch does it with a decoupled look-back.  Each block takes
// the next tile of 4,096 lanes from an atomic counter (so a tile's
// predecessors were all taken by blocks already running: forward progress
// whatever order the blocks run in), reads its mask once, ranks its
// survivors with warp ballots and a scan over the (iteration, warp) groups,
// and publishes its survivor count in its status word (flag and value in
// one 64-bit word).  One warp then walks back over the predecessors' status
// words, 32 at a time, adding aggregates until it meets an inclusive
// prefix, and publishes its own.  No pre-fill: the tail [count, N) has
// exactly one slot per non-survivor, and the non-survivor of rank r among
// non-survivors (the tile's start minus its survivor prefix, plus its rank
// in the tile) writes `fill` at N - 1 - r, so every output element is
// written exactly once.  Survivors are staged in shared memory and written
// out contiguously, row by row; the last tile writes the count.  Bounded by
// bytes: the mask read once, each value read and written once.

// probe_place replaces repro/kernels/compact/kernel.py::probe_place (body
// _place_kernel, which runs compact/ref.py::probe_place_rounds): claim-round
// placement of pre-hashed keys into an empty table.  One round is three
// launches driven by a host loop: (A) every pending lane finds the first
// unoccupied slot on its chain and does atomicMin(claim[slot], lane);
// (B) the lane that holds its slot's minimum occupies it; (C) the claim words
// of the touched slots are reset.  The atomic minimum makes the winner the
// lowest lane whatever the order threads run in, so the table layout is the
// reference's exactly (a first-come CAS would not be).  Two device counters
// (lanes with a candidate, lanes still pending) are read by the host once
// per round to apply the reference's stop conditions.  Bounded by the
// dependent gathers into the occupancy bytes (4 MB at 2^22 slots, resident in
// L2) and by the number of rounds, each a host round trip.

#include "common.cuh"

namespace {

constexpr int kCompactThreads = 512;
constexpr int kCompactIters = 8;  // lanes a thread
constexpr int kCompactTile = kCompactThreads * kCompactIters;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr unsigned long long kAggregate = 1ull << 32;  // status: the tile's own count
constexpr unsigned long long kPrefix = 2ull << 32;     // status: survivors up to its end

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(p) = w;
}

// Thread t of the block holds lanes tile0 + j * 512 + t (j < 8), so every
// mask and value read is coalesced along the lane.
__global__ void __launch_bounds__(kCompactThreads)
masked_compact_kernel(const int* __restrict__ values, const uint8_t* __restrict__ mask, int rows,
                      long long n, int fill, int* __restrict__ out, int* __restrict__ count,
                      unsigned long long* __restrict__ status, int* __restrict__ next_tile,
                      int ntiles) {
  __shared__ int s_group[kCompactIters * kCompactWarps];  // survivors a group, then its offset
  __shared__ int s_tile, s_prefix, s_agg;
  __shared__ int s_buf[kCompactTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(next_tile, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long tile0 = static_cast<long long>(tile) * kCompactTile;

  unsigned keep = 0;
  int rank[kCompactIters];  // rank inside the (iteration, warp) group
  int v[kCompactIters];     // row 0's values, loaded while the look-back runs
#pragma unroll
  for (int j = 0; j < kCompactIters; ++j) {
    const long long i = tile0 + j * kCompactThreads + threadIdx.x;
    const bool k = i < n && mask[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, k);
    if (lane == 0) s_group[j * kCompactWarps + warp] = __popc(ballot);
    rank[j] = __popc(ballot & ((1u << lane) - 1u));
    keep |= static_cast<unsigned>(k) << j;
    v[j] = k ? values[i] : 0;
  }
  __syncthreads();

  if (warp == 0) {
    // exclusive scan of the 128 group counts, 4 a lane, in lane order
    int c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = s_group[lane * 4 + e];
    const int sum = c[0] + c[1] + c[2] + c[3];
    const int inc = warp_inclusive_scan(sum);
    int off = inc - sum;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s_group[lane * 4 + e] = off;
      off += c[e];
    }
    const int agg = __shfl_sync(0xffffffffu, inc, 31);

    // decoupled look-back over the predecessors' status words
    int excl = 0;
    if (lane == 0) store_status(status + tile, (tile == 0 ? kPrefix : kAggregate) | static_cast<unsigned>(agg));
    if (tile > 0) {
      for (int p = tile - 1;; p -= 32) {
        const int idx = p - lane;
        unsigned long long w = kPrefix;  // before tile 0: a prefix of 0
        if (idx >= 0) {
          do {
            w = load_status(status + idx);
          } while ((w >> 32) == 0);
        }
        const int val = static_cast<int>(static_cast<unsigned>(w));
        const unsigned done = __ballot_sync(0xffffffffu, (w >> 32) == 2);
        if (done) {  // the nearest inclusive prefix ends the walk
          excl += warp_sum(lane <= __ffs(done) - 1 ? val : 0);
          break;
        }
        excl += warp_sum(val);
      }
      if (lane == 0) store_status(status + tile, kPrefix | static_cast<unsigned>(excl + agg));
    }
    if (lane == 0) {
      s_prefix = excl;
      s_agg = agg;
      if (tile == ntiles - 1) *count = excl + agg;
    }
  }
  __syncthreads();

  const int prefix = s_prefix;
  const int agg = s_agg;
  const int valid = static_cast<int>(min(static_cast<long long>(kCompactTile), n - tile0));
  const int dropped = valid - agg;
  // slot of this tile's first non-survivor: N - 1 - (non-survivors before it)
  const long long fill_top = n - 1 - (tile0 - prefix);
  for (int r = 0; r < rows; ++r) {
    const int* vrow = values + r * n;
    int* orow = out + r * n;
#pragma unroll
    for (int j = 0; j < kCompactIters; ++j) {
      if ((keep >> j) & 1u) {
        const int x = r == 0 ? v[j] : vrow[tile0 + j * kCompactThreads + threadIdx.x];
        s_buf[s_group[j * kCompactWarps + warp] + rank[j]] = x;
      }
    }
    __syncthreads();
    for (int x = threadIdx.x; x < agg; x += kCompactThreads) orow[prefix + x] = s_buf[x];
    for (int x = threadIdx.x; x < dropped; x += kCompactThreads) orow[fill_top - x] = fill;
    __syncthreads();
  }
}

// probe_place round, launch A: first free slot on the chain, claim it
__global__ void place_claim_kernel(const int* __restrict__ home, int m, int cap,
                                   int max_probes, const uint8_t* __restrict__ pending,
                                   const uint8_t* __restrict__ occ, int* __restrict__ claim,
                                   int* __restrict__ cand, int* __restrict__ counters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int has = 0;
  if (i < m) {
    int c = -1;
    if (pending[i]) {
      const int h = home[i];
      for (int step = 0; step < max_probes; ++step) {
        const int s = rt::probe_slot(h, step, cap);
        if (!occ[s]) { c = s; break; }
      }
      if (c >= 0) {
        atomicMin(claim + c, i);
        has = 1;
      }
    }
    cand[i] = c;
  }
  const int n_has = __syncthreads_count(has);
  if (threadIdx.x == 0 && n_has) atomicAdd(counters, n_has);
}

// launch B: winners occupy their slot; count lanes still pending
__global__ void place_settle_kernel(int m, uint8_t* __restrict__ pending,
                                    uint8_t* __restrict__ occ, const int* __restrict__ claim,
                                    const int* __restrict__ cand, int* __restrict__ slots,
                                    int* __restrict__ counters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int still = 0;
  if (i < m && pending[i]) {
    const int c = cand[i];
    if (c >= 0 && claim[c] == i) {
      occ[c] = 1;
      slots[i] = c;
      pending[i] = 0;
    } else {
      still = 1;
    }
  }
  const int n_still = __syncthreads_count(still);
  if (threadIdx.x == 0 && n_still) atomicAdd(counters + 1, n_still);
}

// launch C: reset the claim words this round touched
__global__ void place_reset_kernel(int m, const int* __restrict__ cand,
                                   int* __restrict__ claim) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) {
    const int c = cand[i];
    if (c >= 0) claim[c] = rt::kInt32Max;
  }
}

}  // namespace

// scratch: ntiles + 1 64-bit words, zeroed here: the tile counter (as an
// int, in word 0) and one status word a tile
extern "C" int rt_masked_compact(const void* values, const void* mask, int rows, long long n,
                                 int fill, void* out, void* count, void* scratch, int ntiles,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(words, 0, (ntiles + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_compact_kernel<<<ntiles, kCompactThreads, 0, st>>>(
      static_cast<const int*>(values), static_cast<const uint8_t*>(mask), rows, n, fill,
      static_cast<int*>(out), static_cast<int*>(count), words + 1, reinterpret_cast<int*>(words),
      ntiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_probe_place_round(const void* home, int m, int cap, int max_probes,
                                    void* pending, void* occ, void* claim, void* cand,
                                    void* slots, void* counters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kPlaceBlock = 256;
  const int grid = rt::grid_for(m, kPlaceBlock);
  int* ctr = static_cast<int*>(counters);
  cudaMemsetAsync(ctr, 0, 2 * sizeof(int), st);
  place_claim_kernel<<<grid, kPlaceBlock, 0, st>>>(
      static_cast<const int*>(home), m, cap, max_probes,
      static_cast<const uint8_t*>(pending), static_cast<const uint8_t*>(occ),
      static_cast<int*>(claim), static_cast<int*>(cand), ctr);
  place_settle_kernel<<<grid, kPlaceBlock, 0, st>>>(
      m, static_cast<uint8_t*>(pending), static_cast<uint8_t*>(occ),
      static_cast<const int*>(claim), static_cast<const int*>(cand),
      static_cast<int*>(slots), ctr);
  place_reset_kernel<<<grid, kPlaceBlock, 0, st>>>(
      m, static_cast<const int*>(cand), static_cast<int*>(claim));
  return static_cast<int>(cudaGetLastError());
}

// State-maintenance compaction primitives: masked_compact and probe_place.
//
// masked_compact replaces repro/kernels/compact/kernel.py::masked_compact
// (body _compact_kernel): a stable stream compaction of R int32 rows by one
// bool mask.  Survivors go first in lane order; the caller pre-fills the tail
// with `fill`.  The TPU kernel ran its grid in order and carried a running
// offset from one block to the next; blocks on this card run in no order, so
// the offset becomes three passes: (1) each block counts its mask, (2) one
// block scans the block counts and writes the total, (3) each block ranks its
// survivors with a warp ballot/popc and a shared-memory scan over its warps,
// adds its block offset and scatters all R rows.  No atomic-counter append:
// positions come from the scan, so the order is the lane order.  Bounded by
// bytes: each mask byte is read twice and each value read and written once;
// the reads of pass 3 and all writes are coalesced along the lane.
//
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

constexpr int kBlock = 1024;

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Exclusive scan of one int per thread over the block; s_warp holds 33 ints.
// Returns the thread's exclusive prefix and writes the block total to *total.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int inc = warp_inclusive_scan(v);
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? s_warp[lane] : 0;
    const int winc = warp_inclusive_scan(w);
    if (lane < nwarps) s_warp[lane] = winc - w;
    if (lane == 31) s_warp[32] = winc;
  }
  __syncthreads();
  *total = s_warp[32];
  return s_warp[warp] + inc - v;
}

// pass 1: survivors per block
__global__ void compact_count_kernel(const uint8_t* __restrict__ mask, long long n,
                                     int* __restrict__ block_counts) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int keep = (i < n) && mask[i];
  const int c = __syncthreads_count(keep);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

// pass 2: one block turns block counts into block offsets, writes the total
__global__ void compact_scan_kernel(int* __restrict__ block_counts, int nblocks,
                                    int* __restrict__ count) {
  __shared__ int s_warp[33];
  const int per = (nblocks + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, nblocks);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += block_counts[j];
  int total;
  int off = block_exclusive_scan(sum, s_warp, &total);
  for (int j = lo; j < hi; ++j) {
    const int c = block_counts[j];
    block_counts[j] = off;
    off += c;
  }
  if (threadIdx.x == 0) *count = total;
}

// pass 3: rank survivors inside the block and scatter every row
__global__ void compact_scatter_kernel(const int* __restrict__ values,
                                       const uint8_t* __restrict__ mask, int rows,
                                       long long n, const int* __restrict__ block_offsets,
                                       int* __restrict__ out) {
  __shared__ int s_warp[33];
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool keep = (i < n) && mask[i];
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  const int lane_rank = __popc(ballot & ((1u << lane) - 1u));
  int total;
  // only lane 0 of each warp contributes the warp's count to the block scan
  const int warp_off = block_exclusive_scan(lane == 0 ? __popc(ballot) : 0, s_warp, &total);
  const int warp_base = __shfl_sync(0xffffffffu, warp_off, 0);
  if (keep) {
    const long long pos = static_cast<long long>(block_offsets[blockIdx.x]) + warp_base + lane_rank;
    for (int r = 0; r < rows; ++r) out[r * n + pos] = values[r * n + i];
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

extern "C" int rt_masked_compact(const void* values, const void* mask, int rows,
                                 long long n, void* out, void* count,
                                 void* block_counts, int nblocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* bc = static_cast<int*>(block_counts);
  compact_count_kernel<<<nblocks, kBlock, 0, st>>>(m, n, bc);
  compact_scan_kernel<<<1, kBlock, 0, st>>>(bc, nblocks, static_cast<int*>(count));
  compact_scatter_kernel<<<nblocks, kBlock, 0, st>>>(
      static_cast<const int*>(values), m, rows, n, bc, static_cast<int*>(out));
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

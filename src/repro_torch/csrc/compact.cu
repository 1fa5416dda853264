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
// placement of pre-hashed keys into an empty table.  In a round every
// pending lane finds the first free slot on its chain and claims it with an
// atomic minimum; the lowest claimant of a slot wins it, whatever the order
// threads run in, so the table layout is the reference's exactly (a
// first-come CAS would not be).  What bounds it on an H100: not bytes (the
// lanes, 9 bytes each, are a few microseconds) but the random claim words
// in L2 (an atomic, a read and a write a lane, at a few tens of G a second)
// and the dependency of each round on the whole previous round.  As three
// launches a round and a host read of two counters to apply the stop rule,
// a call followed the host (0.31-0.49 ms for 3-5 rounds).  So a call is one
// cooperative launch of the resident blocks, after one memset of its
// control words.  The blocks fill the claim words, make round 0's claims,
// then each phase settles one round and makes the next round's claims for
// its losers, ended by a grid barrier (a counter that the cooperative launch
// makes safe: every block is resident; a wait that outlasts about a second
// traps instead of hanging), after which every block reads the same totals
// (lanes with a candidate, lanes still pending) and applies the reference's
// stop rule.  One barrier a round suffices because the claim words are
// never reset and carry the occupancy: the lowest claimant of a slot always
// wins and occupies it, so a word written in an earlier round marks its
// slot taken.  A word holds its lane and a two-bit tag: the parity of the
// round that claimed it, or "taken" once its winner has settled (before
// the same parity comes round again); probes of round r + 1 see round r's
// parity or "taken" as taken and their own parity as free.  Round 0 finds
// every slot free and claims its home slot without a read.  Round 0's lanes
// go to the blocks in chunks, in turn; each block keeps its own losers as
// the next round's worklist, so later rounds touch only them, and once few
// are pending one block runs the remaining rounds alone.  The kernel writes
// the overflow flag and adds its rounds to a counter that the caller keeps
// across calls.

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

// probe_place.  Control words (kCtlBytes), zeroed by the host before each
// launch: the barrier's arrivals (64-bit); three (lanes with a candidate,
// lanes still pending) pairs that the phases use in turn (a phase adds to
// its pair and every block reads it after the phase's barrier; block 0
// clears the pair of the phase after next); then each block's count of
// lanes still pending.
constexpr int kPlaceThreads = 1024;
constexpr int kPlaceIlp = 4;         // lanes a thread has in flight
constexpr int kTailLanes = 2048;     // pending lanes that one block takes on alone
constexpr int kCtlPairs = 2;         // in 32-bit words, after the 64-bit arrival count
constexpr int kCtlLost = 8;
constexpr int kCtlBytes = 4096;
constexpr int kMaxPlaceBlocks = kCtlBytes / 4 - kCtlLost;
constexpr unsigned kNoClaim = ~0u;      // a claim word no lane has written
constexpr unsigned kTaken = 2u << 30;  // tag of a slot whose winner has settled
constexpr unsigned kMaxSpins = 1u << 22;  // ~1-2 s of polling: a barrier that never ends traps

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A grid-wide barrier, valid only under a cooperative launch (every block
// resident): the k-th barrier of a launch waits for k x gridDim.x arrivals.
// Thread 0's release add and acquire loads carry the block's writes across,
// ordered with the other threads by the block barriers around them.
__device__ __forceinline__ void grid_barrier(unsigned long long* arrive,
                                             unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" : : "l"(arrive) : "memory");
    unsigned spins = 0;
    while (ld_acquire(arrive) < target) {
      __nanosleep(32);
      if (++spins == kMaxSpins) __trap();
    }
  }
  __syncthreads();
}

// A claim word: a tag in the top two bits (the parity of the round that
// claimed, or kTaken), the lane below them (lanes stay under 2^30 - 1).
__device__ __forceinline__ unsigned tagged(int round, int lane) {
  return static_cast<unsigned>(round & 1) << 30 | static_cast<unsigned>(lane);
}

// Round `round`'s claims for up to kPlaceIlp lanes a thread (lane[q] < 0:
// none), every claim of the earlier rounds being final: a slot is taken iff
// its word holds an earlier round's claim (whose lowest claimant won it):
// the previous round's parity, or kTaken once its winner has settled; a
// word of this round's parity is free, and the atomic minimum of this
// round's words leaves the lowest lane in it.  Round 0 finds every slot
// free.  The candidates come back in c[].
__device__ __forceinline__ void place_claim(const int* __restrict__ home,
                                            unsigned* claim, int cap, int max_probes,
                                            int round, const int (&lane)[kPlaceIlp],
                                            int (&c)[kPlaceIlp]) {
  int h[kPlaceIlp];
#pragma unroll
  for (int q = 0; q < kPlaceIlp; ++q) {
    c[q] = -1;
    h[q] = lane[q] >= 0 ? __ldg(home + lane[q]) : 0;
  }
  if (round == 0) {  // nothing is taken yet: the home slot, with no read
#pragma unroll
    for (int q = 0; q < kPlaceIlp; ++q)
      if (lane[q] >= 0 && max_probes > 0) c[q] = rt::probe_slot(h[q], 0, cap);
  }
  for (int step = 0; step < (round == 0 ? 0 : max_probes); ++step) {
    int s[kPlaceIlp];
    unsigned w[kPlaceIlp];
#pragma unroll
    for (int q = 0; q < kPlaceIlp; ++q) {  // every probe of the step in flight together
      s[q] = rt::probe_slot(h[q], step, cap);
      w[q] = lane[q] >= 0 && c[q] < 0 ? __ldcg(claim + s[q]) : 0;
    }
    bool more = false;
#pragma unroll
    for (int q = 0; q < kPlaceIlp; ++q) {
      if (lane[q] >= 0 && c[q] < 0) {
        if (w[q] == kNoClaim || w[q] >> 30 == static_cast<unsigned>(round & 1)) c[q] = s[q];
        else more = true;
      }
    }
    if (!more) break;
  }
#pragma unroll
  for (int q = 0; q < kPlaceIlp; ++q)
    if (c[q] >= 0) atomicMin(claim + c[q], tagged(round, lane[q]));
}

// Warp-aggregated count of `flag` into a shared counter; returns this lane's
// position among the flagged lanes of all warps that added before it.
__device__ __forceinline__ unsigned count_in(unsigned* counter, bool flag) {
  const int lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  unsigned at = 0;
  if (ballot) {
    const int leader = __ffs(ballot) - 1;
    if (lane == leader) at = atomicAdd(counter, static_cast<unsigned>(__popc(ballot)));
    at = __shfl_sync(0xffffffffu, at, leader) + __popc(ballot & ((1u << lane) - 1u));
  }
  return at;
}

// Round 0's lanes go to the blocks in chunks of kPlaceChunk, in turn (the
// active lanes are often a prefix: the rehash compacts the live rows first),
// and block b's worklists take the range [lo, lo + n) of every list, its
// round-0 lane count at the offset of the blocks before it.
constexpr int kPlaceChunk = kPlaceIlp * kPlaceThreads;

struct LaneRange {
  int lo, n;
};

__device__ __forceinline__ LaneRange block_lanes(int b, int m) {
  const int g = static_cast<int>(gridDim.x);
  const int chunks = (m + kPlaceChunk - 1) / kPlaceChunk;
  const int full = chunks / g, rem = chunks % g;
  const int short_by = chunks * kPlaceChunk - m;  // lanes the last chunk lacks
  const int last = (chunks - 1) % g;              // the block that has the last chunk
  return {kPlaceChunk * (b * full + min(b, rem)) - (last < b ? short_by : 0),
          kPlaceChunk * (full + (b < rem ? 1 : 0)) - (last == b ? short_by : 0)};
}

// Round 0's lane at local index jj of block b.
__device__ __forceinline__ int round0_lane(int b, int jj) {
  return (b + jj / kPlaceChunk * static_cast<int>(gridDim.x)) * kPlaceChunk + jj % kPlaceChunk;
}

// One launch a call.  Phase 0 makes round 0's claims; phase r + 1 settles
// round r (a lane won iff its slot's word holds its own tag of round r) and
// makes round r + 1's claims for the lanes that lost, each phase ended by a
// grid barrier after which every block applies the stop rule to the same
// totals.  Round r > 0 of block b takes only the lanes that its round r - 1
// lost, kept in its range of the worklists (lanes and their candidates, two
// of each), so no worklist is shared between blocks and the block counts
// its losers in shared memory.  The claim words are the only words other
// blocks write during the rounds; they are read through L2 (__ldcg).  The
// totals take one atomic a block a count.  Once kTailLanes or fewer lanes are
// pending, block 0 gathers them into shared memory and runs the remaining
// rounds alone, with block barriers.
__global__ void __launch_bounds__(kPlaceThreads)
probe_place_kernel(const int* __restrict__ home, const uint8_t* __restrict__ active, int m,
                   int cap, int max_probes, int max_rounds, unsigned* claim,
                   int* cand_a, int* cand_b, int* list_a, int* list_b, int* slots,
                   unsigned long long* ctl, uint8_t* overflow, int* rounds_total) {
  __shared__ unsigned s_count[2];  // this block's phase: candidates, lanes still pending
  __shared__ int s_lane[2][kTailLanes];
  __shared__ int s_cand[2][kTailLanes];
  __shared__ unsigned s_off[kMaxPlaceBlocks + 1];
  unsigned* words = reinterpret_cast<unsigned*>(ctl);
  const int t = threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + t;
  const LaneRange mine = block_lanes(blockIdx.x, m);
  const int lo = mine.lo;
  int n_mine = mine.n;  // this block's lanes in round 0
  unsigned long long target = gridDim.x;

  if (cap % 4 == 0) {
    const uint4 none = make_uint4(kNoClaim, kNoClaim, kNoClaim, kNoClaim);
    for (long long k = tid; k < cap / 4; k += stride) reinterpret_cast<uint4*>(claim)[k] = none;
  } else {
    for (long long k = tid; k < cap; k += stride) claim[k] = kNoClaim;
  }
  grid_barrier(ctl, target);

  // phase 0: round 0's claims, the active lanes of this block's range
  if (t < 2) s_count[t] = 0;
  __syncthreads();
  for (int base = 0; base < n_mine; base += kPlaceIlp * kPlaceThreads) {
    int lane[kPlaceIlp], c[kPlaceIlp];
#pragma unroll
    for (int q = 0; q < kPlaceIlp; ++q) {
      const int jj = base + q * kPlaceThreads + t;
      const int i = round0_lane(blockIdx.x, jj);
      lane[q] = jj < n_mine && active[i] ? i : -1;
      if (jj < n_mine && lane[q] < 0) slots[i] = -1;  // an inactive lane
    }
    place_claim(home, claim, cap, max_probes, 0, lane, c);
#pragma unroll
    for (int q = 0; q < kPlaceIlp; ++q) {
      const int jj = base + q * kPlaceThreads + t;
      if (jj < n_mine) cand_a[lo + jj] = c[q];
      count_in(s_count, c[q] >= 0);
      count_in(s_count + 1, lane[q] >= 0);
    }
  }
  __syncthreads();
  if (t < 2 && s_count[t]) atomicAdd(words + kCtlPairs + t, s_count[t]);
  target += gridDim.x;
  grid_barrier(ctl, target);

  int rounds = 0;
  unsigned n_still = __ldcg(words + kCtlPairs + 1);  // the active lanes
  unsigned n_has = __ldcg(words + kCtlPairs);
  bool tail = false;
  int r = 0;
  const int* list_in = nullptr;  // round 0: this block's range
  int* list_out = list_a;
  const int* cand_in = cand_a;
  int* cand_out = cand_b;
  if (n_still > 0) {
    rounds = 1;
    for (;;) {
      if (n_has == 0) break;  // no candidate anywhere: no winner can ever appear again
      // phase r + 1: settle round r, then round r + 1's claims by its losers
      const int p = r + 1;
      unsigned* pair = words + kCtlPairs + 2 * (p % 3);
      if (tid == 0) {  // every block has read the pair of phase p - 2
        unsigned* next = words + kCtlPairs + 2 * ((p + 1) % 3);
        next[0] = next[1] = 0;
      }
      if (t < 2) s_count[t] = 0;
      __syncthreads();
      const bool go_on = rounds < max_rounds;
      for (int base = 0; base < n_mine; base += kPlaceIlp * kPlaceThreads) {
        int lane[kPlaceIlp], c[kPlaceIlp], next[kPlaceIlp], at[kPlaceIlp];
        unsigned held[kPlaceIlp];
#pragma unroll
        for (int q = 0; q < kPlaceIlp; ++q) {
          const int jj = base + q * kPlaceThreads + t;
          lane[q] = -1;
          c[q] = -1;
          if (jj < n_mine) {
            const int i = round0_lane(blockIdx.x, jj);
            lane[q] = r > 0 ? list_in[lo + jj] : (active[i] ? i : -1);
            c[q] = cand_in[lo + jj];
          }
        }
#pragma unroll
        for (int q = 0; q < kPlaceIlp; ++q) held[q] = c[q] >= 0 ? __ldcg(claim + c[q]) : 0;
#pragma unroll
        for (int q = 0; q < kPlaceIlp; ++q) {
          const bool won = lane[q] >= 0 && c[q] >= 0 && held[q] == tagged(r, lane[q]);
          const bool still = lane[q] >= 0 && !won;
          if (won) {
            slots[lane[q]] = c[q];
            claim[c[q]] = kTaken | static_cast<unsigned>(lane[q]);
          } else if (still && r == 0) {
            slots[lane[q]] = -1;
          }
          at[q] = count_in(s_count + 1, still);
          if (still) list_out[lo + at[q]] = lane[q];
          next[q] = still && go_on ? lane[q] : -1;
        }
        place_claim(home, claim, cap, max_probes, r + 1, next, c);
#pragma unroll
        for (int q = 0; q < kPlaceIlp; ++q) {
          if (next[q] >= 0) cand_out[lo + at[q]] = c[q];
          count_in(s_count, c[q] >= 0);
        }
      }
      __syncthreads();
      const unsigned lost_here = s_count[1];
      if (t < 2 && s_count[t]) atomicAdd(pair + t, s_count[t]);
      if (t == 0) words[kCtlLost + blockIdx.x] = lost_here;
      target += gridDim.x;
      grid_barrier(ctl, target);

      // every block reads the same totals: the reference's stop rule
      n_has = __ldcg(pair);
      n_still = __ldcg(pair + 1);
      if (n_still == 0 || !go_on) break;
      ++rounds;  // round r + 1 has made its claims
      n_mine = static_cast<int>(lost_here);
      list_in = list_out;
      list_out = list_in == list_a ? list_b : list_a;
      cand_in = cand_out;
      cand_out = cand_in == cand_a ? cand_b : cand_a;
      ++r;
      if (n_has > 0 && n_still <= kTailLanes) {
        tail = true;
        break;
      }
    }
  }

  if (tail) {
    if (blockIdx.x != 0) return;
    // gather every block's pending lanes: block b's are at [lo_b, lo_b + lost_b)
    const int g = static_cast<int>(gridDim.x);
    for (int b = t; b < g; b += kPlaceThreads) s_off[b] = __ldcg(words + kCtlLost + b);
    __syncthreads();
    if (t < 32) {  // exclusive scan: lane t takes blocks [t * per, t * per + per)
      const int per = (g + 31) / 32;
      unsigned sum = 0;
      for (int b = t * per; b < min(g, t * per + per); ++b) sum += s_off[b];
      unsigned off = warp_inclusive_scan(static_cast<int>(sum)) - sum;
      for (int b = t * per; b < min(g, t * per + per); ++b) {
        const unsigned k = s_off[b];
        s_off[b] = off;
        off += k;
      }
      if (t == 31) s_off[g] = off;
    }
    __syncthreads();
    int n = static_cast<int>(n_still);
    for (int j = t; j < n; j += kPlaceThreads) {
      int b = 0, hi = g - 1;  // the block whose range holds j
      while (b < hi) {
        const int mid = (b + hi + 1) / 2;
        if (s_off[mid] <= static_cast<unsigned>(j)) b = mid;
        else hi = mid - 1;
      }
      const int at = block_lanes(b, m).lo + (j - static_cast<int>(s_off[b]));
      s_lane[0][j] = __ldcg(list_in + at);
      s_cand[0][j] = __ldcg(cand_in + at);
    }
    int cur = 0;
    for (;;) {  // as the phases above, with block barriers
      __syncthreads();
      if (t < 2) s_count[t] = 0;
      __syncthreads();
      const bool go_on = rounds < max_rounds;
      for (int j = t; j < n; j += kPlaceThreads) {
        const int i = s_lane[cur][j];
        const int c = s_cand[cur][j];
        int next[kPlaceIlp], cn[kPlaceIlp];  // one lane a thread here: next[0]
#pragma unroll
        for (int q = 0; q < kPlaceIlp; ++q) next[q] = -1;
        unsigned at = 0;
        if (c >= 0 && __ldcg(claim + c) == tagged(r, i)) {
          slots[i] = c;
          claim[c] = kTaken | static_cast<unsigned>(i);
        } else {
          at = atomicAdd(s_count + 1, 1u);
          s_lane[cur ^ 1][at] = i;
          if (go_on) next[0] = i;
        }
        place_claim(home, claim, cap, max_probes, r + 1, next, cn);
        if (next[0] >= 0) {
          s_cand[cur ^ 1][at] = cn[0];
          if (cn[0] >= 0) atomicAdd(s_count, 1u);
        }
      }
      __syncthreads();
      n_has = s_count[0];
      n_still = s_count[1];
      if (n_still == 0 || !go_on) break;
      ++rounds;
      if (n_has == 0) break;
      n = static_cast<int>(n_still);
      cur ^= 1;
      ++r;
    }
  }
  if (tid == 0) {
    *overflow = rounds > 0 && n_still > 0;
    *rounds_total += rounds;
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

// One cooperative launch of the resident blocks (at most what the lanes and
// the claim fill can use), after a memset of its control words.  ints: the
// claim words (cap), then two candidate lists and two worklists (m each).
// A grid the card cannot keep resident is refused by the launch, never run.
extern "C" int rt_probe_place(const void* home, const void* active, int m, int cap,
                              int max_probes, int max_rounds, void* ints, void* ctl, void* slots,
                              void* overflow, void* rounds_total, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static int resident_of[64];  // resident blocks, by device ordinal, found once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_place_kernel,
                                                          kPlaceThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident_of[dev] = per_sm * sms;
  }
  const long long work = m > cap / 4 ? m : cap / 4;
  const long long need = (work + kPlaceThreads - 1) / kPlaceThreads;
  long long grid = need < resident_of[dev] ? need : resident_of[dev];
  grid = grid < 1 ? 1 : (grid > kMaxPlaceBlocks ? kMaxPlaceBlocks : grid);
  err = cudaMemsetAsync(ctl, 0, kCtlBytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int* a_home = static_cast<const int*>(home);
  const uint8_t* a_active = static_cast<const uint8_t*>(active);
  unsigned* a_claim = static_cast<unsigned*>(ints);
  int* a_cand_a = static_cast<int*>(ints) + cap;
  int* a_cand_b = a_cand_a + m;
  int* a_list_a = a_cand_b + m;
  int* a_list_b = a_list_a + m;
  int* a_slots = static_cast<int*>(slots);
  unsigned long long* a_ctl = static_cast<unsigned long long*>(ctl);
  uint8_t* a_over = static_cast<uint8_t*>(overflow);
  int* a_rounds = static_cast<int*>(rounds_total);
  void* args[] = {&a_home, &a_active, &m, &cap, &max_probes, &max_rounds, &a_claim, &a_cand_a,
                  &a_cand_b, &a_list_a, &a_list_b, &a_slots, &a_ctl, &a_over, &a_rounds};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(probe_place_kernel),
                                    dim3(static_cast<unsigned>(grid)), dim3(kPlaceThreads), args,
                                    0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Batched bounded hash probe: the engine's locate hot loop.
//
// Replaces the Pallas kernel repro/kernels/hash_probe/kernel.py::hash_probe
// (body _probe_kernel).  For each query key it walks the triangular chain
// from the mix32 home slot for at most max_probes steps and returns the slot
// holding the key and the first EMPTY_KEY slot, -1 where none.
//
// What bounds it on an H100: dependent memory latency, not bytes.  At the
// main path's 2^17 queries into a table of 2^23 slots every query fits on
// the card at once (512 blocks of 256 threads), the bytes are a few MB, and
// a query's time is its chain of dependent loads: its key, then one 4-byte
// load a probe step.  The TPU kernel kept the whole column in VMEM; here
// there is no staging, and a 32 MB column fits the 50 MB L2 between the
// engine's calls.  At load 0.14 almost every query stops at its first probe
// (146,168 steps for 131,072 queries on phase 4's table), so a call is the
// key's load and one dependent load: the floor that hash_probe_floor_kernel
// measures on the same grid.  Reading home's aligned 32-byte
// sector in one round trip, or the two sectors that hold steps 0-3, did not
// beat this loop on an H100 (equal, and 12% slower): they add sectors for
// every query to save a round trip for the few whose chain goes on.
//
// One thread per query, stopping at its first hit or first empty slot, so
// the work is the chain length the data needs, never the cap; the chain
// wraps at the table's end (rt::probe_slot).  Neighbouring threads read
// neighbouring queries and write neighbouring outputs, so those coalesce.

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kMaxProbes = 32;  // types.MAX_PROBES

__global__ void hash_probe_kernel(const int* __restrict__ table, int cap,
                                  const int* __restrict__ queries, int n,
                                  int max_probes, int* __restrict__ found,
                                  int* __restrict__ empty) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int q = queries[i];
  const int home = static_cast<int>(rt::mix32(static_cast<uint32_t>(q)) &
                                    static_cast<uint32_t>(cap - 1));
  int f = -1, e = -1;
  for (int step = 0; step < max_probes; ++step) {
    const int s = rt::probe_slot(home, step, cap);
    const int k = __ldg(table + s);
    if (k == q) { f = s; break; }
    if (k == rt::kEmptyKey) { e = s; break; }
  }
  found[i] = f;
  empty[i] = e;
}

// The latency floor of the probe's grid, for measurement only: mode 0 an
// empty kernel, mode 1 a thread's key and then one dependent load of its
// home slot, written out.
__global__ void hash_probe_floor_kernel(const int* __restrict__ table, int cap,
                                        const int* __restrict__ queries, int n,
                                        int mode, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (mode == 0 || i >= n) return;
  const int q = queries[i];
  out[i] = __ldg(table + (rt::mix32(static_cast<uint32_t>(q)) &
                          static_cast<uint32_t>(cap - 1)));
}

}  // namespace

extern "C" int rt_hash_probe(const void* table, int cap, const void* queries,
                             int n, void* found, void* empty, void* stream) {
  if (n > 0) {
    hash_probe_kernel<<<rt::grid_for(n, kBlock), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(table), cap, static_cast<const int*>(queries), n,
        kMaxProbes, static_cast<int*>(found), static_cast<int*>(empty));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_hash_probe_floor(const void* table, int cap, const void* queries,
                                   int n, int mode, void* out, void* stream) {
  if (n > 0) {
    hash_probe_floor_kernel<<<rt::grid_for(n, kBlock), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(table), cap, static_cast<const int*>(queries), n, mode,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

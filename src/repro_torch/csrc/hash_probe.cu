// Batched bounded hash probe: the engine's locate hot loop.
//
// Replaces the Pallas kernel repro/kernels/hash_probe/kernel.py::hash_probe
// (body _probe_kernel).  For each query key it walks the triangular chain
// from the mix32 home slot for at most max_probes steps and returns the slot
// holding the key and the first EMPTY_KEY slot, -1 where none.
//
// What bounds it on an H100: dependent gathers into the key column, one per
// probe step.  The TPU kernel kept the whole column in VMEM; here there is no
// staging at all.  A column of 2^22 int32 keys is 16 MB and stays resident in
// the 50 MB L2, so every probe after the first touch is an L2 hit.  One thread
// per query, and a thread stops at its first hit or first empty slot, so the
// work is the chain length the data needs (about 1-2 steps at load 0.5),
// never the cap.  Neighbouring threads read neighbouring queries and write
// neighbouring outputs, so those accesses coalesce.

#include "common.cuh"

namespace {

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

}  // namespace

extern "C" int rt_hash_probe(const void* table, int cap, const void* queries,
                             int n, void* found, void* empty, void* stream) {
  constexpr int kBlock = 256;
  constexpr int kMaxProbes = 32;  // types.MAX_PROBES
  if (n > 0) {
    hash_probe_kernel<<<rt::grid_for(n, kBlock), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(table), cap, static_cast<const int*>(queries), n,
        kMaxProbes, static_cast<int*>(found), static_cast<int*>(empty));
  }
  return static_cast<int>(cudaGetLastError());
}

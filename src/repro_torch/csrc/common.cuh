// Shared helpers for the graph kernels: the 32-bit key hash and the
// triangular probe sequence, bit-identical to repro_torch.core.hashing.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr int kEmptyKey = -1;
constexpr int kInt32Max = 0x7FFFFFFF;

// MurmurHash3 finalizer (public domain) on uint32 lanes.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// home + step*(step+1)/2 modulo a power-of-two capacity.
__device__ __forceinline__ int probe_slot(int home, int step, int cap) {
  return (home + (step * (step + 1)) / 2) & (cap - 1);
}

inline int grid_for(long long n, int block) {
  long long g = (n + block - 1) / block;
  return static_cast<int>(g < 1 ? 1 : g);
}

}  // namespace rt

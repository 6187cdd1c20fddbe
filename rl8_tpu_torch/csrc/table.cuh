// Per-launch tables in device memory: the per-layer entries of the kernels
// that run a whole model in one launch (act.cu's wgmma and tiled routes,
// ppo.cu's row passes). A model may have any number of layers, and a
// kernel's parameters hold at most 32,764 bytes, so no table of fixed size
// in them covers every depth: the launch function lays the entries out on
// the host, and table_kernel copies them, through its own parameters
// kTableWords 8-byte words a launch, into the workspace that the wrapper
// allocates, on the launch's stream before the kernel that reads them (one
// launch of table_kernel up to 480 words: 15 layers of ppo.cu, 20 of act.cu's
// wgmma route, both chains). Kernels read an entry where a layer starts;
// every thread reads the same entry, which the L1 cache broadcasts.
#pragma once

#include <cuda_runtime.h>
#include <string.h>

#include <vector>

namespace rl8 {
namespace {  // each including source gets its own copy

constexpr int kTableWords = 480;  // 3,840 bytes of a table_kernel's parameters

struct TableChunk {
  long long word[kTableWords];
  long long base;
  int n;
};

__global__ void table_kernel(const __grid_constant__ TableChunk c, long long* __restrict__ dst) {
  for (int i = threadIdx.x; i < c.n; i += blockDim.x) dst[c.base + i] = c.word[i];
}

// Floats of workspace that a table of n entries of T takes: whole 16-byte
// units, so that what follows it stays aligned.
template <class T>
__host__ inline long long table_floats(long long n) {
  return (n * (long long)sizeof(T) + 15) / 16 * 4;
}

// Copies the entries of v to dst (table_floats<T>(v.size()) floats) on s.
template <class T>
__host__ inline cudaError_t upload_table(const std::vector<T>& v, void* dst, cudaStream_t s) {
  static_assert(sizeof(T) % sizeof(long long) == 0, "a table entry is whole 8-byte words");
  const long long* src = reinterpret_cast<const long long*>(v.data());
  const long long n = (long long)v.size() * (long long)(sizeof(T) / sizeof(long long));
  for (long long b = 0; b < n; b += kTableWords) {
    TableChunk c;
    c.base = b;
    c.n = (int)(n - b < kTableWords ? n - b : kTableWords);
    memcpy(c.word, src + b, sizeof(long long) * (size_t)c.n);
    table_kernel<<<1, 256, 0, s>>>(c, static_cast<long long*>(dst));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace rl8

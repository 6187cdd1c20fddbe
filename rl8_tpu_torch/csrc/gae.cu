// GAE kernel: unnormalized generalized advantage estimates and returns.
//
// Replaces rl8_tpu/ops/gae.py:_gae_kernel (the Pallas TPU kernel). For
// time-major rewards [T, B] and values [T + 1, B] it walks t = T-1 ... 0:
//   delta_t = rewards_t / (scale + 1e-8) + gamma * values_{t+1} - values_t
//   adv_t   = delta_t + gamma * lambda * adv_{t+1}      (adv_T = 0)
//   ret_t   = adv_t + values_t
// Advantage normalization stays outside (a global reduction).
//
// Bound on an H100 SXM: it moves (4T + 1) * B * 4 bytes (rewards, values,
// advantages, returns) and does a few FLOP per element, so memory bounds
// it: 4.2 MB at T=32, B=8192, ~1.3 us at 3.35 TB/s; at that size launch
// latency dominates in practice.
//
// Design. One thread per env column carries the recurrence in a register,
// in the plain version's order. Because the layout is time-major, the
// threads of a warp read and write 32 consecutive columns of one time row:
// every access is coalesced. The TPU kernel pads the batch to 512-lane
// tiles and gates the horizon on a VMEM budget; here the ragged edge is
// masked and nothing caps T. The reward scale is read from the 0-d device
// tensor it lives in, so the caller never fetches it to the host.
//
// At 4.2 MB the kernel is a chain of DRAM latencies unless many loads are in
// flight: 256-column blocks gave B=8192 32 blocks on 132 SMs, and each
// thread loaded as it walked t down. Here a block owns kCols = 64 columns
// (B=8192: 128 blocks, about one an SM), and each thread copies its own
// column's rewards and values into shared memory by cp.async, kChunk time
// steps a group, kStages groups in flight before it walks the first: at
// T=32 every load of the launch is issued at once, and at larger T the
// next chunks' copies overlap the walk of the current one. Loads into
// registers did not stay in flight: the compiler issued each chunk's loads
// after the walk before it (one latency a chunk, PERF.md). A thread reads
// back only its own copies, so no barrier is needed.
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kCols = 64;
constexpr int kChunk = 32;
constexpr int kStages = 2;

// Copies chunk c's rewards and values of column b (time steps T - 1 - c
// kChunk - j, j < kChunk, those at or above 0) to row j of r and v, at the
// thread's column, and commits them as one cp.async group (empty past t = 0).
__device__ __forceinline__ void copy_chunk(const float* __restrict__ rewards, const float* __restrict__ values,
                                           int T, int B, int b, int c, float (*r)[kCols], float (*v)[kCols]) {
  const int t0 = T - 1 - c * kChunk;
#pragma unroll 8
  for (int j = 0; j < kChunk && t0 - j >= 0; ++j) {
    const size_t i = (size_t)(t0 - j) * B + b;
    rl8::cp_async4(&r[j][threadIdx.x], rewards + i, 4);
    rl8::cp_async4(&v[j][threadIdx.x], values + i, 4);
  }
  rl8::cp_async_commit();
}

__global__ void __launch_bounds__(kCols)
    gae_kernel(const float* __restrict__ rewards, const float* __restrict__ values,
               const float* __restrict__ scale, float* __restrict__ adv,
               float* __restrict__ ret, int T, int B, float gamma, float gamma_lambda) {
  __shared__ float rs[kStages][kChunk][kCols], vs[kStages][kChunk][kCols];
  const int b = blockIdx.x * kCols + threadIdx.x;
  if (b >= B) return;
  for (int c = 0; c < kStages - 1; ++c) copy_chunk(rewards, values, T, B, b, c, rs[c], vs[c]);
  float v_next = __ldg(values + (size_t)T * B + b);
  const float inv_scale = 1.0f / (__ldg(scale) + 1e-8f);
  float prev = 0.0f;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int ahead = c + kStages - 1;
    copy_chunk(rewards, values, T, B, b, ahead, rs[ahead % kStages], vs[ahead % kStages]);
    rl8::cp_async_wait<kStages - 1>();  // chunk c has landed
    const float(*r)[kCols] = rs[c % kStages];
    const float(*v)[kCols] = vs[c % kStages];
    const int t0 = T - 1 - c * kChunk;
    for (int j = 0; j < kChunk && t0 - j >= 0; ++j) {
      const size_t i = (size_t)(t0 - j) * B + b;
      const float vt = v[j][threadIdx.x];
      const float delta = r[j][threadIdx.x] * inv_scale + gamma * v_next - vt;
      prev = delta + gamma_lambda * prev;
      adv[i] = prev;
      ret[i] = prev + vt;
      v_next = vt;
    }
  }
}

// The same grid with no work: what a launch of gae_kernel costs before it
// moves a byte (chip_smoke.py times it beside the kernel).
__global__ void __launch_bounds__(kCols) gae_empty_kernel() {}

}  // namespace

extern "C" int rl8_gae(const float* rewards, const float* values, const float* scale,
                       float* adv, float* ret, int T, int B, float gamma, float gamma_lambda,
                       int device, void* stream) {
  if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kCols - 1) / kCols;
  gae_kernel<<<grid, kCols, 0, (cudaStream_t)stream>>>(rewards, values, scale, adv, ret, T, B, gamma,
                                                       gamma_lambda);
  return (int)cudaGetLastError();
}

extern "C" int rl8_gae_empty(int B, int device, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  gae_empty_kernel<<<(B + kCols - 1) / kCols, kCols, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* rl8_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

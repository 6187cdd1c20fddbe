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
// Design. One thread per env column carries the recurrence in a register.
// Because the layout is time-major, the threads of a warp read and write
// 32 consecutive columns of one time row: every access is coalesced. The
// TPU kernel pads the batch to 512-lane tiles and gates the horizon on a
// VMEM budget; here the ragged edge is masked and nothing caps T. The
// reward scale is read from the 0-d device tensor it lives in, so the
// caller never fetches it to the host.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    gae_kernel(const float* __restrict__ rewards, const float* __restrict__ values,
               const float* __restrict__ scale, float* __restrict__ adv,
               float* __restrict__ ret, int T, int B, float gamma, float gamma_lambda) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float inv_scale = 1.0f / (scale[0] + 1e-8f);
  float prev = 0.0f;
  float v_next = values[(size_t)T * B + b];
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = (size_t)t * B + b;
    const float v = values[i];
    const float delta = rewards[i] * inv_scale + gamma * v_next - v;
    prev = delta + gamma_lambda * prev;
    adv[i] = prev;
    ret[i] = prev + v;
    v_next = v;
  }
}

}  // namespace

extern "C" int rl8_gae(const float* rewards, const float* values, const float* scale,
                       float* adv, float* ret, int T, int B, float gamma, float gamma_lambda,
                       int device, void* stream) {
  if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kThreads - 1) / kThreads;
  gae_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(rewards, values, scale, adv, ret, T,
                                                          B, gamma, gamma_lambda);
  return (int)cudaGetLastError();
}

extern "C" const char* rl8_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

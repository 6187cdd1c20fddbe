// Block-level MLP pieces shared by the kernels (the PPO update kernel
// ppo.cu, the chain kernels chains.cu, the act kernels' activations and
// narrow heads): a block of threads owns R rows whose activations live in
// shared memory, and weights stream from L2.
//
// dense_layer is a [R, in_w] x [in_w, out_w] product: weights are packed
// [in, out], so thread j reads column j and the 32 threads of a warp read 32
// consecutive floats; each weight read feeds R FMAs against activations
// that the warp reads as (16-byte) broadcasts. Sums run in order of k.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rl8 {
namespace {  // each including source gets its own copy

// Activation codes: the position in rl8_tpu_torch/ops/fused_mlp.py:ACT_FNS,
// plus kIdentity for products that are not followed by an activation.
constexpr int kRelu = 0;
constexpr int kTanh = 1;
constexpr int kIdentity = 2;

// relu keeps a NaN, as torch.relu and jnp.maximum do (fmaxf(NaN, 0) is 0).
// Every kernel's forward activation is this one; the backward masks stay
// h > 0, which is 0 at a NaN, as torch's threshold_backward gives.
__device__ __forceinline__ float activate(float x, int act) {
  return act == kRelu ? (x > 0.0f || x != x ? x : 0.0f) : (act == kTanh ? tanhf(x) : x);
}

// out[r, j] = act(sum_k in[r, k] * W[k, j] + b[j]) for all R rows, summed in
// order of k; b may be null (no bias). in's rows are ld_in apart and out's
// ld_out apart (in_w and out_w when 0). Where in_w is a multiple of 4,
// activations are read four k at a time (one 16-byte broadcast load feeds
// four FMAs), so shared-memory loads no longer pace the FMAs one for one.
// `in` must then be 16-byte aligned.
template <int R>
__device__ void dense_layer(const float* in, int in_w, const float* __restrict__ W,
                            const float* __restrict__ b, float* out, int out_w, int act, int ld_out = 0,
                            int ld_in = 0) {
  if (ld_out == 0) ld_out = out_w;
  if (ld_in == 0) ld_in = in_w;
  for (int j = threadIdx.x; j < out_w; j += blockDim.x) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    int k = 0;
    if ((in_w & 3) == 0 && (ld_in & 3) == 0) {
      for (; k < in_w; k += 4) {
        const float w0 = __ldg(W + (size_t)k * out_w + j);
        const float w1 = __ldg(W + (size_t)(k + 1) * out_w + j);
        const float w2 = __ldg(W + (size_t)(k + 2) * out_w + j);
        const float w3 = __ldg(W + (size_t)(k + 3) * out_w + j);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 h = *reinterpret_cast<const float4*>(in + r * ld_in + k);
          acc[r] = fmaf(h.x, w0, acc[r]);
          acc[r] = fmaf(h.y, w1, acc[r]);
          acc[r] = fmaf(h.z, w2, acc[r]);
          acc[r] = fmaf(h.w, w3, acc[r]);
        }
      }
    }
    for (; k < in_w; ++k) {
      const float w = __ldg(W + (size_t)k * out_w + j);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(in[r * ld_in + k], w, acc[r]);
    }
    const float bj = b != nullptr ? __ldg(b + j) : 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) out[r * ld_out + j] = activate(acc[r] + bj, act);
  }
}

// out[r * stride + col0 + o] = sum_k in[r, k] * W[k, o] + b[o] for all R rows
// (in's rows ld_in apart, in_w when 0): one warp per (row, output) pair,
// lanes striding over k, then a shuffle reduction.
template <int R>
__device__ void narrow_head(const float* in, int in_w, const float* __restrict__ W,
                            const float* __restrict__ b, int n_out, float* out, int stride,
                            int col0, int ld_in = 0) {
  if (ld_in == 0) ld_in = in_w;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int p = warp; p < R * n_out; p += n_warps) {
    const int r = p / n_out;
    const int o = p % n_out;
    float s = 0.0f;
    for (int k = lane; k < in_w; k += 32) s = fmaf(in[r * ld_in + k], __ldg(W + k * n_out + o), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[r * stride + col0 + o] = s + __ldg(b + o);
  }
}

}  // namespace
}  // namespace rl8

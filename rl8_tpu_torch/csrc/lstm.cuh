// LSTM cell pieces shared by the recurrent kernels (rnn_act.cu, rnn_ppo.cu).
// A layer's parameters are Wi [in_w, 4H], Wh [H, 4H] and b [4H], the gates
// i, f, g, o side by side (flax's OptimizedLSTMCell order); a block owns R
// rows, whose layer input and previous hidden state live in shared memory,
// and thread j owns hidden unit j: it computes that unit's four gate columns
// (j, H + j, 2H + j, 3H + j) for all R rows, so the cell update stays in its
// registers. Weights stream from L2: the 32 threads of a warp read 32
// consecutive floats of each of the four gate blocks of a weight row, and
// each weight read feeds R FMAs against activations the warp reads as
// 16-byte broadcasts.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rl8 {
namespace {  // each including source gets its own copy

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// acc[g][r] += sum_k in[r, k] * W[k, g H + j] over k in order, for the four
// gates g; in's rows are ld_in apart (in_w when 0). Where in_w and ld_in
// are multiples of 4, `in` (16-byte aligned) is read four k at a time.
template <int R>
__device__ __forceinline__ void gate_products(const float* in, int in_w, const float* __restrict__ W, int H,
                                              int j, float (&acc)[4][R], int ld_in = 0) {
  if (ld_in == 0) ld_in = in_w;
  const size_t ld = 4 * (size_t)H;
  int k = 0;
  if ((in_w & 3) == 0 && (ld_in & 3) == 0) {
    for (; k < in_w; k += 4) {
      float w[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int g = 0; g < 4; ++g) w[q][g] = __ldg(W + (k + q) * ld + g * H + j);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(in + r * ld_in + k);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[g][r] = fmaf(x.x, w[0][g], acc[g][r]);
          acc[g][r] = fmaf(x.y, w[1][g], acc[g][r]);
          acc[g][r] = fmaf(x.z, w[2][g], acc[g][r]);
          acc[g][r] = fmaf(x.w, w[3][g], acc[g][r]);
        }
      }
    }
  }
  for (; k < in_w; ++k) {
    float w[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) w[g] = __ldg(W + k * ld + g * H + j);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = in[r * ld_in + k];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g][r] = fmaf(x, w[g], acc[g][r]);
    }
  }
}

// The pre-activations z = b + x Wi + h Wh of hidden unit j's four gates for
// R rows of x [R, in_w] and h [R, H] (both in shared memory, rows ld_x and
// ld_h apart, in_w and H when 0).
template <int R>
__device__ __forceinline__ void lstm_preact(const float* x, int in_w, const float* h, const float* __restrict__ Wi,
                                            const float* __restrict__ Wh, const float* __restrict__ b, int H,
                                            int j, float (&z)[4][R], int ld_x = 0, int ld_h = 0) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float bg = __ldg(b + g * H + j);
#pragma unroll
    for (int r = 0; r < R; ++r) z[g][r] = bg;
  }
  gate_products<R>(x, in_w, Wi, H, j, z, ld_x);
  gate_products<R>(h, H, Wh, H, j, z, ld_h);
}

// The gate activations in place (sigmoid on i, f, o; tanh on g) of one row.
__device__ __forceinline__ void gate_activations(float& i, float& f, float& g, float& o) {
  i = sigmoidf(i);
  f = sigmoidf(f);
  g = tanhf(g);
  o = sigmoidf(o);
}

}  // namespace
}  // namespace rl8

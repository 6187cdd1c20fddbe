// Action sampling of the act kernels (act.cu, rnn_act.cu): from the heads'
// outputs of a block's rows, the actions, their log-probs and the values.
//
// Random numbers: counter-based Philox4x32-10 keyed by the per-step (seed,
// offset) that the wrapper draws from the algorithm's generator, so draws do
// not depend on the block size. A categorical draw is word 0 at counter
// (row, group, category, 0); a normal draw is Box-Muller, sqrt(-2 log u1)
// cos(2 pi u2), on words 0 and 1 at counter (row, dim, 0, 1). A word's top
// 23 bits scaled by 2^-23 and clamped to >= 1e-7 give a uniform (the TPU
// kernel's construction); the Gumbel term is -log(-log(u)).
// ops/distmath.py:philox_uniform and philox_normal are the same generator in
// PyTorch, so the plain versions can replay a launch's draws exactly.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "distmath.cuh"

namespace rl8 {
namespace {  // each including source gets its own copy

__device__ __forceinline__ uint2 philox_words01(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                                uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint2(c0, c1);
}

__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return fmaxf(__uint2float_rn(bits >> 9) * 1.1920928955078125e-7f, 1e-7f);
}

// Categorical sampling of rows r0 .. r0 + nr - 1, whose heads [rows, stride]
// (shared memory) hold A groups of n_cat logits from column 0 and the value
// in column stride - 1: per group a log-softmax, z - (max + log(sum(exp(z -
// max)))) (distmath.log_softmax_rows), Gumbel-argmax sampling (the argmax
// of the log-probs when deterministic; ties go to the first index), one
// int32 action column per group; the chosen log-probs summed over groups in
// group order. `chosen` is [rows, A] of shared scratch. Every thread of the
// block must call it.
__device__ void categorical_epilogue(const float* heads, int stride, int r0, int nr, int A, int n_cat,
                                     uint32_t seed, uint32_t offset, int deterministic,
                                     int* __restrict__ actions, float* __restrict__ logp,
                                     float* __restrict__ values, float* chosen) {
  for (int t = threadIdx.x; t < nr * A; t += blockDim.x) {
    const int r = t / A;
    const int a = t % A;
    const float* z = heads + r * stride + a * n_cat;
    float m = z[0];
    for (int c = 1; c < n_cat; ++c) m = fmaxf(m, z[c]);
    float s = 0.0f;
    for (int c = 0; c < n_cat; ++c) s += expf(z[c] - m);
    const float lse = m + logf(s);
    int best = 0;
    float best_score = -INFINITY;
    float best_lp = z[0] - lse;
    for (int c = 0; c < n_cat; ++c) {
      const float lp = z[c] - lse;
      float score = lp;
      if (!deterministic) {
        const float u = to_uniform(philox_words01((uint32_t)(r0 + r), (uint32_t)a, (uint32_t)c, 0u, seed, offset).x);
        score = lp - logf(-logf(u));
      }
      if (score > best_score) {  // strict: ties go to the first index
        best_score = score;
        best = c;
        best_lp = lp;
      }
    }
    actions[(size_t)(r0 + r) * A + a] = best;
    chosen[r * A + a] = best_lp;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    float total = chosen[r * A];
    for (int a = 1; a < A; ++a) total += chosen[r * A + a];
    logp[r0 + r] = total;
    values[r0 + r] = heads[r * stride + stride - 1];
  }
}

// Normal (or, squashed, SquashedNormal) sampling of rows r0 .. r0 + nr - 1
// (distmath.sample_continuous_actions), whose heads [rows, stride] hold the
// mean [A] from column 0, the pre-tanh log-std [A] from column A and the
// value in column stride - 1: per row and dim log_std = tanh(head), a
// Box-Muller normal draw, a = mean + std * noise (mean when deterministic),
// a = tanh(a) when squashed, the log-prob (of the squashed action through
// the clipped atanh and the +-100 clamp when squashed; distmath.cuh), summed
// over dims in order. `parts` is [rows, 2A] of shared scratch. Every thread
// of the block must call it.
__device__ void continuous_epilogue(const float* heads, int stride, int r0, int nr, int A, int squashed,
                                    uint32_t seed, uint32_t offset, int deterministic,
                                    float* __restrict__ actions, float* __restrict__ logp,
                                    float* __restrict__ values, float* parts) {
  for (int t = threadIdx.x; t < nr * A; t += blockDim.x) {
    const int r = t / A;
    const int a = t % A;
    const float* z = heads + r * stride;
    const float mean = z[a];
    const float log_std = tanhf(z[A + a]);
    const float sd = expf(log_std);
    const float inv_var = expf(-2.0f * log_std);
    float x = mean;
    if (!deterministic) {
      const uint2 w = philox_words01((uint32_t)(r0 + r), (uint32_t)a, 0u, 1u, seed, offset);
      const float noise = sqrtf(-2.0f * logf(to_uniform(w.x))) * cosf(kTwoPi * to_uniform(w.y));
      // Rounded as the plain version's two tensor ops round it.
      x = __fadd_rn(mean, __fmul_rn(sd, noise));
    }
    float base, log_det = 0.0f;
    if (squashed) {
      x = tanhf(x);
      const float c = squash_clip(x);
      base = clamp100(normal_per_dim_logp(clipped_atanh(c) - mean, log_std, inv_var));
      log_det = squash_log_det(c);
    } else {
      base = normal_per_dim_logp(x - mean, log_std, inv_var);
    }
    actions[(size_t)(r0 + r) * A + a] = x;
    parts[r * 2 * A + a] = base;
    parts[r * 2 * A + A + a] = log_det;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    const float* pr = parts + r * 2 * A;
    float total = pr[0];
    for (int a = 1; a < A; ++a) total += pr[a];
    if (squashed) {
      float det = pr[A];
      for (int a = 1; a < A; ++a) det += pr[A + a];
      total -= det;
    }
    logp[r0 + r] = total;
    values[r0 + r] = heads[r * stride + stride - 1];
  }
}

}  // namespace
}  // namespace rl8

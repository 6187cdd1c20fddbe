// Distribution math shared by the act kernels (act.cu) and the PPO update
// kernel (ppo.cu): the counterpart of rl8_tpu_torch/ops/distmath.py, written
// with the same formulas and constants (each rounded once to f32, as PyTorch
// rounds a Python float), so that the log-prob stored at act time and the
// one the update recomputes agree, and both agree with the plain versions
// to f32 rounding. Precise tanhf/expf/logf/log1pf: no fast-math intrinsics.
//
// The log-prob formulas round every operation as the plain version's
// tensor ops do (__fmul_rn and friends, which nvcc never contracts into an
// FMA): near a squashed action of +-1, 1 - c*c cancels, and an FMA there
// would change the log-det term by up to ~1e-2 against the plain version
// (c*c rounded first). So for the same mean, log-std and action, kernel and
// plain version give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rl8 {
namespace {  // each including source gets its own copy

// Distribution kinds: the position in rl8_tpu_torch/ops/fused_act.py:KINDS.
constexpr int kCategorical = 0;
constexpr int kNormal = 1;
constexpr int kSquashed = 2;

constexpr float kHalfLog2Pi = 0.9189385332046727f;  // 0.5 * log(2 pi)
constexpr float kNormalEntropy = 1.4189385332046727f;  // 0.5 * (1 + log(2 pi))
constexpr float kSquashEps = 1.1920929e-07f;  // f32 machine epsilon
constexpr float kTwoPi = 6.283185307179586f;

// Per-dimension diagonal-normal log-prob; diff = x - mean, inv_var =
// exp(-2 log_std).
__device__ __forceinline__ float normal_per_dim_logp(float diff, float log_std, float inv_var) {
  const float q = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, diff), diff), inv_var);
  return __fsub_rn(__fsub_rn(q, log_std), kHalfLog2Pi);
}

// SquashedNormal: a squashed action clipped to 1 - eps before the atanh.
__device__ __forceinline__ float squash_clip(float a) {
  return fminf(fmaxf(a, -1.0f + kSquashEps), 1.0f - kSquashEps);
}

// atanh of a clipped action through log1p.
__device__ __forceinline__ float clipped_atanh(float c) {
  return 0.5f * (log1pf(c) - log1pf(-c));
}

// The tanh log-det term of a clipped action.
__device__ __forceinline__ float squash_log_det(float c) {
  return logf(__fadd_rn(__fsub_rn(1.0f, __fmul_rn(c, c)), kSquashEps));
}

// The base log-prob clamped to +-100, as SquashedNormal clamps it.
__device__ __forceinline__ float clamp100(float x) { return fminf(fmaxf(x, -100.0f), 100.0f); }

}  // namespace
}  // namespace rl8

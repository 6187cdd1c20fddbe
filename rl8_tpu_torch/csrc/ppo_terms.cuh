// The per-sample PPO terms of the update kernels (ppo.cu, rnn_ppo.cu): the
// distribution's log-prob (and entropy) from the heads' outputs, the
// dual-clipped surrogate and the clamped smooth-L1 value loss with
// rl8_tpu_torch/ops/fused_ppo.py:_policy_grad_terms / _vf_grad_terms' boundary
// conventions (take1 = surr1 <= surr2, a strict in_clip interval, the
// dual-clip gate clip1 >= dual * adv, the strict sl1 < vf_clip), and the
// heads' cotangents, written in place of their outputs.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "distmath.cuh"

namespace rl8 {
namespace {  // each including source gets its own copy

// What the terms of one sample read: the columns of its packed row (the
// recurrent kernel shifts them to each step of a sequence) and the loss's
// constants.
struct LossDims {
  int act_col, logp_col, adv_col, ret_col;
  int kind, act_dim, n_cat;
  float clip_lo, clip_hi, dual, vf_clip, vf_scale, scale;
  int use_entropy;
};

// The dual-clipped surrogate of one sample: writes its policy and kl
// elements to v[0] and v[3] and returns u, the loss's cotangent on new_logp.
__device__ __forceinline__ float surrogate(const int* row, float new_logp, float* v, const LossDims& d) {
  const float old_logp = __int_as_float(row[d.logp_col]);
  const float adv = __int_as_float(row[d.adv_col]);
  const float lr = new_logp - old_logp;
  const float r = expf(lr);
  const float rc = fminf(fmaxf(r, d.clip_lo), d.clip_hi);
  const float surr1 = adv * r;
  const float surr2 = adv * rc;
  const float clip1 = fminf(surr1, surr2);
  const bool in_clip = r > d.clip_lo && r < d.clip_hi;
  const float dclip1 = surr1 <= surr2 ? adv : (in_clip ? adv : 0.0f);
  float pol = clip1, delem = dclip1;
  if (d.dual != 0.0f) {
    const float dual_adv = d.dual * adv;
    if (adv < 0.0f) {
      pol = fmaxf(clip1, dual_adv);
      delem = clip1 >= dual_adv ? dclip1 : 0.0f;
    }
  }
  v[0] = pol;
  v[3] = (r - 1.0f) - lr;
  return -d.scale * delem * r;
}

// One sample's categorical policy terms: z holds its logits [A * n] and gets
// dlogits. Writes its policy, entropy and kl elements to v[0], v[2], v[3].
__device__ __forceinline__ void policy_row(const int* row, float* z, float* v, const LossDims& d, float ec_scale) {
  const int n = d.n_cat;
  const int A = d.act_dim;
  float new_logp = 0.0f, ent = 0.0f;
  for (int a = 0; a < A; ++a) {
    const float* zg = z + a * n;
    float m = zg[0];
    for (int c = 1; c < n; ++c) m = fmaxf(m, zg[c]);
    float s = 0.0f;
    for (int c = 0; c < n; ++c) s += expf(zg[c] - m);
    const float lse = m + logf(s);
    const int action = row[d.act_col + a];
    float chosen = 0.0f, h = 0.0f;
    for (int c = 0; c < n; ++c) {
      const float lp = zg[c] - lse;
      if (c == action) chosen = lp;
      if (d.use_entropy) h -= expf(lp) * lp;
    }
    new_logp += chosen;
    ent += h;
  }
  const float u = surrogate(row, new_logp, v, d);
  // Second pass: dlogits in place, group by group.
  for (int a = 0; a < A; ++a) {
    float* zg = z + a * n;
    float m = zg[0];
    for (int c = 1; c < n; ++c) m = fmaxf(m, zg[c]);
    float s = 0.0f;
    for (int c = 0; c < n; ++c) s += expf(zg[c] - m);
    const float lse = m + logf(s);
    float h = 0.0f;
    if (d.use_entropy) {
      for (int c = 0; c < n; ++c) {
        const float lp = zg[c] - lse;
        h -= expf(lp) * lp;
      }
    }
    const int action = row[d.act_col + a];
    for (int c = 0; c < n; ++c) {
      const float lp = zg[c] - lse;
      const float p = expf(lp);
      float dz = u * ((c == action ? 1.0f : 0.0f) - p);
      if (d.use_entropy) dz += ec_scale * p * (lp + h);
      zg[c] = dz;
    }
  }
  v[2] = ent;
}

// One dim of a continuous sample: log_std and inv_var from the pre-tanh
// head, diff (x - mean, or through the clipped atanh when squashed), the base
// log-prob, and the squashed action's log-det term.
struct DimTerms {
  float log_std, inv_var, diff, base, log_det;
};

__device__ __forceinline__ DimTerms dim_terms(float x, float mean, float pre, bool squashed) {
  DimTerms t;
  t.log_std = tanhf(pre);
  t.inv_var = expf(-2.0f * t.log_std);
  t.log_det = 0.0f;
  if (squashed) {
    const float c = squash_clip(x);
    t.diff = clipped_atanh(c) - mean;
    t.log_det = squash_log_det(c);
  } else {
    t.diff = x - mean;
  }
  t.base = normal_per_dim_logp(t.diff, t.log_std, t.inv_var);
  return t;
}

// One sample's continuous policy terms: z holds its [mean | pre-tanh
// log-std] heads [2A] and gets their cotangents. Writes its policy, entropy
// and kl elements to v[0], v[2], v[3].
__device__ __forceinline__ void continuous_row(const int* row, float* z, float* v, const LossDims& d,
                                               float ec_scale) {
  const int A = d.act_dim;
  const bool squashed = d.kind == kSquashed;
  float logp_sum = 0.0f, det_sum = 0.0f, ent = 0.0f;
  for (int a = 0; a < A; ++a) {
    const DimTerms t = dim_terms(__int_as_float(row[d.act_col + a]), z[a], z[A + a], squashed);
    logp_sum += squashed ? clamp100(t.base) : t.base;
    det_sum += t.log_det;
    if (d.use_entropy) ent += kNormalEntropy + t.log_std;
  }
  const float u = surrogate(row, squashed ? logp_sum - det_sum : logp_sum, v, d);
  for (int a = 0; a < A; ++a) {
    const DimTerms t = dim_terms(__int_as_float(row[d.act_col + a]), z[a], z[A + a], squashed);
    // d new_logp / d mean = diff inv_var; / d log_std = diff^2 inv_var - 1;
    // the +-100 clamp cuts both where the base log-prob lies outside it.
    const float gate = !squashed || (t.base > -100.0f && t.base < 100.0f) ? 1.0f : 0.0f;
    const float dmean = u * (t.diff * t.inv_var) * gate;
    float dlog_std = u * (t.diff * t.diff * t.inv_var - 1.0f) * gate;
    if (d.use_entropy) dlog_std -= ec_scale;
    z[a] = dmean;
    z[A + a] = dlog_std * (1.0f - t.log_std * t.log_std);
  }
  v[2] = ent;
}

// One sample's value terms: z[0] holds its value and gets dv; v[1] gets the
// clamped smooth-L1 element.
__device__ __forceinline__ void value_row(const int* row, float* z, float* v, const LossDims& d) {
  const float diff = z[0] - __int_as_float(row[d.ret_col]);
  const float ad = fabsf(diff);
  const float sl1 = ad < 1.0f ? 0.5f * diff * diff : ad - 0.5f;
  const float sign = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
  const float dsl1 = ad < 1.0f ? diff : sign;
  v[1] = fminf(fmaxf(sl1, 0.0f), d.vf_clip);
  z[0] = (sl1 < d.vf_clip ? dsl1 : 0.0f) * d.vf_scale;
}

}  // namespace
}  // namespace rl8

// Discrete act kernel: one rollout step of the default discrete model.
//
// Replaces rl8_tpu/ops/fused_act.py:_discrete_act_kernel (the Pallas TPU
// kernel). For every row of obs [B, d_in] it computes, in one launch:
//   - the twin-chain forward of DefaultDiscreteModel
//     (fused_mlp._forward_block): each chain is h = act(h @ W + b) per
//     hidden layer, then a linear head; the policy chain's head gives
//     logits [A * n], the value chain's head gives the value;
//   - a log-softmax per categorical group, z - (max + log(sum(exp(z - max))))
//     (distmath.log_softmax_rows, the one logp formula of the port);
//   - Gumbel-argmax sampling per group (argmax of the log-probs when
//     deterministic), one int32 action column per group;
//   - the chosen log-probs summed over groups in group order, and the value.
//
// Bound on an H100 SXM: the forward is 2 * B * (d_in*H + H*H + H*(A*n+1))
// FLOP for two hidden layers of width H, 2.17 GFLOP at B=8192, d_in=1,
// H=256, against ~0.6 MB of parameters and I/O, so f32 CUDA-core FMAs
// bound it: ~32 us at 67 TFLOP/s.
//
// Design. A block of 256 threads owns kRows=16 rows and keeps their
// activations in shared memory (two ping-pong buffers of [16, H]). The
// TPU kernel keeps every weight resident in VMEM; here a 256x256 f32 weight
// (256 KB) is larger than a block's shared memory, so weights stream from
// L2 (the whole parameter set is ~0.53 MB of the 50 MB L2). Weights are
// packed [in, out] so that thread j reads column j: the 32 threads of a
// warp read 32 consecutive floats, and each weight read feeds 16 FMAs
// (one per row) against shared-memory activations that the warp reads as
// 16-byte broadcasts. 16 rows rather than 32 or 8: at B=8192 it gives 512
// blocks, enough resident warps to hide the L2 latency of the weight reads,
// while 8 rows doubles the weight reads (PERF.md has the measurements).
// Narrow heads (A*n logits, 1 value) are warp dot products with shuffle
// reductions, as the TPU kernel runs them as lane reductions.
// Everything is f32 end to end (no tensor cores), so logp and values agree
// with the plain PyTorch version to f32 rounding.
//
// Random numbers: counter-based Philox4x32-10 keyed by the per-step
// (seed, offset) that the wrapper draws from the algorithm's generator,
// counted by (row, group, category, 0), so draws do not depend on the
// block size. Word 0's top 23 bits scaled by 2^-23 and clamped to >= 1e-7
// give the uniform (the TPU kernel's construction); the Gumbel term is
// -log(-log(u)). ops/distmath.py:philox_uniform is the same generator in
// PyTorch, so the plain version can replay a launch's draws exactly.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mlp.cuh"

namespace {

using rl8::dense_layer;
using rl8::kRows;
using rl8::narrow_head;

constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;

struct ActDims {
  int d_in;
  int n_layers;
  int n_logits;
  int n_cat;
  int act;  // 0: relu, 1: tanh
  int max_hidden;
  int hidden[kMaxLayers];
};

__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1, uint32_t c2,
                                                 uint32_t c3, uint32_t k0, uint32_t k1) {
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
  return c0;
}

__global__ void __launch_bounds__(kThreads)
    discrete_act_kernel(const float* __restrict__ obs, const float* __restrict__ params,
                        int* __restrict__ actions, float* __restrict__ logp,
                        float* __restrict__ values, int B, ActDims d, uint32_t seed,
                        uint32_t offset, int deterministic) {
  extern __shared__ float smem[];
  const int A = d.n_logits / d.n_cat;
  const int head_stride = d.n_logits + 1;
  float* xs = smem;                              // [kRows, d_in]
  float* h0 = xs + kRows * d.d_in;               // [kRows, max_hidden]
  float* h1 = h0 + kRows * d.max_hidden;         // [kRows, max_hidden]
  float* heads = h1 + kRows * d.max_hidden;      // [kRows, n_logits + 1]
  float* chosen = heads + kRows * head_stride;   // [kRows, A]

  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, B - r0);
  for (int i = threadIdx.x; i < kRows * d.d_in; i += blockDim.x) {
    xs[i] = (i / d.d_in) < nr ? obs[(size_t)r0 * d.d_in + i] : 0.0f;
  }
  __syncthreads();

  // Chain 0 is the policy torso + logits head, chain 1 the value torso +
  // value head; params hold each layer's W [in, out] then b [out].
  const float* p = params;
  for (int chain = 0; chain < 2; ++chain) {
    const float* cur = xs;
    int cur_w = d.d_in;
    for (int l = 0; l < d.n_layers; ++l) {
      const int out_w = d.hidden[l];
      float* dst = (l & 1) ? h1 : h0;
      dense_layer<kRows>(cur, cur_w, p, p + cur_w * out_w, dst, out_w, d.act);
      p += cur_w * out_w + out_w;
      __syncthreads();
      cur = dst;
      cur_w = out_w;
    }
    const int n_out = chain == 0 ? d.n_logits : 1;
    narrow_head<kRows>(cur, cur_w, p, p + cur_w * n_out, n_out, heads, head_stride,
                chain == 0 ? 0 : d.n_logits);
    p += cur_w * n_out + n_out;
    __syncthreads();
  }

  for (int t = threadIdx.x; t < nr * A; t += blockDim.x) {
    const int r = t / A;
    const int a = t % A;
    const float* z = heads + r * head_stride + a * d.n_cat;
    float m = z[0];
    for (int c = 1; c < d.n_cat; ++c) m = fmaxf(m, z[c]);
    float s = 0.0f;
    for (int c = 0; c < d.n_cat; ++c) s += expf(z[c] - m);
    const float lse = m + logf(s);
    int best = 0;
    float best_score = -INFINITY;
    float best_lp = z[0] - lse;
    for (int c = 0; c < d.n_cat; ++c) {
      const float lp = z[c] - lse;
      float score = lp;
      if (!deterministic) {
        const uint32_t bits = philox_word0((uint32_t)(r0 + r), (uint32_t)a, (uint32_t)c, 0u,
                                           seed, offset);
        const float u = fmaxf(__uint2float_rn(bits >> 9) * 1.1920928955078125e-7f, 1e-7f);
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
    values[r0 + r] = heads[r * head_stride + d.n_logits];
  }
}

}  // namespace

extern "C" int rl8_discrete_act(const float* obs, const float* params, int* actions, float* logp,
                                float* values, int B, int d_in, int n_layers, const int* hidden,
                                int n_logits, int n_cat, int act, unsigned int seed,
                                unsigned int offset, int deterministic, int device,
                                void* stream) {
  if (B <= 0 || d_in <= 0 || n_layers < 1 || n_layers > kMaxLayers || n_cat <= 0 ||
      n_logits % n_cat != 0 || (act != 0 && act != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ActDims d;
  d.d_in = d_in;
  d.n_layers = n_layers;
  d.n_logits = n_logits;
  d.n_cat = n_cat;
  d.act = act;
  d.max_hidden = 0;
  for (int l = 0; l < kMaxLayers; ++l) {
    d.hidden[l] = l < n_layers ? hidden[l] : 0;
    if (d.hidden[l] > d.max_hidden) d.max_hidden = d.hidden[l];
  }
  const size_t smem = sizeof(float) * (size_t)kRows *
                      (d_in + 2 * d.max_hidden + (n_logits + 1) + n_logits / n_cat);
  err = cudaFuncSetAttribute(discrete_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kRows - 1) / kRows;
  discrete_act_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      obs, params, actions, logp, values, B, d, seed, offset, deterministic);
  return (int)cudaGetLastError();
}

// Act kernels: one rollout step of a default model, in one launch.
//
// discrete_act_kernel replaces rl8_tpu/ops/fused_act.py:_discrete_act_kernel
// (the Pallas TPU kernel). For every row of obs [B, d_in] it computes:
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
// continuous_act_kernel replaces fused_act.py:_continuous_act_kernel for
// DefaultContinuousModel with Normal or SquashedNormal
// (distmath.sample_continuous_actions): the same twin-chain forward, whose
// policy chain has two heads (mean and pre-tanh log-std, A wide each), then
// per row and action dim log_std = tanh(head), a Box-Muller normal draw,
// a = mean + std * noise (mean when deterministic), a = tanh(a) when
// squashed, the log-prob (of the squashed action through the clipped atanh
// and the +-100 clamp when squashed; distmath.cuh), summed over dims in
// order, and the value.
//
// Bound on an H100 SXM: the forward is 2 * B * (d_in*H + H*H + H*(heads+1))
// FLOP for two hidden layers of width H, 2.17 GFLOP at B=8192, d_in=1,
// H=256 (2 logits, or a mean and a log-std of A = 1), against ~0.6 MB of
// parameters and I/O, so f32 CUDA-core FMAs bound it: ~32 us at 67
// TFLOP/s. The continuous epilogue adds ~20 transcendentals per row and
// dim, under 1% of that.
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
// Sampling and its Philox random numbers are sample.cuh's, shared with
// rnn_act.cu.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "distmath.cuh"
#include "mlp.cuh"
#include "sample.cuh"

namespace {

using rl8::dense_layer;
using rl8::kRows;
using rl8::narrow_head;

constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;

struct ActDims {
  int d_in;
  int n_layers;
  int act;  // 0: relu, 1: tanh
  int max_hidden;
  int hidden[kMaxLayers];
  int n_heads;  // heads of the policy chain: 1 (logits) or 2 (mean, log-std)
  int head_w;   // width of each: A * n logits, or A
};

// Shared memory of a block: xs [kRows, d_in], two ping-pong activation
// buffers [kRows, max_hidden], and the heads [kRows, n_heads * head_w + 1]
// (the policy heads, then the value).
__device__ __forceinline__ int head_stride(const ActDims& d) { return d.n_heads * d.head_w + 1; }

// Loads the block's rows of obs and runs both chains' forward: chain 0 is
// the policy torso and its heads, chain 1 the value torso and value head;
// params hold each layer's W [in, out] then b [out]. Returns the heads.
__device__ float* twin_forward(const float* __restrict__ obs, const float* __restrict__ params,
                               int r0, int nr, const ActDims& d, float* smem) {
  float* xs = smem;
  float* h0 = xs + kRows * d.d_in;
  float* h1 = h0 + kRows * d.max_hidden;
  float* heads = h1 + kRows * d.max_hidden;
  const int stride = head_stride(d);
  for (int i = threadIdx.x; i < kRows * d.d_in; i += blockDim.x) {
    xs[i] = (i / d.d_in) < nr ? obs[(size_t)r0 * d.d_in + i] : 0.0f;
  }
  __syncthreads();
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
    const int n_heads = chain == 0 ? d.n_heads : 1;
    const int n_out = chain == 0 ? d.head_w : 1;
    for (int j = 0; j < n_heads; ++j) {
      narrow_head<kRows>(cur, cur_w, p, p + cur_w * n_out, n_out, heads, stride,
                         chain == 0 ? j * n_out : stride - 1);
      p += cur_w * n_out + n_out;
    }
    __syncthreads();
  }
  return heads;
}

__global__ void __launch_bounds__(kThreads)
    discrete_act_kernel(const float* __restrict__ obs, const float* __restrict__ params,
                        int* __restrict__ actions, float* __restrict__ logp,
                        float* __restrict__ values, int B, ActDims d, int n_cat, uint32_t seed,
                        uint32_t offset, int deterministic) {
  extern __shared__ float smem[];
  const int A = d.head_w / n_cat;
  const int stride = head_stride(d);
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, B - r0);
  const float* heads = twin_forward(obs, params, r0, nr, d, smem);
  float* chosen = smem + kRows * (d.d_in + 2 * d.max_hidden + stride);  // [kRows, A]
  rl8::categorical_epilogue(heads, stride, r0, nr, A, n_cat, seed, offset, deterministic, actions, logp,
                            values, chosen);
}

__global__ void __launch_bounds__(kThreads)
    continuous_act_kernel(const float* __restrict__ obs, const float* __restrict__ params,
                          float* __restrict__ actions, float* __restrict__ logp,
                          float* __restrict__ values, int B, ActDims d, int squashed,
                          uint32_t seed, uint32_t offset, int deterministic) {
  extern __shared__ float smem[];
  const int A = d.head_w;
  const int stride = head_stride(d);
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, B - r0);
  const float* heads = twin_forward(obs, params, r0, nr, d, smem);
  // [kRows, 2A]: each dim's (clamped, when squashed) base log-prob, then
  // its tanh log-det term.
  float* parts = smem + kRows * (d.d_in + 2 * d.max_hidden + stride);
  rl8::continuous_epilogue(heads, stride, r0, nr, A, squashed, seed, offset, deterministic, actions, logp,
                           values, parts);
}

// The dims of a launch, or false if the kernels do not take them.
bool make_dims(int B, int d_in, int n_layers, const int* hidden, int act, int n_heads, int head_w,
               ActDims* d) {
  if (B <= 0 || d_in <= 0 || n_layers < 1 || n_layers > kMaxLayers || head_w <= 0 ||
      (act != 0 && act != 1)) {
    return false;
  }
  d->d_in = d_in;
  d->n_layers = n_layers;
  d->act = act;
  d->n_heads = n_heads;
  d->head_w = head_w;
  d->max_hidden = 0;
  for (int l = 0; l < kMaxLayers; ++l) {
    d->hidden[l] = l < n_layers ? hidden[l] : 0;
    if (l < n_layers && d->hidden[l] <= 0) return false;
    if (d->hidden[l] > d->max_hidden) d->max_hidden = d->hidden[l];
  }
  return true;
}

// Floats of shared memory: xs, two activation buffers, the heads and
// `extra` floats per row.
size_t smem_bytes(const ActDims& d, int extra) {
  return sizeof(float) * (size_t)kRows *
         (d.d_in + 2 * d.max_hidden + d.n_heads * d.head_w + 1 + extra);
}

}  // namespace

extern "C" int rl8_discrete_act(const float* obs, const float* params, int* actions, float* logp,
                                float* values, int B, int d_in, int n_layers, const int* hidden,
                                int n_logits, int n_cat, int act, unsigned int seed,
                                unsigned int offset, int deterministic, int device,
                                void* stream) {
  ActDims d;
  if (n_cat <= 0 || n_logits % n_cat != 0 ||
      !make_dims(B, d_in, n_layers, hidden, act, 1, n_logits, &d)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(d, n_logits / n_cat);
  err = cudaFuncSetAttribute(discrete_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kRows - 1) / kRows;
  discrete_act_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      obs, params, actions, logp, values, B, d, n_cat, seed, offset, deterministic);
  return (int)cudaGetLastError();
}

extern "C" int rl8_continuous_act(const float* obs, const float* params, float* actions,
                                  float* logp, float* values, int B, int d_in, int n_layers,
                                  const int* hidden, int action_dim, int act, int squashed,
                                  unsigned int seed, unsigned int offset, int deterministic,
                                  int device, void* stream) {
  ActDims d;
  if (!make_dims(B, d_in, n_layers, hidden, act, 2, action_dim, &d)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(d, 2 * action_dim);
  err = cudaFuncSetAttribute(continuous_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kRows - 1) / kRows;
  continuous_act_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      obs, params, actions, logp, values, B, d, squashed, seed, offset, deterministic);
  return (int)cudaGetLastError();
}

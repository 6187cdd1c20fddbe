// Recurrent act kernel: one rollout step of a default recurrent model, in one
// launch.
//
// Replaces rl8_tpu/ops/fused_rnn_act.py:_kernel (the Pallas TPU kernel). For
// every row of obs [B, d_in] with its states h, c [B, K * H] it computes:
//   - K stacked LSTM cells (flax OptimizedLSTMCell): per layer z = x Wi +
//     h Wh + b, sigmoid on the i, f, o gates and tanh on g, c' = f c + i g,
//     h' = o tanh(c'); layer l + 1 reads layer l's h'; h' and c' of every
//     layer are the new states;
//   - the heads on the top layer's h': logits [A * n] (Categorical) or the
//     mean and the pre-tanh log-std [A each] (Normal, SquashedNormal), and
//     the value;
//   - the sampling, sample.cuh's epilogues (the act kernels' own, so that
//     ops/fused_rnn_act.py:rnn_act_plain replays the Philox draws of a
//     launch draw for draw).
// One body holds both branches, as the TPU kernel does; the branch is a
// template argument.
//
// Bound on an H100 SXM at the main path (B = 8192, d_in = 1, K = 1, H =
// 256): 2 * B * (d_in + H) * 4H = 4.3 GFLOP of f32 FMAs per launch against
// ~35 MB of states, observations, parameters and outputs, so the f32
// CUDA-core FMAs bound it: ~0.064 ms at 67 TFLOP/s.
//
// Design (lstm.cuh): a block of 256 threads owns kRows = 16 rows; thread j
// owns hidden unit j and computes its four gate columns, so the cell update
// happens in registers and c never passes through shared memory. The
// layer's input and previous hidden state lie in shared memory (two
// ping-pong input buffers, so a layer's h' can be written while the others
// still read its input). The TPU kernel holds the weights in VMEM; Wh alone
// is 1 MB at H = 256, so here weights stream from L2, each read feeding 16
// FMAs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "distmath.cuh"
#include "lstm.cuh"
#include "mlp.cuh"
#include "sample.cuh"

namespace {

using rl8::kCategorical;
using rl8::kRows;
using rl8::kSquashed;
using rl8::narrow_head;

constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;

struct RnnActDims {
  int d_in, H, K, act_dim, n_cat;
  int n_heads;  // policy heads: 1 (logits) or 2 (mean, pre-tanh log-std)
  int head_w;   // each policy head's width: A * n, or A
  int stride;   // n_heads * head_w + 1: the heads' row, the value last
  int xw;       // max(d_in, H): a layer input's width
};

// Floats of shared memory: two layer inputs, the previous hidden state, the
// heads and the sampling scratch (2A per row).
size_t smem_floats(const RnnActDims& d) {
  return (size_t)kRows * (2 * d.xw + d.H + d.stride + 2 * d.act_dim);
}

template <bool kContinuous>
__global__ void __launch_bounds__(kThreads)
    rnn_act_kernel(const float* __restrict__ obs, const float* __restrict__ h0, const float* __restrict__ c0,
                   const float* __restrict__ params, void* __restrict__ actions, float* __restrict__ logp,
                   float* __restrict__ values, float* __restrict__ h_out, float* __restrict__ c_out, int B,
                   RnnActDims d, int squashed, uint32_t seed, uint32_t offset, int deterministic) {
  extern __shared__ __align__(16) float smem[];
  const int H = d.H;
  const int KH = d.K * H;
  float* cur = smem;                    // [kRows, in_w]: the layer's input
  float* nxt = cur + kRows * d.xw;      // [kRows, H]: its output, the next layer's input
  float* hp = nxt + kRows * d.xw;       // [kRows, H]: the layer's previous hidden state
  float* heads = hp + kRows * H;        // [kRows, stride]
  float* scratch = heads + kRows * d.stride;  // [kRows, 2A]
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, B - r0);

  int in_w = d.d_in;
  for (int i = threadIdx.x; i < kRows * in_w; i += blockDim.x) {
    cur[i] = (i / in_w) < nr ? obs[(size_t)r0 * in_w + i] : 0.0f;
  }
  const float* p = params;
  for (int l = 0; l < d.K; ++l) {
    for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
      const int r = i / H;
      hp[i] = r < nr ? h0[(size_t)(r0 + r) * KH + l * H + i % H] : 0.0f;
    }
    __syncthreads();
    const float* wi = p;
    const float* wh = wi + (size_t)in_w * 4 * H;
    const float* b = wh + (size_t)H * 4 * H;
    p = b + 4 * H;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float z[4][kRows];
      rl8::lstm_preact<kRows>(cur, in_w, hp, wi, wh, b, H, j, z);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        rl8::gate_activations(z[0][r], z[1][r], z[2][r], z[3][r]);
        const size_t at = (size_t)(r0 + r) * KH + l * H + j;
        const float c_prev = r < nr ? c0[at] : 0.0f;
        const float c = z[1][r] * c_prev + z[0][r] * z[2][r];
        const float h = z[3][r] * tanhf(c);
        if (r < nr) {
          h_out[at] = h;
          c_out[at] = c;
        }
        nxt[r * H + j] = h;
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    in_w = H;
  }
  // Heads on the top layer's h' (cur): the policy heads side by side, then
  // the value in the last column.
  for (int q = 0; q <= d.n_heads; ++q) {
    const int w = q < d.n_heads ? d.head_w : 1;
    narrow_head<kRows>(cur, H, p, p + (size_t)H * w, w, heads, d.stride, q < d.n_heads ? q * w : d.stride - 1);
    p += (size_t)H * w + w;
  }
  __syncthreads();
  if constexpr (kContinuous) {
    rl8::continuous_epilogue(heads, d.stride, r0, nr, d.act_dim, squashed, seed, offset, deterministic,
                             static_cast<float*>(actions), logp, values, scratch);
  } else {
    rl8::categorical_epilogue(heads, d.stride, r0, nr, d.act_dim, d.n_cat, seed, offset, deterministic,
                              static_cast<int*>(actions), logp, values, scratch);
  }
}

}  // namespace

// kind: 0 categorical (actions int32 [B, A]), 1 normal, 2 squashed (actions
// f32 [B, A]). h0, c0, h_out, c_out are [B, K * H]; params are laid out as
// ops/fused_rnn_act.py:RnnParams.
extern "C" int rl8_rnn_act(const float* obs, const float* h0, const float* c0, const float* params,
                           void* actions, float* logp, float* values, float* h_out, float* c_out, int B,
                           int d_in, int H, int K, int kind, int act_dim, int n_cat, unsigned int seed,
                           unsigned int offset, int deterministic, int device, void* stream) {
  if (B <= 0 || d_in <= 0 || H <= 0 || K < 1 || K > kMaxLayers || act_dim <= 0 || kind < kCategorical ||
      kind > kSquashed || (kind == kCategorical && n_cat < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  RnnActDims d;
  d.d_in = d_in;
  d.H = H;
  d.K = K;
  d.act_dim = act_dim;
  d.n_cat = n_cat;
  d.n_heads = kind == kCategorical ? 1 : 2;
  d.head_w = kind == kCategorical ? act_dim * n_cat : act_dim;
  d.stride = d.n_heads * d.head_w + 1;
  d.xw = d_in > H ? d_in : H;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * smem_floats(d);
  const auto kernel = kind == kCategorical ? rnn_act_kernel<false> : rnn_act_kernel<true>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kRows - 1) / kRows;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(obs, h0, c0, params, actions, logp, values, h_out,
                                                        c_out, B, d, (int)(kind == kSquashed), seed, offset,
                                                        deterministic);
  return (int)cudaGetLastError();
}

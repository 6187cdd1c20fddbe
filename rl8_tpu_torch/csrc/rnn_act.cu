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
// 256): 2 * B * (d_in + H) * 4H = 4.3 GFLOP per launch against ~35 MB of
// states, observations, parameters and outputs, so the products bound it:
// ~0.064 ms at the CUDA cores' 67 TFLOP/s f32, ~0.026 ms at three TF32
// products per f32 product at the tensor cores' 495 TFLOP/s.
//
// Design. A block of 256 threads owns a tile of 16 * MT rows (MT = 2 where
// the tile fits two blocks to an SM, else 1: the two instantiations, chosen
// by shape at launch). The gate products run on the tensor cores through
// mma.cuh's 3xTF32 (f32-accurate per product; each k step of 8 in a fresh
// accumulator, so the tensor core's truncation does not build up over the
// 257-deep sums). Warp w owns hidden-unit tiles w, w + 8, ... of 8 units,
// and for each computes the unit tile's four gate columns (i, f, g, o) for
// every row of the block, so lane (g, tq) holds all four gates of its
// (row, unit) pairs in its accumulator fragments and the cell update runs
// there, with no pass through shared memory. Each weight is read from L2
// once per block (the 16-row blocks of the first design read Wi, Wh and b,
// 1.06 MB at H = 256, once per 16 rows: ~540 MB of L2 traffic a launch),
// as B fragments in place, two k steps ahead of the products. The layer's
// input and previous hidden state lie in shared memory, their rows padded
// to 4 past a multiple of 32 so that the A fragment loads are free of bank
// conflicts (unpadded where padding would not fit: the widest layers). The
// narrow heads and the sampling stay on the CUDA cores.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "distmath.cuh"
#include "lstm.cuh"
#include "mlp.cuh"
#include "mma.cuh"
#include "sample.cuh"

namespace {

using rl8::FragA;
using rl8::FragB;
using rl8::kCategorical;
using rl8::kSquashed;
using rl8::narrow_head;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 8;
constexpr size_t kMaxSmem = 232448;       // a block's shared memory on an H100
constexpr size_t kTwoBlocksSmem = 113 * 1024;  // two blocks to an SM
constexpr int kAhead = 2;  // k steps of weights in flight ahead of the products

struct RnnActDims {
  int d_in, H, K, act_dim, n_cat;
  int n_heads;  // policy heads: 1 (logits) or 2 (mean, pre-tanh log-std)
  int head_w;   // each policy head's width: A * n, or A
  int stride;   // n_heads * head_w + 1: the heads' row, the value last
  int ldx;      // row stride of a layer input: max(d_in, H), padded
  int ldh;      // row stride of the previous hidden state: H, padded
};

// Floats of shared memory for 16 * mt rows: two layer inputs, the previous
// hidden state, the heads and the sampling scratch (2A per row).
size_t smem_floats(const RnnActDims& d, int mt) {
  return (size_t)16 * mt * (2 * d.ldx + d.ldh + d.stride + 2 * d.act_dim);
}

// acc[mt][q] += A[rows of m tile mt, k < K] W[k, q H + units u0 .. u0 + 7]
// for the four gates q, on the tensor cores: A in shared memory (rows lda
// apart), W [K, 4H] row-major in device memory, read as B fragments in
// place kAhead k steps ahead. Units at or past H and k at or past K read 0.
template <int MT>
__device__ __forceinline__ void gate_tile(float (&acc)[MT][4][4], const float* A, int lda, int K,
                                          const float* __restrict__ W, int H, int u0) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const size_t ldw = 4 * (size_t)H;
  const int u = u0 + g;
  const bool in_units = u < H;
  auto fetch = [&](int kb, float (&bn)[4][2]) {
    const int k = kb + tq;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* w = W + (size_t)k * ldw + (size_t)q * H + u;
      bn[q][0] = in_units && k < K ? __ldg(w) : 0.0f;
      bn[q][1] = in_units && k + 4 < K ? __ldg(w + 4 * ldw) : 0.0f;
    }
  };
  // kAhead k steps a pass, each from its B values, which then take those
  // of the step kAhead ahead.
  float bn[kAhead][4][2];
#pragma unroll
  for (int s = 0; s < kAhead; ++s) fetch(8 * s, bn[s]);
  for (int kb = 0; kb < K; kb += 8 * kAhead) {
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const int ks = kb + 8 * s;
      if (ks >= K) break;
      FragB fb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) fb[q].set(bn[s][q][0], bn[s][q][1]);
      if (ks + 8 * kAhead < K) fetch(ks + 8 * kAhead, bn[s]);
      const int k = ks + tq;
      const bool lo = k < K, hi = k + 4 < K;
      FragA fa[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* a = A + (mt * 16 + g) * lda + k;
        fa[mt].set(lo ? a[0] : 0.0f, lo ? a[8 * lda] : 0.0f, hi ? a[4] : 0.0f, hi ? a[8 * lda + 4] : 0.0f);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) rl8::mma_3xtf32(acc[mt][q], fa[mt], fb[q]);
    }
  }
}

template <int MT, bool kContinuous>
__global__ void __launch_bounds__(kThreads, 2)
    rnn_act_kernel(const float* __restrict__ obs, const float* __restrict__ h0, const float* __restrict__ c0,
                   const float* __restrict__ params, void* __restrict__ actions, float* __restrict__ logp,
                   float* __restrict__ values, float* __restrict__ h_out, float* __restrict__ c_out, int B,
                   RnnActDims d, int squashed, uint32_t seed, uint32_t offset, int deterministic) {
  constexpr int R = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  const int H = d.H, KH = d.K * H, ldx = d.ldx, ldh = d.ldh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  float* cur = smem;                    // [R, ldx]: the layer's input
  float* nxt = cur + R * ldx;           // [R, ldx]: its output, the next layer's input
  float* hp = nxt + R * ldx;            // [R, ldh]: the layer's previous hidden state
  float* heads = hp + R * ldh;          // [R, stride]
  float* scratch = heads + R * d.stride;  // [R, 2A]
  const int r0 = blockIdx.x * R;
  const int nr = min(R, B - r0);

  int in_w = d.d_in;
  for (int i = threadIdx.x; i < R * in_w; i += blockDim.x) {
    const int r = i / in_w;
    cur[r * ldx + i % in_w] = r < nr ? obs[(size_t)r0 * in_w + i] : 0.0f;
  }
  const float* p = params;
  for (int l = 0; l < d.K; ++l) {
    for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
      const int r = i / H;
      hp[r * ldh + i % H] = r < nr ? h0[(size_t)(r0 + r) * KH + l * H + i % H] : 0.0f;
    }
    __syncthreads();
    const float* wi = p;
    const float* wh = wi + (size_t)in_w * 4 * H;
    const float* b = wh + (size_t)H * 4 * H;
    p = b + 4 * H;
    for (int u0 = 8 * warp; u0 < H; u0 += 8 * kWarps) {
      float acc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.0f;
      gate_tile<MT>(acc, cur, ldx, in_w, wi, H, u0);
      gate_tile<MT>(acc, hp, ldh, H, wh, H, u0);
      // The cell update of the lane's (row, unit) pairs: C fragment element
      // e holds row mt 16 + g (+ 8 for e >= 2) and unit u0 + 2 tq + (e & 1).
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = u0 + 2 * tq + (e & 1);
        if (u >= H) continue;
        float bg[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) bg[q] = __ldg(b + q * H + u);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = mt * 16 + g + (e >= 2 ? 8 : 0);
          float zi = bg[0] + acc[mt][0][e], zf = bg[1] + acc[mt][1][e];
          float zg = bg[2] + acc[mt][2][e], zo = bg[3] + acc[mt][3][e];
          rl8::gate_activations(zi, zf, zg, zo);
          const size_t at = (size_t)(r0 + r) * KH + l * H + u;
          const float c_prev = r < nr ? c0[at] : 0.0f;
          const float c = zf * c_prev + zi * zg;
          const float h = zo * tanhf(c);
          if (r < nr) {
            h_out[at] = h;
            c_out[at] = c;
          }
          nxt[r * ldx + u] = h;
        }
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
    narrow_head<R>(cur, H, p, p + (size_t)H * w, w, heads, d.stride, q < d.n_heads ? q * w : d.stride - 1, ldx);
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

template <int MT>
cudaError_t launch(const RnnActDims& d, int kind, const float* obs, const float* h0, const float* c0,
                   const float* params, void* actions, float* logp, float* values, float* h_out, float* c_out,
                   int B, uint32_t seed, uint32_t offset, int deterministic, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(d, MT);
  const auto kernel = kind == kCategorical ? rnn_act_kernel<MT, false> : rnn_act_kernel<MT, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + 16 * MT - 1) / (16 * MT);
  kernel<<<grid, kThreads, smem, stream>>>(obs, h0, c0, params, actions, logp, values, h_out, c_out, B, d,
                                          (int)(kind == kSquashed), seed, offset, deterministic);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 categorical (actions int32 [B, A]), 1 normal, 2 squashed (actions
// f32 [B, A]). h0, c0, h_out, c_out are [B, K * H]; params are laid out as
// ops/fused_rnn_act.py:RnnParams. The tile is 32 rows where two such blocks
// fit an SM, else 16 rows (with padded rows where they fit a block, else
// unpadded: as wide as the first design took).
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
  const int xw = d_in > H ? d_in : H;
  d.ldx = (xw + 31) / 32 * 32 + 4;
  d.ldh = (H + 31) / 32 * 32 + 4;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (sizeof(float) * smem_floats(d, 2) <= kTwoBlocksSmem) {
    err = launch<2>(d, kind, obs, h0, c0, params, actions, logp, values, h_out, c_out, B, seed, offset,
                    deterministic, s);
  } else {
    if (sizeof(float) * smem_floats(d, 1) > kMaxSmem) {
      d.ldx = xw;
      d.ldh = H;
    }
    err = launch<1>(d, kind, obs, h0, c0, params, actions, logp, values, h_out, c_out, B, seed, offset,
                    deterministic, s);
  }
  return (int)err;
}

// Chain kernels: several activation-MLP chains that share one input x [N,
// d_in], each ending in linear heads, forward and backward.
//
// chains_fwd_kernel replaces rl8_tpu/ops/fused_mlp.py:_fwd_kernel (called by
// _call_fwd, the forward of fused_chains); chains_bwd_rows_kernel and the
// weight products below replace fused_mlp.py:_bwd_kernel (_fused_bwd, the
// recompute-based backward). Per chain, layer l computes
//   h_l = act(LN_l?(h_{l-1} @ W_l + b_l)),  h_{-1} = x,
// with flax's fast-variance LayerNorm where the layer has one: mu = mean(z),
// var = max(mean(z^2) - mu^2, 0), s = rsqrt(var + 1e-6), xhat = (z - mu) s,
// LN(z) = xhat * scale + bias; then out_j = h_{L-1} @ Wh_j + bh_j per head.
// The parameters are one flat f32 vector, per chain each layer's W [in, out],
// b, and (LayerNorm) scale and bias, then each head's W and b: fused_mlp.py's
// _flatten_params order. Each head has its own [N, hw] output; the backward
// takes each head's cotangent and returns dx [N, d_in] and the gradient of
// every parameter in the flat layout.
//
// Bound on an H100 SXM at the main path (MischievousMule: two chains of d_in
// = 7 -> 128 (LayerNorm) -> 128, heads of 3 and 1): the forward is 35,072
// multiply-adds per row, 0.29 GFLOP for a 4,096-row rollout step and 2.30
// GFLOP for a 32,768-row minibatch, against 36 bytes of input and 16 of
// output per row and ~0.14 MB of parameters: f32 FMAs bound it, 34 us at 67
// TFLOP/s for the minibatch. The backward recomputes the forward and adds the
// dh products and the weight products, ~3x the operations, and writes ~6 KB
// of scratch per row (~0.2 GB per minibatch), so it is bound by both at about
// 0.1 ms.
//
// Design. Everything is f32 on CUDA cores, as the port's other kernels.
// - Forward: a block of 256 threads owns 16 rows and walks every chain, the
//   current layer's activations in shared memory (two ping-pong buffers),
//   weights streaming from L2 (mlp.cuh's dense_layer: thread j reads column j
//   of W [in, out], coalesced). A LayerNorm is a warp per row: lane-strided
//   sums of z and z^2 reduced with an xor butterfly, in a fixed order. Heads
//   narrower than 8 are warp dot products (mlp.cuh's narrow_head), as the TPU
//   ran them as lane reductions. Rows past N are zeros in shared memory and
//   are never stored; nothing is padded in device memory.
// - Backward: the TPU kernel adds every grid step's gradients into
//   VMEM-resident accumulators over a sequential grid. CUDA blocks run in
//   parallel, so it follows ppo.cu instead:
//   1. chains_bwd_rows_kernel: a block owns 32 rows, recomputes each chain's
//      forward and writes every layer's output h_l to a device scratch
//      (LayerNorm layers also xhat, and keep s per row in shared memory).
//      Then, down the chain, da = dh * act'(h_l); through a LayerNorm dxhat =
//      da * scale and dpre = s (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
//      (warp per row); dpre_l goes to the scratch (and, for a LayerNorm, da
//      and da * xhat); dh_{l-1} = dpre_l W_l^T against a transposed copy of
//      W_l, or as warp dot products when W_l's input is narrower than 8 (the
//      7-wide first layer's dx). dx sums the chains in chain order.
//   2. The weight products dW = h_in^T dpre, db = sum(dpre) and the heads'
//      dW = h_{L-1}^T dout over all rows, and LayerNorm's dscale = sum(da *
//      xhat) and dbias = sum(da) as bias-only column sums of scratch rows:
//      wgrad.cuh's split-K jobs (128x128 tensor-core tiles for products 8 or
//      more wide, the 7-wide input's dW and the heads included; a thread per
//      column for the bias-only ones), each group of rows writing its own
//      partial.
//   3. sum_partials_kernel adds the partials in a fixed order.
//   No float atomics: two launches give the same bits.
#include <cuda_runtime.h>
#include <math.h>

#include "mlp.cuh"
#include "wgrad.cuh"

namespace {

using rl8::activate;
using rl8::dense_layer;
using rl8::Job;
using rl8::Jobs;
using rl8::kIdentity;
using rl8::kRelu;
using rl8::kTanh;
using rl8::narrow_head;

constexpr int kThreads = 256;
constexpr int kFwdRows = 16;  // rows per block of the forward
constexpr int kBwdRows = 32;  // rows per block of the backward's row pass
constexpr int kMaxChains = 4;
constexpr int kMaxLayers = 8;
constexpr int kMaxHeads = 4;
constexpr int kNarrow = 8;  // products with fewer outputs than this are warp dot products
constexpr float kLnEps = 1e-6f;
constexpr int kMaxSmem = 232448;  // shared memory a block may use on an H100
constexpr int kMaxJobs = kMaxChains * (3 * kMaxLayers + kMaxHeads);
// Rows per group of the weight products, and the most groups: a minibatch
// of 32,768 rows makes wgrad.cuh's 4,096-row groups only 8, too few blocks
// for the card, and its blocks walk their rows in a latency-bound loop of
// 32-row chunks, so the chains split much finer.
constexpr int kGroupRows = 128;
constexpr int kMaxChainGroups = 256;

// The chains' structure, the parameter offsets and, for the backward, the
// workspace offsets.
struct Chains {
  long long N;
  int d_in, act, n_chains, n_out;
  int n_layers[kMaxChains];
  int width[kMaxChains][kMaxLayers];
  int ln[kMaxChains][kMaxLayers];
  int n_heads[kMaxChains];
  int head_w[kMaxChains][kMaxHeads];
  int head_col[kMaxChains][kMaxHeads];  // each head's first column among all heads' outputs
  int chain_out[kMaxChains];            // a chain's heads' columns, which are adjacent
  float* out[kMaxChains][kMaxHeads];        // forward: each head's output [N, hw]
  const float* dout[kMaxChains][kMaxHeads];  // backward: each head's cotangent [N, hw]
  int max_w;                            // widest layer, or d_in if wider: the ping-pong buffers
  int max_chain_out;
  // Offset of each layer's W in the flat parameters (b, then a LayerNorm's
  // scale and bias follow it); index n_layers + j: head j's W.
  long long woff[kMaxChains][kMaxLayers + kMaxHeads];
  // Backward: offset in the workspace of the transposed copy of W_l used for
  // dh_{l-1} (-1 where the product is narrow), and at index n_layers the
  // chain's heads, transposed and stacked [chain_out, w_last].
  long long wt[kMaxChains][kMaxLayers + 1];
  // Backward: scratch offsets of h_l [N, w_l] and dpre_l [N, w_l], and for
  // LayerNorm layers of xhat_l (then da_l * xhat_l) and da_l, each [N, w_l].
  long long h_off[kMaxChains][kMaxLayers];
  long long dpre_off[kMaxChains][kMaxLayers];
  long long xhat_off[kMaxChains][kMaxLayers];
  long long da_off[kMaxChains][kMaxLayers];
};

struct Layout {
  Chains d;
  long long P, wt_floats, row_floats, part_floats, rows_per_group;
  int groups;
  size_t fwd_smem, bwd_smem;
};

// Parses spec = [n_chains, then per chain: n_layers, (width, ln) per layer,
// n_heads, width per head] and lays everything out; false where the kernels
// do not take the chains.
bool make_layout(long long N, int d_in, int act, const int* spec, int spec_len, Layout* L) {
  if (N <= 0 || d_in <= 0 || (act != kRelu && act != kTanh) || spec_len < 1) return false;
  Chains& d = L->d;
  d.N = N;
  d.d_in = d_in;
  d.act = act;
  int i = 0;
  auto next = [&](int* v) {
    if (i >= spec_len) return false;
    *v = spec[i++];
    return true;
  };
  if (!next(&d.n_chains) || d.n_chains < 1 || d.n_chains > kMaxChains) return false;
  long long off = 0, wt = 0, row = 0;
  d.n_out = 0;
  d.max_w = d_in;
  d.max_chain_out = 0;
  for (int c = 0; c < d.n_chains; ++c) {
    if (!next(&d.n_layers[c]) || d.n_layers[c] < 1 || d.n_layers[c] > kMaxLayers) return false;
    int in = d_in;
    for (int l = 0; l < d.n_layers[c]; ++l) {
      int w, ln;
      if (!next(&w) || !next(&ln) || w < 1 || (ln != 0 && ln != 1)) return false;
      d.width[c][l] = w;
      d.ln[c][l] = ln;
      d.max_w = w > d.max_w ? w : d.max_w;
      d.woff[c][l] = off;
      off += (long long)in * w + w + (ln ? 2LL * w : 0);
      d.wt[c][l] = in >= kNarrow ? wt : -1;
      if (in >= kNarrow) wt += (long long)in * w;
      d.h_off[c][l] = row;
      row += N * w;
      d.dpre_off[c][l] = row;
      row += N * w;
      d.xhat_off[c][l] = d.da_off[c][l] = -1;
      if (ln) {
        d.xhat_off[c][l] = row;
        row += N * w;
        d.da_off[c][l] = row;
        row += N * w;
      }
      in = w;
    }
    if (!next(&d.n_heads[c]) || d.n_heads[c] < 1 || d.n_heads[c] > kMaxHeads) return false;
    d.chain_out[c] = 0;
    for (int j = 0; j < d.n_heads[c]; ++j) {
      int hw;
      if (!next(&hw) || hw < 1) return false;
      d.head_w[c][j] = hw;
      d.head_col[c][j] = d.n_out;
      d.n_out += hw;
      d.chain_out[c] += hw;
      d.woff[c][d.n_layers[c] + j] = off;
      off += (long long)in * hw + hw;
    }
    d.wt[c][d.n_layers[c]] = wt;
    wt += (long long)in * d.chain_out[c];
    d.max_chain_out = d.chain_out[c] > d.max_chain_out ? d.chain_out[c] : d.max_chain_out;
  }
  if (i != spec_len) return false;
  L->P = off;
  L->wt_floats = wt;
  L->row_floats = row;
  long long groups = (N + kGroupRows - 1) / kGroupRows;
  groups = groups < 1 ? 1 : (groups > kMaxChainGroups ? kMaxChainGroups : groups);
  L->groups = (int)groups;
  L->rows_per_group = (N + groups - 1) / groups;
  L->part_floats = (long long)L->groups * off;
  L->fwd_smem = sizeof(float) * (size_t)kFwdRows * (d_in + 2 * d.max_w + d.n_out);
  L->bwd_smem = sizeof(float) * ((size_t)kBwdRows * (2 * d_in + 2 * d.max_w + d.max_chain_out) +
                                 (size_t)kMaxLayers * kBwdRows);
  return L->fwd_smem <= (size_t)kMaxSmem && L->bwd_smem <= (size_t)kMaxSmem;
}

// ------------------------------------------------------------ block pieces

// LayerNorm of each of the R rows of z [R, w], in place, followed by the
// activation: z = act(xhat * scale + bias). A warp per row; each lane sums
// its strided elements in order, then an xor butterfly (which leaves the same
// bits in every lane). With s_out, s goes to s_out[r] and xhat to
// xhat_out[r * w + k] for rows r < nr (xhat_out points at the block's first
// row).
template <int R>
__device__ void layer_norm_rows(float* z, int w, const float* __restrict__ scale, const float* __restrict__ bias,
                                int act, float* s_out, float* xhat_out, int nr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  for (int r = warp; r < R; r += n_warps) {
    float* row = z + r * w;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = lane; k < w; k += 32) {
      const float v = row[k];
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mu = s1 / w;
    const float s = rsqrtf(fmaxf(s2 / w - mu * mu, 0.0f) + kLnEps);
    const bool keep = xhat_out != nullptr && r < nr;
    for (int k = lane; k < w; k += 32) {
      const float xh = (row[k] - mu) * s;
      if (keep) xhat_out[(size_t)r * w + k] = xh;
      row[k] = activate(fmaf(xh, __ldg(scale + k), __ldg(bias + k)), act);
    }
    if (s_out != nullptr && lane == 0) s_out[r] = s;
  }
}

// out[r, j] = sum_k in[r, k] * Wt[j, k] for the R rows and j < J, Wt row-major
// [J, K] (so in @ Wt^T): a warp per (row, output), lanes striding over k
// (coalesced), then a shuffle reduction.
template <int R>
__device__ void narrow_bt(const float* in, int K, const float* __restrict__ Wt, float* out, int J) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  for (int p = warp; p < R * J; p += n_warps) {
    const int r = p / J, j = p % J;
    float s = 0.0f;
    for (int k = lane; k < K; k += 32) s = fmaf(in[r * K + k], __ldg(Wt + (size_t)j * K + k), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[r * J + j] = s;
  }
}

// Head j of a chain on h [R, w]: hb [R, hw] = h @ Wh + bh.
template <int R>
__device__ void head_product(const float* h, int w, const float* __restrict__ W, int hw, float* hb) {
  if (hw < kNarrow) {
    narrow_head<R>(h, w, W, W + (size_t)w * hw, hw, hb, hw, 0);
  } else {
    dense_layer<R>(h, w, W, W + (size_t)w * hw, hb, hw, kIdentity);
  }
}

// --------------------------------------------------------------- forward

__global__ void __launch_bounds__(kThreads)
    chains_fwd_kernel(const float* __restrict__ x, const float* __restrict__ params, Chains d) {
  constexpr int R = kFwdRows;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [R, d_in]
  float* ga = xs + R * d.d_in;       // [R, max_w]
  float* gb = ga + R * d.max_w;      // [R, max_w]
  float* heads = gb + R * d.max_w;   // head j of chain c: [R, hw] from R * head_col
  const long long r0 = (long long)blockIdx.x * R;
  const int nr = (int)min((long long)R, d.N - r0);
  for (int i = threadIdx.x; i < R * d.d_in; i += blockDim.x) {
    xs[i] = i < nr * d.d_in ? x[r0 * d.d_in + i] : 0.0f;
  }
  __syncthreads();
  for (int c = 0; c < d.n_chains; ++c) {
    const float* cur = xs;
    int cur_w = d.d_in;
    for (int l = 0; l < d.n_layers[c]; ++l) {
      const int w = d.width[c][l];
      float* dst = (l & 1) ? gb : ga;
      const float* W = params + d.woff[c][l];
      const float* b = W + (size_t)cur_w * w;
      dense_layer<R>(cur, cur_w, W, b, dst, w, d.ln[c][l] ? kIdentity : d.act);
      __syncthreads();
      if (d.ln[c][l]) {
        layer_norm_rows<R>(dst, w, b + w, b + 2 * w, d.act, nullptr, nullptr, nr);
        __syncthreads();
      }
      cur = dst;
      cur_w = w;
    }
    for (int j = 0; j < d.n_heads[c]; ++j) {
      head_product<R>(cur, cur_w, params + d.woff[c][d.n_layers[c] + j], d.head_w[c][j],
                      heads + R * d.head_col[c][j]);
    }
    __syncthreads();  // the next chain overwrites the buffers the heads read
  }
  for (int c = 0; c < d.n_chains; ++c) {
    for (int j = 0; j < d.n_heads[c]; ++j) {
      const int hw = d.head_w[c][j];
      const float* hb = heads + R * d.head_col[c][j];
      float* o = d.out[c][j] + r0 * hw;
      for (int i = threadIdx.x; i < nr * hw; i += blockDim.x) o[i] = hb[i];
    }
  }
}

// --------------------------------------------------------------- backward

__global__ void __launch_bounds__(kThreads)
    chains_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ params, const float* __restrict__ wt,
                           float* __restrict__ scratch, float* __restrict__ dx, Chains d) {
  constexpr int R = kBwdRows;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                      // [R, d_in]
  float* dxs = xs + R * d.d_in;          // [R, d_in]: dx summed over chains
  float* ga = dxs + R * d.d_in;          // [R, max_w]
  float* gb = ga + R * d.max_w;          // [R, max_w]
  float* douts = gb + R * d.max_w;       // [R, max_chain_out]
  float* svals = douts + R * d.max_chain_out;  // [kMaxLayers, R]: LayerNorm's s per layer and row
  const long long r0 = (long long)blockIdx.x * R;
  const int nr = (int)min((long long)R, d.N - r0);
  for (int i = threadIdx.x; i < R * d.d_in; i += blockDim.x) {
    xs[i] = i < nr * d.d_in ? x[r0 * d.d_in + i] : 0.0f;
  }
  __syncthreads();

  for (int c = 0; c < d.n_chains; ++c) {
    const int L = d.n_layers[c];
    // Forward, storing each layer's output (and a LayerNorm's xhat).
    const float* cur = xs;
    int cur_w = d.d_in;
    for (int l = 0; l < L; ++l) {
      const int w = d.width[c][l];
      float* dst = (l & 1) ? gb : ga;
      const float* W = params + d.woff[c][l];
      const float* b = W + (size_t)cur_w * w;
      dense_layer<R>(cur, cur_w, W, b, dst, w, d.ln[c][l] ? kIdentity : d.act);
      __syncthreads();
      if (d.ln[c][l]) {
        layer_norm_rows<R>(dst, w, b + w, b + 2 * w, d.act, svals + l * R,
                           scratch + d.xhat_off[c][l] + r0 * w, nr);
        __syncthreads();
      }
      float* h = scratch + d.h_off[c][l] + r0 * w;
      for (int i = threadIdx.x; i < nr * w; i += blockDim.x) h[i] = dst[i];
      cur = dst;
      cur_w = w;
    }
    // The chain's head cotangents; rows past N are zeros.
    const int n_out = d.chain_out[c];
    for (int j = 0; j < d.n_heads[c]; ++j) {
      const int hw = d.head_w[c][j], col = d.head_col[c][j] - d.head_col[c][0];
      const float* g = d.dout[c][j] + r0 * hw;
      for (int i = threadIdx.x; i < R * hw; i += blockDim.x) {
        const int r = i / hw;
        douts[r * n_out + col + i % hw] = r < nr ? g[i] : 0.0f;
      }
    }
    __syncthreads();
    // dh_{L-1} = sum over heads of dout_j Wh_j^T, one product against the
    // heads' stacked transposes.
    float* dh = (cur == ga) ? gb : ga;
    dense_layer<R>(douts, n_out, wt + d.wt[c][L], nullptr, dh, cur_w, kIdentity);
    __syncthreads();
    for (int l = L - 1; l >= 0; --l) {
      const int w = d.width[c][l];
      // This block's h_l rows, written above and visible after the barriers
      // since; rows past N have a zero dh, so their h does not matter.
      const float* h = scratch + d.h_off[c][l] + r0 * w;
      if (!d.ln[c][l]) {
        for (int i = threadIdx.x; i < R * w; i += blockDim.x) {
          const float hv = i < nr * w ? h[i] : 0.0f;
          dh[i] *= d.act == kRelu ? (hv > 0.0f ? 1.0f : 0.0f) : 1.0f - hv * hv;
        }
      } else {
        // da = dh * act'(h); dxhat = da * scale; dpre = s (dxhat - mean(dxhat)
        // - xhat mean(dxhat xhat)). A warp per row: the first sweep sums, the
        // second stores da and da * xhat (over xhat) and leaves dpre in dh.
        const float* scale = params + d.woff[c][l] + (size_t)(l == 0 ? d.d_in : d.width[c][l - 1]) * w + w;
        float* xhat = scratch + d.xhat_off[c][l] + r0 * w;
        float* da_g = scratch + d.da_off[c][l] + r0 * w;
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
        for (int r = warp; r < R; r += n_warps) {
          float* row = dh + r * w;
          const bool in_rows = r < nr;
          float m1 = 0.0f, m2 = 0.0f;
          for (int k = lane; k < w; k += 32) {
            const float hv = in_rows ? h[r * w + k] : 0.0f;
            const float xh = in_rows ? xhat[r * w + k] : 0.0f;
            const float da = row[k] * (d.act == kRelu ? (hv > 0.0f ? 1.0f : 0.0f) : 1.0f - hv * hv);
            const float dxh = da * __ldg(scale + k);
            m1 += dxh;
            m2 = fmaf(dxh, xh, m2);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            m1 += __shfl_xor_sync(0xffffffffu, m1, off);
            m2 += __shfl_xor_sync(0xffffffffu, m2, off);
          }
          m1 /= w;
          m2 /= w;
          const float s = svals[l * R + r];
          for (int k = lane; k < w; k += 32) {
            const float hv = in_rows ? h[r * w + k] : 0.0f;
            const float xh = in_rows ? xhat[r * w + k] : 0.0f;
            const float da = row[k] * (d.act == kRelu ? (hv > 0.0f ? 1.0f : 0.0f) : 1.0f - hv * hv);
            const float dxh = da * __ldg(scale + k);
            if (in_rows) {
              da_g[r * w + k] = da;
              xhat[r * w + k] = da * xh;
            }
            row[k] = s * (dxh - m1 - xh * m2);
          }
        }
      }
      __syncthreads();
      float* g = scratch + d.dpre_off[c][l] + r0 * w;
      for (int i = threadIdx.x; i < nr * w; i += blockDim.x) g[i] = dh[i];
      // dh_{l-1} = dpre_l W_l^T, or at l = 0 this chain's dx.
      const int in_w = l == 0 ? d.d_in : d.width[c][l - 1];
      float* next = dh == ga ? gb : ga;
      if (d.wt[c][l] >= 0) {
        dense_layer<R>(dh, w, wt + d.wt[c][l], nullptr, next, in_w, kIdentity);
      } else {
        narrow_bt<R>(dh, w, params + d.woff[c][l], next, in_w);
      }
      __syncthreads();
      dh = next;
    }
    for (int i = threadIdx.x; i < R * d.d_in; i += blockDim.x) dxs[i] = c == 0 ? dh[i] : dxs[i] + dh[i];
    __syncthreads();  // the next chain reuses every buffer
  }
  for (int i = threadIdx.x; i < nr * d.d_in; i += blockDim.x) dx[r0 * d.d_in + i] = dxs[i];
}

// Launches the weight products of jobs[0..n) in lists of at most
// kMaxWgJobs, each group of rows writing its partial gradient.
cudaError_t launch_jobs(const Job* jobs, int n, const Layout& L, float* partials, cudaStream_t s) {
  Jobs tiled, bias;
  auto reset = [&](Jobs* js) {
    js->n = 0;
    js->inner_rows = 1;
    js->rows_per_group = L.rows_per_group;
    js->rows = L.d.N;
    js->P = L.P;
  };
  reset(&tiled);
  reset(&bias);
  int tiles = 0;
  cudaError_t err;
  auto flush = [&](bool force) -> cudaError_t {
    if (tiled.n > 0 && (force || tiled.n == rl8::kMaxWgJobs)) {
      cudaError_t e = rl8::launch_tiled(tiled, tiles, L.groups, partials, s);
      reset(&tiled);
      tiles = 0;
      if (e != cudaSuccess) return e;
    }
    if (bias.n > 0 && (force || bias.n == rl8::kMaxWgJobs)) {
      cudaError_t e = rl8::launch_bias(bias, L.groups, partials, s);
      reset(&bias);
      return e;
    }
    return cudaSuccess;
  };
  for (int q = 0; q < n; ++q) {
    rl8::add_job(jobs[q], &tiled, &bias, &tiles);
    if ((err = flush(false)) != cudaSuccess) return err;
  }
  return flush(true);
}

Job make_job(const float* a, long long a_outer, const float* b, long long b_outer, int K, int J, long long off) {
  Job jb;
  jb.a = a;
  jb.b = b;
  jb.a_outer = a_outer;
  jb.b_outer = b_outer;
  jb.a_inner = jb.b_inner = 0;
  jb.off = off;
  jb.K = K;
  jb.J = J;
  jb.bias = 1;
  jb.tiles_j = jb.tile0 = 0;
  return jb;
}

}  // namespace

// Floats of workspace that rl8_chains_bwd needs (backward != 0) or 0 for the
// forward, or -1 where the kernels do not take the chains.
extern "C" long long rl8_chains_workspace(long long N, int d_in, const int* spec, int spec_len, int backward) {
  Layout L;
  if (!make_layout(N, d_in, kRelu, spec, spec_len, &L)) return -1;
  return backward ? L.wt_floats + L.row_floats + L.part_floats : 0;
}

// outs: a host array of each head's output [N, hw], chain by chain.
extern "C" int rl8_chains_fwd(const float* x, const float* params, float* const* outs, long long N, int d_in,
                              const int* spec, int spec_len, int act, int device, void* stream) {
  Layout L;
  if (!make_layout(N, d_in, act, spec, spec_len, &L)) return (int)cudaErrorInvalidValue;
  for (int c = 0, q = 0; c < L.d.n_chains; ++c) {
    for (int j = 0; j < L.d.n_heads[c]; ++j) L.d.out[c][j] = outs[q++];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(chains_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.fwd_smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (N + kFwdRows - 1) / kFwdRows;
  chains_fwd_kernel<<<(unsigned)blocks, kThreads, L.fwd_smem, (cudaStream_t)stream>>>(x, params, L.d);
  return (int)cudaGetLastError();
}

// douts: a host array of each head's cotangent [N, hw], chain by chain; dx
// [N, d_in] and grads [P] (the flat parameter layout) are outputs; workspace
// holds rl8_chains_workspace(..., 1) floats.
extern "C" int rl8_chains_bwd(const float* x, const float* params, const float* const* douts, float* dx,
                              float* grads, float* workspace, long long N, int d_in, const int* spec, int spec_len,
                              int act, int device, void* stream) {
  Layout L;
  if (!make_layout(N, d_in, act, spec, spec_len, &L)) return (int)cudaErrorInvalidValue;
  for (int c = 0, q = 0; c < L.d.n_chains; ++c) {
    for (int j = 0; j < L.d.n_heads[c]; ++j) L.d.dout[c][j] = douts[q++];
  }
  const Chains& d = L.d;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float* wt = workspace;
  float* scratch = wt + L.wt_floats;
  float* partials = scratch + L.row_floats;

  // Transposed copies for the dh products.
  for (int c = 0; c < d.n_chains; ++c) {
    int in = d_in;
    for (int l = 0; l < d.n_layers[c]; ++l) {
      const int w = d.width[c][l];
      if (d.wt[c][l] >= 0) {
        rl8::transpose_kernel<<<rl8::grid_for((long long)in * w), kThreads, 0, s>>>(
            params + d.woff[c][l], wt + d.wt[c][l], in, w);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      }
      in = w;
    }
    long long row = d.wt[c][d.n_layers[c]];
    for (int j = 0; j < d.n_heads[c]; ++j) {
      const int hw = d.head_w[c][j];
      rl8::transpose_kernel<<<rl8::grid_for((long long)in * hw), kThreads, 0, s>>>(
          params + d.woff[c][d.n_layers[c] + j], wt + row, in, hw);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      row += (long long)hw * in;
    }
  }

  err = cudaFuncSetAttribute(chains_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bwd_smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (N + kBwdRows - 1) / kBwdRows;
  chains_bwd_rows_kernel<<<(unsigned)blocks, kThreads, L.bwd_smem, s>>>(x, params, wt, scratch, dx, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  Job jobs[kMaxJobs];
  int n = 0;
  for (int c = 0; c < d.n_chains; ++c) {
    const int Lc = d.n_layers[c];
    int in = d_in;
    for (int l = 0; l < Lc; ++l) {
      const int w = d.width[c][l];
      const float* a = l == 0 ? x : scratch + d.h_off[c][l - 1];
      jobs[n++] = make_job(a, in, scratch + d.dpre_off[c][l], w, in, w, d.woff[c][l]);
      if (d.ln[c][l]) {
        // Bias-only column sums: dscale = sum(da * xhat), dbias = sum(da).
        const long long scale_off = d.woff[c][l] + (long long)in * w + w;
        jobs[n++] = make_job(a, in, scratch + d.xhat_off[c][l], w, 0, w, scale_off);
        jobs[n++] = make_job(a, in, scratch + d.da_off[c][l], w, 0, w, scale_off + w);
      }
      in = w;
    }
    for (int j = 0; j < d.n_heads[c]; ++j) {
      jobs[n++] = make_job(scratch + d.h_off[c][Lc - 1], in, d.dout[c][j], d.head_w[c][j], in, d.head_w[c][j],
                           d.woff[c][Lc + j]);
    }
  }
  if ((err = launch_jobs(jobs, n, L, partials, s)) != cudaSuccess) return (int)err;
  rl8::sum_partials_kernel<<<rl8::grid_for(L.P), rl8::kWgThreads, 0, s>>>(partials, L.groups, L.P, grads);
  return (int)cudaGetLastError();
}

// Chain kernels: several activation-MLP chains that share one input x [N,
// d_in], each ending in linear heads, forward and backward.
//
// chains_fwd_tiles_kernel (and, for chains too wide for it, chains_fwd_kernel)
// replaces rl8_tpu/ops/fused_mlp.py:_fwd_kernel (called by _call_fwd, the
// forward of fused_chains); chains_bwd_tiles_kernel (and, for
// chains too wide for it, chains_bwd_rows_kernel with the weight products
// below) replaces fused_mlp.py:_bwd_kernel (_fused_bwd, the recompute-based
// backward). Per chain, layer l computes
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
// dh products and the weight products, ~3x the operations (6.90 GFLOP): 0.103
// ms on the CUDA cores, 0.042 ms at three TF32 products per f32 product on
// the tensor cores; its inputs and outputs are ~2.6 MB.
//
// Design.
// - Forward, f32 on the CUDA cores (a tensor-core forward flipped a relu
//   mask, PERF.md), each output summed in order of k.
//   - The tiled route (chains whose parameters and a 64-row tile fit a
//     block's shared memory: MischievousMule's use ~114 KB, so two
//     256-thread blocks share an SM). Block (i, c) owns chain c, loads its
//     parameters into shared memory once (cp.async) and walks the row tiles
//     i, i + groups, ...: the weights are read from L2 once per block, where
//     the first design read both chains' ~0.14 MB from L2 for every 16 rows
//     (~0.3 GB a 32,768-row launch). One chain a block rather than both
//     (~146 KB): two blocks an SM (16 warps to hide the latency of the
//     barrier-separated phases; 8 warps an SM, 32-row tiles of 128
//     threads, took 0.0996 ms against 0.0908 at 32,768 rows on an H100),
//     and a 4,096-row rollout step still gives 128 blocks.
//     Products are tile.cuh's register tiles: each thread owns 4 rows x 8
//     columns, so one 16-byte shared-memory load feeds 8 FMAs (the first
//     design issued about one load per FMA and left half its threads idle
//     at width 128). A layer up to 128 wide is one pass, and its row group's
//     16 lanes hold each of its rows in registers: its LayerNorm (flax's
//     fast variance, clamped at 0: each lane sums its 8 columns in order,
//     then an xor butterfly over the 16 lanes) and, after the last layer,
//     the narrow heads (the same sums of products) run there and write
//     straight to each head's output [N, hw]; its output replaces its input
//     in shared memory. Wider layers take passes of 128 columns between two
//     buffers, a LayerNorm a warp per row, narrow heads 4 lanes a row, and
//     wider heads the product. The activation is a template argument.
//   - The streaming route (the rest, up to the kernels' width limit; e.g.
//     a 768-wide layer, whose tile buffers alone fill shared memory): the
//     first design, a block of 256 threads per 16 rows walking every chain
//     with the weights streaming from L2 (mlp.cuh's dense_layer) and heads
//     narrower than 8 as warp dot products (mlp.cuh's narrow_head).
//   Rows past N are zeros in shared memory and are never stored; nothing is
//   padded in device memory.
// - Backward. The TPU kernel adds every grid step's gradients into
//   VMEM-resident accumulators over a sequential grid. CUDA blocks run in
//   parallel and nothing carries over between them, so:
//   - The tiled route (chains whose parameters, their gradients and a 32-row
//     tile fit a block's shared memory: MischievousMule's use 219 KB). Block
//     (i, c) of 512 threads owns chain c and walks the row tiles i, i +
//     groups, ...: persistent blocks, as many as the card holds at once (one
//     an SM), split evenly over the chains. It loads the chain's parameters
//     into shared memory once (cp.async) and keeps their gradient
//     accumulators there, in the same padded layout. Per tile it recomputes
//     the forward (f32 FMAs in order of k: on the tensor cores it flipped a
//     relu mask, see forward_rows), keeping every h_l (and a LayerNorm's
//     xhat and s) in shared memory; then, from the top, the weight products
//     dW += h_in^T dpre and the cotangents da = (dpre_above W^T) act'(h_l),
//     in place of h_l, on the tensor cores (mma.cuh's 3xTF32; the 7-wide
//     input's dx on the CUDA cores as warp dot products), and the column sums
//     db = sum(dpre), dscale = sum(da xhat), dbias = sum(da) on the CUDA
//     cores; through a LayerNorm dxhat = da scale and dpre = s (dxhat -
//     mean(dxhat) - xhat mean(dxhat xhat)) (a warp per row). The per-row
//     activations and cotangents never reach device memory: the first design
//     wrote ~6 KB of them per row (~0.2 GB per minibatch) and read them back.
//     Each gradient element has one owner thread for every tile, so its adds
//     come in a fixed order. The block writes its gradients as one row of the
//     partials, and its rows' dx of its chain to a per-chain dx.
//   - The streaming route (the rest, up to the forward's width limit; e.g. a
//     768-wide layer, whose weights alone fill shared memory): the first
//     design's row pass, chains_bwd_rows_kernel, 32 rows a block of 256
//     threads with the weights streaming from L2 and the per-row activations
//     and cotangents going to a device scratch, then wgrad.cuh's split-K
//     weight products (128x128 tensor-core tiles; a thread per column for
//     LayerNorm's column sums), each group of rows writing its own partial.
//   Then sum_partials_kernel adds the partials, and (tiled) sum_chain_dx_kernel
//   the chains' dx, in a fixed order. No float atomics: two launches give the
//   same bits.
#include <cuda_runtime.h>
#include <math.h>

#include "mlp.cuh"
#include "tile.cuh"
#include "wgrad.cuh"

namespace {

using rl8::activate;
using rl8::dense_layer;
using rl8::FragA;
using rl8::FragB;
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
// The tiled backward: threads and rows per block, the parameter blocks a
// chain's layout copies, and the most blocks over all chains.
constexpr int kTileThreads = 512;
constexpr int kTileRows = 32;
constexpr int kMaxTileSegs = 2 * kMaxLayers + 2 * kMaxHeads;
constexpr int kMaxTileBlocks = 264;

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

// ------------------------------------------------------- tiled backward

// A row-major block of the flat parameters ([rows, cols] from flat) and its
// place in shared memory (rows ld apart from sm).
struct Seg {
  long long flat;
  int rows, cols, sm, ld;
};

// One chain's shared-memory layout in the tiled backward (offsets in
// floats). The parameters lie at [0, S) and their gradient accumulators, in
// the same layout, at [S, 2S): per layer W_l [in_l, w_l] (rows ldw apart),
// then its b (and LayerNorm scale and bias) as in the flat vector; then the
// heads' Ws side by side, [w_last, n_out] (rows ldh apart), and their
// biases. The row tile's activations follow.
struct TileChain {
  int L, n_out, n_heads;
  int in[kMaxLayers], w[kMaxLayers], ln[kMaxLayers];
  int sw[kMaxLayers], ldw[kMaxLayers], sv[kMaxLayers];
  int sh, ldh, shb, S;
  int sa[kMaxLayers], lda[kMaxLayers];  // h_l (then da_l, then dpre_l) [R, w_l]
  int sxh[kMaxLayers];                  // LayerNorm xhat_l [R, w_l], rows lda[l] apart
  int sx, ldx, sd, ldd, ss;             // x [R, d_in], head cotangents [R, n_out], LayerNorm s [L, R]
  int n_seg;
  Seg seg[kMaxTileSegs];
  const float* dout[kMaxHeads];
  int head_w[kMaxHeads], head_col[kMaxHeads];  // columns among the chain's heads
};

struct Tiled {
  long long N, P;
  int d_in, act, n_chains, groups;
  size_t smem;
  TileChain c[kMaxChains];
};

// Row strides: activations 4 past a multiple of 32 (the A fragments' loads
// are then free of bank conflicts), weights a multiple of 8 that is not one
// of 16 (the B fragments' loads of a forward product are then free of them).
int act_ld(int w) { return (w + 31) / 32 * 32 + 4; }
int weight_ld(int w) {
  const int ld = (w + 7) / 8 * 8;
  return ld % 16 == 0 ? ld + 8 : ld;
}

// Lays out the tiled backward of Lo's chains; false where a chain's
// parameters, gradients and row tile do not fit a block's shared memory
// (those chains take the streaming route).
bool make_tiled(const Layout& Lo, Tiled* T) {
  const Chains& d = Lo.d;
  T->N = d.N;
  T->P = Lo.P;
  T->d_in = d.d_in;
  T->act = d.act;
  T->n_chains = d.n_chains;
  long long most = 0;
  for (int c = 0; c < d.n_chains; ++c) {
    TileChain& t = T->c[c];
    t.L = d.n_layers[c];
    t.n_out = d.chain_out[c];
    t.n_heads = d.n_heads[c];
    long long off = 0;
    int n = 0, in = d.d_in;
    for (int l = 0; l < t.L; ++l) {
      const int w = d.width[c][l];
      t.in[l] = in;
      t.w[l] = w;
      t.ln[l] = d.ln[c][l];
      t.sw[l] = (int)off;
      t.ldw[l] = weight_ld(w);
      t.seg[n++] = Seg{d.woff[c][l], in, w, (int)off, t.ldw[l]};
      off += (long long)in * t.ldw[l];
      const int nv = t.ln[l] ? 3 * w : w;
      t.sv[l] = (int)off;
      t.seg[n++] = Seg{d.woff[c][l] + (long long)in * w, 1, nv, (int)off, nv};
      off += nv;
      in = w;
    }
    t.sh = (int)off;
    t.ldh = weight_ld(t.n_out);
    off += (long long)in * t.ldh;
    t.shb = (int)off;
    off += t.n_out;
    for (int j = 0; j < t.n_heads; ++j) {
      const int hw = d.head_w[c][j], col = d.head_col[c][j] - d.head_col[c][0];
      t.head_w[j] = hw;
      t.head_col[j] = col;
      t.dout[j] = d.dout[c][j];
      t.seg[n++] = Seg{d.woff[c][t.L + j], in, hw, t.sh + col, t.ldh};
      t.seg[n++] = Seg{d.woff[c][t.L + j] + (long long)in * hw, 1, hw, t.shb + col, hw};
    }
    t.n_seg = n;
    off = (off + 3) / 4 * 4;
    t.S = (int)off;
    constexpr int R = kTileRows;
    long long a = 2 * off;
    t.sx = (int)a;
    t.ldx = act_ld(d.d_in);
    a += (long long)R * t.ldx;
    for (int l = 0; l < t.L; ++l) {
      t.lda[l] = act_ld(t.w[l]);
      t.sa[l] = (int)a;
      a += (long long)R * t.lda[l];
      t.sxh[l] = -1;
      if (t.ln[l]) {
        t.sxh[l] = (int)a;
        a += (long long)R * t.lda[l];
      }
    }
    t.sd = (int)a;
    t.ldd = act_ld(t.n_out);
    a += (long long)R * t.ldd;
    t.ss = (int)a;
    a += (long long)t.L * R;
    if (a * (long long)sizeof(float) + (long long)sizeof(TileChain) > kMaxSmem) return false;
    most = a > most ? a : most;
  }
  T->smem = sizeof(float) * (size_t)most;
  const long long tiles = (d.N + kTileRows - 1) / kTileRows;
  const long long cap = kMaxTileBlocks / d.n_chains;
  T->groups = (int)(tiles < cap ? tiles : cap);
  return true;
}

// -------------------------------------------------------- tiled forward

// The forward's tiled route: threads and rows per block, each thread's rows
// (tile.cuh's RT) and the threads of a row group (CG); a pass covers 8 CG
// columns of a layer.
constexpr int kFwdTileRows = 64;
constexpr int kFwdRT = 4;
constexpr int kFwdCG = 16;
constexpr int kFwdTileThreads = kFwdTileRows / kFwdRT * kFwdCG;
constexpr int kFwdPass = 8 * kFwdCG;

// One chain's shared-memory layout in the tiled forward (offsets in
// floats from the block's shared memory): per layer W_l [in_l, w_l] (rows
// ldw apart, 16-byte aligned, as tile.cuh reads them) and its b (and
// LayerNorm scale and bias); per head W [w_last, hw] (rows ldh apart) and
// b. The backward's TileChain lays the same blocks out for its mma fragments
// (rows a multiple of 8 apart, heads side by side) beside their gradients
// and a tile's activations for every layer, which the forward does not keep.
struct FwdChain {
  int L, n_heads;
  int in[kMaxLayers], w[kMaxLayers], ln[kMaxLayers];
  int sw[kMaxLayers], ldw[kMaxLayers], sv[kMaxLayers];
  int sh[kMaxHeads], ldh[kMaxHeads], shb[kMaxHeads], head_w[kMaxHeads];
  int narrow_heads;  // every head narrower than kNarrow
  int n_seg;
  Seg seg[kMaxTileSegs];
  float* out[kMaxHeads];
};

// The tiled forward: two buffers of x's tile [R, d_in] at 0 (rows ldx
// apart; the next tile's lands while one is computed), then the activation
// buffers [R, widest layer] (rows lda apart) at sa and sb (one buffer, sa ==
// sb, where every layer is one pass), then the block's chain.
struct FwdTiled {
  long long N;
  int d_in, act, n_chains, groups;
  int ldx, lda, sa, sb;
  size_t smem;
  FwdChain c[kMaxChains];
};

// Lays out the tiled forward of Lo's chains; false where a chain's
// parameters and a row tile's two activation buffers do not fit a block's
// shared memory (those chains take the streaming route, chains_fwd_kernel).
bool make_fwd_tiled(const Layout& Lo, FwdTiled* F) {
  constexpr int R = kFwdTileRows;
  const Chains& d = Lo.d;
  F->N = d.N;
  F->d_in = d.d_in;
  F->act = d.act;
  F->n_chains = d.n_chains;
  F->ldx = rl8::tile_ld(d.d_in);
  F->lda = rl8::tile_ld(d.max_w);
  // Layers of one pass each (the thread's sums live in registers until the
  // pass is done) write their output in place of their input: one buffer.
  int widest = 0;
  for (int c = 0; c < d.n_chains; ++c) {
    for (int l = 0; l < d.n_layers[c]; ++l) widest = d.width[c][l] > widest ? d.width[c][l] : widest;
  }
  F->sa = 2 * R * F->ldx;
  F->sb = widest <= kFwdPass ? F->sa : F->sa + R * F->lda;
  const long long sp = F->sb + (long long)R * F->lda;
  auto up4 = [](long long v) { return (v + 3) / 4 * 4; };
  long long most = 0;
  for (int c = 0; c < d.n_chains; ++c) {
    FwdChain& t = F->c[c];
    t.L = d.n_layers[c];
    t.n_heads = d.n_heads[c];
    long long off = sp;
    int n = 0, in = d.d_in;
    for (int l = 0; l < t.L; ++l) {
      const int w = d.width[c][l];
      t.in[l] = in;
      t.w[l] = w;
      t.ln[l] = d.ln[c][l];
      t.ldw[l] = (w + 3) / 4 * 4;
      t.sw[l] = (int)off;
      t.seg[n++] = Seg{d.woff[c][l], in, w, (int)off, t.ldw[l]};
      off = up4(off + (long long)in * t.ldw[l]);
      const int nv = t.ln[l] ? 3 * w : w;
      t.sv[l] = (int)off;
      t.seg[n++] = Seg{d.woff[c][l] + (long long)in * w, 1, nv, (int)off, nv};
      off = up4(off + nv);
      in = w;
    }
    t.narrow_heads = 1;
    for (int j = 0; j < t.n_heads; ++j) {
      const int hw = d.head_w[c][j];
      t.head_w[j] = hw;
      t.narrow_heads &= hw < kNarrow;
      t.ldh[j] = (hw + 3) / 4 * 4;
      t.sh[j] = (int)off;
      t.seg[n++] = Seg{d.woff[c][t.L + j], in, hw, (int)off, t.ldh[j]};
      off = up4(off + (long long)in * t.ldh[j]);
      t.shb[j] = (int)off;
      t.seg[n++] = Seg{d.woff[c][t.L + j] + (long long)in * hw, 1, hw, (int)off, hw};
      off = up4(off + hw);
      t.out[j] = d.out[c][j];
    }
    t.n_seg = n;
    if (off * (long long)sizeof(float) + (long long)sizeof(FwdChain) > kMaxSmem) return false;
    most = off > most ? off : most;
  }
  F->smem = sizeof(float) * (size_t)most;
  F->groups = (int)((d.N + R - 1) / R);
  return true;
}

// LayerNorm of the block's rows of z (rows ld apart, w wide), in place,
// followed by the activation: z = act(xhat * scale + bias), with scale and
// bias in shared memory. Warp i owns rows i RW .. i RW + RW - 1 and works
// on them at once: per row, each lane sums its strided elements in order,
// then an xor butterfly, as layer_norm_rows does for one row at a time (the
// same sums in the same order; its rows' serial shuffles were ~25% of the
// forward, kernel_variants.py's fwd_no_layer_norm).
template <int RW, int ACT>
__device__ __forceinline__ void layer_norm_tile(float* z, int ld, int w, const float* scale, const float* bias) {
  const int lane = threadIdx.x % 32;
  float* rows = z + (threadIdx.x / 32) * RW * ld;
  float s1[RW], s2[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) s1[i] = s2[i] = 0.0f;
  for (int k = lane; k < w; k += 32) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float v = rows[i * ld + k];
      s1[i] += v;
      s2[i] = fmaf(v, v, s2[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const float mu = s1[i] / w;
    s1[i] = mu;
    s2[i] = rsqrtf(fmaxf(s2[i] / w - mu * mu, 0.0f) + kLnEps);
  }
  for (int k = lane; k < w; k += 32) {
    const float sc = scale[k], bi = bias[k];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      float* v = rows + i * ld + k;
      *v = activate(fmaf((*v - s1[i]) * s2[i], sc, bi), ACT);
    }
  }
}

// LayerNorm and activation of a one-pass layer's outputs in registers:
// v[r][j] is row r's column n[j] (columns past w are ignored), and the CG
// lanes of the row group (adjacent, within a warp) hold the whole row. Each
// lane sums its columns in order, then an xor butterfly over the CG lanes;
// flax's fast variance, clamped at 0, as layer_norm_tile computes it. Its
// separate pass over shared memory was ~14% of the forward
// (kernel_variants.py's fwd_no_layer_norm).
template <int RT, int CG, int ACT>
__device__ __forceinline__ void fused_layer_norm(float (&v)[RT][8], const int (&n)[8], int w, const float* scale,
                                                 const float* bias) {
  float sc[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = n[j] < w ? scale[n[j]] : 0.0f;
    bi[j] = n[j] < w ? bias[n[j]] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (n[j] < w) {
        s1 += v[r][j];
        s2 = fmaf(v[r][j], v[r][j], s2);
      }
    }
#pragma unroll
    for (int off = CG / 2; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mu = s1 / w;
    const float s = rsqrtf(fmaxf(s2 / w - mu * mu, 0.0f) + kLnEps);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[r][j] = activate(fmaf((v[r][j] - mu) * s, sc[j], bi[j]), ACT);
  }
}

// The chain's narrow heads on the last layer's outputs in registers (rows
// q0 .. q0 + RT - 1; tile.cuh's tile_heads), each straight to its output
// [N, hw] for the rows below nr. Their separate pass over shared memory, and
// the barrier before it, were ~7% of the forward (fwd_no_heads).
template <int RT, int CG>
__device__ __forceinline__ void fused_heads(const float (&h)[RT][8], const int (&n)[8], int w, const FwdChain& t,
                                            const float* smem, long long r0, int q0, int nr) {
  for (int j = 0; j < t.n_heads; ++j) {
    const int hw = t.head_w[j];
    float* o = t.out[j] + r0 * hw;
    rl8::tile_heads<RT, CG>(h, n, w, smem + t.sh[j], t.ldh[j], smem + t.shb[j], hw, [&](int r, int q, float v) {
      if (q0 + r < nr) o[(q0 + r) * hw + q] = v;
    });
  }
}

// Copies the segments of a chain's parameters into shared memory
// (cp.async; committed by the caller): 16 bytes a copy where a segment's
// rows allow it, else 4, a row at a time for wide rows.
__device__ __forceinline__ void load_segments(const Seg* segs, int n_seg, const float* __restrict__ params,
                                              float* smem) {
  for (int q = 0; q < n_seg; ++q) {
    const Seg s = segs[q];
    const float* src = params + s.flat;
    float* dst = smem + s.sm;
    if ((s.cols & 3) == 0 && (s.flat & 3) == 0) {
      const int per_row = s.cols / 4;
      for (int i = threadIdx.x; i < s.rows * per_row; i += blockDim.x) {
        const int row = i / per_row, c = 4 * (i - row * per_row);
        rl8::cp_async16(dst + row * s.ld + c, src + (size_t)row * s.cols + c, 16);
      }
    } else if (s.cols >= 32) {
      for (int row = 0; row < s.rows; ++row) {
        for (int c = threadIdx.x; c < s.cols; c += blockDim.x) {
          rl8::cp_async4(dst + row * s.ld + c, src + (size_t)row * s.cols + c, 4);
        }
      }
    } else {
      for (int i = threadIdx.x; i < s.rows * s.cols; i += blockDim.x) {
        rl8::cp_async4(dst + (i / s.cols) * s.ld + i % s.cols, src + i, 4);
      }
    }
  }
}

// Copies rows r0 .. r0 + R of x (zeros past N) to xs, rows ldx apart
// (cp.async; committed by the caller).
template <int R>
__device__ __forceinline__ void load_x(const float* __restrict__ x, long long N, int d_in, long long r0, float* xs,
                                       int ldx) {
  const int nr = (int)min((long long)R, N - r0);
  for (int i = threadIdx.x; i < R * d_in; i += blockDim.x) {
    const int r = i / d_in;
    rl8::cp_async4(xs + r * ldx + (i - r * d_in), x + r0 * d_in + (r < nr ? i : 0), r < nr ? 4 : 0);
  }
}

// The tiled forward: block (i, c) owns chain c, loads its parameters into
// shared memory once (cp.async) and walks the row tiles i, i + groups, ...
// (the next tile's x in flight while one is computed); per tile each layer
// is tile.cuh's register-tiled product in passes of 128 columns (bias and
// activation on the way out), then a LayerNorm where the layer has one, and
// each head goes straight to its output [N, hw]: narrow ones 4 lanes per
// row (tile.cuh's narrow_rows), wider ones as a product. Rows past N are
// zeros in shared memory and are never stored.
template <int ACT>
__global__ void __launch_bounds__(kFwdTileThreads, 2)
    chains_fwd_tiles_kernel(const float* __restrict__ x, const float* __restrict__ params,
                            const __grid_constant__ FwdTiled F) {
  constexpr int R = kFwdTileRows, RT = kFwdRT, CG = kFwdCG;
  extern __shared__ __align__(16) float smem[];
  // The block's chain, copied from the parameters: read with indices known
  // only at run time, the parameters are generic loads on every use.
  __shared__ FwdChain t;
  for (int i = threadIdx.x; i < (int)(sizeof(FwdChain) / sizeof(int)); i += blockDim.x) {
    reinterpret_cast<int*>(&t)[i] = reinterpret_cast<const int*>(&F.c[blockIdx.y])[i];
  }
  __syncthreads();
  load_segments(t.seg, t.n_seg, params, smem);
  const int d_in = F.d_in, ldx = F.ldx, lda = F.lda;
  load_x<R>(x, F.N, d_in, (long long)blockIdx.x * R, smem, ldx);
  rl8::cp_async_commit();
  const int rg = threadIdx.x / CG, c0 = 4 * (threadIdx.x % CG), c1 = c0 + 4 * CG;

  int buf = 0;
  for (long long tile = blockIdx.x; tile * R < F.N; tile += gridDim.x, buf ^= 1) {
    const long long r0 = tile * R;
    const int nr = (int)min((long long)R, F.N - r0);
    const float* xs = smem + buf * R * ldx;
    rl8::cp_async_wait<0>();
    __syncthreads();  // x (and the parameters) landed; the last tile's heads are done
    if ((tile + gridDim.x) * R < F.N) {
      load_x<R>(x, F.N, d_in, (tile + gridDim.x) * R, smem + (buf ^ 1) * R * ldx, ldx);
      rl8::cp_async_commit();
    }
    const float* cur = xs;
    int cur_ld = ldx, cur_w = d_in;
    bool heads_done = false;
    for (int l = 0; l < t.L; ++l) {
      const int w = t.w[l], ldw = t.ldw[l], ln = t.ln[l];
      const float* W = smem + t.sw[l];
      const float* bv = smem + t.sv[l];
      float* dst = smem + ((l & 1) ? F.sb : F.sa);
      // A layer of one pass has each row in the registers of its row
      // group: its LayerNorm, and the narrow heads of the last layer, run on
      // them (fused_layer_norm, fused_heads) with no pass over shared memory.
      const bool one_pass = w <= kFwdPass;
      const bool fuse_heads = l == t.L - 1 && !ln && one_pass && t.narrow_heads;
      for (int n0 = 0; n0 < w; n0 += kFwdPass) {
        float acc[RT][8];
        rl8::tile_zero(acc);
        rl8::tile_fma<RT>(acc, cur + rg * RT * cur_ld, cur_ld, W, ldw, cur_w, min(n0 + c0, ldw - 4),
                          min(n0 + c1, ldw - 4));
        int n[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          n[j] = n0 + (j < 4 ? c0 + j : c1 + j - 4);
          const float b = n[j] < w ? bv[n[j]] : 0.0f;
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r][j] = ln ? acc[r][j] + b : activate(acc[r][j] + b, ACT);
        }
        if (ln && one_pass) fused_layer_norm<RT, CG, ACT>(acc, n, w, bv + w, bv + 2 * w);
        if (fuse_heads) {
          fused_heads<RT, CG>(acc, n, w, t, smem, r0, rg * RT, nr);
          continue;
        }
        if (dst == cur) __syncthreads();  // in place: every thread's product has read its input
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float* row = dst + (rg * RT + r) * lda;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int n4 = n[4 * half];
            if (n4 + 4 <= w) {
              *reinterpret_cast<float4*>(row + n4) =
                  make_float4(acc[r][4 * half], acc[r][4 * half + 1], acc[r][4 * half + 2], acc[r][4 * half + 3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (n4 + j < w) row[n4 + j] = acc[r][4 * half + j];
              }
            }
          }
        }
      }
      if (fuse_heads) {
        heads_done = true;
        break;
      }
      __syncthreads();
      if (ln && !one_pass) {
        layer_norm_tile<R * 32 / kFwdTileThreads, ACT>(dst, lda, w, bv + w, bv + 2 * w);
        __syncthreads();
      }
      cur = dst;
      cur_ld = lda;
      cur_w = w;
    }
    if (heads_done) continue;  // the next tile's barrier orders its writes after these reads
    for (int j = 0; j < t.n_heads; ++j) {
      const int hw = t.head_w[j], ldh = t.ldh[j];
      const float* W = smem + t.sh[j];
      const float* bh = smem + t.shb[j];
      float* o = t.out[j] + r0 * hw;
      if (hw < kNarrow) {
        rl8::narrow_rows<kFwdTileThreads / R>(cur, cur_ld, cur_w, W, ldh, bh, hw, [&](int r, int q, float v) {
          if (r < nr) o[r * hw + q] = v;
        });
        continue;
      }
      for (int n0 = 0; n0 < hw; n0 += kFwdPass) {
        float acc[RT][8];
        rl8::tile_zero(acc);
        rl8::tile_fma<RT>(acc, cur + rg * RT * cur_ld, cur_ld, W, ldh, cur_w, min(n0 + c0, ldh - 4),
                          min(n0 + c1, ldh - 4));
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int row = rg * RT + r;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int n = n0 + (q < 4 ? c0 + q : c1 + q - 4);
            if (row < nr && n < hw) o[row * hw + n] = acc[r][q] + bh[n];
          }
        }
      }
    }
  }
}

// acc[mt][nt] += sum over k < K of a(m, k) b(k, n) on the tensor cores
// (mma.cuh's 3xTF32, a fresh accumulator per k step of 8), for the warp's
// MTW m16 tiles from m0 and NTW n8 tiles from n0 (mma.cuh's fragment
// layouts); a and b return 0 outside their operands, k >= K included.
template <int MTW, int NTW, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[MTW][NTW][4], int m0, int n0, int K, FA a, FB b) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
#pragma unroll 2
  for (int kb = 0; kb < K; kb += 8) {
    const int k = kb + tq;
    FragB fb[NTW];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) fb[nt].set(b(k, n0 + nt * 8 + g), b(k + 4, n0 + nt * 8 + g));
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      const int m = m0 + mt * 16 + g;
      FragA fa;
      fa.set(a(m, k), a(m + 8, k), a(m, k + 4), a(m + 8, k + 4));
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) rl8::mma_3xtf32(acc[mt][nt], fa, fb[nt]);
    }
  }
}

// out(r, n, v) with v = sum over k < K of A[r, k] b(k, n), for the tile's
// rows and n < N; A in shared memory (rows lda apart). Products 8 or more
// wide run on the tensor cores, a warp per 8 columns for every row;
// narrower ones (the 7-wide input's dx) on the CUDA cores: S adjacent lanes
// per (row, column), S the largest power of two up to 32 that the block's
// threads allow, each summing every S-th k, then a shuffle reduction, all
// in a fixed order. (A warp per (row, column) left most of the block idle
// behind its serial shuffles: 0.1 ms of the 0.53 ms launch on an H100,
// kernel_variants.py's chains_no_dx.) Each output is passed to out by one
// lane, once.
template <class FB, class OUT>
__device__ __forceinline__ void row_product(const float* A, int lda, int K, int N, FB b, OUT out) {
  constexpr int R = kTileRows, MT = R / 16, n_warps = kTileThreads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  if (N < kNarrow) {
    int S = 32;
    while (S > 1 && S * R * N > kTileThreads) S >>= 1;
    const int part = threadIdx.x % S;
    // Whole groups of S lanes step together, so the shuffles see every lane
    // of a group (the loop's bound is rounded up to whole warps).
    const int outputs = R * N, per_pass = kTileThreads / S;
    for (int p0 = 0; p0 < outputs; p0 += per_pass) {
      const int p = p0 + threadIdx.x / S;
      const bool live = p < outputs;
      const int r = live ? p / N : 0, n = live ? p % N : 0;
      float s = 0.0f;
      if (live) {
        for (int k = part; k < K; k += S) s = fmaf(A[r * lda + k], b(k, n), s);
      }
      for (int off = S / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (live && part == 0) out(r, n, s);
    }
    return;
  }
  auto a = [&](int m, int k) { return k < K ? A[m * lda + k] : 0.0f; };
  auto bk = [&](int k, int n) { return k < K && n < N ? b(k, n) : 0.0f; };
  for (int n0 = 8 * warp; n0 < N; n0 += 8 * n_warps) {
    float acc[MT][1][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][0][e] = 0.0f;
    warp_mma<MT, 1>(acc, 0, n0, K, a, bk);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 2 * tq + (e & 1);
        if (n < N) out(mt * 16 + g + (e >= 2 ? 8 : 0), n, acc[mt][0][e]);
      }
    }
  }
}

// G[m ldg + n] += sum over the tile's rows r of A[r lda + m] B[r ldb + n],
// for m < M and n < N, on the tensor cores: a warp per 32 x 16 block of G.
// The same warp owns a block at every tile, so each element of G has one
// owner and its adds need no barrier and come in a fixed order.
__device__ __forceinline__ void weight_product(const float* A, int lda, int M, const float* B, int ldb, int N,
                                               float* G, int ldg) {
  constexpr int n_warps = kTileThreads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int units_n = (N + 15) / 16, units = (M + 31) / 32 * units_n;
  auto a = [&](int m, int k) { return m < M ? A[k * lda + m] : 0.0f; };
  auto b = [&](int k, int n) { return n < N ? B[k * ldb + n] : 0.0f; };
  for (int u = warp; u < units; u += n_warps) {
    const int m0 = (u / units_n) * 32, n0 = (u % units_n) * 16;
    float acc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    warp_mma<2, 2>(acc, m0, n0, kTileRows, a, b);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + mt * 16 + g + (e >= 2 ? 8 : 0), n = n0 + nt * 8 + 2 * tq + (e & 1);
          if (m < M && n < N) G[m * ldg + n] += acc[mt][nt][e];
        }
      }
    }
  }
}

// G[n] += sum over the tile's rows of B[r ldb + n] (times X[r ldb + n]
// when X is given), for n < N: a thread per column, rows in order.
__device__ __forceinline__ void column_sums(const float* B, int ldb, const float* X, int N, float* G) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.0f;
    if (X != nullptr) {
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) s = fmaf(B[r * ldb + n], X[r * ldb + n], s);
    } else {
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) s += B[r * ldb + n];
    }
    G[n] += s;
  }
}

// out[r, n] = act(sum over k < K of A[r, k] W[k, n] + b[n]) for the tile's
// rows and n < N (no activation where ln: a LayerNorm follows), A and W in
// shared memory (rows lda and ldw apart): the forward recompute, on the
// CUDA cores in f32, summed in order of k. On the tensor cores it flipped a
// relu mask that the plain version's f32 sums keep (a unit 1.6e-8 from 0:
// 3xTF32 truncates each k step's sum), and dx missed the checks by 0.025 on
// an H100 (kernel_variants.py's chains_tc_forward). Thread (q, j) owns
// column j (and j + 128, ...) of the tile's q-th group of rows: each weight
// it loads feeds a group's FMAs, and a warp's activation loads are
// broadcasts (four k at a time where K and lda allow).
__device__ __forceinline__ void forward_rows(const float* A, int lda, int K, const float* W, int ldw,
                                             const float* b, int N, float* out, int ldo, bool ln, int act) {
  constexpr int kCols = 128, kGroup = kTileRows * kCols / kTileThreads;
  const int j0 = threadIdx.x % kCols, q0 = (threadIdx.x / kCols) * kGroup;
  const bool vec = (K & 3) == 0 && (lda & 3) == 0;
  for (int n = j0; n < N; n += kCols) {
    float acc[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) acc[r] = 0.0f;
    int k = 0;
    if (vec) {
      for (; k < K; k += 4) {
        const float w0 = W[k * ldw + n], w1 = W[(k + 1) * ldw + n], w2 = W[(k + 2) * ldw + n], w3 = W[(k + 3) * ldw + n];
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(A + (q0 + r) * lda + k);
          acc[r] = fmaf(a.x, w0, acc[r]);
          acc[r] = fmaf(a.y, w1, acc[r]);
          acc[r] = fmaf(a.z, w2, acc[r]);
          acc[r] = fmaf(a.w, w3, acc[r]);
        }
      }
    }
    for (; k < K; ++k) {
      const float wk = W[k * ldw + n];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) acc[r] = fmaf(A[(q0 + r) * lda + k], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const float v = acc[r] + b[n];
      out[(q0 + r) * ldo + n] = ln ? v : activate(v, act);
    }
  }
}

__device__ __forceinline__ float act_grad(float h, int act) {
  return act == kRelu ? (h > 0.0f ? 1.0f : 0.0f) : 1.0f - h * h;
}

// The tiled backward: block (i, c) owns chain c, holds its parameters and
// their gradient accumulators in shared memory, and walks the row tiles i,
// i + groups, ...; per tile the forward recompute, the backward and the
// weight products run on the tile's rows in shared memory. At the end the
// block writes its gradients as row i of the partials (the chain's columns)
// and has written its tiles' dx of the chain to dxc [n_chains, N, d_in].
__global__ void __launch_bounds__(kTileThreads, 1)
    chains_bwd_tiles_kernel(const float* __restrict__ x, const float* __restrict__ params,
                            float* __restrict__ partials, float* __restrict__ dxc, const __grid_constant__ Tiled T) {
  constexpr int R = kTileRows, n_warps = kTileThreads / 32;
  extern __shared__ __align__(16) float smem[];
  // The block's chain, copied from the parameters: read with indices known
  // only at run time, the parameters are generic loads on every use.
  __shared__ TileChain t;
  for (int i = threadIdx.x; i < (int)(sizeof(TileChain) / sizeof(int)); i += blockDim.x) {
    reinterpret_cast<int*>(&t)[i] = reinterpret_cast<const int*>(&T.c[blockIdx.y])[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, act = T.act, d_in = T.d_in;
  float* Ws = smem;
  float* Gs = smem + t.S;
  for (int q = 0; q < t.n_seg; ++q) {
    const Seg s = t.seg[q];
    for (int i = threadIdx.x; i < s.rows * s.cols; i += blockDim.x) {
      rl8::cp_async4(Ws + s.sm + (i / s.cols) * s.ld + i % s.cols, params + s.flat + i, 4);
    }
  }
  rl8::cp_async_commit();
  for (int i = threadIdx.x; i < t.S; i += blockDim.x) Gs[i] = 0.0f;
  rl8::cp_async_wait<0>();
  __syncthreads();
  float* xs = smem + t.sx;
  float* ds = smem + t.sd;
  float* svals = smem + t.ss;
  float* dxo = dxc + (size_t)blockIdx.y * T.N * d_in;

  for (long long tile = blockIdx.x; tile * R < T.N; tile += gridDim.x) {
    const long long r0 = tile * R;
    const int nr = (int)min((long long)R, T.N - r0);
    for (int i = threadIdx.x; i < R * d_in; i += blockDim.x) {
      const int r = i / d_in;
      xs[r * t.ldx + i % d_in] = r < nr ? x[r0 * d_in + i] : 0.0f;
    }
    for (int j = 0; j < t.n_heads; ++j) {
      const int hw = t.head_w[j];
      for (int i = threadIdx.x; i < R * hw; i += blockDim.x) {
        const int r = i / hw;
        ds[r * t.ldd + t.head_col[j] + i % hw] = r < nr ? t.dout[j][r0 * hw + i] : 0.0f;
      }
    }
    __syncthreads();

    // Forward, each layer's output h_l (a LayerNorm layer's xhat and s too).
    for (int l = 0; l < t.L; ++l) {
      const float* in = l == 0 ? xs : smem + t.sa[l - 1];
      const int ld_in = l == 0 ? t.ldx : t.lda[l - 1];
      float* h = smem + t.sa[l];
      const int ld = t.lda[l], w = t.w[l], ldw = t.ldw[l], ln = t.ln[l];
      const float* W = Ws + t.sw[l];
      const float* bv = Ws + t.sv[l];
      forward_rows(in, ld_in, t.in[l], W, ldw, bv, w, h, ld, ln, act);
      __syncthreads();
      if (ln) {
        float* xh = smem + t.sxh[l];
        for (int r = warp; r < R; r += n_warps) {
          float* row = h + r * ld;
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
          for (int k = lane; k < w; k += 32) {
            const float xv = (row[k] - mu) * s;
            xh[r * ld + k] = xv;
            row[k] = activate(fmaf(xv, bv[w + k], bv[2 * w + k]), act);
          }
          if (lane == 0) svals[l * R + r] = s;
        }
        __syncthreads();
      }
    }

    // Backward from the top. cot is the cotangent of the layer above's
    // pre-activation (first the heads' outputs), rows ldc apart and nc
    // wide; Wc (rows ldwc apart), Gw and Gb that layer's weights and
    // gradients. At l = -1 the layer above is layer 0 and its input x.
    const float* cot = ds;
    int ldc = t.ldd, nc = t.n_out, ldwc = t.ldh;
    const float* Wc = Ws + t.sh;
    float* Gw = Gs + t.sh;
    float* Gb = Gs + t.shb;
    for (int l = t.L - 1; l >= -1; --l) {
      const float* hin = l >= 0 ? smem + t.sa[l] : xs;
      const int ld_in = l >= 0 ? t.lda[l] : t.ldx, in_w = l >= 0 ? t.w[l] : d_in;
      weight_product(hin, ld_in, in_w, cot, ldc, nc, Gw, ldwc);
      column_sums(cot, ldc, nullptr, nc, Gb);
      if (l < 0) {
        // This chain's dx = dpre_0 W_0^T (x is not overwritten).
        row_product(cot, ldc, nc, d_in, [&](int k, int n) { return Wc[n * ldwc + k]; },
                    [&](int r, int n, float v) {
                      if (r < nr) dxo[(r0 + r) * d_in + n] = v;
                    });
        break;
      }
      __syncthreads();  // h_l is read above and overwritten below
      // da_l = (cot Wc^T) act'(h_l), in place of h_l.
      float* h = smem + t.sa[l];
      const int ld = t.lda[l], w = t.w[l];
      row_product(cot, ldc, nc, w, [&](int k, int n) { return Wc[n * ldwc + k]; },
                  [&](int r, int n, float v) { h[r * ld + n] = v * act_grad(h[r * ld + n], act); });
      __syncthreads();
      if (t.ln[l]) {
        // dscale = sum(da xhat) and dbias = sum(da); then per row dxhat =
        // da scale and dpre = s (dxhat - mean(dxhat) - xhat mean(dxhat
        // xhat)), in place.
        const float* bv = Ws + t.sv[l];
        const float* xh = smem + t.sxh[l];
        column_sums(h, ld, xh, w, Gs + t.sv[l] + w);
        column_sums(h, ld, nullptr, w, Gs + t.sv[l] + 2 * w);
        __syncthreads();
        for (int r = warp; r < R; r += n_warps) {
          float* row = h + r * ld;
          const float* xr = xh + r * ld;
          float m1 = 0.0f, m2 = 0.0f;
          for (int k = lane; k < w; k += 32) {
            const float dxh = row[k] * bv[w + k];
            m1 += dxh;
            m2 = fmaf(dxh, xr[k], m2);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            m1 += __shfl_xor_sync(0xffffffffu, m1, off);
            m2 += __shfl_xor_sync(0xffffffffu, m2, off);
          }
          m1 /= w;
          m2 /= w;
          const float s = svals[l * R + r];
          for (int k = lane; k < w; k += 32) row[k] = s * (row[k] * bv[w + k] - m1 - xr[k] * m2);
        }
        __syncthreads();
      }
      cot = h;
      ldc = ld;
      nc = w;
      ldwc = t.ldw[l];
      Wc = Ws + t.sw[l];
      Gw = Gs + t.sw[l];
      Gb = Gs + t.sv[l];
    }
    __syncthreads();  // the next tile reuses every buffer
  }
  float* out = partials + (size_t)blockIdx.x * T.P;
  for (int q = 0; q < t.n_seg; ++q) {
    const Seg s = t.seg[q];
    for (int i = threadIdx.x; i < s.rows * s.cols; i += blockDim.x) {
      out[s.flat + i] = Gs[s.sm + (i / s.cols) * s.ld + i % s.cols];
    }
  }
}

// dx = sum over chains of dxc[c], in chain order.
__global__ void sum_chain_dx_kernel(const float* __restrict__ dxc, int n_chains, long long n,
                                    float* __restrict__ dx) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = dxc[i];
    for (int c = 1; c < n_chains; ++c) s += dxc[(size_t)c * n + i];
    dx[i] = s;
  }
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
// forward, or -1 where the kernels do not take the chains: the tiled route's
// partials (at most kMaxTileBlocks / n_chains groups) and per-chain dx, or
// the streaming route's transposed weights, row scratch and partials.
extern "C" long long rl8_chains_workspace(long long N, int d_in, const int* spec, int spec_len, int backward) {
  Layout L;
  if (!make_layout(N, d_in, kRelu, spec, spec_len, &L)) return -1;
  if (!backward) return 0;
  Tiled T;
  if (make_tiled(L, &T)) return (long long)T.groups * L.P + (long long)L.d.n_chains * N * d_in;
  return L.wt_floats + L.row_floats + L.part_floats;
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
  FwdTiled F;
  if (make_fwd_tiled(L, &F)) {
    // The tiled route: as many persistent blocks as the card holds at once
    // (within the row tiles), split evenly over the chains.
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
    // The activation is a template argument: chosen at run time, every
    // activation also paid for tanhf's instructions.
    auto kernel = act == kRelu ? chains_fwd_tiles_kernel<kRelu> : chains_fwd_tiles_kernel<kTanh>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F.smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFwdTileThreads, F.smem);
    if (err != cudaSuccess) return (int)err;
    const int fit = sms * per_sm / L.d.n_chains;
    F.groups = fit < 1 ? 1 : (fit < F.groups ? fit : F.groups);
    kernel<<<dim3(F.groups, L.d.n_chains), kFwdTileThreads, F.smem, (cudaStream_t)stream>>>(x, params, F);
    return (int)cudaGetLastError();
  }
  // The streaming route.
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

  Tiled T;
  if (make_tiled(L, &T)) {
    // The tiled route: as many persistent blocks as the card holds at once
    // (within the workspace's groups), split evenly over the chains.
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(chains_bwd_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T.smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chains_bwd_tiles_kernel, kTileThreads, T.smem);
    if (err != cudaSuccess) return (int)err;
    const int fit = sms * per_sm / d.n_chains;
    T.groups = fit < 1 ? 1 : (fit < T.groups ? fit : T.groups);
    float* partials = workspace;
    float* dxc = partials + (long long)T.groups * L.P;
    chains_bwd_tiles_kernel<<<dim3(T.groups, d.n_chains), kTileThreads, T.smem, s>>>(x, params, partials, dxc, T);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rl8::sum_partials_kernel<<<rl8::grid_for(L.P), rl8::kWgThreads, 0, s>>>(partials, T.groups, L.P, grads);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    sum_chain_dx_kernel<<<rl8::grid_for(N * d_in), rl8::kWgThreads, 0, s>>>(dxc, d.n_chains, N * d_in, dx);
    return (int)cudaGetLastError();
  }

  // The streaming route.
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

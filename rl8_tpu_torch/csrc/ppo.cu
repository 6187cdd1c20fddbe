// PPO update kernel: one packed minibatch -> the PPO losses and the gradient
// of every parameter, with the backward derived by hand.
//
// Replaces the Pallas TPU kernels of rl8_tpu/ops/fused_ppo.py (with
// fused_mlp._forward_block and fused_mlp._chains_backward):
// _discrete_kernel for the default discrete model with Categorical, and
// _continuous_kernel for the default continuous model with Normal or
// (entropy off) SquashedNormal. Per row of the packed int32 matrix [N, D]
// (actions, advantages, logp, returns, obs; the float columns bitcast) it
// computes:
//   - the twin-chain forward (policy torso + its heads, value torso +
//     value head) on the CUDA cores, f32 end to end;
//   - categorical: per group the log-softmax z - (max + log(sum(exp(z -
//     max)))) (the act kernel's formula), the chosen action's logp and,
//     with use_entropy, the entropy (policy_row);
//   - continuous: from the mean and pre-tanh log-std heads, log_std =
//     tanh(pre), the Normal logp of the f32 action columns or, squashed,
//     that of their clipped atanh with the +-100 clamp (distmath.cuh, the
//     act kernel's formulas), and the entropy sum(0.5 (1 + log 2 pi) +
//     log_std) (continuous_row);
//   - the dual-clipped surrogate and the clamped smooth-L1 value loss with
//     fused_ppo._policy_grad_terms / _vf_grad_terms' boundary conventions
//     (take1 = surr1 <= surr2, a strict in_clip interval, the dual-clip gate
//     clip1 >= dual * adv, the strict sl1 < vf_clip);
//   - the heads' cotangents: dlogits = u_pol * (onehot - p) [+ ec * scale *
//     p * (logp_all + H)], or dmean = u_pol * diff * inv_var * gate and
//     dpre = (u_pol * (diff^2 * inv_var - 1) * gate [- ec * scale]) *
//     (1 - log_std^2), where the gate is 0 where the +-100 clamp cuts
//     (squashed only); and dv. Then backprop through both chains into
//     every parameter gradient, scaled by scale = 1 / (n_rows * accum);
//   - the four stat sums: policy, vf, entropy and kl.
//
// Bound on an H100 SXM at the main path (N = 262,144 rows, d_in = 1, twin
// 256-wide torsos, 2 logits or a mean and a log-std of A = 1, the same
// shapes): the forward is 132,352 MACs per row and the backward 264,192
// (dW and dh of both 256x256 layers, the heads, dW of the first layers),
// 2.08e11 FLOP per launch, against ~6.3 MB of inputs and outputs, so the
// products bound it: 3.10 ms at the CUDA cores' 67 TFLOP/s, 1.26 ms at
// three TF32 products per f32 product at the tensor cores' 495 TFLOP/s.
//
// Design. On the TPU the grid runs in order, so every grid step adds its
// rows' gradient into VMEM-resident accumulators. CUDA blocks run in
// parallel, and one 256x256 f32 dW (256 KB) does not fit a block's shared
// memory, so the work is split in passes, with no float atomics (the
// result is bit-identical from launch to launch):
//   1. ppo_rows_kernel: a block owns kRows = 32 rows, two blocks to an SM (64
//      rows a block, one to an SM, made the launch 10.73 ms against 10.09 on
//      an H100, kernel_variants.py's ff_rows64: the pass waits on latency,
//      and a second block hides more of it than a weight read feeding 64 rows
//      saves). It runs each chain's forward with the current layer's
//      activations in shared memory (mlp.cuh's dense_layer on the CUDA
//      cores), the per-row losses and head cotangents, and the backward of dh
//      down the chain: dh_{l-1} = dpre_l W_l^T on the tensor cores (tc_dense:
//      a transposed copy of W_l streams from L2 in 16-row slices through a
//      two-stage cp.async ring in shared memory, small enough that two blocks
//      fit an SM; the 8 warps split the rows 2 ways and the columns 4 ways).
//      The forward stays on the CUDA cores because the tensor cores round
//      toward zero (mma.cuh): their bias in h_l reaches the logits and
//      values, and the loss's cotangents sum it over every row. With the
//      forward's products on the tensor cores the gradients' error against
//      the plain version was 4.9e-4 of their norm (the checks allow 1e-4)
//      against 4.7e-6, and the launch was slower (kernel_variants.py's
//      tc_forward). The backward's bias only scales each gradient by a
//      fraction of an ulp. It writes each layer's output h_l and pre-
//      activation cotangent dpre_l to a scratch in device memory (8 KB per
//      row at the main path, 2.1 GB at N = 262,144), and its rows' stat sums.
//      The backward's activation gate reads h_l back from that scratch (this
//      block's own writes), which keeps two activation buffers in shared
//      memory.
//   2. The weight products dW = h_in^T dpre and db = sum(dpre) over rows,
//      split over up to 64 groups of rows (wgrad.cuh, shared with
//      rnn_ppo.cu): 128x128 tensor-core tiles for every layer and head, the
//      first layer's K = d_in and the 2- and 1-wide heads included. Each
//      group writes its own partial gradient. A chain's heads lie side by
//      side in its cotangent scratch ([mean | pre] for the continuous policy)
//      and each head is its own weight product.
//   3. The partials are summed over groups, and the stats over row blocks,
//      in a fixed order.
// The per-row loss terms (policy_row, continuous_row, value_row) are
// ppo_terms.cuh's, shared with rnn_ppo.cu.
// Rows past N exist in no buffer: the last row block masks them with
// selects and stores none of them.
#include <cuda_runtime.h>
#include <math.h>

#include "distmath.cuh"
#include "mlp.cuh"
#include "mma.cuh"
#include "ppo_terms.cuh"
#include "wgrad.cuh"

namespace {

using rl8::dense_layer;
using rl8::Job;
using rl8::Jobs;
using rl8::kCategorical;
using rl8::kSquashed;
using rl8::kRelu;
using rl8::kTanh;
using rl8::narrow_head;

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows per block of the row pass
constexpr int kMaxLayers = 8;
constexpr int kMaxHeads = 2;  // heads of a chain
static_assert(2 * (kMaxLayers + kMaxHeads) <= rl8::kMaxWgJobs, "weight-product jobs");
// tc_dense: rows of W per shared-memory stage, columns per pass, and a
// staged row (8 floats of padding make the B fragments' loads
// conflict-free).
constexpr int kSlice = 16;
constexpr int kWCols = 256;
constexpr int kWLd = kWCols + 8;
constexpr int kWFloats = 2 * kSlice * kWLd;
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use on an H100

// The loss's columns and constants (LossDims), and the shapes.
struct Dims : rl8::LossDims {
  long long N;
  int D, obs_col;
  int d_in, n_layers, act, max_hidden, sum_hidden;
  int ld;                              // row stride of the activation buffers in shared memory
  int hidden[kMaxLayers];
  int prefix[kMaxLayers];              // sum of hidden[:l]
  int n_heads[2], head_w[2];           // per chain: its heads, all head_w wide
  int n_out[2];                        // per chain: n_heads * head_w
  // Offset of each layer's W in params; index n_layers + j: head j's.
  long long woff[2][kMaxLayers + kMaxHeads];
  long long wtoff[2][kMaxLayers];      // offset of W^T in the transposed copy (layers >= 1)
  long long region[2];                 // each chain's offset in the row scratch
};

// Where everything lives: the parameter layout, and the workspace (floats):
// [W^T copies][row scratch: per chain h_l..., dpre_l..., dout][partials: groups x P][stats: blocks x 4].
struct Layout {
  Dims d;
  long long P, wt_floats, row_floats, part_floats, stat_floats, rows_per_group;
  int groups, row_blocks;
  size_t smem;  // the row pass's: the W stages, two activation buffers, the inputs, the heads, the row stats
};

// The policy chain has one head of act_dim * n_cat logits (categorical)
// or two of act_dim (mean, pre-tanh log-std); the value chain one of 1.
// False where the row pass does not fit a block's shared memory.
bool make_layout(int N, int d_in, int n_layers, const int* hidden, int kind, int act_dim,
                 int n_cat, Layout* L) {
  if (N <= 0 || d_in <= 0 || n_layers < 1 || n_layers > kMaxLayers || act_dim <= 0 ||
      kind < kCategorical || kind > kSquashed || (kind == kCategorical && n_cat < 2)) {
    return false;
  }
  Dims& d = L->d;
  d.N = N;
  d.d_in = d_in;
  d.n_layers = n_layers;
  d.kind = kind;
  d.act_dim = act_dim;
  d.n_cat = n_cat;
  d.n_heads[0] = kind == kCategorical ? 1 : 2;
  d.head_w[0] = kind == kCategorical ? act_dim * n_cat : act_dim;
  d.n_heads[1] = d.head_w[1] = 1;
  d.max_hidden = 0;
  d.sum_hidden = 0;
  for (int l = 0; l < kMaxLayers; ++l) {
    d.hidden[l] = l < n_layers ? hidden[l] : 0;
    if (l < n_layers && d.hidden[l] <= 0) return false;
    d.prefix[l] = d.sum_hidden;
    d.sum_hidden += d.hidden[l];
    if (d.hidden[l] > d.max_hidden) d.max_hidden = d.hidden[l];
  }
  // A multiple of 32 plus 4: the A fragments' loads hit 32 banks.
  d.ld = (d.max_hidden + 31) / 32 * 32 + 4;
  long long off = 0, wt = 0;
  for (int c = 0; c < 2; ++c) {
    long long in = d_in;
    for (int l = 0; l < n_layers; ++l) {
      d.woff[c][l] = off;
      off += in * d.hidden[l] + d.hidden[l];
      d.wtoff[c][l] = wt;
      if (l > 0) wt += (in * d.hidden[l] + 3) / 4 * 4;  // 16-byte aligned copies
      in = d.hidden[l];
    }
    d.n_out[c] = d.n_heads[c] * d.head_w[c];
    for (int j = 0; j < d.n_heads[c]; ++j) {
      d.woff[c][n_layers + j] = off;
      off += in * d.head_w[c] + d.head_w[c];
    }
  }
  L->P = off;
  L->wt_floats = wt;
  d.region[0] = 0;
  d.region[1] = (long long)N * (2 * d.sum_hidden + d.n_out[0]);
  L->row_floats = d.region[1] + (long long)N * (2 * d.sum_hidden + d.n_out[1]);
  rl8::split_rows(N, &L->groups, &L->rows_per_group);
  L->part_floats = (long long)L->groups * L->P;
  L->smem = sizeof(float) * ((size_t)kWFloats + (size_t)kRows * (2 * d.ld + ((d_in + 3) / 4 * 4) + d.n_out[0] + 4));
  L->row_blocks = (N + kRows - 1) / kRows;
  L->stat_floats = 4LL * L->row_blocks;
  return L->smem <= kMaxSmem;
}

// ---------------------------------------------------------------- row pass

// The head weight of chain c for concatenated output column o and input k.
__device__ __forceinline__ float head_weight(const float* params, const Dims& d, int c, int o, int k) {
  const int w = d.head_w[c];
  return __ldg(params + d.woff[c][d.n_layers + o / w] + (size_t)k * w + o % w);
}

// out[r, n] = sum_k in[r, k] W[k, n] for the block's kRows rows, on the
// tensor cores (mma.cuh's 3xTF32). in [kRows, K] in shared memory, rows ld
// apart (a multiple of 32 plus 4); W [K, N] row-major in device memory,
// streamed kSlice rows at a time through the two stages of ws with
// cp.async, the next slice's copies in flight during this one's products;
// out [kRows, N] in shared memory, rows ld apart. The 8 warps split the
// rows 2 ways (an m16 tile each) and the columns 4 ways (n tiles of 8
// interleaved), over passes of kWCols columns.
__device__ void tc_dense(const float* in, int K, const float* __restrict__ W, int N, float* out, int ld, float* ws) {
  constexpr int MT = kRows / 32;  // m16 tiles per warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int m0 = (warp / 4) * (kRows / 2), wn = warp % 4;
  const bool vec = reinterpret_cast<uintptr_t>(W) % 16 == 0 && N % 4 == 0;
  const int slices = (K + kSlice - 1) / kSlice;
  for (int n0 = 0; n0 < N; n0 += kWCols) {
    const int nw = min(kWCols, N - n0);
    auto issue = [&](int s) {
      if (s < slices) {
        float* dst = ws + (s & 1) * kSlice * kWLd;
        const int kb = s * kSlice;
        if (vec) {
#pragma unroll
          for (int u = 0; u < kSlice * kWCols / 4 / kThreads; ++u) {
            const int i = threadIdx.x + u * kThreads;
            const int r = i / (kWCols / 4), col = 4 * (i % (kWCols / 4));
            if (col < nw) {
              const int bytes = kb + r < K ? 4 * min(4, nw - col) : 0;
              rl8::cp_async16(dst + r * kWLd + col, bytes ? W + (size_t)(kb + r) * N + n0 + col : W, bytes);
            }
          }
        } else {
#pragma unroll 4
          for (int u = 0; u < kSlice * kWCols / kThreads; ++u) {
            const int i = threadIdx.x + u * kThreads;
            const int r = i / kWCols, col = i % kWCols;
            if (col < nw) {
              const int bytes = kb + r < K ? 4 : 0;
              rl8::cp_async4(dst + r * kWLd + col, bytes ? W + (size_t)(kb + r) * N + n0 + col : W, bytes);
            }
          }
        }
      }
      rl8::cp_async_commit();
    };
    float acc[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.0f;
    issue(0);
    for (int s = 0; s < slices; ++s) {
      issue(s + 1);
      rl8::cp_async_wait<1>();
      __syncthreads();  // slice s has landed in every thread's view
      const float* Ws = ws + (s & 1) * kSlice * kWLd;
#pragma unroll
      for (int ks = 0; ks < kSlice; ks += 8) {
        const int k = s * kSlice + ks + tq;
        if (k - tq < K) {
          // Columns of `in` at or past K hold no input: read as 0 (W's
          // rows past K are zero-filled).
          const bool lo = k < K, hi = k + 4 < K;
          rl8::FragA fa[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float* a = in + (m0 + mt * 16 + g) * ld + k;
            fa[mt].set(lo ? a[0] : 0.0f, lo ? a[8 * ld] : 0.0f, hi ? a[4] : 0.0f, hi ? a[8 * ld + 4] : 0.0f);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int nt = wn + 4 * i;
            if (nt * 8 < nw) {
              const float* w = Ws + (ks + tq) * kWLd + nt * 8 + g;
              rl8::FragB fb;
              fb.set(w[0], w[4 * kWLd]);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) rl8::mma_3xtf32(acc[mt][i], fa[mt], fb);
            }
          }
        }
      }
      __syncthreads();  // every warp is done with the stage that slice s + 2 fills
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = n0 + (wn + 4 * i) * 8 + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col + (e & 1);
        if (c < n0 + nw) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) out[(m0 + mt * 16 + g + (e >= 2 ? 8 : 0)) * ld + c] = acc[mt][i][e];
        }
      }
    }
  }
}

// dst[r * w + k] = src[r * ld + k] for the block's first nr rows.
__device__ __forceinline__ void store_rows(const float* src, int ld, int nr, int w, float* __restrict__ dst) {
  for (int k = threadIdx.x; k < w; k += blockDim.x) {
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      if (r < nr) dst[(size_t)r * w + k] = src[r * ld + k];
    }
  }
}

template <bool kContinuous>
__global__ void __launch_bounds__(kThreads, 2)
    ppo_rows_kernel(const int* __restrict__ packed, const float* __restrict__ ec,
                    const float* __restrict__ params, const float* __restrict__ wt,
                    float* __restrict__ scratch, float* __restrict__ stat_part, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d.ld;
  float* ws = smem;                                    // tc_dense's W stages
  float* ga = ws + kWFloats;                           // [kRows, ld]: layer outputs, dh
  float* gb = ga + kRows * ld;                             // [kRows, ld]
  float* xs = gb + kRows * ld;                             // [kRows, d_in]
  float* head = xs + kRows * ((d.d_in + 3) / 4 * 4);       // [kRows, n_out]: outputs, then cotangents
  float* rowv = head + kRows * d.n_out[0];                 // [kRows, 4]: pol, vf, ent, kl

  const long long r0 = (long long)blockIdx.x * kRows;
  const int nr = (int)min((long long)kRows, d.N - r0);
  const float* packed_f = reinterpret_cast<const float*>(packed);
  for (int i = threadIdx.x; i < kRows * d.d_in; i += blockDim.x) {
    const int r = i / d.d_in;
    xs[i] = r < nr ? packed_f[(r0 + r) * d.D + d.obs_col + i % d.d_in] : 0.0f;
  }
  const float ec_scale = d.use_entropy ? ec[0] * d.scale : 0.0f;
  __syncthreads();

  for (int c = 0; c < 2; ++c) {
    float* region = scratch + d.region[c];
    const int n_out = d.n_out[c];
    // Forward; every layer's output also goes to the scratch, where the
    // weight products and this block's backward read it.
    const float* cur = xs;
    int cur_w = d.d_in;
    for (int l = 0; l < d.n_layers; ++l) {
      const int w = d.hidden[l];
      float* dst = (l & 1) ? gb : ga;
      const float* W = params + d.woff[c][l];
      dense_layer<kRows>(cur, cur_w, W, W + (size_t)cur_w * w, dst, w, d.act, ld, l == 0 ? 0 : ld);
      __syncthreads();
      store_rows(dst, ld, nr, w, region + (size_t)d.N * d.prefix[l] + (size_t)r0 * w);
      cur = dst;
      cur_w = w;
    }
    for (int j = 0; j < d.n_heads[c]; ++j) {
      const int w = d.head_w[c];
      const float* Wh = params + d.woff[c][d.n_layers + j];
      narrow_head<kRows>(cur, cur_w, Wh, Wh + (size_t)cur_w * w, w, head, n_out, j * w, ld);
    }
    __syncthreads();
    // Losses and head cotangents, a thread per row; rows past N get zeros.
    if (threadIdx.x < kRows) {
      const int r = threadIdx.x;
      float* z = head + r * n_out;
      float* v = rowv + r * 4;
      if (r < nr) {
        const int* row = packed + (r0 + r) * d.D;
        if (c == 0) {
          if constexpr (kContinuous) {
            rl8::continuous_row(row, z, v, d, ec_scale);
          } else {
            rl8::policy_row(row, z, v, d, ec_scale);
          }
        } else {
          rl8::value_row(row, z, v, d);
        }
      } else {
        for (int o = 0; o < n_out; ++o) z[o] = 0.0f;
        if (c == 0) {
          v[0] = v[2] = v[3] = 0.0f;
        } else {
          v[1] = 0.0f;
        }
      }
    }
    __syncthreads();
    float* dout = region + (size_t)d.N * 2 * d.sum_hidden + (size_t)r0 * n_out;
    for (int i = threadIdx.x; i < nr * n_out; i += blockDim.x) dout[i] = head[i];
    // dh_L = dout @ Wh^T over the chain's heads: they are narrow, so a loop
    // over their outputs.
    float* dh = ga;
    for (int k = threadIdx.x; k < cur_w; k += blockDim.x) {
      float acc[kRows];
      const float w0 = head_weight(params, d, c, 0, k);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = head[r * n_out] * w0;
      for (int o = 1; o < n_out; ++o) {
        const float w = head_weight(params, d, c, o, k);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(head[r * n_out + o], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) dh[r * ld + k] = acc[r];
    }
    __syncthreads();
    // Down the chain: dpre_l = dh_l * act'(h_l), stored; dh_{l-1} = dpre_l W_l^T.
    for (int l = d.n_layers - 1; l >= 0; --l) {
      const int w = d.hidden[l];
      // This block's h_l rows, written above and visible after the
      // barriers since; rows past N have no h, and a zero dh.
      const float* h = region + (size_t)d.N * d.prefix[l] + (size_t)r0 * w;
      for (int k = threadIdx.x; k < w; k += blockDim.x) {
#pragma unroll 8
        for (int r = 0; r < kRows; ++r) {
          const float hv = r < nr ? h[(size_t)r * w + k] : 0.0f;
          dh[r * ld + k] *= d.act == kRelu ? (hv > 0.0f ? 1.0f : 0.0f) : 1.0f - hv * hv;
        }
      }
      __syncthreads();
      store_rows(dh, ld, nr, w, region + (size_t)d.N * (d.sum_hidden + d.prefix[l]) + (size_t)r0 * w);
      if (l > 0) {
        float* next = dh == ga ? gb : ga;
        tc_dense(dh, w, wt + d.wtoff[c][l], d.hidden[l - 1], next, ld, ws);
        __syncthreads();
        dh = next;
      }
    }
    __syncthreads();  // the next chain reuses every buffer
  }
  if (threadIdx.x < 4) {
    float s = 0.0f;
    for (int r = 0; r < nr; ++r) s += rowv[r * 4 + threadIdx.x];
    stat_part[(size_t)blockIdx.x * 4 + threadIdx.x] = s;
  }
}

}  // namespace

// Floats of workspace that rl8_ppo_grads needs for these shapes, or -1.
extern "C" long long rl8_ppo_workspace(int N, int d_in, int n_layers, const int* hidden, int kind,
                                       int act_dim, int n_cat) {
  Layout L;
  if (!make_layout(N, d_in, n_layers, hidden, kind, act_dim, n_cat, &L)) return -1;
  return L.wt_floats + L.row_floats + L.part_floats + L.stat_floats;
}

// cols: obs, actions, logp, advantages, returns (first column of each);
// the action columns are int32 for the categorical kind and f32 bit
// patterns for the continuous ones. grads [P] and stats [4] (policy, vf,
// entropy, kl sums) are outputs.
extern "C" int rl8_ppo_grads(const int* packed, int N, int D, const int* cols, const float* ec,
                             const float* params, float* grads, float* stats, float* workspace,
                             int d_in, int n_layers, const int* hidden, int kind, int act_dim,
                             int n_cat, int act, float clip_lo, float clip_hi, float dual,
                             float vf_clip, float vf_scale, float scale, int use_entropy,
                             int device, void* stream) {
  Layout L;
  if (!make_layout(N, d_in, n_layers, hidden, kind, act_dim, n_cat, &L) ||
      (act != kRelu && act != kTanh) || (kind == kSquashed && use_entropy)) {
    return (int)cudaErrorInvalidValue;
  }
  Dims& d = L.d;
  d.D = D;
  d.obs_col = cols[0];
  d.act_col = cols[1];
  d.logp_col = cols[2];
  d.adv_col = cols[3];
  d.ret_col = cols[4];
  if (d.obs_col < 0 || d.obs_col + d_in > D || d.act_col < 0 || d.act_col + act_dim > D ||
      d.logp_col < 0 || d.logp_col >= D || d.adv_col < 0 || d.adv_col >= D || d.ret_col < 0 ||
      d.ret_col >= D) {
    return (int)cudaErrorInvalidValue;
  }
  d.act = act;
  d.clip_lo = clip_lo;
  d.clip_hi = clip_hi;
  d.dual = dual;
  d.vf_clip = vf_clip;
  d.vf_scale = vf_scale;
  d.scale = scale;
  d.use_entropy = use_entropy;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float* wt = workspace;
  float* rows = wt + L.wt_floats;
  float* partials = rows + L.row_floats;
  float* stat_part = partials + L.part_floats;

  for (int c = 0; c < 2; ++c) {
    for (int l = 1; l < n_layers; ++l) {
      const int K = d.hidden[l - 1], J = d.hidden[l];
      rl8::transpose_kernel<<<rl8::grid_for((long long)K * J), kThreads, 0, s>>>(
          params + d.woff[c][l], wt + d.wtoff[c][l], K, J);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }

  const auto rows_kernel = kind == kCategorical ? ppo_rows_kernel<false> : ppo_rows_kernel<true>;
  err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
  if (err != cudaSuccess) return (int)err;
  rows_kernel<<<L.row_blocks, kThreads, L.smem, s>>>(packed, ec, params, wt, rows, stat_part, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  Jobs tiled;
  tiled.n = 0;
  tiled.inner_rows = 1;
  tiled.rows_per_group = L.rows_per_group;
  tiled.rows = N;
  tiled.P = L.P;
  int tiles = 0;
  for (int c = 0; c < 2; ++c) {
    const float* region = rows + d.region[c];
    // Jobs l < n_layers are the layers, then one per head.
    for (int l = 0; l < n_layers + d.n_heads[c]; ++l) {
      Job jb;
      const bool is_head = l >= n_layers;
      const int in_l = is_head ? n_layers : l;  // the layer whose input this job reads
      jb.K = in_l == 0 ? d_in : d.hidden[in_l - 1];
      jb.J = is_head ? d.head_w[c] : d.hidden[l];
      jb.bias = 1;
      jb.a_inner = jb.b_inner = 0;
      if (in_l == 0) {
        jb.a = reinterpret_cast<const float*>(packed) + d.obs_col;
        jb.a_outer = D;
      } else {
        jb.a = region + (size_t)N * d.prefix[in_l - 1];
        jb.a_outer = d.hidden[in_l - 1];
      }
      if (is_head) {
        jb.b = region + (size_t)N * 2 * d.sum_hidden + (size_t)(l - n_layers) * d.head_w[c];
        jb.b_outer = d.n_out[c];
      } else {
        jb.b = region + (size_t)N * (d.sum_hidden + d.prefix[l]);
        jb.b_outer = jb.J;
      }
      jb.off = d.woff[c][l];
      rl8::add_tiled(jb, &tiled, &tiles);
    }
  }
  return (int)rl8::launch_wgrad(tiled, tiles, L.groups, partials, grads, stat_part, L.row_blocks,
                                stats, s);
}

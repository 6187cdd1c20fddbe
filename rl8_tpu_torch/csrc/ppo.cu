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
//     value head), f32 end to end with no tensor cores;
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
// shapes): the forward is 132,352 MACs per row and the
// backward 264,192 (dW and dh of both 256x256 layers, the heads, dW of the
// first layers), 2.08e11 FLOP per launch, against ~6.3 MB of inputs and
// outputs, so f32 CUDA-core FMAs bound it: 3.10 ms at 67 TFLOP/s.
//
// Design. On the TPU the grid runs in order, so every grid step adds its
// rows' gradient into VMEM-resident accumulators. CUDA blocks run in
// parallel, and one 256x256 f32 dW (256 KB) does not fit a block's shared
// memory, so the work is split in passes, with no float atomics (the
// result is bit-identical from launch to launch):
//   1. ppo_rows_kernel: a block owns kRows = 32 rows (the act kernel's
//      layout, mlp.cuh, with twice its rows so that each weight read from L2
//      feeds twice the FMAs): it runs each chain's forward with the current
//      layer's activations in shared memory, the per-row losses and head
//      cotangents, and the backward of dh down the chain (dh_{l-1} =
//      dpre_l W_l^T, against a transposed copy of W_l so that warps read
//      weights coalesced). It writes each layer's output h_l and
//      pre-activation cotangent dpre_l to a scratch in device memory (8 KB
//      per row at the main path, 2.1 GB at N = 262,144), and its rows' stat
//      sums. The backward reads h_l back from that scratch, which keeps a
//      block at ~66 KB of shared memory (three per SM): on an H100 SXM,
//      keeping every layer in shared memory instead took 35% longer at 32
//      rows (PERF.md).
//   2. The weight products dW = h_in^T dpre and db = sum(dpre) over rows,
//      split over up to 64 groups of rows: a 64x64-tiled kernel (4x4 outputs
//      per thread) for wide layers, and a thread-per-output kernel for
//      narrow ones (the obs dim is 1, the heads 2 and 1 wide, or 1 each),
//      which the TPU ran as VPU loops. Both stage chunks of rows through
//      shared memory. Each group writes its own partial gradient. A chain's
//      heads lie side by side in its cotangent scratch ([mean | pre] for
//      the continuous policy) and each head is its own weight product.
//   3. The partials are summed over groups, and the stats over row blocks,
//      in a fixed order.
// Rows past N exist in no buffer: the last row block masks them with
// selects and stores none of them.
#include <cuda_runtime.h>
#include <math.h>

#include "distmath.cuh"
#include "mlp.cuh"

namespace {

using rl8::dense_layer;
using rl8::kCategorical;
using rl8::kSquashed;
using rl8::kIdentity;
using rl8::kRelu;
using rl8::kTanh;
using rl8::narrow_head;

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows per block of the row pass
constexpr int kMaxLayers = 8;
constexpr int kTile = 64;          // tiled weight products: outputs per tile side
constexpr int kChunk = 32;         // tiled weight products: rows per shared-memory stage
constexpr int kNarrowPer = 16;     // narrow weight products: outputs per thread
constexpr int kNarrowSmem = 8192;  // narrow weight products: floats of a staged row chunk
constexpr int kStageBatch = 8;     // narrow weight products: loads in flight per thread
constexpr int kMaxGroups = 64;     // split of the rows for the weight products
constexpr int kGroupRows = 4096;   // rows per group below the cap
constexpr int kMaxHeads = 2;       // heads of a chain
constexpr int kMaxJobs = 2 * (kMaxLayers + kMaxHeads);

struct Dims {
  long long N;
  int D, obs_col, act_col, logp_col, adv_col, ret_col;
  int d_in, n_layers, kind, act_dim, n_cat, act, max_hidden, sum_hidden;
  int hidden[kMaxLayers];
  int prefix[kMaxLayers];              // sum of hidden[:l]
  int n_heads[2], head_w[2];           // per chain: its heads, all head_w wide
  int n_out[2];                        // per chain: n_heads * head_w
  // Offset of each layer's W in params; index n_layers + j: head j's.
  long long woff[2][kMaxLayers + kMaxHeads];
  long long wtoff[2][kMaxLayers];      // offset of W^T in the transposed copy (layers >= 1)
  long long region[2];                 // each chain's offset in the row scratch
  float clip_lo, clip_hi, dual, vf_clip, vf_scale, scale;
  int use_entropy;
};

// Where everything lives: the parameter layout, and the workspace (floats):
// [W^T copies][row scratch: per chain h_l..., dpre_l..., dout][partials: groups x P][stats: blocks x 4].
struct Layout {
  Dims d;
  long long P, wt_floats, row_floats, part_floats, stat_floats;
  int groups, rows_per_group, row_blocks;
};

// The policy chain has one head of act_dim * n_cat logits (categorical)
// or two of act_dim (mean, pre-tanh log-std); the value chain one of 1.
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
  long long off = 0, wt = 0;
  for (int c = 0; c < 2; ++c) {
    long long in = d_in;
    for (int l = 0; l < n_layers; ++l) {
      d.woff[c][l] = off;
      off += in * d.hidden[l] + d.hidden[l];
      d.wtoff[c][l] = wt;
      if (l > 0) wt += in * d.hidden[l];
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
  int groups = (N + kGroupRows - 1) / kGroupRows;
  L->groups = groups < 1 ? 1 : (groups > kMaxGroups ? kMaxGroups : groups);
  L->rows_per_group = (N + L->groups - 1) / L->groups;
  L->part_floats = (long long)L->groups * L->P;
  L->row_blocks = (N + kRows - 1) / kRows;
  L->stat_floats = 4LL * L->row_blocks;
  return true;
}

// ---------------------------------------------------------------- row pass

// The dual-clipped surrogate of one row: writes its policy and kl elements
// to v[0] and v[3] and returns u, the loss's cotangent on new_logp.
__device__ __forceinline__ float surrogate(const int* row, float new_logp, float* v, const Dims& d) {
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

// One row's categorical policy terms: z holds its logits [A * n] and gets
// dlogits. Writes the row's policy, entropy and kl elements to v[0], v[2],
// v[3].
__device__ __forceinline__ void policy_row(const int* row, float* z, float* v, const Dims& d, float ec_scale) {
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

// One dim of a continuous row: log_std and inv_var from the pre-tanh head,
// diff (x - mean, or through the clipped atanh when squashed), the base
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
    const float c = rl8::squash_clip(x);
    t.diff = rl8::clipped_atanh(c) - mean;
    t.log_det = rl8::squash_log_det(c);
  } else {
    t.diff = x - mean;
  }
  t.base = rl8::normal_per_dim_logp(t.diff, t.log_std, t.inv_var);
  return t;
}

// One row's continuous policy terms: z holds its [mean | pre-tanh log-std]
// heads [2A] and gets their cotangents. Writes the row's policy, entropy and
// kl elements to v[0], v[2], v[3].
__device__ __forceinline__ void continuous_row(const int* row, float* z, float* v, const Dims& d,
                                               float ec_scale) {
  const int A = d.act_dim;
  const bool squashed = d.kind == kSquashed;
  float logp_sum = 0.0f, det_sum = 0.0f, ent = 0.0f;
  for (int a = 0; a < A; ++a) {
    const DimTerms t = dim_terms(__int_as_float(row[d.act_col + a]), z[a], z[A + a], squashed);
    logp_sum += squashed ? rl8::clamp100(t.base) : t.base;
    det_sum += t.log_det;
    if (d.use_entropy) ent += rl8::kNormalEntropy + t.log_std;
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

// One row's value terms: z[0] holds its value and gets dv; v[1] gets the
// clamped smooth-L1 element.
__device__ __forceinline__ void value_row(const int* row, float* z, float* v, const Dims& d) {
  const float diff = z[0] - __int_as_float(row[d.ret_col]);
  const float ad = fabsf(diff);
  const float sl1 = ad < 1.0f ? 0.5f * diff * diff : ad - 0.5f;
  const float sign = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
  const float dsl1 = ad < 1.0f ? diff : sign;
  v[1] = fminf(fmaxf(sl1, 0.0f), d.vf_clip);
  z[0] = (sl1 < d.vf_clip ? dsl1 : 0.0f) * d.vf_scale;
}

// The head weight of chain c for concatenated output column o and input k.
__device__ __forceinline__ float head_weight(const float* params, const Dims& d, int c, int o, int k) {
  const int w = d.head_w[c];
  return __ldg(params + d.woff[c][d.n_layers + o / w] + (size_t)k * w + o % w);
}

template <bool kContinuous>
__global__ void __launch_bounds__(kThreads)
    ppo_rows_kernel(const int* __restrict__ packed, const float* __restrict__ ec,
                    const float* __restrict__ params, const float* __restrict__ wt,
                    float* __restrict__ scratch, float* __restrict__ stat_part, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                             // [kRows, d_in]
  float* ga = xs + kRows * d.d_in;              // [kRows, max_hidden]: layer outputs, dh
  float* gb = ga + kRows * d.max_hidden;        // [kRows, max_hidden]
  float* head = gb + kRows * d.max_hidden;      // [kRows, n_out]: outputs, then cotangents
  float* rowv = head + kRows * d.n_out[0];      // [kRows, 4]: pol, vf, ent, kl

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
      dense_layer<kRows>(cur, cur_w, W, W + (size_t)cur_w * w, dst, w, d.act);
      __syncthreads();
      float* g = region + (size_t)d.N * d.prefix[l] + (size_t)r0 * w;
      for (int i = threadIdx.x; i < nr * w; i += blockDim.x) g[i] = dst[i];
      cur = dst;
      cur_w = w;
    }
    for (int j = 0; j < d.n_heads[c]; ++j) {
      const int w = d.head_w[c];
      const float* Wh = params + d.woff[c][d.n_layers + j];
      narrow_head<kRows>(cur, cur_w, Wh, Wh + (size_t)cur_w * w, w, head, n_out, j * w);
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
            continuous_row(row, z, v, d, ec_scale);
          } else {
            policy_row(row, z, v, d, ec_scale);
          }
        } else {
          value_row(row, z, v, d);
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
      for (int r = 0; r < kRows; ++r) dh[r * cur_w + k] = acc[r];
    }
    __syncthreads();
    // Down the chain: dpre_l = dh_l * act'(h_l), stored; dh_{l-1} = dpre_l W_l^T.
    for (int l = d.n_layers - 1; l >= 0; --l) {
      const int w = d.hidden[l];
      // This block's h_l rows, written above and visible after the
      // barriers since; rows past N have no h, and a zero dh.
      const float* h = region + (size_t)d.N * d.prefix[l] + (size_t)r0 * w;
      for (int i = threadIdx.x; i < kRows * w; i += blockDim.x) {
        const float hv = i < nr * w ? h[i] : 0.0f;
        dh[i] *= d.act == kRelu ? (hv > 0.0f ? 1.0f : 0.0f) : 1.0f - hv * hv;
      }
      __syncthreads();
      float* g = region + (size_t)d.N * (d.sum_hidden + d.prefix[l]) + (size_t)r0 * w;
      for (int i = threadIdx.x; i < nr * w; i += blockDim.x) g[i] = dh[i];
      if (l > 0) {
        float* next = dh == ga ? gb : ga;
        dense_layer<kRows>(dh, w, wt + d.wtoff[c][l], nullptr, next, d.hidden[l - 1], kIdentity);
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

// WT [J, K] = W [K, J]^T.
__global__ void transpose_kernel(const float* __restrict__ W, float* __restrict__ WT, int K,
                                 int J) {
  const long long total = (long long)K * J;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    WT[(i % J) * K + i / J] = W[i];
  }
}

// ---------------------------------------------------------- weight products

// One layer's (or head's) gradient: C[K + 1, J] = [A | 1]^T B over rows,
// i.e. dW [K, J] followed by db [J], which is how W and b lie in the flat
// parameter vector from offset `off`.
struct Job {
  const float* a;  // [N, K] at row stride lda (the layer's input)
  const float* b;  // [N, J] at row stride ldb (the layer's pre-activation cotangent)
  long long lda, ldb, off;
  int K, J, tiles_j, tile0;
};

struct Jobs {
  Job job[kMaxJobs];
  int n;
  int rows_per_group;
  long long N, P;
};

// The job of a block, selected with constant indices so the table stays in
// the parameter bank.
__device__ __forceinline__ Job select_job(const Jobs& js, int index, bool by_tile) {
  Job jb = js.job[0];
#pragma unroll
  for (int q = 1; q < kMaxJobs; ++q) {
    if (q < js.n && (by_tile ? js.job[q].tile0 <= index : q == index)) jb = js.job[q];
  }
  return jb;
}

// Wide layers: a block owns a 64x64 tile of dW for one group of rows and
// walks the group 32 rows at a time through shared memory; each thread
// keeps 4x4 outputs. The blocks of the first k tile also sum db.
__global__ void __launch_bounds__(kThreads)
    reduce_tiled_kernel(Jobs js, float* __restrict__ partials) {
  __shared__ __align__(16) float As[kChunk][kTile];
  __shared__ __align__(16) float Bs[kChunk][kTile];
  const Job jb = select_job(js, blockIdx.x, true);
  const int t = blockIdx.x - jb.tile0;
  const int k0 = (t / jb.tiles_j) * kTile;
  const int j0 = (t % jb.tiles_j) * kTile;
  const long long n_begin = (long long)blockIdx.y * js.rows_per_group;
  const long long n_end = min(js.N, n_begin + js.rows_per_group);
  const int tk = threadIdx.x / 16 * 4;
  const int tj = threadIdx.x % 16 * 4;
  const bool do_bias = k0 == 0 && threadIdx.x < kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float bias = 0.0f;
  for (long long n0 = n_begin; n0 < n_end; n0 += kChunk) {
#pragma unroll
    for (int u = 0; u < kChunk * kTile / kThreads; ++u) {
      const int rr = (threadIdx.x + u * kThreads) / kTile;
      const int cc = threadIdx.x % kTile;
      const long long n = n0 + rr;
      As[rr][cc] = (n < n_end && k0 + cc < jb.K) ? jb.a[n * jb.lda + k0 + cc] : 0.0f;
      Bs[rr][cc] = (n < n_end && j0 + cc < jb.J) ? jb.b[n * jb.ldb + j0 + cc] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kChunk; ++rr) {
      const float4 av = *reinterpret_cast<const float4*>(&As[rr][tk]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[rr][tj]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
    if (do_bias) {
      for (int rr = 0; rr < kChunk; ++rr) bias += Bs[rr][threadIdx.x];
    }
    __syncthreads();
  }
  float* out = partials + (size_t)blockIdx.y * js.P + jb.off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tk + i;
      const int col = j0 + tj + j;
      if (k < jb.K && col < jb.J) out[(size_t)k * jb.J + col] = acc[i][j];
    }
  }
  if (do_bias && j0 + threadIdx.x < jb.J) out[(size_t)jb.K * jb.J + j0 + threadIdx.x] = bias;
}

// dst[r * width + c] = src[r * ld + c] for r < rows, c < width, with each
// thread's loads issued in batches of kStageBatch before their stores, so
// that they wait on device memory together rather than one by one.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, long long ld, int width,
                                           int rows, float* dst) {
  const int total = rows * width;
  for (int base = threadIdx.x; base < total; base += kThreads * kStageBatch) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < total ? src[(i / width) * ld + i % width] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < total) dst[i] = v[u];
    }
  }
}

// Narrow layers ((K + 1) * J <= kThreads * kNarrowPer): a block per job and
// group of rows, a thread per output of C[K + 1, J] (row K is the bias).
// The block stages chunks of rows of A and B through shared memory with
// all its threads, so that many loads are in flight at once, and each
// thread then sums its outputs from shared memory.
__global__ void __launch_bounds__(kThreads)
    reduce_narrow_kernel(Jobs js, float* __restrict__ partials) {
  __shared__ __align__(16) float sm[kNarrowSmem];
  const Job jb = select_job(js, blockIdx.x, false);
  const long long n_begin = (long long)blockIdx.y * js.rows_per_group;
  const long long n_end = min(js.N, n_begin + js.rows_per_group);
  const int K = jb.K, J = jb.J;
  const int outputs = (K + 1) * J;
  const int chunk = min(kChunk, kNarrowSmem / (K + J));
  float* As = sm;              // [chunk, K]
  float* Bs = sm + chunk * K;  // [chunk, J]
  int rk[kNarrowPer], cj[kNarrowPer];
  float acc[kNarrowPer];
#pragma unroll
  for (int i = 0; i < kNarrowPer; ++i) {
    const int o = threadIdx.x + i * kThreads;
    rk[i] = o / J;
    cj[i] = o % J;
    acc[i] = 0.0f;
  }
  for (long long n0 = n_begin; n0 < n_end; n0 += chunk) {
    const int rows = (int)min((long long)chunk, n_end - n0);
    stage_rows(jb.a + n0 * jb.lda, jb.lda, K, rows, As);
    stage_rows(jb.b + n0 * jb.ldb, jb.ldb, J, rows, Bs);
    __syncthreads();
    for (int rr = 0; rr < rows; ++rr) {
#pragma unroll
      for (int i = 0; i < kNarrowPer; ++i) {
        if (threadIdx.x + i * kThreads < outputs) {
          const float av = rk[i] < K ? As[rr * K + rk[i]] : 1.0f;
          acc[i] = fmaf(av, Bs[rr * J + cj[i]], acc[i]);
        }
      }
    }
    __syncthreads();
  }
  float* out = partials + (size_t)blockIdx.y * js.P + jb.off;
#pragma unroll
  for (int i = 0; i < kNarrowPer; ++i) {
    const int o = threadIdx.x + i * kThreads;
    if (o < outputs) out[o] = acc[i];
  }
}

// grads[p] = sum over groups of partials[g, p], in order of g.
__global__ void sum_partials_kernel(const float* __restrict__ partials, int groups, long long P,
                                    float* __restrict__ grads) {
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += (long long)gridDim.x * blockDim.x) {
    float s = partials[p];
    for (int g = 1; g < groups; ++g) s += partials[(size_t)g * P + p];
    grads[p] = s;
  }
}

// stats[s] = sum over row blocks of stat_part[b, s]: strided sums per
// thread, then a tree in shared memory, both in a fixed order.
__global__ void __launch_bounds__(kThreads)
    sum_stats_kernel(const float* __restrict__ stat_part, int blocks, float* __restrict__ stats) {
  __shared__ float sh[4][kThreads];
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] += stat_part[(size_t)b * 4 + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sh[i][threadIdx.x] = s[i];
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sh[i][threadIdx.x] += sh[i][threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x < 4) stats[threadIdx.x] = sh[threadIdx.x][0];
}

int grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return (int)(blocks < 1 ? 1 : (blocks > 4096 ? 4096 : blocks));
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
      transpose_kernel<<<grid_for((long long)K * J), kThreads, 0, s>>>(
          params + d.woff[c][l], wt + d.wtoff[c][l], K, J);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }

  const size_t smem = sizeof(float) * (size_t)kRows *
                      (d_in + 2 * d.max_hidden + d.n_out[0] + 4);
  const auto rows_kernel =
      kind == kCategorical ? ppo_rows_kernel<false> : ppo_rows_kernel<true>;
  err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rows_kernel<<<L.row_blocks, kThreads, smem, s>>>(packed, ec, params, wt, rows, stat_part, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  Jobs tiled, narrow;
  tiled.n = narrow.n = 0;
  tiled.rows_per_group = narrow.rows_per_group = L.rows_per_group;
  tiled.N = narrow.N = N;
  tiled.P = narrow.P = L.P;
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
      if (in_l == 0) {
        jb.a = reinterpret_cast<const float*>(packed) + d.obs_col;
        jb.lda = D;
      } else {
        jb.a = region + (size_t)N * d.prefix[in_l - 1];
        jb.lda = d.hidden[in_l - 1];
      }
      if (is_head) {
        jb.b = region + (size_t)N * 2 * d.sum_hidden + (size_t)(l - n_layers) * d.head_w[c];
        jb.ldb = d.n_out[c];
      } else {
        jb.b = region + (size_t)N * (d.sum_hidden + d.prefix[l]);
        jb.ldb = jb.J;
      }
      jb.off = d.woff[c][l];
      if ((long long)(jb.K + 1) * jb.J <= (long long)kThreads * kNarrowPer) {
        jb.tiles_j = jb.tile0 = 0;
        narrow.job[narrow.n++] = jb;
      } else {
        jb.tiles_j = (jb.J + kTile - 1) / kTile;
        jb.tile0 = tiles;
        tiles += jb.tiles_j * ((jb.K + kTile - 1) / kTile);
        tiled.job[tiled.n++] = jb;
      }
    }
  }
  if (tiled.n > 0) {
    reduce_tiled_kernel<<<dim3(tiles, L.groups), kThreads, 0, s>>>(tiled, partials);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (narrow.n > 0) {
    reduce_narrow_kernel<<<dim3(narrow.n, L.groups), kThreads, 0, s>>>(narrow, partials);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  sum_partials_kernel<<<grid_for(L.P), kThreads, 0, s>>>(partials, L.groups, L.P, grads);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_stats_kernel<<<1, kThreads, 0, s>>>(stat_part, L.row_blocks, stats);
  return (int)cudaGetLastError();
}

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
//   1. The row pass, on one of two routes that the shapes fix at build
//      (make_layout): each chain's forward, the per-row losses and head
//      cotangents, and the backward of dh down the chain, writing each
//      layer's output h_l and pre-activation cotangent dpre_l to a row
//      scratch in device memory (8 KB a row at the main path, 2.1 GB at N =
//      262,144) for the weight products, and its rows' stat sums. The
//      forward stays in f32 on the CUDA cores, each output summed in order
//      of k: the tensor cores round toward zero (mma.cuh), their bias in h_l
//      reaches the logits and values, and the loss's cotangents sum it over
//      every row (with the forward's products on the tensor cores the
//      gradients' error against the plain version was 4.9e-4 of their norm,
//      the checks allow 1e-4; kernel_variants.py's tc_forward). The dh
//      products run on the tensor cores in 3xTF32; their bias only scales
//      each gradient by a fraction of an ulp.
//      The staged route (every minibatch of at least kStagedMinRows rows
//      whose widest layer has kStagedMinWidth units or more, the main path
//      among them, and every shape whose narrow row pass does not fit a
//      block's shared memory: layers wider than 736 at the dummy envs'
//      shapes, or heads too wide for it) runs two kernels over blocks of
//      128 rows (stage.cuh's kStRows), one block an SM, which keep every
//      activation, head row and cotangent in the row scratch (its slabs
//      padded to whole row blocks, NP rows; the block's input rows copied to
//      a slab of their own) and stream each product's operands through a
//      3-stage ring in shared memory, 32 deep in k: the block's rows by
//      cp.async, each weight slab by one bulk copy (the TMA unit) counted by
//      the stage's mbarrier (stage.cuh's StRing), from copies of the weights
//      in the stages' layout that the launch makes once.
//      ppo_staged_fwd_kernel runs each chain's forward register-tiled, 8 rows
//      x 16 columns a thread in 256-column passes (stage.cuh's fwd_product),
//      then the top layer's epilogue through shared memory, as many rows a
//      round as fit (all 128 at 256 wide): the rows of h_L, the chain's
//      head weights, the heads (narrow_head's sums, a warp a row), the loss
//      terms (a thread a row), the cotangents to the scratch and the top
//      layer's dpre. ppo_staged_bwd_kernel (layers >= 2) runs dpre_{l-1} =
//      (dpre_l W_l^T) act'(h_{l-1}) down each chain in 3xTF32 wgmma
//      (stage.cuh's bwd_passes): W_l as stored, [in, out], is the K-major B
//      operand over the output units, from big and small TF32 halves, and
//      the rows' dpre the A operand, split in registers; a fresh accumulator
//      every 32 k keeps the tensor core's truncation near f32's rounding;
//      each pass's loads of h_{l-1} are all issued before its stores.
//      This replaces, at the main path, the narrow route's design below,
//      which waited on latency: 32-row blocks, each weight read from L2
//      feeding 32 rows, a forward with one thread a column, and dh products
//      on mma.sync, one instruction an m16n8k8 step (and the earlier wide
//      kernels, whose epilogue read the row scratch one dependent load at a
//      time). Each weight slab a stage holds now feeds 128 rows and costs no
//      thread an instruction. Measured on an NVIDIA H100 80GB HBM3 at
//      700.00 W (PERF.md §6, chip_smoke.py --time-updates; kernel_variants.py
//      for the ablations): the launch at the main path 6.19 ms against 10.24
//      (row pass 4.53 against 6.60: forward kernel 3.20, of which its FMAs
//      ~1.6 against a 1.04 ms bound; dh kernel 1.33), the wide cell's 67.2
//      against 90.1.
//      The narrow route (ppo_rows_kernel) keeps the rest, where the staged
//      route's 128-row blocks leave SMs idle (8,192 rows are 64 blocks for
//      132 SMs) or its 256-column forward passes are mostly padding (64
//      wide: 2.15 ms against 4.12 at 262,144 rows): a block owns kRows = 32
//      rows, two blocks to an SM, the current layer's activations in shared
//      memory, the forward on mlp.cuh's dense_layer, the dh products in
//      tc_dense (3xTF32 mma.sync on a transposed copy of W_l streamed from
//      L2 in 16-row slices through a two-stage cp.async ring); the
//      backward's activation gate reads h_l back from the scratch (this
//      block's own writes).
//   2. The weight products dW = h_in^T dpre and db = sum(dpre) over rows,
//      split over up to 64 groups of rows (wgrad.cuh, shared with
//      rnn_ppo.cu and chains.cu): 3xTF32 wgmma tiles of 128x128 for the
//      layers' products, the first layer's K = d_in and the 2- and 1-wide
//      heads on the CUDA cores. Each group writes its own partial gradient.
//      A chain's heads lie side by side in its cotangent scratch ([mean |
//      pre] for the continuous policy) and each head is its own weight
//      product.
//   3. The partials are summed over groups, and the stats over row blocks,
//      in a fixed order.
// Depth. A model may have any number of layers (rl8_tpu's residency gate
// admits 87 of 256 at the dummy envs' shapes, 1,306 of 64). The kernels
// read each layer's width, slab offset and weight offsets from a table in
// the workspace (PpoLayer, table.cuh), which the launch writes before them:
// no table of fixed size in a kernel's parameters covers every depth. The
// narrow route's shared memory does not grow with depth, so deep models of
// up to 736 wide can take it. The row scratch does grow: it holds every h_l
// and dpre_l of a row, 64 KiB a row at 16 layers of 256 (17.2 GB at
// 262,144 rows, ~93 GB at 87 layers). So the row pass and the weight
// products run over chunks of equal rows, as few as fit kWorkspaceFloats
// (12 GiB) beside the table, the weight copies, the partials and the stats:
// per chunk, the row pass over its rows, then the weight products over them
// into the partials (at most kPartialFloats: fewer groups of rows for a
// larger model), which sum_partials_kernel adds into the gradient, the
// first chunk's written and the others added in chunk order, so that two
// launches stay bit-identical. The main path (2.1 GB of row scratch) and
// the wide cell (8.6 GB) are one chunk. The weight products' jobs, one a
// layer and head of each chain, go to wgrad.cuh's launch_jobs, which
// launches them in lists of kMaxWgJobs.
// The per-row loss terms (policy_row, continuous_row, value_row) are
// ppo_terms.cuh's, shared with rnn_ppo.cu.
// On the narrow route rows past N exist in no buffer: the last row block
// masks them with selects and stores none of them; the staged route's
// slabs hold whole row blocks, and its padding rows carry zero cotangents.
#include <cuda_runtime.h>
#include <math.h>

#include "distmath.cuh"
#include "mlp.cuh"
#include "mma.cuh"
#include "ppo_terms.cuh"
#include "stage.cuh"
#include "table.cuh"
#include "wgrad.cuh"

namespace {

using rl8::dense_layer;
using rl8::Job;
using rl8::kCategorical;
using rl8::kSquashed;
using rl8::kRelu;
using rl8::kTanh;
using rl8::narrow_head;

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows per block of the row pass
// tc_dense: rows of W per shared-memory stage, columns per pass, and a
// staged row (8 floats of padding make the B fragments' loads
// conflict-free).
constexpr int kSlice = 16;
constexpr int kWCols = 256;
constexpr int kWLd = kWCols + 8;
constexpr int kWFloats = 2 * kSlice * kWLd;
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use on an H100
// The workspace's budget (rl8_ppo_workspace): 12 GiB, the table, the
// weight copies, the partials, the stats and the row scratch of one chunk
// of rows together; the wide cell's whole-buffer minibatch (8.6 GB at 1024
// wide x 262,144 rows) stays one chunk. The row scratch grows with depth
// times rows (16 layers of 256 at 262,144 rows would take 17.2 GB, rl8_tpu's
// deepest 256-wide model ~93 GB), so the row pass and the weight products
// run over chunks of whole row blocks that fit the rest of the budget, as
// few as fit and of equal rows (a short last chunk leaves most of the card
// idle in its last wave), and the partials take at most kPartialFloats
// (256 MiB) of it: fewer groups of rows for a larger model.
constexpr long long kWorkspaceFloats = 3LL << 30;
constexpr long long kPartialFloats = 64LL << 20;
// The staged route takes every minibatch of at least kStagedMinRows rows
// whose widest layer has at least kStagedMinWidth units, and whatever the
// narrow route's shared memory does not fit; the narrow route the rest (see
// the file's head).
constexpr long long kStagedMinRows = 16384;
constexpr int kStagedMinWidth = 128;
// The staged kernels' weight slabs by bulk copies (stage.cuh's StRing), not
// every thread's cp.async.
constexpr bool kBulkSlabs = true;

// One layer of a chain, entry c * n_layers + l of the launch's table in
// device memory (table.cuh): its width, the offset of its slabs in the
// chain's row scratch (prefix = sum of the widths below it), its W in
// params, and its copies in the workspace: the narrow route's W^T (l >= 1),
// the staged route's W in stage.cuh's forward layout and (l >= 1) its big and
// small TF32 halves for the backward's dh products.
struct PpoLayer {
  long long woff, wtoff, cf, cb, cbs;
  int hidden, prefix;
};

// The loss's columns and constants (LossDims), and the shapes.
struct Dims : rl8::LossDims {
  long long N;                         // rows of this chunk
  long long NP;                        // rows of each scratch slab: the chunk's, or whole row blocks (staged)
  long long xoff;                      // the staged route's input slab [NP, d_in] in the row scratch
  const PpoLayer* tab;                 // [2][n_layers], in device memory
  int D, obs_col;
  int d_in, n_layers, act, max_hidden;
  long long sum_hidden;
  int ld;                              // row stride of the activation buffers in shared memory
  int ldh, erows, eout, wstaged;       // staged: the top layer's epilogue, erows rows of ldh floats a round, eout
                                       // heads, whose weights are in shared memory where wstaged
  int n_heads[2], head_w[2];           // per chain: its heads (at most two: a mean and a log-std), all head_w wide
  int n_out[2];                        // per chain: n_heads * head_w
  long long hoff[2][2];                // offset of head j of chain c's W in params
  long long region[2];                 // each chain's offset in the row scratch
};

// Where everything lives: the parameter layout, and the workspace (floats):
// [table][W^T copies; wide: the weight copies][row scratch of a chunk: per
// chain h_l..., dpre_l..., dout; wide: the inputs][partials: groups x P]
// [stats: blocks x 4].
struct Layout {
  Dims d;
  std::vector<PpoLayer> tab;
  long long P, tab_floats, wt_floats, row_floats, part_floats, stat_floats;
  long long chunk;  // rows a chunk: whole row blocks, or N
  int max_groups, row_blocks;
  bool staged;  // the staged route (ppo_staged_fwd_kernel, ppo_staged_bwd_kernel: activations and heads in the row scratch)
  size_t smem;  // the row pass's: the W stages, two activation buffers and the inputs, the heads, the row stats (narrow);
                // stage.cuh's stages (both products' rings, and the epilogue's rows) and the row stats (staged)
};

// The policy chain has one head of act_dim * n_cat logits (categorical)
// or two of act_dim (mean, pre-tanh log-std); the value chain one of 1.
// The narrow route where its row pass fits a block's shared memory (which
// does not grow with depth), else the wide one, which keeps nothing of a
// width in shared memory. False where the shapes are out of range, or where
// the weight copies and the partials leave no room in kWorkspaceFloats for
// one row block.
bool make_layout(int N, int d_in, int n_layers, const int* hidden, int kind, int act_dim,
                 int n_cat, Layout* L) {
  if (N <= 0 || d_in <= 0 || n_layers < 1 || act_dim <= 0 ||
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
  L->tab.assign(2 * (size_t)n_layers, PpoLayer{});
  for (int l = 0; l < n_layers; ++l) {
    if (hidden[l] <= 0) return false;
    for (int c = 0; c < 2; ++c) {
      L->tab[c * n_layers + l].hidden = hidden[l];
      L->tab[c * n_layers + l].prefix = (int)d.sum_hidden;
    }
    d.sum_hidden += hidden[l];
    if (hidden[l] > d.max_hidden) d.max_hidden = hidden[l];
  }
  if (d.sum_hidden > (1LL << 30)) return false;
  // A multiple of 32 plus 4: the A fragments' loads hit 32 banks.
  d.ld = (d.max_hidden + 31) / 32 * 32 + 4;
  long long off = 0, wt = 0;
  for (int c = 0; c < 2; ++c) {
    long long in = d_in;
    for (int l = 0; l < n_layers; ++l) {
      PpoLayer& e = L->tab[c * n_layers + l];
      e.woff = off;
      off += in * hidden[l] + hidden[l];
      e.wtoff = wt;
      if (l > 0) wt += (in * hidden[l] + 3) / 4 * 4;  // 16-byte aligned copies
      in = hidden[l];
    }
    d.n_out[c] = d.n_heads[c] * d.head_w[c];
    for (int j = 0; j < d.n_heads[c]; ++j) {
      d.hoff[c][j] = off;
      off += in * d.head_w[c] + d.head_w[c];
    }
  }
  L->P = off;
  L->smem = sizeof(float) * ((size_t)kWFloats + (size_t)kRows * (2 * d.ld + ((d_in + 3) / 4 * 4) + d.n_out[0] + 4));
  L->staged = L->smem > kMaxSmem || (N >= kStagedMinRows && d.max_hidden >= kStagedMinWidth);
  const int rows = L->staged ? rl8::kStRows : kRows;
  L->row_blocks = (int)((N + rows - 1) / rows);
  L->stat_floats = 4LL * L->row_blocks;
  if (L->staged) {
    L->smem = rl8::kStFwdSmem + sizeof(float) * rl8::kStRows * 4;
    // The top layer's epilogue: the head weights, and as many of the block's
    // rows a round as fit the stages beside them and their head outputs.
    // (Heads too wide for their weights to fit beside a row are read from
    // L2 instead.)
    d.ldh = (hidden[n_layers - 1] + 3) / 4 * 4;
    d.eout = d.n_out[0] > d.n_out[1] ? d.n_out[0] : d.n_out[1];
    const long long stage = (long long)(rl8::kStFwdSmem / sizeof(float));
    long long fit = (stage - (long long)(d.ldh + 1) * d.eout) / (d.ldh + d.eout);
    d.wstaged = fit >= 1;
    if (!d.wstaged) fit = stage / (d.ldh + d.eout);
    if (fit < 1) return false;
    d.erows = (int)(fit < rl8::kStRows ? fit : rl8::kStRows);
    wt = 0;
    for (int c = 0; c < 2; ++c) {
      int in = d_in;
      for (int l = 0; l < n_layers; ++l) {
        PpoLayer& e = L->tab[c * n_layers + l];
        e.cf = wt;
        wt += rl8::fwd_copy_floats(in, hidden[l]);
        e.cb = wt;
        if (l > 0) wt += rl8::bwd_copy_floats(hidden[l], in);
        e.cbs = wt;
        if (l > 0) wt += rl8::bwd_copy_floats(hidden[l], in);
        in = hidden[l];
      }
    }
  }
  L->wt_floats = wt;
  L->tab_floats = rl8::table_floats<PpoLayer>((long long)L->tab.size());
  // The partials: up to kMaxGroups groups of rows, within kPartialFloats.
  const long long most = kPartialFloats / L->P;
  L->max_groups = (int)(most < 1 ? 1 : (most > rl8::kMaxGroups ? rl8::kMaxGroups : most));
  L->part_floats = (long long)L->max_groups * L->P;
  // The row scratch of a chunk: per row, each chain's h_l and dpre_l and its
  // heads' cotangents, and (wide) the inputs.
  const long long per_row = 4 * d.sum_hidden + d.n_out[0] + d.n_out[1] + (L->staged ? d_in : 0);
  const long long fixed = L->tab_floats + L->wt_floats + L->part_floats + L->stat_floats;
  if (fixed >= kWorkspaceFloats) return false;
  const long long fit = (kWorkspaceFloats - fixed) / per_row / rows * rows;
  if (fit < rows) return false;
  // Wide: every slab holds whole row blocks (a multiple of 128 rows, so
  // every slab starts 16-byte aligned), which the blocks' padding rows
  // fill. Narrow: N rows where they fit, else chunks of whole blocks.
  const long long all = L->staged ? (long long)L->row_blocks * rows : N;
  const long long chunks = (all + fit - 1) / fit;
  L->chunk = chunks == 1 ? all : ((all + chunks - 1) / chunks + rows - 1) / rows * rows;
  d.NP = L->chunk;
  d.region[0] = 0;
  d.region[1] = d.NP * (2 * d.sum_hidden + d.n_out[0]);
  d.xoff = d.region[1] + d.NP * (2 * d.sum_hidden + d.n_out[1]);
  L->row_floats = d.xoff + (L->staged ? d.NP * d_in : 0);
  return L->smem <= kMaxSmem;
}

// The layer entry of chain c's layer l.
__device__ __forceinline__ PpoLayer layer(const Dims& d, int c, int l) { return d.tab[c * d.n_layers + l]; }

// ---------------------------------------------------------------- row pass

// The head weight of chain c for concatenated output column o and input k,
// and the bias of output o (in_w: the top layer's width).
__device__ __forceinline__ float head_weight(const float* params, const Dims& d, int c, int o, int k) {
  const int w = d.head_w[c];
  return __ldg(params + d.hoff[c][o / w] + (size_t)k * w + o % w);
}
__device__ __forceinline__ float head_bias(const float* params, const Dims& d, int c, int o, int in_w) {
  const int w = d.head_w[c];
  return __ldg(params + d.hoff[c][o / w] + (size_t)in_w * w + o % w);
}

// out[r, n] = sum_k in[r, k] W[k, n] for the block's kRows rows, on the
// tensor cores (mma.cuh's 3xTF32). in [kRows, K] in shared memory, rows
// ld_in apart (a multiple of 32 plus 4); W [K, N] row-major in device
// memory, streamed kSlice rows at a time through the two stages of ws with
// cp.async, the next slice's copies in flight during this one's products;
// out [kRows, N] in shared memory, rows ld_out apart. The 8 warps split the rows 2
// ways (an m16 tile each) and the columns 4 ways (n tiles of 8
// interleaved), over passes of kWCols columns.
__device__ void tc_dense(const float* in, int K, int ld_in, const float* __restrict__ W, int N, float* out,
                         int ld_out, float* ws) {
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
            const float* a = in + (m0 + mt * 16 + g) * ld_in + k;
            fa[mt].set(lo ? a[0] : 0.0f, lo ? a[8 * ld_in] : 0.0f, hi ? a[4] : 0.0f, hi ? a[8 * ld_in + 4] : 0.0f);
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
          for (int mt = 0; mt < MT; ++mt) out[(m0 + mt * 16 + g + (e >= 2 ? 8 : 0)) * ld_out + c] = acc[mt][i][e];
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

// The narrow route's row pass (see the file's head): the activations live
// in shared memory.
template <bool kContinuous>
__global__ void __launch_bounds__(kThreads, 2)
    ppo_rows_kernel(const int* __restrict__ packed, const float* __restrict__ ec,
                    const float* __restrict__ params, const float* __restrict__ wt,
                    float* __restrict__ scratch, float* __restrict__ stat_part, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d.ld;
  const int ld_x = (d.d_in + 3) / 4 * 4;
  float* ws = smem;                                        // tc_dense's W stages
  float* ga = ws + kWFloats;                               // [kRows, ld]: layer outputs, dh
  float* gb = ga + kRows * ld;                             // [kRows, ld]
  float* xs = gb + kRows * ld;                             // [kRows, d_in]
  float* head = xs + kRows * ld_x;                         // [kRows, n_out]: outputs, then cotangents
  float* rowv = head + kRows * d.n_out[0];                 // [kRows, 4]: pol, vf, ent, kl

  const long long r0 = (long long)blockIdx.x * kRows;
  const int nr = (int)min((long long)kRows, d.N - r0);
  const float* packed_f = reinterpret_cast<const float*>(packed);
  // The block's input rows (zeros past N).
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
    int cur_ld = 0;
    for (int l = 0; l < d.n_layers; ++l) {
      const PpoLayer e = layer(d, c, l);
      const int w = e.hidden;
      float* hl = region + d.NP * e.prefix + r0 * w;
      const float* W = params + e.woff;
      float* dst = (l & 1) ? gb : ga;
      dense_layer<kRows>(cur, cur_w, W, W + (size_t)cur_w * w, dst, w, d.act, ld, l == 0 ? 0 : ld);
      __syncthreads();
      store_rows(dst, ld, nr, w, hl);
      cur = dst;
      cur_ld = ld;
      cur_w = w;
    }
    for (int j = 0; j < d.n_heads[c]; ++j) {
      const int w = d.head_w[c];
      const float* Wh = params + d.hoff[c][j];
      narrow_head<kRows>(cur, cur_w, Wh, Wh + (size_t)cur_w * w, w, head, n_out, j * w, cur_ld);
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
    float* dout = region + d.NP * 2 * d.sum_hidden + r0 * n_out;
    for (int i = threadIdx.x; i < nr * n_out; i += blockDim.x) dout[i] = head[i];
    // dh_L = dout @ Wh^T over the chain's heads: they are narrow, so a loop
    // over their outputs.
    const int top = d.n_layers - 1;
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
    for (int l = top; l >= 0; --l) {
      const PpoLayer e = layer(d, c, l);
      const int w = e.hidden;
      // This block's h_l rows, written above and visible after the
      // barriers since; rows past N have no h, and a zero dh.
      const float* h = region + d.NP * e.prefix + r0 * w;
      for (int k = threadIdx.x; k < w; k += blockDim.x) {
#pragma unroll 8
        for (int r = 0; r < kRows; ++r) {
          const float hv = r < nr ? h[(size_t)r * w + k] : 0.0f;
          dh[r * ld + k] *= d.act == kRelu ? (hv > 0.0f ? 1.0f : 0.0f) : 1.0f - hv * hv;
        }
      }
      __syncthreads();
      store_rows(dh, ld, nr, w, region + d.NP * (d.sum_hidden + e.prefix) + r0 * w);
      if (l > 0) {
        const int w_in = layer(d, c, l - 1).hidden;
        float* next = dh == ga ? gb : ga;
        tc_dense(dh, w, ld, wt + e.wtoff, w_in, next, ld, ws);
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


// The activation's derivative at its output h (relu: h > 0, as torch's
// threshold_backward; tanh: 1 - h^2).
__device__ __forceinline__ float act_grad(float h, int act) {
  return act == kRelu ? (h > 0.0f ? 1.0f : 0.0f) : 1.0f - h * h;
}

// The staged route's row pass, first kernel (see the file's head): kStRows
// rows a block, one block an SM; per chain the forward, the heads, the loss
// terms and the top layer's dpre, every activation and cotangent in the row
// scratch.
template <bool kContinuous>
__global__ void __launch_bounds__(rl8::kStThreads, 1)
    ppo_staged_fwd_kernel(const int* __restrict__ packed, const float* __restrict__ ec,
                      const float* __restrict__ params, const float* __restrict__ wt,
                      float* __restrict__ scratch, float* __restrict__ stat_part, Dims d) {
  constexpr int R = rl8::kStRows;
  extern __shared__ __align__(128) float st_smem[];
  float* rowv = st_smem + rl8::kStFwdSmem / sizeof(float);  // [R, 4]: pol, vf, ent, kl
  const long long r0 = (long long)blockIdx.x * R;
  const int nr = (int)min((long long)R, d.N - r0);
  const float* packed_f = reinterpret_cast<const float*>(packed);
  // The block's input rows (zeros past N), in the input slab.
  float* x = scratch + d.xoff + r0 * d.d_in;
  for (int i = threadIdx.x; i < R * d.d_in; i += blockDim.x) {
    const int r = i / d.d_in;
    x[i] = r < nr ? packed_f[(r0 + r) * d.D + d.obs_col + i % d.d_in] : 0.0f;
  }
  const float ec_scale = d.use_entropy ? ec[0] * d.scale : 0.0f;
  __shared__ uint64_t bars[rl8::kStStages];
  rl8::StRing ring = rl8::st_ring_init(bars);  // its barrier also publishes the input rows
  rl8::StRing* const slabs = kBulkSlabs ? &ring : nullptr;

  for (int c = 0; c < 2; ++c) {
    float* region = scratch + d.region[c];
    const int n_out = d.n_out[c];
    // Forward: h_l = act(h_{l-1} W_l + b_l) into the scratch, the layer's
    // input read back from there (the padding rows' too: they are zeros
    // past N, or a layer's output on them).
    const float* cur = x;
    int cur_w = d.d_in;
    for (int l = 0; l < d.n_layers; ++l) {
      const PpoLayer e = layer(d, c, l);
      const int w = e.hidden;
      float* hl = region + d.NP * e.prefix + r0 * w;
      const float* b = params + e.woff + (size_t)cur_w * w;
      const bool vec = rl8::st_vec(hl, w);
      const rl8::FwdSeg seg{{cur, cur_w, cur_w, R, rl8::st_vec(cur, cur_w)}, wt + e.cf};
      rl8::fwd_product(
          &seg, 1, w, st_smem, [](auto& acc, const int(&)[8]) { rl8::tile_zero(acc); },
          [&](auto& acc, int rg, const int(&n)[8]) {
            float bj[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) bj[j] = n[j] < w ? __ldg(b + n[j]) : 0.0f;
#pragma unroll
            for (int i = 0; i < R / 16; ++i) {
              float* row = hl + (size_t)(rg + 16 * i) * w;
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = rl8::activate(acc[i][j] + bj[j], d.act);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (vec) {
                  if (n[4 * h] < w) {
                    *reinterpret_cast<float4*>(row + n[4 * h]) =
                        make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
                  }
                } else {
#pragma unroll
                  for (int j = 4 * h; j < 4 * h + 4; ++j) {
                    if (n[j] < w) row[n[j]] = acc[i][j];
                  }
                }
              }
            }
          },
          slabs);
      cur = hl;
      cur_w = w;
    }
    // The top layer's epilogue, d.erows rows at a time through shared
    // memory (the stages are free between products): the chain's head
    // weights, transposed (wsm [n_out][ldh], bsm [n_out]; from L2 where
    // they do not fit), once; then per
    // round the rows of h_L (hs), the heads into zs (a warp per row, lane l
    // summing k = l, l + 32, ... of up to four outputs at once in order, then
    // an xor butterfly: st_heads' sums, so its bits), the loss terms turning
    // them into their cotangents in place (a thread per row; rows past N get
    // zeros), the cotangents to the chain's slab, and dpre_L = (dout @
    // Wh^T) * act'(h_L) (the heads are narrow: a loop over their outputs).
    const int top = d.n_layers - 1, lane = threadIdx.x % 32;
    float* hs = st_smem;                        // [erows][ldh]
    float* zs = hs + d.erows * d.ldh;           // [erows][n_out]
    float* wsm = zs + d.erows * d.eout;         // [n_out][ldh]
    float* bsm = wsm + d.eout * d.ldh;          // [n_out]
    float* dout = region + d.NP * 2 * d.sum_hidden + r0 * n_out;
    float* dp = region + d.NP * (d.sum_hidden + layer(d, c, top).prefix) + r0 * cur_w;
    if (d.wstaged) {
      for (int i = threadIdx.x; i < n_out * cur_w; i += blockDim.x) {
        const int o = i / cur_w, k = i % cur_w;
        wsm[o * d.ldh + k] = head_weight(params, d, c, o, k);
      }
      for (int o = threadIdx.x; o < n_out; o += blockDim.x) bsm[o] = head_bias(params, d, c, o, cur_w);
    }
    // The rounds, over hw(o, k), head output o's weight of input k, and
    // hb(o), its bias: from shared memory where they fit, else from L2 (a
    // copy of the loop each, so that no product's load sits in a branch).
    const bool vec = rl8::st_vec(cur, cur_w) && d.ldh % 4 == 0;
    auto rounds = [&](auto hw, auto hb) {
      for (int rc = 0; rc < R; rc += d.erows) {
        const int er = min(d.erows, R - rc);
        if (vec) {
          const int q = cur_w / 4;
          for (int i = threadIdx.x; i < er * q; i += blockDim.x) {
            const int r = i / q, k = 4 * (i % q);
            const bool in = rc + r < nr;
            rl8::cp_async16(hs + r * d.ldh + k, in ? cur + (size_t)(rc + r) * cur_w + k : cur, in ? 16 : 0);
          }
        } else {
          for (int i = threadIdx.x; i < er * cur_w; i += blockDim.x) {
            const int r = i / cur_w, k = i % cur_w;
            const bool in = rc + r < nr;
            rl8::cp_async4(hs + r * d.ldh + k, in ? cur + (size_t)(rc + r) * cur_w + k : cur, in ? 4 : 0);
          }
        }
        rl8::cp_async_commit();
        rl8::cp_async_wait<0>();
        __syncthreads();
        for (int r = threadIdx.x / 32; r < er; r += blockDim.x / 32) {
          const float* x = hs + r * d.ldh;
          for (int o0 = 0; o0 < n_out; o0 += 4) {
            float sq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
            for (int k = lane; k < cur_w; k += 32) {
              const float xv = x[k];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                if (o0 + q < n_out) sq[q] = fmaf(xv, hw(o0 + q, k), sq[q]);
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
#pragma unroll
              for (int off = 16; off > 0; off >>= 1) sq[q] += __shfl_xor_sync(0xffffffffu, sq[q], off);
              if (lane == 0 && o0 + q < n_out) zs[r * n_out + o0 + q] = sq[q] + hb(o0 + q);
            }
          }
        }
        __syncthreads();
        if (threadIdx.x < er) {
          const int r = rc + threadIdx.x;
          float* z = zs + threadIdx.x * n_out;
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
        for (int i = threadIdx.x; i < er * n_out; i += blockDim.x) dout[(size_t)rc * n_out + i] = zs[i];
        for (int k = threadIdx.x; k < cur_w; k += blockDim.x) {
          for (int r8 = 0; r8 < er; r8 += 8) {
            float acc[8];
            const float w0 = hw(0, k);
#pragma unroll
            for (int r = 0; r < 8; ++r) acc[r] = r8 + r < er ? zs[(r8 + r) * n_out] * w0 : 0.0f;
            for (int o = 1; o < n_out; ++o) {
              const float w = hw(o, k);
#pragma unroll
              for (int r = 0; r < 8; ++r) acc[r] = fmaf(r8 + r < er ? zs[(r8 + r) * n_out + o] : 0.0f, w, acc[r]);
            }
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              if (r8 + r < er) {
                dp[(size_t)(rc + r8 + r) * cur_w + k] = acc[r] * act_grad(hs[(r8 + r) * d.ldh + k], d.act);
              }
            }
          }
        }
        __syncthreads();  // the next rows (or the next chain) reuse hs and zs
      }
    };
    if (d.wstaged) {
      rounds([&](int o, int k) { return wsm[o * d.ldh + k]; }, [&](int o) { return bsm[o]; });
    } else {
      rounds([&](int o, int k) { return head_weight(params, d, c, o, k); },
             [&](int o) { return head_bias(params, d, c, o, cur_w); });
    }
  }
  if (threadIdx.x < 4) {
    float s = 0.0f;
    for (int r = 0; r < nr; ++r) s += rowv[r * 4 + threadIdx.x];
    stat_part[(size_t)blockIdx.x * 4 + threadIdx.x] = s;
  }
}


// The staged route's row pass, second kernel (layers >= 2; see the file's
// head): down each chain, dpre_{l-1} = (dpre_l W_l^T) * act'(h_{l-1}) on
// the tensor cores (bwd_passes), kStRows rows a block, one block an SM;
// each pass's h_{l-1} loads all issued before its stores.
__global__ void __launch_bounds__(rl8::kStThreads, 1)
    ppo_staged_bwd_kernel(const float* __restrict__ wt, float* __restrict__ scratch, Dims d) {
  constexpr int R = rl8::kStRows;
  extern __shared__ __align__(128) float st_smem[];
  const long long r0 = (long long)blockIdx.x * R;
  const int nr = (int)min((long long)R, d.N - r0);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  __shared__ uint64_t bars[rl8::kStStages];
  rl8::StRing ring = rl8::st_ring_init(bars);
  rl8::StRing* const slabs = kBulkSlabs ? &ring : nullptr;
  for (int c = 0; c < 2; ++c) {
    float* region = scratch + d.region[c];
    for (int l = d.n_layers - 1; l > 0; --l) {
      const PpoLayer e = layer(d, c, l), below = layer(d, c, l - 1);
      const int w = e.hidden, w_in = below.hidden;
      const float* dpl = region + d.NP * (d.sum_hidden + e.prefix) + r0 * w;
      float* next = region + d.NP * (d.sum_hidden + below.prefix) + r0 * w_in;
      const float* h = region + d.NP * below.prefix + r0 * w_in;
      const rl8::StRows a{dpl, w, w, R, rl8::st_vec(dpl, w)};
      rl8::bwd_passes(a, wt + e.cb, wt + e.cbs, w_in, st_smem, [&](const float(&sum)[2][32], int u0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float hv[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            // D [64, 64]: row 16 warp + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2.
            const int r = 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
            const int u = u0 + 64 * hh + 8 * (i >> 2) + 2 * t + (i & 1);
            hv[i] = r < nr && u < w_in ? h[(size_t)r * w_in + u] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
            const int u = u0 + 64 * hh + 8 * (i >> 2) + 2 * t + (i & 1);
            if (u < w_in) next[(size_t)r * w_in + u] = sum[hh][i] * act_grad(hv[i], d.act);
          }
        }
      }, slabs);
    }
  }
}

}  // namespace

// Floats of workspace that rl8_ppo_grads needs for these shapes (at most
// kWorkspaceFloats), or -1 where it takes no launch of them.
extern "C" long long rl8_ppo_workspace(int N, int d_in, int n_layers, const int* hidden, int kind,
                                       int act_dim, int n_cat) {
  Layout L;
  if (!make_layout(N, d_in, n_layers, hidden, kind, act_dim, n_cat, &L)) return -1;
  return L.tab_floats + L.wt_floats + L.row_floats + L.part_floats + L.stat_floats;
}

// Rows of a chunk of the row pass and the weight products (N where the
// whole minibatch fits the budget), or -1.
extern "C" long long rl8_ppo_chunk_rows(int N, int d_in, int n_layers, const int* hidden, int kind, int act_dim,
                                        int n_cat) {
  Layout L;
  if (!make_layout(N, d_in, n_layers, hidden, kind, act_dim, n_cat, &L)) return -1;
  return L.chunk;
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
  float* wt = workspace + L.tab_floats;
  float* rows = wt + L.wt_floats;
  float* partials = rows + L.row_floats;
  float* stat_part = partials + L.part_floats;
  if ((err = rl8::upload_table(L.tab, workspace, s)) != cudaSuccess) return (int)err;
  d.tab = reinterpret_cast<const PpoLayer*>(workspace);

  for (int c = 0; c < 2; ++c) {
    int in = d_in;
    for (int l = 0; l < n_layers; ++l) {
      const PpoLayer& e = L.tab[c * n_layers + l];
      const int J = e.hidden;
      const float* W = params + e.woff;
      if (L.staged) {
        // The staged route's copies: W for the forward, and (l >= 1) its
        // TF32 halves for the backward's dh products.
        rl8::tile_fwd_kernel<<<rl8::grid_for(rl8::fwd_copy_floats(in, J)), kThreads, 0, s>>>(W, J, in, J, 0,
                                                                                           wt + e.cf);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        if (l > 0) {
          rl8::tile_bwd_kernel<<<rl8::grid_for(rl8::bwd_copy_floats(J, in)), kThreads, 0, s>>>(
              W, J, J, in, wt + e.cb, wt + e.cbs);
          if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        }
      } else if (l > 0) {
        rl8::transpose_kernel<<<rl8::grid_for((long long)in * J), kThreads, 0, s>>>(W, wt + e.wtoff, in, J);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      }
      in = J;
    }
  }

  const auto rows_kernel = kind == kCategorical
                               ? (L.staged ? ppo_staged_fwd_kernel<false> : ppo_rows_kernel<false>)
                               : (L.staged ? ppo_staged_fwd_kernel<true> : ppo_rows_kernel<true>);
  err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
  if (err != cudaSuccess) return (int)err;
  if (L.staged && n_layers > 1) {
    err = cudaFuncSetAttribute(ppo_staged_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)rl8::kStBwdSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const int block_rows = L.staged ? rl8::kStRows : kRows;
  std::vector<Job> jobs;
  // The chunks of rows, in order: each chunk's row pass writes its row
  // blocks' stats and its rows' scratch, and its weight products' partials
  // are summed into grads (the first chunk's written, the others added), so
  // the sums come in a fixed order and two launches give the same bits.
  for (long long c0 = 0; c0 < N; c0 += L.chunk) {
    const long long n = N - c0 < L.chunk ? N - c0 : L.chunk;
    const int* pk = packed + c0 * D;
    const int blocks = (int)((n + block_rows - 1) / block_rows);
    d.N = n;
    rows_kernel<<<blocks, L.staged ? rl8::kStThreads : kThreads, L.smem, s>>>(pk, ec, params, wt, rows,
                                                                             stat_part + 4 * (c0 / block_rows), d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (L.staged && n_layers > 1) {
      ppo_staged_bwd_kernel<<<blocks, rl8::kStThreads, rl8::kStBwdSmem, s>>>(wt, rows, d);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    jobs.clear();
    for (int c = 0; c < 2; ++c) {
      const float* region = rows + d.region[c];
      // Jobs l < n_layers are the layers, then one per head.
      for (int l = 0; l < n_layers + d.n_heads[c]; ++l) {
        const bool is_head = l >= n_layers;
        const int in_l = is_head ? n_layers : l;  // the layer whose input this job reads
        const PpoLayer* below = in_l == 0 ? nullptr : &L.tab[c * n_layers + in_l - 1];
        const int K = below == nullptr ? d_in : below->hidden;
        const float* a = below == nullptr ? reinterpret_cast<const float*>(pk) + d.obs_col : region + d.NP * below->prefix;
        const long long a_outer = below == nullptr ? D : below->hidden;
        if (is_head) {
          const int j = l - n_layers;
          jobs.push_back(rl8::make_job(a, a_outer, region + d.NP * 2 * d.sum_hidden + (size_t)j * d.head_w[c],
                                       d.n_out[c], K, d.head_w[c], d.hoff[c][j]));
        } else {
          const PpoLayer& e = L.tab[c * n_layers + l];
          jobs.push_back(rl8::make_job(a, a_outer, region + d.NP * (d.sum_hidden + e.prefix), e.hidden, K,
                                       e.hidden, e.woff));
        }
      }
    }
    int groups = 0;
    long long rows_per_group = 0;
    rl8::split_rows(n, &groups, &rows_per_group);
    if (groups > L.max_groups) {
      groups = L.max_groups;
      rows_per_group = (n + groups - 1) / groups;
    }
    err = rl8::launch_jobs(jobs.data(), (long long)jobs.size(), n, groups, rows_per_group, L.P, partials, s);
    if (err != cudaSuccess) return (int)err;
    rl8::sum_partials_kernel<<<rl8::grid_for(L.P), rl8::kWgThreads, 0, s>>>(partials, groups, L.P, grads, c0 > 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  rl8::sum_stats_kernel<<<1, rl8::kWgThreads, 0, s>>>(stat_part, L.row_blocks, stats);
  return (int)cudaGetLastError();
}

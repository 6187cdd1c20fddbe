// Recurrent PPO update kernel: one packed minibatch of sequences -> the PPO
// losses and the gradient of every LSTM and head parameter, with the
// backward through time derived by hand.
//
// Replaces rl8_tpu/ops/fused_rnn_ppo.py:_kernel (the Pallas TPU kernel). Per
// packed row (a sequence of L steps: obs [L, d_in], the stored initial
// states h, c [K * H], actions [L, A], old logp, advantages and returns [L];
// float columns bitcast) it computes:
//   - the stacked-LSTM forward over the L steps from the stored states
//     (lstm.cuh: z = b + x Wi + h Wh, sigmoid i, f, o, tanh g, c' = f c +
//     i g, h' = o tanh(c'); layer l + 1 reads layer l's h');
//   - per step, the heads on the top layer's h' and the PPO terms of the
//     step's sample (ppo_terms.cuh, shared with ppo.cu: the distribution's
//     log-prob and entropy, the dual-clipped surrogate, the clamped
//     smooth-L1 value loss, the heads' cotangents), every sample weighted
//     1 / (n_rows L accum);
//   - the backward through time, steps and layers in reverse: the head
//     cotangents enter the top layer's h' only; per (step, layer) dh = dh_t
//     + (dh from the heads, or the dx of the layer above), dc = dh o (1 -
//     tanh^2 c') + dc_t, the four gate cotangents dz [4H], dh_t = dz Wh^T
//     (at steps t > 0 only: the stored initial states take no gradient),
//     dc_t = dc f, and dx = dz Wi^T into the layer below;
//   - the weight gradients dWi = sum x^T dz, dWh = sum h^T dz, db = sum dz
//     and the heads' dW, db over every (sequence, step), and the loss and
//     KL sums.
// One body holds both distribution families; the row pass's branch is a
// template argument.
//
// Bound on an H100 SXM at the main path (N = 65,536 sequences, L = 4, d_in
// = 1, K = 1, H = 256, A = 1, n = 2): per sample 2 (d_in + H) 4H FLOP of
// forward and 2 (d_in + H + 1) 4H of weight products, per sequence (L - 1)
// 2 4H H of dh_t, ~1.45 MFLOP per sample, 3.8e11 FLOP per launch, against
// ~140 MB of inputs and outputs, so the products bound it: ~5.7 ms at the
// CUDA cores' 67 TFLOP/s, ~2.3 ms at three TF32 products per f32 product
// at the tensor cores' 495 TFLOP/s. Of that the row pass's share: the
// forward's 1.38e11 FLOP, 2.06 ms in f32, and the dh products' 1.03e11,
// 0.62 ms at 3xTF32; its scratches move ~4.4 GB (~1.3 ms at 3.35 TB/s).
//
// Design. On the TPU the grid runs in order and every grid step adds its
// tile's gradients into VMEM; CUDA blocks run in parallel, so, as in
// ppo.cu, the work is split in passes with no float atomics (the result is
// bit-identical from launch to launch):
//   1. The row pass, on one of two routes that the shapes fix at launch
//      (make_layout): the stacked-LSTM forward per step, the heads, the loss
//      terms and the heads' cotangents, then the backward through time,
//      writing per (sequence, step, layer) h' and c' (slot t + 1 of an [L +
//      1] state scratch whose slot 0 holds the stored states) and the four
//      gate activations, which the backward overwrites with the gate
//      cotangents dz (26.7 KB per sequence at the main path, 1.75 GB at N =
//      65,536), for the weight products. The forward stays in f32 on the
//      CUDA cores (lstm.cuh's sums, each gate in order of k): the tensor
//      cores round toward zero (mma.cuh), and the forward's values feed the
//      loss, whose cotangents sum any bias over every sample (with the
//      forward's gates on 3xTF32 wgmma, an ablation since removed, the
//      forward kernel was 1.4 ms faster at the main path but its gradients
//      sat 1.1e-5 off float64 against the f32 version's 1.4e-6, past a
//      tenth of the checks' limit). The dh products run on the tensor
//      cores in 3xTF32.
//      The staged route (every minibatch of at least kStagedMinRows
//      sequences whose LSTM is kStagedMinWidth wide or more, the main path
//      among them, and every shape whose narrow row pass does not fit a
//      block's shared memory: H past ~720 at the dummy envs' heads) runs two
//      kernels over blocks of 128 sequences (stage.cuh's kStRows), one block
//      an SM, every operand in the scratches, each product streamed through
//      a 3-stage ring in shared memory, 32 deep in k: the block's rows by
//      cp.async, each weight slab by one bulk copy (the TMA unit) counted by
//      the stage's mbarrier (stage.cuh's StRing), from copies of the
//      weights in the stages' layout that the launch makes once.
//      rnn_staged_fwd_kernel runs, per step and layer, z = b + x Wi + h Wh
//      as one product over the block's rows (stage.cuh's fwd_product,
//      register-tiled, 8 rows x 16 columns a thread in 256-column passes;
//      the layer's input, the packed obs columns or layer l - 1's h' in
//      slot t + 1, then the previous state in slot t, against Wi and Wh
//      whose gate columns the copy interleaves so that a thread's four
//      adjacent columns are one unit's gates; each gate summed in order of k
//      from its bias), the cell update on the sums in registers (a pass's
//      previous cell states loaded before its stores), then the step's
//      epilogue through shared memory, as many rows a round as fit (all
//      128 at H 256): the rows of the top layer's h', the heads
//      (narrow_head's sums, a warp a row, weights in shared memory), the
//      loss terms (a thread a row) and the cotangents
//      to the head-cotangent scratch. rnn_staged_bwd_kernel runs the
//      backward through time, steps and layers in reverse: the cell
//      backward elementwise, four adjacent units a thread by 16-byte loads
//      (the top layer's dh plus the heads' cotangent dout W_heads^T from
//      the head weights and the step's cotangents in shared memory), dz
//      into the gate scratch; then dh_t = dz Wh^T into the layer's dh_t
//      scratch and dx = dz Wi^T added into the dh_t of the layer below
//      (bwd_passes: Wh and Wi as stored, [H, 4H], are the K-major B operand
//      from big and small TF32 halves, no transposed copy; dz the A operand,
//      split in registers; a fresh accumulator every 32 k). Offsets are
//      64-bit. This replaces, at the main path, the narrow design below,
//      which waited on latency (each weight read from L2 as scalar fragments
//      feeding 16 sequences), and the earlier wide kernels (a cp.async ring, the
//      epilogue and heads read from L2 one dependent load at a time, a dx
//      scratch). Measured on an NVIDIA H100 80GB HBM3 at 700.00 W
//      (kernel_variants.py, PERF.md §6): at the main path the row pass 8.9
//      ms against the narrow route's 12.0 (the earlier wide kernels at 256:
//      10.3), its forward kernel ~6 (its FMAs ~3.5 of that against their
//      2.06 ms bound), its backward kernel ~2.8 (the cell backward ~1.0,
//      at the rate of its ~3.2 GB; the dh products 0.6).
//      The narrow route (rnn_rows_kernel) keeps the rest, where 128-sequence
//      blocks leave SMs idle or narrow gates waste the passes: a block of 256
//      threads owns kRows = 16 sequences, two blocks to an SM (32 sequences a
//      block, one to an SM, made the launch 22.55 ms against 19.1,
//      kernel_variants.py's rnn_rows32: the pass waits on latency). Thread j
//      owns hidden unit j in the forward (lstm.cuh). The backward's gate
//      cotangents go to shared memory, the A operand of dh_t = dz Wh^T and
//      dx = dz Wi^T on the tensor cores (mma.cuh's 3xTF32) with the
//      transposed weights read from L2 as B fragments in place, two k steps
//      ahead. Warp w owns hidden-unit tiles w, w + 8, ... (8 units each), so
//      lane (g, tq) holds the same (sequence, unit) pairs in the cell
//      backward and in the products' outputs: a unit's dh_t, dc_t and gates
//      pass through no barrier.
//   2. wgrad.cuh's split-K weight products over the N L (sequence, step)
//      rows, read in place from the scratch with an outer (sequence) and an
//      inner (step) stride: dWh (H by 4H, db as its bias row) and dWi past
//      the first layer on 3xTF32 wgmma tiles, the first layer's dWi (K =
//      d_in) and the heads on the CUDA cores.
//   3. The fixed-order sums of the partials and of the blocks' stats.
// Sequences past N are zeros in the last block: their states, inputs and
// cotangents are 0, and the weight products read rows below N only.
// Workspace at the main path: 1.953 GB on the staged route (states 2 x 336
// MB, gates 1.07 GB, head cotangents 3.1 MB, dh_t and dc_t 67 MB each,
// weight copies 3.3 MB, partials 68 MB, stats), 2.2 MB past the narrow
// route's 1.951 GB (whose transposed copy is 1 MB); the earlier wide
// kernels' 67 MB dx scratch is gone (dx adds into the dh_t scratch).
#include <cuda_runtime.h>
#include <math.h>

#include <vector>

#include "distmath.cuh"
#include "lstm.cuh"
#include "mlp.cuh"
#include "mma.cuh"
#include "ppo_terms.cuh"
#include "stage.cuh"
#include "wgrad.cuh"

namespace {

using rl8::FragA;
using rl8::FragB;
using rl8::Job;
using rl8::kCategorical;
using rl8::kSquashed;
using rl8::narrow_head;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // sequences per block of the row pass
constexpr int kMaxLayers = 8;
constexpr int kMaxHeads = 3;  // policy heads and the value head
// A block's shared memory on an H100 (227 KB). make_layout takes the staged
// route where the narrow row pass's buffers pass it, and refuses a shape
// whose staged route passes it too; rl8_rnn_ppo_workspace then returns -1
// (which ops/fused_rnn_ppo.py:card_takes_rnn_update asks).
constexpr size_t kMaxSmem = 232448;
// The staged route takes every minibatch of at least kStagedMinRows
// sequences whose LSTM is at least kStagedMinWidth wide, and whatever the
// narrow row pass's shared memory does not fit; the narrow route the rest
// (see the file's head).
constexpr long long kStagedMinRows = 16384;
constexpr int kStagedMinWidth = 64;
// The staged kernels' weight slabs by bulk copies (stage.cuh's StRing), not
// every thread's cp.async.
constexpr bool kBulkSlabs = true;

// The loss's columns (of step 0) and constants (LossDims), and the shapes.
struct Dims : rl8::LossDims {
  long long N, Npad;  // sequences, and rounded up to whole blocks
  int D, obs_col, h_col, c_col;
  int d_in, H, L, K;
  int n_heads, head_w;  // policy heads and each one's width
  int n_out;            // n_heads * head_w + 1: a step's head row, the value last
  int ldx, ldh, ldz;    // row strides in shared memory of a layer input, an [H] row and a [4H] row
  int u_floats;         // per sequence: the forward's or the backward's shared buffers
  long long hs;         // floats per sequence of the h (and c) scratch: (L + 1) K H
  long long gs;         // floats per sequence of the gate (then dz) scratch: L K 4H
  long long ds;         // floats per sequence of the head cotangents: L n_out
  long long wi_off[kMaxLayers], wh_off[kMaxLayers];  // in params; each layer's b follows its Wh
  long long head_off[kMaxHeads];
  long long whT_off[kMaxLayers], wiT_off[kMaxLayers];  // in the transposed copies (Wi^T: layers >= 1)
  // The staged route's weight copies (stage.cuh's layouts): Wi and Wh for
  // the forward, their gate columns interleaved; Wh's and (layers >= 1)
  // Wi's big and small TF32 halves for the backward's products.
  long long cfi[kMaxLayers], cfh[kMaxLayers], cbh[kMaxLayers], cbhs[kMaxLayers], cbi[kMaxLayers], cbis[kMaxLayers];
  // The staged forward's epilogue: a staged top-layer row's stride, rows a
  // round, the head outputs in shared memory (else in the head-cotangent
  // scratch) and the head weights in shared memory (else read from L2).
  int eld, erows, zsm, wstaged;
  // The staged backward: the heads' cotangent summed in the top layer's
  // cell backward from shared memory (else a pass through its dh_t).
  int hfuse;
};

// The parameter layout and the workspace (floats): [Wh^T, Wi^T copies;
// staged: the weight copies][h scratch][c scratch][gates, then dz][head
// cotangents][dh_t][dc_t][partials: groups x P][stats: blocks x 4].
struct Layout {
  Dims d;
  long long P, wt_floats, state_floats, gz_floats, dout_floats, time_floats, part_floats, stat_floats;
  long long rows_per_group;
  int groups, row_blocks;
  size_t smem;   // the row pass's (staged: its first kernel's)
  size_t bsmem;  // the staged route's second kernel's
  bool staged;  // the staged route (rnn_staged_fwd_kernel, rnn_staged_bwd_kernel: every operand in the scratches)
};

// The row strides (padded to a multiple of 32 plus 4, which makes the
// tensor cores' A fragment loads conflict-free, or unpadded) and the row
// pass's shared memory at those strides.
size_t set_strides(Dims& d, bool pad) {
  auto ld = [pad](int w) { return pad ? (w + 31) / 32 * 32 + 4 : w; };
  d.ldx = ld(d.d_in > d.H ? d.d_in : d.H);
  d.ldh = ld(d.H);
  d.ldz = ld(4 * d.H);
  const int fwd = 2 * d.ldx + d.ldh, bwd = d.ldz + d.ldh + d.n_out;
  d.u_floats = fwd > bwd ? fwd : bwd;
  return sizeof(float) * (size_t)kRows * (d.u_floats + d.n_out + 4);
}

// The narrow row pass's strides are padded where that fits shared memory,
// else unpadded (as wide as the kernel took before the padding). The staged
// route, which keeps nothing of a width in shared memory, takes the shapes
// where neither fits and the minibatches of the rule above.
bool make_layout(int N, int d_in, int H, int L, int K, int kind, int act_dim, int n_cat, Layout* Lo) {
  // The weight products divide a row index by L in 32 bits; a block's
  // offsets within a sequence's rows of the scratches are 32-bit.
  if (N <= 0 || d_in <= 0 || H <= 0 || L <= 0 || K < 1 || K > kMaxLayers || act_dim <= 0 ||
      kind < kCategorical || kind > kSquashed || (kind == kCategorical && n_cat < 2) ||
      (long long)N * L >= (1LL << 31) || (long long)kRows * (L + 1) * K * 4 * H >= (1LL << 31)) {
    return false;
  }
  Dims& d = Lo->d;
  d.N = N;
  d.d_in = d_in;
  d.H = H;
  d.L = L;
  d.K = K;
  d.kind = kind;
  d.act_dim = act_dim;
  d.n_cat = n_cat;
  d.n_heads = kind == kCategorical ? 1 : 2;
  d.head_w = kind == kCategorical ? act_dim * n_cat : act_dim;
  d.n_out = d.n_heads * d.head_w + 1;
  if ((long long)kRows * L * d.n_out >= (1LL << 31)) return false;
  const long long H4 = 4LL * H;
  long long off = 0, wt = 0;
  for (int l = 0; l < K; ++l) {
    const long long in = l == 0 ? d_in : H;
    d.wi_off[l] = off;
    off += in * H4;
    d.wh_off[l] = off;
    off += H * H4 + H4;
    d.whT_off[l] = wt;
    wt += H4 * H;
    d.wiT_off[l] = wt;
    if (l > 0) wt += H4 * H;
  }
  for (int q = 0; q <= d.n_heads; ++q) {
    const int w = q < d.n_heads ? d.head_w : 1;
    d.head_off[q] = off;
    off += (long long)H * w + w;
  }
  Lo->P = off;
  Lo->smem = set_strides(d, true);
  if (Lo->smem > kMaxSmem) Lo->smem = set_strides(d, false);
  Lo->staged = Lo->smem > kMaxSmem || ((long long)N >= kStagedMinRows && H >= kStagedMinWidth);
  if (Lo->staged) {
    // The forward's epilogue: as many of the block's top-layer rows a round
    // as fit the stages beside their head outputs (the outputs in the
    // head-cotangent scratch where not one row's fit beside its inputs);
    // the head weights, transposed, in shared memory past the stages and the
    // row stats where they fit, else read from L2.
    const long long stage = (long long)(rl8::kStFwdSmem / sizeof(float));
    d.eld = (H + 3) / 4 * 4;
    d.zsm = stage >= d.eld + d.n_out;
    const long long fit = stage / (d.eld + (d.zsm ? d.n_out : 0));
    if (fit < 1) return false;
    d.erows = (int)(fit < rl8::kStRows ? fit : rl8::kStRows);
    const size_t base = rl8::kStFwdSmem + sizeof(float) * rl8::kStRows * 4;
    const size_t heads = sizeof(float) * (size_t)d.n_out * (d.eld + 1);
    d.wstaged = base + heads <= kMaxSmem;
    Lo->smem = base + (d.wstaged ? heads : 0);
    const size_t hsmem = sizeof(float) * (size_t)d.n_out * (H + rl8::kStRows);
    d.hfuse = H % 4 == 0 && rl8::kStBwdSmem + hsmem <= kMaxSmem;
    Lo->bsmem = rl8::kStBwdSmem + (d.hfuse ? hsmem : 0);
    wt = 0;
    for (int l = 0; l < K; ++l) {
      d.cfi[l] = wt;
      wt += rl8::fwd_copy_floats(l == 0 ? d_in : H, 4 * H);
      d.cfh[l] = wt;
      wt += rl8::fwd_copy_floats(H, 4 * H);
      d.cbh[l] = wt;
      wt += rl8::bwd_copy_floats(4 * H, H);
      d.cbhs[l] = wt;
      wt += rl8::bwd_copy_floats(4 * H, H);
      d.cbi[l] = wt;
      if (l > 0) wt += rl8::bwd_copy_floats(4 * H, H);
      d.cbis[l] = wt;
      if (l > 0) wt += rl8::bwd_copy_floats(4 * H, H);
    }
  }
  Lo->wt_floats = wt;
  const int rows = Lo->staged ? rl8::kStRows : kRows;
  Lo->row_blocks = (N + rows - 1) / rows;
  d.Npad = (long long)Lo->row_blocks * rows;
  d.hs = (long long)(L + 1) * K * H;
  d.gs = (long long)L * K * H4;
  d.ds = (long long)L * d.n_out;
  Lo->state_floats = d.Npad * d.hs;
  Lo->gz_floats = d.Npad * d.gs;
  Lo->dout_floats = d.Npad * d.ds;
  Lo->time_floats = (long long)K * d.Npad * H;
  rl8::split_rows((long long)N * L, &Lo->groups, &Lo->rows_per_group);
  Lo->part_floats = (long long)Lo->groups * Lo->P;
  Lo->stat_floats = 4LL * Lo->row_blocks;
  return Lo->smem <= kMaxSmem;
}

// ---------------------------------------------------------------- row pass

// The weight of head output column o (the policy heads side by side, then
// the value) for hidden unit k.
__device__ __forceinline__ float head_weight(const float* params, const Dims& d, int o, int k) {
  const int q = o < d.n_heads * d.head_w ? o / d.head_w : d.n_heads;
  const int w = q < d.n_heads ? d.head_w : 1;
  return __ldg(params + d.head_off[q] + (size_t)k * w + (o - q * d.head_w));
}

// The backward's products on the tensor cores. Warp w owns hidden-unit tiles
// w, w + 8, w + 16, ... of 8 units each (of ceil(H / 8)), for all the block's
// rows, and takes them KUT at a time; lane (g, tq) of a warp holds, for each
// of its m16 tiles mt and unit tiles, the rows mt 16 + g (+ 8) and the units
// 2 tq (+ 1) of the tile (mma.cuh's C layout). The cell backward uses the
// same map, so a unit's dh_t, dc_t and gates stay with one lane and need no
// barrier.


// acc[mt][i] += A[kRows, K] W[K, units of tile i] over k < K: A in shared
// memory with rows lda apart; W [K, H] row-major in device memory (L2),
// read as B fragments in place, two k steps ahead of the products.
template <int MT, int KUT>
__device__ __forceinline__ void unit_products(float (&acc)[MT][KUT][4], const float* A, int lda, int K,
                                              const float* __restrict__ W, int H, const int (&u0)[KUT]) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  auto fetch = [&](int kb, float (&bn)[KUT][2]) {
    const int k = kb + tq;
#pragma unroll
    for (int i = 0; i < KUT; ++i) {
      const int u = u0[i] + g;
      const float* w = W + (size_t)k * H + u;
      bn[i][0] = u < H && k < K ? __ldg(w) : 0.0f;
      bn[i][1] = u < H && k + 4 < K ? __ldg(w + 4 * (size_t)H) : 0.0f;
    }
  };
  // The k step at kb from the B values in bn, which then take kb + 16's.
  auto step = [&](int kb, float (&bn)[KUT][2]) {
    FragB fb[KUT];
#pragma unroll
    for (int i = 0; i < KUT; ++i) fb[i].set(bn[i][0], bn[i][1]);
    if (kb + 16 < K) fetch(kb + 16, bn);
    const int k = kb + tq;
    const bool lo = k < K, hi = k + 4 < K;
    FragA fa[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* a = A + (mt * 16 + g) * lda + k;
      fa[mt].set(lo ? a[0] : 0.0f, lo ? a[8 * lda] : 0.0f, hi ? a[4] : 0.0f, hi ? a[8 * lda + 4] : 0.0f);
    }
#pragma unroll
    for (int i = 0; i < KUT; ++i) {
      if (u0[i] < H) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) rl8::mma_3xtf32(acc[mt][i], fa[mt], fb[i]);
      }
    }
  };
  float b0[KUT][2], b1[KUT][2];
  fetch(0, b0);
  fetch(8, b1);
  for (int kb = 0; kb < K; kb += 16) {
    step(kb, b0);
    if (kb + 8 < K) step(kb + 8, b1);
  }
}

// The narrow route's row pass (see the file's head).
template <bool kContinuous>
__global__ void __launch_bounds__(kThreads, 2)
    rnn_rows_kernel(const int* __restrict__ packed, const float* __restrict__ ec,
                    const float* __restrict__ params, const float* __restrict__ wt, float* __restrict__ hseq,
                    float* __restrict__ cseq, float* __restrict__ gz, float* __restrict__ dout,
                    float* __restrict__ dht, float* __restrict__ dct, float* __restrict__ stat_part, Dims d) {
  constexpr int MT = kRows / 16;  // m16 tiles: every warp covers all the rows
  constexpr int KUT = 4;          // unit tiles per pass of the backward's products
  extern __shared__ __align__(16) float smem[];
  const int H = d.H, K = d.K, L = d.L, H4 = 4 * H, KH = K * H;
  const int ldx = d.ldx, ldh = d.ldh, ldz = d.ldz;
  const int n_tiles = (H + 7) / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  // The forward's view of the union: two layer inputs and the previous
  // hidden state.
  float* xa = smem;            // [kRows, ldx]
  float* xb = xa + kRows * ldx;    // [kRows, ldx]
  float* hp = xb + kRows * ldx;    // [kRows, ldh]
  // The backward's: the gate cotangents, the cotangent into the current
  // layer's output, and the step's head cotangents.
  float* dzs = smem;                      // [kRows, ldz]
  float* dx = dzs + kRows * ldz;          // [kRows, ldh]
  float* dos = dx + kRows * ldh;          // [kRows, n_out]
  float* head = smem + kRows * d.u_floats;    // [kRows, n_out]: outputs, then cotangents
  float* rowv = head + kRows * d.n_out;   // [kRows, 4]: pol, vf, ent, kl over the steps

  const long long r0 = (long long)blockIdx.x * kRows;
  const int nr = (int)min((long long)kRows, d.N - r0);
  const float* packed_f = reinterpret_cast<const float*>(packed);
  const float ec_scale = d.use_entropy ? ec[0] * d.scale : 0.0f;

  // Slot 0 of the state scratch: the stored initial states.
  for (int i = threadIdx.x; i < kRows * KH; i += blockDim.x) {
    const int r = i / KH;
    const size_t row = (size_t)(r0 + r);
    const bool in = r < nr;
    hseq[row * d.hs + i % KH] = in ? packed_f[row * d.D + d.h_col + i % KH] : 0.0f;
    cseq[row * d.hs + i % KH] = in ? packed_f[row * d.D + d.c_col + i % KH] : 0.0f;
  }
  for (int i = threadIdx.x; i < kRows * 4; i += blockDim.x) rowv[i] = 0.0f;

  // ---------------- forward: the LSTM, the heads and the loss terms per step
  for (int t = 0; t < L; ++t) {
    float* cur = xa;
    float* nxt = xb;
    int in_w = d.d_in;
    for (int i = threadIdx.x; i < kRows * in_w; i += blockDim.x) {
      const int r = i / in_w;
      cur[r * ldx + i % in_w] = r < nr ? packed_f[(size_t)(r0 + r) * d.D + d.obs_col + t * in_w + i % in_w] : 0.0f;
    }
    for (int l = 0; l < K; ++l) {
      __syncthreads();  // the state scratch's slot t, and the buffers, are ready
      for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
        hp[(i / H) * ldh + i % H] = hseq[(size_t)(r0 + i / H) * d.hs + ((size_t)t * K + l) * H + i % H];
      }
      __syncthreads();
      const float* wi = params + d.wi_off[l];
      const float* wh = params + d.wh_off[l];
      const float* b = wh + (size_t)H * H4;
      for (int j = threadIdx.x; j < H; j += blockDim.x) {
        float z[4][kRows];
        rl8::lstm_preact<kRows>(cur, in_w, hp, wi, wh, b, H, j, z, ldx, ldh);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const size_t row = (size_t)(r0 + r);
          rl8::gate_activations(z[0][r], z[1][r], z[2][r], z[3][r]);
          float* gp = gz + row * d.gs + ((size_t)t * K + l) * H4 + j;
          gp[0] = z[0][r];
          gp[H] = z[1][r];
          gp[2 * H] = z[2][r];
          gp[3 * H] = z[3][r];
          const float c_prev = cseq[row * d.hs + ((size_t)t * K + l) * H + j];
          const float c = z[1][r] * c_prev + z[0][r] * z[2][r];
          const float h = z[3][r] * tanhf(c);
          cseq[row * d.hs + ((size_t)(t + 1) * K + l) * H + j] = c;
          hseq[row * d.hs + ((size_t)(t + 1) * K + l) * H + j] = h;
          nxt[r * ldx + j] = h;
        }
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      in_w = H;
    }
    // The heads on the top layer's h' (cur).
    for (int q = 0; q <= d.n_heads; ++q) {
      const int w = q < d.n_heads ? d.head_w : 1;
      const float* Wq = params + d.head_off[q];
      narrow_head<kRows>(cur, H, Wq, Wq + (size_t)H * w, w, head, d.n_out, q < d.n_heads ? q * w : d.n_out - 1, ldx);
    }
    __syncthreads();
    // The step's loss terms and head cotangents, a thread per sequence;
    // sequences past N get zeros.
    if (threadIdx.x < kRows) {
      const int r = threadIdx.x;
      float* z = head + r * d.n_out;
      if (r < nr) {
        rl8::LossDims s = d;
        s.act_col += t * d.act_dim;
        s.logp_col += t;
        s.adv_col += t;
        s.ret_col += t;
        const int* row = packed + (size_t)(r0 + r) * d.D;
        float v[4];
        if constexpr (kContinuous) {
          rl8::continuous_row(row, z, v, s, ec_scale);
        } else {
          rl8::policy_row(row, z, v, s, ec_scale);
        }
        rl8::value_row(row, z + d.n_out - 1, v, s);
#pragma unroll
        for (int i = 0; i < 4; ++i) rowv[r * 4 + i] += v[i];
      } else {
        for (int o = 0; o < d.n_out; ++o) z[o] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * d.n_out; i += blockDim.x) {
      dout[(size_t)(r0 + i / d.n_out) * d.ds + t * d.n_out + i % d.n_out] = head[i];
    }
  }

  // ---------------- backward through time
  for (int t = L - 1; t >= 0; --t) {
    __syncthreads();  // the head cotangents are stored, and the union is free
    for (int i = threadIdx.x; i < kRows * d.n_out; i += blockDim.x) {
      dos[i] = dout[(size_t)(r0 + i / d.n_out) * d.ds + t * d.n_out + i % d.n_out];
    }
    __syncthreads();
    // The heads' cotangent into the top layer's h': dx = dout W_heads^T (the
    // heads are narrow, so a loop over their outputs).
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      for (int o = 0; o < d.n_out; ++o) {
        const float w = head_weight(params, d, o, j);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(dos[r * d.n_out + o], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) dx[r * ldh + j] = acc[r];
    }
    __syncthreads();
    for (int l = K - 1; l >= 0; --l) {
      // The cell backward of the lane's (row, unit) pairs: dx, dh_t, dc_t
      // and the unit's gates are this lane's own.
      const bool last = t == L - 1;
      for (int p = warp; p < n_tiles; p += kWarps) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int u = 8 * p + 2 * tq + (e & 1);
            const int r = mt * 16 + g + (e >= 2 ? 8 : 0);
            if (u < H) {
              const size_t row = (size_t)(r0 + r);
              const size_t ut = ((size_t)l * d.Npad + row) * H + u;
              const float dh = (last ? 0.0f : dht[ut]) + dx[r * ldh + u];
              float* gp = gz + row * d.gs + ((size_t)t * K + l) * H4 + u;
              const float gi = gp[0], gf = gp[H], gg = gp[2 * H], go = gp[3 * H];
              const float c_prev = cseq[row * d.hs + ((size_t)t * K + l) * H + u];
              const float tc = tanhf(cseq[row * d.hs + ((size_t)(t + 1) * K + l) * H + u]);
              const float dc = dh * go * (1.0f - tc * tc) + (last ? 0.0f : dct[ut]);
              const float di = dc * gg * gi * (1.0f - gi);
              const float df = dc * c_prev * gf * (1.0f - gf);
              const float dg = dc * gi * (1.0f - gg * gg);
              const float dout_o = dh * tc * go * (1.0f - go);
              gp[0] = di;
              gp[H] = df;
              gp[2 * H] = dg;
              gp[3 * H] = dout_o;
              float* dzr = dzs + r * ldz + u;
              dzr[0] = di;
              dzr[H] = df;
              dzr[2 * H] = dg;
              dzr[3 * H] = dout_o;
              dct[ut] = dc * gf;
            }
          }
        }
      }
      __syncthreads();
      // dh_t = dz Wh^T for the previous step (none before step 0: the
      // stored initial states take no gradient); dx = dz Wi^T into the
      // layer below. Both on the tensor cores, into the lanes that own the
      // units.
      if (t > 0 || l > 0) {
        for (int p0 = warp; p0 < n_tiles; p0 += kWarps * KUT) {
          int u0[KUT];
          float ah[MT][KUT][4], ax[MT][KUT][4];
#pragma unroll
          for (int i = 0; i < KUT; ++i) {
            u0[i] = (p0 + kWarps * i < n_tiles) ? 8 * (p0 + kWarps * i) : H;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) ah[mt][i][e] = ax[mt][i][e] = 0.0f;
          }
          if (t > 0) unit_products<MT, KUT>(ah, dzs, ldz, H4, wt + d.whT_off[l], H, u0);
          if (l > 0) unit_products<MT, KUT>(ax, dzs, ldz, H4, wt + d.wiT_off[l], H, u0);
#pragma unroll
          for (int i = 0; i < KUT; ++i) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int u = u0[i] + 2 * tq + (e & 1);
                const int r = mt * 16 + g + (e >= 2 ? 8 : 0);
                if (u < H) {
                  if (t > 0) dht[((size_t)l * d.Npad + r0 + r) * H + u] = ah[mt][i][e];
                  if (l > 0) dx[r * ldh + u] = ax[mt][i][e];
                }
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x < 4) {
    float s = 0.0f;
    for (int r = 0; r < nr; ++r) s += rowv[r * 4 + threadIdx.x];
    stat_part[(size_t)blockIdx.x * 4 + threadIdx.x] = s;
  }
}

// The cell backward of one (sequence, unit) pair from its dh (the time
// cotangent plus the cotangent from above), its dc_t (0 past the last step),
// its four gates and its cell states: the gate cotangents dz (i, f, g, o),
// and dc_t for the step before.
__device__ __forceinline__ void cell_backward(float dh, float dcn, float gi, float gf, float gg, float go,
                                              float c_prev, float c, float (&dz)[4], float& dc_prev) {
  const float tc = tanhf(c);
  const float dc = dh * go * (1.0f - tc * tc) + dcn;
  dz[0] = dc * gg * gi * (1.0f - gi);
  dz[1] = dc * c_prev * gf * (1.0f - gf);
  dz[2] = dc * gi * (1.0f - gg * gg);
  dz[3] = dh * tc * go * (1.0f - go);
  dc_prev = dc * gf;
}

// The staged route's row pass (see the file's head), first kernel: the
// forward over the steps, the heads and the loss terms, kStRows sequences
// a block, one block an SM; the gates, states and head rows go to the
// scratches. Offsets are 64-bit throughout.
template <bool kContinuous>
__global__ void __launch_bounds__(rl8::kStThreads, 1)
    rnn_staged_fwd_kernel(const int* __restrict__ packed, const float* __restrict__ ec,
                          const float* __restrict__ params, const float* __restrict__ wt, float* __restrict__ hseq,
                          float* __restrict__ cseq, float* __restrict__ gz, float* __restrict__ dout,
                          float* __restrict__ stat_part, Dims d) {
  constexpr int R = rl8::kStRows;
  extern __shared__ __align__(128) float st_smem[];
  float* rowv = st_smem + rl8::kStFwdSmem / sizeof(float);  // [R, 4]: pol, vf, ent, kl over the steps
  float* wsm = rowv + R * 4;                                  // [n_out][eld]: the head weights, where wstaged
  float* bsm = wsm + (long long)d.n_out * d.eld;              // [n_out]: their biases
  const int H = d.H, K = d.K, L = d.L, n_out = d.n_out, lane = threadIdx.x % 32;
  const long long H4 = 4LL * H, KH = (long long)K * H;
  const long long r0 = (long long)blockIdx.x * R;
  const int nr = (int)min((long long)R, d.N - r0);
  const float* packed_f = reinterpret_cast<const float*>(packed);
  const float ec_scale = d.use_entropy ? ec[0] * d.scale : 0.0f;
  // The block's rows of the scratches: its first sequence.
  float* hseq_b = hseq + r0 * d.hs;
  float* cseq_b = cseq + r0 * d.hs;
  float* gz_b = gz + r0 * d.gs;
  float* dout_b = dout + r0 * d.ds;

  // Slot 0 of the state scratch: the stored initial states.
  for (long long i = threadIdx.x; i < R * KH; i += blockDim.x) {
    const long long r = i / KH, k = i % KH;
    const bool in = r < nr;
    hseq_b[r * d.hs + k] = in ? packed_f[(r0 + r) * d.D + d.h_col + k] : 0.0f;
    cseq_b[r * d.hs + k] = in ? packed_f[(r0 + r) * d.D + d.c_col + k] : 0.0f;
  }
  for (int i = threadIdx.x; i < R * 4; i += blockDim.x) rowv[i] = 0.0f;
  if (d.wstaged) {
    for (int i = threadIdx.x; i < n_out * H; i += blockDim.x) {
      wsm[(i / H) * d.eld + i % H] = head_weight(params, d, i / H, i % H);
    }
    for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
      const int q = o < d.n_heads * d.head_w ? o / d.head_w : d.n_heads;
      const int w = q < d.n_heads ? d.head_w : 1;
      bsm[o] = __ldg(params + d.head_off[q] + (size_t)H * w + (o - q * d.head_w));
    }
  }
  __shared__ uint64_t bars[rl8::kStStages];
  rl8::StRing ring = rl8::st_ring_init(bars);  // its barrier also publishes slot 0, the row stats and the head weights
  rl8::StRing* const slabs = kBulkSlabs ? &ring : nullptr;

  // ---------------- forward: the LSTM, the heads and the loss terms per step
  for (int t = 0; t < L; ++t) {
    for (int l = 0; l < K; ++l) {
      // z = b + x Wi + h Wh over the block's rows: x the obs columns (rows
      // past N read as 0) or layer l - 1's h' (slot t + 1), h slot t; gate
      // columns interleaved, so a thread's four adjacent columns are one
      // unit's gates. (fwd_product returns after a barrier, so the slots and
      // h' it reads are stored.)
      const long long slot = (long long)t * K + l;  // (step, layer) in the state scratch
      const float* xp = l == 0 ? packed_f + r0 * d.D + d.obs_col + (long long)t * d.d_in
                               : hseq_b + (slot + K - 1) * H;
      const long long ldx = l == 0 ? d.D : d.hs;
      const float* hp = hseq_b + slot * H;
      const rl8::FwdSeg seg[2] = {
          {{xp, ldx, l == 0 ? d.d_in : H, l == 0 ? nr : R, rl8::st_vec(xp, ldx)}, wt + d.cfi[l]},
          {{hp, d.hs, H, R, rl8::st_vec(hp, d.hs)}, wt + d.cfh[l]}};
      const float* b = params + d.wh_off[l] + (size_t)H * H4;
      rl8::fwd_product(
          seg, 2, 4 * H, st_smem,
          [&](auto& acc, const int(&n)[8]) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float bj = n[j] < 4 * H ? __ldg(b + (n[j] % 4) * H + n[j] / 4) : 0.0f;
#pragma unroll
              for (int i = 0; i < R / 16; ++i) acc[i][j] = bj;
            }
          },
          [&](auto& acc, int rg, const int(&n)[8]) {
            // The tile's two units' previous cell states, all loaded before
            // any store.
            float cp[R / 16][2];
#pragma unroll
            for (int i = 0; i < R / 16; ++i)
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const int j = n[4 * q] / 4;
                cp[i][q] = j < H ? cseq_b[(long long)(rg + 16 * i) * d.hs + slot * H + j] : 0.0f;
              }
#pragma unroll
            for (int i = 0; i < R / 16; ++i) {
              const long long r = rg + 16 * i;
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const int j = n[4 * q] / 4;
                if (j < H) {
                  float zi = acc[i][4 * q], zf = acc[i][4 * q + 1], zg = acc[i][4 * q + 2], zo = acc[i][4 * q + 3];
                  rl8::gate_activations(zi, zf, zg, zo);
                  float* gp = gz_b + r * d.gs + slot * H4 + j;
                  gp[0] = zi;
                  gp[H] = zf;
                  gp[2 * H] = zg;
                  gp[3 * H] = zo;
                  const float c = zf * cp[i][q] + zi * zg;
                  cseq_b[r * d.hs + (slot + K) * H + j] = c;
                  hseq_b[r * d.hs + (slot + K) * H + j] = zo * tanhf(c);
                }
              }
            }
          },
          slabs);
    }
    // The step's epilogue, d.erows rows a round through shared memory (the
    // stages are free between products): the rows of the top layer's h'
    // (slot t + 1) into hs, the heads into zs (a warp a row, lane l summing
    // k = l, l + 32, ... of up to four outputs at once in order, then an xor
    // butterfly: st_heads' sums), the loss terms turning them into their
    // cotangents in place (a thread a row; rows past N get zeros), and the
    // cotangents to the step's row of the head-cotangent scratch (where zs
    // is not that row itself).
    const float* top = hseq_b + ((long long)(t + 1) * K + K - 1) * H;
    float* dout_t = dout_b + (long long)t * n_out;
    float* hs = st_smem;  // [erows][eld]
    const bool vec = rl8::st_vec(top, d.hs) && H % 4 == 0;
    auto rounds = [&](auto hw, auto hb) {
      for (int rc = 0; rc < R; rc += d.erows) {
        const int er = min(d.erows, R - rc);
        float* zs = d.zsm ? hs + d.erows * d.eld : dout_t + rc * d.ds;  // [er][zld]
        const long long zld = d.zsm ? n_out : d.ds;
        if (vec) {
          const int q = H / 4;
          for (int i = threadIdx.x; i < er * q; i += blockDim.x) {
            const int r = i / q, k = 4 * (i % q);
            rl8::cp_async16(hs + r * d.eld + k, top + (rc + r) * d.hs + k, 16);
          }
        } else {
          for (int i = threadIdx.x; i < er * H; i += blockDim.x) {
            const int r = i / H, k = i % H;
            rl8::cp_async4(hs + r * d.eld + k, top + (rc + r) * d.hs + k, 4);
          }
        }
        rl8::cp_async_commit();
        rl8::cp_async_wait<0>();
        __syncthreads();
        for (int r = threadIdx.x / 32; r < er; r += blockDim.x / 32) {
          const float* x = hs + r * d.eld;
          for (int o0 = 0; o0 < n_out; o0 += 4) {
            float sq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
            for (int k = lane; k < H; k += 32) {
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
              if (lane == 0 && o0 + q < n_out) zs[r * zld + o0 + q] = sq[q] + hb(o0 + q);
            }
          }
        }
        __syncthreads();
        if (threadIdx.x < er) {
          const int r = rc + threadIdx.x;
          float* z = zs + threadIdx.x * zld;
          if (r < nr) {
            rl8::LossDims s = d;
            s.act_col += t * d.act_dim;
            s.logp_col += t;
            s.adv_col += t;
            s.ret_col += t;
            const int* row = packed + (r0 + r) * d.D;
            float v[4];
            if constexpr (kContinuous) {
              rl8::continuous_row(row, z, v, s, ec_scale);
            } else {
              rl8::policy_row(row, z, v, s, ec_scale);
            }
            rl8::value_row(row, z + n_out - 1, v, s);
#pragma unroll
            for (int i = 0; i < 4; ++i) rowv[r * 4 + i] += v[i];
          } else {
            for (int o = 0; o < n_out; ++o) z[o] = 0.0f;
          }
        }
        __syncthreads();
        if (d.zsm) {
          for (int i = threadIdx.x; i < er * n_out; i += blockDim.x) {
            dout_t[(long long)(rc + i / n_out) * d.ds + i % n_out] = zs[i];
          }
          __syncthreads();  // the next round, or the next product, reuses hs and zs
        }
      }
    };
    if (d.wstaged) {
      rounds([&](int o, int k) { return wsm[o * d.eld + k]; }, [&](int o) { return bsm[o]; });
    } else {
      rounds([&](int o, int k) { return head_weight(params, d, o, k); },
             [&](int o) {
               const int q = o < d.n_heads * d.head_w ? o / d.head_w : d.n_heads;
               const int w = q < d.n_heads ? d.head_w : 1;
               return __ldg(params + d.head_off[q] + (size_t)H * w + (o - q * d.head_w));
             });
    }
  }

  if (threadIdx.x < 4) {
    float s = 0.0f;
    for (int r = 0; r < nr; ++r) s += rowv[r * 4 + threadIdx.x];
    stat_part[(size_t)blockIdx.x * 4 + threadIdx.x] = s;
  }
}

// The staged route's row pass, second kernel: the backward through time,
// the steps and layers in reverse, kStRows sequences a block, one block an
// SM. Layer l's dh lives in its dh_t scratch: the dh_t product of the step
// after writes it, the heads' cotangent (top layer) or the dx product of
// layer l + 1 adds into it (writes it past the last step), and the cell
// backward reads it. dz overwrites the gates in the gate scratch; dc_t goes
// to its scratch. kVec (H a multiple of 4) selects the cell backward's
// 16-byte path; each width's kernel holds one path, so that the other's
// registers do not spill the products' (the 16-byte path in a kernel at H
// 1617, where it never runs, cost 0.7 ms of 19.3).
template <bool kVec>
__global__ void __launch_bounds__(rl8::kStThreads, 1)
    rnn_staged_bwd_kernel(const float* __restrict__ params, const float* __restrict__ wt,
                          const float* __restrict__ cseq, float* __restrict__ gz, const float* __restrict__ dout,
                          float* __restrict__ dht, float* __restrict__ dct, Dims d) {
  constexpr int R = rl8::kStRows;
  extern __shared__ __align__(128) float st_smem[];
  const int H = d.H, K = d.K, L = d.L, n_out = d.n_out;
  const long long H4 = 4LL * H;
  const long long r0 = (long long)blockIdx.x * R;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const float* cseq_b = cseq + r0 * d.hs;
  float* gz_b = gz + r0 * d.gs;
  const float* dout_b = dout + r0 * d.ds;
  // Where hfuse: the head weights [n_out][H] and the step's head
  // cotangents [R][n_out] in shared memory past the stages.
  const bool hfuse = kVec && d.hfuse;
  float* wsm = st_smem + rl8::kStBwdSmem / sizeof(float);
  float* dsm = wsm + (long long)n_out * H;
  if (hfuse) {
    for (int i = threadIdx.x; i < n_out * H; i += blockDim.x) wsm[i] = head_weight(params, d, i / H, i % H);
  }
  __shared__ uint64_t bars[rl8::kStStages];
  rl8::StRing ring = rl8::st_ring_init(bars);  // its barrier also publishes the head weights
  rl8::StRing* const slabs = kBulkSlabs ? &ring : nullptr;
  for (int t = L - 1; t >= 0; --t) {
    const bool last = t == L - 1;
    // The heads' cotangent into the top layer's dh: dout W_heads^T (the
    // heads are narrow, so a loop over their outputs). Where hfuse, the
    // top layer's cell backward sums it from shared memory (the step's
    // cotangents staged here); else a pass adds it into the layer's dh_t,
    // 32 rows at a time, each row's old dh loaded before the stores.
    if (hfuse) {
      for (int i = threadIdx.x; i < R * n_out; i += blockDim.x) {
        dsm[i] = dout_b[(long long)(i / n_out) * d.ds + (long long)t * n_out + i % n_out];
      }
    } else {
      const float* dos = dout_b + (long long)t * n_out;
      float* dh = dht + ((long long)(K - 1) * d.Npad + r0) * H;
      for (int j = threadIdx.x; j < H; j += blockDim.x) {
        for (int rc = 0; rc < R; rc += 32) {
          float acc[32], old[32];
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            acc[r] = 0.0f;
            old[r] = last ? 0.0f : dh[(long long)(rc + r) * H + j];
          }
          for (int o = 0; o < n_out; ++o) {
            const float w = head_weight(params, d, o, j);
#pragma unroll
            for (int r = 0; r < 32; ++r) acc[r] = fmaf(dos[(rc + r) * d.ds + o], w, acc[r]);
          }
#pragma unroll
          for (int r = 0; r < 32; ++r) dh[(long long)(rc + r) * H + j] = old[r] + acc[r];
        }
      }
    }
    for (int l = K - 1; l >= 0; --l) {
      __syncthreads();  // layer l's dh is complete
      // The cell backward, elementwise over the block's (row, unit) pairs:
      // four adjacent units a thread by 16-byte loads where H allows, two
      // groups' operands loaded before their stores; the top layer's dh
      // plus the heads' cotangent where hfuse.
      const long long slot = (long long)t * K + l;
      const bool heads = hfuse && l == K - 1;
      float* dh_l = dht + ((long long)l * d.Npad + r0) * H;
      float* dc_l = dct + ((long long)l * d.Npad + r0) * H;
      if constexpr (kVec) {
        const int G = H / 4, n = R * G;
        for (int i0 = threadIdx.x; i0 < n; i0 += 2 * blockDim.x) {
          float4 v[2][8];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = min(i0 + e * (int)blockDim.x, n - 1);
            const long long r = i / G, u = 4 * (i % G);
            const float* gp = gz_b + r * d.gs + slot * H4 + u;
            v[e][0] = heads && last ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                                    : *reinterpret_cast<const float4*>(dh_l + r * H + u);
            v[e][1] = last ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : *reinterpret_cast<const float4*>(dc_l + r * H + u);
            v[e][2] = *reinterpret_cast<const float4*>(gp);
            v[e][3] = *reinterpret_cast<const float4*>(gp + H);
            v[e][4] = *reinterpret_cast<const float4*>(gp + 2 * H);
            v[e][5] = *reinterpret_cast<const float4*>(gp + 3 * H);
            v[e][6] = *reinterpret_cast<const float4*>(cseq_b + r * d.hs + slot * H + u);
            v[e][7] = *reinterpret_cast<const float4*>(cseq_b + r * d.hs + (slot + K) * H + u);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + e * (int)blockDim.x;
            if (i >= n) break;
            const long long r = i / G, u = 4 * (i % G);
            if (heads) {
              float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              for (int o = 0; o < n_out; ++o) {
                const float dv = dsm[r * n_out + o];
                const float4 w = *reinterpret_cast<const float4*>(wsm + (long long)o * H + u);
                acc = make_float4(fmaf(dv, w.x, acc.x), fmaf(dv, w.y, acc.y), fmaf(dv, w.z, acc.z),
                                  fmaf(dv, w.w, acc.w));
              }
              v[e][0] = make_float4(v[e][0].x + acc.x, v[e][0].y + acc.y, v[e][0].z + acc.z, v[e][0].w + acc.w);
            }
            float dz[4][4], dcp[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float z[4], f[8];
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                f[q] = k == 0 ? v[e][q].x : k == 1 ? v[e][q].y : k == 2 ? v[e][q].z : v[e][q].w;
              }
              cell_backward(f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], z, dcp[k]);
#pragma unroll
              for (int q = 0; q < 4; ++q) dz[q][k] = z[q];
            }
            float* gp = gz_b + r * d.gs + slot * H4 + u;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              *reinterpret_cast<float4*>(gp + q * H) = make_float4(dz[q][0], dz[q][1], dz[q][2], dz[q][3]);
            }
            *reinterpret_cast<float4*>(dc_l + r * H + u) = make_float4(dcp[0], dcp[1], dcp[2], dcp[3]);
          }
        }
      } else {
#pragma unroll 4
        for (long long i = threadIdx.x; i < R * (long long)H; i += blockDim.x) {
          const long long r = i / H, u = i % H;
          float* gp = gz_b + r * d.gs + slot * H4 + u;
          float z[4], dcp;
          cell_backward(dh_l[r * H + u], last ? 0.0f : dc_l[r * H + u], gp[0], gp[H], gp[2 * H], gp[3 * H],
                        cseq_b[r * d.hs + slot * H + u], cseq_b[r * d.hs + (slot + K) * H + u], z, dcp);
#pragma unroll
          for (int q = 0; q < 4; ++q) gp[q * H] = z[q];
          dc_l[r * H + u] = dcp;
        }
      }
      __syncthreads();
      // dh_t = dz Wh^T for the previous step (none before step 0: the
      // stored initial states take no gradient), into layer l's dh; dx = dz
      // Wi^T into layer l - 1's dh (added to its dh_t, each pass's old
      // values loaded before its stores). Both on the tensor cores, dz read
      // from the gate scratch.
      const float* dz = gz_b + slot * H4;
      const rl8::StRows a{dz, d.gs, 4 * H, R, rl8::st_vec(dz, d.gs)};
      if (t > 0) {
        rl8::bwd_passes(a, wt + d.cbh[l], wt + d.cbhs[l], H, st_smem, [&](const float(&sum)[2][32], int u0) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              // D [64, 64]: row 16 warp + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2.
              const int r = 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
              const int u = u0 + 64 * h + 8 * (i >> 2) + 2 * tq + (i & 1);
              if (u < H) dh_l[(long long)r * H + u] = sum[h][i];
            }
        }, slabs);
      }
      if (l > 0) {
        float* dh_b = dht + ((long long)(l - 1) * d.Npad + r0) * H;
        rl8::bwd_passes(a, wt + d.cbi[l], wt + d.cbis[l], H, st_smem, [&](const float(&sum)[2][32], int u0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float old[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int r = 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
              const int u = u0 + 64 * h + 8 * (i >> 2) + 2 * tq + (i & 1);
              old[i] = !last && u < H ? dh_b[(long long)r * H + u] : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int r = 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
              const int u = u0 + 64 * h + 8 * (i >> 2) + 2 * tq + (i & 1);
              if (u < H) dh_b[(long long)r * H + u] = old[i] + sum[h][i];
            }
          }
        }, slabs);
      }
    }
  }
}

}  // namespace

// Floats of workspace that rl8_rnn_ppo_grads needs for these shapes, or -1.
extern "C" long long rl8_rnn_ppo_workspace(int N, int d_in, int H, int L, int K, int kind, int act_dim,
                                           int n_cat) {
  Layout Lo;
  if (!make_layout(N, d_in, H, L, K, kind, act_dim, n_cat, &Lo)) return -1;
  return Lo.wt_floats + 2 * Lo.state_floats + Lo.gz_floats + Lo.dout_floats + 2 * Lo.time_floats + Lo.part_floats +
         Lo.stat_floats;
}

// cols: obs, hidden states, cell states, actions, logp, advantages, returns
// (first column of each; each leaf [L, ...] or [K, H] flattened); the
// action columns are int32 for the categorical kind and f32 bit patterns for
// the continuous ones. grads [P] (ops/fused_rnn_act.py:RnnParams order) and
// stats [4] (policy, vf, entropy, kl sums over the N L samples) are outputs.
extern "C" int rl8_rnn_ppo_grads(const int* packed, int N, int D, const int* cols, const float* ec,
                                 const float* params, float* grads, float* stats, float* workspace, int d_in,
                                 int H, int L, int K, int kind, int act_dim, int n_cat, float clip_lo,
                                 float clip_hi, float dual, float vf_clip, float vf_scale, float scale,
                                 int use_entropy, int device, void* stream) {
  Layout Lo;
  if (!make_layout(N, d_in, H, L, K, kind, act_dim, n_cat, &Lo) || (kind == kSquashed && use_entropy)) {
    return (int)cudaErrorInvalidValue;
  }
  Dims& d = Lo.d;
  d.D = D;
  d.obs_col = cols[0];
  d.h_col = cols[1];
  d.c_col = cols[2];
  d.act_col = cols[3];
  d.logp_col = cols[4];
  d.adv_col = cols[5];
  d.ret_col = cols[6];
  const int widths[7] = {L * d_in, K * H, K * H, L * act_dim, L, L, L};
  for (int i = 0; i < 7; ++i) {
    if (cols[i] < 0 || cols[i] + widths[i] > D) return (int)cudaErrorInvalidValue;
  }
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
  float* hseq = wt + Lo.wt_floats;
  float* cseq = hseq + Lo.state_floats;
  float* gz = cseq + Lo.state_floats;
  float* dout = gz + Lo.gz_floats;
  float* dht = dout + Lo.dout_floats;
  float* dct = dht + Lo.time_floats;
  float* partials = dct + Lo.time_floats;
  float* stat_part = partials + Lo.part_floats;

  for (int l = 0; l < K && Lo.staged; ++l) {
    // The staged route's copies: Wi, Wh for the forward (gates interleaved),
    // the TF32 halves of Wh and (l >= 1) Wi for the backward.
    const int in = l == 0 ? d_in : H;
    const float* wi = params + d.wi_off[l];
    const float* wh = params + d.wh_off[l];
    rl8::tile_fwd_kernel<<<rl8::grid_for(rl8::fwd_copy_floats(in, 4 * H)), kThreads, 0, s>>>(wi, 4 * H, in, 4 * H, H,
                                                                                            wt + d.cfi[l]);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rl8::tile_fwd_kernel<<<rl8::grid_for(rl8::fwd_copy_floats(H, 4 * H)), kThreads, 0, s>>>(wh, 4 * H, H, 4 * H, H,
                                                                                           wt + d.cfh[l]);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (int q = 0; q < (l > 0 ? 2 : 1); ++q) {
      rl8::tile_bwd_kernel<<<rl8::grid_for(rl8::bwd_copy_floats(4 * H, H)), kThreads, 0, s>>>(
          q == 0 ? wh : wi, 4 * H, 4 * H, H, wt + (q == 0 ? d.cbh[l] : d.cbi[l]), wt + (q == 0 ? d.cbhs[l] : d.cbis[l]));
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  for (int l = 0; l < K && !Lo.staged; ++l) {
    const long long in = l == 0 ? d_in : H;
    rl8::transpose_kernel<<<rl8::grid_for(4LL * H * H), kThreads, 0, s>>>(params + d.wh_off[l],
                                                                          wt + d.whT_off[l], H, 4 * H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (l > 0) {
      rl8::transpose_kernel<<<rl8::grid_for(4LL * in * H), kThreads, 0, s>>>(params + d.wi_off[l],
                                                                             wt + d.wiT_off[l], (int)in, 4 * H);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }

  if (Lo.staged) {
    const auto fwd_kernel = kind == kCategorical ? rnn_staged_fwd_kernel<false> : rnn_staged_fwd_kernel<true>;
    err = cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lo.smem);
    if (err != cudaSuccess) return (int)err;
    fwd_kernel<<<Lo.row_blocks, rl8::kStThreads, Lo.smem, s>>>(packed, ec, params, wt, hseq, cseq, gz, dout,
                                                               stat_part, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const auto bwd_kernel = H % 4 == 0 ? rnn_staged_bwd_kernel<true> : rnn_staged_bwd_kernel<false>;
    err = cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lo.bsmem);
    if (err != cudaSuccess) return (int)err;
    bwd_kernel<<<Lo.row_blocks, rl8::kStThreads, Lo.bsmem, s>>>(params, wt, cseq, gz, dout, dht, dct, d);
  } else {
    const auto rows_kernel = kind == kCategorical ? rnn_rows_kernel<false> : rnn_rows_kernel<true>;
    err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lo.smem);
    if (err != cudaSuccess) return (int)err;
    rows_kernel<<<Lo.row_blocks, kThreads, Lo.smem, s>>>(packed, ec, params, wt, hseq, cseq, gz, dout, dht, dct,
                                                        stat_part, d);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // The weight products over the N L (sequence, step) rows: row (n, t) of
  // an operand lies at n * outer + t * inner.
  std::vector<Job> jobs;
  const long long KH = (long long)K * H;
  for (int l = 0; l < K; ++l) {
    Job jb;
    jb.b = gz + (size_t)l * 4 * H;  // dz of (n, t, l)
    jb.b_outer = d.gs;
    jb.b_inner = KH * 4;
    jb.J = 4 * H;
    // dWi: the layer's input, obs or h' of the layer below (slot t + 1).
    jb.K = l == 0 ? d_in : H;
    jb.bias = 0;
    jb.off = d.wi_off[l];
    if (l == 0) {
      jb.a = reinterpret_cast<const float*>(packed) + d.obs_col;
      jb.a_outer = D;
      jb.a_inner = d_in;
    } else {
      jb.a = hseq + KH + (size_t)(l - 1) * H;
      jb.a_outer = d.hs;
      jb.a_inner = KH;
    }
    jobs.push_back(jb);
    // dWh and db: the previous hidden state (slot t).
    jb.K = H;
    jb.bias = 1;
    jb.off = d.wh_off[l];
    jb.a = hseq + (size_t)l * H;
    jb.a_outer = d.hs;
    jb.a_inner = KH;
    jobs.push_back(jb);
  }
  for (int q = 0; q <= d.n_heads; ++q) {
    Job jb;
    jb.K = H;
    jb.J = q < d.n_heads ? d.head_w : 1;
    jb.bias = 1;
    jb.off = d.head_off[q];
    jb.a = hseq + KH + (size_t)(K - 1) * H;  // the top layer's h' (slot t + 1)
    jb.a_outer = d.hs;
    jb.a_inner = KH;
    jb.b = dout + (q < d.n_heads ? q * d.head_w : d.n_out - 1);
    jb.b_outer = d.ds;
    jb.b_inner = d.n_out;
    jobs.push_back(jb);
  }
  err = rl8::launch_jobs(jobs.data(), (long long)jobs.size(), (long long)N * L, Lo.groups, Lo.rows_per_group, Lo.P,
                         partials, s, L);
  if (err != cudaSuccess) return (int)err;
  rl8::sum_partials_kernel<<<rl8::grid_for(Lo.P), rl8::kWgThreads, 0, s>>>(partials, Lo.groups, Lo.P, grads, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rl8::sum_stats_kernel<<<1, rl8::kWgThreads, 0, s>>>(stat_part, Lo.row_blocks, stats);
  return (int)cudaGetLastError();
}

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
// at the tensor cores' 495 TFLOP/s.
//
// Design. On the TPU the grid runs in order and every grid step adds its
// tile's gradients into VMEM; CUDA blocks run in parallel, so, as in
// ppo.cu, the work is split in passes with no float atomics (the result is
// bit-identical from launch to launch):
//   1. rnn_rows_kernel: a block of 256 threads owns kRows = 16 sequences, two
//      blocks to an SM (32 sequences a block, one to an SM, so that each
//      weight read from L2 feeds 32, made the launch 22.55 ms against 19.1
//      on an H100, kernel_variants.py's rnn_rows32: the pass waits on
//      latency). The forward runs on the CUDA cores, thread j owning hidden
//      unit j (lstm.cuh): the tensor cores round toward zero (mma.cuh), and
//      the forward's values feed the loss, whose cotangents sum any bias over
//      every sample (ppo.cu says what that did to the feedforward update). It
//      writes, per (sequence, step, layer), h' and c' (slot t + 1 of an [L +
//      1] state scratch whose slot 0 holds the stored states) and the four
//      gate activations to a scratch in device memory (26.7 KB per sequence
//      at the main path, 1.75 GB at N = 65,536), and per step the heads'
//      cotangents. The backward reads them back; the gate cotangents dz
//      overwrite the gate activations in place and go to shared memory, the A
//      operand of dh_t = dz Wh^T and dx = dz Wi^T, which run on the tensor
//      cores (mma.cuh's 3xTF32) with the transposed weights read from L2 as B
//      fragments in place, two k steps ahead. Warp w owns hidden-unit tiles
//      w, w + 8, ... (8 units each), so lane (g, tq) holds the same
//      (sequence, unit) pairs in the cell backward and in the products'
//      outputs: a unit's dh_t, dc_t and gates pass through no barrier.
//   2. wgrad.cuh's split-K weight products over the N L (sequence, step)
//      rows, read in place from the scratch with an outer (sequence) and an
//      inner (step) stride, on tensor-core tiles: dWh (H by 4H, db as its
//      bias row), dWi and the heads.
//   3. The fixed-order sums of the partials and of the blocks' stats.
// Sequences past N are zeros in the last block: their states, inputs and
// cotangents are 0, and the weight products read rows below N only.
#include <cuda_runtime.h>
#include <math.h>

#include "distmath.cuh"
#include "lstm.cuh"
#include "mlp.cuh"
#include "mma.cuh"
#include "ppo_terms.cuh"
#include "wgrad.cuh"

namespace {

using rl8::FragA;
using rl8::FragB;
using rl8::Job;
using rl8::Jobs;
using rl8::kCategorical;
using rl8::kSquashed;
using rl8::narrow_head;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // sequences per block of the row pass
constexpr int kMaxLayers = 8;
constexpr int kMaxHeads = 3;  // policy heads and the value head
// A block's shared memory on an H100 (227 KB): the one limit on the width.
// make_layout refuses a row pass larger than this, and
// rl8_rnn_ppo_workspace then returns -1 (which
// ops/fused_rnn_ppo.py:card_takes_rnn_update asks).
constexpr size_t kMaxSmem = 232448;
static_assert(2 * kMaxLayers + kMaxHeads <= rl8::kMaxWgJobs, "weight-product jobs");

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
};

// The parameter layout and the workspace (floats): [Wh^T, Wi^T copies][h
// scratch][c scratch][gates, then dz][head cotangents][dh_t][dc_t]
// [partials: groups x P][stats: blocks x 4].
struct Layout {
  Dims d;
  long long P, wt_floats, state_floats, gz_floats, dout_floats, time_floats, part_floats, stat_floats;
  long long rows_per_group;
  int groups, row_blocks;
  size_t smem;
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

// The row pass's strides are padded where that fits shared memory, else
// unpadded (as wide as the kernel took before the padding); false where
// neither fits.
bool make_layout(int N, int d_in, int H, int L, int K, int kind, int act_dim, int n_cat, Layout* Lo) {
  // The weight products divide a row index by L in 32 bits.
  if (N <= 0 || d_in <= 0 || H <= 0 || L <= 0 || K < 1 || K > kMaxLayers || act_dim <= 0 ||
      kind < kCategorical || kind > kSquashed || (kind == kCategorical && n_cat < 2) ||
      (long long)N * L >= (1LL << 31)) {
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
  Lo->wt_floats = wt;
  Lo->smem = set_strides(d, true);
  if (Lo->smem > kMaxSmem) Lo->smem = set_strides(d, false);
  Lo->row_blocks = (N + kRows - 1) / kRows;
  d.Npad = (long long)Lo->row_blocks * kRows;
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
  float* dx = dzs + kRows * ldz;              // [kRows, ldh]
  float* dos = dx + kRows * ldh;              // [kRows, n_out]
  float* head = smem + kRows * d.u_floats;    // [kRows, n_out]: outputs, then cotangents
  float* rowv = head + kRows * d.n_out;       // [kRows, 4]: pol, vf, ent, kl over the steps

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
      cur[r * ldx + i % in_w] =
          r < nr ? packed_f[(size_t)(r0 + r) * d.D + d.obs_col + t * in_w + i % in_w] : 0.0f;
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

}  // namespace

// Floats of workspace that rl8_rnn_ppo_grads needs for these shapes, or -1.
extern "C" long long rl8_rnn_ppo_workspace(int N, int d_in, int H, int L, int K, int kind, int act_dim,
                                           int n_cat) {
  Layout Lo;
  if (!make_layout(N, d_in, H, L, K, kind, act_dim, n_cat, &Lo)) return -1;
  return Lo.wt_floats + 2 * Lo.state_floats + Lo.gz_floats + Lo.dout_floats + 2 * Lo.time_floats +
         Lo.part_floats + Lo.stat_floats;
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

  for (int l = 0; l < K; ++l) {
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

  const auto rows_kernel = kind == kCategorical ? rnn_rows_kernel<false> : rnn_rows_kernel<true>;
  err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lo.smem);
  if (err != cudaSuccess) return (int)err;
  rows_kernel<<<Lo.row_blocks, kThreads, Lo.smem, s>>>(packed, ec, params, wt, hseq, cseq, gz, dout, dht, dct,
                                                      stat_part, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // The weight products over the N L (sequence, step) rows: row (n, t) of
  // an operand lies at n * outer + t * inner.
  Jobs tiled;
  tiled.n = 0;
  tiled.inner_rows = L;
  tiled.rows_per_group = Lo.rows_per_group;
  tiled.rows = (long long)N * L;
  tiled.P = Lo.P;
  int tiles = 0;
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
    rl8::add_tiled(jb, &tiled, &tiles);
    // dWh and db: the previous hidden state (slot t).
    jb.K = H;
    jb.bias = 1;
    jb.off = d.wh_off[l];
    jb.a = hseq + (size_t)l * H;
    jb.a_outer = d.hs;
    jb.a_inner = KH;
    rl8::add_tiled(jb, &tiled, &tiles);
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
    rl8::add_tiled(jb, &tiled, &tiles);
  }
  return (int)rl8::launch_wgrad(tiled, tiles, Lo.groups, partials, grads, stat_part, Lo.row_blocks,
                                stats, s);
}

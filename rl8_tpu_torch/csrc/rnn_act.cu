// Recurrent act kernel: one rollout step of a default recurrent model, in one
// call (one launch on the 32-row tiles; the staged route's few, below).
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
// Two routes, picked by shape at launch (make_plan):
//
// The staged route (every LSTM at least kStagedMinWidth = 128 wide, the
// main path's among them, and every other shape the 32-row tiles do not
// fit) runs a launch as kernels on stage.cuh's parts:
//   - per layer, TF32 big and small halves of Wi and Wh in the stages'
//     K-major layout, the gate columns permuted so that the thread of a
//     wgmma D fragment holds all four gates of its units (tile_tc_kernel,
//     into the scratch the wrapper allocates, rl8_rnn_act_scratch); a first
//     layer of at most kFoldInputs inputs needs no copy of Wi;
//   - per layer, rnn_gates_tc_kernel over a grid of (32-unit tiles,
//     128-row tiles): a block streams its rows of the layer input (the
//     observations, or layer l - 1's h' from h_out) and of h0 through a
//     3-stage ring in shared memory by cp.async, and its unit tile's 32-deep
//     weight slabs by bulk copies (the TMA unit, counted by the stages'
//     mbarriers, stage.cuh's StRing), and sums x Wi, then h Wh, on the
//     tensor cores in 3xTF32 wgmma (tc_product: each weight slab feeds all
//     128 rows; a fresh accumulator every 32 k folded into an f32 sum, so
//     wgmma's truncation does not build up over the 257- to 3234-deep
//     sums); a first layer of at most kFoldInputs inputs (the dummy envs'
//     one) skips its 32-deep stage: the epilogue adds x Wi on the CUDA
//     cores; then the bias and the cell update on the sums in registers
//     (the previous cell states loaded before any store), h' and c' out;
//   - rnn_heads_kernel over blocks of 8 rows: the heads on the top layer's
//     h' in h_out (st_heads: narrow_head's sums), into the scratch, then
//     sample.cuh's epilogue.
// Its shared memory is the ring's, whatever H and the heads; offsets are
// 64-bit. At the main path the gate grid is 8 x 64 blocks, one to an SM,
// ~3.9 waves on 132 SMs. On an NVIDIA H100 80GB HBM3 at 700.00 W
// (kernel_variants.py, PERF.md §6) the launch at the main path took 0.114
// ms (gates 0.098, heads 0.0097, the Wh copy 0.0034) against the 32-row
// tiles' 0.168, at H 1024 x 8,192 rows 1.19-1.21 ms (the same route with f32
// gates on the CUDA cores, fwd_product, an ablation since removed, 1.94;
// the earlier 16-row tiles 7.01), the plain version 3.6-4.1.
//
// The 32-row tiles (rnn_act_kernel: LSTMs narrower than 128 whose 32-row
// tile fits two blocks to an SM; kernel_variants.py's rnn_act_shapes grid
// measured them faster at 64 wide for 1 to 8,192 rows, and slower from 128
// up at every row count). A block of 256 threads owns 32 rows. The gate
// products run on the tensor cores through mma.cuh's 3xTF32 (f32-accurate
// per product; each k step of 8 in a fresh accumulator, so the tensor
// core's truncation does not build up). Warp w owns hidden-unit tiles w, w +
// 8, ... of 8 units, and for each computes the unit tile's four gate
// columns (i, f, g, o) for every row of the block, so lane (g, tq) holds
// all four gates of its (row, unit) pairs in its accumulator fragments and
// the cell update runs there, with no pass through shared memory. Each
// weight is read from L2 once per block, as B fragments in place, two k
// steps ahead of the products. The layer's input and previous hidden state
// lie in shared memory, their rows padded to 4 past a multiple of 32 so
// that the A fragment loads are free of bank conflicts. The narrow heads
// and the sampling stay on the CUDA cores.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "distmath.cuh"
#include "lstm.cuh"
#include "mlp.cuh"
#include "mma.cuh"
#include "sample.cuh"
#include "stage.cuh"

namespace {

using rl8::FragA;
using rl8::FragB;
using rl8::kCategorical;
using rl8::kSquashed;
using rl8::narrow_head;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 8;
constexpr int kRows = 32;                      // rows a block of the 32-row tiles
constexpr size_t kTwoBlocksSmem = 113 * 1024;  // two blocks to an SM
constexpr int kAhead = 2;  // k steps of weights in flight ahead of the products
constexpr int kHeadRows = 8;  // rows a block of the staged route's heads kernel
// The staged gates' weight slabs by bulk copies (stage.cuh's StRing), not
// every thread's cp.async.
constexpr bool kBulkSlabs = true;
// A first layer of at most this many inputs (the dummy envs' one) adds x Wi
// on the CUDA cores in the staged gates' epilogue, from the observations and
// the parameters, instead of taking a 32-deep stage of its own (and a copy).
constexpr int kFoldInputs = 4;
// The staged route takes every LSTM at least this wide, and whatever the
// 32-row tiles do not fit two blocks to an SM (kernel_variants.py's
// rnn_act_shapes grid: the tiles win at 64 wide, the staged route from 128,
// at every row count from 1 to 8,192).
constexpr int kStagedMinWidth = 128;

struct RnnActDims {
  int d_in, H, K, act_dim, n_cat;
  int n_heads;  // policy heads: 1 (logits) or 2 (mean, pre-tanh log-std)
  int head_w;   // each policy head's width: A * n, or A
  int stride;   // n_heads * head_w + 1: the heads' row, the value last
  int ldx;      // row stride of a layer input: max(d_in, H), padded
  int ldh;      // row stride of the previous hidden state: H, padded
};

// Floats of shared memory for the 32-row tiles: two layer inputs, the
// previous hidden state, the heads and the sampling scratch (2A per row).
size_t smem_floats(const RnnActDims& d) {
  return (size_t)kRows * (2 * d.ldx + d.ldh + d.stride + 2 * d.act_dim);
}

// The staged route's scratch: per layer the big and small TF32 copies of
// Wi and Wh (tile_tc_kernel's layout, gate columns permuted), then the
// heads' rows and the sampling scratch of every kHeadRows rows.
struct Staged {
  long long wi[kMaxLayers], wh[kMaxLayers];    // the big halves' offsets
  long long wis[kMaxLayers], whs[kMaxLayers];  // the small halves'
  long long heads;                             // the heads' rows' offset
  long long floats;                            // the whole scratch
};

Staged staged_layout(const RnnActDims& d, int B) {
  Staged s;
  long long off = 0;
  for (int l = 0; l < d.K; ++l) {
    const int in_w = l == 0 ? d.d_in : d.H;
    const long long fi = rl8::bwd_copy_floats(in_w, 4 * d.H), fh = rl8::bwd_copy_floats(d.H, 4 * d.H);
    s.wi[l] = off;
    s.wis[l] = off += fi;
    s.wh[l] = off += fi;
    s.whs[l] = off += fh;
    off += fh;
  }
  s.heads = off;
  s.floats = off + (long long)(B + kHeadRows - 1) / kHeadRows * kHeadRows * (d.stride + 2 * d.act_dim);
  return s;
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

// The 32-row tiles (see the file's head).
template <bool kContinuous>
__global__ void __launch_bounds__(kThreads, 2)
    rnn_act_kernel(const float* __restrict__ obs, const float* __restrict__ h0, const float* __restrict__ c0,
                   const float* __restrict__ params, void* __restrict__ actions, float* __restrict__ logp,
                   float* __restrict__ values, float* __restrict__ h_out, float* __restrict__ c_out, int B,
                   RnnActDims d, int squashed, uint32_t seed, uint32_t offset, int deterministic) {
  constexpr int MT = kRows / 16, R = kRows;
  extern __shared__ __align__(16) float smem[];
  const int H = d.H, KH = d.K * H, ldx = d.ldx, ldh = d.ldh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  float* cur = smem;              // [R, ldx]: the layer's input
  float* nxt = cur + R * ldx;     // [R, ldx]: its output, the next layer's input
  float* hp = nxt + R * ldx;      // [R, ldh]: the layer's previous hidden state
  float* heads = hp + R * ldh;    // [R, stride]
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

// The staged route's layer l: blockIdx.x is a tile of 32 units
// (tc_product's 128 gate columns, in tile_tc_kernel's order), blockIdx.y
// the first 128-row tile, which steps by gridDim.y; each gate's sum is the
// products' (x Wi, then h Wh, in 32-deep chunks) plus its bias. x [B, in_w]
// (rows ldx apart) is the layer's input (for l >= 1 layer l - 1's columns
// of h_out), h0 and c0 the stored states; h' and c' go to layer l's columns
// of h_out and c_out (rows KH apart). Where fold, x Wi is not a product:
// the epilogue adds x[r, k] wi_fold[k, gate column] over the in_w inputs
// (the layer's Wi as stored, [in_w, 4H]) to the h Wh sums, then the bias.
__global__ void __launch_bounds__(rl8::kStThreads, 1)
    rnn_gates_tc_kernel(const float* x, long long ldx, int in_w, const float* __restrict__ h0,
                        const float* __restrict__ c0, const float* __restrict__ wi_big,
                        const float* __restrict__ wi_small, const float* __restrict__ wh_big,
                        const float* __restrict__ wh_small, const float* __restrict__ b, float* __restrict__ h_out,
                        float* __restrict__ c_out, int B, int H, int K, int l, int fold,
                        const float* __restrict__ wi_fold) {
  constexpr int R = rl8::kStRows;
  extern __shared__ __align__(128) float st_smem[];
  const long long KH = (long long)K * H;
  const long long si = (in_w + rl8::kStK - 1) / rl8::kStK, sh = (H + rl8::kStK - 1) / rl8::kStK;
  const long long wi = blockIdx.x * si * rl8::kStWFloats, wh = blockIdx.x * sh * rl8::kStWFloats;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, g = (threadIdx.x % 32) / 4, tq = threadIdx.x % 4;
  const long long tiles = (B + R - 1) / R;
  __shared__ uint64_t bars[rl8::kStStages];
  rl8::StRing ring = rl8::st_ring_init(bars);
  rl8::StRing* const slabs = kBulkSlabs ? &ring : nullptr;
  for (long long t = blockIdx.y; t < tiles; t += gridDim.y) {
    const long long r0 = t * R;
    const int nr = (int)min((long long)R, B - r0);
    const float* xp = x + r0 * ldx;
    const float* hp = h0 + r0 * KH + (long long)l * H;
    const rl8::TcSeg seg[2] = {{{xp, ldx, in_w, nr, rl8::st_vec(xp, ldx)}, wi_big + wi, wi_small + wi},
                               {{hp, KH, H, nr, rl8::st_vec(hp, KH)}, wh_big + wh, wh_small + wh}};
    rl8::tc_product(fold ? seg + 1 : seg, fold ? 1 : 2, st_smem, [&](const float(&sum)[2][32]) {
      // The thread's rows' folded inputs and previous cell states, loaded
      // before any store.
      float xr[2][kFoldInputs], cp[2][4][2];
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int r = 64 * wg + 16 * warp + g + 8 * rh;
#pragma unroll
        for (int k = 0; k < kFoldInputs; ++k) xr[rh][k] = k < in_w && fold && r < nr ? x[(r0 + r) * ldx + k] : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int j = 32 * blockIdx.x + 16 * h + 4 * m + tq;
            cp[h][m][rh] = r < nr && j < H ? c0[(r0 + r) * KH + (long long)l * H + j] : 0.0f;
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = 32 * blockIdx.x + 16 * h + 4 * m + tq;
          if (j >= H) continue;
          const float bi = __ldg(b + j), bf = __ldg(b + H + j), bg = __ldg(b + 2 * H + j), bo = __ldg(b + 3 * H + j);
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int r = 64 * wg + 16 * warp + g + 8 * rh;
            if (r >= nr) continue;
            float zi = sum[h][8 * m + 2 * rh], zf = sum[h][8 * m + 2 * rh + 1];
            float zg = sum[h][8 * m + 4 + 2 * rh], zo = sum[h][8 * m + 4 + 2 * rh + 1];
#pragma unroll
            for (int k = 0; k < kFoldInputs; ++k) {
              if (fold && k < in_w) {
                const float* w = wi_fold + (long long)k * 4 * H + j;
                zi = fmaf(xr[rh][k], __ldg(w), zi);
                zf = fmaf(xr[rh][k], __ldg(w + H), zf);
                zg = fmaf(xr[rh][k], __ldg(w + 2 * H), zg);
                zo = fmaf(xr[rh][k], __ldg(w + 3 * H), zo);
              }
            }
            zi += bi;
            zf += bf;
            zg += bg;
            zo += bo;
            rl8::gate_activations(zi, zf, zg, zo);
            const long long at = (r0 + r) * KH + (long long)l * H + j;
            const float c = zf * cp[h][m][rh] + zi * zg;
            h_out[at] = zo * tanhf(c);
            c_out[at] = c;
          }
        }
    }, slabs);
  }
}

// The staged route's heads and sampling over blocks of kHeadRows rows: the
// heads on the top layer's h' (in h_out) into the block's rows of the
// scratch (the policy heads side by side, the value last), then the kind's
// epilogue. heads_p points at the first head's W.
template <bool kContinuous>
__global__ void __launch_bounds__(rl8::kStThreads)
    rnn_heads_kernel(const float* __restrict__ h_out, const float* __restrict__ heads_p, float* __restrict__ rows,
                     void* __restrict__ actions, float* __restrict__ logp, float* __restrict__ values, int B,
                     RnnActDims d, int squashed, uint32_t seed, uint32_t offset, int deterministic) {
  const int H = d.H;
  const long long KH = (long long)d.K * H;
  const int r0 = blockIdx.x * kHeadRows;
  const int nr = min(kHeadRows, B - r0);
  const float* top = h_out + (long long)r0 * KH + (long long)(d.K - 1) * H;
  float* heads = rows + (long long)blockIdx.x * kHeadRows * (d.stride + 2 * d.act_dim);  // [kHeadRows, stride]
  float* scratch = heads + kHeadRows * d.stride;                                           // [kHeadRows, 2A]
  const float* p = heads_p;
  for (int q = 0; q <= d.n_heads; ++q) {
    const int w = q < d.n_heads ? d.head_w : 1;
    rl8::st_heads(top, KH, H, p, p + (size_t)H * w, w, heads, d.stride, q < d.n_heads ? q * w : d.stride - 1, nr);
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

// The staged route's launches (see the file's head), on `scratch`
// (staged_layout's floats).
cudaError_t launch_staged(const RnnActDims& d, int kind, const float* obs, const float* h0, const float* c0,
                          const float* params, void* actions, float* logp, float* values, float* h_out,
                          float* c_out, float* scratch, int B, uint32_t seed, uint32_t offset, int deterministic,
                          cudaStream_t s) {
  const Staged S = staged_layout(d, B);
  const int H = d.H;
  const long long KH = (long long)d.K * H;
  cudaError_t err =
      cudaFuncSetAttribute(rnn_gates_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rl8::kStBwdSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((4 * H + rl8::kStPass - 1) / rl8::kStPass, rl8::st_row_grid(B));
  const float* p = params;
  for (int l = 0; l < d.K; ++l) {
    const int in_w = l == 0 ? d.d_in : H;
    const float* wi = p;
    const float* wh = wi + (size_t)in_w * 4 * H;
    const float* b = wh + (size_t)H * 4 * H;
    p = b + 4 * H;
    const float* x = l == 0 ? obs : h_out + (size_t)(l - 1) * H;
    const int fold = l == 0 && in_w <= kFoldInputs;
    if (!fold) {
      rl8::tile_tc_kernel<<<rl8::st_copy_grid(rl8::bwd_copy_floats(in_w, 4 * H)), rl8::kStThreads, 0, s>>>(
          wi, 4 * H, in_w, 4 * H, H, scratch + S.wi[l], scratch + S.wis[l]);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    rl8::tile_tc_kernel<<<rl8::st_copy_grid(rl8::bwd_copy_floats(H, 4 * H)), rl8::kStThreads, 0, s>>>(
        wh, 4 * H, H, 4 * H, H, scratch + S.wh[l], scratch + S.whs[l]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    rnn_gates_tc_kernel<<<grid, rl8::kStThreads, rl8::kStBwdSmem, s>>>(
        x, l == 0 ? d.d_in : KH, in_w, h0, c0, scratch + S.wi[l], scratch + S.wis[l], scratch + S.wh[l],
        scratch + S.whs[l], b, h_out, c_out, B, H, d.K, l, fold, wi);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const auto heads = kind == kCategorical ? rnn_heads_kernel<false> : rnn_heads_kernel<true>;
  heads<<<(B + kHeadRows - 1) / kHeadRows, rl8::kStThreads, 0, s>>>(
      h_out, p, scratch + S.heads, actions, logp, values, B, d, (int)(kind == kSquashed), seed, offset,
      deterministic);
  return cudaGetLastError();
}

// The route of a launch for these shapes, with d filled in: 2 (the 32-row
// tiles, where such a tile fits two blocks to an SM), 1 (the staged route,
// any other shape), or -1 (no route takes them: arguments out of range).
int make_plan(int B, int d_in, int H, int K, int kind, int act_dim, int n_cat, RnnActDims* d) {
  if (B <= 0 || d_in <= 0 || H <= 0 || K < 1 || K > kMaxLayers || act_dim <= 0 || kind < kCategorical ||
      kind > kSquashed || (kind == kCategorical && n_cat < 2) || 4LL * H > (1LL << 30)) {
    return -1;
  }
  d->d_in = d_in;
  d->H = H;
  d->K = K;
  d->act_dim = act_dim;
  d->n_cat = n_cat;
  d->n_heads = kind == kCategorical ? 1 : 2;
  d->head_w = kind == kCategorical ? act_dim * n_cat : act_dim;
  d->stride = d->n_heads * d->head_w + 1;
  const int xw = d_in > H ? d_in : H;
  d->ldx = (xw + 31) / 32 * 32 + 4;
  d->ldh = (H + 31) / 32 * 32 + 4;
  if (H >= kStagedMinWidth) return 1;
  return sizeof(float) * smem_floats(*d) <= kTwoBlocksSmem ? 2 : 1;
}

}  // namespace

// Floats of scratch that rl8_rnn_act needs for these shapes (0 on the
// 32-row tiles; the staged route's weight copies, heads' rows and sampling
// scratch), or -1 where no route takes them (which
// ops/fused_rnn_act.py:card_takes_rnn_act asks).
extern "C" long long rl8_rnn_act_scratch(int B, int d_in, int H, int K, int kind, int act_dim, int n_cat) {
  RnnActDims d;
  const int route = make_plan(B, d_in, H, K, kind, act_dim, n_cat, &d);
  if (route < 0) return -1;
  return route == 1 ? staged_layout(d, B).floats : 0;
}

// kind: 0 categorical (actions int32 [B, A]), 1 normal, 2 squashed (actions
// f32 [B, A]). h0, c0, h_out, c_out are [B, K * H]; params are laid out as
// ops/fused_rnn_act.py:RnnParams; scratch holds rl8_rnn_act_scratch floats
// (null where that is 0). make_plan picks the route.
extern "C" int rl8_rnn_act(const float* obs, const float* h0, const float* c0, const float* params,
                           void* actions, float* logp, float* values, float* h_out, float* c_out, float* scratch,
                           int B, int d_in, int H, int K, int kind, int act_dim, int n_cat, unsigned int seed,
                           unsigned int offset, int deterministic, int device, void* stream) {
  RnnActDims d;
  const int route = make_plan(B, d_in, H, K, kind, act_dim, n_cat, &d);
  if (route < 0 || (route == 1 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    return (int)launch_staged(d, kind, obs, h0, c0, params, actions, logp, values, h_out, c_out, scratch, B, seed,
                              offset, deterministic, s);
  }
  const size_t smem = sizeof(float) * smem_floats(d);
  const auto kernel = kind == kCategorical ? rnn_act_kernel<false> : rnn_act_kernel<true>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + kRows - 1) / kRows, kThreads, smem, s>>>(obs, h0, c0, params, actions, logp, values, h_out, c_out, B,
                                                        d, (int)(kind == kSquashed), seed, offset, deterministic);
  return (int)cudaGetLastError();
}

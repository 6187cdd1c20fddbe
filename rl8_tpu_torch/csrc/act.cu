// Act kernels: one rollout step of a default model, in one launch.
//
// The discrete act kernel (rl8_discrete_act: discrete_act_wgmma_kernel,
// discrete_act_tiles_kernel or discrete_act_kernel, by the routes below)
// replaces rl8_tpu/ops/fused_act.py:_discrete_act_kernel (the Pallas TPU
// kernel). For every row of obs [B, d_in] it computes:
//   - the twin-chain forward of DefaultDiscreteModel
//     (fused_mlp._forward_block): each chain is h = act(h @ W + b) per
//     hidden layer, then a linear head; the policy chain's head gives
//     logits [A * n], the value chain's head gives the value;
//   - a log-softmax per categorical group, z - (max + log(sum(exp(z - max))))
//     (distmath.log_softmax_rows, the one logp formula of the port);
//   - Gumbel-argmax sampling per group (argmax of the log-probs when
//     deterministic), one int32 action column per group;
//   - the chosen log-probs summed over groups in group order, and the value.
//
// The continuous one (rl8_continuous_act: continuous_act_tiles_kernel or
// continuous_act_kernel) replaces fused_act.py:_continuous_act_kernel for
// DefaultContinuousModel with Normal or SquashedNormal
// (distmath.sample_continuous_actions): the same twin-chain forward, whose
// policy chain has two heads (mean and pre-tanh log-std, A wide each), then
// per row and action dim log_std = tanh(head), a Box-Muller normal draw,
// a = mean + std * noise (mean when deterministic), a = tanh(a) when
// squashed, the log-prob (of the squashed action through the clipped atanh
// and the +-100 clamp when squashed; distmath.cuh), summed over dims in
// order, and the value.
//
// Bound on an H100 SXM: the forward is 2 * B * (d_in*H + H*H + H*(heads+1))
// FLOP for two hidden layers of width H, 2.15 GFLOP at B=8192, d_in=1,
// H=256 (2 logits, or a mean and a log-std of A = 1), against ~0.6 MB of
// parameters and I/O, so the products bound it: ~32 us at the CUDA cores'
// 67 TFLOP/s f32, ~13 us at three TF32 products per f32 product at the
// tensor cores' 495 TFLOP/s. The continuous epilogue adds ~20
// transcendentals per row and dim, under 1% of that.
//
// Each kernel has routes, picked by the launch's shapes:
// - discrete_act_wgmma_kernel (the discrete kernel wherever every input and
//   layer is at most 256 wide and the parameters are 16-byte aligned: the
//   main path's twin 256-wide torsos) runs the products on the tensor
//   cores through wgmma.cuh, in 3xTF32 at near-f32 accuracy. A block owns
//   64 rows (B=8192: 128 blocks, one wave on 132 SMs) and computes each
//   layer transposed, out^T = W^T x^T, so that the weights, packed [in,
//   out], are the A operand loaded straight from shared memory into
//   registers (wgmma takes TF32 B operands only K-major, and no transposed
//   copy of a weight is made), and the activations, split into TF32 big
//   and small halves, are the B operand in shared memory. Two consumer
//   warpgroups split a layer's 256 output features; a producer warp
//   streams the weights in 16-row slabs (four stages) by TMA bulk copies, a
//   row a lane, each starting at the 16-byte boundary at or before its row
//   (the value chain starts 8 bytes off alignment after the policy heads).
//   Blocks run in clusters of two that share the slabs: each block's
//   producer copies every other row, multicast to both blocks, so a slab is
//   read from L2 once per 128 rows (with every block reading all of them,
//   the copies held the products up: 0.0504 ms against 0.0454 on an H100,
//   kernel_variants.py's act_wg_no_multicast). Each output accumulates
//   its whole K in the tensor core's accumulator. The two chains run one
//   after the other: both chains' activations, big and small, would take
//   256 KB. The narrow heads run on the CUDA cores on the last layer's
//   outputs in registers, summed in a fixed order, so two launches are
//   bit-identical.
// - continuous_act_tiles_kernel and discrete_act_tiles_kernel (the tiled
//   f32 route: the continuous kernel wherever every layer is at most 256
//   wide, and the discrete one where the wgmma route does not take the
//   launch) run the products on the CUDA cores in f32, each output summed
//   in order of k; see act_tiles.
// - continuous_act_kernel and discrete_act_kernel (the streaming route:
//   layers wider than 256) follow the streaming design below.
//
// Streaming design. A block of 256 threads owns kRows=16 rows and keeps
// their activations in shared memory (two ping-pong buffers of [16, H]).
// The TPU kernel keeps every weight resident in VMEM; here a 256x256 f32
// weight (256 KB) is larger than a block's shared memory, so weights
// stream from L2 (the whole parameter set is ~0.53 MB of the 50 MB L2).
// Weights are packed [in, out] so that thread j reads column j: the 32
// threads of a warp read 32 consecutive floats, and each weight read feeds
// 16 FMAs (one per row) against shared-memory activations that the warp
// reads as 16-byte broadcasts. 16 rows rather than 32 or 8: at B=8192 it
// gives 512 blocks, enough resident warps to hide the L2 latency of the
// weight reads, while 8 rows doubles the weight reads (PERF.md has the
// measurements). Narrow heads (A*n logits, 1 value) are warp dot products
// with shuffle reductions, as the TPU kernel runs them as lane reductions.
// Everything is f32 end to end, so logp and values agree with the plain
// PyTorch version to f32 rounding. It re-reads both 256x256 weights from
// L2 for every 16 rows (~0.27 GB a launch at B=8192) and pays about one
// shared-memory load per FMA, at ~0.3 of the f32 peak (PERF.md).
//
// Tiled f32 design:
// - A block of 256 threads owns 64 rows (B=8192: 128 blocks, about one an
//   SM) and runs both chains on them. Both chains stay in one block, rather
//   than a block per chain over blockIdx.y: the epilogue needs the value
//   beside the policy heads, and at B=8192 128 blocks of 64 rows fill the
//   card as well as 256 half blocks would (one block an SM either way: ~170
//   KB of shared memory).
// - Weights stream through shared memory in slabs of 32 rows, two in flight
//   while a third is multiplied, each read from L2 once per 64 rows. A slab
//   whose rows are 16-byte aligned is a bulk copy (the TMA unit: one
//   instruction, an mbarrier); others are every thread's cp.async copies,
//   which share the load pipe with the products' shared-memory loads (all
//   cp.async: 0.0886 ms against 0.0829 on an H100). The biases and the
//   heads' weights are copied to shared memory with the first slab.
// - Each thread owns 8 rows x 8 columns of a layer (tile.cuh), so one
//   16-byte shared-memory load feeds ~10 FMAs, and each output still sums
//   in order of k in f32. A layer's output replaces its input in place.
// - The heads are summed from the last layer's outputs in registers: each
//   of a row's 32 lanes sums its 8 columns, then a butterfly (tile.cuh's
//   tile_heads).
//
// Sampling and its Philox random numbers are sample.cuh's, shared with
// rnn_act.cu.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "distmath.cuh"
#include "mlp.cuh"
#include "mma.cuh"
#include "sample.cuh"
#include "tile.cuh"
#include "wgmma.cuh"

namespace {

using rl8::dense_layer;
using rl8::kRows;
using rl8::narrow_head;

constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;

struct ActDims {
  int d_in;
  int n_layers;
  int act;  // 0: relu, 1: tanh
  int max_hidden;
  int hidden[kMaxLayers];
  int n_heads;  // heads of the policy chain: 1 (logits) or 2 (mean, log-std)
  int head_w;   // width of each: A * n logits, or A
};

// Shared memory of a block: xs [kRows, d_in], two ping-pong activation
// buffers [kRows, max_hidden], and the heads [kRows, n_heads * head_w + 1]
// (the policy heads, then the value).
__device__ __forceinline__ int head_stride(const ActDims& d) { return d.n_heads * d.head_w + 1; }

// Loads the block's rows of obs and runs both chains' forward: chain 0 is
// the policy torso and its heads, chain 1 the value torso and value head;
// params hold each layer's W [in, out] then b [out]. Returns the heads.
__device__ float* twin_forward(const float* __restrict__ obs, const float* __restrict__ params,
                               int r0, int nr, const ActDims& d, float* smem) {
  float* xs = smem;
  float* h0 = xs + kRows * d.d_in;
  float* h1 = h0 + kRows * d.max_hidden;
  float* heads = h1 + kRows * d.max_hidden;
  const int stride = head_stride(d);
  for (int i = threadIdx.x; i < kRows * d.d_in; i += blockDim.x) {
    xs[i] = (i / d.d_in) < nr ? obs[(size_t)r0 * d.d_in + i] : 0.0f;
  }
  __syncthreads();
  const float* p = params;
  for (int chain = 0; chain < 2; ++chain) {
    const float* cur = xs;
    int cur_w = d.d_in;
    for (int l = 0; l < d.n_layers; ++l) {
      const int out_w = d.hidden[l];
      float* dst = (l & 1) ? h1 : h0;
      dense_layer<kRows>(cur, cur_w, p, p + cur_w * out_w, dst, out_w, d.act);
      p += cur_w * out_w + out_w;
      __syncthreads();
      cur = dst;
      cur_w = out_w;
    }
    const int n_heads = chain == 0 ? d.n_heads : 1;
    const int n_out = chain == 0 ? d.head_w : 1;
    for (int j = 0; j < n_heads; ++j) {
      narrow_head<kRows>(cur, cur_w, p, p + cur_w * n_out, n_out, heads, stride,
                         chain == 0 ? j * n_out : stride - 1);
      p += cur_w * n_out + n_out;
    }
    __syncthreads();
  }
  return heads;
}

__global__ void __launch_bounds__(kThreads)
    discrete_act_kernel(const float* __restrict__ obs, const float* __restrict__ params,
                        int* __restrict__ actions, float* __restrict__ logp,
                        float* __restrict__ values, int B, ActDims d, int n_cat, uint32_t seed,
                        uint32_t offset, int deterministic) {
  extern __shared__ float smem[];
  const int A = d.head_w / n_cat;
  const int stride = head_stride(d);
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, B - r0);
  const float* heads = twin_forward(obs, params, r0, nr, d, smem);
  float* chosen = smem + kRows * (d.d_in + 2 * d.max_hidden + stride);  // [kRows, A]
  rl8::categorical_epilogue(heads, stride, r0, nr, A, n_cat, seed, offset, deterministic, actions, logp,
                            values, chosen);
}

__global__ void __launch_bounds__(kThreads)
    continuous_act_kernel(const float* __restrict__ obs, const float* __restrict__ params,
                          float* __restrict__ actions, float* __restrict__ logp,
                          float* __restrict__ values, int B, ActDims d, int squashed,
                          uint32_t seed, uint32_t offset, int deterministic) {
  extern __shared__ float smem[];
  const int A = d.head_w;
  const int stride = head_stride(d);
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, B - r0);
  const float* heads = twin_forward(obs, params, r0, nr, d, smem);
  // [kRows, 2A]: each dim's (clamped, when squashed) base log-prob, then
  // its tanh log-det term.
  float* parts = smem + kRows * (d.d_in + 2 * d.max_hidden + stride);
  rl8::continuous_epilogue(heads, stride, r0, nr, A, squashed, seed, offset, deterministic, actions, logp,
                           values, parts);
}

// ---------------------------------------------------------- tiled route

// The tiled f32 route: rows and threads per block, each
// thread's rows (tile.cuh's RT) and the threads of a row group (CG): one
// pass covers a layer up to kTileWidth wide. Weights stream through shared
// memory in slabs of kSlabK rows, kStages - 1 in flight.
constexpr int kTileRows = 64;
constexpr int kTileRT = 8;
constexpr int kTileCG = 32;
constexpr int kTileThreads = kTileRows / kTileRT * kTileCG;
constexpr int kTileWidth = 8 * kTileCG;
constexpr int kSlabK = 32;
constexpr int kSlabFloats = kSlabK * kTileWidth;
constexpr int kStages = 3;  // slabs a block holds: kStages - 1 in flight
constexpr int kMaxSmem = 232448;  // shared memory a block may use on an H100
constexpr int kMaxQ = 2 * kMaxLayers;  // layers over both chains

// A tiled launch: layer q = chain * n_layers + l reads in_w[q] x out_w[q]
// weights at woff[q] of the flat parameters (its bias follows them), in
// slabs first_slab[q] .. first_slab[q + 1] - 1; head j of chain c is at
// hoff[c][j]. Shared memory: obs' tile [R, ldx], the activations [R, ldh]
// (each layer's output replaces its input), kStages weight slabs, the heads
// [R, head_stride] and the epilogue's [R, 2A].
struct TilePlan {
  int ldx, ldh, n_q;
  int first_slab[kMaxQ + 1];
  int in_w[kMaxQ], out_w[kMaxQ];
  long long woff[kMaxQ];
  long long hoff[2][2];
  // The biases and the heads' W and b, copied to shared memory from sp with
  // the first slab: layer q's bias at sbias[q], head j of chain c at
  // shead[c][j] (its b after its W).
  int sp;
  // Whether layer q's weight rows start 16-byte aligned, so that its slabs
  // are bulk copies (the TMA unit, one instruction a slab or row; per-thread
  // cp.async copies share the load pipe with the products' shared-memory
  // loads: with cp.async alone ~0.019 ms of them showed, kernel_variants.py's
  // act_no_slab_loads); cp.async otherwise.
  int bulk[kMaxQ];
  int sbias[kMaxQ], shead[2][2];
  size_t smem;
};

// The tiled plan of a launch, or false where its widest layer
// is wider than one pass or its tiles do not fit a block's shared memory
// (those launches take the streaming route).
bool make_plan(const ActDims& d, TilePlan* P) {
  if (d.max_hidden > kTileWidth || d.n_heads > 2) return false;
  P->ldx = rl8::tile_ld(d.d_in);
  P->ldh = rl8::tile_ld(d.max_hidden);
  P->n_q = 2 * d.n_layers;
  long long off = 0;
  int slabs = 0;
  for (int c = 0; c < 2; ++c) {
    int in = d.d_in;
    for (int l = 0; l < d.n_layers; ++l) {
      const int q = c * d.n_layers + l, w = d.hidden[l];
      P->in_w[q] = in;
      P->out_w[q] = w;
      P->woff[q] = off;
      P->first_slab[q] = slabs;
      slabs += (in + kSlabK - 1) / kSlabK;
      off += (long long)in * w + w;
      in = w;
    }
    const int n_heads = c == 0 ? d.n_heads : 1, n_out = c == 0 ? d.head_w : 1;
    for (int j = 0; j < n_heads; ++j) {
      P->hoff[c][j] = off;
      off += (long long)in * n_out + n_out;
    }
  }
  P->first_slab[P->n_q] = slabs;
  for (int q = 0; q < P->n_q; ++q) P->bulk[q] = P->out_w[q] % 4 == 0 && P->woff[q] % 4 == 0;
  const int stride = d.n_heads * d.head_w + 1;
  P->sp = kTileRows * (P->ldx + P->ldh + stride + 2 * d.head_w) + kStages * kSlabFloats;
  int small = 0;
  for (int q = 0; q < P->n_q; ++q) {
    P->sbias[q] = P->sp + small;
    small += P->out_w[q];
  }
  for (int c = 0; c < 2; ++c) {
    const int n_heads = c == 0 ? d.n_heads : 1, n_out = c == 0 ? d.head_w : 1;
    for (int j = 0; j < n_heads; ++j) {
      P->shead[c][j] = P->sp + small;
      small += d.hidden[d.n_layers - 1] * n_out + n_out;
    }
  }
  P->smem = sizeof(float) * ((size_t)P->sp + small);
  return P->smem <= (size_t)kMaxSmem;
}

// Issues the copies of slab g (rows k0 .. k0 + kSlabK of layer q's W [in,
// out], fewer at the end) to dst, rows kTileWidth apart, and commits a
// cp.async group (empty past the last slab and for bulk copies, so that
// every thread counts one group a slab). A layer whose rows are 16-byte
// aligned takes bulk copies by one thread, reported to bar (one for the
// slab where its rows are kTileWidth wide, else one a row); the others
// every thread's cp.async copies, 16, 8 or 4 bytes as the rows' alignment
// allows, 64 threads a row. Returns whether the slab's copies are bulk.
__device__ __forceinline__ bool issue_slab(const float* __restrict__ params, const TilePlan& P, int g, float* dst,
                                           uint64_t* bar) {
  bool bulk = false;
  if (g < P.first_slab[P.n_q]) {
    int q = 0;
    while (P.first_slab[q + 1] <= g) ++q;
    const int k0 = (g - P.first_slab[q]) * kSlabK, w = P.out_w[q];
    const int rows = min(kSlabK, P.in_w[q] - k0);
    const float* src = params + P.woff[q] + (size_t)k0 * w;
    bulk = P.bulk[q];
    if (bulk) {
      if (threadIdx.x == 0) {
        const uint32_t bytes = (uint32_t)(w * sizeof(float));
        rl8::async_proxy_fence();
        rl8::mbar_expect(bar, rows * bytes);
        if (w == kTileWidth) {
          rl8::bulk_copy(dst, src, rows * bytes, bar);
        } else {
          for (int r = 0; r < rows; ++r) rl8::bulk_copy(dst + r * kTileWidth, src + r * w, bytes, bar);
        }
      }
    } else {
      const int lane64 = threadIdx.x % 64, step = blockDim.x / 64;
      const uintptr_t align = reinterpret_cast<uintptr_t>(src) | (uintptr_t)(w * sizeof(float));
      if ((align & 15) == 0) {
        for (int r = threadIdx.x / 64; r < rows; r += step) {
          for (int c = 4 * lane64; c < w; c += 256) rl8::cp_async16(dst + r * kTileWidth + c, src + r * w + c, 16);
        }
      } else if ((align & 7) == 0) {
        for (int r = threadIdx.x / 64; r < rows; r += step) {
          for (int c = 2 * lane64; c < w; c += 128) rl8::cp_async8(dst + r * kTileWidth + c, src + r * w + c);
        }
      } else {
        for (int r = threadIdx.x / 64; r < rows; r += step) {
          for (int c = lane64; c < w; c += 64) rl8::cp_async4(dst + r * kTileWidth + c, src + r * w + c, 4);
        }
      }
    }
  }
  rl8::cp_async_commit();
  return bulk;
}

// The act kernels' tiled route: a block of 256 threads owns 64 rows and
// runs both chains on them. Every layer is tile.cuh's product, each thread
// owning 8 rows x 8 columns, over the weight slabs in order, with the next
// kStages - 1 slabs in flight (bulk copies or cp.async) across layer and
// chain boundaries. A layer's output replaces its input in place once every
// thread's product is done (the sums live in registers); a chain's last
// layer goes straight into its heads (tile.cuh's tile_heads, a row's 32
// lanes each summing its 8 columns, then a butterfly). Then the kind's
// epilogue with the rows' true index, as the streaming kernels call it:
// rl8::continuous_epilogue (CATEGORICAL false; `arg` is squashed) or
// rl8::categorical_epilogue (`arg` is n_cat, actions are int32).
template <int ACT, bool CATEGORICAL>
__device__ __forceinline__ void act_tiles(const float* __restrict__ obs, const float* __restrict__ params,
                                          void* __restrict__ actions, float* __restrict__ logp,
                                          float* __restrict__ values, int B, const ActDims& d, const TilePlan& P,
                                          int arg, uint32_t seed, uint32_t offset, int deterministic) {
  constexpr int R = kTileRows, RT = kTileRT, CG = kTileCG;
  extern __shared__ __align__(16) float smem[];
  const int A = CATEGORICAL ? d.head_w / arg : d.head_w, stride = head_stride(d), ldx = P.ldx, ldh = P.ldh;
  float* xs = smem;
  float* h = xs + R * ldx;
  float* slabs = h + R * ldh;
  float* heads = slabs + kStages * kSlabFloats;
  float* parts = heads + R * stride;
  const int r0 = blockIdx.x * R;
  const int nr = min(R, B - r0);
  const int n_slabs = P.first_slab[P.n_q];
  // Bulk copies: slab g reports to bars[g % kStages]; bit s of phases is the
  // parity of stage s's next phase, and bit s of bulk whether the slab in
  // stage s is bulk.
  __shared__ uint64_t bars[kStages];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) rl8::mbar_init(&bars[s]);
    rl8::mbar_init_fence();
  }
  __syncthreads();
  uint32_t phases = 0, bulk = 0;
  // The biases and the heads' parameters, with the first slab's group.
  for (int q = 0; q < P.n_q; ++q) {
    for (int i = threadIdx.x; i < P.out_w[q]; i += blockDim.x) {
      rl8::cp_async4(smem + P.sbias[q] + i, params + P.woff[q] + (size_t)P.in_w[q] * P.out_w[q] + i, 4);
    }
  }
  for (int c = 0; c < 2; ++c) {
    const int n_heads = c == 0 ? d.n_heads : 1, n_out = c == 0 ? d.head_w : 1;
    const int n = (d.hidden[d.n_layers - 1] + 1) * n_out;
    for (int j = 0; j < n_heads; ++j) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) rl8::cp_async4(smem + P.shead[c][j] + i, params + P.hoff[c][j] + i, 4);
    }
  }
  for (int s = 0; s < kStages - 1; ++s) {
    if (issue_slab(params, P, s, slabs + s * kSlabFloats, &bars[s])) bulk |= 1u << s;
  }
  for (int i = threadIdx.x; i < R * d.d_in; i += blockDim.x) {
    const int r = i / d.d_in;
    xs[r * ldx + i % d.d_in] = r < nr ? obs[(size_t)r0 * d.d_in + i] : 0.0f;
  }
  const int rg = threadIdx.x / CG, c0 = 4 * (threadIdx.x % CG), c1 = c0 + 4 * CG;
  float acc[RT][8];
  rl8::tile_zero(acc);
  for (int g = 0; g < n_slabs; ++g) {
    const int gs = g + kStages - 1;
    const int st = g % kStages, next = gs % kStages;
    if (issue_slab(params, P, gs, slabs + next * kSlabFloats, &bars[next])) {
      bulk |= 1u << next;
    } else {
      bulk &= ~(1u << next);
    }
    rl8::cp_async_wait<kStages - 1>();
    if (bulk & (1u << st)) {
      rl8::mbar_wait(&bars[st], (phases >> st) & 1);
      phases ^= 1u << st;
    }
    __syncthreads();  // slab g has landed for every thread (and obs' tile)
    int q = 0;
    while (P.first_slab[q + 1] <= g) ++q;
    const int l = q % d.n_layers, k0 = (g - P.first_slab[q]) * kSlabK;
    const float* in = l == 0 ? xs : h;
    const int ld = l == 0 ? ldx : ldh;
    rl8::tile_fma<RT>(acc, in + rg * RT * ld + k0, ld, slabs + st * kSlabFloats, kTileWidth,
                      min(kSlabK, P.in_w[q] - k0), c0, c1);
    __syncthreads();  // slab g may be overwritten, and the layer's input
    if (g + 1 < P.first_slab[q + 1]) continue;
    // The layer's last slab: its output, in place of its input, or, after a
    // chain's last layer, straight into the chain's heads (tile.cuh's
    // tile_heads, on the outputs in registers): the policy chain's (mean,
    // pre-tanh log-std) from column 0, the value chain's value in column
    // stride - 1.
    const int w = P.out_w[q], c = q / d.n_layers;
    const float* bias = smem + P.sbias[q];
    int n[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      n[j] = j < 4 ? c0 + j : c1 + j - 4;
      const float b = n[j] < w ? bias[n[j]] : 0.0f;
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r][j] = rl8::activate(acc[r][j] + b, ACT);
    }
    if (l == d.n_layers - 1) {
      const int n_heads = c == 0 ? d.n_heads : 1, n_out = c == 0 ? d.head_w : 1;
      for (int j = 0; j < n_heads; ++j) {
        const float* W = smem + P.shead[c][j];
        float* col = heads + rg * RT * stride + (c == 0 ? j * n_out : stride - 1);
        rl8::tile_heads<RT, CG>(acc, n, w, W, n_out, W + (size_t)w * n_out, n_out,
                                [&](int r, int o, float v) { col[r * stride + o] = v; });
      }
    } else {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (n[j] < w) h[(rg * RT + r) * ldh + n[j]] = acc[r][j];
        }
      }
    }
    rl8::tile_zero(acc);
    __syncthreads();
  }
  if constexpr (CATEGORICAL) {
    rl8::categorical_epilogue(heads, stride, r0, nr, A, arg, seed, offset, deterministic,
                              static_cast<int*>(actions), logp, values, parts);
  } else {
    rl8::continuous_epilogue(heads, stride, r0, nr, A, arg, seed, offset, deterministic,
                             static_cast<float*>(actions), logp, values, parts);
  }
}

template <int ACT>
__global__ void __launch_bounds__(kTileThreads, 1)
    continuous_act_tiles_kernel(const float* __restrict__ obs, const float* __restrict__ params,
                                float* __restrict__ actions, float* __restrict__ logp,
                                float* __restrict__ values, int B, ActDims d, const __grid_constant__ TilePlan P,
                                int squashed, uint32_t seed, uint32_t offset, int deterministic) {
  act_tiles<ACT, false>(obs, params, actions, logp, values, B, d, P, squashed, seed, offset, deterministic);
}

template <int ACT>
__global__ void __launch_bounds__(kTileThreads, 1)
    discrete_act_tiles_kernel(const float* __restrict__ obs, const float* __restrict__ params,
                              int* __restrict__ actions, float* __restrict__ logp, float* __restrict__ values,
                              int B, ActDims d, const __grid_constant__ TilePlan P, int n_cat, uint32_t seed,
                              uint32_t offset, int deterministic) {
  act_tiles<ACT, true>(obs, params, actions, logp, values, B, d, P, n_cat, seed, offset, deterministic);
}

// ---------------------------------------------------------- wgmma route

// The discrete kernel's wgmma route: a block owns kWgRows rows (the
// products' N) and runs both chains on them, one after the other, with two
// consumer warpgroups that split each layer's output features (128 each,
// two m64 tiles) and a producer warp that streams the weights. Weights are
// read in slabs of kWgSlabK rows of W [in, out], kWgStages slabs in flight.
constexpr int kWgRows = 64;
constexpr int kWgConsumers = 256;
constexpr int kWgThreads = kWgConsumers + 32;  // and a producer warp
constexpr int kWgWidth = 256;  // widest layer input and output
constexpr int kWgSlabK = 16;
constexpr int kWgSteps = kWgSlabK / 8;  // k steps a slab
constexpr int kWgLdw = kWgWidth + 8;  // a slab row's stride: A fragment loads hit 32 banks
constexpr int kWgStages = 4;
constexpr int kWgMaxLogits = 64;
constexpr int kWgSlabFloats = kWgSlabK * kWgLdw;

// A wgmma launch: layer q = chain * n_layers + l reads in_w[q] x out_w[q]
// weights at woff[q] of the flat parameters (its bias follows them), in
// slabs first_slab[q] .. first_slab[q + 1] - 1; chain c's head (the logits,
// the value) is at hoff[c]. Shared memory, in floats: the activations'
// big and small TF32 halves, each [kWgWidth / 4][kWgRows][4] (wgmma.cuh's
// bt_offset), which the heads' partial sums overlay; kWgStages slabs; the
// heads [kWgRows, stride] at `heads`; the epilogue's [kWgRows, A]; the
// heads' parameters at head_w.
struct WgPlan {
  int n_q, stride, heads;
  // Chain c's head, W and b (head_n[c] floats from hoff[c]), copied to
  // shared memory at head_w[c].
  int head_w[2], head_n[2];
  int first_slab[kMaxQ + 1];
  int in_w[kMaxQ], out_w[kMaxQ];
  long long woff[kMaxQ];
  long long hoff[2];
  size_t smem;
};

// The wgmma plan of a discrete launch, or false where an input or a layer
// is wider than kWgWidth, the logits are more than kWgMaxLogits or the tiles
// do not fit a block's shared memory.
bool make_wgmma_plan(const ActDims& d, int A, WgPlan* P) {
  // The heads' partials, [8 warps][kWgRows][head_w], go over the B operand.
  if (d.n_heads != 1 || d.d_in > kWgWidth || d.max_hidden > kWgWidth || d.head_w > kWgMaxLogits) return false;
  P->n_q = 2 * d.n_layers;
  long long off = 0;
  int slabs = 0;
  for (int c = 0; c < 2; ++c) {
    int in = d.d_in;
    for (int l = 0; l < d.n_layers; ++l) {
      const int q = c * d.n_layers + l, w = d.hidden[l];
      P->in_w[q] = in;
      P->out_w[q] = w;
      P->woff[q] = off;
      P->first_slab[q] = slabs;
      slabs += (in + kWgSlabK - 1) / kWgSlabK;
      off += (long long)in * w + w;
      in = w;
    }
    const int n_out = c == 0 ? d.head_w : 1;
    P->hoff[c] = off;
    off += (long long)in * n_out + n_out;
  }
  P->first_slab[P->n_q] = slabs;
  P->stride = d.head_w + 1;
  P->heads = 2 * kWgRows * kWgWidth + kWgStages * kWgSlabFloats;
  P->head_n[0] = (d.hidden[d.n_layers - 1] + 1) * d.head_w;
  P->head_n[1] = d.hidden[d.n_layers - 1] + 1;
  P->head_w[0] = P->heads + kWgRows * (P->stride + A);
  P->head_w[1] = P->head_w[0] + P->head_n[0];
  P->smem = sizeof(float) * ((size_t)P->head_w[1] + P->head_n[1]);
  // The mbarriers' static shared memory comes on top.
  return P->smem + 256 <= (size_t)kMaxSmem;
}

// Bytes of the bulk copy of a W row of w floats that starts `shift` floats
// past a 16-byte boundary: the copy starts at the boundary and reads whole
// 16-byte units (at most 3 floats past the row, which the flat layout's
// bias and heads always follow).
__device__ __forceinline__ uint32_t wg_row_bytes(int shift, int w) { return (uint32_t)(((shift + w) * 4 + 15) & ~15); }

// Issues slab g's copies (rows k0 .. of its layer's W) to stage g %
// kWgStages of both blocks of the cluster: one bulk copy a row, a lane a
// row, this block's producer the rows of its rank's parity, each multicast
// to both blocks; each block's full mbarrier expects the whole slab.
// Called by the producer warp.
__device__ __forceinline__ void wg_issue_slab(const float* __restrict__ params, const WgPlan& P, int g, float* slabs,
                                              uint64_t* full, uint32_t rank) {
  static_assert(kWgSlabK <= 32, "a slab's rows are one warp's copies");
  const int lane = threadIdx.x % 32, st = g % kWgStages;
  int q = 0;
  while (P.first_slab[q + 1] <= g) ++q;
  const int k0 = (g - P.first_slab[q]) * kWgSlabK, w = P.out_w[q];
  const long long e = P.woff[q] + (long long)(k0 + lane) * w;  // this lane's row
  const int shift = (int)(e & 3);
  const uint32_t bytes = lane < P.in_w[q] - k0 && lane < kWgSlabK ? wg_row_bytes(shift, w) : 0u;
  const uint32_t total = __reduce_add_sync(0xffffffffu, bytes);
  if (lane == 0) {
    rl8::async_proxy_fence();
    rl8::mbar_expect(&full[st], total);
  }
  __syncwarp();
  if (bytes && (uint32_t)(lane & 1) == rank) {
    rl8::bulk_copy_multicast(slabs + st * kWgSlabFloats + lane * kWgLdw, params + (e - shift), bytes, &full[st], 0x3);
  }
}

// Rows of obs [B, d_in] into the B operand's big and small halves, k up to
// d_in rounded up to a slab (zeros past d_in and past the block's nr rows:
// the first layer's products read every k step of its slabs).
__device__ __forceinline__ void wg_load_obs(const float* __restrict__ obs, int r0, int nr, int d_in, float* xb,
                                            float* xs) {
  const int kp = (d_in + kWgSlabK - 1) / kWgSlabK * kWgSlabK;
  for (int i = threadIdx.x; i < kWgRows * kp; i += kWgConsumers) {
    const int n = i / kp, k = i % kp;
    uint32_t big, small;
    rl8::split_tf32(n < nr && k < d_in ? obs[(size_t)(r0 + n) * d_in + k] : 0.0f, big, small);
    xb[rl8::bt_offset(n, k, kWgRows)] = __uint_as_float(big);
    xs[rl8::bt_offset(n, k, kWgRows)] = __uint_as_float(small);
  }
}

// The discrete act kernel's wgmma route (see the file's head). The producer
// warp (threads 256 ..) issues its half of every slab's bulk copies: slab g
// goes to stage g % kWgStages of both blocks of the cluster once the 16
// consumer warps of both have released the slab before it there (empty: a
// warp releases a slab when its fragments are in registers, arriving on
// both blocks' barriers), and each block's full expects the whole slab.
// Both blocks take the same slabs in the same order. (The first consumer
// warp issuing the copies instead left the other warpgroup waiting on its
// slabs, and was slower on an H100; the 9th warp caps a thread at 168
// registers, 3 warps sharing one of the SM's 4 schedulers.) Each consumer
// warpgroup computes its 128 features of a layer, out^T = W^T x^T: per
// slab, per k step of 8, each thread loads its A fragments of W^T (two m64
// tiles) from the slab and splits them, and the warpgroup issues three
// wgmmas a tile (wgmma_3xtf32) on the B operand's halves; a commit group a
// k step, at most kWgSteps in flight, so that a k step's A registers are
// free again when the next slab reuses them. A layer's accumulators hold
// its whole K. At a layer's end both warpgroups wait for their products
// and meet; the output (bias, activation) is split into the B operand's
// halves in place, or, after a chain's last layer, summed into the chain's
// head from the registers in a fixed order. Then rl8::categorical_epilogue,
// with the producer warp.
template <int ACT>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kWgThreads, 1)
    discrete_act_wgmma_kernel(const float* __restrict__ obs, const float* __restrict__ params,
                              int* __restrict__ actions, float* __restrict__ logp, float* __restrict__ values,
                              int B, ActDims d, const __grid_constant__ WgPlan P, int n_cat, uint32_t seed,
                              uint32_t offset, int deterministic) {
  extern __shared__ __align__(16) float smem[];
  float* xb = smem;
  float* xs = smem + kWgRows * kWgWidth;
  float* slabs = smem + 2 * kWgRows * kWgWidth;
  float* heads = smem + P.heads;
  float* chosen = heads + kWgRows * P.stride;
  __shared__ uint64_t full[kWgStages], empty[kWgStages];
  const int r0 = blockIdx.x * kWgRows;
  const int nr = min(kWgRows, B - r0);
  const int n_slabs = P.first_slab[P.n_q];
  const uint32_t rank = rl8::cluster_rank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      rl8::mbar_init_count(&full[s], 1);
      rl8::mbar_init_count(&empty[s], 2 * kWgConsumers / 32);  // both blocks' consumer warps
    }
    rl8::mbar_init_fence();
  }
  rl8::cluster_sync();  // both blocks' mbarriers are ready
  if (threadIdx.x >= kWgConsumers) {
    // The producer warp: slab g once every consumer warp of both blocks has
    // released the slab before it in its stage.
    for (int g = 0; g < n_slabs; ++g) {
      if (g >= kWgStages) rl8::mbar_wait(&empty[g % kWgStages], (g / kWgStages - 1) & 1);
      wg_issue_slab(params, P, g, slabs, full, rank);
    }
  } else {
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g8 = lane / 4, t4 = lane % 4;
    float acc[2][32];
    uint32_t a_big[kWgSteps][2][4], a_small[kWgSteps][2][4];
    for (int c = 0; c < 2; ++c) {
      for (int i = threadIdx.x; i < P.head_n[c]; i += kWgConsumers) smem[P.head_w[c] + i] = __ldg(params + P.hoff[c] + i);
    }
    wg_load_obs(obs, r0, nr, d.d_in, xb, xs);
    rl8::async_proxy_fence();
    rl8::named_bar_sync(1, kWgConsumers);
    int g = 0;
    for (int c = 0; c < 2; ++c) {
      for (int l = 0; l < d.n_layers; ++l) {
        const int q = c * d.n_layers + l, in = P.in_w[q], w = P.out_w[q];
        const int first = g;
        // The layer's biases of this thread's features, loaded while the
        // products run.
        float bias[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int f = 128 * wg + 64 * mt + 16 * warp + g8 + 8 * half;
            bias[mt][half] = f < w ? __ldg(params + P.woff[q] + (size_t)in * w + f) : 0.0f;
          }
        for (; g < P.first_slab[q + 1]; ++g) {
          const int st = g % kWgStages;
          const int k0 = (g - P.first_slab[q]) * kWgSlabK;
          const long long base = P.woff[q] + (long long)k0 * w;
          const float* slab = slabs + st * kWgSlabFloats;
          rl8::mbar_wait(&full[st], (g / kWgStages) & 1);
#pragma unroll
          for (int ks = 0; ks < kWgSteps; ++ks) {
            rl8::wgmma_wait<kWgSteps - 1>();  // the group that last read a_*[ks] is done
            // This thread's slab rows: k = 8 ks + t4 and + 4, each starting
            // `shift` floats into its row (the copy's 16-byte start).
            float v[2][4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int kk = 8 * ks + t4 + 4 * h;
              const float* row = slab + kk * kWgLdw + (int)((base + (long long)kk * w) & 3);
              const bool live = k0 + kk < in;
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                const int m = 128 * wg + 64 * mt + 16 * warp + g8;
                v[mt][2 * h] = live && m < w ? row[m] : 0.0f;
                v[mt][2 * h + 1] = live && m + 8 < w ? row[m + 8] : 0.0f;
              }
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
              rl8::split_tf32(v[mt][0], a_big[ks][mt][0], a_small[ks][mt][0]);
              rl8::split_tf32(v[mt][1], a_big[ks][mt][1], a_small[ks][mt][1]);
              rl8::split_tf32(v[mt][2], a_big[ks][mt][2], a_small[ks][mt][2]);
              rl8::split_tf32(v[mt][3], a_big[ks][mt][3], a_small[ks][mt][3]);
            }
            // Every k step and tile, also past the layer's K and width: the
            // A fragments are 0 there and the B operand finite (0 past the
            // widths), so the products add nothing, and no wgmma sits in a
            // branch (ptxas serializes every wgmma of a kernel that has one).
            const int step = k0 / 8 + ks;
            const uint64_t db = rl8::wgmma_desc(xb + 8 * step * kWgRows, 16 * kWgRows, 128);
            const uint64_t ds = rl8::wgmma_desc(xs + 8 * step * kWgRows, 16 * kWgRows, 128);
            rl8::wgmma_fence();
            const int add = g > first || ks > 0;  // the layer's first k step starts the sums
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) rl8::wgmma_3xtf32(acc[mt], a_big[ks][mt], a_small[ks][mt], db, ds, add);
            rl8::wgmma_commit();
          }
          __syncwarp();
          if (lane == 0) {  // this warp is done reading the slab: in both blocks' counts
            rl8::mbar_arrive(&empty[st]);
            rl8::mbar_arrive_cluster(&empty[st], rank ^ 1u);
          }
        }
        rl8::wgmma_wait<0>();
        rl8::named_bar_sync(1, kWgConsumers);  // every product has read the layer's input
        // The layer's output of accumulator element i of tile mt: act(sum +
        // b), 0 past the layer's width. (Computed where it is used: an
        // instruction writing the accumulators makes ptxas serialize every
        // wgmma.)
        auto output = [&](int mt, int i) {
          const int f = 128 * wg + 64 * mt + 16 * warp + g8 + 8 * ((i >> 1) & 1);
          return f < w ? rl8::activate(acc[mt][i] + bias[mt][(i >> 1) & 1], ACT) : 0.0f;
        };
        if (l + 1 < d.n_layers) {
          // The next layer's B operand, split.
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int f = 128 * wg + 64 * mt + 16 * warp + g8 + 8 * ((i >> 1) & 1);
              const int n = 8 * (i >> 2) + 2 * t4 + (i & 1);
              uint32_t big, small;
              rl8::split_tf32(output(mt, i), big, small);
              xb[rl8::bt_offset(n, f, kWgRows)] = __uint_as_float(big);
              xs[rl8::bt_offset(n, f, kWgRows)] = __uint_as_float(small);
            }
        } else {
          // The chain's head (the logits from column 0, or the value in
          // column stride - 1), on the outputs in registers: each thread
          // sums its 4 features of each of its 16 rows in order, an xor
          // butterfly adds the warp's 8 lanes that share the rows, and the 8
          // warps' partials (over the B operand, [8][kWgRows][n_out]) are
          // added in order: a fixed order, so launches are bit-identical.
          const int n_out = c == 0 ? d.head_w : 1, col = c == 0 ? 0 : P.stride - 1;
          const float* W = smem + P.head_w[c];
          float* part = smem;
          for (int o = 0; o < n_out; ++o) {
            float wf[2][2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int f = 128 * wg + 64 * mt + 16 * warp + g8 + 8 * half;
                wf[mt][half] = f < w ? W[f * n_out + o] : 0.0f;
              }
            // This thread's rows 8 j + 2 t4 + e, j in 4 jh .. 4 jh + 3.
#pragma unroll
            for (int jh = 0; jh < 2; ++jh) {
              float p[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) p[i] = 0.0f;
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int half = 0; half < 2; ++half)
#pragma unroll
                  for (int i = 0; i < 8; ++i)
                    p[i] = fmaf(output(mt, 4 * (4 * jh + (i >> 1)) + 2 * half + (i & 1)), wf[mt][half], p[i]);
#pragma unroll
              for (int off = 16; off >= 4; off >>= 1)
#pragma unroll
                for (int i = 0; i < 8; ++i) p[i] += __shfl_xor_sync(0xffffffffu, p[i], off);
              if (g8 == 0) {
#pragma unroll
                for (int i = 0; i < 8; ++i)
                  part[((threadIdx.x / 32) * kWgRows + 8 * (4 * jh + (i >> 1)) + 2 * t4 + (i & 1)) * n_out + o] = p[i];
              }
            }
          }
          rl8::named_bar_sync(1, kWgConsumers);
          for (int i = threadIdx.x; i < kWgRows * n_out; i += kWgConsumers) {
            float y = part[i];
            for (int v = 1; v < kWgConsumers / 32; ++v) y += part[v * kWgRows * n_out + i];
            heads[(i / n_out) * P.stride + col + i % n_out] = y + W[w * n_out + i % n_out];
          }
          rl8::named_bar_sync(1, kWgConsumers);
          if (c == 0) wg_load_obs(obs, r0, nr, d.d_in, xb, xs);
        }
        rl8::async_proxy_fence();  // the B operand's writes, before the next products read them
        rl8::named_bar_sync(1, kWgConsumers);
      }
    }
  }
  __syncthreads();
  rl8::categorical_epilogue(heads, P.stride, r0, nr, d.head_w / n_cat, n_cat, seed, offset, deterministic, actions,
                            logp, values, chosen);
  rl8::cluster_sync();  // the other block's last arrivals on this block's mbarriers have landed
}

// The dims of a launch, or false if the kernels do not take them.
bool make_dims(int B, int d_in, int n_layers, const int* hidden, int act, int n_heads, int head_w,
               ActDims* d) {
  if (B <= 0 || d_in <= 0 || n_layers < 1 || n_layers > kMaxLayers || head_w <= 0 ||
      (act != 0 && act != 1)) {
    return false;
  }
  d->d_in = d_in;
  d->n_layers = n_layers;
  d->act = act;
  d->n_heads = n_heads;
  d->head_w = head_w;
  d->max_hidden = 0;
  for (int l = 0; l < kMaxLayers; ++l) {
    d->hidden[l] = l < n_layers ? hidden[l] : 0;
    if (l < n_layers && d->hidden[l] <= 0) return false;
    if (d->hidden[l] > d->max_hidden) d->max_hidden = d->hidden[l];
  }
  return true;
}

// Floats of shared memory: xs, two activation buffers, the heads and
// `extra` floats per row.
size_t smem_bytes(const ActDims& d, int extra) {
  return sizeof(float) * (size_t)kRows *
         (d.d_in + 2 * d.max_hidden + d.n_heads * d.head_w + 1 + extra);
}

}  // namespace

extern "C" int rl8_discrete_act(const float* obs, const float* params, int* actions, float* logp,
                                float* values, int B, int d_in, int n_layers, const int* hidden,
                                int n_logits, int n_cat, int act, unsigned int seed,
                                unsigned int offset, int deterministic, int device,
                                void* stream) {
  ActDims d;
  if (n_cat <= 0 || n_logits % n_cat != 0 ||
      !make_dims(B, d_in, n_layers, hidden, act, 1, n_logits, &d)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int A = n_logits / n_cat;
  WgPlan W;
  if ((reinterpret_cast<uintptr_t>(params) & 15) == 0 && make_wgmma_plan(d, A, &W)) {
    auto kernel = act == rl8::kRelu ? discrete_act_wgmma_kernel<rl8::kRelu> : discrete_act_wgmma_kernel<rl8::kTanh>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W.smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    // An even grid: blocks run in clusters of two (a last block past B
    // only streams its half of the weights).
    kernel<<<(B + 2 * kWgRows - 1) / (2 * kWgRows) * 2, kWgThreads, W.smem, (cudaStream_t)stream>>>(
        obs, params, actions, logp, values, B, d, W, n_cat, seed, offset, deterministic);
    return (int)cudaGetLastError();
  }
  // Inputs wider than the wgmma route's 256, or parameters off 16-byte
  // alignment (its bulk copies start at 16-byte boundaries): the tiled f32
  // route, where every layer is at most 256 wide.
  TilePlan P;
  if (make_plan(d, &P)) {
    if ((reinterpret_cast<uintptr_t>(params) & 15) != 0) {
      for (int q = 0; q < P.n_q; ++q) P.bulk[q] = 0;
    }
    auto kernel = act == rl8::kRelu ? discrete_act_tiles_kernel<rl8::kRelu> : discrete_act_tiles_kernel<rl8::kTanh>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(B + kTileRows - 1) / kTileRows, kTileThreads, P.smem, (cudaStream_t)stream>>>(
        obs, params, actions, logp, values, B, d, P, n_cat, seed, offset, deterministic);
    return (int)cudaGetLastError();
  }
  // Layers wider than 256.
  const size_t smem = smem_bytes(d, A);
  err = cudaFuncSetAttribute(discrete_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kRows - 1) / kRows;
  discrete_act_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      obs, params, actions, logp, values, B, d, n_cat, seed, offset, deterministic);
  return (int)cudaGetLastError();
}

extern "C" int rl8_continuous_act(const float* obs, const float* params, float* actions,
                                  float* logp, float* values, int B, int d_in, int n_layers,
                                  const int* hidden, int action_dim, int act, int squashed,
                                  unsigned int seed, unsigned int offset, int deterministic,
                                  int device, void* stream) {
  ActDims d;
  if (!make_dims(B, d_in, n_layers, hidden, act, 2, action_dim, &d)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  TilePlan P;
  if (make_plan(d, &P)) {
    if ((reinterpret_cast<uintptr_t>(params) & 15) != 0) {
      for (int q = 0; q < P.n_q; ++q) P.bulk[q] = 0;
    }
    // The activation is a template argument: chosen at run time, every
    // activation also paid for tanhf's instructions.
    auto kernel = act == rl8::kRelu ? continuous_act_tiles_kernel<rl8::kRelu> : continuous_act_tiles_kernel<rl8::kTanh>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(B + kTileRows - 1) / kTileRows, kTileThreads, P.smem, (cudaStream_t)stream>>>(
        obs, params, actions, logp, values, B, d, P, squashed, seed, offset, deterministic);
    return (int)cudaGetLastError();
  }
  // Layers wider than one pass of the tiled route.
  const size_t smem = smem_bytes(d, 2 * action_dim);
  err = cudaFuncSetAttribute(continuous_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kRows - 1) / kRows;
  continuous_act_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      obs, params, actions, logp, values, B, d, squashed, seed, offset, deterministic);
  return (int)cudaGetLastError();
}

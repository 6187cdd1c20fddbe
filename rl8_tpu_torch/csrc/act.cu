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
// - act_layer_tc_kernel (discrete) or act_layer_kernel (continuous), and
//   act_heads_kernel<_> (the staged route: layers wider than 256, and
//   inputs or heads too wide for the tiled route) follow the staged design
//   below.
//
// Staged design. A launch is one kernel a layer over both chains, then one
// for the heads and the sampling, on stage.cuh's parts:
//   - copies of every layer's W in the stages' layout, zero-padded to whole
//     slabs: for the discrete kind TF32 big and small halves, K-major
//     (tile_tc_kernel), for the continuous kinds f32 (tile_fwd_kernel),
//     into the scratch the wrapper allocates (rl8_act_scratch);
//   - per layer, act_layer_tc_kernel (discrete) or act_layer_kernel
//     (continuous) over a grid of (column tiles, 128-row tiles, the two
//     chains): a block streams its rows of the layer's input (the
//     observations, or the previous layer's activations in the scratch's
//     ping-pong buffers) and its column tile's 32-deep weight slabs through
//     a 3-stage cp.async ring in shared memory; the discrete kind sums on
//     the tensor cores in 3xTF32 wgmma (tc_product, 128 columns a block, a
//     fresh accumulator every 32 k folded into an f32 sum), the continuous
//     kinds in f32 on the CUDA cores, each output in order of k
//     (fwd_product, 256 columns a block, 8 rows by 16 columns a thread, one
//     16-byte shared-memory load for 16 FMAs), since their squashed
//     log-probs are sensitive near +-1; each weight slab feeds all 128
//     rows; then the bias and the activation (relu keeps a NaN) into the
//     other buffer;
//   - act_heads_kernel over blocks of 8 rows: each chain's heads on its
//     last layer's activations (st_heads: narrow_head's sums) into the
//     scratch, then the kind's sample.cuh epilogue.
// Shared memory is the ring's, whatever the widths, inputs and heads; the
// activations make a round trip through device memory between layers
// (~0.27 GB a launch at 1024 wide x 8,192 rows, ~0.08 ms at 3.35 TB/s),
// under the products' 34 GFLOP there (0.51 ms at 67 TFLOP/s f32, 0.21 at
// 3xTF32 on 495). One block to an SM (the ring, and fwd_product's 128
// accumulators a thread). It replaces the streaming route (16 rows a
// block, every weight re-read from L2 for every 16 rows, one shared-memory
// load per FMA; past ~1,800 wide the rows in a device-memory scratch
// re-read through L1 at every k). On an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md, one A/B) the discrete launch at 1024 x 8,192 took 0.67 ms (f32
// layers, an ablation since removed, 1.14; the streaming route 2.40-2.43;
// the plain version 3.6-3.8) and at 2388 x 4,096 1.66-1.67 (f32 3.23,
// streaming 18.02-18.05, plain 3.5-4.3). The TPU kernel keeps every weight resident in VMEM; here one
// 1024 x 1024 f32 weight (4 MB) is larger than a block's shared memory, so
// weights stream from L2 in slabs.
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
// Depth. A model may have any number of layers. The wgmma and the tiled
// routes run every layer in one launch, so they read each layer's shapes,
// offsets and slabs from a table in the scratch (WgLayer, TileLayer;
// table.cuh), which the launch writes before the kernel, walking it with a
// cursor as the slabs come: no table of fixed size in a kernel's
// parameters covers every depth. The wgmma route's shared memory does not
// grow with depth, so a deep discrete model up to 256 wide keeps it (16
// layers of 256: the same block of 64 rows, twice the slabs of 8 layers).
// The wgmma route's tensor cores round each output's running sum toward
// zero at every k step, so it takes chains of at most kWgMaxSteps k steps
// (32 layers of 256); deeper discrete models up to 256 wide take the tiled
// f32 route. The tiled route reads a layer's biases from the parameters
// where its outputs are made, so its shared memory does not grow with
// depth either. The staged route launches a layer at a time from the host
// and takes any depth; its heads kernel gets only the heads' offsets.
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
#include "stage.cuh"
#include "table.cuh"
#include "tile.cuh"
#include "wgmma.cuh"

namespace {

// A launch's shapes; the widths of its layers (any number) stay on the
// host, and the kernels read what they need of them from their plans'
// tables in device memory (table.cuh).
struct ActDims {
  int d_in;
  int n_layers;
  int act;  // 0: relu, 1: tanh
  int max_hidden;
  int last;     // the last hidden layer's width
  int n_heads;  // heads of the policy chain: 1 (logits) or 2 (mean, log-std)
  int head_w;   // width of each: A * n logits, or A
};

__host__ __device__ inline int head_stride(const ActDims& d) { return d.n_heads * d.head_w + 1; }

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

// Layer q = chain * n_layers + l of a tiled launch, entry q of its table:
// in_w x out_w weights at woff of the flat parameters (its bias follows
// them), in slabs first_slab .. end_slab - 1; bulk: whether its weight rows
// start 16-byte aligned, so
// that its slabs are bulk copies (the TMA unit, one instruction a slab or
// row; per-thread cp.async copies share the load pipe with the products'
// shared-memory loads: with cp.async alone ~0.019 ms of them showed,
// kernel_variants.py's act_no_slab_loads); cp.async otherwise.
struct TileLayer {
  long long woff;
  int first_slab, end_slab, in_w, out_w, bulk, pad;
};

// A tiled launch: its n_q layers in the table tab (device memory), head j
// of chain c at hoff[c][j]. Shared memory: obs' tile [R, ldx], the
// activations [R, ldh] (each layer's output replaces its input), kStages
// weight slabs, the heads [R, head_stride] and the epilogue's [R, 2A]; then
// from sp the heads' W and b, copied with the first slab (head j of chain c
// at shead[c][j], its b after its W). None of it grows with depth: a
// layer's biases are read from the parameters (L1) where its outputs are
// made, 8 a thread.
struct TilePlan {
  int ldx, ldh, n_q, n_slabs;
  long long hoff[2][2];
  int sp;
  int shead[2][2];
  size_t smem;
  const TileLayer* tab;
};

// The tiled plan of a launch (and its table, *tab), or false where its
// widest layer is wider than one pass or its tiles do not fit a block's
// shared memory (those launches take the staged route).
bool make_plan(const ActDims& d, const int* hidden, TilePlan* P, std::vector<TileLayer>* tab) {
  if (d.max_hidden > kTileWidth || d.n_heads > 2) return false;
  P->ldx = rl8::tile_ld(d.d_in);
  P->ldh = rl8::tile_ld(d.max_hidden);
  P->n_q = 2 * d.n_layers;
  tab->assign((size_t)P->n_q, TileLayer{});
  long long off = 0;
  int slabs = 0;
  for (int c = 0; c < 2; ++c) {
    int in = d.d_in;
    for (int l = 0; l < d.n_layers; ++l) {
      TileLayer& e = (*tab)[c * d.n_layers + l];
      const int w = hidden[l];
      e.in_w = in;
      e.out_w = w;
      e.woff = off;
      e.first_slab = slabs;
      slabs += (in + kSlabK - 1) / kSlabK;
      e.end_slab = slabs;
      e.bulk = w % 4 == 0 && off % 4 == 0;
      off += (long long)in * w + w;
      in = w;
    }
    const int n_heads = c == 0 ? d.n_heads : 1, n_out = c == 0 ? d.head_w : 1;
    for (int j = 0; j < n_heads; ++j) {
      P->hoff[c][j] = off;
      off += (long long)in * n_out + n_out;
    }
  }
  P->n_slabs = slabs;
  const int stride = d.n_heads * d.head_w + 1;
  P->sp = kTileRows * (P->ldx + P->ldh + stride + 2 * d.head_w) + kStages * kSlabFloats;
  long long small = 0;
  for (int c = 0; c < 2; ++c) {
    const int n_heads = c == 0 ? d.n_heads : 1, n_out = c == 0 ? d.head_w : 1;
    for (int j = 0; j < n_heads; ++j) {
      P->shead[c][j] = (int)(P->sp + small);
      small += (long long)d.last * n_out + n_out;
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
// allows, 64 threads a row. q is the caller's cursor over the layers (g
// only grows from call to call). Returns whether the slab's copies are
// bulk.
__device__ __forceinline__ bool issue_slab(const float* __restrict__ params, const TilePlan& P, int g, float* dst,
                                           uint64_t* bar, int& q) {
  bool bulk = false;
  if (g < P.n_slabs) {
    while (P.tab[q].end_slab <= g) ++q;
    const TileLayer e = P.tab[q];
    const int k0 = (g - e.first_slab) * kSlabK, w = e.out_w;
    const int rows = min(kSlabK, e.in_w - k0);
    const float* src = params + e.woff + (size_t)k0 * w;
    bulk = e.bulk;
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
// epilogue with the rows' true index, as the staged heads kernel calls it:
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
  const int n_slabs = P.n_slabs;
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
  // The heads' parameters, with the first slab's group.
  for (int c = 0; c < 2; ++c) {
    const int n_heads = c == 0 ? d.n_heads : 1, n_out = c == 0 ? d.head_w : 1;
    const int n = (d.last + 1) * n_out;
    for (int j = 0; j < n_heads; ++j) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) rl8::cp_async4(smem + P.shead[c][j] + i, params + P.hoff[c][j] + i, 4);
    }
  }
  int q_issue = 0, q = 0;  // the layers of the next slab to issue and of slab g
  for (int s = 0; s < kStages - 1; ++s) {
    if (issue_slab(params, P, s, slabs + s * kSlabFloats, &bars[s], q_issue)) bulk |= 1u << s;
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
    if (issue_slab(params, P, gs, slabs + next * kSlabFloats, &bars[next], q_issue)) {
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
    while (P.tab[q].end_slab <= g) ++q;
    const TileLayer e = P.tab[q];
    const int l = q % d.n_layers, k0 = (g - e.first_slab) * kSlabK;
    const float* in = l == 0 ? xs : h;
    const int ld = l == 0 ? ldx : ldh;
    rl8::tile_fma<RT>(acc, in + rg * RT * ld + k0, ld, slabs + st * kSlabFloats, kTileWidth,
                      min(kSlabK, e.in_w - k0), c0, c1);
    __syncthreads();  // slab g may be overwritten, and the layer's input
    if (g + 1 < e.end_slab) continue;
    // The layer's last slab: its output, in place of its input, or, after a
    // chain's last layer, straight into the chain's heads (tile.cuh's
    // tile_heads, on the outputs in registers): the policy chain's (mean,
    // pre-tanh log-std) from column 0, the value chain's value in column
    // stride - 1.
    const int w = e.out_w, c = q / d.n_layers;
    const float* bias = params + e.woff + (size_t)e.in_w * w;
    int n[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      n[j] = j < 4 ? c0 + j : c1 + j - 4;
      const float b = n[j] < w ? __ldg(bias + n[j]) : 0.0f;
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
// The most k steps of 8 down a chain (every layer's input, in slabs): each
// output keeps its whole K in the tensor core's accumulator, which rounds
// toward zero at every k step, and a relu torso carries that shrinkage
// down the chain. At 32 layers of 256 (994 steps) the values and log-probs
// stay within 1e-4 of the f32 forward's, at 87 (2,754) they do not (on an
// H100, chip_smoke.py's deep_sweep), so deeper chains take the tiled f32
// route, which any depth fits.
constexpr int kWgMaxSteps = 1024;
constexpr int kWgSlabFloats = kWgSlabK * kWgLdw;

// Layer q = chain * n_layers + l of a wgmma launch, entry q of its table:
// in_w x out_w weights at woff of the flat parameters (its bias follows
// them), in slabs first_slab .. end_slab - 1.
struct WgLayer {
  long long woff;
  int first_slab, end_slab, in_w, out_w;
};

// A wgmma launch: its n_q layers in the table tab (device memory); chain
// c's head (the logits, the value) is at hoff[c]. Shared memory, in floats:
// the activations' big and small TF32 halves, each [kWgWidth / 4][kWgRows]
// [4] (wgmma.cuh's bt_offset), which the heads' partial sums overlay;
// kWgStages slabs; the heads [kWgRows, stride] at `heads`; the epilogue's
// [kWgRows, A]; the heads' parameters at head_w. None of it grows with
// depth.
struct WgPlan {
  int n_q, n_slabs, stride, heads;
  // Chain c's head, W and b (head_n[c] floats from hoff[c]), copied to
  // shared memory at head_w[c].
  int head_w[2], head_n[2];
  long long hoff[2];
  size_t smem;
  const WgLayer* tab;
};

// The wgmma plan of a discrete launch (and its table, *tab), or false where
// an input or a layer is wider than kWgWidth, the logits are more than
// kWgMaxLogits, a chain takes more than kWgMaxSteps k steps or the tiles do
// not fit a block's shared memory.
bool make_wgmma_plan(const ActDims& d, const int* hidden, int A, WgPlan* P, std::vector<WgLayer>* tab) {
  // The heads' partials, [8 warps][kWgRows][head_w], go over the B operand.
  if (d.n_heads != 1 || d.d_in > kWgWidth || d.max_hidden > kWgWidth || d.head_w > kWgMaxLogits) return false;
  P->n_q = 2 * d.n_layers;
  tab->assign((size_t)P->n_q, WgLayer{});
  long long off = 0;
  int slabs = 0;
  for (int c = 0; c < 2; ++c) {
    int in = d.d_in;
    for (int l = 0; l < d.n_layers; ++l) {
      WgLayer& e = (*tab)[c * d.n_layers + l];
      const int w = hidden[l];
      e.in_w = in;
      e.out_w = w;
      e.woff = off;
      e.first_slab = slabs;
      slabs += (in + kWgSlabK - 1) / kWgSlabK;
      e.end_slab = slabs;
      off += (long long)in * w + w;
      in = w;
    }
    const int n_out = c == 0 ? d.head_w : 1;
    P->hoff[c] = off;
    off += (long long)in * n_out + n_out;
    if (c == 0 && (long long)slabs * kWgSteps > kWgMaxSteps) return false;
  }
  P->n_slabs = slabs;
  P->stride = d.head_w + 1;
  P->heads = 2 * kWgRows * kWgWidth + kWgStages * kWgSlabFloats;
  P->head_n[0] = (d.last + 1) * d.head_w;
  P->head_n[1] = d.last + 1;
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
// Called by the producer warp; q is its cursor over the layers (g only
// grows from call to call).
__device__ __forceinline__ void wg_issue_slab(const float* __restrict__ params, const WgPlan& P, int g, float* slabs,
                                              uint64_t* full, uint32_t rank, int& q) {
  static_assert(kWgSlabK <= 32, "a slab's rows are one warp's copies");
  const int lane = threadIdx.x % 32, st = g % kWgStages;
  while (P.tab[q].end_slab <= g) ++q;
  const WgLayer L = P.tab[q];
  const int k0 = (g - L.first_slab) * kWgSlabK, w = L.out_w;
  const long long e = L.woff + (long long)(k0 + lane) * w;  // this lane's row
  const int shift = (int)(e & 3);
  const uint32_t bytes = lane < L.in_w - k0 && lane < kWgSlabK ? wg_row_bytes(shift, w) : 0u;
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
  const int n_slabs = P.n_slabs;
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
    int q = 0;
    for (int g = 0; g < n_slabs; ++g) {
      if (g >= kWgStages) rl8::mbar_wait(&empty[g % kWgStages], (g / kWgStages - 1) & 1);
      wg_issue_slab(params, P, g, slabs, full, rank, q);
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
        const WgLayer L = P.tab[c * d.n_layers + l];
        const int in = L.in_w, w = L.out_w;
        const int first = g;
        // The layer's biases of this thread's features, loaded while the
        // products run.
        float bias[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int f = 128 * wg + 64 * mt + 16 * warp + g8 + 8 * half;
            bias[mt][half] = f < w ? __ldg(params + L.woff + (size_t)in * w + f) : 0.0f;
          }
        for (; g < L.end_slab; ++g) {
          const int st = g % kWgStages;
          const int k0 = (g - L.first_slab) * kWgSlabK;
          const long long base = L.woff + (long long)k0 * w;
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

// The dims of a launch, or false if the kernels do not take them (any
// number of layers).
bool make_dims(int B, int d_in, int n_layers, const int* hidden, int act, int n_heads, int head_w,
               ActDims* d) {
  if (B <= 0 || d_in <= 0 || n_layers < 1 || head_w <= 0 || (act != 0 && act != 1)) return false;
  d->d_in = d_in;
  d->n_layers = n_layers;
  d->act = act;
  d->n_heads = n_heads;
  d->head_w = head_w;
  d->max_hidden = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (hidden[l] <= 0) return false;
    if (hidden[l] > d->max_hidden) d->max_hidden = hidden[l];
  }
  d->last = hidden[n_layers - 1];
  return true;
}

// ---------------------------------------------------------- staged route

// Rows a block of the staged route's heads kernel.
constexpr int kHeadRows = 8;

// A staged launch's scratch (floats from its start) and the parameters'
// places: layer q = chain * n_layers + l is in_w[q] x out_w[q] at woff[q]
// of the flat parameters (its bias after it) and its copy at copy[q]
// (categorical: tc_product's big and small halves, one after the other;
// else fwd_product's layout); head j of chain c at hoff[c][j]; the
// activations of layer l of chain c at act + ((l % 2) * 2 + c) * B ld; the
// heads' rows and the epilogue's scratch of every kHeadRows rows at heads.
// The plan lives on the host (a launch a layer); the heads kernel gets only
// the heads' offsets.
struct HeadOffsets {
  long long hoff[2][2];
};

struct StagedPlan {
  bool categorical;  // the discrete kind (one policy head): its layers in 3xTF32 wgmma
  int n_q, ld;       // ld: an activation row's stride, the widest layer
  std::vector<int> in_w, out_w;
  std::vector<long long> woff, copy;
  HeadOffsets heads_at;
  long long act, heads, floats;
};

// The continuous kinds' layers stay f32 (fwd_product): their squashed
// log-probs are sensitive near +-1.
StagedPlan staged_plan(const ActDims& d, const int* hidden, int extra, int B) {
  StagedPlan P;
  P.categorical = d.n_heads == 1;
  P.n_q = 2 * d.n_layers;
  P.ld = d.max_hidden;
  P.in_w.resize(P.n_q);
  P.out_w.resize(P.n_q);
  P.woff.resize(P.n_q);
  P.copy.resize(P.n_q);
  long long off = 0, copies = 0;
  for (int c = 0; c < 2; ++c) {
    int in = d.d_in;
    for (int l = 0; l < d.n_layers; ++l) {
      const int q = c * d.n_layers + l, w = hidden[l];
      P.in_w[q] = in;
      P.out_w[q] = w;
      P.woff[q] = off;
      P.copy[q] = copies;
      off += (long long)in * w + w;
      copies += P.categorical ? 2 * rl8::bwd_copy_floats(in, w) : rl8::fwd_copy_floats(in, w);
      in = w;
    }
    const int n_heads = c == 0 ? d.n_heads : 1, n_out = c == 0 ? d.head_w : 1;
    for (int j = 0; j < n_heads; ++j) {
      P.heads_at.hoff[c][j] = off;
      off += (long long)in * n_out + n_out;
    }
  }
  P.act = copies;
  P.heads = P.act + (long long)(d.n_layers > 1 ? 4 : 2) * B * P.ld;
  P.floats = P.heads + (long long)(B + kHeadRows - 1) / kHeadRows * kHeadRows * (head_stride(d) + extra);
  return P;
}

// One layer of both chains (blockIdx.z is the chain): its weight copies,
// biases, inputs (rows ld_in apart, in_w wide: the observations or the
// previous layer's activations) and outputs (rows ld_out apart).
struct LayerArgs {
  const float* w[2];
  const float* b[2];
  const float* in[2];
  float* out[2];
  long long ld_in, ld_out;
  int in_w, out_w;
};

// The staged route's layer in f32 (the continuous kinds): blockIdx.x is the column tile (columns 256 x ..
// 256 x + 255), blockIdx.y the first 128-row tile, which steps by
// gridDim.y, blockIdx.z the chain; out = act(in W + b), each output summed
// in order of k from 0 in f32 (fwd_product), then the bias.
__global__ void __launch_bounds__(rl8::kStThreads, 1) act_layer_kernel(LayerArgs a, int B, int act) {
  constexpr int R = rl8::kStRows;
  extern __shared__ __align__(128) float st_smem[];
  const int c = blockIdx.z;
  const int n0 = blockIdx.x * rl8::kStFwdPass;
  const int N = min(rl8::kStFwdPass, a.out_w - n0);
  const long long stages = (a.in_w + rl8::kStK - 1) / rl8::kStK;
  const float* w = a.w[c] + blockIdx.x * stages * rl8::kStFwdWFloats;
  const float* b = a.b[c];
  float* out = a.out[c];
  const long long tiles = (B + R - 1) / R;
  for (long long t = blockIdx.y; t < tiles; t += gridDim.y) {
    const long long r0 = t * R;
    const int nr = (int)min((long long)R, B - r0);
    const float* in = a.in[c] + r0 * a.ld_in;
    const rl8::FwdSeg seg = {{in, a.ld_in, a.in_w, nr, rl8::st_vec(in, a.ld_in)}, w};
    rl8::fwd_product(
        &seg, 1, N, st_smem,
        [&](auto& acc, const int(&)[8]) {
#pragma unroll
          for (int i = 0; i < R / 16; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
        },
        [&](auto& acc, int rg, const int(&n)[8]) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = n0 + n[j];
            if (col >= a.out_w) continue;
            const float bj = __ldg(b + col);
#pragma unroll
            for (int i = 0; i < R / 16; ++i) {
              const int r = rg + 16 * i;
              if (r < nr) out[(r0 + r) * a.ld_out + col] = rl8::activate(acc[i][j] + bj, act);
            }
          }
        });
  }
}

// act_layer_kernel with its products in 3xTF32 wgmma (the discrete kind):
// blockIdx.x is a tile of 128 columns (tc_product), the big halves of the
// copies at a.w, the small ones bwd_copy_floats further; each output's sum
// in 32-deep chunks, then the bias and the activation.
__global__ void __launch_bounds__(rl8::kStThreads, 1) act_layer_tc_kernel(LayerArgs a, int B, int act) {
  constexpr int R = rl8::kStRows;
  extern __shared__ __align__(128) float st_smem[];
  const int c = blockIdx.z;
  const long long stages = (a.in_w + rl8::kStK - 1) / rl8::kStK;
  const long long half = rl8::round_up(a.in_w, rl8::kStK) * rl8::round_up(a.out_w, rl8::kStPass);
  const float* big = a.w[c] + blockIdx.x * stages * rl8::kStWFloats;
  const float* b = a.b[c];
  float* out = a.out[c];
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, g = (threadIdx.x % 32) / 4, tq = threadIdx.x % 4;
  const long long tiles = (B + R - 1) / R;
  for (long long t = blockIdx.y; t < tiles; t += gridDim.y) {
    const long long r0 = t * R;
    const int nr = (int)min((long long)R, B - r0);
    const float* in = a.in[c] + r0 * a.ld_in;
    const rl8::TcSeg seg = {{in, a.ld_in, a.in_w, nr, rl8::st_vec(in, a.ld_in)}, big, big + half};
    rl8::tc_product(&seg, 1, st_smem, [&](const float(&sum)[2][32]) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
          const int col = rl8::kStPass * blockIdx.x + 64 * h + 8 * (i >> 2) + 2 * tq + (i & 1);
          if (r < nr && col < a.out_w) out[(r0 + r) * a.ld_out + col] = rl8::activate(sum[h][i] + __ldg(b + col), act);
        }
    });
  }
}

// The staged route's heads and sampling over blocks of kHeadRows rows: each
// chain's heads on its last layer's activations (top[c], rows ld apart,
// in_w wide; st_heads: narrow_head's sums) into the block's rows of the
// scratch (the policy heads side by side, the value last), then the kind's
// epilogue: rl8::continuous_epilogue (CATEGORICAL false; `arg` is
// squashed) or rl8::categorical_epilogue (`arg` is n_cat, actions int32).
template <bool CATEGORICAL>
__global__ void __launch_bounds__(rl8::kStThreads)
    act_heads_kernel(const float* __restrict__ top0, const float* __restrict__ top1, long long ld, int in_w,
                     const float* __restrict__ params, HeadOffsets P, float* __restrict__ rows,
                     void* __restrict__ actions, float* __restrict__ logp, float* __restrict__ values, int B,
                     ActDims d, int arg, uint32_t seed, uint32_t offset, int deterministic) {
  const int A = CATEGORICAL ? d.head_w / arg : d.head_w, stride = head_stride(d);
  const int r0 = blockIdx.x * kHeadRows;
  const int nr = min(kHeadRows, B - r0);
  float* heads = rows + (long long)blockIdx.x * kHeadRows * (stride + (CATEGORICAL ? A : 2 * A));
  float* parts = heads + kHeadRows * stride;  // the epilogue's [kHeadRows, A] or [kHeadRows, 2A]
  for (int c = 0; c < 2; ++c) {
    const float* top = (c == 0 ? top0 : top1) + (long long)r0 * ld;
    const int n_heads = c == 0 ? d.n_heads : 1, n_out = c == 0 ? d.head_w : 1;
    for (int j = 0; j < n_heads; ++j) {
      const float* W = params + P.hoff[c][j];
      rl8::st_heads(top, ld, in_w, W, W + (size_t)in_w * n_out, n_out, heads, stride,
                    c == 0 ? j * n_out : stride - 1, nr);
    }
  }
  __syncthreads();
  if constexpr (CATEGORICAL) {
    rl8::categorical_epilogue(heads, stride, r0, nr, A, arg, seed, offset, deterministic,
                              static_cast<int*>(actions), logp, values, parts);
  } else {
    rl8::continuous_epilogue(heads, stride, r0, nr, A, arg, seed, offset, deterministic,
                             static_cast<float*>(actions), logp, values, parts);
  }
}

// The staged route's launches (see the file's head) on `scratch`
// (staged_plan's floats; `extra` floats of epilogue scratch a row: A, or
// 2A for the continuous kinds; `arg` is n_cat, or squashed).
int launch_staged(const float* obs, const float* params, void* actions, float* logp, float* values,
                  float* scratch, int B, const ActDims& d, const int* hidden, int extra, int arg, uint32_t seed,
                  uint32_t offset, int deterministic, cudaStream_t s) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const StagedPlan P = staged_plan(d, hidden, extra, B);
  for (int q = 0; q < P.n_q; ++q) {
    const float* w = params + P.woff[q];
    float* dst = scratch + P.copy[q];
    if (P.categorical) {
      const long long half = rl8::bwd_copy_floats(P.in_w[q], P.out_w[q]);
      rl8::tile_tc_kernel<<<rl8::st_copy_grid(half), rl8::kStThreads, 0, s>>>(w, P.out_w[q], P.in_w[q],
                                                                               P.out_w[q], 0, dst, dst + half);
    } else {
      rl8::tile_fwd_kernel<<<rl8::st_copy_grid(rl8::fwd_copy_floats(P.in_w[q], P.out_w[q])), rl8::kStThreads, 0,
                             s>>>(w, P.out_w[q], P.in_w[q], P.out_w[q], 0, dst);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err =
      P.categorical
          ? cudaFuncSetAttribute(act_layer_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)rl8::kStBwdSmem)
          : cudaFuncSetAttribute(act_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rl8::kStFwdSmem);
  if (err != cudaSuccess) return (int)err;
  float* act = scratch + P.act;
  auto buffer = [&](int l, int c) { return act + ((long long)(l % 2) * 2 + c) * B * P.ld; };
  for (int l = 0; l < d.n_layers; ++l) {
    LayerArgs a;
    for (int c = 0; c < 2; ++c) {
      const int q = c * d.n_layers + l;
      a.w[c] = scratch + P.copy[q];
      a.b[c] = params + P.woff[q] + (long long)P.in_w[q] * P.out_w[q];
      a.in[c] = l == 0 ? obs : buffer(l - 1, c);
      a.out[c] = buffer(l, c);
    }
    a.ld_in = l == 0 ? d.d_in : P.ld;
    a.ld_out = P.ld;
    a.in_w = l == 0 ? d.d_in : hidden[l - 1];
    a.out_w = hidden[l];
    const int cols = P.categorical ? rl8::kStPass : rl8::kStFwdPass;  // columns a block
    const dim3 grid((a.out_w + cols - 1) / cols, rl8::st_row_grid(B), 2);
    if (P.categorical) {
      act_layer_tc_kernel<<<grid, rl8::kStThreads, rl8::kStBwdSmem, s>>>(a, B, d.act);
    } else {
      act_layer_kernel<<<grid, rl8::kStThreads, rl8::kStFwdSmem, s>>>(a, B, d.act);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int L = d.n_layers - 1;
  const auto heads = P.categorical ? act_heads_kernel<true> : act_heads_kernel<false>;
  heads<<<(B + kHeadRows - 1) / kHeadRows, rl8::kStThreads, 0, s>>>(
      buffer(L, 0), buffer(L, 1), P.ld, hidden[L], params, P.heads_at, scratch + P.heads, actions, logp, values, B, d, arg,
      seed, offset, deterministic);
  return (int)cudaGetLastError();
}

// Floats of scratch that a launch of B rows needs: the wgmma or the tiled
// route's table (for the discrete kind, `aligned`: whether its parameters
// are 16-byte aligned, which the wgmma route needs), else the staged
// route's copies, activations and heads.
long long scratch_floats(const ActDims& d, const int* hidden, int extra, int A, bool aligned, int B) {
  WgPlan W;
  TilePlan P;
  std::vector<WgLayer> wt;
  std::vector<TileLayer> tt;
  if (d.n_heads == 1 && aligned && make_wgmma_plan(d, hidden, A, &W, &wt)) {
    return rl8::table_floats<WgLayer>((long long)wt.size());
  }
  if (make_plan(d, hidden, &P, &tt)) return rl8::table_floats<TileLayer>((long long)tt.size());
  return staged_plan(d, hidden, extra, B).floats;
}

}  // namespace

// scratch: rl8_act_scratch floats.
extern "C" int rl8_discrete_act(const float* obs, const float* params, int* actions, float* logp,
                                float* values, float* scratch, int B, int d_in, int n_layers, const int* hidden,
                                int n_logits, int n_cat, int act, unsigned int seed,
                                unsigned int offset, int deterministic, int device,
                                void* stream) {
  ActDims d;
  if (n_cat <= 0 || n_logits % n_cat != 0 ||
      !make_dims(B, d_in, n_layers, hidden, act, 1, n_logits, &d) || scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int A = n_logits / n_cat;
  WgPlan W;
  std::vector<WgLayer> wt;
  if ((reinterpret_cast<uintptr_t>(params) & 15) == 0 && make_wgmma_plan(d, hidden, A, &W, &wt)) {
    if ((err = rl8::upload_table(wt, scratch, s)) != cudaSuccess) return (int)err;
    W.tab = reinterpret_cast<const WgLayer*>(scratch);
    auto kernel = act == rl8::kRelu ? discrete_act_wgmma_kernel<rl8::kRelu> : discrete_act_wgmma_kernel<rl8::kTanh>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W.smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    // An even grid: blocks run in clusters of two (a last block past B
    // only streams its half of the weights).
    kernel<<<(B + 2 * kWgRows - 1) / (2 * kWgRows) * 2, kWgThreads, W.smem, s>>>(
        obs, params, actions, logp, values, B, d, W, n_cat, seed, offset, deterministic);
    return (int)cudaGetLastError();
  }
  // Inputs wider than the wgmma route's 256, or parameters off 16-byte
  // alignment (its bulk copies start at 16-byte boundaries): the tiled f32
  // route, where every layer is at most 256 wide.
  TilePlan P;
  std::vector<TileLayer> tt;
  if (make_plan(d, hidden, &P, &tt)) {
    if ((reinterpret_cast<uintptr_t>(params) & 15) != 0) {
      for (TileLayer& e : tt) e.bulk = 0;
    }
    if ((err = rl8::upload_table(tt, scratch, s)) != cudaSuccess) return (int)err;
    P.tab = reinterpret_cast<const TileLayer*>(scratch);
    auto kernel = act == rl8::kRelu ? discrete_act_tiles_kernel<rl8::kRelu> : discrete_act_tiles_kernel<rl8::kTanh>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(B + kTileRows - 1) / kTileRows, kTileThreads, P.smem, s>>>(
        obs, params, actions, logp, values, B, d, P, n_cat, seed, offset, deterministic);
    return (int)cudaGetLastError();
  }
  // Layers wider than 256, and heads or inputs too wide for the tiled route
  // (or, at depth, biases too many for its shared memory).
  return launch_staged(obs, params, actions, logp, values, scratch, B, d, hidden, A, n_cat, seed, offset,
                       deterministic, s);
}

extern "C" int rl8_continuous_act(const float* obs, const float* params, float* actions,
                                  float* logp, float* values, float* scratch, int B, int d_in, int n_layers,
                                  const int* hidden, int action_dim, int act, int squashed,
                                  unsigned int seed, unsigned int offset, int deterministic,
                                  int device, void* stream) {
  ActDims d;
  if (!make_dims(B, d_in, n_layers, hidden, act, 2, action_dim, &d) || scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  TilePlan P;
  std::vector<TileLayer> tt;
  if (make_plan(d, hidden, &P, &tt)) {
    if ((reinterpret_cast<uintptr_t>(params) & 15) != 0) {
      for (TileLayer& e : tt) e.bulk = 0;
    }
    if ((err = rl8::upload_table(tt, scratch, s)) != cudaSuccess) return (int)err;
    P.tab = reinterpret_cast<const TileLayer*>(scratch);
    // The activation is a template argument: chosen at run time, every
    // activation also paid for tanhf's instructions.
    auto kernel = act == rl8::kRelu ? continuous_act_tiles_kernel<rl8::kRelu> : continuous_act_tiles_kernel<rl8::kTanh>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(B + kTileRows - 1) / kTileRows, kTileThreads, P.smem, s>>>(
        obs, params, actions, logp, values, B, d, P, squashed, seed, offset, deterministic);
    return (int)cudaGetLastError();
  }
  // Layers wider than one pass of the tiled route, and heads or inputs too
  // wide for it (or, at depth, biases too many for its shared memory).
  return launch_staged(obs, params, actions, logp, values, scratch, B, d, hidden, 2 * action_dim, squashed, seed,
                       offset, deterministic, s);
}

// Floats of scratch that rl8_discrete_act (continuous = 0; aligned: its
// parameters are 16-byte aligned) or rl8_continuous_act needs for a launch
// of B rows of these shapes (always some: the wgmma and the tiled routes'
// table of layers, or the staged route's scratch), or -1 where no route
// takes them (dims out of range).
extern "C" long long rl8_act_scratch(int B, int d_in, int n_layers, const int* hidden, int continuous,
                                     int action_dim, int n_cat, int aligned) {
  ActDims d;
  if (action_dim <= 0 || (!continuous && n_cat <= 0)) return -1;
  const int head_w = continuous ? action_dim : action_dim * n_cat;
  if (!make_dims(B, d_in, n_layers, hidden, 0, continuous ? 2 : 1, head_w, &d)) return -1;
  return scratch_floats(d, hidden, continuous ? 2 * action_dim : action_dim, action_dim, aligned != 0, B);
}

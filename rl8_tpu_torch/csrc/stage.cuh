// Staged block products for the update kernels' staged routes (ppo.cu's
// ppo_staged_fwd_kernel and ppo_staged_bwd_kernel, the main path's row
// pass; rnn_ppo.cu's rnn_staged_fwd_kernel and rnn_staged_bwd_kernel, the
// recurrent main path's), the chain kernels' staged routes and the act
// kernels' staged routes (act.cu's act_layer_kernel and
// act_layer_tc_kernel, rnn_act.cu's rnn_gates_tc_kernel, the recurrent
// main path's, and their heads kernels): a block of 256 threads owns
// kStRows rows whose operands live in device memory (the kernels'
// scratches, or the packed minibatch), and each
// product streams both of its operands through a ring of kStStages
// shared-memory stages filled by cp.async (the weight slabs by one bulk
// copy each where the caller passes an StRing), kStK deep along the
// reduction axis, so that shared memory is bounded by the stage depth and
// not by the layer's width, and each weight slab that a stage holds feeds
// all kStRows rows.
//
// - fwd_product: out[r, n] = sum_k A[r, k] W[k, n] on the CUDA cores in
//   f32, register-tiled as tile.cuh's tile_fma (thread (rg, cg) owns rows
//   rg + 16 i, i < RT = kStRows / 16, and two tiles of 8 columns, 4 cg ..
//   and 64 + 4 cg .., and 128 more, of a pass of kStFwdPass columns; one
//   16-byte shared-memory load feeds 16 FMAs, and the block's rows, re-read
//   once a pass, are read once for every 256 columns). Each output sums in
//   order of k into one accumulator with fmaf, as mlp.cuh's dense_layer
//   and lstm.cuh's gate_products do (the forward's values reach the loss,
//   so it stays off the tensor cores: mma.cuh). A product may run over two
//   operands one after the other (the LSTM's x Wi, then h Wh).
// - bwd_product: out[r, u] = sum_k A[r, k] W[u, k] (dh = dpre W^T with W
//   stored [in, out]: W's rows are the output units) on the tensor cores,
//   3xTF32 wgmma (wgmma.cuh): the two warpgroups own 64 rows each (M), a
//   pass covers kStPass units as two n64 tiles (N), and each thread loads
//   its A fragments (the rows' cotangents) from the staged slab and splits
//   them in registers. W is the B operand, K-major as it is stored, from
//   big and small TF32 copies that the launch makes once (tile_bwd_kernel)
//   in the stages' layout. wgmma keeps a sum in one accumulator and rounds
//   each k step's result toward zero; over a whole K of 1024 to 6468 that
//   bias reaches 1e-5 to 6e-5 of the outputs (tests/test_torch_tf32.py), so
//   every kStChunk of k starts a fresh accumulator that a CUDA-core add
//   (round to nearest) folds into the running f32 sum, in order. The bias
//   left in each chunk compounds down a deep chain's dh products: at 64 k a
//   chunk, 324 layers of 128 put the chain backward's gradients 1.2e-4 off
//   float64 (the plain f32 version 2.4e-5), so a chunk is one stage (32 k),
//   whose wgmma results each stage waits for anyway.
//
// - tc_product: out[r, n] = sum_k A[r, k] W[k, n] for one tile of kStPass
//   columns on the tensor cores, 3xTF32 wgmma with bwd_product's scheme, W
//   (stored [in, out]) from big and small TF32 copies that the launch makes
//   once, K-major, in the stages' layout (tile_tc_kernel; for the LSTM's
//   gates with the columns permuted so that one thread's D fragment holds
//   all four gates of its units), over one or two operands one after the
//   other (x Wi, then h Wh), a fresh accumulator every kStChunk of k.
//
// - ws_produce / ws_consume: fwd_product's arithmetic (each output summed
//   in order of k from 0 into one f32 accumulator with fmaf; the same
//   16 x 16 thread tiles, 128 accumulators a thread) on a warp-specialised
//   ring (chains.cu's chains_layer_kernel): a block of kWsThreads is a
//   producer warpgroup, of which one thread issues every copy, and two
//   consumer warpgroups that run the FMAs; setmaxnreg moves the producer's
//   registers to the consumers. The ring holds kWsStages stages of kWsK k,
//   each with a full mbarrier (the copies have landed) and an empty one
//   (every consumer has read it): no block-wide barrier a stage, so the
//   consumers' FMAs run while the next stages' copies are in flight. A
//   weight slab comes by one bulk copy from tile_fwd_kernel's layout, a
//   row slab by one 2-D tensor-map copy (TMA: rows and columns outside the
//   operand read as zeros; its row stride must be a multiple of 16 bytes,
//   so chains.cu pads a first layer's d_in of 7 once a launch) into a
//   [kStRows][kWsK] box. A warp's row loads are broadcasts of two rows, 128
//   bytes apart in a dense box, so the same banks: the box is swizzled
//   instead of padded (TMA's 128-byte swizzle: row r's 16-byte chunk q lies
//   at chunk q ^ (r % 8), ws_swizzle). The weight loads are 16 adjacent
//   16-byte runs a warp. Each row load feeds both 128-column halves. (A
//   producer warp's cp.async of an unaligned first layer lost to
//   fwd_product at a K of 257, PERF.md: it shares a scheduler with two
//   consumer warps.)
//
// Each kernel of a wide route holds one kind of product, one block an SM:
// fwd_product's 128 accumulators a thread, and bwd_product's running sums
// and fragments, take most of its registers.
//
// Weights are read from copies in the stages' own layout, zero-padded to
// whole stages (tile_fwd_kernel, tile_bwd_kernel), so a stage's weight slab
// is one contiguous run and needs no masks; activations are read in place,
// with columns at or past K and rows at or past nr zero-filled. Zero terms
// leave an f32 sum's bits as they are, so the padding changes no output.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "tile.cuh"
#include "wgmma.cuh"

namespace rl8 {
namespace {  // each including source gets its own copy

constexpr int kStThreads = 256;
constexpr int kStRows = 128;                   // rows a block
constexpr int kStK = 32;                       // k a stage
constexpr int kStStages = 3;                   // stages of the ring
constexpr int kStPass = 128;                   // output units a pass of bwd_product
constexpr int kStFwdPass = 256;                // output columns a pass of fwd_product
constexpr int kStChunk = 32;                   // k a wgmma accumulator holds
constexpr int kStLdA = kStK + 4;               // a staged row: A fragment loads hit 32 banks
constexpr int kStAFloats = kStRows * kStLdA;   // a stage's A slab
constexpr int kStWFloats = kStK * kStPass;     // a stage's weight slab (each of big and small)
constexpr int kStFwdWFloats = kStK * kStFwdPass;  // fwd_product's weight slab
constexpr int kStFwdFloats = kStAFloats + kStFwdWFloats;
constexpr int kStBwdFloats = kStAFloats + 2 * kStWFloats;
// A block's shared memory for each product's ring.
constexpr size_t kStFwdSmem = sizeof(float) * kStStages * kStFwdFloats;
constexpr size_t kStBwdSmem = sizeof(float) * kStStages * kStBwdFloats;
static_assert(kStRows == 128 && kStThreads == 256, "two warpgroups of 64 rows; 16 x 16 thread tiles");
static_assert(kStChunk % kStK == 0, "a wgmma chunk is whole stages");
static_assert((kStAFloats * 4) % 128 == 0 && (kStBwdFloats * 4) % 128 == 0 && (kStFwdFloats * 4) % 128 == 0,
              "128-byte aligned slabs");

__host__ __device__ inline long long round_up(long long x, long long m) { return (x + m - 1) / m * m; }

// Floats of a weight copy of K x N in fwd_product's layout, and of one of
// the two halves of a copy in bwd_product's (N units, K deep).
__host__ inline long long fwd_copy_floats(int K, int N) { return round_up(K, kStK) * round_up(N, kStFwdPass); }
__host__ inline long long bwd_copy_floats(int K, int N) { return round_up(K, kStK) * round_up(N, kStPass); }

// Blocks of kStThreads for a weight copy of `floats` (tile_fwd_kernel's and
// tile_tc_kernel's loops step by the grid), and the y extent of a grid over
// B rows' kStRows-row tiles (its kernels step by gridDim.y past the cap).
__host__ inline int st_copy_grid(long long floats) {
  const long long blocks = (floats + kStThreads - 1) / kStThreads;
  return (int)(blocks < 1 ? 1 : (blocks > 4096 ? 4096 : blocks));
}
__host__ inline unsigned st_row_grid(long long B) {
  const long long tiles = (B + kStRows - 1) / kStRows;
  return (unsigned)(tiles < 65535 ? tiles : 65535);
}

// fwd_product's copy of W [K, N] (W[k, n] = src[k * ld + col(n)], col(n) =
// n, or, with gates, the LSTM's gate q = n % 4 of unit n / 4: q H + n / 4,
// so that a thread's four adjacent columns are one unit's four gates):
// [N / kStFwdPass passes][K / kStK stages][kStK][kStFwdPass], zeros past K
// and N.
__global__ void tile_fwd_kernel(const float* __restrict__ src, long long ld, int K, int N, int gates_H,
                                float* __restrict__ dst) {
  const long long S = round_up(K, kStK) / kStK, total = round_up(N, kStFwdPass) * S * kStK;
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < total;
       o += (long long)gridDim.x * blockDim.x) {
    const long long p = o / (S * kStFwdWFloats), s = (o / kStFwdWFloats) % S;
    const int kk = (int)(o % kStFwdWFloats) / kStFwdPass, nn = (int)(o % kStFwdPass);
    const long long k = s * kStK + kk, n = p * kStFwdPass + nn;
    const long long col = gates_H ? (n % 4) * gates_H + n / 4 : n;
    dst[o] = k < K && n < N ? src[k * ld + col] : 0.0f;
  }
}

// bwd_product's copies of W [N, K] (units n, depth k: W[n, k] = src[n * ld
// + k]) split into TF32 big and small halves (mma.cuh's split_tf32):
// [N / kStPass passes][K / kStK stages][kStK / 4][kStPass][4], each stage
// one B operand in wgmma.cuh's bt_offset layout; zeros past K and N.
__global__ void tile_bwd_kernel(const float* __restrict__ src, long long ld, int K, int N, float* __restrict__ big,
                                float* __restrict__ small) {
  const long long S = round_up(K, kStK) / kStK, total = round_up(N, kStPass) * S * kStK;
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < total;
       o += (long long)gridDim.x * blockDim.x) {
    const long long p = o / (S * kStWFloats), s = (o / kStWFloats) % S;
    const int e = (int)(o % kStWFloats);
    const int kc = e / (4 * kStPass), nn = (e / 4) % kStPass, kk = 4 * kc + e % 4;
    const long long k = s * kStK + kk, n = p * kStPass + nn;
    uint32_t b = 0, sm = 0;
    if (k < K && n < N) split_tf32(src[n * ld + k], b, sm);
    big[o] = __uint_as_float(b);
    small[o] = __uint_as_float(sm);
  }
}

// An operand of the block's rows in device memory: row r (r < nr; rows
// past it read as 0) at p + r * ld, columns k < K (past K read as 0). vec:
// p and ld allow 16-byte copies.
struct StRows {
  const float* p;
  long long ld;
  int K, nr, vec;
};

__host__ __device__ inline int st_vec(const float* p, long long ld) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && ld % 4 == 0;
}

// Copies columns k0 .. k0 + kStK of the block's rows of `a` into dst
// [kStRows][kStLdA] with cp.async.cg (from L2: the block's own rows, written
// before a barrier, are read back here).
__device__ __forceinline__ void st_load_rows(float* dst, const StRows& a, int k0) {
  if (a.vec) {
#pragma unroll
    for (int u = 0; u < kStRows * kStK / 4 / kStThreads; ++u) {
      const int i = threadIdx.x + u * kStThreads;
      const int r = i / (kStK / 4), kc = 4 * (i % (kStK / 4));
      const int k = k0 + kc;
      const int bytes = r < a.nr && k < a.K ? 4 * min(4, a.K - k) : 0;
      cp_async16(dst + r * kStLdA + kc, bytes ? a.p + (long long)r * a.ld + k : a.p, bytes);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < kStRows * kStK / kStThreads; ++u) {
      const int i = threadIdx.x + u * kStThreads;
      const int r = i / kStK, kc = i % kStK;
      const int k = k0 + kc;
      const int bytes = r < a.nr && k < a.K ? 4 : 0;
      cp_async4(dst + r * kStLdA + kc, bytes ? a.p + (long long)r * a.ld + k : a.p, bytes);
    }
  }
}

// Copies `floats` contiguous floats (a multiple of 4 * kStThreads) from src
// to dst.
__device__ __forceinline__ void st_load_run(float* dst, const float* __restrict__ src, int floats) {
  for (int i = 4 * threadIdx.x; i < floats; i += 4 * kStThreads) cp_async16(dst + i, src + i, 16);
}

// A ring whose weight slabs come by bulk copies (the TMA unit: one
// instruction a slab, its bytes counted by the stage's mbarrier) instead of
// every thread's cp.async: bar[s] is stage s's mbarrier, bit s of phase the
// parity of its next phase. st_ring_init sets it up once a kernel (every
// thread calls it); a product given a ring leaves every phase complete when
// it returns, so that the next product goes on from the same state.
struct StRing {
  uint64_t* bar;
  uint32_t phase;
};

__device__ __forceinline__ StRing st_ring_init(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStStages; ++s) mbar_init(&bars[s]);
    mbar_init_fence();
  }
  __syncthreads();
  return StRing{bars, 0u};
}

// Issues the weight runs of stage st: `floats` contiguous floats from each
// src[i] to dst[i] (i < n): one bulk copy each from the first thread,
// reporting their bytes to the ring's mbarrier of the stage, or (no ring)
// every thread's cp.async (st_load_run).
__device__ __forceinline__ void st_issue_runs(StRing* ring, int st, int n, float* const* dst,
                                              const float* const* src, int floats) {
  if (ring == nullptr) {
    for (int i = 0; i < n; ++i) st_load_run(dst[i], src[i], floats);
  } else if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)(floats * sizeof(float));
    async_proxy_fence();  // the block's reads of the stage (before the caller's barrier) come first
    mbar_expect(&ring->bar[st], n * bytes);
    for (int i = 0; i < n; ++i) bulk_copy(dst[i], src[i], bytes, &ring->bar[st]);
  }
}

// Waits until bar's phase of the given parity has completed; a phase that
// has not completed after ~10 s of the SM's clock (a copy that never
// arrives) traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void st_mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// Waits for this thread's copies of the oldest stage in flight (st), and for
// the stage's bulk copies where there is a ring, and makes the block's
// copies of it visible to every thread (and, async, to wgmma).
template <bool kAsync>
__device__ __forceinline__ void st_stage_ready(StRing* ring = nullptr, int st = 0) {
  cp_async_wait<kStStages - 2>();
  if (ring != nullptr) {
    st_mbar_wait(&ring->bar[st], (ring->phase >> st) & 1u);
    ring->phase ^= 1u << st;
  }
  if constexpr (kAsync) async_proxy_fence();
  __syncthreads();
}

// mlp.cuh's narrow_head for rows in device memory, 64-bit row offsets:
// out[r * stride + col0 + o] = sum_k in[r * ld_in + k] W[k, o] + b[o] for
// the block's first `rows` rows (kStRows by default), one warp a (row,
// output) pair, lane l summing k = l, l + 32, ... in order and an xor
// butterfly adding the lanes, the same sums as narrow_head's (so the same
// bits), with eight of a lane's loads in flight at once.
__device__ __forceinline__ void st_heads(const float* in, long long ld_in, int in_w, const float* __restrict__ W,
                                         const float* __restrict__ b, int n_out, float* out, long long stride,
                                         int col0, int rows = kStRows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < rows * n_out; p += kStThreads / 32) {
    const int r = p / n_out, o = p % n_out;
    const float* x = in + r * ld_in;
    float s = 0.0f;
    int k = lane;
    for (; k + 7 * 32 < in_w; k += 8 * 32) {
      float xv[8], wv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        xv[u] = x[k + 32 * u];
        wv[u] = __ldg(W + (size_t)(k + 32 * u) * n_out + o);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) s = fmaf(xv[u], wv[u], s);
    }
    for (; k < in_w; k += 32) s = fmaf(x[k], __ldg(W + (size_t)k * n_out + o), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[r * stride + col0 + o] = s + __ldg(b + o);
  }
}

// One operand of fwd_product: rows `a` against the copy `w` of its weight
// (tile_fwd_kernel's layout, for a K of a.K and N columns).
struct FwdSeg {
  StRows a;
  const float* w;
};

// out = A W (see the file's head) over the segments one after the other, N
// output columns. For each pass of kStFwdPass columns and each of the
// thread's two tiles in it, init(acc, n) sets the tile's accumulators
// (acc[i][j]: row rg + 16 i, column n[j]) and, after the pass's products,
// store(acc, rg, n) takes them. Every thread of the block calls it; it
// returns after a barrier, with the stores visible to the block.
template <class Init, class Store>
__device__ void fwd_product(const FwdSeg* seg, int n_seg, int N, float* smem, Init init, Store store,
                            StRing* ring = nullptr) {
  constexpr int RT = kStRows / 16;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int c0 = 4 * cg, c1 = c0 + 64;  // the first tile's columns; the second's are 128 on
  int S = 0, s1 = 0;  // stages of the product, and of the first segment
  for (int q = 0; q < n_seg; ++q) {
    const int sq = (seg[q].a.K + kStK - 1) / kStK;
    if (q == 0) s1 = sq;
    S += sq;
  }
  const int passes = (N + kStFwdPass - 1) / kStFwdPass;
  const int iters = passes * S;
  auto issue = [&](int it) {
    if (it < iters) {
      float* st = smem + (it % kStStages) * kStFwdFloats;
      const int p = it / S, s = it % S;
      const int q = s < s1 ? 0 : 1, sq = q == 0 ? s : s - s1;
      const int Sq = (seg[q].a.K + kStK - 1) / kStK;
      st_load_rows(st, seg[q].a, sq * kStK);
      float* dst = st + kStAFloats;
      const float* src = seg[q].w + ((long long)p * Sq + sq) * kStFwdWFloats;
      st_issue_runs(ring, it % kStStages, 1, &dst, &src, kStFwdWFloats);
    }
    cp_async_commit();
  };
  // The columns of tile h of pass p (computed where they are used, so that
  // they hold no registers through the products).
  auto columns = [&](int p, int h, int (&n)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) n[j] = p * kStFwdPass + 128 * h + (j < 4 ? c0 + j : c1 + j - 4);
  };
  float acc[2][RT][8];
#pragma unroll
  for (int s = 0; s < kStStages - 1; ++s) issue(s);
  for (int it = 0; it < iters; ++it) {
    const int p = it / S, s = it % S;
    if (s == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int n[8];
        columns(p, h, n);
        init(acc[h], n);
      }
    }
    st_stage_ready<false>(ring, it % kStStages);
    issue(it + kStStages - 1);
    const float* st = smem + (it % kStStages) * kStFwdFloats;
    // The stage's k within its segment's K (past it the slabs hold zeros,
    // which add nothing: a first layer's K of d_in takes d_in steps).
    const int q = s < s1 ? 0 : 1;
    const int kq = seg[q].a.K - (q == 0 ? s : s - s1) * kStK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (kq >= kStK) {
        tile_fma<RT>(acc[h], st + rg * kStLdA, 16 * kStLdA, st + kStAFloats, kStFwdPass, kStK, c0 + 128 * h,
                     c1 + 128 * h);
      } else {
        tile_fma<RT>(acc[h], st + rg * kStLdA, 16 * kStLdA, st + kStAFloats, kStFwdPass, kq, c0 + 128 * h,
                     c1 + 128 * h);
      }
    }
    if (s == S - 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int n[8];
        columns(p, h, n);
        store(acc[h], rg, n);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// out = A W^T (see the file's head) for `units` output units: rows `a` (K
// = a.K) against big and small (tile_bwd_kernel's copies). After each pass
// of kStPass units from u0, done(sum, u0) takes the thread's sums of it
// once: element i of n64 tile h is row 64 wg + 16 warp + g + 8 ((i >> 1) &
// 1), unit u0 + 64 h + 8 (i >> 2) + 2 t + (i & 1) (units at or past `units`
// hold zeros), so that a caller can issue every load its outputs need
// before its first store. Every thread of the block calls it; it returns
// after a barrier, with done's stores visible to the block.
template <class Done>
__device__ void bwd_passes(const StRows& a, const float* __restrict__ big, const float* __restrict__ small,
                           int units, float* smem, Done done, StRing* ring = nullptr) {
  constexpr int KSteps = kStK / 8;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int S = (a.K + kStK - 1) / kStK;
  const int passes = (units + kStPass - 1) / kStPass;
  const int iters = passes * S;
  auto issue = [&](int it) {
    if (it < iters) {
      float* st = smem + (it % kStStages) * kStBwdFloats;
      const long long w = (long long)it * kStWFloats;  // pass p, stage s: (p S + s) slabs in
      st_load_rows(st, a, (it % S) * kStK);
      float* dst[2] = {st + kStAFloats, st + kStAFloats + kStWFloats};
      const float* src[2] = {big + w, small + w};
      st_issue_runs(ring, it % kStStages, 2, dst, src, kStWFloats);
    }
    cp_async_commit();
  };
  float acc[2][32], sum[2][32];
#pragma unroll
  for (int s = 0; s < kStStages - 1; ++s) issue(s);
  for (int it = 0; it < iters; ++it) {
    const int s = it % S;
    st_stage_ready<true>(ring, it % kStStages);
    issue(it + kStStages - 1);
    const float* st = smem + (it % kStStages) * kStBwdFloats;
    const float* As = st + (64 * wg + 16 * warp + g) * kStLdA + t;
    uint32_t a_big[KSteps][4], a_small[KSteps][4];
#pragma unroll
    for (int ks = 0; ks < KSteps; ++ks) {
      // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
      const float* x = As + 8 * ks;
      split_tf32(x[0], a_big[ks][0], a_small[ks][0]);
      split_tf32(x[8 * kStLdA], a_big[ks][1], a_small[ks][1]);
      split_tf32(x[4], a_big[ks][2], a_small[ks][2]);
      split_tf32(x[8 * kStLdA + 4], a_big[ks][3], a_small[ks][3]);
    }
    // Every k step and both n64 tiles of the pass, also past K and units
    // (zeros there): no wgmma sits in a branch (ptxas serializes every
    // wgmma of a kernel that has one).
#pragma unroll
    for (int ks = 0; ks < KSteps; ++ks) {
      const float* b = st + kStAFloats + 8 * ks * kStPass;
      wgmma_fence();
      const int add = (s * kStK + 8 * ks) % kStChunk != 0;  // a chunk's first k step starts its sum
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t db = wgmma_desc(b + 4 * 64 * h, 16 * kStPass, 128);
        const uint64_t ds = wgmma_desc(b + kStWFloats + 4 * 64 * h, 16 * kStPass, 128);
        wgmma_3xtf32(acc[h], a_big[ks], a_small[ks], db, ds, add);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[h][i])::"memory");
    if ((s + 1) * kStK % kStChunk == 0 || s == S - 1) {
      const bool first = s < kStChunk / kStK;  // the pass's first chunk
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[h][i] = first ? acc[h][i] : sum[h][i] + acc[h][i];
    }
    if (s == S - 1) done(sum, (it / S) * kStPass);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// bwd_passes with store(r, u, v) taking each output of the block's rows r <
// kStRows and units u < units, once.
template <class Store>
__device__ void bwd_product(const StRows& a, const float* __restrict__ big, const float* __restrict__ small,
                            int units, float* smem, Store store) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  bwd_passes(a, big, small, units, smem, [&](const float(&sum)[2][32], int u0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        // D [64, 64]: row 16 warp + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2.
        const int r = 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
        const int u = u0 + 64 * h + 8 * (i >> 2) + 2 * t + (i & 1);
        if (u < units) store(r, u, sum[h][i]);
      }
  });
}

// tc_product's copies of W [K, N] (W[k, n] = src[k * ld + col(n)]; col(n)
// = n, or, with gates, the LSTM's column of gate q of unit u below) split
// into TF32 big and small halves: [N / kStPass passes][K / kStK stages]
// [kStK / 4][kStPass][4] (bwd_product's stage layout), zeros past K and N.
// With gates, column c of pass p (n64 tile h = c / 64, then j = (c % 64) / 8,
// t = (c % 8) / 2, e = c % 2) is gate q = 2 (j % 2) + e of unit u = 32 p +
// 16 h + 4 (j / 2) + t, so that the thread of a wgmma D fragment that holds
// column 2 t + e of the tile's 8-column groups 2 m and 2 m + 1 holds all
// four gates of unit 4 m + t.
__global__ void tile_tc_kernel(const float* __restrict__ src, long long ld, int K, int N, int gates_H,
                               float* __restrict__ big, float* __restrict__ small) {
  const long long S = round_up(K, kStK) / kStK, total = round_up(N, kStPass) * S * kStK;
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < total;
       o += (long long)gridDim.x * blockDim.x) {
    const long long p = o / (S * kStWFloats), s = (o / kStWFloats) % S;
    const int e = (int)(o % kStWFloats);
    const int kc = e / (4 * kStPass), nn = (e / 4) % kStPass, kk = 4 * kc + e % 4;
    const long long k = s * kStK + kk, n = p * kStPass + nn;
    long long col = n;
    bool in = n < N;
    if (gates_H) {
      const int j = (nn % 64) / 8, tq = (nn % 8) / 2;
      const long long u = 32 * p + 16 * (nn / 64) + 4 * (j / 2) + tq;
      col = (2 * (j % 2) + nn % 2) * (long long)gates_H + u;
      in = u < gates_H;
    }
    uint32_t b = 0, sm = 0;
    if (k < K && in) split_tf32(src[k * ld + col], b, sm);
    big[o] = __uint_as_float(b);
    small[o] = __uint_as_float(sm);
  }
}

// One operand of tc_product: rows `a` against the big and small copies of
// its weight's column tile (tile_tc_kernel's layout, the tile's pass).
struct TcSeg {
  StRows a;
  const float* big;
  const float* small;
};

// out = A W over the segments one after the other for one tile of kStPass
// columns, on the tensor cores in 3xTF32 wgmma (bwd_product's scheme: the
// two warpgroups own 64 rows each, each thread splits its A fragments from
// the staged slab in registers, W's halves are the K-major B operand), each
// kStChunk of k (counted over the segments' stages in turn) in a fresh
// accumulator folded into an f32 running sum in order. done(sum) takes the
// thread's sums once: element i of n64 tile h is row 64 wg + 16 warp + g +
// 8 ((i >> 1) & 1), column 64 h + 8 (i >> 2) + 2 t + (i & 1). Every thread
// of the block calls it; it returns after a barrier. The weight slabs come
// by bulk copies where the caller passes a ring.
template <class Done>
__device__ void tc_product(const TcSeg* seg, int n_seg, float* smem, Done done, StRing* ring = nullptr) {
  constexpr int KSteps = kStK / 8;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  int iters = 0, s1 = 0;
  for (int q = 0; q < n_seg; ++q) {
    const int sq = (seg[q].a.K + kStK - 1) / kStK;
    if (q == 0) s1 = sq;
    iters += sq;
  }
  auto issue = [&](int it) {
    if (it < iters) {
      float* st = smem + (it % kStStages) * kStBwdFloats;
      const int q = it < s1 ? 0 : 1, sq = q == 0 ? it : it - s1;
      const long long w = (long long)sq * kStWFloats;
      st_load_rows(st, seg[q].a, sq * kStK);
      float* dst[2] = {st + kStAFloats, st + kStAFloats + kStWFloats};
      const float* src[2] = {seg[q].big + w, seg[q].small + w};
      st_issue_runs(ring, it % kStStages, 2, dst, src, kStWFloats);
    }
    cp_async_commit();
  };
  float acc[2][32], sum[2][32];
#pragma unroll
  for (int s = 0; s < kStStages - 1; ++s) issue(s);
  for (int it = 0; it < iters; ++it) {
    st_stage_ready<true>(ring, it % kStStages);
    issue(it + kStStages - 1);
    const float* st = smem + (it % kStStages) * kStBwdFloats;
    const float* As = st + (64 * wg + 16 * warp + g) * kStLdA + t;
    uint32_t a_big[KSteps][4], a_small[KSteps][4];
#pragma unroll
    for (int ks = 0; ks < KSteps; ++ks) {
      const float* x = As + 8 * ks;
      split_tf32(x[0], a_big[ks][0], a_small[ks][0]);
      split_tf32(x[8 * kStLdA], a_big[ks][1], a_small[ks][1]);
      split_tf32(x[4], a_big[ks][2], a_small[ks][2]);
      split_tf32(x[8 * kStLdA + 4], a_big[ks][3], a_small[ks][3]);
    }
#pragma unroll
    for (int ks = 0; ks < KSteps; ++ks) {
      const float* b = st + kStAFloats + 8 * ks * kStPass;
      wgmma_fence();
      const int add = (it * kStK + 8 * ks) % kStChunk != 0;  // a chunk's first k step starts its sum
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t db = wgmma_desc(b + 4 * 64 * h, 16 * kStPass, 128);
        const uint64_t ds = wgmma_desc(b + kStWFloats + 4 * 64 * h, 16 * kStPass, 128);
        wgmma_3xtf32(acc[h], a_big[ks], a_small[ks], db, ds, add);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[h][i])::"memory");
    if ((it + 1) * kStK % kStChunk == 0 || it == iters - 1) {
      const bool first = it < kStChunk / kStK;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[h][i] = first ? acc[h][i] : sum[h][i] + acc[h][i];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  done(sum);
}

// ------------------------------------------------ warp-specialised product

constexpr int kWsThreads = 384;    // a producer warpgroup, then two consumer warpgroups
constexpr int kWsConsumers = 256;   // fwd_product's 16 x 16 thread tiles
constexpr int kWsK = 32;            // k a stage
constexpr int kWsStages = 4;        // stages of the ring
constexpr int kWsProducerRegs = 40;
constexpr int kWsConsumerRegs = 232;
constexpr int kWsAFloats = kStRows * kWsK;      // a stage's rows, dense [kStRows][kWsK]
constexpr int kWsWFloats = kWsK * kStFwdPass;   // a stage's weight slab [kWsK][kStFwdPass]
constexpr int kWsStageFloats = kWsAFloats + kWsWFloats;
// A block's shared memory: 1024 bytes to align the ring, the ring, and its
// 2 kWsStages mbarriers.
constexpr size_t kWsSmem = 1024 + sizeof(float) * kWsStages * kWsStageFloats + 2 * sizeof(uint64_t) * kWsStages;
static_assert((kWsThreads - kWsConsumers == 128 || kWsThreads - kWsConsumers == 32) && kWsConsumers == 256 &&
                  kStFwdPass == 256,
              "a producer warpgroup (or warp); the consumers' tiles cover 128 rows x 256 columns");
static_assert(kStK % kWsK == 0 && kWsK % 4 == 0, "a stage is a run of a copy's 32-k stage");
static_assert((kWsStageFloats * 4) % 1024 == 0 && (kWsAFloats * 4) % 1024 == 0,
              "swizzled TMA boxes at 1024-byte boundaries");
static_assert(kWsK == 32 || kWsK == 16, "rows of 128 or 64 bytes: TMA's swizzle of the same span");
static_assert(kWsSmem <= 232448, "the ring fits a block's shared memory");
static_assert(kWsProducerRegs * 128 + kWsConsumerRegs * 256 <= 65536, "the SM's registers");

// The ring of ws_produce and ws_consume: slabs [kWsStages][kWsStageFloats]
// (rows, then the weight slab), full[s] (one arrival with the stage's bytes)
// and empty[s] (kWsConsumers arrivals);
// g counts the stages so far, the same in the producer and the consumers.
struct WsRing {
  float* slabs;
  uint64_t* full;
  uint64_t* empty;
  uint32_t g;
};

// Sets up the ring in `smem` (the kernel's dynamic shared memory, kWsSmem
// bytes); every thread of the block calls it, before the roles split. The
// ring is an offset of smem (not an address rounded as an integer), so
// that the compiler keeps its loads in the shared space (LDS, not generic
// loads).
__device__ __forceinline__ WsRing ws_ring_init(float* smem) {
  float* slabs = smem + ((1024 - (shared_addr(smem) & 1023)) & 1023) / sizeof(float);
  uint64_t* bars = reinterpret_cast<uint64_t*>(slabs + kWsStages * kWsStageFloats);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWsStages; ++s) {
      mbar_init(&bars[s]);
      mbar_init_count(&bars[kWsStages + s], kWsConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return WsRing{slabs, bars, bars + kWsStages, 0u};
}

// What a swizzled row slab XORs into row r's 16-byte chunk indices (TMA's
// 128-byte swizzle for rows of 128 bytes, its 64-byte one for rows of 64:
// address bits 7 and up): chunk q of row r lies at chunk q ^ ws_swizzle(r).
__device__ __forceinline__ int ws_swizzle(int r) { return ((r * kWsK * 4) >> 7) & (kWsK / 4 - 1); }

// The roles' register budgets (every thread of a warpgroup executes its
// own; with a producer warp alone, not a warpgroup, the launch bound sets
// one budget for all).
__device__ __forceinline__ void ws_producer_regs() {
  if constexpr (kWsThreads - kWsConsumers == 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWsProducerRegs));
  }
}
__device__ __forceinline__ void ws_consumer_regs() {
  if constexpr (kWsThreads - kWsConsumers == 128) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWsConsumerRegs));
  }
}

// A 2-D tensor-map copy of the box at (k0, r0) (columns, rows) of `map` to
// dst, reporting its bytes to bar.
__device__ __forceinline__ void tma_load_2d(float* dst, const void* map, int k0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(shared_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(r0), "r"(shared_addr(bar))
      : "memory");
}

// The producer's side of one tile: every stage of its K, the weight slab
// from w (tile_fwd_kernel's layout, the tile's pass) by one bulk copy and
// the kStRows rows from row r0 by a tensor-map copy of `map` (the operand
// [rows, K]), each into the next free stage of the ring. One thread of the
// block calls it.
__device__ void ws_produce(WsRing& ring, const void* map, int K, int r0, const float* __restrict__ w) {
  const int S = (K + kWsK - 1) / kWsK;
  for (int s = 0; s < S; ++s, ++ring.g) {
    const int slot = ring.g % kWsStages;
    float* rows = ring.slabs + slot * kWsStageFloats;
    st_mbar_wait(&ring.empty[slot], ((ring.g / kWsStages) & 1u) ^ 1u);  // the consumers' release of its last use
    async_proxy_fence();
    mbar_expect(&ring.full[slot], kWsStageFloats * sizeof(float));
    bulk_copy(rows + kWsAFloats, w + (long long)s * kWsK * kStFwdPass, kWsWFloats * sizeof(float), &ring.full[slot]);
    tma_load_2d(rows, map, s * kWsK, r0, &ring.full[slot]);
  }
}

// acc[h][i][j] += sum over k < K of A(i, k) W[k kStFwdPass + 128 h + c(j)]
// in order of k (c(j) = c0 + j for j < 4, c1 + j - 4 after), A(i, k) the
// thread's row i (row 16 i of a swizzled slab from A, all with swizzle sw,
// ws_swizzle), each row load shared by both halves.
template <int RT>
__device__ __forceinline__ void ws_fma(float (&acc)[2][RT][8], const float* A, int sw, const float* W, int K, int c0,
                                       int c1) {
  int k = 0;
#pragma unroll 1
  for (; k + 4 <= K; k += 4) {
    float4 a[RT];
    const int kc = ((k >> 2) ^ sw) << 2;
#pragma unroll
    for (int r = 0; r < RT; ++r) a[r] = *reinterpret_cast<const float4*>(A + r * 16 * kWsK + kc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 w0 = *reinterpret_cast<const float4*>(W + (k + kk) * kStFwdPass + 128 * h + c0);
        const float4 w1 = *reinterpret_cast<const float4*>(W + (k + kk) * kStFwdPass + 128 * h + c1);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float ak = kk == 0 ? a[r].x : kk == 1 ? a[r].y : kk == 2 ? a[r].z : a[r].w;
          acc[h][r][0] = fmaf(ak, w0.x, acc[h][r][0]);
          acc[h][r][1] = fmaf(ak, w0.y, acc[h][r][1]);
          acc[h][r][2] = fmaf(ak, w0.z, acc[h][r][2]);
          acc[h][r][3] = fmaf(ak, w0.w, acc[h][r][3]);
          acc[h][r][4] = fmaf(ak, w1.x, acc[h][r][4]);
          acc[h][r][5] = fmaf(ak, w1.y, acc[h][r][5]);
          acc[h][r][6] = fmaf(ak, w1.z, acc[h][r][6]);
          acc[h][r][7] = fmaf(ak, w1.w, acc[h][r][7]);
        }
      }
    }
  }
  for (; k < K; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 w0 = *reinterpret_cast<const float4*>(W + k * kStFwdPass + 128 * h + c0);
      const float4 w1 = *reinterpret_cast<const float4*>(W + k * kStFwdPass + 128 * h + c1);
      const int kc = (((k >> 2) ^ sw) << 2) + (k & 3);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float ak = A[r * 16 * kWsK + kc];
        acc[h][r][0] = fmaf(ak, w0.x, acc[h][r][0]);
        acc[h][r][1] = fmaf(ak, w0.y, acc[h][r][1]);
        acc[h][r][2] = fmaf(ak, w0.z, acc[h][r][2]);
        acc[h][r][3] = fmaf(ak, w0.w, acc[h][r][3]);
        acc[h][r][4] = fmaf(ak, w1.x, acc[h][r][4]);
        acc[h][r][5] = fmaf(ak, w1.y, acc[h][r][5]);
        acc[h][r][6] = fmaf(ak, w1.z, acc[h][r][6]);
        acc[h][r][7] = fmaf(ak, w1.w, acc[h][r][7]);
      }
    }
  }
}

// The consumers' side of one tile of K: the products of every stage as it
// lands (fwd_product's sums, from zero), each stage released to the
// producer once read; then store(acc, rg, c0, c1) takes the thread's
// outputs (acc[h][i][j]: row rg + 16 i, column 128 h + c0 + j for j < 4,
// 128 h + c1 + j - 4 after). Every consumer thread calls it.
template <class Store>
__device__ void ws_consume(WsRing& ring, int K, Store store) {
  constexpr int RT = kStRows / 16;
  const int ct = threadIdx.x - (kWsThreads - kWsConsumers);
  const int rg = ct / 16, c0 = 4 * (ct % 16), c1 = c0 + 64;
  float acc[2][RT][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) tile_zero(acc[h]);
  const int S = (K + kWsK - 1) / kWsK;
  for (int s = 0; s < S; ++s, ++ring.g) {
    const int slot = ring.g % kWsStages;
    st_mbar_wait(&ring.full[slot], (ring.g / kWsStages) & 1u);
    const float* rows = ring.slabs + slot * kWsStageFloats;
    const int kq = K - s * kWsK;
    if (kq >= kWsK) {
      ws_fma<RT>(acc, rows + rg * kWsK, ws_swizzle(rg), rows + kWsAFloats, kWsK, c0, c1);
    } else {
      ws_fma<RT>(acc, rows + rg * kWsK, ws_swizzle(rg), rows + kWsAFloats, kq, c0, c1);
    }
    mbar_arrive(&ring.empty[slot]);
  }
  store(acc, rg, c0, c1);
}

}  // namespace
}  // namespace rl8

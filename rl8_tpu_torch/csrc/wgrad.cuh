// Weight gradients summed over rows, shared by the PPO update kernels
// (ppo.cu, rnn_ppo.cu) and the chain backward (chains.cu): C[K (+1), J] =
// [A | 1]^T B over every row, i.e. dW [K, J] followed (when the job has a
// bias) by db [J], which is how W and b lie in the flat parameter vector
// from offset `off`.
//
// Replaces, with ppo.cu, rnn_ppo.cu and chains.cu, the weight-gradient sums
// of rl8_tpu/ops/fused_ppo.py's _discrete_kernel and _continuous_kernel,
// fused_rnn_ppo.py's _kernel and fused_mlp.py's _bwd_kernel (each grid step
// adds its rows' h^T dpre into VMEM-resident accumulators on the MXU).
//
// The rows are split over up to kMaxGroups groups; each group writes its own
// partial gradient and sum_partials_kernel adds them in a fixed order, so
// there are no float atomics and two launches give the same bits.
//
// Bound on an H100 SXM at the feedforward main path (262,144 rows, twin
// 256-wide torsos): the products are 7.0e10 FLOP, 0.42 ms at three TF32
// products per f32 product at the tensor cores' 495 TFLOP/s, and they read
// ~1.07 GB of row scratch once, 0.32 ms at 3.35 TB/s.
//
// Design. Jobs with K >= kWgMinK and J >= kWgMinJ go to reduce_wgmma_kernel:
// a block (two warpgroups) owns a kTile x kTile tile of dW for one group of
// rows and walks the group kChunk rows at a time through a ring of kStages
// shared-memory stages filled by cp.async (each operand's rows lie anywhere:
// strided scratch slabs, or (sequence, step) pairs), so that the next
// chunks' loads overlap this chunk's products. The products are 3xTF32
// wgmma (wgmma.cuh), the reduction axis being the rows: warpgroup wg owns
// the tile's units k0 + 64 wg .. of K (M), both n64 halves of its J units
// (N). wgmma reads a .tf32 operand from shared memory only K-major (rows
// contiguous for each unit), and both operands lie row-major in the
// scratch, so the A operand (the layer's input h) comes from registers,
// each thread loading its fragments from the staged rows and splitting
// them (mma.cuh's split_tf32), and the B operand (the cotangent dpre) is
// transposed in the stage: the block converts each staged chunk into big
// and small TF32 halves in wgmma.cuh's bt_offset layout, into one of two
// buffers, while the tensor cores run the chunk before it (a split the
// operand needs anyway, so the transpose costs no extra pass; a row pass
// writing dpre transposed would still leave the split to do here). Each
// chunk's 32 rows are a fresh wgmma accumulator (the tensor core rounds
// each k step's sum toward zero), folded into an f32 running sum on the
// CUDA cores, in order. The blocks of the first k tile of a biased job also
// sum db from the staged B chunk on the CUDA cores, each column's rows in a
// fixed order. This replaces 128x128 mma.sync tiles (mma.cuh), which issue
// one instruction per m16n8k8 step and reached ~53 TFLOP/s, instruction-
// bound. Other jobs (small: the first layer's K = d_in, the 1- and 2-wide
// heads, LayerNorm's bias-only column sums with K = 0 in chains.cu) go to
// reduce_small_kernel on the CUDA cores, a lane an output, the block's
// warps on slices of the group's rows, each in order: a 128-wide tile would
// waste most of its products on them, and their cost is the rows they
// read.
//
// A launch holds at most kMaxWgJobs jobs a list; launch_jobs splits any
// number of jobs into lists, a launch each (a deep model's layers, several
// chains' heads).
//
// Row i of a job is (i / inner_rows, i % inner_rows): the feedforward
// update's rows have inner_rows = 1; the recurrent update's rows are
// (sequence, step) pairs, inner_rows = seq_len, so each operand is read in
// place from its scratch with an outer and an inner stride.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "tile.cuh"
#include "wgmma.cuh"

namespace rl8 {
namespace {  // each including source gets its own copy

constexpr int kWgThreads = 256;
constexpr int kTile = 128;         // wgmma products: outputs per tile side
constexpr int kChunk = 32;         // wgmma products: rows per stage, and a wgmma accumulator's
constexpr int kStages = 3;         // wgmma products: stages of the cp.async ring
constexpr int kWgLdA = kTile + 8;  // a staged A row: the fragments' loads hit 32 banks
constexpr int kWgAFloats = kChunk * kWgLdA;            // a stage's A rows [kChunk][kWgLdA]
constexpr int kWgRawFloats = kWgAFloats + kChunk * kTile;  // and its B rows [kChunk][kTile]
constexpr int kWgOpFloats = kChunk * kTile;            // one TF32 half of a converted B chunk
// Two converted B chunks (big and small halves each), then the ring.
constexpr size_t kWgmmaSmem = sizeof(float) * (4 * kWgOpFloats + kStages * kWgRawFloats);
constexpr int kWgMinK = 64;        // smaller K (a first layer's d_in) or J (heads) go to reduce_small_kernel
constexpr int kWgMinJ = 8;
constexpr int kMaxGroups = 64;     // split of the rows
constexpr int kGroupRows = 4096;   // rows per group below the cap
constexpr int kMaxWgJobs = 24;
static_assert(kChunk == 32 && kTile == 128 && kWgThreads == 256 && kStages == 3,
              "two warpgroups of 64 units; 4 k steps a chunk; two chunks in flight");
static_assert((4 * kWgOpFloats * 4) % 128 == 0 && (kWgRawFloats * 4) % 16 == 0, "aligned operands");

struct Job {
  const float* a;  // the input of the layer (or head)
  const float* b;  // the cotangent of its output
  long long a_outer, a_inner, b_outer, b_inner;  // strides of row (i / inner_rows, i % inner_rows)
  long long off;
  int K, J, bias, tiles_j, tile0;  // tiles_j: a small job's blocks
  int vec_a, vec_b;  // the operand's rows can be copied 16 bytes at a time
};

struct Jobs {
  Job job[kMaxWgJobs];
  int n;
  int inner_rows;
  int slices;  // the small list: slices of a group's rows (small_slices)
  long long rows_per_group;
  long long rows, P;
};

// Groups of rows and rows per group for `rows` rows.
__host__ inline void split_rows(long long rows, int* groups, long long* rows_per_group) {
  long long g = (rows + kGroupRows - 1) / kGroupRows;
  g = g < 1 ? 1 : (g > kMaxGroups ? kMaxGroups : g);
  *groups = (int)g;
  *rows_per_group = (rows + g - 1) / g;
}

// reduce_small_kernel's slices of a group's rows: at least 256 rows each,
// up to one a warp.
__host__ inline int small_slices(long long rows_per_group) {
  int slices = 1;
  while (slices < kWgThreads / 32 && rows_per_group >= 512LL * slices) slices *= 2;
  return slices;
}

__host__ inline int aligned16(const float* p, long long outer, long long inner) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && outer % 4 == 0 && inner % 4 == 0;
}

// Adds `jb` to the small list (`small_tiles` of its blocks so far) if K < kWgMinK or J < kWgMinJ (K = 0: bias-only), else to the
// wgmma list (`tiles` tiles so far).
__host__ inline void add_job(Job jb, Jobs* tiled, Jobs* small, int* tiles, int* small_tiles) {
  if (jb.K < kWgMinK || jb.J < kWgMinJ) {
    const long long per_block = 32LL * (kWgThreads / 32 / small->slices);
    jb.tiles_j = (int)(((long long)(jb.K + jb.bias) * jb.J + per_block - 1) / per_block);
    jb.tile0 = *small_tiles;
    jb.vec_a = jb.vec_b = 0;
    *small_tiles += jb.tiles_j;
    small->job[small->n++] = jb;
  } else {
    jb.tiles_j = (jb.J + kTile - 1) / kTile;
    jb.tile0 = *tiles;
    jb.vec_a = aligned16(jb.a, jb.a_outer, jb.a_inner);
    jb.vec_b = aligned16(jb.b, jb.b_outer, jb.b_inner);
    *tiles += jb.tiles_j * ((jb.K + kTile - 1) / kTile);
    tiled->job[tiled->n++] = jb;
  }
}

// The job of a block, selected with constant indices so the table stays in
// the parameter bank.
__device__ __forceinline__ Job select_job(const Jobs& js, int index) {
  Job jb = js.job[0];
#pragma unroll
  for (int q = 1; q < kMaxWgJobs; ++q) {
    if (q < js.n && js.job[q].tile0 <= index) jb = js.job[q];
  }
  return jb;
}

// Where row n of a job's operand starts: n * outer, or with kStaged ((outer,
// inner) rows, n < 2^31) (n / inner_rows) * outer + (n % inner_rows) * inner.
template <bool kStaged>
__device__ __forceinline__ long long row_start(long long n, int inner_rows, long long outer, long long inner) {
  if constexpr (kStaged) {
    const unsigned q = (unsigned)n / (unsigned)inner_rows;
    return (long long)q * outer + (long long)((unsigned)n - q * (unsigned)inner_rows) * inner;
  } else {
    return n * outer;
  }
}

// Issues the cp.async copies of rows [n0, n0 + kChunk) of one operand's
// columns [c0, c0 + width) into dst [kChunk][ld]: 16 bytes a copy where the
// operand allows it (vec), else 4. Rows past n_end are zero-filled; columns
// at or past width are not written (they stay 0 from the start).
template <bool kStaged>
__device__ __forceinline__ void load_chunk(float* dst, int ld, const float* __restrict__ src, long long outer,
                                           long long inner, int vec, int inner_rows, long long n0, long long n_end,
                                           int c0, int width) {
  if (vec) {
#pragma unroll
    for (int u = 0; u < kChunk * kTile / 4 / kWgThreads; ++u) {
      const int i = threadIdx.x + u * kWgThreads;
      const int r = i / (kTile / 4), col = 4 * (i % (kTile / 4));
      if (col < width) {
        const long long n = n0 + r;
        const int bytes = n < n_end ? 4 * min(4, width - col) : 0;
        const float* p = bytes ? src + row_start<kStaged>(n, inner_rows, outer, inner) + c0 + col : src;
        cp_async16(dst + r * ld + col, p, bytes);
      }
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < kChunk * kTile / kWgThreads; ++u) {
      const int i = threadIdx.x + u * kWgThreads;
      const int r = i / kTile, col = i % kTile;
      if (col < width) {
        const long long n = n0 + r;
        const int bytes = n < n_end ? 4 : 0;
        const float* p = bytes ? src + row_start<kStaged>(n, inner_rows, outer, inner) + c0 + col : src;
        cp_async4(dst + r * ld + col, p, bytes);
      }
    }
  }
}

// The wgmma jobs (see the file's head): a block owns a kTile x kTile tile of
// dW for one group of rows, kChunk rows a stage. Per chunk c: each thread
// splits its A fragments from the staged rows (a0 (m, k) = A[row k][unit
// m], m = 64 wg + 16 warp + g), the warpgroups issue 4 k steps of 3xTF32
// wgmma over both n64 halves into a fresh accumulator from the converted B
// chunk c, and while the tensor cores run them the block converts B chunk
// c + 1 into the other buffer; then each thread adds the accumulator into
// its f32 running sum. Units past K and J (zero columns) and rows past the
// group (zero rows) add nothing; no wgmma sits in a branch (ptxas
// serializes every wgmma of a kernel that has one). kStaged: rows are
// (outer, inner) pairs.
template <bool kStaged>
__global__ void __launch_bounds__(kWgThreads, 1) reduce_wgmma_kernel(Jobs js, float* __restrict__ partials) {
  extern __shared__ __align__(128) float wg_smem[];
  float* op = wg_smem;                     // 2 x [big, small] x [kChunk / 4][kTile][4] (bt_offset)
  float* raw = wg_smem + 4 * kWgOpFloats;  // kStages x [A [kChunk][kWgLdA], B [kChunk][kTile]]
  const Job jb = select_job(js, blockIdx.x);
  const int tile = blockIdx.x - jb.tile0;
  const int k0 = (tile / jb.tiles_j) * kTile;
  const int j0 = (tile % jb.tiles_j) * kTile;
  const int kw = min(kTile, jb.K - k0), jw = min(kTile, jb.J - j0);
  const long long n_begin = (long long)blockIdx.y * js.rows_per_group;
  const long long n_end = min(js.rows, n_begin + js.rows_per_group);
  const int chunks = n_end > n_begin ? (int)((n_end - n_begin + kChunk - 1) / kChunk) : 0;
  const bool do_bias = jb.bias && k0 == 0;

  // Columns past kw and jw are never copied: zero them once in every stage
  // (a full tile's copies write every column, zeros past n_end included).
  if (kw < kTile || jw < kTile) {
    for (int i = threadIdx.x; i < kStages * kWgRawFloats; i += kWgThreads) raw[i] = 0.0f;
    __syncthreads();
  }
  auto issue = [&](int c) {
    if (c < chunks) {
      float* st = raw + (c % kStages) * kWgRawFloats;
      const long long n0 = n_begin + (long long)c * kChunk;
      load_chunk<kStaged>(st, kWgLdA, jb.a, jb.a_outer, jb.a_inner, jb.vec_a, js.inner_rows, n0, n_end, k0, kw);
      load_chunk<kStaged>(st + kWgAFloats, kTile, jb.b, jb.b_outer, jb.b_inner, jb.vec_b, js.inner_rows, n0, n_end,
                          j0, jw);
    }
    cp_async_commit();
  };
  // B chunk c into converted buffer c & 1: thread (cq, cj) takes column cj
  // of row quads cq, cq + 2, cq + 4, cq + 6 (four rows a 16-byte store of
  // each half), and sums that column's rows for db in this fixed order.
  const int cj = threadIdx.x % kTile, cq = threadIdx.x / kTile;
  float bias = 0.0f;
  auto convert = [&](int c) {
    const float* bs = raw + (c % kStages) * kWgRawFloats + kWgAFloats;
    float* big = op + (c & 1) * 2 * kWgOpFloats;
#pragma unroll
    for (int u = 0; u < kChunk / 8; ++u) {
      const int q = cq + 2 * u;
      float x[4];
      uint32_t hb[4], hs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = bs[(4 * q + i) * kTile + cj];
        split_tf32(x[i], hb[i], hs[i]);
      }
      if (do_bias) bias = (((bias + x[0]) + x[1]) + x[2]) + x[3];
      *reinterpret_cast<uint4*>(big + q * 4 * kTile + 4 * cj) = make_uint4(hb[0], hb[1], hb[2], hb[3]);
      *reinterpret_cast<uint4*>(big + kWgOpFloats + q * 4 * kTile + 4 * cj) = make_uint4(hs[0], hs[1], hs[2], hs[3]);
    }
  };

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m = 64 * wg + 16 * warp + g;
  float acc[2][32], sum[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[h][i] = 0.0f;
  issue(0);
  issue(1);
  if (chunks > 0) {
    cp_async_wait<1>();
    __syncthreads();  // chunk 0 has landed for every thread
    convert(0);
    async_proxy_fence();
    __syncthreads();  // converted chunk 0 is visible to wgmma
  }
  for (int c = 0; c < chunks; ++c) {
    const float* as = raw + (c % kStages) * kWgRawFloats + t * kWgLdA + m;
    uint32_t a_big[kChunk / 8][4], a_small[kChunk / 8][4];
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      // a0 (m, k), a1 (m + 8, k), a2 (m, k + 4), a3 (m + 8, k + 4), k = 8 ks + t.
      const float* x = as + 8 * ks * kWgLdA;
      split_tf32(x[0], a_big[ks][0], a_small[ks][0]);
      split_tf32(x[8], a_big[ks][1], a_small[ks][1]);
      split_tf32(x[4 * kWgLdA], a_big[ks][2], a_small[ks][2]);
      split_tf32(x[4 * kWgLdA + 8], a_big[ks][3], a_small[ks][3]);
    }
    const float* b = op + (c & 1) * 2 * kWgOpFloats;
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t db = wgmma_desc(b + 8 * ks * kTile + 4 * 64 * h, 16 * kTile, 128);
        const uint64_t ds = wgmma_desc(b + kWgOpFloats + 8 * ks * kTile + 4 * 64 * h, 16 * kTile, 128);
        wgmma_3xtf32(acc[h], a_big[ks], a_small[ks], db, ds, ks > 0);  // the chunk's first k step starts its sum
      }
      wgmma_commit();
    }
    // While they run: the copies of chunk c + 2 into the stage chunk c - 1
    // held (read before the last barrier), and chunk c + 1's conversion into
    // the buffer chunk c - 1's products read (waited for before it).
    issue(c + 2);
    if (c + 1 < chunks) {
      cp_async_wait<1>();
      __syncthreads();  // chunk c + 1 has landed for every thread
      convert(c + 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[h][i])::"memory");
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[h][i] += acc[h][i];
    async_proxy_fence();
    __syncthreads();  // converted chunk c + 1 is visible to wgmma; every warp is done with stage c's A rows
  }
  cp_async_wait<0>();
  __syncthreads();
  float* out = partials + (size_t)blockIdx.y * js.P + jb.off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      // D [64, 64]: row 16 warp + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2.
      const int k = k0 + m + 8 * ((i >> 1) & 1);
      const int col = j0 + 64 * h + 8 * (i >> 2) + 2 * t + (i & 1);
      if (k < jb.K && col < jb.J) out[(size_t)k * jb.J + col] = sum[h][i];
    }
  }
  if (do_bias) {
    float* part = raw;  // the ring is free after the barrier above
    if (cq == 1) part[cj] = bias;
    __syncthreads();
    if (cq == 0 && cj < jw) out[(size_t)jb.K * jb.J + j0 + cj] = bias + part[cj];
  }
}

// The small jobs (see the file's head): a block per G x 32 outputs of a job,
// [K (+1 for the bias), J] flattened, and group of rows, where the block's
// kWgThreads / 32 warps are G groups of 32 outputs times S = js.slices
// slices of the group's rows (few rows a group: more outputs a block). Lane
// l of a warp takes its output group's output l; each warp sums its slice's
// rows in order, and the first slice's warps add the slices' sums in order.
// Each thread steps its operands' row addresses from row to row (kStaged:
// (outer, inner) rows, inner within a sequence, a wrap to the next one's
// first step). (Eight outputs a lane, a warp's loads of a row covering 256
// consecutive outputs, made the main path's small jobs 2.4x slower on an
// H100: kernel_variants.py, ppo_split_ms.)
template <bool kStaged>
__global__ void __launch_bounds__(kWgThreads) reduce_small_kernel(Jobs js, float* __restrict__ partials) {
  constexpr int kWarps = kWgThreads / 32;
  __shared__ float part[kWarps][32];
  const Job jb = select_job(js, blockIdx.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S = js.slices, G = kWarps / S, og = warp % G, sl = warp / G;
  const long long outs = (long long)(jb.K + jb.bias) * jb.J;
  const long long o = ((long long)(blockIdx.x - jb.tile0) * G + og) * 32 + lane;
  // The output's columns: k of A (the bias row's A is 1) and j of B;
  // outputs past the job compute on column 0 and are not stored.
  const int k = o < outs ? (int)(o / jb.J) : 0, j = o < outs ? (int)(o % jb.J) : 0;
  const long long n_begin = (long long)blockIdx.y * js.rows_per_group;
  const long long n_end = min(js.rows, n_begin + js.rows_per_group);
  const long long per = n_end > n_begin ? (n_end - n_begin + S - 1) / S : 0;
  const long long w_begin = min(n_end, n_begin + sl * per), w_end = min(n_end, w_begin + per);
  float s = 0.0f;
  if (w_begin < w_end) {
    const int ir = js.inner_rows;
    int r = kStaged ? (int)(w_begin % ir) : 0;
    const long long q = kStaged ? w_begin / ir : w_begin;
    const float* pb = jb.b + q * jb.b_outer + r * jb.b_inner + j;
    const long long b_wrap = jb.b_outer - (long long)(ir - 1) * jb.b_inner;
    if (k < jb.K) {
      const float* pa = jb.a + q * jb.a_outer + r * jb.a_inner + k;
      const long long a_wrap = jb.a_outer - (long long)(ir - 1) * jb.a_inner;
#pragma unroll 8
      for (long long n = w_begin; n < w_end; ++n) {
        s = fmaf(__ldg(pa), __ldg(pb), s);
        if constexpr (kStaged) {
          const bool wrap = ++r == ir;
          r = wrap ? 0 : r;
          pa += wrap ? a_wrap : jb.a_inner;
          pb += wrap ? b_wrap : jb.b_inner;
        } else {
          pa += jb.a_outer;
          pb += jb.b_outer;
        }
      }
    } else {
#pragma unroll 8
      for (long long n = w_begin; n < w_end; ++n) {
        s += __ldg(pb);
        if constexpr (kStaged) {
          const bool wrap = ++r == ir;
          r = wrap ? 0 : r;
          pb += wrap ? b_wrap : jb.b_inner;
        } else {
          pb += jb.b_outer;
        }
      }
    }
  }
  part[warp][lane] = s;
  __syncthreads();
  if (sl == 0 && o < outs) {
    float sum = part[og][lane];
    for (int w = 1; w < S; ++w) sum += part[og + w * G][lane];
    partials[(size_t)blockIdx.y * js.P + jb.off + o] = sum;
  }
}

// grads[p] = sum over groups of partials[g, p], in order of g; with
// accumulate, added to grads[p] (a launch over chunks of rows: each chunk's
// sum in chunk order).
__global__ void sum_partials_kernel(const float* __restrict__ partials, int groups, long long P,
                                    float* __restrict__ grads, int accumulate) {
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += (long long)gridDim.x * blockDim.x) {
    float s = partials[p];
    for (int g = 1; g < groups; ++g) s += partials[(size_t)g * P + p];
    grads[p] = accumulate ? grads[p] + s : s;
  }
}

// stats[s] = sum over row blocks of stat_part[b, s]: strided sums per
// thread, then a tree in shared memory, both in a fixed order.
__global__ void __launch_bounds__(kWgThreads)
    sum_stats_kernel(const float* __restrict__ stat_part, int blocks, float* __restrict__ stats) {
  __shared__ float sh[4][kWgThreads];
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int b = threadIdx.x; b < blocks; b += kWgThreads) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] += stat_part[(size_t)b * 4 + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sh[i][threadIdx.x] = s[i];
  __syncthreads();
  for (int w = kWgThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sh[i][threadIdx.x] += sh[i][threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x < 4) stats[threadIdx.x] = sh[threadIdx.x][0];
}

// WT [J, K] = W [K, J]^T.
__global__ void transpose_kernel(const float* __restrict__ W, float* __restrict__ WT, int K, int J) {
  const long long total = (long long)K * J;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    WT[(i % J) * K + i / J] = W[i];
  }
}

__host__ inline int grid_for(long long work) {
  const long long blocks = (work + kWgThreads - 1) / kWgThreads;
  return (int)(blocks < 1 ? 1 : (blocks > 4096 ? 4096 : blocks));
}

// Launches the wgmma jobs of `tiled` (`tiles` tiles) over `groups` groups of
// rows.
__host__ inline cudaError_t launch_tiled(const Jobs& tiled, int tiles, int groups, float* partials, cudaStream_t s) {
  const auto kernel = tiled.inner_rows > 1 ? reduce_wgmma_kernel<true> : reduce_wgmma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgmmaSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, groups), kWgThreads, kWgmmaSmem, s>>>(tiled, partials);
  return cudaGetLastError();
}

// Launches the small jobs of `small` (`tiles` blocks) over `groups` groups of
// rows.
__host__ inline cudaError_t launch_small(const Jobs& small, int tiles, int groups, float* partials, cudaStream_t s) {
  const auto kernel = small.inner_rows > 1 ? reduce_small_kernel<true> : reduce_small_kernel<false>;
  kernel<<<dim3(tiles, groups), kWgThreads, 0, s>>>(small, partials);
  return cudaGetLastError();
}

// A job with a bias over rows of one outer stride each (inner_rows = 1).
__host__ inline Job make_job(const float* a, long long a_outer, const float* b, long long b_outer, int K, int J,
                             long long off) {
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
  jb.tiles_j = jb.tile0 = jb.vec_a = jb.vec_b = 0;
  return jb;
}

// Launches the weight products of jobs[0..n) (row i of a job is (i /
// inner_rows, i % inner_rows)) in lists of at most kMaxWgJobs, wgmma and
// small apart, over `groups` groups of rows_per_group rows, each group
// writing its partial gradient of every job's parameters: any number of
// jobs, a launch per full list.
__host__ inline cudaError_t launch_jobs(const Job* jobs, long long n, long long rows, int groups,
                                        long long rows_per_group, long long P, float* partials, cudaStream_t s,
                                        int inner_rows = 1) {
  Jobs tiled, small;
  auto reset = [&](Jobs* js) {
    js->n = 0;
    js->inner_rows = inner_rows;
    js->slices = small_slices(rows_per_group);
    js->rows_per_group = rows_per_group;
    js->rows = rows;
    js->P = P;
  };
  reset(&tiled);
  reset(&small);
  int tiles = 0, small_tiles = 0;
  auto flush = [&](bool force) -> cudaError_t {
    if (tiled.n > 0 && (force || tiled.n == kMaxWgJobs)) {
      cudaError_t e = launch_tiled(tiled, tiles, groups, partials, s);
      reset(&tiled);
      tiles = 0;
      if (e != cudaSuccess) return e;
    }
    if (small.n > 0 && (force || small.n == kMaxWgJobs)) {
      cudaError_t e = launch_small(small, small_tiles, groups, partials, s);
      reset(&small);
      small_tiles = 0;
      return e;
    }
    return cudaSuccess;
  };
  for (long long q = 0; q < n; ++q) {
    add_job(jobs[q], &tiled, &small, &tiles, &small_tiles);
    cudaError_t err = flush(false);
    if (err != cudaSuccess) return err;
  }
  return flush(true);
}

}  // namespace
}  // namespace rl8

// Weight gradients summed over rows, shared by the PPO update kernels
// (ppo.cu, rnn_ppo.cu) and the chain backward (chains.cu): C[K (+1), J] =
// [A | 1]^T B over every row, i.e. dW [K, J] followed (when the job has a
// bias) by db [J], which is how W and b lie in the flat parameter vector
// from offset `off`.
//
// The rows are split over up to kMaxGroups groups; each group writes its own
// partial gradient and sum_partials_kernel adds them in a fixed order, so
// there are no float atomics and two launches give the same bits. Products
// (any K and J: the first layer's K = d_in and the 1- and 2-wide heads
// included) go to reduce_tiled_kernel, 128x128 output tiles on the tensor
// cores (mma.cuh's 3xTF32) fed by a cp.async ring of row chunks; bias-only
// jobs (K = 0: LayerNorm's column sums in chains.cu) to reduce_bias_kernel,
// a block per kWgThreads columns and group of rows, a thread per column on
// the CUDA cores.
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

namespace rl8 {
namespace {  // each including source gets its own copy

constexpr int kWgThreads = 256;
constexpr int kTile = 128;         // tiled products: outputs per tile side
constexpr int kChunk = 32;         // tiled products: rows per shared-memory stage
constexpr int kStages = 3;         // tiled products: stages of the cp.async ring
constexpr int kLd = kTile + 8;     // a staged row: 8 floats of padding make fragment loads conflict-free
constexpr size_t kTiledSmem = sizeof(float) * kStages * 2 * kChunk * kLd;
constexpr int kMaxGroups = 64;     // split of the rows
constexpr int kGroupRows = 4096;   // rows per group below the cap
constexpr int kMaxWgJobs = 24;

struct Job {
  const float* a;  // the input of the layer (or head)
  const float* b;  // the cotangent of its output
  long long a_outer, a_inner, b_outer, b_inner;  // strides of row (i / inner_rows, i % inner_rows)
  long long off;
  int K, J, bias, tiles_j, tile0;
  int vec_a, vec_b;  // the operand's rows can be copied 16 bytes at a time
};

struct Jobs {
  Job job[kMaxWgJobs];
  int n;
  int inner_rows;
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

__host__ inline int aligned16(const float* p, long long outer, long long inner) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && outer % 4 == 0 && inner % 4 == 0;
}

// Adds `jb` to the tiled list.
__host__ inline void add_tiled(Job jb, Jobs* tiled, int* tiles) {
  jb.tiles_j = (jb.J + kTile - 1) / kTile;
  jb.tile0 = *tiles;
  jb.vec_a = aligned16(jb.a, jb.a_outer, jb.a_inner);
  jb.vec_b = aligned16(jb.b, jb.b_outer, jb.b_inner);
  *tiles += jb.tiles_j * ((jb.K + kTile - 1) / kTile);
  tiled->job[tiled->n++] = jb;
}

// Adds `jb` to the bias list (`bias_tiles` blocks of kWgThreads columns so
// far) if it is bias-only (K = 0), else to the tiled one. (A 1- or 2-wide
// head on the tensor cores wastes most of each tile's products, but streams
// its rows at the tiled kernel's rate: the thread-per-output kernel that
// took the heads before spent 2.05 ms of the recurrent update on them on an
// H100, chip_smoke.py --time-updates.)
__host__ inline void add_job(Job jb, Jobs* tiled, Jobs* bias, int* tiles, int* bias_tiles) {
  if (jb.K == 0) {
    jb.tiles_j = (jb.J + kWgThreads - 1) / kWgThreads;
    jb.tile0 = *bias_tiles;
    *bias_tiles += jb.tiles_j;
    bias->job[bias->n++] = jb;
  } else {
    add_tiled(jb, tiled, tiles);
  }
}

// The job of a block, selected with constant indices so the table stays in
// the parameter bank.
__device__ __forceinline__ Job select_job(const Jobs& js, int index, bool by_tile) {
  Job jb = js.job[0];
#pragma unroll
  for (int q = 1; q < kMaxWgJobs; ++q) {
    if (q < js.n && (by_tile ? js.job[q].tile0 <= index : q == index)) jb = js.job[q];
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
// columns [c0, c0 + width) into dst [kChunk, kLd]: 16 bytes a copy where
// the operand allows it (vec), else 4. Rows past n_end are zero-filled;
// columns at or past width are not written (they stay 0 from the start).
template <bool kStaged>
__device__ __forceinline__ void load_chunk(float* dst, const float* __restrict__ src, long long outer, long long inner,
                                           int vec, int inner_rows, long long n0, long long n_end, int c0, int width) {
  if (vec) {
#pragma unroll
    for (int u = 0; u < kChunk * kTile / 4 / kWgThreads; ++u) {
      const int i = threadIdx.x + u * kWgThreads;
      const int r = i / (kTile / 4), col = 4 * (i % (kTile / 4));
      if (col < width) {
        const long long n = n0 + r;
        const int bytes = n < n_end ? 4 * min(4, width - col) : 0;
        const float* p = bytes ? src + row_start<kStaged>(n, inner_rows, outer, inner) + c0 + col : src;
        cp_async16(dst + r * kLd + col, p, bytes);
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
        cp_async4(dst + r * kLd + col, p, bytes);
      }
    }
  }
}

// Wide jobs, on the tensor cores: a block owns a 128x128 tile of dW for one
// group of rows and walks the group kChunk rows at a time through a ring of
// kStages shared-memory stages filled by cp.async, so that the next chunks'
// loads overlap this chunk's products. Its 8 warps split the tile 2 x 4,
// 64x32 outputs each (4 x 4 m16n8 tiles), summed with mma.cuh's 3xTF32
// products over the chunk's rows (the reduction axis). m and n tiles past
// the job's K and J are skipped. The blocks of the first k tile of a biased
// job also sum db, one column per thread of the first 128, on the CUDA
// cores from the staged B chunk: a K that fills its k tiles leaves no room
// for a ones column. kStaged: rows are (outer, inner) pairs.
template <bool kStaged>
__global__ void __launch_bounds__(kWgThreads, 2) reduce_tiled_kernel(Jobs js, float* __restrict__ partials) {
  extern __shared__ __align__(16) float wg_smem[];  // kStages x [A chunk, B chunk], each [kChunk, kLd]
  const Job jb = select_job(js, blockIdx.x, true);
  const int t = blockIdx.x - jb.tile0;
  const int k0 = (t / jb.tiles_j) * kTile;
  const int j0 = (t % jb.tiles_j) * kTile;
  const int kw = min(kTile, jb.K - k0), jw = min(kTile, jb.J - j0);
  const long long n_begin = (long long)blockIdx.y * js.rows_per_group;
  const long long n_end = min(js.rows, n_begin + js.rows_per_group);
  const int chunks = (int)((n_end - n_begin + kChunk - 1) / kChunk);
  const bool do_bias = jb.bias && k0 == 0 && threadIdx.x < kTile;

  // Columns past kw and jw are never copied: zero them once in every stage
  // (a full tile's copies write every column, zeros past n_end included).
  if (kw < kTile || jw < kTile) {
    for (int i = threadIdx.x; i < kStages * 2 * kChunk * kLd; i += kWgThreads) wg_smem[i] = 0.0f;
    __syncthreads();
  }
  auto issue = [&](int chunk) {
    if (chunk < chunks) {
      float* As = wg_smem + (chunk % kStages) * 2 * kChunk * kLd;
      const long long n0 = n_begin + (long long)chunk * kChunk;
      load_chunk<kStaged>(As, jb.a, jb.a_outer, jb.a_inner, jb.vec_a, js.inner_rows, n0, n_end, k0, kw);
      load_chunk<kStaged>(As + kChunk * kLd, jb.b, jb.b_outer, jb.b_inner, jb.vec_b, js.inner_rows, n0, n_end, j0,
                          jw);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  float bias = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c has landed, and every warp is done with chunk c - 1's stage
    issue(c + kStages - 1);
    const float* As = wg_smem + (c % kStages) * 2 * kChunk * kLd;
    const float* Bs = As + kChunk * kLd;
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 8) {
      const float* a_lo = As + (ks + tq) * kLd + wm + g;
      const float* b_lo = Bs + (ks + tq) * kLd + wn + g;
      FragB fb[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) fb[nt].set(b_lo[nt * 8], b_lo[nt * 8 + 4 * kLd]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (wm + mt * 16 < kw) {
          const float* a = a_lo + mt * 16;
          FragA fa;
          fa.set(a[0], a[8], a[4 * kLd], a[4 * kLd + 8]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (wn + nt * 8 < jw) mma_3xtf32(acc[mt][nt], fa, fb[nt]);
          }
        }
      }
    }
    if (do_bias) {
#pragma unroll 8
      for (int r = 0; r < kChunk; ++r) bias += Bs[r * kLd + threadIdx.x];
    }
  }
  cp_async_wait<0>();
  float* out = partials + (size_t)blockIdx.y * js.P + jb.off;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + wm + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int col = j0 + wn + nt * 8 + 2 * tq + (e & 1);
        if (k < jb.K && col < jb.J) out[(size_t)k * jb.J + col] = acc[mt][nt][e];
      }
    }
  }
  if (do_bias && threadIdx.x < jw) out[(size_t)jb.K * jb.J + j0 + threadIdx.x] = bias;
}

// Bias-only jobs (K = 0, rows with inner_rows = 1: LayerNorm's dscale and
// dbias in chains.cu): a block per kWgThreads columns of a job and group of
// rows, a thread per column, summing the group's rows in order.
__global__ void __launch_bounds__(kWgThreads) reduce_bias_kernel(Jobs js, float* __restrict__ partials) {
  const Job jb = select_job(js, blockIdx.x, true);
  const int j = (blockIdx.x - jb.tile0) * kWgThreads + threadIdx.x;
  if (j >= jb.J) return;
  const long long n_begin = (long long)blockIdx.y * js.rows_per_group;
  const long long n_end = min(js.rows, n_begin + js.rows_per_group);
  float s = 0.0f;
#pragma unroll 8
  for (long long n = n_begin; n < n_end; ++n) s += jb.b[n * jb.b_outer + j];
  partials[(size_t)blockIdx.y * js.P + jb.off + j] = s;
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

// Launches the tiled products of `tiled` (`tiles` tiles) over `groups`
// groups of rows.
__host__ inline cudaError_t launch_tiled(const Jobs& tiled, int tiles, int groups, float* partials, cudaStream_t s) {
  const auto kernel = tiled.inner_rows > 1 ? reduce_tiled_kernel<true> : reduce_tiled_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTiledSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, groups), kWgThreads, kTiledSmem, s>>>(tiled, partials);
  return cudaGetLastError();
}

// Launches the bias-only jobs of `bias` (`tiles` blocks of columns) over
// `groups` groups of rows.
__host__ inline cudaError_t launch_bias(const Jobs& bias, int tiles, int groups, float* partials, cudaStream_t s) {
  if (bias.inner_rows != 1) return cudaErrorInvalidValue;
  reduce_bias_kernel<<<dim3(tiles, groups), kWgThreads, 0, s>>>(bias, partials);
  return cudaGetLastError();
}

// Launches the weight products of `tiled` (`tiles` tiles) over `groups`
// groups, then the fixed-order sum into grads [P] and the stat sums of
// `blocks` row blocks into stats [4].
__host__ inline cudaError_t launch_wgrad(const Jobs& tiled, int tiles, int groups, float* partials, float* grads,
                                         const float* stat_part, int blocks, float* stats, cudaStream_t s) {
  cudaError_t err;
  if ((err = launch_tiled(tiled, tiles, groups, partials, s)) != cudaSuccess) return err;
  sum_partials_kernel<<<grid_for(tiled.P), kWgThreads, 0, s>>>(partials, groups, tiled.P, grads, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_stats_kernel<<<1, kWgThreads, 0, s>>>(stat_part, blocks, stats);
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

// Launches the weight products of jobs[0..n) (rows with inner_rows = 1) in
// lists of at most kMaxWgJobs, tiled and bias-only apart, over `groups`
// groups of rows_per_group rows, each group writing its partial gradient
// of every job's parameters: any number of jobs, a launch per full list.
__host__ inline cudaError_t launch_jobs(const Job* jobs, long long n, long long rows, int groups,
                                        long long rows_per_group, long long P, float* partials, cudaStream_t s) {
  Jobs tiled, bias;
  auto reset = [&](Jobs* js) {
    js->n = 0;
    js->inner_rows = 1;
    js->rows_per_group = rows_per_group;
    js->rows = rows;
    js->P = P;
  };
  reset(&tiled);
  reset(&bias);
  int tiles = 0, bias_tiles = 0;
  auto flush = [&](bool force) -> cudaError_t {
    if (tiled.n > 0 && (force || tiled.n == kMaxWgJobs)) {
      cudaError_t e = launch_tiled(tiled, tiles, groups, partials, s);
      reset(&tiled);
      tiles = 0;
      if (e != cudaSuccess) return e;
    }
    if (bias.n > 0 && (force || bias.n == kMaxWgJobs)) {
      cudaError_t e = launch_bias(bias, bias_tiles, groups, partials, s);
      reset(&bias);
      bias_tiles = 0;
      return e;
    }
    return cudaSuccess;
  };
  for (long long q = 0; q < n; ++q) {
    add_job(jobs[q], &tiled, &bias, &tiles, &bias_tiles);
    cudaError_t err = flush(false);
    if (err != cudaSuccess) return err;
  }
  return flush(true);
}

}  // namespace
}  // namespace rl8

// Weight gradients summed over rows, shared by the PPO update kernels
// (ppo.cu, rnn_ppo.cu): C[K (+1), J] = [A | 1]^T B over every row, i.e. dW
// [K, J] followed (when the job has a bias) by db [J], which is how W and b
// lie in the flat parameter vector from offset `off`.
//
// The rows are split over up to kMaxGroups groups; each group writes its own
// partial gradient and sum_partials_kernel adds them in a fixed order, so
// there are no float atomics and two launches give the same bits. Wide jobs
// go to reduce_tiled_kernel (64x64 output tiles, 4x4 outputs per thread),
// narrow ones to reduce_narrow_kernel (a thread per output), both staging
// chunks of rows through shared memory.
//
// Row i of a job is (i / inner_rows, i % inner_rows): the feedforward
// update's rows have inner_rows = 1; the recurrent update's rows are
// (sequence, step) pairs, inner_rows = seq_len, so each operand is read in
// place from its scratch with an outer and an inner stride.
#pragma once

#include <cuda_runtime.h>

namespace rl8 {
namespace {  // each including source gets its own copy

constexpr int kWgThreads = 256;
constexpr int kTile = 64;          // tiled products: outputs per tile side
constexpr int kChunk = 32;         // tiled products: rows per shared-memory stage
constexpr int kNarrowPer = 16;     // narrow products: outputs per thread
constexpr int kNarrowSmem = 8192;  // narrow products: floats of a staged row chunk
constexpr int kStageBatch = 8;     // narrow products: loads in flight per thread
constexpr int kMaxGroups = 64;     // split of the rows
constexpr int kGroupRows = 4096;   // rows per group below the cap
constexpr int kMaxWgJobs = 24;

struct Job {
  const float* a;  // the input of the layer (or head)
  const float* b;  // the cotangent of its output
  long long a_outer, a_inner, b_outer, b_inner;  // strides of row (i / inner_rows, i % inner_rows)
  long long off;
  int K, J, bias, tiles_j, tile0;
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

// Adds `jb` to the tiled list.
__host__ inline void add_tiled(Job jb, Jobs* tiled, int* tiles) {
  jb.tiles_j = (jb.J + kTile - 1) / kTile;
  jb.tile0 = *tiles;
  *tiles += jb.tiles_j * ((jb.K + kTile - 1) / kTile);
  tiled->job[tiled->n++] = jb;
}

// Adds `jb` to the narrow list if its outputs fit it, else to the tiled one.
__host__ inline void add_job(Job jb, Jobs* tiled, Jobs* narrow, int* tiles) {
  if ((long long)(jb.K + jb.bias) * jb.J <= (long long)kWgThreads * kNarrowPer) {
    jb.tiles_j = jb.tile0 = 0;
    narrow->job[narrow->n++] = jb;
  } else {
    add_tiled(jb, tiled, tiles);
  }
}

// Where row n0 + r of the job's operands starts, or -1 past n_end: one
// division per row and chunk, kept in shared memory, so the loads
// themselves divide nothing. Only jobs with inner_rows > 1 stage them (the
// kernels' kStaged instantiation); with inner_rows = 1 a row starts at n *
// outer.
__device__ __forceinline__ void row_offsets(const Job& jb, int inner_rows, long long n0, long long n_end, int r,
                                            long long* off_a, long long* off_b) {
  const long long n = n0 + r;
  const long long outer = n / inner_rows, inner = n % inner_rows;
  off_a[r] = n < n_end ? outer * jb.a_outer + inner * jb.a_inner : -1;
  off_b[r] = n < n_end ? outer * jb.b_outer + inner * jb.b_inner : -1;
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

// Wide jobs: a block owns a 64x64 tile of dW for one group of rows and walks
// the group 32 rows at a time through shared memory; each thread keeps 4x4
// outputs. The blocks of the first k tile of a biased job also sum db.
// kStaged: rows are (outer, inner) pairs whose offsets are staged per chunk.
template <bool kStaged>
__global__ void __launch_bounds__(kWgThreads) reduce_tiled_kernel(Jobs js, float* __restrict__ partials) {
  __shared__ __align__(16) float As[kChunk][kTile];
  __shared__ __align__(16) float Bs[kChunk][kTile];
  __shared__ long long off_a[kChunk], off_b[kChunk];
  const Job jb = select_job(js, blockIdx.x, true);
  const int t = blockIdx.x - jb.tile0;
  const int k0 = (t / jb.tiles_j) * kTile;
  const int j0 = (t % jb.tiles_j) * kTile;
  const long long n_begin = (long long)blockIdx.y * js.rows_per_group;
  const long long n_end = min(js.rows, n_begin + js.rows_per_group);
  const int tk = threadIdx.x / 16 * 4;
  const int tj = threadIdx.x % 16 * 4;
  const bool do_bias = jb.bias && k0 == 0 && threadIdx.x < kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float bias = 0.0f;
  for (long long n0 = n_begin; n0 < n_end; n0 += kChunk) {
    if constexpr (kStaged) {
      if (threadIdx.x < kChunk) row_offsets(jb, js.inner_rows, n0, n_end, threadIdx.x, off_a, off_b);
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kChunk * kTile / kWgThreads; ++u) {
      const int rr = (threadIdx.x + u * kWgThreads) / kTile;
      const int cc = threadIdx.x % kTile;
      const long long n = n0 + rr;
      const bool in_rows = n < n_end;
      const long long oa = kStaged ? off_a[rr] : n * jb.a_outer;
      const long long ob = kStaged ? off_b[rr] : n * jb.b_outer;
      As[rr][cc] = (in_rows && k0 + cc < jb.K) ? jb.a[oa + k0 + cc] : 0.0f;
      Bs[rr][cc] = (in_rows && j0 + cc < jb.J) ? jb.b[ob + j0 + cc] : 0.0f;
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

// dst[r * width + c] = src[off[r] + c] for r < rows, c < width (off[r] =
// (n0 + r) * outer when off is null), with each thread's loads issued in
// batches of kStageBatch before their stores, so that they wait on device
// memory together rather than one by one.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, const long long* off, long long n0,
                                           long long outer, int width, int rows, float* dst) {
  const int total = rows * width;
  for (int base = threadIdx.x; base < total; base += kWgThreads * kStageBatch) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = base + u * kWgThreads;
      const int r = i / width;
      v[u] = i < total ? src[(off != nullptr ? off[r] : (n0 + r) * outer) + i % width] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = base + u * kWgThreads;
      if (i < total) dst[i] = v[u];
    }
  }
}

// Narrow jobs ((K + bias) * J <= kWgThreads * kNarrowPer): a block per job and
// group of rows, a thread per output of C (row K is the bias). The block
// stages chunks of rows of A and B through shared memory with all its
// threads, so that many loads are in flight at once, and each thread then
// sums its outputs from shared memory. kStaged: as for reduce_tiled_kernel.
template <bool kStaged>
__global__ void __launch_bounds__(kWgThreads) reduce_narrow_kernel(Jobs js, float* __restrict__ partials) {
  __shared__ __align__(16) float sm[kNarrowSmem];
  __shared__ long long off_a[kChunk], off_b[kChunk];
  const Job jb = select_job(js, blockIdx.x, false);
  const long long n_begin = (long long)blockIdx.y * js.rows_per_group;
  const long long n_end = min(js.rows, n_begin + js.rows_per_group);
  const int K = jb.K, J = jb.J;
  const int outputs = (K + jb.bias) * J;
  const int chunk = min(kChunk, kNarrowSmem / (K + J));
  float* As = sm;              // [chunk, K]
  float* Bs = sm + chunk * K;  // [chunk, J]
  int rk[kNarrowPer], cj[kNarrowPer];
  float acc[kNarrowPer];
#pragma unroll
  for (int i = 0; i < kNarrowPer; ++i) {
    const int o = threadIdx.x + i * kWgThreads;
    rk[i] = o / J;
    cj[i] = o % J;
    acc[i] = 0.0f;
  }
  for (long long n0 = n_begin; n0 < n_end; n0 += chunk) {
    const int rows = (int)min((long long)chunk, n_end - n0);
    if constexpr (kStaged) {
      if (threadIdx.x < rows) row_offsets(jb, js.inner_rows, n0, n_end, threadIdx.x, off_a, off_b);
      __syncthreads();
    }
    stage_rows(jb.a, kStaged ? off_a : nullptr, n0, jb.a_outer, K, rows, As);
    stage_rows(jb.b, kStaged ? off_b : nullptr, n0, jb.b_outer, J, rows, Bs);
    __syncthreads();
    for (int rr = 0; rr < rows; ++rr) {
#pragma unroll
      for (int i = 0; i < kNarrowPer; ++i) {
        if (threadIdx.x + i * kWgThreads < outputs) {
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
    const int o = threadIdx.x + i * kWgThreads;
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

// Launches the weight products of `tiled` and `narrow` (`tiles` tiles in
// all) over `groups` groups, then the fixed-order sum into grads [P] and the
// stat sums of `blocks` row blocks into stats [4].
__host__ inline cudaError_t launch_wgrad(const Jobs& tiled, const Jobs& narrow, int tiles, int groups,
                                         float* partials, float* grads, const float* stat_part, int blocks,
                                         float* stats, cudaStream_t s) {
  cudaError_t err;
  const bool staged = tiled.inner_rows > 1;
  if (tiled.n > 0) {
    const auto kernel = staged ? reduce_tiled_kernel<true> : reduce_tiled_kernel<false>;
    kernel<<<dim3(tiles, groups), kWgThreads, 0, s>>>(tiled, partials);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (narrow.n > 0) {
    const auto kernel = staged ? reduce_narrow_kernel<true> : reduce_narrow_kernel<false>;
    kernel<<<dim3(narrow.n, groups), kWgThreads, 0, s>>>(narrow, partials);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  sum_partials_kernel<<<grid_for(tiled.P), kWgThreads, 0, s>>>(partials, groups, tiled.P, grads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_stats_kernel<<<1, kWgThreads, 0, s>>>(stat_part, blocks, stats);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rl8

// Register-tiled f32 products on the CUDA cores, shared by the chain
// forward's tiled route (chains.cu) and the act kernels' tiled route
// (act.cu).
//
// A block computes out[R, n] = A[R, K] @ W[K, n] with A and W in shared
// memory, both row-major. Thread (rg, cg) owns RT adjacent rows (rg * RT
// ...) and 8 columns: 4 from c0 = 4 cg and 4 from c1 = c0 + 4 CG, so that
// the CG threads of a row group read W's row k as two runs of 16-byte
// loads with no bank conflict. Per 4 k a thread loads RT float4s of A (one
// per row, 4 k each; a warp's lanes share their rows, so these are
// broadcasts) and 8 float4s of W, and issues 32 RT FMAs: one 16-byte
// shared-memory load feeds 8 (RT = 4) to 10.7 (RT = 8) FMAs, where
// mlp.cuh's dense_layer needs one per FMA. Each output sums in order of k
// in one f32 accumulator, as the plain versions' products do (no tensor
// cores: they flip relu masks and bias the log-probs, PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rl8 {
namespace {  // each including source gets its own copy

// Hopper's bulk copies (the TMA unit: one instruction moves a whole
// contiguous block to shared memory and reports its bytes to an mbarrier),
// for weights that stream through shared memory.
__device__ __forceinline__ uint32_t shared_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_addr(bar)) : "memory");
}

// Makes initialized mbarriers visible to the bulk copies.
__device__ __forceinline__ void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

// Orders this thread's earlier shared-memory accesses (after a barrier:
// the block's) before its next bulk copies' writes.
__device__ __forceinline__ void async_proxy_fence() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// The arrival of this phase, expecting `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(bytes)
               : "memory");
}

// Copies `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// src to dst, reporting them to bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(bytes), "r"(shared_addr(bar))
               : "memory");
}

// Copies 8 bytes (both addresses 8-byte aligned) as a cp.async.
__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(shared_addr(dst)), "l"(src) : "memory");
}

// Waits until bar's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(shared_addr(bar)),
      "r"(parity)
      : "memory");
}

// Row stride of a tile held for tile_fma's products: a multiple of 4 (rows
// 16-byte aligned) that is not one of 8, so row groups RT = 4 rows apart in
// one warp read and write different banks.
inline int tile_ld(int w) {
  const int ld = (w + 3) / 4 * 4;
  return ld % 8 == 0 ? ld + 4 : ld;
}

// acc[r][j] += sum over k < K of A[r * lda + k] * W[k * ldw + c(j)], c(j) =
// c0 + j for j < 4 and c1 + j - 4 otherwise, in order of k. A points at the
// thread's first row; lda, ldw, c0 and c1 are multiples of 4 and A, W are
// 16-byte aligned. The columns must lie inside W's rows (the caller clamps
// a group past the layer's width and does not store it).
template <int RT>
__device__ __forceinline__ void tile_fma(float (&acc)[RT][8], const float* A, int lda, const float* W, int ldw,
                                         int K, int c0, int c1) {
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= K; k += 4) {
    float4 a[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) a[r] = *reinterpret_cast<const float4*>(A + r * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(W + (k + kk) * ldw + c0);
      const float4 w1 = *reinterpret_cast<const float4*>(W + (k + kk) * ldw + c1);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float ak = kk == 0 ? a[r].x : kk == 1 ? a[r].y : kk == 2 ? a[r].z : a[r].w;
        acc[r][0] = fmaf(ak, w0.x, acc[r][0]);
        acc[r][1] = fmaf(ak, w0.y, acc[r][1]);
        acc[r][2] = fmaf(ak, w0.z, acc[r][2]);
        acc[r][3] = fmaf(ak, w0.w, acc[r][3]);
        acc[r][4] = fmaf(ak, w1.x, acc[r][4]);
        acc[r][5] = fmaf(ak, w1.y, acc[r][5]);
        acc[r][6] = fmaf(ak, w1.z, acc[r][6]);
        acc[r][7] = fmaf(ak, w1.w, acc[r][7]);
      }
    }
  }
  for (; k < K; ++k) {
    const float4 w0 = *reinterpret_cast<const float4*>(W + k * ldw + c0);
    const float4 w1 = *reinterpret_cast<const float4*>(W + k * ldw + c1);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float ak = A[r * lda + k];
      acc[r][0] = fmaf(ak, w0.x, acc[r][0]);
      acc[r][1] = fmaf(ak, w0.y, acc[r][1]);
      acc[r][2] = fmaf(ak, w0.z, acc[r][2]);
      acc[r][3] = fmaf(ak, w0.w, acc[r][3]);
      acc[r][4] = fmaf(ak, w1.x, acc[r][4]);
      acc[r][5] = fmaf(ak, w1.y, acc[r][5]);
      acc[r][6] = fmaf(ak, w1.z, acc[r][6]);
      acc[r][7] = fmaf(ak, w1.w, acc[r][7]);
    }
  }
}

template <int RT>
__device__ __forceinline__ void tile_zero(float (&acc)[RT][8]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
}

// Narrow heads on a one-pass layer's outputs in registers: h[r][j] is the
// thread's row r, column n[j] (columns at or past w are ignored), and the CG
// adjacent lanes of its row group (within a warp) hold the whole row. For
// o < n_out, out(r, o, v) with v = sum over columns k of h[r][k] W[k * ldw +
// o] + b[o]: each lane sums its columns' products in order, then an xor
// butterfly over the CG lanes, in a fixed order; the group's first lane
// passes each of its rows' outputs to out, once. W and b may be in shared
// or global memory.
template <int RT, int CG, class OUT>
__device__ __forceinline__ void tile_heads(const float (&h)[RT][8], const int (&n)[8], int w, const float* W,
                                           int ldw, const float* b, int n_out, OUT out) {
  for (int o0 = 0; o0 < n_out; o0 += 4) {
    float part[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[r][q] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (n[j] >= w) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (o0 + q >= n_out) continue;
        const float wq = W[n[j] * ldw + o0 + q];
#pragma unroll
        for (int r = 0; r < RT; ++r) part[r][q] = fmaf(h[r][j], wq, part[r][q]);
      }
    }
#pragma unroll
    for (int off = CG / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (o0 + q >= n_out) continue;  // the same for every lane
#pragma unroll
        for (int r = 0; r < RT; ++r) part[r][q] += __shfl_xor_sync(0xffffffffu, part[r][q], off);
      }
    }
    if (threadIdx.x % CG == 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (o0 + q < n_out) out(r, o0 + q, part[r][q] + b[o0 + q]);
        }
      }
    }
  }
}

// out(r, o, v) for the block's rows r < blockDim.x / L and o < n_out, v =
// sum over k < K of A[r * lda + k] W[k * ldw + o] + b[o] (narrow heads): L
// adjacent lanes per row, for up to 4 outputs at once (one load of A feeds
// them all). Lane p's i-th term, k = p + L i, goes to partial sum i % 8,
// each summed in order; the 8 partials are added as a tree, then an xor
// butterfly adds the L lanes', all in a fixed order. So each output is 8 L
// partial sums of K / (8 L) terms, as a warp-wide dot product (mlp.cuh's
// narrow_head) would have it: with one sum a lane the 64-term chains moved
// a squashed log-prob past the act checks (where d logp / d mean ~ 12).
// Every row's lanes work at once: a warp per (row, output) left most lanes
// idle behind its serial shuffles. W and b may be in shared or global
// memory. Each output is passed to out by one lane, once.
template <int L, class OUT>
__device__ __forceinline__ void narrow_rows(const float* A, int lda, int K, const float* W, int ldw,
                                            const float* b, int n_out, OUT out) {
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "L is a power of two up to a warp");
  constexpr int NS = 8;
  const int r = threadIdx.x / L, part = threadIdx.x % L;
  const float* a = A + r * lda;
  for (int o0 = 0; o0 < n_out; o0 += 4) {
    const int no = min(4, n_out - o0);
    float s[4][NS];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[q][j] = 0.0f;
    int k = part;
    for (; k + (NS - 1) * L < K; k += NS * L) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float av = a[k + j * L];
        const float* w = W + (k + j * L) * ldw + o0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < no) s[q][j] = fmaf(av, w[q], s[q][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (k + j * L < K) {
        const float av = a[k + j * L];
        const float* w = W + (k + j * L) * ldw + o0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < no) s[q][j] = fmaf(av, w[q], s[q][j]);
        }
      }
    }
#pragma unroll
    for (int half = NS / 2; half > 0; half >>= 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < half; ++j) s[q][j] += s[q][j + half];
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q][0] += __shfl_xor_sync(0xffffffffu, s[q][0], off);
    }
    if (part == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < no) out(r, o0 + q, s[q][0] + b[o0 + q]);
      }
    }
  }
}

}  // namespace
}  // namespace rl8

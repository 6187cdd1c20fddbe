// Warpgroup tensor-core products (wgmma) in 3xTF32, Hopper's sm_90a only:
// the building block of the discrete act kernel's wgmma route (act.cu).
//
// Replaces, with act.cu, rl8_tpu/ops/fused_act.py:_discrete_act_kernel's
// products (the TPU kernel's jnp.dot on the MXU). Bound on an H100 SXM:
// the twin 256-wide torsos are 2.15 GFLOP at 8,192 rows, 0.0324 ms at the
// CUDA cores' 67 TFLOP/s f32 and 0.0130 ms at three TF32 products per f32
// product at the tensor cores' 495 TFLOP/s; mma.sync, which mma.cuh uses,
// reaches only ~160 TFLOP/s of TF32 on an H100 (PERF.md), under the f32
// rate once tripled, so only wgmma can take such a product below the CUDA
// cores' time.
//
// wgmma.mma_async m64nNk8 .f32.tf32.tf32: a warpgroup (4 warps, 128
// threads) adds a [64, 8] x [8, N] product into a [64, N] f32 accumulator
// held N / 2 floats a thread, asynchronously. TF32 operands in shared
// memory must be K-major (the transpose bits are for 16-bit types only),
// and the flat parameters hold each weight [in, out], N-major for a B
// operand. So a layer is computed transposed, out^T [out, rows] = W^T
// [out, in] x^T [in, rows]: W^T is the A operand, which wgmma also takes
// from registers, so each thread loads its fragment straight from a
// shared-memory slab of W rows and no transposed copy of a weight is made;
// x^T is the B operand, the activations [rows, in], K-major as they stand.
//
// Fragments (PTX ISA, wgmma .m64nNk8 with .tf32), warp w of the warpgroup
// owning rows 16 w .. 16 w + 15, g = lane / 4, t = lane % 4:
//   A [64, 8] (registers): a0 (16w + g, t), a1 (16w + g + 8, t),
//                          a2 (16w + g, t + 4), a3 (16w + g + 8, t + 4);
//   D [64, N]: d[i] at row 16w + g + 8 ((i / 2) % 2), column 8 (i / 4) +
//              2t + i % 2, for i < N / 2.
// B (shared memory, no swizzle, K-major) is read as 8 x 16-byte core
// matrices: 8 of its N columns by 4 k. bt_offset lays out a [rows, K] tile
// so that one k step of 8 is two core matrices LBO = 16 rows bytes apart
// along k, and 8-row groups SBO = 128 bytes apart: [K / 4][rows][4] floats.
//
// 3xTF32: every operand x splits into big = tf32(x) and small = x - big
// (mma.cuh's split_tf32), and a product adds small * big, big * small,
// then big * big. All three go into one accumulator over the whole K: the
// tensor core rounds each step's result toward zero, a bias of a fraction
// of an ulp a step that tests/test_torch_tf32.py's act_torso case holds
// ten times inside the act checks at 8,192 rows of the main path's torsos
// (the update kernels start a fresh accumulator every step instead,
// because their loss sums the bias over 262,144 rows).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rl8 {
namespace {  // each including source gets its own copy

// The descriptor of a no-swizzle (interleaved) K-major operand at smem,
// core matrices lbo bytes apart along k and sbo bytes apart along the
// other dimension (PTX ISA, matrix descriptor: start address, LBO and SBO
// in 16-byte units, layout type 0 in bits 62-63).
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((addr >> 4) & 0x3FFFu) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}

// Orders this thread's register and shared-memory accesses before the
// warpgroup's next wgmma (the accumulators and A fragments it wrote).
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// Waits until at most N of the warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d = a b + (add ? d : 0) for a [64, 8] A fragment in registers (TF32
// bits) and an [8, 64] B operand at desc_b. Starting a sum with add = 0,
// rather than zeroing d, leaves no other instruction writing d between
// the warpgroup's wgmmas (ptxas serializes every wgmma of a kernel that
// has one).
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                    int add = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add)
      : "memory");
}

// d = a b + (add ? d : 0) in 3xTF32: small * big, big * small, then big *
// big, into d.
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[32], const uint32_t (&a_big)[4],
                                             const uint32_t (&a_small)[4], uint64_t b_big, uint64_t b_small,
                                             int add = 1) {
  wgmma_m64n64k8_tf32(d, a_small, b_big, add);
  wgmma_m64n64k8_tf32(d, a_big, b_small);
  wgmma_m64n64k8_tf32(d, a_big, b_big);
}

// Float offset of (row n, k) in a B tile of `rows` rows laid out for
// wgmma_desc(tile + 8 * k_step * rows, 16 * rows, 128): [K / 4][rows][4].
__device__ __forceinline__ int bt_offset(int n, int k, int rows) { return (k >> 2) * 4 * rows + n * 4 + (k & 3); }

// An mbarrier that completes a phase after `count` arrivals (and the bytes
// its arrivals expect).
__device__ __forceinline__ void mbar_init_count(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"((uint32_t)__cvta_generic_to_shared(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"((uint32_t)__cvta_generic_to_shared(bar))
               : "memory");
}

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster meets here; the blocks' shared
// memory accesses before it are visible to the others after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// An arrival on the mbarrier at the same offset as bar in block `rank` of
// the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"((uint32_t)__cvta_generic_to_shared(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// Copies `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// src to dst in every block of the cluster in `mask`, each copy reporting
// its bytes to the mbarrier at bar's offset in its block.
__device__ __forceinline__ void bulk_copy_multicast(float* dst, const float* src, uint32_t bytes, uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], "
      "%4;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
      "l"(src), "r"(bytes), "r"((uint32_t)__cvta_generic_to_shared(bar)), "h"(mask)
      : "memory");
}

// A barrier of the first `threads` threads of the block (named barrier id,
// not 0: __syncthreads' own).
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace
}  // namespace rl8

// Warp-level 3xTF32 products on Hopper's tensor cores, shared by the narrow
// routes of the PPO update kernels (ppo.cu's ppo_rows_kernel, rnn_ppo.cu),
// the tiled chain backward and the recurrent act kernel; and the TF32 split
// and cp.async copies that the wgmma products (wgmma.cuh, stage.cuh,
// wgrad.cuh) use too.
//
// mma.sync m16n8k8 with TF32 operands and f32 accumulators: a warp adds a
// [16, 8] x [8, 8] product into a [16, 8] tile held four floats per lane.
// TF32 keeps 10 mantissa bits, so one product per f32 product would round
// each operand by up to 2^-11 relative. 3xTF32 splits every operand x into
// big = tf32(x) (cvt.rna: the tensor core would otherwise truncate the f32
// bits it is given, and x - big would not be the remainder) and small = x -
// big, and adds small * big + big * small, then big * big, per k step of 8
// into a fresh accumulator, added to the running f32 sum on the CUDA cores:
// the dropped small * small term and the truncation of small leave an error
// near f32's (~2^-21 relative), at three tensor-core products per f32
// product. Its rounding is not f32's, though: see mma_3xtf32.
//
// Fragment layout (PTX ISA, mma.m16n8k8 .tf32), with g = lane / 4 and t =
// lane % 4:
//   A [16, 8]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B [8, 8]:  b0 (t, g), b1 (t + 4, g)   (row k, column n);
//   C [16, 8]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
//
// cp.async stages tiles from device memory into shared memory without
// passing through registers, so that a chunk's loads overlap the products
// on the chunk before it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rl8 {
namespace {  // each including source gets its own copy

// x rounded to nearest (ties away) at TF32's 10 mantissa bits, as the bits
// of an f32 whose low 13 bits are 0 (cleared here rather than left to cvt:
// x - big must see the rounded value; the tensor core ignores them).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = big + small to ~2^-21 relative: big is TF32, small the f32 remainder,
// which the tensor core reads truncated to TF32. The remainder's sign does
// not follow x's, so that truncation leaves no bias, and it saves two
// instructions an operand: rounding it too made the feedforward update
// 10.51 ms against 10.09 on an H100 (kernel_variants.py's round_small),
// whose tiled products wait on these CUDA-core instructions rather than on
// the tensor cores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a b for one m16n8k8 tile, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment split into its big and small halves.
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
};

// A B fragment split into its big and small halves.
struct FragB {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, big[0], small[0]);
    split_tf32(b1, big[1], small[1]);
  }
};

// c += a b at near-f32 accuracy: the small terms first, then big * big,
// into a fresh accumulator that a CUDA-core add (round to nearest) then
// adds to c. The tensor core rounds its f32 result toward zero, not to
// nearest: carried across a long sum in one accumulator, that bias grows
// with the sum (the update's gradients came 2.4e-5 to 4.4e-5 of their norm
// from the plain version's, against 2.8e-6 to 4.7e-6 with this fresh
// accumulator per k step of 8, on an H100: kernel_variants.py's
// accumulate_in_mma). What remains is a bias toward zero of a fraction of
// an ulp of each output: harmless where an output only scales a gradient
// (the weight products, the backward's dh), not where it feeds the loss
// (see ppo.cu's and rnn_ppo.cu's forwards).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a, const FragB& b) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(t, a.small, b.big);
  mma_tf32(t, a.big, b.small);
  mma_tf32(t, a.big, b.big);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copies `bytes` (0 to 16) of src to the 16 bytes at dst and zero-fills the
// rest; dst and src 16-byte aligned (src is not read when bytes is 0).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

// Copies one float (bytes 4) or writes a 0 (bytes 0).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
}  // namespace rl8

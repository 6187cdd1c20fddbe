#!/usr/bin/env python3
"""Time and check design variants of the port's kernels on one card.

Run from the repository root on a machine with a CUDA card and ``nvcc``:
``python3 kernel_variants.py [--kernels ppo,chains,rnn_act,chains_fwd,act,gae,wide,wide_act,ppo_shapes,rnn_ppo,rnn_shapes,rnn_act_shapes,chains_wide] [NAME ...]``
(all variants when no name is given; ``--kernels`` picks what each
variant is measured on, the PPO update kernels when it is not given). Each variant is the checkout's ``rl8_tpu_torch/csrc`` with a few
text substitutions (``VARIANTS`` below), compiled into its own library
under ``build/variants/NAME/`` (only the sources a variant changes are
compiled for it; the others come from one build of the checkout's
sources), all with one ``nvcc`` per source started together. For each variant, at the main paths' shapes (``chip_smoke.py``'s
inputs: 262,144 rows of the discrete feedforward update, 65,536 sequences
of 4 steps of the recurrent one), it prints one JSON line with

- device ms per launch (``chip_smoke.time_ms``) and the split by kernel
  (``torch.profiler``);
- each gradient tensor's norm-relative error against the plain f32
  version and, for the feedforward update, against the plain version in
  float64 (the largest error per chain), and whether two launches gave
  the same bits;
- per kernel, the tensor-core (``HMMA``, and of those ``TF32``), f32 FMA
  (``FFMA``) and local-memory (``LDL``, ``STL``) instructions in its SASS
  (``cuobjdump -sass``), and its block barriers (``BAR``), mbarrier
  operations (``SYNCS``) and TMA copies (``UTMALDG`` tensor-map loads,
  ``UBLKCP`` bulk copies);
- ``nvcc -Xptxas -v``'s registers and spills of the row passes.

With ``chains_wide``, the staged chain routes at ``wide_custom``'s and
``deep_custom``'s shapes (``chains_wide_measure``: the forward's product,
the backward saved and recomputed, a cuBLAS yardstick, and the products of
``fwd_product``'s other callers' shapes); its variants
``chains_fwd_product``, ``chains_ws_stages3``, ``chains_ws_stages6``,
``chains_ws_no_persist`` and ``chains_ws_no_fma`` ablate the forward's
warp-specialised ring.

With ``chains``, the chain backward at MischievousMule's 32,768 rows
(``chip_smoke.py``'s check inputs): ms, split, dx and each gradient
tensor against the plain f32 version and a float64 one, the dx elements
outside the checks' tolerance with the smallest pre-activation margin of
their rows (float64: a relu mask the card's rounding may flip), and bit
identity. With ``rnn_act``, the recurrent act kernel at 8,192 rows of one
256-wide layer: ms and its largest errors against the plain version,
deterministic and draw for draw. With ``chains_fwd``, the chain forward at
MischievousMule's 4,096 and 32,768 rows: ms, split, the largest error
against the plain version and bit identity. With ``act``, the continuous act
kernel (squashed) and the discrete one (A=1, n=2) at 8,192 rows of twin
256-wide torsos: each one's ms, split, largest errors against the plain
version (deterministic and draw for draw) and bit identity. With ``gae``,
the GAE kernel at T = 32 and 512 over 8,192 columns: ms, the largest error
against the plain version and bit identity, and an empty launch of its
grid (``gae_empty_ms``) timed the same way. With ``wide``, the update
kernels' wide routes at the wide cells' shapes (1024 x 262,144 rows,
categorical; H 1024 x 65,536 sequences of 4): ms, split, the gradient's
norm-relative error against the plain version and bit identity. With
``wide_act``, the act kernels' staged routes (``rnn_act`` at H 1024 x
8,192, 1617, 512 and 289 x 4,096; both act kernels, categorical and
squashed, at 1024 x 8,192, 2388 and 384 x 4,096): ms (stochastic), split,
the largest deterministic error against the plain version (log-probs,
values, new states) with the count of differing actions, and bit
identity; its variants ``heads_rows32``, ``staged_stages2`` and
``wide_stages4`` are the staged design's ablations. With ``ppo_shapes``,
the feedforward update's ms at the shapes the route rule decides between
its narrow and staged routes (``PPO_SHAPES``; variants ``staged_at_256``
and ``narrow_rule`` move the rule). With ``rnn_ppo``, the recurrent update
at the main path's shapes, categorical and squashed: ms, split, the worst
gradient tensor's error against the plain version and bit identity; with
``rnn_shapes``, its ms over the ``RNN_SHAPES_*`` grid, and with
``rnn_act_shapes`` the recurrent act kernel's over ``RNN_ACT_SHAPES_*``
(``rnn_wide``: the update at H 1617 x 2,048 sequences, 16 blocks)
(the route rules' evidence: variants ``rnn_staged_at_256``,
``rnn_narrow_rule``, ``rnn_staged_everywhere``, ``rnn_act_staged_at_256``,
``rnn_act_tiles_rule``); ``rnn_act`` also times 4,096 rows and a ragged
1,000 of two layers, each split by kernel. ``rnn_fwd_no_*`` and
``rnn_bwd_no_*`` ablate the recurrent staged route's two kernels' parts,
``rnn_act_no_fold`` gives the act's staged gates their first layer as a
stage of its own. ``rnn_wide_at_256`` and its
ablations ``rnn_wide256_*`` apply to sources that still have the recurrent
update's wide route (``Lo->wide``), where they force it at every width. The SASS counts include
shared-memory loads (``LDS``) and warpgroup tensor-core products
(``HGMMA``); the ptxas lines include its notes of serialized ``wgmma``.

The card's name and power limit come first. It imports neither JAX nor
``rl8_tpu``.
"""

from __future__ import annotations

import inspect
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Each variant: (file in csrc, text in the checkout, its replacement).
_ROWS64 = [
    ("ppo.cu", "constexpr int kRows = 32;", "constexpr int kRows = 64;"),
    ("ppo.cu", "constexpr int kSlice = 16;", "constexpr int kSlice = 32;"),
    ("ppo.cu", "__global__ void __launch_bounds__(kThreads, 2)\n    ppo_rows_kernel(",
     "__global__ void __launch_bounds__(kThreads, 1)\n    ppo_rows_kernel("),
]
# The staged chain forward's products on stage.cuh's fwd_product (the
# design before the warp-specialised ring): a kernel of 256 threads, every
# thread's cp.async and a block barrier a stage, blockIdx.x the 256-column
# tile, blockIdx.y the first 128-row block (stepping by gridDim.y),
# blockIdx.z the product.
_CHAINS_ST_KERNEL = """__global__ void __launch_bounds__(rl8::kStThreads, 1) chains_layer_st_kernel(const __grid_constant__ StProducts ps) {
  constexpr int R = rl8::kStRows;
  extern __shared__ __align__(128) float st_smem[];
  const StProduct p = select_item(ps.p, blockIdx.z);
  const int n0 = blockIdx.x * rl8::kStFwdPass;
  if (n0 >= p.N) return;
  const long long stages = (p.K + rl8::kStK - 1) / rl8::kStK;
  const float* w = p.w + blockIdx.x * stages * rl8::kStFwdWFloats;
  const long long tiles = (ps.rows + R - 1) / R;
  for (long long t = blockIdx.y; t < tiles; t += gridDim.y) {
    const long long r0 = t * R;
    const int nr = (int)min((long long)R, ps.rows - r0);
    const float* in = p.in + r0 * p.ld_in;
    float* out = p.out + r0 * p.ld_out;
    const rl8::FwdSeg seg = {{in, p.ld_in, p.K, nr, rl8::st_vec(in, p.ld_in)}, w};
    rl8::fwd_product(
        &seg, 1, min(rl8::kStFwdPass, p.N - n0), st_smem, [](auto& acc, const int(&)[8]) { rl8::tile_zero(acc); },
        [&](auto& acc, int rg, const int(&n)[8]) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = n0 + n[j];
            if (col >= p.N) continue;
            const float bj = __ldg(p.b + col);
#pragma unroll
            for (int i = 0; i < R / 16; ++i) {
              const int r = rg + 16 * i;
              if (r < nr) out[r * p.ld_out + col] = activate(acc[i][j] + bj, p.act);
            }
          }
        });
  }
}

"""
_CHAINS_FWD_PRODUCT = [
    ("chains.cu", "// One chain's LayerNorm rows for chains_ln_kernel", _CHAINS_ST_KERNEL + "// One chain's LayerNorm rows for chains_ln_kernel"),
    ("chains.cu", "    const long long blocks = tiles > sms ? sms : tiles;\n"
                  "    chains_layer_kernel<<<(unsigned)blocks, rl8::kWsThreads, rl8::kWsSmem, s>>>(t);\n",
     "    cudaFuncSetAttribute(chains_layer_st_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rl8::kStFwdSmem);\n"
     "    chains_layer_st_kernel<<<dim3(t.gx, rl8::st_row_grid(t.rows), t.n), rl8::kStThreads, rl8::kStFwdSmem, s>>>(t);\n"),
]
VARIANTS: dict[str, list[tuple[str, str, str]]] = {
    # The design as checked in.
    "as_is": [],
    # (--kernels chains_wide) The staged chain forward's product: on
    # stage.cuh's fwd_product (no producer warp: every thread's cp.async and
    # a block barrier a stage, one tile a block), with a ring of 3 stages of
    # 32 k or 6 of 16 k instead of 4 of 32, one block a tile instead of
    # persistent blocks, without its FMAs (its copies, ring and stores
    # alone), with a producer warp and no setmaxnreg (288 threads: the launch
    # bound's 224 registers for all), 24/240 registers instead of 40/232,
    # the FMA loop unrolled twice, and its FMAs ordered by weight value.
    "chains_fwd_product": _CHAINS_FWD_PRODUCT,
    "chains_ws_stages3": [("stage.cuh", "constexpr int kWsStages = 4; ", "constexpr int kWsStages = 3; ")],
    "chains_ws_stages6": [("stage.cuh", "constexpr int kWsStages = 4; ", "constexpr int kWsStages = 6; "),
                          ("stage.cuh", "constexpr int kWsK = 32; ", "constexpr int kWsK = 16; ")],
    "chains_ws_no_persist": [("chains.cu", "    const long long blocks = tiles > sms ? sms : tiles;\n",
                              "    const long long blocks = tiles;\n")],
    "chains_ws_warp_producer": [("stage.cuh", "constexpr int kWsThreads = 384; ", "constexpr int kWsThreads = 288; ")],
    "chains_ws_regs240": [("stage.cuh", "constexpr int kWsProducerRegs = 40;", "constexpr int kWsProducerRegs = 24;"),
                          ("stage.cuh", "constexpr int kWsConsumerRegs = 232;", "constexpr int kWsConsumerRegs = 240;")],
    "chains_ws_unroll2": [("stage.cuh", "#pragma unroll 1\n  for (; k + 4 <= K; k += 4) {", "#pragma unroll 2\n  for (; k + 4 <= K; k += 4) {")],
    "chains_ws_w_reuse": [("stage.cuh", '#pragma unroll\n        for (int r = 0; r < RT; ++r) {\n          const float ak = kk == 0 ? a[r].x : kk == 1 ? a[r].y : kk == 2 ? a[r].z : a[r].w;\n          acc[h][r][0] = fmaf(ak, w0.x, acc[h][r][0]);\n          acc[h][r][1] = fmaf(ak, w0.y, acc[h][r][1]);\n          acc[h][r][2] = fmaf(ak, w0.z, acc[h][r][2]);\n          acc[h][r][3] = fmaf(ak, w0.w, acc[h][r][3]);\n          acc[h][r][4] = fmaf(ak, w1.x, acc[h][r][4]);\n          acc[h][r][5] = fmaf(ak, w1.y, acc[h][r][5]);\n          acc[h][r][6] = fmaf(ak, w1.z, acc[h][r][6]);\n          acc[h][r][7] = fmaf(ak, w1.w, acc[h][r][7]);\n        }',
                          '        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};\n#pragma unroll\n        for (int j = 0; j < 8; ++j) {\n#pragma unroll\n          for (int r = 0; r < RT; ++r) {\n            const float ak = kk == 0 ? a[r].x : kk == 1 ? a[r].y : kk == 2 ? a[r].z : a[r].w;\n            acc[h][r][j] = fmaf(ak, wv[j], acc[h][r][j]);\n          }\n        }')],
    "chains_ws_no_fma": [("stage.cuh", "      ws_fma<RT>(acc, rows + rg * kWsK, ws_swizzle(rg), rows + kWsAFloats, kWsK, c0, c1);\n", "")],
    # The feedforward forward's l >= 1 products on the tensor cores too.
    "tc_forward": [(
        "ppo.cu",
        "      dense_layer<kRows>(cur, cur_w, W, W + (size_t)cur_w * w, dst, w, d.act, ld, l == 0 ? 0 : ld);",
        "      if (l == 0) {\n"
        "        dense_layer<kRows>(cur, cur_w, W, W + (size_t)cur_w * w, dst, w, d.act, ld, 0);\n"
        "      } else {\n"
        "        tc_dense(cur, cur_w, ld, W, w, dst, ld, ws);\n"
        "        __syncthreads();\n"
        "        for (int k = threadIdx.x; k < w; k += blockDim.x)\n"
        "          for (int r = 0; r < kRows; ++r)\n"
        "            dst[r * ld + k] = rl8::activate(dst[r * ld + k] + __ldg(W + (size_t)cur_w * w + k), d.act);\n"
        "      }",
    )],
    # Every 3xTF32 product accumulated in the tensor core's own accumulator
    # across the whole reduction, with no fresh accumulator per k step.
    "accumulate_in_mma": [(
        "mma.cuh",
        "  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n  mma_tf32(t, a.small, b.big);\n  mma_tf32(t, a.big, b.small);\n"
        "  mma_tf32(t, a.big, b.big);\n#pragma unroll\n  for (int e = 0; e < 4; ++e) c[e] += t[e];",
        "  mma_tf32(c, a.small, b.big);\n  mma_tf32(c, a.big, b.small);\n  mma_tf32(c, a.big, b.big);",
    )],
    # The remainder rounded to TF32 with cvt.rna too.
    "round_small": [(
        "mma.cuh",
        "  small = __float_as_uint(x - __uint_as_float(big));",
        "  small = tf32_rna(x - __uint_as_float(big));",
    )],
    # 64 rows a feedforward row-pass block (32-row weight stages), one block to an SM.
    "ff_rows64": _ROWS64,
    # The feedforward update's route rule: the staged route at every shape
    # (staged_at_256), and the narrow route wherever its shared memory fits
    # (narrow_rule: the rule before the staged route took the minibatches of
    # 16,384 rows and more).
    "staged_at_256": [("ppo.cu", "  L->staged = L->smem > kMaxSmem || (N >= kStagedMinRows && d.max_hidden >= kStagedMinWidth);", "  L->staged = true;")],
    # The staged update kernels' weight slabs by every thread's cp.async
    # instead of bulk copies.
    "staged_cp_async": [("ppo.cu", "constexpr bool kBulkSlabs = true;", "constexpr bool kBulkSlabs = false;")],
    "narrow_rule": [("ppo.cu", "  L->staged = L->smem > kMaxSmem || (N >= kStagedMinRows && d.max_hidden >= kStagedMinWidth);", "  L->staged = L->smem > kMaxSmem;")],
    # Ablations of the staged row pass (ppo_staged_*_kernel; wrong results,
    # times only): no forward FMAs, no heads, no top-layer dpre, no loss
    # terms, no dh products; and of the wgmma weight products: no products,
    # no conversion of the B chunks.
    "staged_no_fwd_fma": [("stage.cuh", "        tile_fma<RT>(acc[h], st + rg * kStLdA, 16 * kStLdA, st + kStAFloats, kStFwdPass, kStK, c0 + 128 * h,\n"
                           "                     c1 + 128 * h);\n", "")],
    "staged_no_heads": [("ppo.cu", "              if (lane == 0 && o0 + q < n_out) zs[r * n_out + o0 + q] = sq[q] + hb(o0 + q);\n", "")],
    "staged_no_top_dpre": [("ppo.cu", "        for (int k = threadIdx.x; k < cur_w; k += blockDim.x) {\n          for (int r8 = 0;",
                            "        for (int k = threadIdx.x; k < cur_w && R < 0; k += blockDim.x) {\n          for (int r8 = 0;")],
    "staged_no_loss": [("ppo.cu", "        if (threadIdx.x < er) {\n          const int r = rc + threadIdx.x;",
                        "        if (threadIdx.x < er && R < 0) {\n          const int r = rc + threadIdx.x;")],
    "staged_no_bwd_mma": [("stage.cuh", "        wgmma_3xtf32(acc[h], a_big[ks], a_small[ks], db, ds, add);\n", "")],
    "wgrad_no_mma": [("wgrad.cuh", "        wgmma_3xtf32(acc[h], a_big[ks], a_small[ks], db, ds, ks > 0);", "")],
    "wgrad_no_convert": [("wgrad.cuh", "      convert(c + 1);\n", ""), ("wgrad.cuh", "    convert(0);\n", "")],
    # The chain backward's forward recompute on the tensor cores (3xTF32)
    # instead of f32 FMAs.
    "chains_tc_forward": [(
        "chains.cu",
        "      forward_rows(in, ld_in, t.in[l], W, ldw, bv, w, h, ld, ln, act);",
        "      row_product(in, ld_in, t.in[l], w, [&](int k, int n) { return W[k * ldw + n]; },\n"
        "                  [&](int r, int n, float v) { h[r * ld + n] = ln ? v + bv[n] : activate(v + bv[n], act); });",
    )],
    # The tiled chain backward's k loops not unrolled.
    "chains_no_unroll": [("chains.cu", "#pragma unroll 2\n  for (int kb = 0; kb < K; kb += 8) {",
                          "  for (int kb = 0; kb < K; kb += 8) {")],
    # The recurrent act kernel's weights three and four k steps ahead.
    "rnn_act_ahead3": [("rnn_act.cu", "constexpr int kAhead = 2;", "constexpr int kAhead = 3;")],
    "rnn_act_ahead4": [("rnn_act.cu", "constexpr int kAhead = 2;", "constexpr int kAhead = 4;")],
    # Ablations of the tiled chain backward (wrong results; their times
    # against as_is split the kernel's time by phase): no weight products,
    # no column sums, no dh products, no forward recompute products, no dx.
    "chains_no_wgrad": [("chains.cu", "      weight_product(hin, ld_in, in_w, cot, ldc, nc, Gw, ldwc);\n", "")],
    "chains_no_colsums": [
        ("chains.cu", "      column_sums(cot, ldc, nullptr, nc, Gb);\n", ""),
        ("chains.cu", "        column_sums(h, ld, xh, w, Gs + t.sv[l] + w);\n"
                      "        column_sums(h, ld, nullptr, w, Gs + t.sv[l] + 2 * w);\n", ""),
    ],
    "chains_no_dh": [("chains.cu", "      row_product(cot, ldc, nc, w, [&]", "      if (l > 100) row_product(cot, ldc, nc, w, [&]")],
    "chains_no_forward": [("chains.cu", "      forward_rows(in, ld_in, t.in[l], W, ldw, bv, w, h, ld, ln, act);\n", "")],
    "chains_no_dx": [("chains.cu", "        row_product(cot, ldc, nc, d_in, [&]", "        if (l > 100) row_product(cot, ldc, nc, d_in, [&]")],
    # The chain backward's and the recurrent act kernel's 3xTF32 products
    # as three independent mma.sync each, in fresh accumulators summed on
    # the CUDA cores (no product waits on another's result).
    "mma_independent": [
        ("mma.cuh", "__device__ __forceinline__ uint32_t smem_addr(const void* p) {",
         "__device__ __forceinline__ void mma_3xtf32_independent(float (&c)[4], const FragA& a, const FragB& b) {\n"
         "  float t0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, t1[4] = {0.0f, 0.0f, 0.0f, 0.0f}, t2[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"
         "  mma_tf32(t0, a.small, b.big);\n  mma_tf32(t1, a.big, b.small);\n  mma_tf32(t2, a.big, b.big);\n"
         "#pragma unroll\n  for (int e = 0; e < 4; ++e) c[e] += (t0[e] + t1[e]) + t2[e];\n}\n\n"
         "__device__ __forceinline__ uint32_t smem_addr(const void* p) {"),
        ("chains.cu", "rl8::mma_3xtf32(", "rl8::mma_3xtf32_independent("),
        ("rnn_act.cu", "rl8::mma_3xtf32(", "rl8::mma_3xtf32_independent("),
    ],
    # 256 threads a tiled chain-backward block.
    "chains_256": [("chains.cu", "constexpr int kTileThreads = 512;", "constexpr int kTileThreads = 256;")],
    # 64-row recurrent act tiles, one block to an SM (and its registers).
    "rnn_act_rows64": [
        ("rnn_act.cu", "constexpr int kRows = 32; ", "constexpr int kRows = 64; "),
        ("rnn_act.cu", "smem_floats(*d) <= kTwoBlocksSmem ? 2 : 1", "smem_floats(*d) <= 227 * 1024 ? 2 : 1"),
        ("rnn_act.cu", "__global__ void __launch_bounds__(kThreads, 2)\n    rnn_act_kernel(",
         "__global__ void __launch_bounds__(kThreads, 1)\n    rnn_act_kernel("),
    ],
    # Ablations of the recurrent act kernel (wrong results; times only):
    # constant weights in place of the L2 loads, and the products replaced
    # by one integer op per tile (fragment loads and splits kept).
    "rnn_act_no_weight_loads": [
        ("rnn_act.cu", "bn[q][0] = in_units && k < K ? __ldg(w) : 0.0f;", "bn[q][0] = in_units && k < K ? 0.5f : 0.0f;"),
        ("rnn_act.cu", "bn[q][1] = in_units && k + 4 < K ? __ldg(w + 4 * ldw) : 0.0f;",
         "bn[q][1] = in_units && k + 4 < K ? 0.25f : 0.0f;"),
    ],
    "rnn_act_no_mma": [(
        "rnn_act.cu", "for (int mt = 0; mt < MT; ++mt) rl8::mma_3xtf32(acc[mt][q], fa[mt], fb[q]);",
        "for (int mt = 0; mt < MT; ++mt) acc[mt][q][0] += __uint_as_float(fa[mt].big[0] & fb[q].small[1]);",
    )],
    # 16-row recurrent act tiles.
    "rnn_act_rows16": [("rnn_act.cu", "constexpr int kRows = 32; ", "constexpr int kRows = 16; ")],
    # Ablations of the chain forward's tiled route (wrong results; their
    # times against as_is split the kernel's time): no layer products, no
    # parameter loads, no (fused) LayerNorm, no (fused) narrow heads.
    "fwd_no_product": [("chains.cu", "        rl8::tile_fma<RT>(acc, cur + rg * RT * cur_ld, cur_ld, W, ldw, cur_w,",
                        "        if (l > 100) rl8::tile_fma<RT>(acc, cur + rg * RT * cur_ld, cur_ld, W, ldw, cur_w,")],
    "fwd_no_param_load": [("chains.cu", "  load_segments(t.seg, t.n_seg, params, smem);\n", "")],
    "fwd_no_layer_norm": [("chains.cu", "        if (ln && one_pass) fused_layer_norm<RT, CG, ACT>(acc, n, w, bv + w, bv + 2 * w);\n", "")],
    "fwd_no_heads": [("chains.cu", "          fused_heads<RT, CG>(acc, n, w, t, smem, r0, rg * RT, nr);\n", "")],
    # The chain forward's tiled route at 32-row tiles (128 threads: 8 warps
    # an SM).
    "fwd_rows32": [("chains.cu", "constexpr int kFwdTileRows = 64;", "constexpr int kFwdTileRows = 32;")],
    # Ablations of the continuous act kernel's tiled route: no products, no
    # weight-slab copies, no heads, no epilogue (sampling and log-probs).
    "act_no_product": [("act.cu", "    rl8::tile_fma<RT>(acc, in + rg * RT * ld + k0,", "    if (g > 1000) rl8::tile_fma<RT>(acc, in + rg * RT * ld + k0,")],
    "act_no_slab_loads": [
        ("act.cu", "        rl8::mbar_expect(bar, rows * bytes);", "        rl8::mbar_expect(bar, 0u);"),
        ("act.cu", "        if (w == kTileWidth) {\n          rl8::bulk_copy(", "        if (w < 0) {\n          rl8::bulk_copy("),
        ("act.cu", "          for (int r = 0; r < rows; ++r) rl8::bulk_copy(", "          for (int r = 0; r < 0; ++r) rl8::bulk_copy("),
        ("act.cu", "    } else {\n      const int lane64", "    } else if (g < 0) {\n      const int lane64"),
    ],
    # The continuous act kernel's slabs all by every thread's cp.async copies.
    "act_cp_async": [("act.cu", "P->bulk[q] = P->out_w[q] % 4 == 0 && P->woff[q] % 4 == 0;", "P->bulk[q] = 0;")],
    "act_no_heads": [("act.cu", "        rl8::tile_heads<RT, CG>(acc, n, w, W, n_out,", "        if (j > 100) rl8::tile_heads<RT, CG>(acc, n, w, W, n_out,")],
    "act_no_epilogue": [("act.cu", "    __syncthreads();\n  }\n  if constexpr (CATEGORICAL) {",
                         "    __syncthreads();\n  }\n  if (B >= 0) return;\n  if constexpr (CATEGORICAL) {")],
    # The continuous act kernel's tiled route with slabs of 16 rows, with two
    # slabs (one in flight), and with 32-row tiles (128 threads).
    "act_slab16": [("act.cu", "constexpr int kSlabK = 32;", "constexpr int kSlabK = 16;")],
    "act_stages2": [("act.cu", "constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    # The continuous act kernel's tiled route with 4 rows a thread (512 threads).
    "act_rt4": [("act.cu", "constexpr int kTileRT = 8;", "constexpr int kTileRT = 4;")],
    "act_rows32": [("act.cu", "constexpr int kTileRows = 64;", "constexpr int kTileRows = 32;")],
    # The discrete act kernel on the tiled f32 route (the yardstick of its
    # wgmma route).
    "act_discrete_tiled": [("act.cu", "if ((reinterpret_cast<uintptr_t>(params) & 15) == 0 && make_wgmma_plan(d, A, &W)) {",
                            "if (B < 0 && make_wgmma_plan(d, A, &W)) {")],
    # Ablations of the wgmma route (wrong results; times only): no products
    # (the fragments' loads and splits kept), one TF32 product per f32
    # product (big * big: the other two products' cost), no slab copies, no
    # heads.
    "act_wg_no_product": [("act.cu", "for (int mt = 0; mt < 2; ++mt) rl8::wgmma_3xtf32(acc[mt], a_big[ks][mt], a_small[ks][mt], db, ds, add);",
                           "for (int mt = 0; mt < 2; ++mt) acc[mt][ks] += __uint_as_float((a_big[ks][mt][0] ^ a_small[ks][mt][1]"
                           " ^ a_big[ks][mt][2] ^ a_small[ks][mt][3]) & (uint32_t)(db ^ ds ^ add));")],
    "act_wg_1xtf32": [("wgmma.cuh", "  wgmma_m64n64k8_tf32(d, a_small, b_big, add);\n  wgmma_m64n64k8_tf32(d, a_big, b_small);\n  wgmma_m64n64k8_tf32(d, a_big, b_big);",
                       "  wgmma_m64n64k8_tf32(d, a_big, b_big, add);")],
    "act_wg_no_slab_loads": [
        ("act.cu", "    rl8::mbar_expect(&full[st], total);", "    rl8::mbar_expect(&full[st], 0u * total);"),
        ("act.cu", "  if (bytes && (uint32_t)(lane & 1) == rank) {", "  if (lane < 0 && bytes && (uint32_t)(lane & 1) == rank) {"),
    ],
    "act_wg_no_heads": [("act.cu", "          for (int o = 0; o < n_out; ++o) {\n            float wf[2][2];",
                         "          for (int o = 0; o < n_out && B < 0; ++o) {\n            float wf[2][2];")],
    # The wgmma route with 32-row slabs, two of them (ptxas spills at its
    # 168 registers); with five 16-row slabs.
    "act_wg_slab32": [("act.cu", "constexpr int kWgSlabK = 16;", "constexpr int kWgSlabK = 32;"),
                      ("act.cu", "constexpr int kWgStages = 4;", "constexpr int kWgStages = 2;")],
    "act_wg_stages5": [("act.cu", "constexpr int kWgStages = 4;", "constexpr int kWgStages = 5;")],
    # Every block copies every row of its slabs itself (still in clusters
    # of two): each block reads all the weights from L2.
    "act_wg_no_multicast": [
        ("act.cu", "  if (bytes && (uint32_t)(lane & 1) == rank) {\n    rl8::bulk_copy_multicast(slabs + st * kWgSlabFloats + lane * kWgLdw, params + (e - shift), bytes, &full[st], 0x3);",
         "  if (bytes) {\n    rl8::bulk_copy(slabs + st * kWgSlabFloats + lane * kWgLdw, params + (e - shift), bytes, &full[st]);"),
        ("act.cu", "            rl8::mbar_arrive_cluster(&empty[st], rank ^ 1u);\n", ""),
        ("act.cu", "      rl8::mbar_init_count(&empty[s], 2 * kWgConsumers / 32);", "      rl8::mbar_init_count(&empty[s], kWgConsumers / 32);"),
    ],
    # GAE: 32 columns a block; 128 columns a block with chunks of 16 time
    # steps (a block's static shared memory is at most 48 KB); chunks of 16,
    # and of 64 with 32 columns a block; three chunks in flight.
    "gae_cols32": [("gae.cu", "constexpr int kCols = 64;", "constexpr int kCols = 32;")],
    "gae_cols128_chunk16": [("gae.cu", "constexpr int kCols = 64;", "constexpr int kCols = 128;"),
                            ("gae.cu", "constexpr int kChunk = 32;", "constexpr int kChunk = 16;")],
    "gae_chunk16": [("gae.cu", "constexpr int kChunk = 32;", "constexpr int kChunk = 16;")],
    "gae_cols32_chunk64": [("gae.cu", "constexpr int kCols = 64;", "constexpr int kCols = 32;"),
                           ("gae.cu", "constexpr int kChunk = 32;", "constexpr int kChunk = 64;")],
    "gae_stages3": [("gae.cu", "constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    # Ablations of the update kernels' wide routes (stage.cuh; times only,
    # wrong results): no forward products, no backward products.
    "wide_no_fwd_fma": [("stage.cuh", "        tile_fma<RT>(acc[h], st + rg * kStLdA, 16 * kStLdA, st + kStAFloats, kStFwdPass, kStK, c0 + 128 * h,\n"
                         "                     c1 + 128 * h);\n",
                         "")],
    "wide_no_bwd_mma": [("stage.cuh", "        wgmma_3xtf32(acc[h], a_big[ks], a_small[ks], db, ds, add);\n", "")],
    # No weight slab copies, or no activation slab copies (the products
    # read what the ring held before).
    "wide_no_w_loads": [
        ("stage.cuh", "    for (int i = 0; i < n; ++i) st_load_run(dst[i], src[i], floats);\n", ""),
        ("stage.cuh", "    mbar_expect(&ring->bar[st], n * bytes);\n    for (int i = 0; i < n; ++i) bulk_copy(dst[i], src[i], bytes, &ring->bar[st]);\n",
         "    mbar_expect(&ring->bar[st], 0u);\n"),
    ],
    "wide_no_a_loads": [
        ("stage.cuh", "      st_load_rows(st, seg[q].a, sq * kStK);\n", ""),
        ("stage.cuh", "      st_load_rows(st, a, (it % S) * kStK);\n", ""),
    ],
    # Four stages in the wide routes' ring.
    "wide_stages4": [("stage.cuh", "constexpr int kStStages = 3; ", "constexpr int kStStages = 4; ")],
    # The act kernels' staged routes (stage.cuh; times and errors with
    # --kernels wide_act): the heads kernels with 32 rows a block instead of
    # 8, and two stages in the ring (wide_stages4 above: four).
    "heads_rows32": [("rnn_act.cu", "constexpr int kHeadRows = 8;", "constexpr int kHeadRows = 32;"),
                     ("act.cu", "constexpr int kHeadRows = 8;", "constexpr int kHeadRows = 32;")],
    "staged_stages2": [("stage.cuh", "constexpr int kStStages = 3; ", "constexpr int kStStages = 2; ")],
    # The recurrent kernels' route rules: the update's 128-sequence route at
    # every width (rnn_wide_at_256) and the act kernel's staged route at
    # every shape (rnn_act_staged_at_256).
    "rnn_wide_at_256": [("rnn_ppo.cu", "  Lo->wide = Lo->smem > kMaxSmem;", "  Lo->wide = true;")],
    "rnn_act_staged_at_256": [("rnn_act.cu", "  return sizeof(float) * smem_floats(*d) <= kTwoBlocksSmem ? 2 : 1;",
                               "  return 1;")],
    # The act kernel's 32-row tiles wherever they fit (the rule before the
    # staged route took H from 128).
    "rnn_act_tiles_rule": [("rnn_act.cu", "  if (H >= kStagedMinWidth) return 1;\n", "")],
    # The staged gates' first layer as a 32-deep stage of its own (and a
    # copy of its Wi), not summed in the epilogue.
    "rnn_act_no_fold": [("rnn_act.cu", "    const int fold = l == 0 && in_w <= kFoldInputs;", "    const int fold = 0;")],

    # Ablations of the 128-sequence route at 256 wide (wrong results; times
    # only): no forward FMAs, no dh products.
    "rnn_wide256_no_fwd_fma": [("rnn_ppo.cu", "  Lo->wide = Lo->smem > kMaxSmem;", "  Lo->wide = true;"),
                               ("stage.cuh", "        tile_fma<RT>(acc[h], st + rg * kStLdA, 16 * kStLdA, st + kStAFloats, kStFwdPass, kStK, c0 + 128 * h,\n"
                                "                     c1 + 128 * h);\n", "")],
    "rnn_wide256_no_bwd_mma": [("rnn_ppo.cu", "  Lo->wide = Lo->smem > kMaxSmem;", "  Lo->wide = true;"),
                               ("stage.cuh", "        wgmma_3xtf32(acc[h], a_big[ks], a_small[ks], db, ds, add);\n", "")],
    # The recurrent update's route rule on these sources: the staged route
    # at every shape, and the narrow route wherever its shared memory fits;
    # the staged kernels' weight slabs by every thread's cp.async.
    "rnn_staged_at_256": [("rnn_ppo.cu", "  Lo->staged = Lo->smem > kMaxSmem || ((long long)N >= kStagedMinRows && H >= kStagedMinWidth);",
                           "  Lo->staged = true;")],
    "rnn_narrow_rule": [("rnn_ppo.cu", "  Lo->staged = Lo->smem > kMaxSmem || ((long long)N >= kStagedMinRows && H >= kStagedMinWidth);",
                         "  Lo->staged = Lo->smem > kMaxSmem;")],
    "rnn_staged_cp_async": [("rnn_ppo.cu", "constexpr bool kBulkSlabs = true;", "constexpr bool kBulkSlabs = false;")],
    # The staged forward's head weights read from L2 instead of shared
    # memory.
    "rnn_no_wstaged": [("rnn_ppo.cu", "    d.wstaged = base + heads <= kMaxSmem;", "    d.wstaged = false;")],
    # Both recurrent kernels' staged routes at every shape.
    "rnn_staged_everywhere": [
        ("rnn_ppo.cu", "  Lo->staged = Lo->smem > kMaxSmem || ((long long)N >= kStagedMinRows && H >= kStagedMinWidth);",
         "  Lo->staged = true;"),
        ("rnn_act.cu", "  return sizeof(float) * smem_floats(*d) <= kTwoBlocksSmem ? 2 : 1;", "  return 1;")],
    # Ablations of the staged route's forward kernel (wrong results; times
    # only): no FMAs and no row (A) or weight loads; no heads and loss
    # epilogue, no loss terms, no heads.
    "rnn_fwd_no_fma_no_a": [
        ("stage.cuh", "        tile_fma<RT>(acc[h], st + rg * kStLdA, 16 * kStLdA, st + kStAFloats, kStFwdPass, kStK, c0 + 128 * h,\n"
         "                     c1 + 128 * h);\n", ""),
        ("stage.cuh", "      st_load_rows(st, seg[q].a, sq * kStK);\n", "")],
    "rnn_fwd_no_fma_no_w": [
        ("stage.cuh", "        tile_fma<RT>(acc[h], st + rg * kStLdA, 16 * kStLdA, st + kStAFloats, kStFwdPass, kStK, c0 + 128 * h,\n"
         "                     c1 + 128 * h);\n", ""),
        ("stage.cuh", "    for (int i = 0; i < n; ++i) st_load_run(dst[i], src[i], floats);\n", ""),
        ("stage.cuh", "    mbar_expect(&ring->bar[st], n * bytes);\n    for (int i = 0; i < n; ++i) bulk_copy(dst[i], src[i], bytes, &ring->bar[st]);\n",
         "    mbar_expect(&ring->bar[st], 0u);\n")],
    "rnn_fwd_no_epilogue": [("rnn_ppo.cu", "      for (int rc = 0; rc < R; rc += d.erows) {", "      for (int rc = 0; rc < 0; rc += d.erows) {")],
    "rnn_fwd_no_loss": [("rnn_ppo.cu", "        if (threadIdx.x < er) {\n          const int r = rc + threadIdx.x;",
                         "        if (threadIdx.x < er && R < 0) {\n          const int r = rc + threadIdx.x;")],
    "rnn_fwd_no_heads": [("rnn_ppo.cu", "              if (lane == 0 && o0 + q < n_out) zs[r * zld + o0 + q] = sq[q] + hb(o0 + q);\n", "")],
    # Ablations of the staged route's backward kernel: no cell backward, no
    # heads' cotangent.
    "rnn_bwd_no_cell": [("rnn_ppo.cu", "        const int G = H / 4, n = R * G;", "        const int G = H / 4, n = 0;")],
    "rnn_bwd_no_heads": [("rnn_ppo.cu", "      for (int j = threadIdx.x; j < H; j += blockDim.x) {\n        for (int rc = 0; rc < R; rc += 32) {",
                          "      for (int j = threadIdx.x; j < 0; j += blockDim.x) {\n        for (int rc = 0; rc < R; rc += 32) {")],
    # The recurrent act kernel's staged route at 256 wide with four stages,
    # and with its weight slabs by every thread's cp.async.
    "rnn_act_staged_256_stages4": [
        ("rnn_act.cu", "  return sizeof(float) * smem_floats(*d) <= kTwoBlocksSmem ? 2 : 1;", "  return 1;"),
        ("stage.cuh", "constexpr int kStStages = 3; ", "constexpr int kStStages = 4; ")],
    "rnn_act_staged_256_cp_async": [
        ("rnn_act.cu", "  return sizeof(float) * smem_floats(*d) <= kTwoBlocksSmem ? 2 : 1;", "  return 1;"),
        ("rnn_act.cu", "constexpr bool kBulkSlabs = true;", "constexpr bool kBulkSlabs = false;")],
    # 32 sequences a recurrent row-pass block, one block to an SM.
    "rnn_rows32": [
        ("rnn_ppo.cu", "constexpr int kRows = 16;  // sequences", "constexpr int kRows = 32;  // sequences"),
        ("rnn_ppo.cu", "__global__ void __launch_bounds__(kThreads, 2)\n    rnn_rows_kernel(",
         "__global__ void __launch_bounds__(kThreads, 1)\n    rnn_rows_kernel("),
    ],
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def build_all(names: list[str]) -> dict[str, tuple[Path, dict[str, str]]]:
    """Each variant's library and each source's ptxas report. The
    checkout's sources are compiled once (``build/variants/_base``); a
    variant compiles only the sources its substitutions change (all of
    them where it changes a header) and links the base's other objects.
    Every compile of every variant starts at once."""
    from rl8_tpu_torch.ops import _build

    root = REPO / "build" / "variants"
    nvcc = _build._nvcc()
    jobs: dict[tuple[str, str], Path] = {}  # (variant, stem) -> the source to compile
    dirs = {}
    for name in ["_base", *names]:
        src = root / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        changed = set()
        for file, old, new in VARIANTS.get(name, []):
            text = (src / file).read_text()
            if old not in text:
                raise RuntimeError(f"variant {name}: {file} has no {old[:60]!r}")
            (src / file).write_text(text.replace(old, new))
            changed.add(file)
        dirs[name] = src
        for cu in sorted(src.glob("*.cu")):
            if name == "_base" or cu.name in changed or any(f.endswith(".cuh") for f in changed):
                jobs[(name, cu.stem)] = cu
    procs = {key: subprocess.Popen([nvcc, *_build._FLAGS, "-c", str(cu), "-o", str(cu.with_suffix(".o"))],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for key, cu in jobs.items()}
    logs = {key: proc.communicate()[0] for key, proc in procs.items()}
    for (name, stem), proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed on {stem}.cu:\n{logs[(name, stem)]}")
    built = {}
    for name in names:
        objects, variant_logs = [], {}
        for cu in sorted(dirs[name].glob("*.cu")):
            owner = name if (name, cu.stem) in jobs else "_base"
            objects.append(str(dirs[owner] / f"{cu.stem}.o"))
            variant_logs[cu.stem] = logs[(owner, cu.stem)]
        lib = dirs[name] / "lib.so"
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", *objects, "-o", str(lib)],
                       check=True)
        built[name] = (lib, variant_logs)
    return built


def short(kernel: str) -> str | None:
    m = re.search(r"(ppo_rows_kernel<[^>]*>|rnn_rows_kernel<[^>]*>|ppo_staged_fwd_kernel<[^>]*>|ppo_staged_bwd_kernel|rnn_wide_fwd_kernel<[^>]*>|rnn_wide_bwd_kernel|"
                  r"rnn_staged_fwd_kernel<[^>]*>|rnn_staged_bwd_kernel|"
                  r"tile_fwd_kernel|tile_bwd_kernel|reduce_wgmma_kernel<\w+>|reduce_small_kernel|"
                  r"sum_partials_kernel|sum_stats_kernel|transpose_kernel|chains_\w*kernel|"
                  r"sum_chain_dx_kernel|rnn_act_kernel<[^>]*>|continuous_act_\w*kernel|discrete_act_\w*kernel|gae_kernel|"
                  r"rnn_gates_\w*kernel|rnn_heads_kernel<\w+>|act_layer_\w*kernel|act_heads_kernel<\w+>|tile_tc_kernel)", kernel)
    return m.group(1) if m else None


def sass_counts(lib: Path) -> dict[str, dict[str, int]]:
    from rl8_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    fn = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            source = re.search(r"(ppo|rnn_ppo|chains|rnn_act|act|gae)_cu", fn)
            kernel = re.search(r"(ppo_rows_kernel|rnn_rows_kernel|ppo_staged_\w+?_kernel|rnn_wide_\w+?_kernel|rnn_staged_\w+?_kernel|reduce_wgmma_kernel|reduce_small_kernel|chains_bwd_\w+?_kernel|"
                               r"chains_fwd_\w*?kernel|chains_(?:layer|layer_st|dh|ln|ln_bwd|heads|dx)_kernel|continuous_act_\w*?kernel|discrete_act_\w*?kernel|"
                               r"rnn_act_kernel|gae_kernel|rnn_gates_\w*?kernel|rnn_heads_kernel|act_layer_\w*?kernel|"
                               r"act_heads_kernel)(I\w*)?", fn)
            args = ",".join(re.findall(r"L[ib](\d+)E", kernel.group(2) or "")) if kernel else ""
            fn = f"{source.group(1)}.cu {kernel.group(1)}<{args}>" if source and kernel else None
            continue
        if fn and re.search(r"HGMMA|HMMA|FFMA|LDL|STL|\bLDS\b|\bBAR\.|UTMALDG|UBLKCP|SYNCS", line):
            c = counts.setdefault(fn, {"HGMMA": 0, "HMMA": 0, "HMMA_TF32": 0, "FFMA": 0, "LDS": 0, "local": 0,
                                       "BAR": 0, "UTMALDG": 0, "UBLKCP": 0, "SYNCS": 0})
            if re.search(r"\bBAR\.", line):
                c["BAR"] += 1
            elif "UTMALDG" in line:
                c["UTMALDG"] += 1
            elif "UBLKCP" in line:
                c["UBLKCP"] += 1
            elif "SYNCS" in line:
                c["SYNCS"] += 1
            elif "HGMMA" in line:
                c["HGMMA"] += 1
            elif "HMMA" in line:
                c["HMMA"] += 1
                c["HMMA_TF32"] += "TF32" in line
            elif "FFMA" in line:
                c["FFMA"] += 1
            elif re.search(r"\bLDS\b", line):
                c["LDS"] += 1
            else:
                c["local"] += 1
    return counts


def ptxas_rows(logs: dict[str, str]) -> list[str]:
    out, fn = [], None
    for stem in ("ppo", "rnn_ppo", "chains", "rnn_act", "act", "gae"):
        for line in logs[stem].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1) if re.search(r"rows_kernel|staged_\w+_kernel|wide_fwd_kernel|wide_bwd_kernel|tiles_kernel|act_kernel|wgmma_kernel|"
                                             r"chains_\w*kernel|gae_kernel|gates_\w*kernel|layer_\w*kernel|heads_kernel",
                                             m.group(1)) else None
            elif fn and ("registers" in line or "spill stores" in line):
                name = re.search(r"(rnn_gates_tc_kernel|rnn_heads_kernel|rnn_staged_fwd_kernel(?:ILb[01])?|"
                                 r"rnn_staged_bwd_kernel|rnn_rows_kernel(?:ILb[01])?|act_layer_tc_kernel|"
                                 r"act_layer_kernel|act_heads_kernel)", fn)
                where = f"{stem}.cu {name.group(1)}" if name else f"{stem}.cu"
                out.append(f"{where}: {line.strip().replace('ptxas info    : ', '')}")
            elif "serialized" in line:
                out.append(f"{stem}.cu: {line.strip().replace('ptxas info    : ', '')[:160]}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from rl8_tpu_torch.ops import _build
    from torch.profiler import ProfilerActivity, profile

    args = sys.argv[1:]
    kinds = {"ppo"}
    if args[:1] == ["--kernels"]:
        kinds, args = set(args[1].split(",")), args[2:]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 check=True, capture_output=True, text=True).stdout.strip()})
    names = args or list(VARIANTS)
    built = build_all(names)

    def split(fn) -> dict[str, float]:
        """The device ms of one call of fn by kernel: the fullest of three
        profiled calls (the profiler sometimes drops a window's records)."""
        best: dict[str, float] = {}
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            out: dict[str, float] = {}
            for e in prof.key_averages():
                name = short(e.key)
                if name and e.self_device_time_total > 0:
                    out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
            if sum(out.values()) > sum(best.values()):
                best = out
        return best

    measures = []
    if "ppo" in kinds:
        measures.append(ppo_measure(torch, dev, split))
    if "chains" in kinds:
        measures.append(chains_measure(torch, dev, split))
    if "rnn_act" in kinds:
        measures.append(rnn_act_measure(torch, dev, split))
    if "chains_fwd" in kinds:
        measures.append(chains_fwd_measure(torch, dev, split))
    if "act" in kinds:
        measures.append(act_measure(torch, dev, split))
    if "gae" in kinds:
        measures.append(gae_measure(torch, dev))
    if "wide" in kinds:
        measures.append(wide_measure(torch, dev, split))
    if "wide_act" in kinds:
        measures.append(wide_act_measure(torch, dev, split))
    if "ppo_shapes" in kinds:
        measures.append(ppo_shapes_measure(torch, dev))
    if "rnn_ppo" in kinds:
        measures.append(rnn_ppo_measure(torch, dev, split))
    if "rnn_shapes" in kinds:
        measures.append(rnn_shapes_measure(torch, dev))
    if "rnn_act_shapes" in kinds:
        measures.append(rnn_act_shapes_measure(torch, dev))
    if "rnn_wide" in kinds:
        measures.append(rnn_wide_measure(torch, dev, split))
    if "chains_wide" in kinds:
        measures.append(chains_wide_measure(torch, dev, split))
    for name, (lib, logs) in built.items():
        _build._lib = None
        _build.build = lambda lib=lib: lib
        record = {"variant": name}
        for measure in measures:
            record.update(measure())
        record.update(sass=sass_counts(lib), ptxas=ptxas_rows(logs))
        emit(record)
    return 0


def ppo_measure(torch, dev, split):
    """The PPO update kernels' measurement of a variant (see the module's
    docstring)."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import PPOLossConfig, fused_ppo, fused_rnn_ppo_grads, pack_rnn_params
    from rl8_tpu_torch.ops import rnn_ppo_grads_plain
    from rl8_tpu_torch.ops.fused_act import ActParams
    from rl8_tpu_torch.ops.fused_rnn_act import RnnParams
    from rl8_tpu_torch.specs import Discrete

    # The plain feedforward update in float64: ppo_grads_plain with the
    # packed f32 columns widened (it returns its gradients rounded to f32).
    src = inspect.getsource(fused_ppo.ppo_grads_plain)
    src = src.replace(".view(torch.float32)\n", ".view(torch.float32).double()\n")
    namespace = dict(fused_ppo.__dict__)
    exec(src.replace("def ppo_grads_plain", "def ppo_grads_f64"), namespace)

    loss = dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)
    ec = torch.tensor(0.0, device=dev)
    N = 8192 * 32
    model = cs.make_model(torch, Discrete(2, shape=(1,)), seed=40 + ord("a"))
    params, packed, unpack = cs.ppo_inputs(torch, dev, model, N, seed=ord("a"))
    cfg = PPOLossConfig(clip_param=0.2, n_rows=N, use_entropy=False, **loss)
    plain = fused_ppo.ppo_grads_plain(params, packed, unpack, ec, cfg)[2]
    f64 = namespace["ppo_grads_f64"](ActParams(**{**params.__dict__, "flat": params.flat.double()}),
                                     packed, unpack, ec, cfg)[2]
    rnn_model = cs.make_rnn_model(torch, "categorical", seed=110 + ord("a"))
    rnn_params = pack_rnn_params(rnn_model)
    rnn_packed, rnn_unpack, _ = cs.rnn_ppo_inputs(torch, dev, rnn_model, "categorical", 65536, 4, seed=ord("a"))
    rnn_cfg = PPOLossConfig(clip_param=0.2, n_rows=65536, use_entropy=False, **loss)
    rnn_plain = rnn_ppo_grads_plain(rnn_params, rnn_packed, rnn_unpack, ec, rnn_cfg)[2]

    def chain_errors(got, want) -> list[float]:
        """The largest norm-relative error of a tensor, per chain."""
        out = []
        for gc, wc in zip(ActParams(**{**params.__dict__, "flat": got}).chains(),
                          ActParams(**{**params.__dict__, "flat": want}).chains()):
            pairs = zip([t for pair in (*gc[0], *gc[1]) for t in pair], [t for pair in (*wc[0], *wc[1]) for t in pair])
            out.append(max(float((g.double() - w.double()).norm() / w.double().norm()) for g, w in pairs))
        return out

    def rnn_error(got) -> float:
        def tensors(flat):
            v = RnnParams(**{**rnn_params.__dict__, "flat": flat})
            return [t for layer in v.lstm() for t in layer] + [t for head in v.heads() for t in head]
        return max(float((g - w).norm() / w.norm()) for g, w in zip(tensors(got), tensors(rnn_plain)))

    def measure() -> dict:
        ff = lambda: fused_ppo.fused_ppo_grads(params, packed, unpack, ec, cfg)  # noqa: E731
        rnn = lambda: fused_rnn_ppo_grads(rnn_params, rnn_packed, rnn_unpack, ec, rnn_cfg)  # noqa: E731
        g1, g2 = ff()[2], ff()[2]
        r1, r2 = rnn()[2], rnn()[2]
        torch.cuda.synchronize()
        return {
            "ppo_ms": cs.time_ms(torch, ff, iters=10, warmup=2)[0],
            "ppo_split_ms": split(ff),
            "ppo_worst_grad_vs_plain": chain_errors(g1, plain),
            "ppo_worst_grad_vs_float64": chain_errors(g1, f64),
            "plain_worst_grad_vs_float64": chain_errors(plain, f64),
            "rnn_ppo_ms": cs.time_ms(torch, rnn, iters=10, warmup=2)[0],
            "rnn_ppo_split_ms": split(rnn),
            "rnn_worst_grad_vs_plain": rnn_error(r1),
            "bit_identical": bool(torch.equal(g1, g2) and torch.equal(r1, r2)),
        }

    return measure


#: ppo_shapes_measure's shapes: (name, hiddens, activation, rows, kind, A,
#: categories, obs dim): check_ppo's configs a, b and c, the examples'
#: launches (CartPole, MountainCar, Pendulum: example_rows rows), deep_torso's
#: 16 x 256 and deep_sweep's deep shapes at 8,192 rows, and the route rule's
#: edges (the staged route's smallest minibatch, ragged row blocks, 64 to
#: 192 wide at the main path's rows, 736 wide).
PPO_SHAPES = (
    ("a", (256, 256), "relu", 8192 * 32, "categorical", 1, 2, 1),
    ("b", (64, 32), "relu", 1000, "categorical", 2, 3, 3),
    ("c", (100, 72), "tanh", 9001, "categorical", 3, 2, 5),
    ("cartpole", (256, 256), "relu", 1024 * 64, "categorical", 1, 3, 5),
    ("mountain_car", (256, 256), "relu", 1024 * 64, "categorical", 1, 3, 2),
    ("pendulum", (256, 256), "relu", 1024 * 128, "normal", 1, 0, 3),
    ("deep_16x256", (256,) * 16, "relu", 8192 * 32, "categorical", 1, 2, 1),
    ("deep_16x256_8192", (256,) * 16, "relu", 8192, "categorical", 1, 2, 1),
    ("deep_87x256_8192", (256,) * 87, "relu", 8192, "categorical", 1, 2, 1),
    ("deep_1306x64_8192", (64,) * 1306, "tanh", 8192, "categorical", 1, 2, 1),
    ("w256_8192", (256, 256), "relu", 8192, "categorical", 1, 2, 1),
    ("w256_16384", (256, 256), "relu", 16384, "categorical", 1, 2, 1),
    ("w256_20001", (256, 256), "relu", 20001, "categorical", 1, 2, 1),
    ("w64_262144", (64, 64), "relu", 8192 * 32, "categorical", 1, 2, 1),
    ("w128_262144", (128, 128), "relu", 8192 * 32, "categorical", 1, 2, 1),
    ("w192_262144", (192, 192), "relu", 8192 * 32, "categorical", 1, 2, 1),
    ("w736_16384", (736, 736), "relu", 16384, "categorical", 1, 2, 1),
)


def ppo_shapes_measure(torch, dev):
    """The feedforward update's device ms per launch at PPO_SHAPES (the
    route rule's evidence: run with the variants that change it)."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import PPOLossConfig, fused_ppo_grads
    from rl8_tpu_torch.specs import Discrete

    loss = dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)
    ec = torch.tensor(0.0, device=dev)

    def inputs(name, hiddens, activation, N, kind, A, n, obs_dim):
        seed = sum(map(ord, name))
        if kind == "categorical":
            model = cs.make_model(torch, Discrete(n, shape=(A,)), seed=seed, obs_dim=obs_dim, hiddens=hiddens,
                                  activation_fn=activation)
            params, packed, unpack = cs.ppo_inputs(torch, dev, model, N, seed=seed)
        else:
            model = cs.make_continuous_model(torch, A, seed=seed, obs_dim=obs_dim, hiddens=hiddens,
                                             activation_fn=activation)
            params, packed, unpack, _ = cs.continuous_ppo_inputs(torch, dev, model, N, seed=seed, squashed=False)
        return params, packed, unpack, PPOLossConfig(clip_param=0.2, n_rows=N, use_entropy=False, **loss)

    def measure() -> dict:
        out = {}
        for shape in PPO_SHAPES:
            params, packed, unpack, cfg = inputs(*shape)
            run = lambda: fused_ppo_grads(params, packed, unpack, ec, cfg)  # noqa: E731
            deep = len(shape[1]) > 20
            out[f"shape_{shape[0]}_ms"] = cs.time_ms(torch, run, iters=2 if deep else 10, warmup=1)[0]
            del params, packed, unpack
            torch.cuda.empty_cache()
        return out

    return measure


def rnn_ppo_measure(torch, dev, split):
    """The recurrent update at the main path's shapes (65,536 sequences of 4
    steps, one 256-wide layer, categorical), categorical and squashed: ms,
    split by kernel, the worst gradient tensor's norm-relative error against
    the plain version, and bit identity."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import PPOLossConfig, fused_rnn_ppo_grads, pack_rnn_params, rnn_ppo_grads_plain
    from rl8_tpu_torch.ops.fused_rnn_act import RnnParams

    loss = dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)
    ec = torch.tensor(0.0, device=dev)
    N = 65536
    cases = []
    for kind in ("categorical", "squashed"):
        model = cs.make_rnn_model(torch, kind, seed=110 + ord("a"))
        params = pack_rnn_params(model, squashed=kind == "squashed")
        packed, unpack, _ = cs.rnn_ppo_inputs(torch, dev, model, kind, N, 4, seed=ord("a"))
        cfg = PPOLossConfig(clip_param=0.2, n_rows=N, use_entropy=False, squashed=kind == "squashed", **loss)
        plain = rnn_ppo_grads_plain(params, packed, unpack, ec, cfg)[2]
        cases.append((kind, params, packed, unpack, cfg, plain))

    def tensors(params, flat):
        v = RnnParams(**{**params.__dict__, "flat": flat})
        return [t for layer in v.lstm() for t in layer] + [t for head in v.heads() for t in head]

    def measure() -> dict:
        out = {}
        for kind, params, packed, unpack, cfg, plain in cases:
            run = lambda: fused_rnn_ppo_grads(params, packed, unpack, ec, cfg)  # noqa: E731
            g1, g2 = run()[2], run()[2]
            torch.cuda.synchronize()
            key = "rnn_ppo" if kind == "categorical" else f"rnn_ppo_{kind}"
            out[f"{key}_ms"] = cs.time_ms(torch, run, iters=10, warmup=2)[0]
            out[f"{key}_split_ms"] = split(run)
            out[f"{key}_worst_grad_vs_plain"] = max(float((g - w).norm() / w.norm())
                                                    for g, w in zip(tensors(params, g1), tensors(params, plain)))
            out[f"{key}_bit_identical"] = bool(torch.equal(g1, g2))
        return out

    return measure


#: rnn_shapes_measure's grid: sequences (the sharded cells' per-rank sizes
#: among them), one or two H-wide layers; 4 steps, the dummy envs' input
#: and heads.
RNN_SHAPES_N = (1000, 16384, 32768, 65536)
RNN_SHAPES_H = (64, 128, 256, 512, 724, 1024)
RNN_SHAPES_K = (1, 2)


def rnn_shapes_measure(torch, dev):
    """The recurrent update's device ms per launch over the RNN_SHAPES_*
    grid (the route rule's evidence: run with the variants that move it)."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import PPOLossConfig, fused_rnn_ppo_grads, pack_rnn_params

    loss = dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)
    ec = torch.tensor(0.0, device=dev)

    def measure() -> dict:
        out = {}
        for H in RNN_SHAPES_H:
            for K in RNN_SHAPES_K:
                model = cs.make_rnn_model(torch, "categorical", seed=H + K, hidden_size=H, num_layers=K)
                params = pack_rnn_params(model)
                for N in RNN_SHAPES_N:
                    packed, unpack, _ = cs.rnn_ppo_inputs(torch, dev, model, "categorical", N, 4, seed=N + H)
                    cfg = PPOLossConfig(clip_param=0.2, n_rows=N, use_entropy=False, **loss)
                    run = lambda: fused_rnn_ppo_grads(params, packed, unpack, ec, cfg)  # noqa: E731
                    out[f"rnn_{N}x{H}x{K}_ms"] = cs.time_ms(torch, run, iters=3 if N * H * K > 2**24 else 10,
                                                            warmup=1)[0]
                    del packed, unpack
                del model, params
                torch.cuda.empty_cache()
        return out

    return measure


def rnn_wide_measure(torch, dev, split):
    """The recurrent update at the widest LSTM ``rl8_tpu``'s gate admits, H
    1617 x 2,048 sequences of 4 (a grid of 16 blocks of 128 sequences):
    ms and split by kernel."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import PPOLossConfig, fused_rnn_ppo_grads, pack_rnn_params

    loss = dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)
    ec = torch.tensor(0.0, device=dev)
    model = cs.make_rnn_model(torch, "categorical", seed=110 + 1617, hidden_size=1617)
    params = pack_rnn_params(model)
    packed, unpack, _ = cs.rnn_ppo_inputs(torch, dev, model, "categorical", 2048, 4, seed=1617)
    cfg = PPOLossConfig(clip_param=0.2, n_rows=2048, use_entropy=False, **loss)

    def measure() -> dict:
        run = lambda: fused_rnn_ppo_grads(params, packed, unpack, ec, cfg)  # noqa: E731
        return {"rnn_1617x2048_ms": cs.time_ms(torch, run, iters=10, warmup=1)[0],
                "rnn_1617x2048_split_ms": split(run)}

    return measure


#: rnn_act_shapes_measure's grid: rows (a served request's to the
#: Recurrent cell's 8,192) and one or two H-wide layers.
RNN_ACT_SHAPES_B = (1, 8, 64, 256, 1000, 4096, 8192)
RNN_ACT_SHAPES_H = (64, 96, 128, 192, 256, 288)
RNN_ACT_SHAPES_K = (1, 2)


def rnn_act_shapes_measure(torch, dev):
    """The recurrent act kernel's device ms per launch (stochastic) over the
    RNN_ACT_SHAPES_* grid (its route rule's evidence)."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import fused_rnn_act, pack_rnn_params

    gen = torch.Generator(device=dev).manual_seed(9)
    cases = []
    for H in RNN_ACT_SHAPES_H:
        for K in RNN_ACT_SHAPES_K:
            params = pack_rnn_params(cs.make_rnn_model(torch, "categorical", seed=H + K, hidden_size=H, num_layers=K))
            for B in RNN_ACT_SHAPES_B:
                obs = 3.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
                cases.append((f"rnn_act_{B}x{H}x{K}_ms", params, obs, cs.rnn_states(torch, dev, B, K, H, gen)))

    def measure() -> dict:
        return {name: cs.time_ms(torch, lambda p=p, o=o, s=s: fused_rnn_act(p, o, s, (1, 2)), iters=20)[0]
                for name, p, o, s in cases}

    return measure


def wide_measure(torch, dev, split):
    """The update kernels' wide routes' measurement of a variant (see the
    module's docstring)."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import PPOLossConfig, fused_ppo_grads, fused_rnn_ppo_grads, pack_rnn_params
    from rl8_tpu_torch.ops import ppo_grads_plain, rnn_ppo_grads_plain
    from rl8_tpu_torch.specs import Discrete

    loss = dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)
    ec = torch.tensor(0.0, device=dev)
    N = 8192 * 32
    params, packed, unpack = cs.ppo_inputs(
        torch, dev, cs.make_model(torch, Discrete(2, shape=(1,)), seed=1064, hiddens=(1024, 1024)), N, seed=1024)
    cfg = PPOLossConfig(clip_param=0.2, n_rows=N, use_entropy=False, **loss)
    plain = ppo_grads_plain(params, packed, unpack, ec, cfg)[2]
    rnn_model = cs.make_rnn_model(torch, "categorical", seed=1134, hidden_size=1024)
    rnn_params = pack_rnn_params(rnn_model)
    rnn_packed, rnn_unpack, _ = cs.rnn_ppo_inputs(torch, dev, rnn_model, "categorical", 65536, 4, seed=1024)
    rnn_cfg = PPOLossConfig(clip_param=0.2, n_rows=65536, use_entropy=False, **loss)
    rnn_plain = rnn_ppo_grads_plain(rnn_params, rnn_packed, rnn_unpack, ec, rnn_cfg)[2]

    def measure() -> dict:
        out = {}
        for name, run, want in (
            ("wide_ppo", lambda: fused_ppo_grads(params, packed, unpack, ec, cfg), plain),
            ("wide_rnn_ppo", lambda: fused_rnn_ppo_grads(rnn_params, rnn_packed, rnn_unpack, ec, rnn_cfg), rnn_plain),
        ):
            g1, g2 = run()[2], run()[2]
            torch.cuda.synchronize()
            out[f"{name}_ms"] = cs.time_ms(torch, run, iters=3, warmup=1)[0]
            out[f"{name}_split_ms"] = split(run)
            out[f"{name}_vs_plain"] = float((g1 - want).norm() / want.norm())
            out[f"{name}_bit_identical"] = bool(torch.equal(g1, g2))
        return out

    return measure


#: wide_act_measure's shapes: the recurrent act kernel's (H, rows) and the
#: act kernels' (width, rows), the wide cells' first.
WIDE_ACT_RNN = ((1024, 8192), (1617, 4096), (512, 4096), (289, 4096))
WIDE_ACT_FF = ((1024, 8192), (2388, 4096), (384, 4096))


def wide_act_measure(torch, dev, split):
    """The act kernels' staged routes' measurement of a variant (see the
    module's docstring)."""
    import math

    import chip_smoke as cs
    from rl8_tpu_torch.ops import act_plain, fused_act, fused_rnn_act, pack_act_params, pack_rnn_params, rnn_act_plain
    from rl8_tpu_torch.specs import Discrete

    gen = torch.Generator(device=dev).manual_seed(21)
    cases = []
    for H, B in WIDE_ACT_RNN:
        params = pack_rnn_params(cs.make_rnn_model(torch, "categorical", seed=H, hidden_size=H,
                                                   head_scale=0.3 * math.sqrt(256 / H)))
        obs = 3.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
        states = cs.rnn_states(torch, dev, B, 1, H, gen)
        cases.append((f"rnn_act_{H}x{B}", lambda p=params, o=obs, s=states, d=False: fused_rnn_act(p, o, s, (1, 2), deterministic=d),
                      rnn_act_plain(params, obs, states, (1, 2), deterministic=True)))
    for w, B in WIDE_ACT_FF:
        obs = 20.0 * torch.randn((B, 1), generator=gen, device=dev)
        for kind in ("categorical", "squashed"):
            if kind == "categorical":
                model = cs.make_model(torch, Discrete(2, shape=(1,)), seed=w, hiddens=(w, w))
            else:
                model = cs.scale_mean_head(torch, cs.make_continuous_model(torch, 1, seed=w + 1, log_std_scale=0.03,
                                                                           hiddens=(w, w)), obs, cs.WIDE_MEAN_RMS)
            params = pack_act_params(model, squashed=kind == "squashed")
            cases.append((f"act_{w}x{B}" + ("_squashed" if kind == "squashed" else ""),
                          lambda p=params, o=obs, d=False: fused_act(p, o, (1, 2), deterministic=d),
                          act_plain(params, obs, (1, 2), deterministic=True)))

    def measure() -> dict:
        out = {}
        for name, run, plain in cases:
            k1, k2 = run(d=True), run(d=True)
            torch.cuda.synchronize()
            out[f"{name}_ms"] = cs.time_ms(torch, run, iters=10, warmup=2)[0]
            out[f"{name}_split_ms"] = split(run)
            kf = [t for t in k1 if torch.is_tensor(t)] + ([v for v in k1[3].values()] if len(k1) > 3 else [])
            pf = [t for t in plain if torch.is_tensor(t)] + ([v for v in plain[3].values()] if len(plain) > 3 else [])
            out[f"{name}_vs_plain"] = {
                "actions_differ": int((k1[0] != plain[0]).sum()),
                "max_abs": max(float((k.float() - q.float()).abs().max()) for k, q in zip(kf[1:], pf[1:])),
            }
            out[f"{name}_bit_identical"] = all(torch.equal(a, b) for a, b in zip(kf, [t for t in k2 if torch.is_tensor(t)] + ([v for v in k2[3].values()] if len(k2) > 3 else [])))
        return out

    return measure


def chains_measure(torch, dev, split):
    """The chain backward's measurement of a variant (see the module's
    docstring)."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import chains_vjp_plain, fused_chains_bwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, default_chains, flatten_chains, unflatten_chains

    chains = default_chains(cs.make_mule(torch, seed=5).to(dev))
    structure, flat = chain_structure(chains), flatten_chains(chains)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = [0.5 * torch.randn((N, 7), generator=gen, device=dev) for N in (4096, 32768)][1]
    gen = torch.Generator(device=dev).manual_seed(32768)
    douts = [torch.randn((32768, w), generator=gen, device=dev) for w in (3, 1)]
    grouped = [douts[:1], douts[1:]]
    p_dx, p_grads = chains_vjp_plain(x, chains, "relu", grouped)
    double = tuple(tuple(tuple(tuple(t.double() for t in p) for p in part) for part in chain) for chain in chains)
    f_dx, f_grads = chains_vjp_plain(x.double(), double, "relu", [[d.double() for d in g] for g in grouped])
    # Per row, the smallest |pre-activation| over every unit of every chain.
    margin = torch.full((x.shape[0],), float("inf"), dtype=torch.float64, device=dev)
    for layers, _ in double:
        h = x.double()
        for layer in layers:
            z = h @ layer[0] + layer[1]
            if len(layer) == 4:
                mu = z.mean(1, keepdim=True)
                var = ((z * z).mean(1, keepdim=True) - mu * mu).clamp_min(0.0)
                z = (z - mu) * torch.rsqrt(var + 1e-6) * layer[2] + layer[3]
            margin = torch.minimum(margin, z.abs().min(1).values)
            h = torch.relu(z)

    def tensors(flat_grads):
        return [t for layers, heads in unflatten_chains(flat_grads, structure) for ts in (*layers, *heads) for t in ts]

    def worst(got, want) -> float:
        return max(float((g.double() - w.double()).norm() / w.double().norm()) for g, w in zip(tensors(got), tensors(want)))

    def measure() -> dict:
        run = lambda: fused_chains_bwd(x, flat, structure, "relu", douts)  # noqa: E731
        (k_dx, k_flat), (k2_dx, k2_flat) = run(), run()
        torch.cuda.synchronize()
        bad = ~torch.isclose(k_dx, p_dx, rtol=cs.CHAIN_RTOL, atol=cs.CHAIN_ATOL)
        rows = bad.any(1).nonzero().flatten()[:8]
        return {
            "chains_bwd_ms": cs.time_ms(torch, run, iters=20, warmup=2)[0],
            "chains_bwd_split_ms": split(run),
            "dx_vs_plain": float((k_dx - p_dx).abs().max()),
            "dx_vs_float64": float((k_dx.double() - f_dx).abs().max()),
            "plain_dx_vs_float64": float((p_dx.double() - f_dx).abs().max()),
            "dx_outside_tolerance": int(bad.sum()),
            "bad_rows": {int(r): {"margin": float(margin[r]), "kernel_err": float((k_dx[r] - p_dx[r]).abs().max()),
                                  "plain_vs_float64": float((p_dx[r].double() - f_dx[r]).abs().max())}
                         for r in rows},
            "smallest_margin": float(margin.min()),
            "grad_vs_plain": worst(k_flat, flatten_chains(p_grads)),
            "grad_vs_float64": worst(k_flat, flatten_chains(f_grads)),
            "plain_grad_vs_float64": worst(flatten_chains(p_grads), flatten_chains(f_grads)),
            "chains_bit_identical": bool(torch.equal(k_dx, k2_dx) and torch.equal(k_flat, k2_flat)),
        }

    return measure


def rnn_act_measure(torch, dev, split):
    """The recurrent act kernel's measurement of a variant (see the
    module's docstring)."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import fused_rnn_act, pack_rnn_params, rnn_act_plain

    B, H = 8192, 256
    gen = torch.Generator(device=dev).manual_seed(5)
    obs = 3.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
    states = cs.rnn_states(torch, dev, B, 1, H, gen)
    params = pack_rnn_params(cs.make_rnn_model(torch, "categorical", seed=99))
    # The other shapes: 4,096 rows, and a ragged 1,000 rows of two layers.
    others = []
    for name, B2, K in (("rnn_act_4096", 4096, 1), ("rnn_act_1000_2l", 1000, 2)):
        others.append((name, pack_rnn_params(cs.make_rnn_model(torch, "categorical", seed=99 + K, num_layers=K)),
                       3.0 * (2.0 * torch.rand((B2, 1), generator=gen, device=dev) - 1.0),
                       cs.rnn_states(torch, dev, B2, K, H, gen)))

    def errors(p, o, s) -> dict:
        out = {}
        for det in (True, False):
            ka, kl, kv, ks = fused_rnn_act(p, o, s, (1, 2), deterministic=det)
            pa, pl, pv, ps = rnn_act_plain(p, o, s, (1, 2), deterministic=det)
            out["deterministic" if det else "stochastic"] = {
                "actions_differ": int((ka != pa).sum()), "logp": float((kl - pl).abs().max()),
                "values": float((kv - pv).abs().max()),
                "states": max(float((ks[k] - ps[k]).abs().max()) for k in ks),
            }
        k1, k2 = fused_rnn_act(p, o, s, (1, 2)), fused_rnn_act(p, o, s, (1, 2))
        flat = lambda r: [r[0], r[1], r[2], *r[3].values()]  # noqa: E731
        out["bit_identical"] = all(torch.equal(a, b) for a, b in zip(flat(k1), flat(k2)))
        return out

    def measure() -> dict:
        run = lambda: fused_rnn_act(params, obs, states, (1, 2))  # noqa: E731
        out = {"rnn_act_ms": cs.time_ms(torch, run)[0], "rnn_act_split_ms": split(run), **errors(params, obs, states)}
        for name, p, o, s in others:
            run = lambda p=p, o=o, s=s: fused_rnn_act(p, o, s, (1, 2))  # noqa: E731
            out[f"{name}_ms"] = cs.time_ms(torch, run)[0]
            out[f"{name}_split_ms"] = split(run)
            out[name] = errors(p, o, s)
        return out

    return measure


def chains_fwd_measure(torch, dev, split):
    """The chain forward's measurement of a variant (see the module's
    docstring)."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import forward_chains, fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, default_chains, flatten_chains

    chains = default_chains(cs.make_mule(torch, seed=5).to(dev))
    structure, flat = chain_structure(chains), flatten_chains(chains)
    gen = torch.Generator(device=dev).manual_seed(6)
    xs = [0.5 * torch.randn((N, 7), generator=gen, device=dev) for N in (4096, 32768)]
    plain = [[o for chain in forward_chains(x, chains, "relu")[0] for o in chain] for x in xs]

    def measure() -> dict:
        out = {}
        for x, want in zip(xs, plain):
            N = x.shape[0]
            run = lambda: fused_chains_fwd(x, flat, structure, "relu")  # noqa: E731
            k1, k2 = run(), run()
            torch.cuda.synchronize()
            out[f"chains_fwd_{N}_ms"] = cs.time_ms(torch, run)[0]
            out[f"chains_fwd_{N}_split_ms"] = split(run)
            out[f"chains_fwd_{N}_vs_plain"] = max(float((k - p).abs().max()) for k, p in zip(k1, want))
            out[f"chains_fwd_{N}_bit_identical"] = all(torch.equal(a, b) for a, b in zip(k1, k2))
        return out

    return measure


#: ``chains_wide``'s stand-ins for the other callers of ``stage.cuh``'s
#: ``fwd_product`` at their main paths' shapes, on the chain forward's
#: staged route (forced by a fifth head: the tiled route holds four):
#: ``(name, d_in, layout, rows)``. ``ppo_staged_fwd_kernel``'s forward
#: products (twin 256-wide relu torsos, 262,144 rows), the act kernels'
#: staged continuous forward (the same torsos, 8,192 rows) and
#: ``rnn_staged_fwd_kernel``'s gate products (h Wh of one 256-wide LSTM, 256
#: x 1024, 65,536 sequences of 4 steps; its 1-wide x Wi is folded into the
#: epilogue there); and that product's shape from a 257-wide input, whose
#: rows (1,028 bytes apart) no tensor map takes: the producer warp's
#: cp.async route at a K of nine stages.
CALLER_SHAPES = (
    ("ppo_staged_fwd", 1, (([(256, False), (256, False)], [2, 1, 1, 1, 1]), ([(256, False), (256, False)], [1])),
     262144),
    ("act_staged_continuous", 1, (([(256, False), (256, False)], [1, 1, 1, 1, 1]),
                                  ([(256, False), (256, False)], [1])), 8192),
    ("rnn_staged_fwd_gates", 256, (([(1024, False)], [1, 1, 1, 1, 1]),), 262144),
    ("unaligned_257", 257, (([(1024, False)], [1, 1, 1, 1, 1]),), 262144),
)


def sampled_clocks(torch, fn, seconds: float = 2.0) -> dict:
    """The SM clock (MHz) and power draw (W) that ``nvidia-smi`` reads every
    100 ms while ``fn`` runs back to back for ``seconds`` (medians of the
    samples taken after the first half second)."""
    import time

    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                             "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        lines = proc.communicate()[0].strip().splitlines()
    rows = [[float(v) for v in line.split(",")] for line in lines if line.count(",") == 1]
    rows = rows[len(rows) // 4:] or rows
    med = lambda xs: sorted(xs)[len(xs) // 2] if xs else None  # noqa: E731
    return {"sm_mhz": med([r[0] for r in rows]), "power_w": med([r[1] for r in rows]), "samples": len(rows)}


def chains_wide_measure(torch, dev, split):
    """The staged chain routes' measurement of a variant at ``wide_custom``'s
    shapes (MischievousMule at 2048 wide, ``chip_smoke.py``'s
    ``mule_layout``): the forward at 4,096 and 32,768 rows (ms, split by
    kernel, the largest error against the plain version, bit identity);
    the backward at 32,768 rows saved (``chip_smoke.saved_bwd_ms``: after a
    saving forward, events around the backward alone) and recomputed (ms, split; whether
    the saved one launched ``chains_layer_kernel``; saved and recomputed
    bit-identical), and ``deep_custom``'s (12 x 128) the same way; a
    cuBLAS yardstick of the same layer products (``torch.addmm`` and
    ``torch.mm``, f32, TF32 off, alone: the forward's products and heads,
    and the backward's dh, dx and weight products); and the products of
    ``CALLER_SHAPES`` (the chain forward's ``chains_layer_kernel`` ms
    there)."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import forward_chains, fused_chains_bwd, fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, flatten_chains

    gen = torch.Generator(device=dev).manual_seed(61)
    cases = {
        "wide_custom": cs.random_chains(torch, dev, seed=62, d_in=7, layout=cs.mule_layout(2048)),
        "deep_custom": cs.random_chains(torch, dev, seed=63, d_in=7,
                                        layout=tuple(([(128, i == 0)] + [(128, False)] * 11, [w]) for i, w in
                                                     ((0, 3), (0, 1)))),
    }
    xs = {N: 0.5 * torch.randn((N, 7), generator=gen, device=dev) for N in (4096, 32768)}

    def library_ms(chains, x, douts, backward: bool) -> float:
        """The layer products alone as cuBLAS calls (f32, TF32 off) on
        activations of the products' shapes."""
        _, hs = forward_chains(x, chains, "relu")
        calls = []
        for (layers, heads), h, chain_douts in zip(chains, hs, douts or [[None] * len(hd) for _, hd in chains]):
            for layer, h_in, h_out in zip(layers, h[:-1], h[1:]):
                if backward:
                    calls.append(lambda a=h_out, w=layer[0]: torch.mm(a, w.t()))
                    calls.append(lambda a=h_in, g=h_out: torch.mm(a.t(), g))
                else:
                    calls.append(lambda a=h_in, w=layer[0], b=layer[1]: torch.addmm(b, a, w))
            for (w, b), dout in zip(heads, chain_douts):
                if backward:
                    calls.append(lambda a=h[-1], g=dout: torch.mm(a.t(), g))
                    calls.append(lambda g=dout, w=w: torch.mm(g, w.t()))
                else:
                    calls.append(lambda a=h[-1], w=w, b=b: torch.addmm(b, a, w))
        return cs.time_ms(torch, lambda: [f() for f in calls], iters=5, warmup=1)[0]

    def measure() -> dict:
        out = {}
        for name, chains in cases.items():
            structure, flat = chain_structure(chains), flatten_chains(chains)
            rows = (4096, 32768) if name == "wide_custom" else (32768,)
            for N in rows:
                x = xs[N]
                run = lambda: fused_chains_fwd(x, flat, structure, "relu")  # noqa: E731
                k1, k2 = run(), run()
                want = [o for chain in forward_chains(x, chains, "relu")[0] for o in chain]
                torch.cuda.synchronize()
                key = f"{name}_fwd_{N}"
                out[f"{key}_ms"] = cs.time_ms(torch, run, iters=10 if N > 4096 else 20, warmup=2)[0]
                out[f"{key}_split_ms"] = split(run)
                out[f"{key}_vs_plain"] = max(float((k - p).abs().max()) for k, p in zip(k1, want))
                out[f"{key}_bit_identical"] = all(torch.equal(a, b) for a, b in zip(k1, k2))
            x = xs[32768]
            douts = [torch.randn((32768, w), generator=gen, device=dev) for _, heads in structure[1] for w in heads]
            recompute = lambda: fused_chains_bwd(x, flat, structure, "relu", douts)  # noqa: E731
            dx_r, dflat_r = recompute()
            _, kept = fused_chains_fwd(x, flat, structure, "relu", save=True)
            dx_s, dflat_s = fused_chains_bwd(x, flat, structure, "relu", douts, saved=kept)
            del kept
            torch.cuda.synchronize()
            key = f"{name}_bwd_32768"
            out[f"{key}_saved_bit_identical_to_recompute"] = bool(torch.equal(dx_r, dx_s) and torch.equal(dflat_r, dflat_s))
            out[f"{key}_recompute_ms"] = cs.time_ms(torch, recompute, iters=5, warmup=1)[0]
            out[f"{key}_recompute_split_ms"] = split(recompute)
            out[f"{key}_saved_ms"] = cs.saved_bwd_ms(torch, x, flat, structure, "relu", douts, 5)
            saved_split = {}
            for _ in range(3):
                _, kept = fused_chains_fwd(x, flat, structure, "relu", save=True)
                got = split(lambda: fused_chains_bwd(x, flat, structure, "relu", douts, saved=kept))
                saved_split = got if sum(got.values()) > sum(saved_split.values()) else saved_split
            del kept
            out[f"{key}_saved_split_ms"] = saved_split
            out[f"{key}_saved_launches_layer_kernel"] = any("chains_layer" in k for k in saved_split)
            if name == "wide_custom":
                grouped, q = [], 0
                for _, heads in structure[1]:
                    grouped.append(douts[q : q + len(heads)])
                    q += len(heads)
                out["wide_custom_fwd_4096_library_ms"] = library_ms(chains, xs[4096], None, False)
                out["wide_custom_fwd_32768_library_ms"] = library_ms(chains, x, None, False)
                flat_w = flatten_chains(chains)
                out["wide_custom_fwd_32768_clocks"] = sampled_clocks(
                    torch, lambda: fused_chains_fwd(x, flat_w, structure, "relu"))
                w1 = chains[0][0][1][0]
                h1 = torch.randn((32768, w1.shape[0]), generator=gen, device=dev)
                out["cublas_2048_product_clocks"] = sampled_clocks(torch, lambda: torch.mm(h1, w1))
                del h1
                out[f"{key}_library_ms"] = library_ms(chains, x, grouped, True)
            torch.cuda.empty_cache()
        for name, d_in, layout, N in CALLER_SHAPES:
            chains = cs.random_chains(torch, dev, seed=64, d_in=d_in, layout=layout)
            structure, flat = chain_structure(chains), flatten_chains(chains)
            x = 0.5 * torch.randn((N, d_in), generator=gen, device=dev)
            run = lambda: fused_chains_fwd(x, flat, structure, "relu")  # noqa: E731
            out[f"caller_{name}_{N}_fwd_ms"] = cs.time_ms(torch, run, iters=10, warmup=2)[0]
            got = split(run)
            out[f"caller_{name}_{N}_layer_kernel_ms"] = sum(v for k, v in got.items() if "chains_layer" in k)
            del chains, x
        return out

    return measure


def act_measure(torch, dev, split):
    """The act kernels' measurement of a variant (see the module's
    docstring)."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import act_plain, fused_act, pack_act_params
    from rl8_tpu_torch.specs import Discrete

    B = 8192
    gen = torch.Generator(device=dev).manual_seed(3)
    obs = 100.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
    squashed = pack_act_params(cs.make_continuous_model(torch, 1, seed=62), squashed=True)
    discrete = pack_act_params(cs.make_model(torch, Discrete(2, shape=(1,)), seed=12))

    def measure() -> dict:
        out = {}
        for name, params in (("continuous", squashed), ("discrete", discrete)):
            run = lambda: fused_act(params, obs, (1, 2))  # noqa: E731
            out[f"{name}_act_ms"] = cs.time_ms(torch, run)[0]
            out[f"{name}_act_split_ms"] = split(run)
            for det in (True, False):
                k1 = fused_act(params, obs, (1, 2), deterministic=det)
                k2 = fused_act(params, obs, (1, 2), deterministic=det)
                p = act_plain(params, obs, (1, 2), deterministic=det)
                torch.cuda.synchronize()
                out[f"{name}_{'deterministic' if det else 'stochastic'}"] = {
                    "actions": float((k1[0] - p[0]).abs().max()), "values": float((k1[2] - p[2]).abs().max()),
                    "logp": float((k1[1] - p[1]).abs().max()),
                    "bit_identical": all(torch.equal(a, b) for a, b in zip(k1, k2)),
                }
        return out

    return measure


def gae_measure(torch, dev):
    """The GAE kernel's measurement of a variant (see the module's
    docstring)."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import _build, fused_gae, gae_plain

    gen = torch.Generator(device=dev).manual_seed(2)
    kw = {"gamma": 0.95, "gae_lambda": 0.95}
    cases = {}
    for T in (32, 512):
        rewards = torch.randn((T, 8192, 1), generator=gen, device=dev)
        values = torch.randn((T + 1, 8192, 1), generator=gen, device=dev)
        cases[T] = (rewards, values, torch.tensor(3.7, device=dev))

    def measure() -> dict:
        out = {}
        for T, (rewards, values, scale) in cases.items():
            run = lambda: fused_gae(rewards, values, scale, **kw)  # noqa: E731
            (ka, kr), (k2a, k2r) = run(), run()
            pa, pr = gae_plain(rewards, values, scale, **kw)
            torch.cuda.synchronize()
            out[f"gae_{T}_ms"] = cs.time_ms(torch, run, iters=200)[0]
            out[f"gae_{T}_vs_plain"] = max(float((ka - pa).abs().max()), float((kr - pr).abs().max()))
            out[f"gae_{T}_bit_identical"] = bool(torch.equal(ka, k2a) and torch.equal(kr, k2r))
        lib = _build.load()
        out["gae_empty_ms"] = cs.time_ms(
            torch, lambda: lib.rl8_gae_empty(8192, 0, torch.cuda.current_stream().cuda_stream), iters=200)[0]
        return out

    return measure


if __name__ == "__main__":
    sys.exit(main())

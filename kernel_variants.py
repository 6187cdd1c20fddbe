#!/usr/bin/env python3
"""Time and check design variants of the port's kernels on one card.

Run from the repository root on a machine with a CUDA card and ``nvcc``:
``python3 kernel_variants.py [--kernels ppo,chains,rnn_act,chains_fwd,act,gae] [NAME ...]``
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
  (``cuobjdump -sass``);
- ``nvcc -Xptxas -v``'s registers and spills of the row passes.

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
grid (``gae_empty_ms``) timed the same way. The SASS counts include
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
VARIANTS: dict[str, list[tuple[str, str, str]]] = {
    # The design as checked in.
    "as_is": [],
    # The feedforward forward's l >= 1 products on the tensor cores too.
    "tc_forward": [(
        "ppo.cu",
        "      dense_layer<kRows>(cur, cur_w, W, W + (size_t)cur_w * w, dst, w, d.act, ld, l == 0 ? 0 : ld);",
        "      if (l == 0) {\n"
        "        dense_layer<kRows>(cur, cur_w, W, W + (size_t)cur_w * w, dst, w, d.act, ld, 0);\n"
        "      } else {\n"
        "        tc_dense(cur, cur_w, W, w, dst, ld, ws);\n"
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
        ("rnn_act.cu", "smem_floats(d, 2) <= kTwoBlocksSmem", "smem_floats(d, 4) <= kMaxSmem"),
        ("rnn_act.cu", "err = launch<2>(", "err = launch<4>("),
        ("rnn_act.cu", "__global__ void __launch_bounds__(kThreads, 2)\n    rnn_act_kernel(",
         "__global__ void __launch_bounds__(kThreads, MT > 2 ? 1 : 2)\n    rnn_act_kernel("),
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
    "rnn_act_rows16": [("rnn_act.cu", "err = launch<2>(", "err = launch<1>(")],
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
    m = re.search(r"(ppo_rows_kernel<\w+>|rnn_rows_kernel<\w+>|reduce_\w+_kernel<\w+>|reduce_bias_kernel|"
                  r"sum_partials_kernel|sum_stats_kernel|transpose_kernel|chains_bwd_\w+_kernel|chains_fwd_\w*kernel|"
                  r"sum_chain_dx_kernel|rnn_act_kernel<[^>]*>|continuous_act_\w*kernel|discrete_act_\w*kernel|gae_kernel)", kernel)
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
            kernel = re.search(r"(ppo_rows_kernel|rnn_rows_kernel|reduce_tiled_kernel|chains_bwd_\w+?_kernel|"
                               r"chains_fwd_\w*?kernel|continuous_act_\w*?kernel|discrete_act_\w*?kernel|"
                               r"rnn_act_kernel|gae_kernel)(I\w*)?", fn)
            args = ",".join(re.findall(r"L[ib](\d+)E", kernel.group(2) or "")) if kernel else ""
            fn = f"{source.group(1)}.cu {kernel.group(1)}<{args}>" if source and kernel else None
            continue
        if fn and re.search(r"HGMMA|HMMA|FFMA|LDL|STL|\bLDS\b", line):
            c = counts.setdefault(fn, {"HGMMA": 0, "HMMA": 0, "HMMA_TF32": 0, "FFMA": 0, "LDS": 0, "local": 0})
            if "HGMMA" in line:
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
                fn = m.group(1) if re.search("rows_kernel|tiles_kernel|act_kernel|wgmma_kernel|chains_fwd_kernel|gae_kernel",
                                             m.group(1)) else None
            elif fn and ("registers" in line or "spill stores" in line):
                out.append(f"{stem}.cu: {line.strip().replace('ptxas info    : ', '')}")
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
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out: dict[str, float] = {}
        for e in prof.key_averages():
            name = short(e.key)
            if name and e.self_device_time_total > 0:
                out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
        return out

    measures = []
    if "ppo" in kinds:
        measures.append(ppo_measure(torch, dev, split))
    if "chains" in kinds:
        measures.append(chains_measure(torch, dev, split))
    if "rnn_act" in kinds:
        measures.append(rnn_act_measure(torch, dev))
    if "chains_fwd" in kinds:
        measures.append(chains_fwd_measure(torch, dev, split))
    if "act" in kinds:
        measures.append(act_measure(torch, dev, split))
    if "gae" in kinds:
        measures.append(gae_measure(torch, dev))
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


def rnn_act_measure(torch, dev):
    """The recurrent act kernel's measurement of a variant (see the
    module's docstring)."""
    import chip_smoke as cs
    from rl8_tpu_torch.ops import fused_rnn_act, pack_rnn_params, rnn_act_plain

    B, H = 8192, 256
    gen = torch.Generator(device=dev).manual_seed(5)
    obs = 3.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
    states = cs.rnn_states(torch, dev, B, 1, H, gen)
    params = pack_rnn_params(cs.make_rnn_model(torch, "categorical", seed=99))

    def measure() -> dict:
        out = {"rnn_act_ms": cs.time_ms(torch, lambda: fused_rnn_act(params, obs, states, (1, 2)))[0]}
        for det in (True, False):
            ka, kl, kv, ks = fused_rnn_act(params, obs, states, (1, 2), deterministic=det)
            pa, pl, pv, ps = rnn_act_plain(params, obs, states, (1, 2), deterministic=det)
            out["deterministic" if det else "stochastic"] = {
                "actions_differ": int((ka != pa).sum()), "logp": float((kl - pl).abs().max()),
                "values": float((kv - pv).abs().max()),
                "states": max(float((ks[k] - ps[k]).abs().max()) for k in ks),
            }
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

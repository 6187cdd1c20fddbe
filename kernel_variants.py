#!/usr/bin/env python3
"""Time and check design variants of the PPO update kernels on one card.

Run from the repository root on a machine with a CUDA card and ``nvcc``:
``python3 kernel_variants.py [NAME ...]`` (all variants when no name is
given). Each variant is the checkout's ``rl8_tpu_torch/csrc`` with a few
text substitutions (``VARIANTS`` below), compiled into its own library
under ``build/variants/NAME/``, all with one ``nvcc`` per source started
together. For each variant, at the main paths' shapes (``chip_smoke.py``'s
inputs: 262,144 rows of the discrete feedforward update, 65,536 sequences
of 4 steps of the recurrent one), it prints one JSON line with

- device ms per launch (``chip_smoke.time_ms``) and the split by kernel
  (``torch.profiler``);
- each gradient tensor's norm-relative error against the plain f32
  version and, for the feedforward update, against the plain version in
  float64 (the largest error per chain), and whether two launches gave
  the same bits;
- per update kernel, the tensor-core (``HMMA``, and of those ``TF32``) and
  f32 FMA (``FFMA``) instructions in its SASS (``cuobjdump -sass``);
- ``nvcc -Xptxas -v``'s registers and spills of the row passes.

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
from concurrent.futures import ThreadPoolExecutor
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
    # 32 sequences a recurrent row-pass block, one block to an SM.
    "rnn_rows32": [
        ("rnn_ppo.cu", "constexpr int kRows = 16;  // sequences", "constexpr int kRows = 32;  // sequences"),
        ("rnn_ppo.cu", "__global__ void __launch_bounds__(kThreads, 2)\n    rnn_rows_kernel(",
         "__global__ void __launch_bounds__(kThreads, 1)\n    rnn_rows_kernel("),
    ],
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def build(name: str, subs: list[tuple[str, str, str]]) -> tuple[Path, dict[str, str]]:
    """The variant's library and each source's ptxas report."""
    from rl8_tpu_torch.ops import _build

    src = REPO / "build" / "variants" / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    for file, old, new in subs:
        text = (src / file).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {file} has no {old[:60]!r}")
        (src / file).write_text(text.replace(old, new))
    nvcc = _build._nvcc()
    procs = {
        cu.stem: subprocess.Popen([nvcc, *_build._FLAGS, "-c", str(cu), "-o", str(cu.with_suffix(".o"))],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cu in sorted(src.glob("*.cu"))
    }
    logs = {stem: proc.communicate()[0] for stem, proc in procs.items()}
    for stem, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed on {stem}.cu:\n{logs[stem]}")
    lib = src / "lib.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                    *(str(cu.with_suffix(".o")) for cu in sorted(src.glob("*.cu"))), "-o", str(lib)], check=True)
    return lib, logs


def short(kernel: str) -> str | None:
    m = re.search(r"(ppo_rows_kernel<\w+>|rnn_rows_kernel<\w+>|reduce_\w+_kernel<\w+>|reduce_bias_kernel|"
                  r"sum_partials_kernel|sum_stats_kernel|transpose_kernel)", kernel)
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
            source = re.search(r"(ppo|rnn_ppo|chains)_cu", fn)
            kernel = re.search(r"(ppo_rows_kernel|rnn_rows_kernel|reduce_tiled_kernel)I?L?b?([01])?", fn)
            fn = f"{source.group(1)}.cu {kernel.group(1)}<{kernel.group(2)}>" if source and kernel else None
            continue
        if fn and ("HMMA" in line or "FFMA" in line):
            c = counts.setdefault(fn, {"HMMA": 0, "HMMA_TF32": 0, "FFMA": 0})
            if "HMMA" in line:
                c["HMMA"] += 1
                c["HMMA_TF32"] += "TF32" in line
            else:
                c["FFMA"] += 1
    return counts


def ptxas_rows(logs: dict[str, str]) -> list[str]:
    out, fn = [], None
    for stem in ("ppo", "rnn_ppo"):
        for line in logs[stem].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1) if "rows_kernel" in m.group(1) else None
            elif fn and ("registers" in line or "spill stores" in line):
                out.append(f"{stem}.cu: {line.strip().replace('ptxas info    : ', '')}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from rl8_tpu_torch.ops import PPOLossConfig, _build, fused_ppo, fused_rnn_ppo_grads, pack_rnn_params
    from rl8_tpu_torch.ops import rnn_ppo_grads_plain
    from rl8_tpu_torch.ops.fused_act import ActParams
    from rl8_tpu_torch.ops.fused_rnn_act import RnnParams
    from rl8_tpu_torch.specs import Discrete
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 check=True, capture_output=True, text=True).stdout.strip()})
    names = sys.argv[1:] or list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: build(n, VARIANTS[n]), names)))

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

    for name, (lib, logs) in built.items():
        _build._lib = None
        _build.build = lambda lib=lib: lib
        ff = lambda: fused_ppo.fused_ppo_grads(params, packed, unpack, ec, cfg)  # noqa: E731
        rnn = lambda: fused_rnn_ppo_grads(rnn_params, rnn_packed, rnn_unpack, ec, rnn_cfg)  # noqa: E731
        g1, g2 = ff()[2], ff()[2]
        r1, r2 = rnn()[2], rnn()[2]
        torch.cuda.synchronize()
        emit({
            "variant": name,
            "ppo_ms": cs.time_ms(torch, ff, iters=10, warmup=2)[0],
            "ppo_split_ms": split(ff),
            "ppo_worst_grad_vs_plain": chain_errors(g1, plain),
            "ppo_worst_grad_vs_float64": chain_errors(g1, f64),
            "plain_worst_grad_vs_float64": chain_errors(plain, f64),
            "rnn_ppo_ms": cs.time_ms(torch, rnn, iters=10, warmup=2)[0],
            "rnn_ppo_split_ms": split(rnn),
            "rnn_worst_grad_vs_plain": rnn_error(r1),
            "bit_identical": bool(torch.equal(g1, g2) and torch.equal(r1, r2)),
            "sass": sass_counts(lib),
            "ptxas": ptxas_rows(logs),
        })
    return 0


if __name__ == "__main__":
    sys.exit(main())

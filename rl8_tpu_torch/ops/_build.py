"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, which :func:`load` opens with
``ctypes``. The build happens at first use, from the sources in the
checkout, into ``build/kernels/`` at the repository root; the library's
name carries a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edited file is never served by a
stale build. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "build", "check", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    found = str(candidate) if candidate.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc was not found (looked in $CUDA_HOME/bin and on PATH): the"
            " CUDA kernels cannot be built on this machine."
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile the kernels if no build of the current sources exists;
    return the shared library's path. ``nvcc``'s ``-Xptxas -v`` report
    (registers, shared memory, spills per kernel) goes to
    ``ptxas.log`` beside the library."""
    sources = _sources()
    digest = hashlib.sha256()
    for src in sorted([*sources, *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    lib_path = BUILD_DIR / f"librl8_kernels-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objects)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *map(str, objects), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link the kernels:\n{link.stdout}")
        (BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
        os.replace(tmp_lib, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """Build (if needed) and open the kernel library, declaring every
    entry point's argument and return types."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.rl8_discrete_act.argtypes = [
            ptr, ptr, ptr, ptr, ptr,  # obs, params, actions, logp, values
            i32, i32, i32, ptr,  # B, d_in, n_layers, hidden (host int array)
            i32, i32, i32,  # n_logits, n_cat, act
            u32, u32, i32,  # seed, offset, deterministic
            i32, ptr,  # device, stream
        ]
        lib.rl8_discrete_act.restype = i32
        lib.rl8_continuous_act.argtypes = [
            ptr, ptr, ptr, ptr, ptr,  # obs, params, actions, logp, values
            i32, i32, i32, ptr,  # B, d_in, n_layers, hidden (host int array)
            i32, i32, i32,  # action_dim, act, squashed
            u32, u32, i32,  # seed, offset, deterministic
            i32, ptr,  # device, stream
        ]
        lib.rl8_continuous_act.restype = i32
        lib.rl8_gae.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, f32, f32, i32, ptr]
        lib.rl8_gae.restype = i32
        lib.rl8_gae_empty.argtypes = [i32, i32, ptr]  # B, device, stream
        lib.rl8_gae_empty.restype = i32
        # N, d_in, n_layers, hidden, kind, action_dim, n_cat
        lib.rl8_ppo_workspace.argtypes = [i32, i32, i32, ptr, i32, i32, i32]
        lib.rl8_ppo_workspace.restype = ctypes.c_longlong
        lib.rl8_ppo_grads.argtypes = [
            ptr, i32, i32, ptr,  # packed, N, D, column starts (host int[5])
            ptr, ptr, ptr, ptr, ptr,  # entropy coeff, params, grads, stats, workspace
            i32, i32, ptr,  # d_in, n_layers, hidden (host int array)
            i32, i32, i32, i32,  # kind, action_dim, n_cat, act
            f32, f32, f32, f32, f32, f32, i32,  # clip lo/hi, dual, vf clip, vf scale, scale, use_entropy
            i32, ptr,  # device, stream
        ]
        lib.rl8_ppo_grads.restype = i32
        lib.rl8_rnn_act.argtypes = [
            ptr, ptr, ptr, ptr,  # obs, h, c, params
            ptr, ptr, ptr, ptr, ptr,  # actions, logp, values, new h, new c
            i32, i32, i32, i32,  # B, d_in, H, K
            i32, i32, i32,  # kind, action_dim, n_cat
            u32, u32, i32,  # seed, offset, deterministic
            i32, ptr,  # device, stream
        ]
        lib.rl8_rnn_act.restype = i32
        # N, d_in, H, L, K, kind, action_dim, n_cat
        lib.rl8_rnn_ppo_workspace.argtypes = [i32] * 8
        lib.rl8_rnn_ppo_workspace.restype = ctypes.c_longlong
        lib.rl8_rnn_ppo_grads.argtypes = [
            ptr, i32, i32, ptr,  # packed, N, D, column starts (host int[7])
            ptr, ptr, ptr, ptr, ptr,  # entropy coeff, params, grads, stats, workspace
            i32, i32, i32, i32,  # d_in, H, L, K
            i32, i32, i32,  # kind, action_dim, n_cat
            f32, f32, f32, f32, f32, f32, i32,  # clip lo/hi, dual, vf clip, vf scale, scale, use_entropy
            i32, ptr,  # device, stream
        ]
        lib.rl8_rnn_ppo_grads.restype = i32
        i64 = ctypes.c_longlong
        # N, d_in, spec (host int array), spec length, backward
        lib.rl8_chains_workspace.argtypes = [i64, i32, ptr, i32, i32]
        lib.rl8_chains_workspace.restype = i64
        lib.rl8_chains_fwd.argtypes = [
            ptr, ptr, ptr,  # x, params, head outputs (host pointer array)
            i64, i32, ptr, i32, i32,  # N, d_in, spec, spec length, act
            i32, ptr,  # device, stream
        ]
        lib.rl8_chains_fwd.restype = i32
        lib.rl8_chains_bwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,  # x, params, head cotangents (host pointer array), dx, grads, workspace
            i64, i32, ptr, i32, i32,  # N, d_in, spec, spec length, act
            i32, ptr,  # device, stream
        ]
        lib.rl8_chains_bwd.restype = i32
        lib.rl8_cuda_error_string.argtypes = [i32]
        lib.rl8_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        message = load().rl8_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({message}).")

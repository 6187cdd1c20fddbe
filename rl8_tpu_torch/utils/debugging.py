"""Debugging and profiling aids (counterpart of ``rl8_tpu/utils/debugging.py``).

- :func:`trace`: capture a ``torch.profiler`` trace (host operators and,
  on the card, device kernels) of the enclosed block into a directory, as
  a Chrome/Perfetto trace file;
- :func:`debug_nans`: raise at the first operation whose floating output
  holds a NaN instead of letting it corrupt training. ATen operators are
  checked by a ``TorchDispatchMode``; the port's kernels launch through
  ``ctypes``, outside the dispatcher, so their wrappers check their own
  outputs (:func:`check_kernel_outputs`) while it is on.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Any, Generator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["trace", "debug_nans", "check_kernel_outputs"]

#: Whether NaN checks are on (set by :func:`debug_nans`).
_checking = {"nans": False}

#: Factory operators whose outputs are uninitialized memory, not results.
_UNINITIALIZED = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "resize_"})


@contextmanager
def trace(log_dir: str, /) -> Generator[None, None, None]:
    """Capture a profile of the enclosed block into ``log_dir`` (created if
    missing) as ``trace-<pid>-<time>.json``, viewable in Perfetto or
    ``chrome://tracing``: host operators, and device kernels where a card
    is present.

    Examples:
        >>> from rl8_tpu_torch.utils.debugging import trace
        >>> with trace("/tmp/rl8-trace"):  # doctest: +SKIP
        ...     algo.collect()
        ...     algo.step()

    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    profiler = torch.profiler.profile(activities=activities)
    with profiler:
        yield
    profiler.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _nan_in(tensors: Any) -> bool:
    if isinstance(tensors, torch.Tensor):
        return tensors.is_floating_point() and bool(torch.isnan(tensors).any())
    if isinstance(tensors, (list, tuple)):
        return any(_nan_in(t) for t in tensors)
    if isinstance(tensors, dict):
        return any(_nan_in(t) for t in tensors.values())
    return False


def check_kernel_outputs(what: str, *outputs: Any) -> None:
    """Raise ``FloatingPointError`` if NaN checks are on and a floating
    output of ``what`` (a kernel launch) holds a NaN."""
    if _checking["nans"] and _nan_in(outputs):
        raise FloatingPointError(f"NaN in the output of {what}.")


class _NanCheck(TorchDispatchMode):
    """Raises at the first ATen operator whose floating output holds a NaN."""

    def __torch_dispatch__(self, func: Any, types: Any, args: Any = (), kwargs: Any = None) -> Any:
        out = func(*args, **(kwargs or {}))
        if _checking["nans"] and func.overloadpacket.__name__ not in _UNINITIALIZED and _nan_in(out):
            raise FloatingPointError(f"NaN in the output of {func}.")
        return out


@contextmanager
def debug_nans(enable: bool = True, /) -> Generator[None, None, None]:
    """Raise ``FloatingPointError`` at the first operation of the enclosed
    block that outputs a NaN: every ATen operator and every kernel launch.

    Each check reads the output on the host, so expect a large slowdown;
    use it when a run diverges, to find the first NaN-producing operation.
    On exit the previous setting is restored.
    """
    prev = _checking["nans"]
    _checking["nans"] = enable
    try:
        with _NanCheck():
            yield
    finally:
        _checking["nans"] = prev

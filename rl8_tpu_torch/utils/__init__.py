"""Host-side utilities (counterpart of ``rl8_tpu/utils/__init__.py``)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Generator

__all__ = [
    "profile_ms",
    "reduce_stats",
    "memory_stats",
    "get_nested",
    "set_nested",
    "CumulativeAverage",
]


def get_nested(tree: Any, key: "str | tuple[str, ...]") -> Any:
    """Fetch ``tree[key]`` where ``key`` may be a tuple path into nested
    mappings (the view-requirement key convention)."""
    if isinstance(key, tuple):
        for k in key:
            tree = tree[k]
        return tree
    return tree[key]


def set_nested(out: dict, key: "str | tuple[str, ...]", value: Any) -> None:
    """Set ``out[key] = value`` where ``key`` may be a tuple path,
    creating intermediate dicts."""
    if isinstance(key, tuple):
        d = out
        for k in key[:-1]:
            d = d.setdefault(k, {})
        d[key[-1]] = value
    else:
        out[key] = value


@contextmanager
def profile_ms() -> Generator[Callable[[], float], None, None]:
    """Profiling context manager returning elapsed milliseconds on the
    host clock. Device work is included only where the timed block ends
    in a synchronizing read (as ``collect`` does with its stats fetch).

    Examples:
        >>> from rl8_tpu_torch.utils import profile_ms
        >>> with profile_ms() as timer:
        ...     pass
        >>> timer() >= 0.0
        True

    """
    start = time.perf_counter_ns()
    yield lambda: (time.perf_counter_ns() - start) / 1e6


def reduce_stats(x: dict[str, list[float]], /) -> dict[str, float]:
    """Reduce lists of metrics into scalars, dispatching on the key's
    ``/``-suffix: ``min``, ``max``, ``mean``, ``std`` (the root mean
    square of the stds) and a sum for anything else.

    Examples:
        >>> from rl8_tpu_torch.utils import reduce_stats
        >>> reduce_stats({"returns/mean": [1.0, 3.0], "env/steps": [4, 4]})
        {'returns/mean': 2.0, 'env/steps': 8}

    """
    y: dict[str, float] = {}
    for k, v in x.items():
        op = k.split("/")[-1]
        match op:
            case "min":
                y[k] = min(v)
            case "max":
                y[k] = max(v)
            case "mean":
                y[k] = sum(v) / len(v)
            case "std":
                y[k] = (sum(s**2 for s in v) / len(v)) ** 0.5
            case _:
                y[k] = sum(v)
    return y


def memory_stats(device: Any = "cuda") -> dict[str, Any]:
    """Free and total memory of ``device`` and the share in use: the card's
    (``torch.cuda.mem_get_info``) for a CUDA device, else the host's
    (``psutil``), or ``{}`` where ``psutil`` is not installed."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
    else:
        try:
            import psutil
        except ImportError:
            return {}
        svmem = psutil.virtual_memory()
        free, total = svmem.free, svmem.total
    return {
        "memory/free": free,
        "memory/total": total,
        "memory/percent": 100 * (total - free) / total if total else 0.0,
    }


class CumulativeAverage:
    """Running cumulative average.

    Examples:
        >>> from rl8_tpu_torch.utils import CumulativeAverage
        >>> ca = CumulativeAverage()
        >>> ca.update(0.0)
        0.0
        >>> ca.update(2.0)
        1.0

    """

    avg: float
    n: int

    def __init__(self) -> None:
        self.avg = 0.0
        self.n = 0

    def update(self, value: float, /) -> float:
        self.avg = (value + self.n * self.avg) / (self.n + 1)
        self.n += 1
        return self.avg

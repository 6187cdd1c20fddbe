"""Host-side utilities (counterpart of ``rl8_tpu/utils/__init__.py``)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Generator

__all__ = ["profile_ms", "get_nested", "set_nested"]


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

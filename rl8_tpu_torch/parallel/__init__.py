"""Batch statistics (single-device counterparts of the global reductions
in ``rl8_tpu/parallel/__init__.py``).

Multi-device execution is a later slice; until then each reduction is
over the whole local tensor, which is what the JAX package computes
with ``axis_name=None``.
"""

from __future__ import annotations

import torch

__all__ = ["gmax", "gmean", "gmin", "gstd", "is_main_process"]


def gmean(x: torch.Tensor) -> torch.Tensor:
    """Mean over all elements."""
    return x.mean()


def gstd(x: torch.Tensor) -> torch.Tensor:
    """SAMPLE standard deviation (``ddof=1``) over all elements, as the
    reward scale, advantage normalization and return metrics use."""
    return x.std(correction=1)


def gmin(x: torch.Tensor) -> torch.Tensor:
    return x.min()


def gmax(x: torch.Tensor) -> torch.Tensor:
    return x.max()


def is_main_process() -> bool:
    """Whether this is process 0, the one that logs metrics: every process
    of a single-process run, and rank 0 where ``torch.distributed`` is
    initialized."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0

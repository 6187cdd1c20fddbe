"""Views: batch preprocessing that creates overlapping time-series windows
prior to feeding samples into a policy's model.

PyTorch counterpart of ``rl8_tpu/views.py``. Batches are nested dicts of
tensors with leading ``[B, T, ...]`` dims; keys may be strings or tuples
of strings for nested access.
"""

from __future__ import annotations

from typing import Any, Callable, Literal, Protocol

import torch

from .data import DataKeys
from .utils import get_nested

__all__ = [
    "ViewKind",
    "ViewMethod",
    "View",
    "ViewRequirement",
    "RollingWindow",
    "PaddedRollingWindow",
    "rolling_window",
    "pad_last_sequence",
    "pad_whole_sequence",
    "tree_map",
]

ViewKind = Literal["last", "all"]
ViewMethod = Literal["rolling_window", "padded_rolling_window"]

Batch = Any  # nested dicts of tensors with leading [B, T, ...] dims


class View(Protocol):
    """A view method protocol."""

    @staticmethod
    def apply_all(x: Batch, size: int, /) -> Batch:
        ...

    @staticmethod
    def apply_last(x: Batch, size: int, /) -> Batch:
        ...

    @staticmethod
    def drop_size(size: int, /) -> int:
        ...


def tree_map(fn: Callable[[torch.Tensor], Any], x: Batch) -> Batch:
    """Apply ``fn`` to every tensor of a nested dict (or to a bare tensor)."""
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def rolling_window(x: torch.Tensor, size: int, /, *, step: int = 1) -> torch.Tensor:
    """Map the time dimension of ``x [B, T, ...]`` into rolling windows,
    returning ``[B, (T - size) // step + 1, size, ...]``.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.views import rolling_window
        >>> rolling_window(torch.arange(5).reshape(1, 5), 3).tolist()
        [[[0, 1, 2], [1, 2, 3], [2, 3, 4]]]

    """
    T = x.shape[1]
    if T < size:
        raise ValueError(
            f"Cannot build rolling windows of size {size} over a time"
            f" dimension of length {T}. Use `padded_rolling_window`, or"
            " collect a longer horizon."
        )
    num_windows = (T - size) // step + 1
    starts = torch.arange(num_windows, device=x.device) * step
    idx = starts[:, None] + torch.arange(size, device=x.device)[None, :]
    return x[:, idx]


def pad_last_sequence(x: torch.Tensor, size: int, /) -> dict[str, torch.Tensor]:
    """Left-pad ``x [B, T, ...]`` so selecting the last ``size`` elements
    always yields a full window; ``True`` mask entries are padding."""
    B, T = x.shape[:2]
    pad = size - T
    if pad > 0:
        padding = x.new_zeros((B, pad, *x.shape[2:]))
        inputs = torch.cat([padding, x], dim=1)
        mask = torch.cat(
            [
                torch.ones((B, pad), dtype=torch.bool, device=x.device),
                torch.zeros((B, T), dtype=torch.bool, device=x.device),
            ],
            dim=1,
        )
    else:
        inputs = x[:, -size:]
        mask = torch.zeros((B, size), dtype=torch.bool, device=x.device)
    return {DataKeys.INPUTS: inputs, DataKeys.PADDING_MASK: mask}


def pad_whole_sequence(x: torch.Tensor, size: int, /) -> dict[str, torch.Tensor]:
    """Left-pad ``x [B, T, ...]`` so a subsequent :func:`rolling_window`
    keeps all ``T`` positions."""
    B, T = x.shape[:2]
    pad = RollingWindow.drop_size(size)
    inputs = torch.cat([x.new_zeros((B, pad, *x.shape[2:])), x], dim=1)
    mask = torch.cat(
        [
            torch.ones((B, pad), dtype=torch.bool, device=x.device),
            torch.zeros((B, T), dtype=torch.bool, device=x.device),
        ],
        dim=1,
    )
    return {DataKeys.INPUTS: inputs, DataKeys.PADDING_MASK: mask}


class RollingWindow:
    """Rolling windows without masking, dropping the first ``size - 1``
    samples of each sequence."""

    @staticmethod
    def apply_all(x: Batch, size: int, /) -> Batch:
        """``[B, T, ...] -> [B * (T - size + 1), size, ...]``."""
        return tree_map(
            lambda t: rolling_window(t, size).reshape(-1, size, *t.shape[2:]), x
        )

    @staticmethod
    def apply_last(x: Batch, size: int, /) -> Batch:
        """``[B, T, ...] -> [B, min(T, size), ...]``."""
        return tree_map(lambda t: t[:, -size:], x)

    @staticmethod
    def drop_size(size: int, /) -> int:
        return size - 1


class PaddedRollingWindow:
    """:class:`RollingWindow` with padding and masking applied beforehand
    so no samples are dropped."""

    @staticmethod
    def apply_all(x: Batch, size: int, /) -> Batch:
        return tree_map(
            lambda t: RollingWindow.apply_all(pad_whole_sequence(t, size), size), x
        )

    @staticmethod
    def apply_last(x: Batch, size: int, /) -> Batch:
        return tree_map(lambda t: pad_last_sequence(t, size), x)

    @staticmethod
    def drop_size(size: int, /) -> int:
        return 0


class ViewRequirement:
    """Batch preprocessing requirement applied to one batch key before the
    model forward pass.

    Args:
        shift: Number of *additional previous* samples along the time axis
            to include in the output (``shift=0`` passes through).
        method: ``"rolling_window"`` (drops early samples) or
            ``"padded_rolling_window"`` (pads + masks; default).

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.views import ViewRequirement
        >>> batch = {"obs": torch.arange(4.0).reshape(1, 4, 1)}
        >>> req = ViewRequirement(shift=1, method="rolling_window")
        >>> req.apply_last("obs", batch).tolist()
        [[[2.0], [3.0]]]
        >>> tuple(req.apply_all("obs", batch).shape)
        (3, 2, 1)

    """

    method: type[View]
    shift: int

    def __init__(
        self, *, shift: int = 0, method: ViewMethod = "padded_rolling_window"
    ) -> None:
        if shift < 0:
            raise ValueError(f"{self.__class__.__name__} `shift` must be non-negative.")
        self.shift = shift
        match method:
            case "rolling_window":
                self.method = RollingWindow
            case "padded_rolling_window":
                self.method = PaddedRollingWindow
            case _:
                raise ValueError(f"No view method for {method}.")

    def apply_all(self, key: str | tuple[str, ...], batch: Batch, /) -> Batch:
        """Apply the view over all time elements, folding time into batch
        (a plain ``[B, T, ...] -> [B * T, ...]`` flatten for ``shift=0``)."""
        item = tree_map(torch.Tensor.detach, get_nested(batch, key))
        if not self.shift:
            return tree_map(lambda t: t.reshape(-1, *t.shape[2:]), item)
        return self.method.apply_all(item, self.shift + 1)

    def apply_last(self, key: str | tuple[str, ...], batch: Batch, /) -> Batch:
        """Apply the view to just the last time elements (``[:, -1]`` for
        ``shift=0``)."""
        item = tree_map(torch.Tensor.detach, get_nested(batch, key))
        if not self.shift:
            return tree_map(lambda t: t[:, -1], item)
        return self.method.apply_last(item, self.shift + 1)

    @property
    def drop_size(self) -> int:
        """Samples dropped along time per batch element."""
        return self.method.drop_size(self.shift + 1)

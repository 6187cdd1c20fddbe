"""Tensor-spec system describing environment/model IO.

PyTorch counterpart of ``rl8_tpu/specs.py``: the same ``Unbounded``,
``Bounded``, ``Discrete`` and ``Composite`` leaves and the same
membership checks, with ``torch`` dtypes and tensors. Array-producing
methods take the device (and, for random draws, the
``torch.Generator``) explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping

import numpy as np
import torch

__all__ = [
    "Spec",
    "TensorSpec",
    "Unbounded",
    "Bounded",
    "Discrete",
    "Composite",
    "assert_1d_spec",
    "assert_nd_spec",
]


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Base leaf spec: a shape, a dtype, and membership semantics."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def zero(
        self, batch_shape: tuple[int, ...] = (), device: Any = "cpu"
    ) -> torch.Tensor:
        """Return a zero-filled tensor of shape ``[*batch_shape, *self.shape]``."""
        return torch.zeros((*batch_shape, *self.shape), dtype=self.dtype, device=device)

    def rand(
        self,
        generator: torch.Generator,
        batch_shape: tuple[int, ...] = (),
        device: Any = "cpu",
    ) -> torch.Tensor:
        raise NotImplementedError

    def contains(self, x: Any) -> bool:
        """Host-side membership check on shape/dtype kind (and bounds)."""
        x = _to_numpy(x)
        if x.ndim < self.ndim or tuple(x.shape[x.ndim - self.ndim :]) != self.shape:
            return False
        return self._contains_values(x)

    def _contains_values(self, x: np.ndarray) -> bool:
        return True

    def assert_is_in(self, x: Any) -> None:
        if not self.contains(x):
            raise AssertionError(f"Value with shape {tuple(_to_numpy(x).shape)} is not in {self}.")

    def encode(self, x: Any, device: Any = "cpu") -> torch.Tensor:
        """Convert external data (NumPy/lists) into a tensor matching the spec."""
        return torch.as_tensor(x, dtype=self.dtype, device=device)


def _normalize_shape(shape: int | tuple[int, ...] | list[int]) -> tuple[int, ...]:
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


class Unbounded(TensorSpec):
    """Continuous, unbounded spec."""

    def __init__(self, shape: int | tuple[int, ...] = (), dtype: torch.dtype = torch.float32) -> None:
        super().__init__(shape=_normalize_shape(shape), dtype=dtype)

    def rand(
        self,
        generator: torch.Generator,
        batch_shape: tuple[int, ...] = (),
        device: Any = "cpu",
    ) -> torch.Tensor:
        shape = (*batch_shape, *self.shape)
        if self.dtype == torch.bool:
            return torch.randint(0, 2, shape, generator=generator, device=device).bool()
        if not self.dtype.is_floating_point:
            info = torch.iinfo(self.dtype)
            return torch.randint(
                info.min, info.max, shape, generator=generator, device=device, dtype=self.dtype
            )
        return torch.randn(shape, generator=generator, device=device, dtype=self.dtype)


@dataclasses.dataclass(frozen=True)
class Bounded(TensorSpec):
    """Continuous spec with elementwise bounds."""

    low: float = -1.0
    high: float = 1.0

    def __init__(
        self,
        shape: int | tuple[int, ...] = (),
        *,
        low: float = -1.0,
        high: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        object.__setattr__(self, "shape", _normalize_shape(shape))
        object.__setattr__(self, "dtype", dtype)
        object.__setattr__(self, "low", float(low))
        object.__setattr__(self, "high", float(high))

    def rand(
        self,
        generator: torch.Generator,
        batch_shape: tuple[int, ...] = (),
        device: Any = "cpu",
    ) -> torch.Tensor:
        u = torch.rand(
            (*batch_shape, *self.shape), generator=generator, device=device, dtype=self.dtype
        )
        return self.low + (self.high - self.low) * u

    def _contains_values(self, x: np.ndarray) -> bool:
        return bool(np.all(x >= self.low) and np.all(x <= self.high))


@dataclasses.dataclass(frozen=True)
class Discrete(TensorSpec):
    """Categorical/discrete spec with ``n`` categories per element.

    Examples:
        >>> from rl8_tpu_torch.specs import Discrete
        >>> spec = Discrete(3, shape=(1,))
        >>> spec.zero((2,)).tolist()
        [[0], [0]]
        >>> spec.contains([[2]]), spec.contains([[3]])
        (True, False)

    """

    n: int = 2

    def __init__(
        self, n: int, shape: int | tuple[int, ...] = (1,), *, dtype: torch.dtype = torch.int32
    ) -> None:
        object.__setattr__(self, "shape", _normalize_shape(shape))
        object.__setattr__(self, "dtype", dtype)
        object.__setattr__(self, "n", int(n))

    def rand(
        self,
        generator: torch.Generator,
        batch_shape: tuple[int, ...] = (),
        device: Any = "cpu",
    ) -> torch.Tensor:
        return torch.randint(
            0, self.n, (*batch_shape, *self.shape),
            generator=generator, device=device, dtype=self.dtype,
        )

    def _contains_values(self, x: np.ndarray) -> bool:
        # Integral values only: a fractional "action" passing a
        # bounds-only check would silently truncate in `encode`.
        if not (np.issubdtype(x.dtype, np.integer) or x.dtype == np.bool_):
            return False
        return bool(np.all(x >= 0) and np.all(x < self.n))


class Composite(Mapping[str, "Spec"]):
    """A dict of specs; ``zero``/``rand`` return plain dicts of tensors."""

    def __init__(self, specs: Mapping[str, "Spec"] | None = None, **kwargs: "Spec") -> None:
        items = dict(specs or {})
        items.update(kwargs)
        self._specs: dict[str, Spec] = items

    def __getitem__(self, key: str) -> "Spec":
        return self._specs[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._specs)

    def __len__(self) -> int:
        return len(self._specs)

    def __hash__(self) -> int:
        return hash(tuple(sorted((k, v) for k, v in self._specs.items())))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Composite) and self._specs == other._specs

    def __repr__(self) -> str:
        return f"Composite({self._specs!r})"

    def set(self, key: str, spec: "Spec") -> "Composite":
        """Return a new composite with ``key`` set to ``spec``."""
        items = dict(self._specs)
        items[key] = spec
        return Composite(items)

    def zero(self, batch_shape: tuple[int, ...] = (), device: Any = "cpu") -> dict[str, Any]:
        return {k: v.zero(batch_shape, device) for k, v in self._specs.items()}

    def rand(
        self,
        generator: torch.Generator,
        batch_shape: tuple[int, ...] = (),
        device: Any = "cpu",
    ) -> dict[str, Any]:
        return {k: v.rand(generator, batch_shape, device) for k, v in self._specs.items()}

    def contains(self, x: Any) -> bool:
        if not isinstance(x, Mapping):
            return False
        return all(k in x and v.contains(x[k]) for k, v in self._specs.items())

    def assert_is_in(self, x: Any) -> None:
        if not self.contains(x):
            raise AssertionError(f"Value is not in {self}.")

    def encode(self, x: Mapping[str, Any], device: Any = "cpu") -> dict[str, Any]:
        return {k: v.encode(x[k], device) for k, v in self._specs.items()}

    @property
    def ndim(self) -> int:
        return min(v.ndim for v in self._specs.values()) if self._specs else 0


Spec = TensorSpec | Composite


def assert_1d_spec(spec: Spec, /) -> None:
    """Check the spec is 1D, as required by default models/distributions."""
    if not (isinstance(spec, TensorSpec) and spec.ndim == 1):
        raise AssertionError(
            f"{spec} is not compatible with default models and"
            " distributions. Tensor specs must have shape ``[N]`` to be"
            " compatible with default models and distributions."
        )


def assert_nd_spec(spec: Spec, /) -> None:
    """Check the spec is at least 1D (recursing through composites)."""
    if isinstance(spec, Composite):
        for k in spec:
            assert_nd_spec(spec[k])
    elif spec.ndim < 1:
        raise AssertionError(
            f"{spec} is not a valid spec. Specs must have a non-empty shape "
            "``[N, ...]`` to interface with models and distributions."
        )

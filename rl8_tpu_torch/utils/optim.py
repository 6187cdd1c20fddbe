"""The update's optimizer: clip by global norm, then an optimizer, over
the flat f32 parameter vector.

Counterpart of ``optax.chain(optax.clip_by_global_norm(max_grad_norm),
opt(lr, ...))``, wrapped by ``rl8_tpu/utils/optim.py``'s
``flatten_optimizer`` or not, with the learning rate set each step as
``optax.inject_hyperparams`` does. Two optimizers take the clipped
gradient:

- :func:`adam_step`, the default (``optimizer_cls=None``): optax's
  ``adam`` written out by hand, functional, over one flat vector;
- :class:`TorchOptimizer`: any ``torch.optim.Optimizer`` class (the
  counterpart of an optax factory), over one flat vector
  (``flatten_optimizer=True``) or one view of it per model leaf
  (``False``: per-leaf state, as ``rl8_tpu``'s unflattened optimizer
  keeps it).

optax's semantics are written out by hand:

- the clip has no epsilon: ``g * max_norm / ||g||`` unless
  ``||g|| < max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
  the norm and so differs);
- Adam's step count is incremented first, and the moments are bias
  corrected: ``m_hat / (sqrt(v_hat + eps_root) + eps)``.

Every tensor stays on the parameters' device; nothing is read back to
the host, so a caller can gate an update on a device flag (``apply``).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

__all__ = ["Adam", "AdamState", "OptimizerState", "TorchOptimizer", "adam_step", "clip_by_global_norm"]


def clip_by_global_norm(grads: torch.Tensor, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` of a flat gradient: ``g * max_norm /
    ||g||`` unless ``||g|| < max_norm``, with no epsilon."""
    norm = torch.linalg.vector_norm(grads)
    return torch.where(norm < max_norm, grads, grads / norm * max_norm)


@dataclass(frozen=True)
class Adam:
    """Adam's hyperparameters other than the learning rate (optax's
    ``adam`` defaults)."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0


@dataclass
class AdamState:
    """Adam's moments (flat f32, the parameters' layout) and its step
    count (0-d int32), all on the parameters' device."""

    m: torch.Tensor
    v: torch.Tensor
    count: torch.Tensor

    @classmethod
    def zeros_like(cls, params: torch.Tensor) -> "AdamState":
        return cls(
            m=torch.zeros_like(params),
            v=torch.zeros_like(params),
            count=torch.zeros((), dtype=torch.int32, device=params.device),
        )


def adam_step(
    params: torch.Tensor,
    grads: torch.Tensor,
    state: AdamState,
    *,
    lr: float,
    max_grad_norm: float,
    adam: Adam,
    apply: torch.Tensor | None = None,
) -> tuple[torch.Tensor, AdamState]:
    """One clipped Adam update of the flat ``params``.

    Args:
        params: Flat f32 parameters.
        grads: Their gradient, same shape.
        state: Adam's state before the update.
        lr: This step's learning rate.
        max_grad_norm: Global-norm clip threshold.
        adam: Adam's other hyperparameters.
        apply: Optional 0-d bool device tensor; where it is false the
            parameters and the state come back unchanged (the
            ``lax.cond`` that skips an update after a KL early stop).

    Returns:
        ``(new_params, new_state)``.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.utils.optim import Adam, AdamState, adam_step
        >>> p = torch.zeros(3)
        >>> p, s = adam_step(p, torch.tensor([3.0, -4.0, 0.0]), AdamState.zeros_like(p),
        ...                  lr=0.1, max_grad_norm=1.0, adam=Adam())
        >>> [round(x, 4) for x in p.tolist()], int(s.count)
        ([-0.1, 0.1, 0.0], 1)

    """
    grads = clip_by_global_norm(grads, max_grad_norm)
    count = state.count + 1
    m = (1 - adam.b1) * grads + adam.b1 * state.m
    v = (1 - adam.b2) * grads**2 + adam.b2 * state.v
    steps = count.to(torch.float32)
    m_hat = m / (1 - adam.b1**steps)
    v_hat = v / (1 - adam.b2**steps)
    new_params = params + -lr * (m_hat / (torch.sqrt(v_hat + adam.eps_root) + adam.eps))
    if apply is None:
        return new_params, AdamState(m=m, v=v, count=count)
    return torch.where(apply, new_params, params), AdamState(
        m=torch.where(apply, m, state.m),
        v=torch.where(apply, v, state.v),
        count=torch.where(apply, count, state.count),
    )


@dataclass
class OptimizerState:
    """A :class:`TorchOptimizer`'s state as a checkpointable tree: each
    parameter's ``torch.optim`` state (``state_dict()["state"]``, keyed by
    the parameter's index as a string) and whether the optimizer has
    stepped (its state is created at the first step)."""

    per_param: dict[str, dict[str, Any]] = field(default_factory=dict)
    stepped: bool = False


class TorchOptimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), opt)`` with ``opt``
    a ``torch.optim.Optimizer``, over a flat f32 parameter vector.

    The optimizer updates :attr:`flat` in place: as one tensor, or through
    one view per leaf of ``shapes`` (per-leaf state). It is built with
    ``lr=`` and the other keywords, and ``capturable=True`` on the card
    where the class takes it (its step count then stays on the device).

    Args:
        optimizer_cls: A ``torch.optim.Optimizer`` subclass (or a callable
            ``(params, lr=..., **kwargs)`` returning one).
        flat: The initial parameters (copied).
        lr: The initial learning rate.
        shapes: The leaves' shapes, in ``flat``'s order; ``None`` is one
            flat tensor.
        kwargs: The optimizer's other keywords.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.utils.optim import TorchOptimizer
        >>> opt = TorchOptimizer(torch.optim.SGD, torch.zeros(3), lr=0.1, shapes=[(1,), (2,)])
        >>> opt.step(torch.tensor([3.0, -4.0, 0.0]), lr=0.1, max_grad_norm=1.0)
        >>> [round(x, 4) for x in opt.flat.tolist()]
        [-0.06, 0.08, 0.0]

    """

    def __init__(
        self,
        optimizer_cls: Any,
        flat: torch.Tensor,
        *,
        lr: float,
        shapes: None | Sequence[Sequence[int]] = None,
        **kwargs: Any,
    ) -> None:
        self.flat = flat.detach().to(torch.float32).clone()
        if shapes is None:
            self.params = [self.flat]
        else:
            sizes = [torch.Size(s).numel() for s in shapes]
            if sum(sizes) != self.flat.numel():
                raise ValueError(f"The leaves take {sum(sizes)} values; the flat vector has {self.flat.numel()}.")
            self.params = [t.view(tuple(s)) for t, s in zip(self.flat.split(sizes), shapes)]
        try:
            takes_capturable = "capturable" in inspect.signature(optimizer_cls).parameters
        except (TypeError, ValueError):
            takes_capturable = False
        if self.flat.device.type == "cuda" and takes_capturable:
            kwargs.setdefault("capturable", True)
        self.optimizer = optimizer_cls(self.params, lr=lr, **kwargs)
        if not isinstance(self.optimizer, torch.optim.Optimizer):
            raise TypeError(
                f"optimizer_cls must build a torch.optim.Optimizer; {optimizer_cls!r} built a"
                f" {type(self.optimizer).__name__}."
            )
        self._stepped = False
        self._exported = self.export()

    def export(self) -> OptimizerState:
        """The optimizer's state as an :class:`OptimizerState` (its
        tensors are the live ones, not copies)."""
        state = self.optimizer.state
        self._exported = OptimizerState(
            per_param={str(i): dict(state[p]) for i, p in enumerate(self.params) if p in state},
            stepped=self._stepped,
        )
        return self._exported

    def bind(self, flat: torch.Tensor, state: OptimizerState) -> torch.Tensor:
        """Start an update from the parameters ``flat`` and ``state``:
        copy ``flat`` into :attr:`flat`, load ``state`` unless it is the
        one :meth:`export` returned last (a restored checkpoint's is
        not), and return :attr:`flat`."""
        self.flat.copy_(flat)
        if state is not self._exported:
            saved = self.optimizer.state_dict()
            saved["state"] = {int(k): dict(v) for k, v in state.per_param.items()}
            self.optimizer.load_state_dict(saved)
            self._stepped = state.stepped
            self._exported = state
        return self.flat

    def _device_gated(self) -> bool:
        """Whether an update can be gated on the device: the state exists
        (it is created at the first step) and is all tensors on the
        parameters' device."""
        return self._stepped and all(
            isinstance(v, torch.Tensor) and v.device == self.flat.device
            for d in self.optimizer.state.values()
            for v in d.values()
        )

    def step(
        self, grads: torch.Tensor, *, lr: float, max_grad_norm: float, apply: None | torch.Tensor = None
    ) -> None:
        """One clipped update of :attr:`flat` from the flat ``grads``.

        Args:
            grads: The flat gradient.
            lr: This step's learning rate.
            max_grad_norm: Global-norm clip threshold.
            apply: Optional 0-d bool device tensor; where it is false the
                parameters and the state are left as they were (the
                ``lax.cond`` that skips an update after a KL early stop):
                the update runs and every tensor it changed is restored
                with ``torch.where``. Before the first step, and for a
                state that is not all tensors on the device (a class
                without ``capturable``, such as ``Adagrad``, counts its
                steps on the host), the flag is read on the host.
        """
        grads = clip_by_global_norm(grads, max_grad_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        off = 0
        for p in self.params:
            p.grad = grads[off : off + p.numel()].view_as(p)
            off += p.numel()
        if apply is None:
            self.optimizer.step()
            self._stepped = True
            return
        if not self._device_gated():
            if bool(apply):
                self.optimizer.step()
                self._stepped = True
            return
        saved = [(d, k, v.clone()) for d in self.optimizer.state.values() for k, v in d.items()]
        old = self.flat.clone()
        self.optimizer.step()
        self.flat.copy_(torch.where(apply, self.flat, old))
        for d, k, v in saved:
            d[k].copy_(torch.where(apply, d[k], v))

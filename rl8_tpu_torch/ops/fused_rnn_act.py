"""Recurrent act kernel: stacked LSTM cells, the heads and sampling in one
launch per rollout step.

PyTorch/CUDA counterpart of ``rl8_tpu/ops/fused_rnn_act.py`` (the Pallas
``_kernel``), for ``DefaultDiscreteRecurrentModel`` with ``Categorical``
and ``DefaultContinuousRecurrentModel`` with ``Normal`` or
``SquashedNormal``; the kernel is ``csrc/rnn_act.cu``, one body with a
discrete and a continuous branch.

:func:`fused_rnn_act` launches the kernel for CUDA tensors and raises if
it cannot; for CPU tensors it runs :func:`rnn_act_plain`, the same
function in plain PyTorch (with the kernel's Philox draws replayed by
``ops/distmath.py``), which is also what the kernel is held against.
:func:`pack_rnn_params` lays the parameters out as both recurrent kernels
read them, the counterpart of ``rl8_tpu``'s ``_concat_lstm_params``,
``_head_layout`` and ``_head_params``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..data import DataKeys
from ._build import check, load
from .distmath import philox_normal, philox_uniform, sample_continuous_actions, sample_discrete_actions

__all__ = [
    "MAX_RNN_LAYERS",
    "RNN_KINDS",
    "RnnParams",
    "fused_rnn_act",
    "load_rnn_params",
    "lstm_cell",
    "pack_rnn_params",
    "rnn_act_plain",
    "rnn_head_names",
]

#: Stacked LSTM layers the kernels take, as in ``rl8_tpu``.
MAX_RNN_LAYERS = 8
#: Distribution kinds the kernels sample and score (the position is the
#: kernels' ``kind`` code, as in ``fused_act.KINDS``).
RNN_KINDS = ("categorical", "normal", "squashed")


def lstm_cell(
    x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, tuple[torch.Tensor, ...], torch.Tensor]:
    """One LSTM cell as flax's ``OptimizedLSTMCell`` computes it:
    ``z = (h Wh + b) + x Wi`` with gates i, f, g, o side by side in ``z``;
    sigmoid on i, f, o and tanh on g; ``c' = f c + i g``; ``h' = o
    tanh(c')``. Returns ``(h', c', (i, f, g, o), tanh(c'))``."""
    z = (h @ wh + b) + x @ wi
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg), torch.sigmoid(zo)
    c_new = f * c + i * g
    tc = torch.tanh(c_new)
    return o * tc, c_new, (i, f, g, o), tc


def rnn_head_names(model: Any) -> tuple[str, ...]:
    """A default recurrent model's head submodules in kernel order, which
    are also their names in the flax tree: the policy heads, then the
    value head."""
    from ..models import DefaultContinuousRecurrentModel, DefaultDiscreteRecurrentModel

    if type(model) is DefaultDiscreteRecurrentModel:
        return ("feature_head", "vf_head")
    if type(model) is DefaultContinuousRecurrentModel:
        return ("action_mean", "action_log_std", "vf_model")
    raise TypeError(f"No recurrent kernel layout is known for {type(model).__name__}.")


@dataclass(frozen=True)
class RnnParams:
    """A default recurrent model's parameters packed for the kernels:
    ``flat`` holds, per layer, ``Wi [d_l, 4H]``, ``Wh [H, 4H]`` and ``b
    [4H]`` (gates i, f, g, o side by side), then each head's ``W [H,
    width]`` and ``b [width]`` in :func:`rnn_head_names` order."""

    flat: torch.Tensor
    d_in: int
    #: ``H``.
    hidden: int
    #: ``K``.
    num_layers: int
    #: Action components ``A``.
    action_dim: int
    #: Categories per action component (categorical only; 0 otherwise).
    n: int
    #: One of :data:`RNN_KINDS`.
    kind: str

    @property
    def continuous(self) -> bool:
        return self.kind != "categorical"

    @property
    def head_widths(self) -> tuple[int, ...]:
        """The heads' widths: ``A * n`` logits, or the mean and the
        pre-tanh log-std (``A`` each); then the value."""
        if self.continuous:
            return (self.action_dim, self.action_dim, 1)
        return (self.action_dim * self.n, 1)

    def _views(self) -> list[torch.Tensor]:
        H = self.hidden
        shapes: list[tuple[int, ...]] = []
        for l in range(self.num_layers):
            shapes += [(self.d_in if l == 0 else H, 4 * H), (H, 4 * H), (4 * H,)]
        for width in self.head_widths:
            shapes += [(H, width), (width,)]
        sizes = [int(torch.Size(shape).numel()) for shape in shapes]
        if sum(sizes) != self.flat.numel():
            raise ValueError(f"The flat vector has {self.flat.numel()} values; the layout takes {sum(sizes)}.")
        return [part.view(shape) for part, shape in zip(self.flat.split(sizes), shapes)]

    def lstm(self) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Per layer ``(Wi, Wh, b)``, views into :attr:`flat`."""
        v = self._views()
        return [tuple(v[3 * l : 3 * l + 3]) for l in range(self.num_layers)]  # type: ignore[misc]

    def heads(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Per head ``(W [H, width], b [width])``, views into :attr:`flat`."""
        v = self._views()[3 * self.num_layers :]
        return [(v[2 * j], v[2 * j + 1]) for j in range(len(self.head_widths))]


def _layout(model: Any, squashed: bool = False) -> dict[str, Any]:
    """Everything but ``flat`` of a default recurrent model's
    :class:`RnnParams`."""
    continuous = len(rnn_head_names(model)) == 3
    if squashed and not continuous:
        raise ValueError("Only the continuous model's actions can be squashed.")
    if not 1 <= model.num_layers <= MAX_RNN_LAYERS:
        raise ValueError(f"The recurrent kernels take 1 to {MAX_RNN_LAYERS} LSTM layers.")
    return dict(
        d_in=model.observation_spec.shape[0],
        hidden=model.hidden_size,
        num_layers=model.num_layers,
        action_dim=model.action_spec.shape[0],
        n=0 if continuous else model.action_spec.n,
        kind=("squashed" if squashed else "normal") if continuous else "categorical",
    )


def pack_rnn_params(model: Any, *, squashed: bool = False) -> RnnParams:
    """Pack a default recurrent model's current parameters (a copy, on the
    model's device) for the recurrent kernels. The discrete model's kind
    is ``"categorical"``; the continuous model's is ``"squashed"`` when
    ``squashed`` (``SquashedNormal``), else ``"normal"``."""
    layout = _layout(model, squashed)
    lstm = model.lstm
    parts = []
    with torch.no_grad():
        for l in range(model.num_layers):
            parts += [lstm.wi[l].reshape(-1), lstm.wh[l].reshape(-1), lstm.b[l].reshape(-1)]
        for name in rnn_head_names(model):
            head = getattr(model, name)
            parts += [head.weight.t().reshape(-1), head.bias.reshape(-1)]
        flat = torch.cat(parts).to(torch.float32).contiguous()
    return RnnParams(flat=flat, **layout)


def load_rnn_params(model: Any, flat: torch.Tensor) -> None:
    """Write a flat vector in :class:`RnnParams` order back into a default
    recurrent model's parameters, in place: the inverse of
    :func:`pack_rnn_params`."""
    params = RnnParams(flat=flat, **_layout(model))
    with torch.no_grad():
        for l, (wi, wh, b) in enumerate(params.lstm()):
            model.lstm.wi[l].copy_(wi)
            model.lstm.wh[l].copy_(wh)
            model.lstm.b[l].copy_(b)
        for name, (w, b) in zip(rnn_head_names(model), params.heads()):
            getattr(model, name).weight.copy_(w.t())
            getattr(model, name).bias.copy_(b)


def _state_cols(states: Any) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``[B, K, H]`` hidden and cell states as ``[B, K*H]`` f32."""
    h, c = states[DataKeys.HIDDEN_STATES], states[DataKeys.CELL_STATES]
    B = h.shape[0]
    return h.reshape(B, -1).to(torch.float32), c.reshape(B, -1).to(torch.float32)


def rnn_act_plain(
    params: RnnParams,
    obs: torch.Tensor,
    states: Any,
    key: tuple[int, int],
    *,
    deterministic: bool,
    noise: None | torch.Tensor = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """Plain PyTorch version of the recurrent act kernel.

    Args:
        params: Packed model parameters.
        obs: f32 observations ``[B, d_in]`` of this step.
        states: ``{hidden_states, cell_states}``, each ``[B, K, H]``.
        key: The step's Philox ``(seed, offset)``; its draws are the
            kernel's (ignored when deterministic or when ``noise`` is
            given).
        deterministic: Take the per-group argmax, or the mean (squashed
            when the kind is), instead of sampling.
        noise: Optional draws to use in place of Philox's: uniforms
            ``[B, A * n]`` for the categorical kind, standard normals
            ``[B, A]`` for the continuous kinds.

    Returns:
        ``(actions [B, A], logp [B, 1], values [B, 1], new_states)``;
        actions are int32 for the categorical kind and f32 otherwise.

    """
    H, K = params.hidden, params.num_layers
    h, c = _state_cols(states)
    B = obs.shape[0]
    x = obs
    hs, cs = [], []
    for l, (wi, wh, b) in enumerate(params.lstm()):
        x, c_new = lstm_cell(x, h[:, l * H : (l + 1) * H], c[:, l * H : (l + 1) * H], wi, wh, b)[:2]
        hs.append(x)
        cs.append(c_new)
    outs = [x @ w + b for w, b in params.heads()]
    A = params.action_dim
    if params.continuous:
        if not deterministic and noise is None:
            noise = philox_normal(*key, B, A, obs.device)
        actions, logp = sample_continuous_actions(
            outs[0], outs[1], deterministic, params.kind == "squashed", noise
        )
    else:
        if not deterministic and noise is None:
            noise = philox_uniform(*key, B, A, params.n, obs.device)
        actions, logp = sample_discrete_actions(outs[0], params.n, deterministic, noise)
    new_states = {
        DataKeys.HIDDEN_STATES: torch.stack(hs, dim=1).reshape(B, K, H),
        DataKeys.CELL_STATES: torch.stack(cs, dim=1).reshape(B, K, H),
    }
    return actions, logp, outs[-1], new_states


def fused_rnn_act(
    params: RnnParams,
    obs: torch.Tensor,
    states: Any,
    key: tuple[int, int],
    *,
    deterministic: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """One recurrent rollout step: new states, actions, their log-probs
    and values.

    CUDA tensors launch ``csrc/rnn_act.cu`` (and count one launch in
    ``fused_rnn_act.launches`` for the categorical kind, in
    ``fused_rnn_act.continuous_launches`` for the others) or raise; CPU
    tensors run :func:`rnn_act_plain`. Non-f32 observations are widened
    to f32 first. See :func:`rnn_act_plain` for the arguments and results.
    """
    if obs.dtype != torch.float32:
        obs = obs.to(torch.float32)
    if obs.dim() != 2 or obs.shape[1] != params.d_in:
        raise ValueError(f"obs must be [B, {params.d_in}], got {tuple(obs.shape)}.")
    B, K, H = obs.shape[0], params.num_layers, params.hidden
    for name in (DataKeys.HIDDEN_STATES, DataKeys.CELL_STATES):
        got = states[name]
        if tuple(got.shape) != (B, K, H) or got.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [{B}, {K}, {H}], got {got.dtype} {tuple(got.shape)}.")
        if got.device != obs.device:
            raise ValueError(f"{name} is on {got.device} but obs is on {obs.device}.")
    if obs.device != params.flat.device:
        raise ValueError(f"obs is on {obs.device} but the params are on {params.flat.device}.")
    if params.kind not in RNN_KINDS:
        raise ValueError(f"Unknown distribution kind {params.kind!r}; expected one of {RNN_KINDS}.")
    seed, offset = key
    if not (0 <= seed < 2**32 and 0 <= offset < 2**32):
        raise ValueError("The Philox key words must be 32-bit unsigned ints.")
    if obs.device.type == "cpu":
        return rnn_act_plain(params, obs, states, key, deterministic=deterministic)
    if obs.device.type != "cuda":
        raise ValueError(f"No recurrent act kernel for device {obs.device}.")
    h, c = states[DataKeys.HIDDEN_STATES], states[DataKeys.CELL_STATES]
    if not all(t.is_contiguous() for t in (obs, h, c, params.flat)):
        raise ValueError("The recurrent act kernel needs contiguous obs, states and params.")
    dev = obs.device
    action_dtype = torch.float32 if params.continuous else torch.int32
    actions = torch.empty((B, params.action_dim), dtype=action_dtype, device=dev)
    logp = torch.empty((B, 1), dtype=torch.float32, device=dev)
    values = torch.empty((B, 1), dtype=torch.float32, device=dev)
    h_n = torch.empty_like(h)
    c_n = torch.empty_like(c)
    code = load().rl8_rnn_act(
        obs.data_ptr(), h.data_ptr(), c.data_ptr(), params.flat.data_ptr(), actions.data_ptr(),
        logp.data_ptr(), values.data_ptr(), h_n.data_ptr(), c_n.data_ptr(), B, params.d_in, H, K,
        RNN_KINDS.index(params.kind), params.action_dim, params.n, seed, offset, int(deterministic),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    check(code, "The recurrent act kernel")
    if params.continuous:
        fused_rnn_act.continuous_launches += 1
    else:
        fused_rnn_act.launches += 1
    return actions, logp, values, {DataKeys.HIDDEN_STATES: h_n, DataKeys.CELL_STATES: c_n}


#: Kernel launches so far, per distribution family (CUDA tensors only;
#: the CPU path counts none).
fused_rnn_act.launches = 0
fused_rnn_act.continuous_launches = 0

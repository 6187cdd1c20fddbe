"""Distribution math shared by the kernels and their plain versions.

PyTorch counterpart of ``rl8_tpu/ops/distmath.py``. These are the plain
versions of what ``csrc/act.cu`` and ``csrc/ppo.cu`` compute in-kernel,
written with the same formulas so the two agree to f32 rounding (the PPO
ratio divides the update's log-prob by the one stored at act time):

- :func:`log_softmax_rows` is ``z - (max + log(sum(exp(z - max))))``,
  the one categorical log-prob formula; ``Categorical.logp`` uses it too.
- :func:`normal_per_dim_logp` and :func:`squashed_normal_logp` are the
  one diagonal-normal and tanh-squashed formulas; ``Normal.logp`` and
  ``SquashedNormal.logp`` use them too.
- :func:`philox_uniform` and :func:`philox_normal` are the counter-based
  Philox4x32-10 generator the act kernel runs, keyed by a per-step
  ``(seed, offset)``. A categorical draw is word 0 at counter ``(row,
  group, category, 0)``; a normal draw is Box-Muller on words 0 and 1 at
  counter ``(row, dim, 0, 1)``. Neither depends on how the kernel cuts
  rows into blocks, so the plain version replays a launch draw for draw.
"""

from __future__ import annotations

import torch

__all__ = [
    "LOG_2PI",
    "SQUASH_EPS",
    "TWO_PI",
    "log_softmax_rows",
    "normal_per_dim_logp",
    "philox4x32",
    "philox_normal",
    "philox_uniform",
    "sample_categorical_group",
    "sample_continuous_actions",
    "sample_discrete_actions",
    "squashed_normal_logp",
]

LOG_2PI = 1.8378770664093453
#: float32 machine epsilon: the atanh clamp margin of ``SquashedNormal``.
SQUASH_EPS = 1.1920929e-07
TWO_PI = 6.283185307179586

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(m: int, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` 32-bit words of ``m * a`` for a 32-bit constant ``m``
    and int64 tensor ``a`` in ``[0, 2^32)``, in 16-bit halves so that no
    partial product overflows int64."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    a_hi, a_lo = a >> 16, a & 0xFFFF
    ll = m_lo * a_lo
    mid = m_hi * a_lo + m_lo * a_hi
    lo = ll + ((mid & 0xFFFF) << 16)
    carry = lo >> 32
    hi = (m_hi * a_hi + (mid >> 16) + carry) & _MASK
    return hi, lo & _MASK


def philox4x32(
    ctr: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    key: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding
    32-bit words; ``key`` is two 32-bit ints."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def philox_uniform(
    seed: int, offset: int, rows: int, groups: int, n: int, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """The act kernel's uniforms ``[rows, groups * n]`` in ``(0, 1)``:
    word 0 of Philox at counter ``(row, group, category, 0)`` and key
    ``(seed, offset)``, its top 23 bits scaled by ``2^-23`` and clamped
    to ``>= 1e-7`` (the TPU kernel's mantissa construction)."""
    r = torch.arange(rows, dtype=torch.int64, device=device).view(-1, 1, 1)
    g = torch.arange(groups, dtype=torch.int64, device=device).view(1, -1, 1)
    c = torch.arange(n, dtype=torch.int64, device=device).view(1, 1, -1)
    shape = (rows, groups, n)
    ctr = (r.expand(shape), g.expand(shape), c.expand(shape), torch.zeros(shape, dtype=torch.int64, device=device))
    bits = philox4x32(ctr, (seed, offset))[0]
    return _to_uniform(bits).reshape(rows, groups * n)


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """A 32-bit word's top 23 bits scaled by ``2^-23``, clamped to
    ``>= 1e-7`` so that logs of it are finite."""
    return ((bits >> 9).to(torch.float32) * (2.0**-23)).clamp_min(1e-7)


def philox_normal(
    seed: int, offset: int, rows: int, dim: int, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """The continuous act kernel's standard-normal noise ``[rows, dim]``:
    Box-Muller ``sqrt(-2 log u1) cos(2 pi u2)`` on the uniforms of words
    0 and 1 of Philox at counter ``(row, dim, 0, 1)`` and key ``(seed,
    offset)`` (the last counter word keeps these draws apart from
    :func:`philox_uniform`'s)."""
    r = torch.arange(rows, dtype=torch.int64, device=device).view(-1, 1)
    d = torch.arange(dim, dtype=torch.int64, device=device).view(1, -1)
    shape = (rows, dim)
    zero = torch.zeros(shape, dtype=torch.int64, device=device)
    w0, w1, _, _ = philox4x32((r.expand(shape), d.expand(shape), zero, zero + 1), (seed, offset))
    u1, u2 = _to_uniform(w0), _to_uniform(w1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)


def log_softmax_rows(z: torch.Tensor) -> torch.Tensor:
    """Numerically-stable log-softmax over the last axis: the shared
    formula that the act kernel computes."""
    m = z.amax(dim=-1, keepdim=True)
    return z - (m + torch.log(torch.exp(z - m).sum(dim=-1, keepdim=True)))


def sample_categorical_group(
    z_logp: torch.Tensor, deterministic: bool, u: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample one categorical group from row-wise log-probs ``[N, n]`` by
    Gumbel-argmax on uniforms ``u [N, n]``; returns ``(action [N, 1]
    int32, chosen logp [N, 1])``. Ties go to the first index."""
    if deterministic:
        scores = z_logp
    else:
        if u is None:
            raise ValueError("Stochastic sampling needs uniforms `u`.")
        scores = z_logp - torch.log(-torch.log(u))
    act = torch.argmax(scores, dim=1, keepdim=True)
    chosen = torch.gather(z_logp, 1, act)
    return act.to(torch.int32), chosen


def sample_discrete_actions(
    logits: torch.Tensor, n: int, deterministic: bool, u: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample every categorical group of ``logits [N, A * n]`` (``n``
    categories per group); returns ``(actions [N, A] int32, summed chosen
    logp [N, 1])``, with the groups' log-probs summed in group order."""
    actions = []
    total = None
    for a in range(logits.shape[1] // n):
        cols = slice(a * n, (a + 1) * n)
        act, chosen = sample_categorical_group(
            log_softmax_rows(logits[:, cols]), deterministic, None if u is None else u[:, cols]
        )
        actions.append(act)
        total = chosen if total is None else total + chosen
    return torch.cat(actions, dim=1), total


def normal_per_dim_logp(diff: torch.Tensor, log_std: torch.Tensor, inv_var: torch.Tensor) -> torch.Tensor:
    """Per-dimension diagonal-normal log-prob, where ``diff = x - mean``
    and ``inv_var = exp(-2 log_std)``."""
    return -0.5 * diff * diff * inv_var - log_std - 0.5 * LOG_2PI


def squashed_normal_logp(
    actions: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor, inv_var: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``SquashedNormal`` log-prob of tanh-squashed ``actions``: invert
    through an atanh of the actions clipped to ``1 - eps``, clamp each
    dim's base log-prob to ±100, subtract the tanh log-det term.

    Returns:
        ``(logp [N, 1], diff, grad_gate)``: ``diff = atanh(a) - mean``, and
        ``grad_gate`` is 1 where the ±100 clamp passes gradients (strictly
        inside it) and 0 where the clamp cuts them.

    """
    clipped = torch.clamp(actions, -1.0 + SQUASH_EPS, 1.0 - SQUASH_EPS)
    u = 0.5 * (torch.log1p(clipped) - torch.log1p(-clipped))
    diff = u - mean
    per_dim = normal_per_dim_logp(diff, log_std, inv_var)
    grad_gate = ((per_dim > -100.0) & (per_dim < 100.0)).to(torch.float32)
    logp = torch.clamp(per_dim, -100.0, 100.0).sum(dim=1, keepdim=True) - torch.log(
        1.0 - clipped * clipped + SQUASH_EPS
    ).sum(dim=1, keepdim=True)
    return logp, diff, grad_gate


def sample_continuous_actions(
    mean: torch.Tensor,
    pre_log_std: torch.Tensor,
    deterministic: bool,
    squashed: bool,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample diagonal-normal (optionally tanh-squashed) actions from the
    raw heads ``[N, A]`` with standard-normal ``noise [N, A]``; returns
    ``(actions [N, A], logp [N, 1])``. The log-std is ``tanh`` of its head
    (the default continuous model's bound); when squashed, the log-prob
    is that of the squashed action, as ``SquashedNormal.logp`` gives it."""
    log_std = torch.tanh(pre_log_std)
    std = torch.exp(log_std)
    inv_var = torch.exp(-2.0 * log_std)
    if deterministic:
        actions = mean
    else:
        if noise is None:
            raise ValueError("Stochastic sampling needs standard-normal `noise`.")
        actions = mean + std * noise
    if squashed:
        actions = torch.tanh(actions)
        logp, _, _ = squashed_normal_logp(actions, mean, log_std, inv_var)
    else:
        logp = normal_per_dim_logp(actions - mean, log_std, inv_var).sum(dim=1, keepdim=True)
    return actions, logp

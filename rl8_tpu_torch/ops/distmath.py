"""Distribution math shared by the act kernel and its plain version.

PyTorch counterpart of the discrete part of ``rl8_tpu/ops/distmath.py``.
These are the plain versions of what ``csrc/act.cu`` computes in-kernel,
written with the same formulas so the two agree to f32 rounding:

- :func:`log_softmax_rows` is ``z - (max + log(sum(exp(z - max))))``,
  the one log-prob formula. The update (a later slice) divides by the
  log-probs stored here, and ``Categorical.logp`` uses it too.
- :func:`philox_uniform` is the counter-based Philox4x32-10 generator
  the kernel runs, keyed by a per-step ``(seed, offset)`` and counted by
  ``(row, group, category)``, so the draws do not depend on how the
  kernel cuts rows into blocks and the plain version can replay them.
"""

from __future__ import annotations

import torch

__all__ = [
    "log_softmax_rows",
    "philox4x32",
    "philox_uniform",
    "sample_categorical_group",
    "sample_discrete_actions",
]

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
    u = (bits >> 9).to(torch.float32) * (2.0**-23)
    return u.clamp_min(1e-7).reshape(rows, groups * n)


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

"""Wide LSTMs, split off ``tests/test_torch_rnn_wide.py`` (whose helpers
it uses) to spread the run time over the test workers:
``rnn_ppo_grads_plain`` against ``jax.grad`` of ``rl8_tpu``'s recurrent
loss at two 1024-wide LSTM layers, Categorical with an entropy bonus,
Normal, and SquashedNormal without one (``check_update_against_jax``; its
tolerances)."""

from __future__ import annotations

import pytest

from tests.test_torch_rnn_wide import UPDATE_KINDS, check_update_against_jax
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("layers", [2])
@pytest.mark.parametrize("kind,ec", UPDATE_KINDS)
def test_plain_update_matches_jax_autodiff_at_1024(kind: str, ec: float, layers: int) -> None:
    """``rnn_ppo_grads_plain`` against ``jax.grad`` at two 1024-wide
    layers (``check_update_against_jax``)."""
    check_update_against_jax(kind, ec, layers)

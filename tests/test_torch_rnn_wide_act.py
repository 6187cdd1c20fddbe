"""Wide LSTMs, split off ``tests/test_torch_rnn_wide.py`` (whose helpers
it uses) to spread the run time over the test workers: ``rnn_act_plain``
(what ``csrc/rnn_act.cu``'s staged route is held against), deterministic,
against ``rl8_tpu``'s module forward at one LSTM layer of H = 1210 (the
first width past the earlier 16-row tile) and 1617 (the gate's widest)
(``check_act_plain_against_jax``; its tolerances)."""

from __future__ import annotations

import pytest

from tests.test_torch_rnn_wide import check_act_plain_against_jax
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("kind", ["categorical", "normal", "squashed"])
@pytest.mark.parametrize("H", [1210, 1617])
def test_act_plain_matches_jax_forward_wide(H: int, kind: str) -> None:
    """``rnn_act_plain`` against ``rl8_tpu``'s module forward at one wide
    layer (``check_act_plain_against_jax``)."""
    check_act_plain_against_jax(H, 1, kind)

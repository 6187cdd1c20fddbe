"""The port's debugging aids (``rl8_tpu_torch/utils/debugging.py``) on the
CPU, beside ``rl8_tpu.utils.debugging``: ``trace`` writes a trace of a
collect; ``debug_nans`` raises ``FloatingPointError`` at the first
NaN-producing operation (an ATen operator, or a kernel's outputs through
its wrapper's launch check), as ``rl8_tpu``'s raises for a jitted one,
and restores the previous setting on exit."""

from __future__ import annotations

import json

import pytest
import torch

from rl8_tpu_torch import AlgorithmConfig
from rl8_tpu_torch.env import DiscreteDummyEnv
from rl8_tpu_torch.ops._build import check
from rl8_tpu_torch.utils.debugging import debug_nans, trace


def _algo():
    return AlgorithmConfig(num_envs=8, horizon=4, model_config={"hiddens": (8,)}, device="cpu").build(DiscreteDummyEnv)


def test_trace_writes_a_trace_of_a_collect(tmp_path) -> None:
    algo = _algo()
    with trace(str(tmp_path / "trace")):
        algo.collect()
    (path,) = (tmp_path / "trace").iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(name.startswith("aten::") for name in names)


def test_debug_nans_raises_at_a_poisoned_parameter() -> None:
    """A NaN in the first layer's weights raises at the rollout's first
    operator that reads it; outside the block the same collect runs."""
    algo = _algo()
    with torch.no_grad():
        next(algo.policy.model.parameters())[0, 0] = float("nan")
    with debug_nans():
        with pytest.raises(FloatingPointError, match="NaN in the output of aten"):
            algo.collect()
    algo.collect()


def test_debug_nans_restores_the_previous_setting() -> None:
    nan = torch.tensor([0.0])
    with debug_nans():
        with debug_nans(False):
            nan / 0.0
        with pytest.raises(FloatingPointError):
            nan / 0.0
    nan / 0.0


def test_debug_nans_checks_kernel_outputs() -> None:
    """The kernels launch outside the dispatcher; their wrappers pass their
    outputs to the launch check, which raises only while checks are on."""
    outputs = (torch.zeros(2), torch.tensor([float("nan")]))
    check(0, "The GAE kernel", *outputs)
    with debug_nans():
        check(0, "The GAE kernel", torch.zeros(2), [torch.ones(3)])
        with pytest.raises(FloatingPointError, match="The GAE kernel"):
            check(0, "The GAE kernel", *outputs)


def test_debug_nans_raises_what_jax_raises() -> None:
    """Both packages raise ``FloatingPointError`` for the log of a negative
    number inside their ``debug_nans``, and neither outside it."""
    import jax
    import jax.numpy as jnp

    from rl8_tpu.utils.debugging import debug_nans as jdebug_nans

    with jdebug_nans():
        with pytest.raises(FloatingPointError):
            jax.jit(jnp.log)(jnp.asarray(-1.0)).block_until_ready()
    with debug_nans():
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0))
    assert bool(jnp.isnan(jax.jit(jnp.log)(jnp.asarray(-1.0))))
    assert bool(torch.isnan(torch.log(torch.tensor(-1.0))))

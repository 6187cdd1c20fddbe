"""An environment that mocks algotrading.

PyTorch counterpart of ``examples/algotrading/env.py``: an asset's price
follows ``y[k+1] = (1 + km) * (1 + kc * sin(f * t)) * y[k]`` with randomly
sampled ``km``/``kc``/``f``/``y[0]``; a policy must learn to hold, buy, or
sell based on the price's change relative to the previous day and to its
buy-in position. Composite observations (action mask, invested flag, two
log-change floats) and masked categorical actions.
"""

from __future__ import annotations

import math
from enum import IntEnum
from typing import Any

import torch

from rl8_tpu_torch.env import Env, EnvConfig, EnvState
from rl8_tpu_torch.specs import Composite, Discrete, Unbounded

__all__ = ["Action", "AlgoTrading"]


class Action(IntEnum):
    """Environment actions."""

    HOLD = 0
    BUY = 1
    SELL = 2


class AlgoTrading(Env):
    """Mock algotrading environment.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.examples.algotrading import AlgoTrading
        >>> env = AlgoTrading(2, device="cpu")
        >>> state, obs = env.reset(torch.Generator().manual_seed(0))
        >>> obs["action_mask"].tolist()  # SELL is masked until invested
        [[True, True, False], [True, True, False]]
        >>> state, obs, reward = env.step(state, torch.tensor([[1], [0]], dtype=torch.int32))
        >>> obs["invested"].tolist(), obs["action_mask"].tolist()
        ([[1], [0]], [[True, False, True], [True, True, False]])

    """

    max_horizon = 128

    def __init__(self, num_envs: int, /, horizon: None | int = None, *, device: Any = "cuda") -> None:
        super().__init__(num_envs, horizon, device=device)
        self.observation_spec = Composite(
            {
                "action_mask": Discrete(2, shape=(3,), dtype=torch.bool),
                "invested": Discrete(2, shape=(1,), dtype=torch.int32),
                "LOG_CHANGE(price)": Unbounded(1),
                "LOG_CHANGE(price, position)": Unbounded(1),
            }
        )
        self.action_spec = Discrete(3, shape=(1,))

    def reset(
        self,
        generator: torch.Generator,
        *,
        state: EnvState = None,
        config: EnvConfig = None,
    ) -> tuple[EnvState, dict[str, torch.Tensor]]:
        config = config or {}
        dev = self.device

        def _bound(name: str, default: float) -> torch.Tensor:
            if name in config:
                return torch.as_tensor(config[name], dtype=torch.float32, device=dev)
            if state is not None:
                return state["bounds"][name]
            return torch.tensor(default, dtype=torch.float32, device=dev)

        bounds = {
            "f_bounds": _bound("f_bounds", math.pi),
            "k_cyclic_bounds": _bound("k_cyclic_bounds", 0.05),
            "k_market_bounds": _bound("k_market_bounds", 0.05),
        }
        B = self.num_envs

        def uniform(low: float, high: float) -> torch.Tensor:
            return low + (high - low) * torch.rand((B, 1), generator=generator, device=dev)

        f = uniform(0.0, 1.0) * bounds["f_bounds"]
        k_cyclic = uniform(-1.0, 1.0) * bounds["k_cyclic_bounds"]
        k_market = uniform(-1.0, 1.0) * bounds["k_market_bounds"]
        t = torch.randint(0, 10, (B, 1), generator=generator, device=dev).to(torch.float32)
        price = uniform(100.0, 10_000.0)
        new_state = {
            "bounds": bounds,
            "action_mask": torch.tensor([True, True, False], device=dev).repeat(B, 1),
            "invested": torch.zeros((B, 1), dtype=torch.int32, device=dev),
            "position": torch.zeros((B, 1), device=dev),
            "f": f,
            "k_cyclic": k_cyclic,
            "k_market": k_market,
            "t": t,
            "price": price,
            "log_change_price": torch.zeros((B, 1), device=dev),
            "log_change_price_position": torch.zeros((B, 1), device=dev),
        }
        return new_state, self._obs(new_state)

    @staticmethod
    def _obs(state: EnvState) -> dict[str, torch.Tensor]:
        return {
            "action_mask": state["action_mask"],
            "invested": state["invested"],
            "LOG_CHANGE(price)": state["log_change_price"],
            "LOG_CHANGE(price, position)": state["log_change_price_position"],
        }

    def step(
        self, state: EnvState, action: torch.Tensor
    ) -> tuple[EnvState, dict[str, torch.Tensor], torch.Tensor]:
        old_price = state["price"]
        a = action.reshape(-1, 1)
        buy = a == Action.BUY
        sell = a == Action.SELL
        hold = a == Action.HOLD

        invested = torch.where(buy, 1, torch.where(sell, 0, state["invested"]))
        # The invested mask is taken AFTER the buy/sell updates, so anyone
        # not invested post-transition (this step's sellers included)
        # tracks the current price as their position; buyers lock in this
        # price.
        position = torch.where((invested == 0) | buy, old_price, state["position"])

        reward = torch.zeros_like(old_price)
        reward = torch.where(sell, torch.log(old_price) - torch.log(state["position"]), reward)
        # Holders keep their invested flag across the step.
        reward = torch.where((invested == 1) & hold, state["log_change_price"], reward)

        new_invested_mask = invested == 1
        action_mask = torch.cat(
            [
                torch.ones_like(new_invested_mask),  # HOLD is always valid
                ~new_invested_mask,  # BUY when not invested
                new_invested_mask,  # SELL when invested
            ],
            dim=1,
        )

        t = state["t"] + 1
        price = old_price * (1 + state["k_market"]) * (1 + state["k_cyclic"] * torch.sin(t * state["f"]))
        new_state = {
            "bounds": state["bounds"],
            "action_mask": action_mask,
            "invested": invested,
            "position": position,
            "f": state["f"],
            "k_cyclic": state["k_cyclic"],
            "k_market": state["k_market"],
            "t": t,
            "price": price,
            "log_change_price": torch.log(price) - torch.log(old_price),
            "log_change_price_position": torch.log(price) - torch.log(position),
        }
        return new_state, self._obs(new_state), reward

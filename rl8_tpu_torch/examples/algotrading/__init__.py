"""The algotrading example: a mock trading environment with composite
observations and masked categorical actions (counterpart of
``examples/algotrading``).

Examples:
    >>> from rl8_tpu_torch import AlgorithmConfig
    >>> from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule
    >>> algo = AlgorithmConfig(
    ...     model_cls=MischievousMule, model_config={"hiddens": (8, 8)}, fused_forward=True,
    ...     num_envs=4, horizon=8, device="cpu",
    ... ).build(AlgoTrading)
    >>> int(algo.collect()["env/steps"]), "losses/total" in algo.step()
    (32, True)

"""

from .env import Action, AlgoTrading
from .models import MischievousMule

__all__ = ["Action", "AlgoTrading", "MischievousMule"]

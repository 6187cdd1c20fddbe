"""The algotrading example: a mock trading environment with composite
observations and masked categorical actions, and three custom models:
``MischievousMule`` (an MLP), ``AttentiveAlpaca`` (self-attention) and
``LazyLemur`` (an LSTM) (counterpart of ``examples/algotrading``). Train
one with ``python -m rl8_tpu_torch.examples.algotrading --model
{lstm,mlp,transformer}``, or the ``config.yaml`` beside this file with
``python -m rl8_tpu_torch train -f``.

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
from .models import AttentiveAlpaca, LazyLemur, MischievousMule

__all__ = ["Action", "AlgoTrading", "AttentiveAlpaca", "LazyLemur", "MischievousMule"]

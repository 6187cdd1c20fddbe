"""Example environments and custom models (counterpart of the repo's
``examples/``), for ``rl8_tpu_torch``: the classic-control envs
(``cartpole``, ``pendulum``, ``mountain_car``), each with a run script
(``python -m rl8_tpu_torch.examples.cartpole``) and a ``config.yaml`` for
the ``train`` CLI, ``dummy.yaml`` (``DiscreteDummyEnv``), and
``algotrading`` with its three custom models, its run script and its
``config.yaml``."""

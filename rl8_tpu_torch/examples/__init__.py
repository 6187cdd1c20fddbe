"""Example environments and custom models (counterpart of the repo's
``examples/``), for ``rl8_tpu_torch``. Only ``algotrading`` with
``MischievousMule`` is ported so far (ROADMAP Queue 1 #5)."""

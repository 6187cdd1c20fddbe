"""Configuration for the high-level training interfaces (counterpart of
``rl8_tpu/trainers/config.py``): a YAML/JSON-loadable config with
dotted-path dynamic imports for the ``env_cls``/``model_cls``/
``distribution_cls``/``optimizer_cls`` fields.

PyYAML is imported only to read a ``.yaml``/``.yml`` file, so JSON
configs load where it is not installed.
"""

from __future__ import annotations

import importlib
import json
import pathlib
from dataclasses import dataclass, field
from typing import Any

from ..algorithms import AlgorithmConfig, RecurrentAlgorithmConfig
from ..env import EnvFactory
from ._feedforward import Trainer
from ._recurrent import RecurrentTrainer

__all__ = ["TrainConfig"]


def _import(name: str) -> Any:
    """Dynamically import a dotted-path definition.

    Imports the longest module prefix, then walks the remaining
    components as attributes (so ``pkg.sub.module.Class`` works without
    ``pkg`` eagerly importing its submodules).
    """
    components = name.split(".")
    mod: Any = None
    split = len(components)
    while split > 0:
        prefix = ".".join(components[:split])
        try:
            mod = importlib.import_module(prefix)
            break
        except ModuleNotFoundError as e:
            # Only "this prefix isn't a module" is a miss; a
            # ModuleNotFoundError raised from INSIDE a located module (a
            # missing third-party dependency) surfaces as-is. The
            # comparison is on component boundaries: importing
            # ``pkg.submodule`` whose body fails on a missing ``pkg.sub``
            # is a dependency error, not a prefix miss, even though
            # ``"pkg.submodule".startswith("pkg.sub")`` is true.
            if e.name is not None and not (prefix == e.name or prefix.startswith(e.name + ".")):
                raise
            split -= 1
    if mod is None:
        raise ImportError(f"Could not dynamically import {name}.")
    try:
        for comp in components[split:]:
            mod = getattr(mod, comp)
    except AttributeError as e:
        raise ImportError(f"Could not dynamically import {name}.") from e
    return mod


@dataclass
class TrainConfig:
    """A helper for instantiating a trainer from a config file.

    Examples:
        Loading a JSON config resolves dotted-path class names:

        >>> import json, pathlib, tempfile
        >>> from rl8_tpu_torch import TrainConfig
        >>> text = json.dumps({
        ...     "env_cls": "rl8_tpu_torch.env.DiscreteDummyEnv",
        ...     "algorithm_config": {"horizon": 8, "gamma": 1, "device": "cpu"},
        ... })
        >>> with tempfile.TemporaryDirectory() as tmp:
        ...     path = pathlib.Path(tmp, "config.json")
        ...     _ = path.write_text(text)
        ...     config = TrainConfig.from_file(path)
        >>> config.env_cls.__name__
        'DiscreteDummyEnv'
        >>> config.algorithm_config["gamma"]
        1

        ``config.build()`` then constructs the trainer, and
        ``config.build().run(...)`` trains.

    """

    #: Environment class to instantiate an algorithm with.
    env_cls: EnvFactory

    #: Algorithm hyperparameters/config to build an algorithm with
    #: (``device`` among them: the card unless it says ``"cpu"``).
    algorithm_config: dict[str, Any] = field(default_factory=dict)

    #: Whether to instantiate a recurrent variant of the algorithm.
    recurrent: bool = False

    def build(self) -> Trainer | RecurrentTrainer:
        """Instantiate a trainer from the train config."""
        if self.recurrent:
            return RecurrentTrainer(RecurrentAlgorithmConfig(**self.algorithm_config).build(self.env_cls))
        return Trainer(AlgorithmConfig(**self.algorithm_config).build(self.env_cls))

    @classmethod
    def from_file(cls, path: str | pathlib.Path) -> "TrainConfig":
        """Instantiate a :class:`TrainConfig` from a JSON or YAML file.

        ``env_cls`` (required) and the ``model_cls``/``distribution_cls``/
        ``optimizer_cls`` algorithm-config entries are fully-qualified
        dotted paths that get dynamically imported.
        """
        p = pathlib.Path(path)
        with open(p, "r") as f:
            match p.suffix:
                case ".json":
                    data = json.load(f)
                case ".yaml" | ".yml":
                    import yaml

                    data = yaml.safe_load(f)
                case _:
                    raise ValueError("Config must be a JSON or YAML file")

        if not isinstance(data, dict):
            raise RuntimeError(
                f"{cls.__name__} config {path} must contain a mapping"
                f" (got {type(data).__name__})."
            )
        if "env_cls" in data:
            data["env_cls"] = _import(data["env_cls"])
        else:
            raise RuntimeError(f"{cls.__name__} config {path} must contain `env_cls`")

        if "algorithm_config" in data:
            for k in ("model_cls", "distribution_cls", "optimizer_cls"):
                if k in data["algorithm_config"]:
                    data["algorithm_config"][k] = _import(data["algorithm_config"][k])

        return cls(**data)

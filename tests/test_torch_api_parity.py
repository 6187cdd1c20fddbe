"""The port's public surface held against ``rl8_tpu``'s and its examples'.

Every module of ``rl8_tpu`` (and of ``examples``, against
``rl8_tpu_torch.examples``) is one case. A case fails when:

(a) the port's counterpart module does not import;
(b) a name of the reference module's ``__all__``, or a public class or
    function defined there, is missing from the port's module, or a name
    of that ``__all__`` is missing from the port's ``__all__`` where it has
    one;
(c) a public method, property or class attribute defined on a reference
    class is missing from the port's class (dataclass and flax fields are
    left to (d); flax's ``parent``, ``name`` and ``scope`` are its own);
(d) a parameter of a reference function, method or ``__call__`` (a
    flax module's ``__call__`` against the port's ``forward``) is not a
    parameter of the port's counterpart. A flax module's or a dataclass's
    constructor parameters are its ``init`` fields but flax's ``parent``
    and ``name``; a port callable taking ``**kwargs`` passes.

A difference that stays is an entry of :data:`BY_DESIGN`, keyed ``(module,
name, parameter)``: ``name`` is the module-level name or ``Class.member``,
and ``parameter`` is ``None`` when the name itself is missing. Each reason
names its category in ROADMAP.md's Queue 3 "Known differences". A case
also fails on an entry of its module that is no longer a difference, so
the table cannot outgrow the surface. Only modules are imported: the
cases run in a few seconds.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import pkgutil
from types import ModuleType
from typing import Any

import flax.linen as fnn
import pytest
import torch

_REFERENCE_ROOTS = ("rl8_tpu", "examples")
#: flax's own constructor fields and bound scope, not a model's surface.
_FLAX_OWN = ("parent", "name", "scope")

_PARAMS = "parameters live in the port's nn.Modules (ROADMAP Queue 3, Known differences: parameters)"
_KEY = "a JAX PRNG key is a torch.Generator in the port (ROADMAP Queue 3, Known differences: random keys)"
_RNG = "the random streams are the algorithm's torch.Generators (ROADMAP Queue 3, Known differences: random keys)"
_GROUP = "a named mesh axis is a torch.distributed group (ROADMAP Queue 3, Known differences: process groups)"
_PALLAS = "a Pallas/TPU-only helper (ROADMAP Queue 3, Known differences: Pallas-only names)"
_GAE = "the port's GAE kernel takes any horizon: fused_gae/gae_plain, no VMEM gate (ROADMAP Queue 3, Known differences: Pallas-only names)"
_INTERPRET = "Pallas interpret mode; a CPU tensor runs the plain version (ROADMAP Queue 3, Known differences: Pallas-only names)"
_WRAPPER = "the kernel wrapper takes packed tensors, not a model (ROADMAP Queue 3, Known differences: kernel wrappers)"
_OPTAX = "an optax transform; the port has TorchOptimizer and the flatten_optimizer= field (ROADMAP Queue 3, Known differences: optimizers)"

#: Each difference that stays, ``(module, name, parameter) -> reason``.
BY_DESIGN: dict[tuple[str, str, str | None], str] = {
    ("rl8_tpu.data", "AlgorithmState", "params"): _PARAMS,
    ("rl8_tpu.data", "AlgorithmState", "rng"): _RNG,
    ("rl8_tpu.data", "RecurrentAlgorithmState", "params"): _PARAMS,
    ("rl8_tpu.data", "RecurrentAlgorithmState", "rng"): _RNG,
    ("rl8_tpu.distributions", "Distribution.sample", "key"): _KEY,
    ("rl8_tpu.distributions", "Categorical.sample", "key"): _KEY,
    ("rl8_tpu.distributions", "Normal.sample", "key"): _KEY,
    ("rl8_tpu.distributions", "SquashedNormal.sample", "key"): _KEY,
    ("rl8_tpu.env", "Env.reset", "key"): _KEY,
    ("rl8_tpu.env", "DummyEnv.reset", "key"): _KEY,
    ("rl8_tpu.nn.functional", "masked_categorical_sample", "key"): _KEY,
    ("rl8_tpu.ops", "gae_fits_vmem", None): _GAE,
    ("rl8_tpu.ops", "pallas_gae", None): _GAE,
    ("rl8_tpu.ops.gae", "gae_fits_vmem", None): _GAE,
    ("rl8_tpu.ops.gae", "pallas_gae", None): _GAE,
    ("rl8_tpu.ops.distmath", "kernel_uniform", None): _PALLAS,
    ("rl8_tpu.ops.distmath", "key_to_seed", None): _PALLAS,
    ("rl8_tpu.ops.distmath", "sample_normal_noise", None): _PALLAS,
    ("rl8_tpu.ops.distmath", "sample_discrete_actions", "actions_ref"): _PALLAS,
    ("rl8_tpu.ops.fused_act", "fused_act", "model"): _WRAPPER,
    ("rl8_tpu.ops.fused_act", "fused_act", "batch"): _WRAPPER,
    ("rl8_tpu.ops.fused_act", "fused_act", "squashed"): _WRAPPER,
    ("rl8_tpu.ops.fused_act", "fused_act", "interpret"): _INTERPRET,
    ("rl8_tpu.ops.fused_mlp", "fused_chains", "interpret"): _INTERPRET,
    ("rl8_tpu.ops.fused_mlp", "fused_default_apply", "params"): _PARAMS,
    ("rl8_tpu.ops.fused_mlp", "fused_default_apply", "interpret"): _INTERPRET,
    ("rl8_tpu.ops.fused_mlp", "fused_custom_apply", "params"): _PARAMS,
    ("rl8_tpu.ops.fused_mlp", "fused_custom_apply", "interpret"): _INTERPRET,
    ("rl8_tpu.ops.fused_mlp", "fused_recurrent_custom_apply", "params"): _PARAMS,
    ("rl8_tpu.ops.fused_mlp", "fused_recurrent_custom_apply", "interpret"): _INTERPRET,
    ("rl8_tpu.ops.fused_mlp", "model_fits_vmem", "params"): _PARAMS,
    ("rl8_tpu.ops.fused_ppo", "fused_ppo_grads", "model"): _WRAPPER,
    ("rl8_tpu.ops.fused_ppo", "fused_ppo_grads", "packed_mb"): _WRAPPER,
    ("rl8_tpu.ops.fused_ppo", "fused_ppo_grads", "interpret"): _INTERPRET,
    ("rl8_tpu.ops.fused_rnn_act", "fused_rnn_act", "model"): _WRAPPER,
    ("rl8_tpu.ops.fused_rnn_act", "fused_rnn_act", "squashed"): _WRAPPER,
    ("rl8_tpu.ops.fused_rnn_act", "fused_rnn_act", "interpret"): _INTERPRET,
    ("rl8_tpu.ops.fused_rnn_ppo", "fused_rnn_ppo_grads", "model"): _WRAPPER,
    ("rl8_tpu.ops.fused_rnn_ppo", "fused_rnn_ppo_grads", "packed_mb"): _WRAPPER,
    ("rl8_tpu.ops.fused_rnn_ppo", "fused_rnn_ppo_grads", "interpret"): _INTERPRET,
    ("rl8_tpu.ops.packing", "block_shuffle", "key"): _KEY,
    ("rl8_tpu.parallel", "gmean", "axis_name"): _GROUP,
    ("rl8_tpu.parallel", "gstd", "axis_name"): _GROUP,
    ("rl8_tpu.parallel", "gmin", "axis_name"): _GROUP,
    ("rl8_tpu.parallel", "gmax", "axis_name"): _GROUP,
    ("rl8_tpu.parallel", "pmean_tree", "axis_name"): _GROUP,
    ("rl8_tpu.policies._base", "GenericPolicyBase.init_params", "key"): _KEY,
    ("rl8_tpu.policies._feedforward", "Policy.init_params", "key"): _KEY,
    ("rl8_tpu.policies._feedforward", "Policy.sample", "params"): _PARAMS,
    ("rl8_tpu.policies._feedforward", "Policy.sample", "key"): _KEY,
    ("rl8_tpu.policies._feedforward", "Policy.save", "params"): _PARAMS,
    ("rl8_tpu.policies._recurrent", "RecurrentPolicy.init_params", "key"): _KEY,
    ("rl8_tpu.policies._recurrent", "RecurrentPolicy.sample", "params"): _PARAMS,
    ("rl8_tpu.policies._recurrent", "RecurrentPolicy.sample", "key"): _KEY,
    ("rl8_tpu.policies._recurrent", "RecurrentPolicy.save", "params"): _PARAMS,
    ("rl8_tpu.policies.serving", "PolicyModel", "params"): _PARAMS,
    ("rl8_tpu.policies.serving", "RecurrentPolicyModel", "params"): _PARAMS,
    ("rl8_tpu.specs", "TensorSpec.rand", "key"): _KEY,
    ("rl8_tpu.specs", "Unbounded.rand", "key"): _KEY,
    ("rl8_tpu.specs", "Bounded.rand", "key"): _KEY,
    ("rl8_tpu.specs", "Discrete.rand", "key"): _KEY,
    ("rl8_tpu.specs", "Composite.rand", "key"): _KEY,
    ("rl8_tpu.utils.optim", "flatten_optimizer", None): _OPTAX,
    ("examples.algotrading.env", "AlgoTrading.reset", "key"): _KEY,
    ("examples.cartpole.env", "CartPole.reset", "key"): _KEY,
    ("examples.mountain_car.env", "MountainCar.reset", "key"): _KEY,
    ("examples.pendulum.env", "Pendulum.reset", "key"): _KEY,
}


def _raise(name: str) -> None:
    raise ImportError(f"cannot walk {name}")


def reference_modules() -> list[str]:
    """Every module of the reference packages but their ``__main__``s
    (importing an example's starts a training run)."""
    names = []
    for root in _REFERENCE_ROOTS:
        package = importlib.import_module(root)
        names.append(root)
        names += [
            info.name
            for info in pkgutil.walk_packages(package.__path__, f"{root}.", onerror=_raise)
            if info.name.rsplit(".", 1)[-1] != "__main__"
        ]
    return sorted(names)


def port_module_name(reference: str) -> str:
    """``rl8_tpu.x`` -> ``rl8_tpu_torch.x``; ``examples.x`` ->
    ``rl8_tpu_torch.examples.x``."""
    root, _, rest = reference.partition(".")
    port_root = "rl8_tpu_torch" if root == "rl8_tpu" else "rl8_tpu_torch.examples"
    return f"{port_root}.{rest}" if rest else port_root


def _public_names(module: ModuleType) -> list[str]:
    """The module's ``__all__``, then every other public class or function
    defined in it."""
    defined = sorted(
        name
        for name, value in vars(module).items()
        if not name.startswith("_") and getattr(value, "__module__", None) == module.__name__
    )
    return list(dict.fromkeys([*getattr(module, "__all__", ()), *defined]))


def _parameters(obj: Any) -> dict[str, inspect.Parameter] | None:
    try:
        return dict(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return None


def _named(parameters: dict[str, inspect.Parameter]) -> list[str]:
    variadic = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
    return [name for name, p in parameters.items() if p.kind not in variadic and name != "self"]


def _missing_parameters(reference: list[str], port: Any) -> list[str]:
    """The names of ``reference`` that ``port``'s signature lacks (none
    when it takes ``**kwargs`` or has no signature to read)."""
    parameters = _parameters(port)
    if parameters is None or any(p.kind is p.VAR_KEYWORD for p in parameters.values()):
        return []
    return [name for name in reference if name not in parameters]


def _init_fields(cls: type) -> list[str] | None:
    if not dataclasses.is_dataclass(cls):
        return None
    return [f.name for f in dataclasses.fields(cls) if f.init and f.name not in _FLAX_OWN]


def _class_differences(name: str, ref: type, port: type) -> list[tuple[str, str | None]]:
    out: list[tuple[str, str | None]] = []
    fields = _init_fields(ref)
    ctor = fields if fields is not None else _named(_parameters(ref) or {})
    out += [(name, p) for p in _missing_parameters(ctor, port)]
    skip = set(fields or ()) | set(_FLAX_OWN)
    for attr, value in vars(ref).items():
        if attr in skip or (attr.startswith("_") and attr != "__call__"):
            continue
        port_attr = "forward" if attr == "__call__" and issubclass(ref, fnn.Module) else attr
        if not any(port_attr in vars(k) for k in port.__mro__):
            out.append((f"{name}.{attr}", None))
        elif callable(value) or isinstance(value, (classmethod, staticmethod)):
            ref_params = _parameters(getattr(ref, attr))
            if ref_params is not None:
                missing = _missing_parameters(_named(ref_params), getattr(port, port_attr))
                out += [(f"{name}.{attr}", p) for p in missing]
    return out


def differences(reference: str) -> set[tuple[str, str, str | None]]:
    """The reference module's public names and parameters that the port
    lacks, as ``(module, name, parameter)`` (checks (b)-(d))."""
    ref = importlib.import_module(reference)
    port = importlib.import_module(port_module_name(reference))
    port_all = getattr(port, "__all__", None)
    out: list[tuple[str, str | None]] = []
    ref_all = getattr(ref, "__all__", ())
    for name in _public_names(ref):
        if not hasattr(port, name) or (name in ref_all and port_all is not None and name not in port_all):
            out.append((name, None))
            continue
        ref_obj, port_obj = getattr(ref, name), getattr(port, name)
        if getattr(ref_obj, "__module__", None) != reference or getattr(ref_obj, "__name__", name) != name:
            continue  # a re-export or an alias: checked where and as it is defined
        if inspect.isclass(ref_obj) and inspect.isclass(port_obj):
            out += _class_differences(name, ref_obj, port_obj)
        elif callable(ref_obj):
            ref_params = _parameters(ref_obj)
            if ref_params is not None:
                out += [(name, p) for p in _missing_parameters(_named(ref_params), port_obj)]
    return {(reference, name, parameter) for name, parameter in out}


REFERENCE_MODULES = reference_modules()


@pytest.mark.parametrize("reference", REFERENCE_MODULES)
def test_port_surface_covers_reference(reference: str) -> None:
    try:
        importlib.import_module(port_module_name(reference))
    except ImportError as e:
        pytest.fail(f"{port_module_name(reference)} (the port of {reference}) does not import: {e}")
    found = differences(reference)
    allowed = {key for key in BY_DESIGN if key[0] == reference}
    gaps = sorted(found - allowed, key=repr)
    stale = sorted(allowed - found, key=repr)
    assert not gaps, f"the port lacks these public names or parameters of {reference}: {gaps}"
    assert not stale, f"BY_DESIGN entries that are no longer differences: {stale}"


def test_by_design_entries_are_walked_and_reasoned() -> None:
    """Every entry names a walked module (else no case would find it
    stale) and gives a one-line reason citing its category."""
    assert {key[0] for key in BY_DESIGN} <= set(REFERENCE_MODULES)
    for key, reason in BY_DESIGN.items():
        assert "Known differences" in reason and "\n" not in reason, key


def test_checks_see_each_kind_of_gap() -> None:
    """The walk reports a missing name, member and parameter: a port
    class stripped of one method and a function of one parameter."""

    class Ref(fnn.Module):
        width: int = 1

        def __call__(self, x: Any, *, deterministic: bool = True) -> Any:
            return x

        def extra(self, key: Any) -> None:
            pass

    class Port(torch.nn.Module):
        def __init__(self) -> None:
            super().__init__()

        def forward(self, x: Any) -> Any:
            return x

    assert set(_class_differences("Ref", Ref, Port)) == {
        ("Ref", "width"),
        ("Ref.__call__", "deterministic"),
        ("Ref.extra", None),
    }
    assert _missing_parameters(["x", "key"], lambda x: x) == ["key"]
    assert _missing_parameters(["x", "key"], lambda x, **kw: x) == []

"""``AttentiveAlpaca`` and ``LazyLemur`` (``rl8_tpu_torch/examples/algotrading/
models``) against ``examples/algotrading/models`` on the CPU, from the flax
models' parameters: the module forwards in f32 and bf16, the fused applies
(the chain kernels' plain versions) and their gradients with respect to
every parameter (the attention stack's, the LSTM's and the embedding
tables included), the flax-tree round trips, the algotrading run script's
argument parsing and model choice, and the new modules' doctests.

Tolerances: rtol = atol = 1e-5 on f32 forwards (other summation orders;
masked logits are compared as masked); gradients over all parameters as
one vector, ``||port - jax|| <= 1e-4 ||jax|| + 1e-6``; bf16 forwards by
the rule of ``tests/test_torch_amp.py`` (the port's error against the f32
forward at most 2x ``rl8_tpu``'s, flax's bf16 forward run op by op, and
the two within a few bf16 roundings).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.algotrading.env import AlgoTrading as JAlgoTrading
from examples.algotrading.models import AttentiveAlpaca as JAttentiveAlpaca
from examples.algotrading.models import LazyLemur as JLazyLemur
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.examples.algotrading import AlgoTrading, AttentiveAlpaca, LazyLemur
from rl8_tpu_torch.models import load_jax_params, to_jax_params
from rl8_tpu_torch.ops import fused_custom_apply, fused_recurrent_custom_apply
from rl8_tpu_torch.ops import supports_fused_apply, supports_fused_recurrent_apply
from rl8_tpu_torch.views import tree_map

RTOL = ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BF16_REL, FLOOR = 2e-2, 1e-6
HIDDENS = (16, 16)
B, SEQ_LEN, T, H = 12, 4, 3, 8


def _alpaca_batch(seed: int = 0) -> dict:
    """A ``kind="last"``-style batch: windows of SEQ_LEN + 1 price changes,
    padded history in some rows and one fully padded row."""
    rng = np.random.default_rng(seed)
    invested = rng.integers(0, 2, size=(B, 1)).astype(np.int32)
    pad = np.zeros((B, SEQ_LEN + 1), bool)
    pad[0, :3], pad[1, :4], pad[2] = True, True, True
    return {DataKeys.OBS: {
        "action_mask": np.concatenate([np.ones_like(invested, bool), invested == 0, invested == 1], axis=1),
        "invested": invested,
        "LOG_CHANGE(price, position)": rng.normal(scale=0.3, size=(B, 1)).astype(np.float32),
        "LOG_CHANGE(price)": {DataKeys.INPUTS: rng.normal(scale=0.3, size=(B, SEQ_LEN + 1, 1)).astype(np.float32),
                              DataKeys.PADDING_MASK: pad},
    }}


def _lemur_batch(seed: int = 0) -> tuple[dict, dict]:
    rng = np.random.default_rng(seed)
    invested = rng.integers(0, 2, size=(B, T, 1)).astype(np.int32)
    batch = {DataKeys.OBS: {
        "action_mask": np.concatenate([np.ones_like(invested, bool), invested == 0, invested == 1], axis=2),
        "invested": invested,
        "LOG_CHANGE(price, position)": rng.normal(scale=0.3, size=(B, T, 1)).astype(np.float32),
        "LOG_CHANGE(price)": rng.normal(scale=0.3, size=(B, T, 1)).astype(np.float32),
    }}
    states = {DataKeys.HIDDEN_STATES: rng.normal(size=(B, 1, H)).astype(np.float32),
              DataKeys.CELL_STATES: rng.normal(size=(B, 1, H)).astype(np.float32)}
    return batch, states


def _models(name: str, dtype=None, seed: int = 0):
    """The flax model (f32 and, with ``dtype``, bf16), its parameters, and
    the port's model with them; the logits head scaled up so that its
    outputs are not all near 0."""
    env, jenv = AlgoTrading(1, device="cpu"), JAlgoTrading(1)
    if name == "alpaca":
        kw = dict(hiddens=HIDDENS, seq_len=SEQ_LEN)
        jcls, tcls = JAttentiveAlpaca, AttentiveAlpaca
        jbatch, jstates = jax.tree_util.tree_map(jnp.asarray, _alpaca_batch(seed)), None
    else:
        kw = dict(hiddens=HIDDENS, hidden_size=H)
        jcls, tcls = JLazyLemur, LazyLemur
        batch, states = _lemur_batch(seed)
        jbatch, jstates = jax.tree_util.tree_map(jnp.asarray, batch), states
    j32 = jcls(jenv.observation_spec, jenv.action_spec, **kw)
    jinputs = (jbatch,) if jstates is None else (jbatch, jstates)
    params = jax.device_get(jax.jit(j32.init)(jax.random.key(seed), *jinputs)["params"])
    params["feature_head"]["kernel"] = params["feature_head"]["kernel"] * 300.0
    tdtype = {None: None, "bfloat16": torch.bfloat16}[dtype]
    j16 = jcls(jenv.observation_spec, jenv.action_spec, dtype=jnp.bfloat16, **kw) if dtype else None
    tmodel = tcls(env.observation_spec, env.action_spec, dtype=tdtype, **kw)
    load_jax_params(tmodel, params)
    return j32, j16, params, tmodel, jinputs


def _t(inputs: tuple) -> tuple:
    return tuple(tree_map(torch.from_numpy, jax.device_get(x)) for x in inputs)


def _outputs(name: str, out) -> tuple:
    """``(logits, values)`` of a forward, masked logits set to 0."""
    (features, values), _ = (out, None) if name == "alpaca" else out
    logits = features["logits"]
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().numpy()
        values = values.detach().numpy()
    logits, values = np.asarray(logits, np.float64), np.asarray(values, np.float64)
    return np.where(logits < -1e37, 0.0, logits), values


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
@pytest.mark.parametrize("name", ["alpaca", "lemur"])
def test_forward_matches_flax(name: str, fused: bool) -> None:
    """The module forward and the fused apply against flax's forward:
    logits (the masked ones exactly at FMIN's side), values and, for
    LazyLemur, the new states."""
    j32, _, params, tmodel, jinputs = _models(name)
    want = jax.jit(j32.apply)({"params": params}, *jinputs)
    apply = (fused_custom_apply if name == "alpaca" else fused_recurrent_custom_apply) if fused else None
    with torch.no_grad():
        got = apply(tmodel, *_t(jinputs)) if fused else tmodel(*_t(jinputs))
    for g, w in zip(_outputs(name, got), _outputs(name, want)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL)
    logits = (got if name == "alpaca" else got[0])[0]["logits"]
    jlogits = np.asarray((want if name == "alpaca" else want[0])[0]["logits"])
    np.testing.assert_array_equal(logits.numpy() < -1e37, jlogits < -1e37)
    if name == "lemur":
        for key in (DataKeys.HIDDEN_STATES, DataKeys.CELL_STATES):
            assert got[1][key].dtype == torch.float32
            np.testing.assert_allclose(got[1][key].numpy(), np.asarray(want[1][key]), rtol=RTOL, atol=ATOL)


def _grad_vector(model: torch.nn.Module) -> np.ndarray:
    """``model``'s parameter gradients in the flax tree's leaf order."""
    saved = [p.data for p in model.parameters()]
    for p in model.parameters():
        p.data = p.grad.clone()
    tree = to_jax_params(model)
    for p, data in zip(model.parameters(), saved):
        p.data = data
    return np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
@pytest.mark.parametrize("name", ["alpaca", "lemur"])
def test_gradients_match_flax(name: str, fused: bool) -> None:
    """The gradients of a loss of the logits and values with respect to
    every parameter (the embedding tables, the attention stack's shared
    layer or the LSTM reached through the chains' ``dx`` on the fused
    route) against ``jax.grad``."""
    j32, _, params, tmodel, jinputs = _models(name, seed=1)

    def split(out):
        features, values = out if name == "alpaca" else out[0]
        return features["logits"], values

    def j_loss(p):
        logits, values = split(j32.apply({"params": p}, *jinputs))
        return jnp.mean(jnp.sin(jnp.where(logits > -1e37, logits, 0.0))) + jnp.mean(values * values)

    apply = fused_custom_apply if name == "alpaca" else fused_recurrent_custom_apply
    out = apply(tmodel, *_t(jinputs)) if fused else tmodel(*_t(jinputs))
    logits, values = split(out)
    (torch.sin(torch.where(logits > -1e37, logits, 0.0)).mean() + (values * values).mean()).backward()
    got = _grad_vector(tmodel)
    jgrads = jax.device_get(jax.jit(jax.grad(j_loss))(params))
    assert np.abs(jgrads["invested_embedding"]["embedding"]).max() > 0
    want = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(jgrads)])
    assert np.linalg.norm(got - want) <= GRAD_RTOL * np.linalg.norm(want) + GRAD_ATOL


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
@pytest.mark.parametrize("name", ["alpaca", "lemur"])
def test_bf16_forward_matches_flax_rule(name: str, fused: bool) -> None:
    """``dtype=bfloat16``: the module forward (and the fused apply, whose
    chains run in f32 on the upcast assembled input) against flax's bf16
    forward op by op, both held against the f32 forward; outputs f32."""
    j32, j16, params, tmodel, jinputs = _models(name, dtype="bfloat16", seed=2)
    ref = _outputs(name, jax.jit(j32.apply)({"params": params}, *jinputs))
    with jax.disable_jit():
        want = _outputs(name, j16.apply({"params": params}, *jinputs))
    apply = fused_custom_apply if name == "alpaca" else fused_recurrent_custom_apply
    assert (supports_fused_apply if name == "alpaca" else supports_fused_recurrent_apply)(tmodel)
    with torch.no_grad():
        out = apply(tmodel, *_t(jinputs)) if fused else tmodel(*_t(jinputs))
    got = _outputs(name, out)
    for g, w, r in zip(got, want, ref):
        scale = max(np.abs(r).max(), 1e-3)
        assert np.abs(g - r).max() <= 2.0 * np.abs(w - r).max() + FLOOR * scale, (np.abs(g - r).max(), np.abs(w - r).max())
        assert np.abs(g - w).max() <= BF16_REL * scale
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())


@pytest.mark.parametrize("name", ["alpaca", "lemur"])
def test_convert_round_trip(name: str) -> None:
    """``to_jax_params`` inverts ``load_jax_params`` exactly on the flax
    tree (``layers_shared`` once under ``share_parameters``; the
    ``DenseGeneral`` kernels ``[E, H, dh]`` and ``[H, dh, E]`` reshaped), and
    ``parameters()`` holds each tensor once."""
    _, _, params, tmodel, _ = _models(name, seed=3)
    tree = to_jax_params(tmodel)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)
    for got, want in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(got, np.asarray(want))
    # flax holds each LSTM gate's kernels and bias apart (12 leaves a
    # layer); the port holds them as wi, wh and b.
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(list(tmodel.parameters())) == n_leaves - (0 if name == "alpaca" else 9)
    if name == "alpaca":
        assert list(tree["price_attention"]) == ["layers_shared"]
        attention = tree["price_attention"]["layers_shared"]["block"]["attention"]
        assert attention["query"]["kernel"].shape == (8, 4, 2) and attention["out"]["kernel"].shape == (4, 2, 8)


def test_algotrading_run_script_parses_and_picks_models(monkeypatch, tmp_path) -> None:
    """``python -m rl8_tpu_torch.examples.algotrading``: ``rl8_tpu``'s flags
    and choices, the model class and recurrence each ``--model`` picks, and
    the ``Plateaus`` stop, driven here with a stub trainer."""
    import importlib
    import tempfile

    script = importlib.import_module("rl8_tpu_torch.examples.algotrading.__main__")
    assert script.parser.parse_args([]).model == "mlp"
    assert not script.parser.parse_args([]).fused_forward
    with pytest.raises(SystemExit):
        script.parser.parse_args(["--model", "gru"])
    actions = {a.dest: a for a in script.parser._actions}
    assert actions["model"].choices == ["lstm", "mlp", "transformer"]
    runs = []

    class StubTrainer:
        def run(self, **kwargs):
            runs.append(kwargs)

    def build(self):
        runs.append(self)
        return StubTrainer()

    monkeypatch.setattr(script.TrainConfig, "build", build)
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix: str(tmp_path / prefix))
    for flag, cls, recurrent in (("lstm", LazyLemur, True), ("transformer", AttentiveAlpaca, False)):
        runs.clear()
        script.main(["--model", flag, "--fused-forward"])
        config, run = runs
        assert config.algorithm_config == {"model_cls": cls, "fused_forward": True}
        assert config.recurrent is recurrent and config.env_cls is AlgoTrading
        (stop,) = run["stop_conditions"]
        assert run["steps_per_eval"] == 10 and type(stop).__name__ == "Plateaus"
        assert (stop.key, stop.patience, stop.rtol) == ("returns/mean", 10, 0.05)


def test_algotrading_config_matches_jax() -> None:
    """The port's ``config.yaml`` is ``examples/algotrading/config.yaml``
    with the port's class paths, and builds on the CPU."""
    import yaml

    from pathlib import Path

    from rl8_tpu_torch.trainers import TrainConfig

    repo = Path(__file__).resolve().parent.parent
    ours = yaml.safe_load((repo / "rl8_tpu_torch/examples/algotrading/config.yaml").read_text())
    theirs = yaml.safe_load((repo / "examples/algotrading/config.yaml").read_text())
    assert ours["env_cls"] == "rl8_tpu_torch." + theirs["env_cls"]
    assert ours["algorithm_config"] == {
        **theirs["algorithm_config"], "model_cls": "rl8_tpu_torch." + theirs["algorithm_config"]["model_cls"]
    }
    config = TrainConfig.from_file(repo / "rl8_tpu_torch/examples/algotrading/config.yaml")
    assert config.algorithm_config["model_cls"] is AttentiveAlpaca


def test_chip_smoke_holds_the_algotrading_config() -> None:
    """chip_smoke.py runs the algotrading config as JSON (the card's
    machine may lack PyYAML): its copy must be the committed YAML file."""
    import importlib.util
    from pathlib import Path

    import yaml

    repo = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke_algotrading", repo / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = yaml.safe_load((repo / "rl8_tpu_torch/examples/algotrading/config.yaml").read_text())
    assert smoke.ALGOTRADING_CONFIG == want


@pytest.mark.parametrize(
    "module_name",
    [
        "rl8_tpu_torch.nn.modules.attention",
        "rl8_tpu_torch.nn.modules.perceiver",
        "rl8_tpu_torch.nn.modules.skip",
        "rl8_tpu_torch.nn.modules.mlp",
    ],
)
def test_new_module_doctests(module_name: str) -> None:
    import doctest
    import importlib

    results = doctest.testmod(
        importlib.import_module(module_name), optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE
    )
    assert results.failed == 0
    assert results.attempted > 0

"""The port's serving wrappers (``rl8_tpu_torch/policies/serving.py``) and
policy export (``Policy.save``/``load``) on the CPU: the MLflow pyfunc
round trips of ``tests/test_serving_pyfunc.py`` through the same mlflow
shim, and ``PolicyModel``/``RecurrentPolicyModel.predict`` held against
``rl8_tpu``'s from the same parameters (``load_jax_params``) at batch
sizes that pad and bucket."""

from __future__ import annotations

import importlib
import inspect
import os
import sys

import jax
import numpy as np
import pytest
import torch

from rl8_tpu.policies import Policy as JPolicy
from rl8_tpu.policies import RecurrentPolicy as JRecurrentPolicy
from rl8_tpu.policies.serving import PolicyModel as JPolicyModel
from rl8_tpu.policies.serving import RecurrentPolicyModel as JRecurrentPolicyModel
from rl8_tpu.specs import Discrete as JDiscrete
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.models import DefaultDiscreteModel, load_jax_params
from rl8_tpu_torch.policies import Policy, RecurrentPolicy
from rl8_tpu_torch.policies import serving
from rl8_tpu_torch.policies.serving import PolicyModel, RecurrentPolicyModel, get_batch_size_from_model_input
from rl8_tpu_torch.specs import Discrete, Unbounded
from rl8_tpu_torch.views import ViewRequirement

SHIMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "reference_impl", "shims")

B, T, OBS_DIM = 4, 3, 5
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture()
def mlflow_pyfunc():
    """The mlflow.pyfunc stand-in, imported from the shims package and
    torn back out of ``sys.modules`` afterwards."""
    had = {k: sys.modules.get(k) for k in ("mlflow", "mlflow.pyfunc")}
    sys.path.insert(0, SHIMS)
    try:
        for k in ("mlflow", "mlflow.pyfunc"):
            sys.modules.pop(k, None)
        mlflow = importlib.import_module("mlflow")
        yield mlflow.pyfunc
    finally:
        sys.path.remove(SHIMS)
        for k, v in had.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _obs(b: int, t: int = T, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, t, OBS_DIM)).astype(np.float32)


def _stack(df, key) -> np.ndarray:
    return np.stack(df[key].to_list())


def _policies(recurrent: bool = False, seed: int = 0):
    """The same policy in both packages (the port loads rl8_tpu's params)."""
    if recurrent:
        jpolicy = JRecurrentPolicy(JUnbounded(OBS_DIM), JDiscrete(3, shape=(1,)), model_config={"hidden_size": 16})
        policy = RecurrentPolicy(Unbounded(OBS_DIM), Discrete(3, shape=(1,)), model_config={"hidden_size": 16})
    else:
        jpolicy = JPolicy(JUnbounded(OBS_DIM), JDiscrete(3, shape=(1,)))
        policy = Policy(Unbounded(OBS_DIM), Discrete(3, shape=(1,)))
    params = jpolicy.init_params(jax.random.key(seed))
    load_jax_params(policy.model, jax.device_get(params))
    return jpolicy, params, policy


def _assert_outputs_match(got, want) -> None:
    assert list(got.columns) == list(want.columns)
    np.testing.assert_array_equal(_stack(got, DataKeys.ACTIONS), _stack(want, DataKeys.ACTIONS))
    for key in (DataKeys.LOGP, DataKeys.VALUES):
        np.testing.assert_allclose(_stack(got, key), _stack(want, key), rtol=RTOL, atol=ATOL)


def test_pyfunc_round_trip_feedforward(tmp_path, mlflow_pyfunc) -> None:
    """save_model -> load_model -> predict matches a direct deterministic
    sample."""
    policy = Policy(Unbounded(OBS_DIM), Discrete(3, shape=(1,)))
    policy.init_params(torch.Generator().manual_seed(0))
    pkl = tmp_path / "policy.pkl"
    policy.save(pkl)
    model_dir = str(tmp_path / "pyfunc_model")
    mlflow_pyfunc.save_model(model_dir, python_model=PolicyModel(device="cpu"), artifacts={"policy": str(pkl)})
    loaded = mlflow_pyfunc.load_model(model_dir)

    obs = _obs(B)
    df = loaded.predict({DataKeys.OBS: obs})
    assert len(df) == B * T
    assert sorted(df.columns) == [DataKeys.ACTIONS, DataKeys.LOGP, DataKeys.VALUES]
    direct = policy.sample(
        {DataKeys.OBS: torch.from_numpy(obs)}, kind="all", deterministic=True, return_logp=True, return_values=True
    )
    np.testing.assert_array_equal(_stack(df, DataKeys.ACTIONS), direct[DataKeys.ACTIONS].numpy())
    np.testing.assert_allclose(_stack(df, DataKeys.LOGP), direct[DataKeys.LOGP].numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_stack(df, DataKeys.VALUES), direct[DataKeys.VALUES].numpy(), rtol=RTOL, atol=ATOL)


def test_pyfunc_round_trip_recurrent(tmp_path, mlflow_pyfunc) -> None:
    """Recurrent round trip: predict returns ``(outputs_df, states_df)``
    and takes an optional ``"states"`` input that continues the
    recurrence exactly."""
    policy = RecurrentPolicy(Unbounded(OBS_DIM), Discrete(3, shape=(1,)), model_config={"hidden_size": 16})
    policy.init_params(torch.Generator().manual_seed(0))
    pkl = tmp_path / "policy.pkl"
    policy.save(pkl)
    model_dir = str(tmp_path / "pyfunc_model")
    mlflow_pyfunc.save_model(
        model_dir, python_model=RecurrentPolicyModel(device="cpu"), artifacts={"policy": str(pkl)}
    )
    loaded = mlflow_pyfunc.load_model(model_dir)

    obs = _obs(B)
    outputs, states_df = loaded.predict({DataKeys.OBS: obs})
    assert len(outputs) == B * T and len(states_df) == B
    direct, direct_states = policy.sample(
        {DataKeys.OBS: torch.from_numpy(obs)}, policy.init_states(B), deterministic=True, return_values=True
    )
    np.testing.assert_array_equal(_stack(outputs, DataKeys.ACTIONS), direct[DataKeys.ACTIONS].numpy())
    np.testing.assert_allclose(_stack(outputs, DataKeys.VALUES), direct[DataKeys.VALUES].numpy(), rtol=RTOL, atol=ATOL)

    states_in = {k: np.stack(states_df[k].to_list()) for k in states_df.columns}
    outputs2, _ = loaded.predict({DataKeys.OBS: obs, DataKeys.STATES: states_in})
    direct2, _ = policy.sample({DataKeys.OBS: torch.from_numpy(obs)}, direct_states, deterministic=True)
    np.testing.assert_array_equal(_stack(outputs2, DataKeys.ACTIONS), direct2[DataKeys.ACTIONS].numpy())


def test_pyfunc_params_dispatch() -> None:
    """``predict`` takes mlflow 2.x's three positional arguments."""
    for cls in (PolicyModel, RecurrentPolicyModel):
        assert list(inspect.signature(cls.predict).parameters)[:4] == ["self", "context", "model_input", "params"]


@pytest.mark.parametrize("batch", [1, 7, 9, 100])
def test_predict_matches_jax_feedforward(batch) -> None:
    jpolicy, params, policy = _policies()
    obs = _obs(batch, seed=batch)
    want = JPolicyModel(jpolicy, params).predict({DataKeys.OBS: obs})
    model = PolicyModel(policy)
    _assert_outputs_match(model.predict({DataKeys.OBS: obs}), want)
    # MLflow's positional order gives the same frame.
    _assert_outputs_match(model.predict(None, {DataKeys.OBS: obs}, None), want)


@pytest.mark.parametrize("batch", [1, 7, 9, 100])
def test_predict_matches_jax_recurrent(batch) -> None:
    jpolicy, params, policy = _policies(recurrent=True)
    obs = _obs(batch, seed=batch)
    jmodel, model = JRecurrentPolicyModel(jpolicy, params), RecurrentPolicyModel(policy)
    want, want_states = jmodel.predict({DataKeys.OBS: obs})
    got, got_states = model.predict({DataKeys.OBS: obs})
    _assert_outputs_match(got, want)
    assert sorted(got_states.columns) == sorted(want_states.columns)
    for key in want_states.columns:
        np.testing.assert_allclose(_stack(got_states, key), _stack(want_states, key), rtol=RTOL, atol=ATOL)
    # Threading the states through a second predict stays together too.
    states = {k: _stack(want_states, k) for k in want_states.columns}
    want2, _ = jmodel.predict({DataKeys.OBS: obs, DataKeys.STATES: states})
    got2, _ = model.predict({DataKeys.OBS: obs, DataKeys.STATES: states})
    _assert_outputs_match(got2, want2)


@pytest.mark.parametrize("batch,bucket", [(1, 8), (7, 8), (8, 8), (9, 16), (100, 128)])
def test_batch_sizes_bucket_to_powers_of_two_with_edge_padding(batch, bucket, monkeypatch) -> None:
    _, _, policy = _policies()
    seen = []
    sample = policy.sample

    def recording_sample(batch_, **kwargs):
        seen.append(batch_[DataKeys.OBS])
        return sample(batch_, **kwargs)

    monkeypatch.setattr(policy, "sample", recording_sample)
    obs = _obs(batch)
    arrays = PolicyModel(policy)._predict_arrays({DataKeys.OBS: obs})
    (padded,) = seen
    assert padded.shape == (bucket, T, OBS_DIM)
    np.testing.assert_array_equal(padded[batch:].numpy(), np.broadcast_to(obs[-1], (bucket - batch, T, OBS_DIM)))
    assert arrays[DataKeys.ACTIONS].shape == (batch * T, 1)
    assert arrays[DataKeys.ACTIONS].dtype == np.int32 and arrays[DataKeys.LOGP].dtype == np.float32


class LastOfWindow(DefaultDiscreteModel):
    """A default model fed the last observation of a rolling window that
    drops the first ``shift`` samples of a sequence."""

    shift = 2

    @property
    def view_requirements(self):
        return {DataKeys.OBS: ViewRequirement(shift=self.shift, method="rolling_window")}

    def forward(self, batch):
        return super().forward({DataKeys.OBS: batch[DataKeys.OBS][:, -1]})


def test_drop_size_rows_are_sliced_off() -> None:
    policy = Policy(Unbounded(OBS_DIM), Discrete(3, shape=(1,)), model_cls=LastOfWindow)
    policy.init_params(torch.Generator().manual_seed(0))
    obs = _obs(5, t=6)
    arrays = PolicyModel(policy)._predict_arrays({DataKeys.OBS: obs})
    rows = 5 * (6 - LastOfWindow.shift)
    assert arrays[DataKeys.VALUES].shape == (rows, 1)
    plain = DefaultDiscreteModel(Unbounded(OBS_DIM), Discrete(3, shape=(1,)))
    plain.load_state_dict(policy.model.state_dict())
    _, values = plain({DataKeys.OBS: torch.from_numpy(obs[:, LastOfWindow.shift :].reshape(rows, OBS_DIM))})
    np.testing.assert_allclose(arrays[DataKeys.VALUES], values.detach().numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", [np.zeros((2, 1, OBS_DIM)), {"observations": np.zeros((2, 1, OBS_DIM))}, [1, 2]])
def test_predict_rejects_inputs_without_obs(bad) -> None:
    _, _, policy = _policies()
    for model in (PolicyModel(policy), RecurrentPolicyModel(_policies(recurrent=True)[2])):
        with pytest.raises(TypeError, match="'obs' key"):
            model.predict(bad)


def test_batch_size_sniffing() -> None:
    assert get_batch_size_from_model_input({"a": {"b": np.zeros((3, 2, 1))}}) == (3, 2)
    with pytest.raises(ValueError, match="ndim >= 3"):
        get_batch_size_from_model_input(np.zeros((3, 2)))
    with pytest.raises(TypeError, match="Empty mapping"):
        get_batch_size_from_model_input({})


def test_one_fetch_keeps_every_dtype() -> None:
    tensors = {
        "i": torch.arange(6, dtype=torch.int64).reshape(3, 2),
        "b": torch.tensor([True, False, True]),
        "f": torch.linspace(0, 1, 5, dtype=torch.float32),
        "h": torch.ones(3, dtype=torch.int32),
    }
    out = serving._fetch(tensors)
    for key, t in tensors.items():
        np.testing.assert_array_equal(out[key], t.numpy())
        assert out[key].dtype == t.numpy().dtype


@pytest.mark.parametrize("cls", [Policy, RecurrentPolicy])
def test_save_and_load_round_trip_on_the_cpu(tmp_path, cls) -> None:
    """``save`` pickles the policy with its parameters on the CPU and
    leaves the live policy alone; ``load`` puts them where it is asked
    (the card by default) and checks the class."""
    policy = cls(Unbounded(OBS_DIM), Discrete(3, shape=(1,)))
    policy.init_params(torch.Generator().manual_seed(1))
    policy.save(tmp_path / "policy.pkl")
    loaded = cls.load(tmp_path / "policy.pkl", device="cpu")
    assert type(loaded.model) is type(policy.model)
    for (name, a), (_, b) in zip(policy.model.state_dict().items(), loaded.model.state_dict().items()):
        assert torch.equal(a, b), name
    other = RecurrentPolicy if cls is Policy else Policy
    with pytest.raises(TypeError, match="holds a"):
        other.load(tmp_path / "policy.pkl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            cls.load(tmp_path / "policy.pkl")


def test_policy_model_load_serves_the_exported_policy(tmp_path) -> None:
    jpolicy, params, policy = _policies(seed=4)
    policy.save(tmp_path / "policy.pkl")
    obs = _obs(9)
    _assert_outputs_match(
        PolicyModel.load(tmp_path / "policy.pkl", device="cpu").predict({DataKeys.OBS: obs}),
        JPolicyModel(jpolicy, params).predict({DataKeys.OBS: obs}),
    )

"""Learning-curve parity of the port (``rl8_tpu_torch/parity.py``) on its
committed curves (``rl8_tpu_torch/curves/``), without training at test
time: the port's copy of the two criteria agrees with
``benchmarks.parity.check_parity`` on ``rl8_tpu``'s committed curves, the
port's curves meet both criteria against the reference's, the curve files
are well formed, and the port's initial parameter distributions match
``rl8_tpu``'s. Re-record the curves with
``python -m rl8_tpu_torch.parity --device cpu``."""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

import benchmarks.parity as jparity
from rl8_tpu_torch import parity
from rl8_tpu_torch.models import to_jax_params

NAMES = sorted(parity.CONFIGS)

#: Configs with a committed curve that misses a criterion, where the
#: same-initialisation comparison recorded in PERF.md §6 settled the miss as
#: seed spread (ROADMAP Queue 3), with the measured figures. Strict: the
#: case fails once the committed curves pass.
SEED_SPREAD: dict[str, str] = {
    "algotrading": (
        "seed 0's final 0.488 is under the band's 0.491; same-init seeds 0-8: the port's mean final"
        " 0.5549 vs rl8_tpu's 0.5603, SE 0.0118, Levene p 0.681: seed spread (ROADMAP Queue 3)"
    ),
    "mountain_car": (
        "seed 1's final -11.891 is under the band's -11.787; same-init seeds 0-8: the port's mean final"
        " -6.766 vs rl8_tpu's -8.592, SE 1.886, Levene p 0.880: seed spread (ROADMAP Queue 3)"
    ),
    "recurrent": (
        "seed 0 takes 81,920 env-steps to half-max, over the 74,995 allowed; same-init seeds 0-8: the"
        " port's mean 57,344 vs rl8_tpu's 63,716, SE 3,808, Levene p 0.406: seed spread (ROADMAP Queue 3)"
    ),
}


def test_configs_match_jax() -> None:
    assert parity.CONFIGS == jparity.CONFIGS
    assert parity.PARITY_NUM_ENVS == jparity.PARITY_NUM_ENVS
    assert os.path.samefile(parity.REFERENCE_CURVES_DIR, jparity.REFERENCE_CURVES_DIR)


@pytest.mark.parametrize("name", NAMES)
def test_criteria_match_jax(name, tmp_path, monkeypatch) -> None:
    """Both copies of the criteria give the same summary on ``rl8_tpu``'s
    committed curves, and refuse the same curves pushed below the band."""
    assert parity.check_parity(name, curves_dir=jparity.CURVES_DIR) == jparity.check_parity(name)
    for fn in os.listdir(jparity.CURVES_DIR):
        if fn.startswith(f"{name}_seed"):
            meta, records = parity.load_curve(os.path.join(jparity.CURVES_DIR, fn))
            for r in records:
                r["returns_mean"] -= 10.0 * (abs(r["returns_mean"]) + 1.0)
            parity.write_curve(str(tmp_path / fn), meta, records)
    monkeypatch.setattr(jparity, "CURVES_DIR", str(tmp_path))
    errors = []
    for check in (lambda: parity.check_parity(name, curves_dir=str(tmp_path)), lambda: jparity.check_parity(name)):
        with pytest.raises(AssertionError) as info:
            check()
        errors.append(str(info.value).split(":")[0])
    assert errors[0] == errors[1]


def _committed_case(name: str):
    if name in SEED_SPREAD:
        return pytest.param(name, marks=pytest.mark.xfail(strict=True, reason=SEED_SPREAD[name]))
    return name


@pytest.mark.parametrize("name", [_committed_case(n) for n in NAMES])
def test_committed_curves_reach_reference_band(name) -> None:
    summary = parity.check_parity(name)
    assert len(summary["ours_final_returns"]) == 3, summary


@pytest.mark.parametrize("name", NAMES)
def test_curve_files_are_well_formed(name) -> None:
    files = sorted(fn for fn in os.listdir(parity.CURVES_DIR) if fn.startswith(f"{name}_seed"))
    assert files == [f"{name}_seed{s}.jsonl" for s in (0, 1, 2)]
    for seed, fn in enumerate(files):
        meta, records = parity.load_curve(os.path.join(parity.CURVES_DIR, fn))
        assert meta["source"] == "rl8_tpu_torch" and meta["device"] == "cpu" and meta["threads"] >= 1
        assert meta["config"] == name and meta["seed"] == seed and meta["num_envs"] == 256
        assert len(records) == parity.CONFIGS[name]["steps"]
        steps = [r["env_steps"] for r in records]
        assert steps == sorted(steps) and len(set(steps)) == len(steps)
        assert steps[0] * len(steps) == steps[-1] == 256 * meta["horizon"] * len(steps)
        assert all(np.isfinite(r["returns_mean"]) for r in records)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _policies(name: str):
    """Both packages' policies of a parity config; the recurrent model at
    a 64-wide LSTM to keep the test short (``tools/parity_same_init.py
    init`` draws the default 256-wide one)."""
    if name == "algotrading":
        from examples.algotrading.env import AlgoTrading as JAlgoTrading
        from examples.algotrading.models import MischievousMule as JMule
        from rl8_tpu.policies import Policy as JPolicy
        from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule
        from rl8_tpu_torch.policies import Policy

        env, jenv = AlgoTrading(4, 8, device="cpu"), JAlgoTrading(4, 8)
        return (
            Policy(env.observation_spec, env.action_spec, model_cls=MischievousMule),
            JPolicy(jenv.observation_spec, jenv.action_spec, model_cls=JMule),
        )
    from rl8_tpu.env import DiscreteDummyEnv as JDiscreteDummyEnv
    from rl8_tpu.policies import RecurrentPolicy as JRecurrentPolicy
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.policies import RecurrentPolicy

    env, jenv = DiscreteDummyEnv(4, 8, device="cpu"), JDiscreteDummyEnv(4, 8)
    config = {"hidden_size": 64}
    return (
        RecurrentPolicy(env.observation_spec, env.action_spec, model_config=config),
        JRecurrentPolicy(jenv.observation_spec, jenv.action_spec, model_config=config),
    )


@pytest.mark.parametrize("name", ["algotrading", "recurrent"])
def test_init_distributions_match_jax(name) -> None:
    """Both packages' initial parameters over seeds 0-19, leaf by leaf:
    constant leaves (biases, LayerNorm scales and biases, the LSTM's
    forget-gate bias) equal, random leaves alike in distribution
    (two-sample KS p >= 1e-3 over the pooled draws, means within 5
    standard errors, stds within 5 relative standard errors), and the
    LSTM's recurrent kernels orthogonal per gate, as flax's
    ``orthogonal()`` makes them."""
    policy, jpolicy = _policies(name)
    jinit = jax.jit(jpolicy.init_params)
    drawn: dict[str, list] = {}
    jdrawn: dict[str, list] = {}
    for seed in range(20):
        policy.init_params(torch.Generator().manual_seed(seed))
        for k, v in _flat(to_jax_params(policy.model)).items():
            drawn.setdefault(k, []).append(v)
        for k, v in _flat(jax.device_get(jinit(jax.random.key(seed)))).items():
            jdrawn.setdefault(k, []).append(v)
    assert drawn.keys() == jdrawn.keys()
    for key in sorted(drawn):
        got, want = np.stack(drawn[key]), np.stack(jdrawn[key])
        if want.std() == 0:
            np.testing.assert_array_equal(got, want, err_msg=key)
            continue
        p = ks_2samp(got.ravel(), want.ravel()).pvalue
        assert p >= 1e-3, (key, p)
        se = want.std() * np.sqrt(2.0 / want.size)
        assert abs(got.mean() - want.mean()) <= 5 * se, key
        assert abs(got.std() / want.std() - 1) <= 5 * np.sqrt(1.0 / want.size), key
        if "/h" in key and key.endswith("kernel"):
            for w in got:
                np.testing.assert_allclose(w.T @ w, np.eye(w.shape[1]), atol=1e-4, err_msg=key)
    if name == "recurrent":
        assert "lstm/lstm_0/hf/bias" in drawn

"""Feedforward PPO algorithm: the rollout and the advantage stage.

PyTorch counterpart of ``rl8_tpu/algorithms/_feedforward.py``. The JAX
package compiles ``collect`` into one ``lax.scan``; here it is a Python
loop over the horizon whose every step is one launch of the act kernel
(``ops/fused_act.py``), the env step, and the reversed-return update,
with a single host fetch per collect (the stats). The advantage stage
that starts a PPO update runs the GAE kernel (``ops/gae.py``). The
update itself (minibatching, the fused PPO kernel and its backward, the
optimizer and schedulers) is the next slice: :meth:`Algorithm.step`
raises until then.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..data import AlgorithmHparams, AlgorithmState, CollectStats, DataKeys, StepStats
from ..distributions import Categorical
from ..env import EnvFactory
from ..models import DefaultDiscreteModel
from ..ops import fused_act, fused_gae, pack_act_params
from ..parallel import gmax, gmean, gmin, gstd
from ..policies import Policy
from ..specs import assert_nd_spec
from ..utils import profile_ms
from ._base import GenericAlgorithmBase

__all__ = ["AlgorithmConfig", "Algorithm"]


@dataclass
class AlgorithmConfig:
    """Config for building a feedforward PPO algorithm.

    The fields of ``rl8_tpu.algorithms.AlgorithmConfig`` that the
    rollout, the advantage stage and hyperparameter validation read,
    plus ``device``. The model is the default model for the env's specs.
    """

    #: Model kwargs unpacked into the default model at instantiation.
    model_config: None | dict[str, Any] = None
    #: Number of transitions per :meth:`Algorithm.collect` call.
    horizon: int = 32
    #: Collects between env resets; negative = reset only once.
    horizons_per_env_reset: int = 1
    #: Number of parallelized environment instances.
    num_envs: int = 8192
    #: Accumulate gradients across minibatches before stepping.
    accumulate_grads: bool = False
    #: GAE lambda.
    gae_lambda: float = 0.95
    #: Discount factor.
    gamma: float = 0.95
    #: Minibatch size; ``None`` = the whole buffer.
    sgd_minibatch_size: None | int = None
    #: SGD epochs over the buffer per step.
    num_sgd_iters: int = 4
    #: Shuffle minibatches each epoch.
    shuffle_minibatches: bool = True
    #: Rows per shuffle unit.
    shuffle_block_rows: int = 8
    #: PPO clip parameter.
    clip_param: float = 0.2
    #: Value-function clip parameter.
    vf_clip_param: float = 5.0
    #: Dual clip for negative advantages (``None`` disables).
    dual_clip_param: None | float = None
    #: Value-function loss weight.
    vf_coeff: float = 1.0
    #: Early-stop epochs when approximate KL exceeds 1.5x this.
    target_kl_div: None | float = None
    #: Global gradient norm clip.
    max_grad_norm: float = 5.0
    #: Standardize advantages per batch.
    normalize_advantages: bool = True
    #: Normalize rewards by the std of reversed discounted returns.
    normalize_rewards: bool = True
    #: Seed of every random stream (parameters, env resets, sampling).
    seed: int = 0
    #: Device that holds the model, the env and the buffer. The default
    #: is the card; pass ``"cpu"`` to run the kernels' plain versions.
    device: str | torch.device = "cuda"

    def build(self, env_cls: EnvFactory) -> "Algorithm":
        """Build and validate an :class:`Algorithm` from this config."""
        algo = Algorithm(env_cls, config=self)
        algo.validate()
        return algo


class Algorithm(GenericAlgorithmBase[AlgorithmHparams, AlgorithmState, Policy]):
    """Feedforward PPO on one device.

    Args:
        env_cls: Highly parallelized environment factory. Stepped
            ``horizon`` times per :meth:`collect`.
        config: See :class:`AlgorithmConfig`.

    Examples:
        >>> from rl8_tpu_torch import AlgorithmConfig
        >>> from rl8_tpu_torch.env import DiscreteDummyEnv
        >>> algo = AlgorithmConfig(
        ...     num_envs=4, horizon=4, model_config={"hiddens": (8,)}, device="cpu"
        ... ).build(DiscreteDummyEnv)
        >>> int(algo.collect()["env/steps"])
        16

    """

    def __init__(self, env_cls: EnvFactory, /, config: None | AlgorithmConfig = None) -> None:
        config = config or AlgorithmConfig()
        self.device = torch.device(config.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "AlgorithmConfig.device is 'cuda' but CUDA is not available;"
                    " pass device='cpu' to run the kernels' plain versions."
                )
            # Full-f32 products in the model forward (the bootstrap value),
            # so they agree with the act kernel's f32 FMAs.
            torch.backends.cuda.matmul.allow_tf32 = False
        num_envs = min(config.num_envs, getattr(env_cls, "max_num_envs", config.num_envs))
        horizon = min(config.horizon, getattr(env_cls, "max_horizon", 1_000_000))
        self.env = env_cls(num_envs, horizon, device=self.device)
        assert_nd_spec(self.env.observation_spec)
        assert_nd_spec(self.env.action_spec)

        self.policy = Policy(
            self.env.observation_spec,
            self.env.action_spec,
            model_config=dict(config.model_config or {}),
        )
        model = self.policy.model
        if type(model) is not DefaultDiscreteModel or self.policy.distribution_cls is not Categorical:
            raise NotImplementedError(
                "This port runs the default discrete model with a Categorical"
                " distribution; other models and distributions come later."
            )
        model.validate_view_requirements()

        self.hparams = AlgorithmHparams(
            accumulate_grads=config.accumulate_grads,
            clip_param=config.clip_param,
            dual_clip_param=config.dual_clip_param,
            enable_amp=False,
            gae_lambda=config.gae_lambda,
            gamma=config.gamma,
            horizon=horizon,
            horizons_per_env_reset=config.horizons_per_env_reset,
            max_grad_norm=config.max_grad_norm,
            normalize_advantages=config.normalize_advantages,
            normalize_rewards=config.normalize_rewards,
            num_envs=num_envs,
            num_sgd_iters=config.num_sgd_iters,
            sgd_minibatch_size=(
                config.sgd_minibatch_size
                if config.sgd_minibatch_size is not None
                else num_envs * horizon
            ),
            shuffle_minibatches=config.shuffle_minibatches,
            shuffle_block_rows=config.shuffle_block_rows,
            target_kl_div=config.target_kl_div,
            vf_clip_param=config.vf_clip_param,
            vf_coeff=config.vf_coeff,
        ).validate()

        # One host generator seeds the others and then draws the act
        # kernel's per-step Philox keys; env resets draw on the device.
        self._key_gen = torch.Generator().manual_seed(config.seed)
        params_seed, env_seed = torch.randint(
            0, 2**62, (2,), generator=self._key_gen
        ).tolist()
        self.policy.init_params(torch.Generator().manual_seed(params_seed))
        model.to(self.device)
        self._env_gen = torch.Generator(device=self.device).manual_seed(env_seed)
        self.state = AlgorithmState(
            env_state=None,
            buffer=self._zero_buffer(),
            reward_scale=torch.tensor(1.0, device=self.device),
        )

    # ------------------------------------------------------------------
    # Buffer helpers
    # ------------------------------------------------------------------

    def _zero_buffer(self, num_envs: None | int = None) -> dict[str, torch.Tensor]:
        """Time-major rollout buffer of zeros; ``num_envs`` overrides the
        batch size (``validate()`` builds a tiny one)."""
        B = self.hparams.num_envs if num_envs is None else num_envs
        T = self.hparams.horizon
        dev = self.device
        buf = {
            DataKeys.OBS: self.env.observation_spec.zero((T + 1, B), dev),
            DataKeys.REWARDS: torch.zeros((T, B, 1), device=dev),
            DataKeys.ACTIONS: self.env.action_spec.zero((T, B), dev),
            DataKeys.LOGP: torch.zeros((T, B, 1), device=dev),
            DataKeys.VALUES: torch.zeros((T + 1, B, 1), device=dev),
        }
        if self.hparams.normalize_rewards:
            buf[DataKeys.REVERSED_DISCOUNTED_RETURNS] = torch.zeros((T + 1, B, 1), device=dev)
        return buf

    # ------------------------------------------------------------------
    # collect
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _collect_impl(
        self, env_config: None | dict[str, Any], deterministic: bool
    ) -> tuple[dict[str, torch.Tensor], bool]:
        """One rollout into a fresh buffer; returns the device-side stats
        and whether the env was reset."""
        h = self.hparams
        B, T = h.num_envs, h.horizon
        state = self.state
        buffer = state.buffer
        model = self.policy.model

        if h.horizons_per_env_reset < 0:
            reset_now = state.horizons == 0
        else:
            reset_now = state.horizons % h.horizons_per_env_reset == 0
        if reset_now:
            env_state, obs = self.env.reset(
                self._env_gen, state=state.env_state, config=env_config
            )
            rev = torch.zeros((B, 1), device=self.device)
        else:
            env_state, obs = state.env_state, buffer[DataKeys.OBS][-1]
            rev = (
                buffer[DataKeys.REVERSED_DISCOUNTED_RETURNS][-1]
                if h.normalize_rewards
                else torch.zeros((B, 1), device=self.device)
            )

        # The parameters are fixed for the whole rollout: pack them once.
        params = pack_act_params(model)
        keys = torch.randint(0, 2**32, (T, 2), generator=self._key_gen).tolist()
        cols: dict[str, list[torch.Tensor]] = {
            DataKeys.OBS: [obs],
            DataKeys.ACTIONS: [],
            DataKeys.LOGP: [],
            DataKeys.VALUES: [],
            DataKeys.REWARDS: [],
            DataKeys.REVERSED_DISCOUNTED_RETURNS: [rev],
        }
        for t in range(T):
            actions, logp, values = fused_act(params, obs, tuple(keys[t]), deterministic=deterministic)
            env_state, obs, rewards = self.env.step(env_state, actions)
            if h.normalize_rewards:
                rev = h.gamma * rev + rewards
            for key, value in (
                (DataKeys.OBS, obs),
                (DataKeys.ACTIONS, actions),
                (DataKeys.LOGP, logp),
                (DataKeys.VALUES, values),
                (DataKeys.REWARDS, rewards),
                (DataKeys.REVERSED_DISCOUNTED_RETURNS, rev),
            ):
                cols[key].append(value)

        # Bootstrap value at the final observation, through the module.
        views = model.apply_view_requirements({DataKeys.OBS: obs[:, None]}, kind="last")
        cols[DataKeys.VALUES].append(model(views)[1])

        new_buffer = {key: torch.stack(values) for key, values in cols.items()}
        new_buffer[DataKeys.REWARDS] = new_buffer[DataKeys.REWARDS].to(torch.float32)
        if h.normalize_rewards:
            reward_scale = gstd(new_buffer[DataKeys.REVERSED_DISCOUNTED_RETURNS][1:])
        else:
            del new_buffer[DataKeys.REVERSED_DISCOUNTED_RETURNS]
            reward_scale = torch.tensor(1.0, device=self.device)

        rewards = new_buffer[DataKeys.REWARDS]
        returns = rewards.sum(dim=0)
        stats = {
            "returns/min": gmin(returns),
            "returns/max": gmax(returns),
            "returns/mean": gmean(returns),
            "returns/std": gstd(returns),
            "rewards/min": gmin(rewards),
            "rewards/max": gmax(rewards),
            "rewards/mean": gmean(rewards),
            "rewards/std": gstd(rewards),
        }
        self.state = AlgorithmState(
            env_state=env_state,
            buffer=new_buffer,
            horizons=state.horizons + 1,
            buffered=True,
            reward_scale=reward_scale,
        )
        return stats, reset_now

    def collect(
        self,
        *,
        env_config: None | dict[str, Any] = None,
        deterministic: bool = False,
    ) -> CollectStats:
        """Collect environment transitions and policy samples in the buffer.

        The environment is reset per ``horizons_per_env_reset``; otherwise
        the last observation carries over.

        Args:
            env_config: Optional config for the env's reset (ignored when
                no reset is scheduled).
            deterministic: Sample deterministically (evaluation) vs
                stochastically (learning).

        Returns:
            Summary statistics of the collected experiences.

        """
        with profile_ms() as collect_timer:
            stats, was_reset = self._collect_impl(env_config, deterministic)
            # The one host fetch of the rollout; it waits for the device.
            values = torch.stack(list(stats.values())).tolist()
        collect_stats: CollectStats = dict(zip(stats, values))  # type: ignore[assignment]
        collect_stats["env/resets"] = self.hparams.num_envs * int(was_reset)
        collect_stats["env/steps"] = self.hparams.num_envs * self.hparams.horizon
        collect_stats["profiling/collect_ms"] = collect_timer()
        return collect_stats

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------

    def _advantages(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The advantage stage that starts a PPO update: unnormalized
        advantages and returns from the GAE kernel, then (optionally)
        advantages standardized with the batch mean and ``ddof=1`` std.
        Returns ``(advantages [T, B, 1], returns [T, B, 1])``."""
        h = self.hparams
        buffer = self.state.buffer
        advantages, returns = fused_gae(
            buffer[DataKeys.REWARDS],
            buffer[DataKeys.VALUES],
            self.state.reward_scale,
            gamma=h.gamma,
            gae_lambda=h.gae_lambda,
        )
        if h.normalize_advantages:
            advantages = (advantages - gmean(advantages)) / (gstd(advantages) + 1e-8)
        return advantages, returns

    def step(self) -> StepStats:
        """Update the policy using the collected buffer: not ported yet."""
        raise NotImplementedError(
            "Algorithm.step is the PPO update (packing, the fused PPO kernel"
            " and its backward, the optimizer and schedulers), which is the"
            " next slice of the port; this slice ports collect() and the"
            " advantage stage."
        )

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------

    @torch.no_grad()
    def validate(self) -> None:
        """Validate env/policy/buffer shape contracts with one real
        reset -> sample -> step round trip, and the training-path
        (``kind="all"``) view folding on a two-env zero buffer."""
        B = self.hparams.num_envs
        generator = torch.Generator(device=self.device).manual_seed(0)
        env_state, obs = self.env.reset(generator)
        sample = self.policy.sample(
            {DataKeys.OBS: obs[:, None]},
            kind="last",
            generator=generator,
            return_logp=True,
            return_values=True,
        )
        _, next_obs, rewards = self.env.step(env_state, sample[DataKeys.ACTIONS])
        actions = sample[DataKeys.ACTIONS]
        self.env.observation_spec.assert_is_in(obs)
        if actions.dim() < 2:
            raise AssertionError(
                "Actions must be at least 2D and have shape ``[N, ...]`` (where"
                " ``N`` is the number of environment instances)."
            )
        self.env.action_spec.assert_is_in(actions)
        for name, got in (
            ("Action log probabilities", sample[DataKeys.LOGP]),
            ("Value estimates", sample[DataKeys.VALUES]),
            ("Rewards", rewards),
        ):
            if tuple(got.shape) != (B, 1):
                raise AssertionError(f"{name} must be 2D with shape ``[N, 1]``.")
        self.env.observation_spec.assert_is_in(next_obs)

        T = self.hparams.horizon
        Bv = min(B, 2)
        zero_obs = self._zero_buffer(Bv)[DataKeys.OBS][:T].transpose(0, 1)
        views = self.policy.model.apply_view_requirements({DataKeys.OBS: zero_obs}, kind="all")
        sample_all = self.policy.sample(
            {DataKeys.VIEWS: views},
            kind="all",
            generator=generator,
            return_logp=True,
            return_values=True,
        )
        if views[DataKeys.OBS].shape[0] != Bv * T:
            raise AssertionError(
                "`apply_view_requirements(kind='all')` must produce a batch of"
                f" size ``[B * T, ...]`` = [{Bv * T}, ...] aligned with the"
                " flattened rollout buffer."
            )
        for name, got in (
            ("Training-path action log probabilities", sample_all[DataKeys.LOGP]),
            ("Training-path value estimates", sample_all[DataKeys.VALUES]),
        ):
            if tuple(got.shape) != (Bv * T, 1):
                raise AssertionError(f"{name} must have shape ``[B * T, 1]``.")

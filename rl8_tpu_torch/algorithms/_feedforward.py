"""Feedforward PPO algorithm: the rollout, the advantage stage and the
PPO update.

PyTorch counterpart of ``rl8_tpu/algorithms/_feedforward.py``. The JAX
package compiles ``collect`` and ``step`` into ``lax.scan``s; here they
are Python loops that launch the port's kernels:

- ``collect`` loops over the horizon, each step one launch of the act
  kernel of the policy's distribution (``ops/fused_act.py``), the env
  step and the reversed-return update, with a single host fetch per
  collect (the stats);
- ``step`` runs the advantage stage through the GAE kernel
  (``ops/gae.py``), packs the B-major training batch into one int32
  matrix (``ops/packing.py``), and per epoch and minibatch launches the
  PPO update kernel (``ops/fused_ppo.py``), then the clipped Adam update
  (``utils/optim.py``). The KL early stop, the gradient accumulation and
  the stat sums stay on the device (the update is gated with
  ``torch.where``, as ``lax.cond`` gates it), so a step makes one host
  fetch, for its stats.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from ..data import AlgorithmHparams, AlgorithmState, DataKeys
from ..distributions import Distribution, SquashedNormal
from ..env import EnvFactory
from ..ops import fused_act, fused_ppo_grads, pack_act_params, pack_rows, supports_fused_update
from ..ops.fused_mlp import load_flat_params
from ..parallel import gmax, gmean, gmin, gstd
from ..policies import Policy
from ..schedulers import ScheduleKind
from ..specs import assert_nd_spec
from ..utils.optim import AdamState
from ._base import GenericAlgorithmBase

__all__ = ["AlgorithmConfig", "Algorithm"]


def _t2b(x: torch.Tensor) -> torch.Tensor:
    """Time-major ``[T, B, ...]`` -> flat batch ``[B * T, ...]`` in B-major
    order, so that row ``i`` is the same transition as in ``rl8_tpu``."""
    return x.transpose(0, 1).reshape(-1, *x.shape[2:])


@dataclass
class AlgorithmConfig:
    """Config for building a feedforward PPO algorithm.

    The fields of ``rl8_tpu.algorithms.AlgorithmConfig`` that this port
    runs, plus ``device``. The model is the default model for the env's
    specs, with ``Categorical`` for discrete actions and ``Normal`` or
    ``SquashedNormal`` for continuous ones; the optimizer is Adam after a
    global-norm clip, over one flat parameter vector. ``optimizer_cls``,
    ``flatten_optimizer``, ``enable_amp`` and ``mesh`` exist so that a JAX
    config carries over; any value but the default raises
    ``NotImplementedError``.
    """

    #: Model kwargs unpacked into the default model at instantiation.
    model_config: None | dict[str, Any] = None
    #: Action distribution class; inferred from the action spec
    #: (``Categorical`` or ``Normal``) when omitted. ``SquashedNormal``
    #: has no entropy, so it trains only with a zero entropy coefficient
    #: and no schedule.
    distribution_cls: None | type[Distribution] = None
    #: Number of transitions per :meth:`Algorithm.collect` call.
    horizon: int = 32
    #: Collects between env resets; negative = reset only once.
    horizons_per_env_reset: int = 1
    #: Number of parallelized environment instances.
    num_envs: int = 8192
    #: ``None`` is Adam (``optax.adam`` in the JAX package); other
    #: optimizers come in a later slice.
    optimizer_cls: Any = None
    #: Adam's kwargs: ``lr`` (or ``learning_rate``), ``b1``, ``b2``,
    #: ``eps``, ``eps_root``; ``{"lr": 1e-3}`` by default.
    optimizer_config: None | dict[str, Any] = None
    #: Accumulate gradients across minibatches before stepping.
    accumulate_grads: bool = False
    #: bf16 mixed precision: not in this port yet.
    enable_amp: bool = False
    #: Optional LR schedule over environment transition counts.
    lr_schedule: None | list[tuple[int, float]] = None
    lr_schedule_kind: ScheduleKind = "step"
    #: Entropy coefficient (ignored when a schedule is given).
    entropy_coeff: float = 0.0
    entropy_coeff_schedule: None | list[tuple[int, float]] = None
    entropy_coeff_schedule_kind: ScheduleKind = "step"
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
    #: Run the optimizer over one flat parameter vector (the only mode
    #: of this port).
    flatten_optimizer: bool = True
    #: Seed of every random stream (parameters, env resets, sampling,
    #: minibatch shuffles).
    seed: int = 0
    #: Multi-device sharding: not in this port yet.
    mesh: Any = None
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
        >>> step_stats = algo.step()
        >>> "losses/total" in step_stats
        True

    """

    def __init__(self, env_cls: EnvFactory, /, config: None | AlgorithmConfig = None) -> None:
        config = config or AlgorithmConfig()
        params_seed = self._init_common(config)
        num_envs = min(config.num_envs, getattr(env_cls, "max_num_envs", config.num_envs))
        horizon = min(config.horizon, getattr(env_cls, "max_horizon", 1_000_000))
        self.env = env_cls(num_envs, horizon, device=self.device)
        assert_nd_spec(self.env.observation_spec)
        assert_nd_spec(self.env.action_spec)

        self.policy = Policy(
            self.env.observation_spec,
            self.env.action_spec,
            model_config=dict(config.model_config or {}),
            distribution_cls=config.distribution_cls,
        )
        model = self.policy.model
        #: Whether the action distribution squashes through tanh (the
        #: kernels' SquashedNormal variant).
        self._squashed_dist = self.policy.distribution_cls is SquashedNormal
        if not supports_fused_update(
            model, self.policy.distribution_cls, zero_entropy=self._static_zero_entropy
        ):
            raise NotImplementedError(
                "This port runs the default models (relu or tanh, biased layers, at"
                " most 8 of them): the discrete one with Categorical, the continuous"
                " one with Normal, or with SquashedNormal when the entropy coefficient"
                f" is 0 with no schedule; not {type(model).__name__} with"
                f" {self.policy.distribution_cls.__name__} here."
            )
        model.validate_view_requirements()

        self.hparams = AlgorithmHparams(
            **self._hparams_fields(config, num_envs, horizon, rows=num_envs * horizon)
        ).validate()
        self.policy.init_params(torch.Generator().manual_seed(params_seed))
        model.to(self.device)
        self.state = AlgorithmState(
            env_state=None,
            buffer=self._zero_buffer(),
            reward_scale=torch.tensor(1.0, device=self.device),
            opt_state=AdamState.zeros_like(self._pack_params().flat),
        )

    # ------------------------------------------------------------------
    # Buffer helpers
    # ------------------------------------------------------------------

    def _pack_params(self):
        """The model's current parameters packed for the kernels, with the
        policy's distribution kind."""
        return pack_act_params(self.policy.model, squashed=self._squashed_dist)

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
        params = self._pack_params()
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
        self.state = dataclasses.replace(
            state,
            env_state=env_state,
            buffer=new_buffer,
            horizons=state.horizons + 1,
            buffered=True,
            reward_scale=reward_scale,
        )
        return stats, reset_now

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _step_impl(self, lr: float, entropy_coeff: float) -> torch.Tensor:
        """One PPO update from the buffer (``rl8_tpu``'s ``_step_impl``).

        Returns the step's window-averaged stats on the device, in the
        order entropy, policy, vf, total, kl."""
        h = self.hparams
        model = self.policy.model
        buffer = self.state.buffer

        advantages, returns = self._advantages()
        views = model.apply_view_requirements(
            {DataKeys.OBS: buffer[DataKeys.OBS][: h.horizon].transpose(0, 1)}, kind="all"
        )
        packed, unpack = pack_rows(
            {
                DataKeys.ACTIONS: _t2b(buffer[DataKeys.ACTIONS]),
                DataKeys.LOGP: _t2b(buffer[DataKeys.LOGP]),
                DataKeys.ADVANTAGES: _t2b(advantages),
                DataKeys.RETURNS: _t2b(returns),
                DataKeys.VIEWS: views,
            }
        )
        cfg = self._loss_config(packed.shape[0] // h.num_minibatches)
        ec = torch.full((), entropy_coeff, dtype=torch.float32, device=self.device)
        # The update's working copy of the parameters, in kernel order.
        params = self._pack_params()
        flat, opt_state, stats = self._sgd_epochs(
            packed,
            lambda flat, mb: fused_ppo_grads(dataclasses.replace(params, flat=flat), mb, unpack, ec, cfg),
            params.flat,
            lr,
        )
        load_flat_params(model, flat)
        # Reset the buffer, keeping the final observation.
        new_buffer = {key: torch.zeros_like(value) for key, value in buffer.items()}
        new_buffer[DataKeys.OBS][-1] = buffer[DataKeys.OBS][-1]
        self.state = dataclasses.replace(
            self.state, buffer=new_buffer, buffered=False, opt_state=opt_state
        )
        return stats

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

"""Feedforward PPO algorithm: the rollout, the advantage stage and the
PPO update.

PyTorch counterpart of ``rl8_tpu/algorithms/_feedforward.py``. The JAX
package compiles ``collect`` and ``step`` into ``lax.scan``s; here they
are Python loops that launch the port's kernels. Two routes for the
rollout and two for the update, chosen at build as ``rl8_tpu`` chooses
them (``fused_act`` and ``fused_update``, each on where the kernels take
the model: a default model with relu or tanh, biased layers, at most 8 of
them, and its distribution):

- The fused act kernel: ``collect`` loops over the horizon, each step one
  launch of the act kernel of the policy's distribution
  (``ops/fused_act.py``), the env step and the reversed-return update.
- The module rollout (custom models, ``model`` or ``model_cls``, and
  default models the kernels do not take or with ``fused_act=False``):
  each rollout step builds the model's views from a carried window of
  observations, runs the model (through the chain kernels,
  ``ops/fused_mlp.py``, with ``fused_forward=True`` and a model that
  declares a ``FusedApplySpec``; else its module forward) and samples its
  distribution.
- ``step`` runs the advantage stage through the GAE kernel
  (``ops/gae.py``) and packs the B-major training batch into one int32
  matrix (``ops/packing.py``); then, per epoch and minibatch, either one
  launch of the PPO update kernel (``ops/fused_ppo.py``) or the PPO loss's
  gradient by autograd through the model, then the clipped Adam update
  (``utils/optim.py``) over one flat parameter vector.

In both, the KL early stop, the gradient accumulation and the stat sums
stay on the device (the update is gated with ``torch.where``, as
``lax.cond`` gates it), so ``collect`` and ``step`` make one host fetch
each, for their stats.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..data import AlgorithmHparams, AlgorithmState, DataKeys
from ..distributions import Distribution, SquashedNormal
from ..env import EnvFactory
from ..models import DefaultContinuousModel, DefaultDiscreteModel, Model, ModelFactory
from ..nn import ppo_losses
from ..ops import fused_act, fused_ppo_grads, pack_act_params, pack_rows, supports_fused_update
from ..ops.fused_ppo import supports_distribution
from ..ops.fused_mlp import (
    card_takes_chains,
    chain_names,
    fused_custom_apply,
    fused_default_apply,
    load_flat_params,
    named_chains,
    supports_fused_apply,
)
from ..parallel import gmax, gmean, gmin, gstd
from ..policies import Policy
from ..schedulers import ScheduleKind
from ..specs import assert_nd_spec
from ..utils import get_nested, set_nested
from ..utils.optim import AdamState
from ..views import tree_map
from ._base import GenericAlgorithmBase

__all__ = ["AlgorithmConfig", "Algorithm"]

#: Non-observation buffer keys ``rl8_tpu``'s models may window; this port
#: does not yet (ROADMAP Queue 1 #5).
_VIEWABLE_NONOBS_KEYS = (DataKeys.ACTIONS, DataKeys.REWARDS, DataKeys.LOGP, DataKeys.VALUES)


def _t2b(x: torch.Tensor) -> torch.Tensor:
    """Time-major ``[T, B, ...]`` -> flat batch ``[B * T, ...]`` in B-major
    order, so that row ``i`` is the same transition as in ``rl8_tpu``."""
    return x.transpose(0, 1).reshape(-1, *x.shape[2:])


def _stack(items: list[Any]) -> Any:
    """Stack a list of equally nested dicts of tensors leaf by leaf."""
    if isinstance(items[0], dict):
        return {key: _stack([item[key] for item in items]) for key in items[0]}
    return torch.stack(items)


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in _leaves(value)]
    return [tree]


def _keep_last(new: Any, old: Any) -> None:
    """``new[-1] = old[-1]`` leaf by leaf."""
    if isinstance(new, dict):
        for key in new:
            _keep_last(new[key], old[key])
    else:
        new[-1] = old[-1]


@dataclass
class AlgorithmConfig:
    """Config for building a feedforward PPO algorithm.

    The fields of ``rl8_tpu.algorithms.AlgorithmConfig`` that this port
    runs, plus ``device``. Without ``model`` or ``model_cls`` the model is
    the default model for the env's specs, with ``Categorical`` for
    discrete actions and ``Normal`` or ``SquashedNormal`` for continuous
    ones; the optimizer is Adam after a global-norm clip, over one flat
    parameter vector. ``optimizer_cls``, ``flatten_optimizer``,
    ``enable_amp``, ``mesh`` and ``exact_sharding`` exist so that a JAX
    config carries over; any value but the default raises
    ``NotImplementedError``.
    """

    #: Model instance to use (its architecture; its parameters are
    #: initialized from the seed, as ``rl8_tpu`` does). Mutually exclusive
    #: with ``model_cls``.
    model: None | Model = None
    #: Custom policy model class or factory; the default model for the
    #: env's specs if omitted.
    model_cls: None | ModelFactory = None
    #: Model kwargs unpacked into the model at instantiation.
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
    #: Evaluate the model's forward through the chain kernels
    #: (``ops/fused_mlp.py``, recompute-based backward) wherever the
    #: module forward would run: custom models declaring a
    #: ``FusedApplySpec`` (rollout and update), and the default models'
    #: bootstrap value (their act and update kernels take the rest).
    #: Models the kernels cannot evaluate keep the module forward, as in
    #: ``rl8_tpu``; on a CUDA device, chains wider than the card kernels
    #: take raise ``NotImplementedError`` at build.
    fused_forward: bool = False
    #: Compute each PPO minibatch's losses and parameter gradients with
    #: one launch of the update kernel (``ops/fused_ppo.py``: forward,
    #: distribution log-probs and entropy, dual-clip surrogate and clamped
    #: smooth-L1 value loss, hand-derived backward). Matches the autodiff
    #: route to f32 rounding. Off for custom models and for default models
    #: the kernels do not take (another activation than relu or tanh,
    #: ``bias=False``, more than 8 layers), which take the autodiff route.
    fused_update: bool = True
    #: Sample rollout actions, log-probs and values with one launch of the
    #: act kernel per step (``ops/fused_act.py``). Its Philox draws differ
    #: from the module rollout's sampler at equal seeds while following
    #: the same distributions. Off under the same conditions as
    #: ``fused_update``.
    fused_act: bool = True
    #: Seed of every random stream (parameters, env resets, sampling,
    #: minibatch shuffles).
    seed: int = 0
    #: Multi-device sharding: not in this port yet.
    mesh: Any = None
    #: ``rl8_tpu``'s GSPMD sharding mode of a ``mesh``: not in this port
    #: yet (ROADMAP Queue 1 #8).
    exact_sharding: bool = False
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
            model=config.model,
            model_cls=config.model_cls,
            model_config=dict(config.model_config or {}),
            distribution_cls=config.distribution_cls,
        )
        model = self.policy.model
        #: Whether the action distribution squashes through tanh (the
        #: kernels' SquashedNormal variant).
        self._squashed_dist = self.policy.distribution_cls is SquashedNormal
        dist_cls, zero_entropy = self.policy.distribution_cls, self._static_zero_entropy
        if type(model) in (DefaultDiscreteModel, DefaultContinuousModel) and not supports_distribution(
            model, dist_cls, zero_entropy=zero_entropy
        ):
            raise NotImplementedError(
                "This port runs the default models: the discrete one with Categorical, the"
                " continuous one with Normal, or with SquashedNormal when the entropy"
                f" coefficient is 0 with no schedule; not {type(model).__name__} with"
                f" {dist_cls.__name__} here."
            )
        kernels_take = supports_fused_update(model, dist_cls, zero_entropy=zero_entropy)
        #: Whether the update launches the update kernel (else autograd),
        #: and the rollout the act kernel (else the module rollout):
        #: ``rl8_tpu``'s gates, on the kernels' support of the model.
        self._fused_update = config.fused_update and kernels_take
        self._fused_act = config.fused_act and kernels_take
        model.validate_view_requirements()
        if model.drop_size:
            raise RuntimeError(
                "Models with sample-dropping view requirements can't align"
                " training views with the rollout buffer. Use"
                " `padded_rolling_window` (drop size 0) views instead."
            )
        self._check_view_keys()

        self.hparams = AlgorithmHparams(
            **self._hparams_fields(config, num_envs, horizon, rows=num_envs * horizon)
        ).validate()
        self.policy.init_params(torch.Generator().manual_seed(params_seed))
        model.to(self.device)
        #: The model's forward through the chain kernels (``rl8_tpu``'s
        #: ``_fused_forward``; both of the port's devices run them).
        self._fused_forward = config.fused_forward and supports_fused_apply(model)
        if self._fused_forward and self.device.type == "cuda":
            if not card_takes_chains(named_chains(model, chain_names(model))):
                raise NotImplementedError(
                    f"The card's chain kernels do not take {type(model).__name__}'s chains: at most 4"
                    " chains of 1 to 8 layers and 1 to 4 heads, whose row passes must fit a block's"
                    " shared memory (the CPU takes any width)."
                )
        #: The autodiff route's parameters, in the order of its flat vector.
        self._params = list(model.parameters())
        if not self._fused_act:
            #: Generator of the module rollout's action samples.
            self._sample_gen = torch.Generator(device=self.device).manual_seed(
                int(torch.randint(0, 2**62, (1,), generator=self._key_gen))
            )
        #: Padding masks of the rollout's view windows, by (size, valid).
        self._pad_masks: dict[tuple[int, int], torch.Tensor] = {}
        self.state = AlgorithmState(
            env_state=None,
            buffer=self._zero_buffer(),
            reward_scale=torch.tensor(1.0, device=self.device),
            opt_state=AdamState.zeros_like(self._flat_params()),
        )

    # ------------------------------------------------------------------
    # Model application and parameters
    # ------------------------------------------------------------------

    def _apply_model(self, batch: Any) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """Model forward: the chain kernels with ``fused_forward`` (default
        models and custom models declaring a ``FusedApplySpec``), the
        module otherwise."""
        model = self.policy.model
        if self._fused_forward:
            if type(model) in (DefaultDiscreteModel, DefaultContinuousModel):
                return fused_default_apply(model, batch)
            return fused_custom_apply(model, batch)
        return model(batch)

    def _pack_params(self):
        """The default model's current parameters packed for the kernels,
        with the policy's distribution kind."""
        return pack_act_params(self.policy.model, squashed=self._squashed_dist)

    def _flat_params(self) -> torch.Tensor:
        """The parameters as the flat vector the optimizer updates (Adam's
        state keeps its order): the kernels' order where the update kernel
        runs, ``model.parameters()``'s on the autodiff route."""
        if self._fused_update:
            return self._pack_params().flat
        return torch.cat([p.detach().reshape(-1) for p in self._params])

    def _load_flat(self, flat: torch.Tensor) -> None:
        """Write a flat vector of :meth:`_flat_params`'s layout into the
        model."""
        if self._fused_update:
            load_flat_params(self.policy.model, flat)
            return
        off = 0
        with torch.no_grad():
            for p in self._params:
                p.copy_(flat[off : off + p.numel()].view_as(p))
                off += p.numel()

    # ------------------------------------------------------------------
    # Buffer and view helpers
    # ------------------------------------------------------------------

    def _zero_buffer(self, num_envs: None | int = None) -> dict[str, Any]:
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

    def _check_view_keys(self) -> None:
        """Refuse view requirements on anything but observations:
        ``rl8_tpu`` also windows past actions, rewards, log-probs and
        values, which this port does not yet, and raises for the rest."""
        for key in self.policy.model.view_requirements:
            root = key if isinstance(key, str) else (key[0] if key else "")
            if root == DataKeys.OBS:
                continue
            if isinstance(key, tuple):
                raise RuntimeError(
                    f"View requirement key {key!r} is invalid: nested keys may only reference observations."
                )
            if root in _VIEWABLE_NONOBS_KEYS:
                raise NotImplementedError(
                    f"View requirements on {root!r} (windows of past actions, rewards, log-probs or"
                    " values) are a later slice of the port (ROADMAP Queue 1 #5)."
                )
            raise RuntimeError(
                f"View requirement key {key!r} does not reference a rollout buffer entry (one of"
                f" {(DataKeys.OBS, *_VIEWABLE_NONOBS_KEYS)})."
            )

    def _training_views(self, obs: Any) -> Any:
        """The model's ``kind="all"`` views of the time-major observations
        ``[T(+1), B, ...]``: ``[B * T, ...]`` rows aligned with the
        flattened buffer (``rl8_tpu``'s ``_training_view_batch``)."""
        T = self.hparams.horizon
        batch = {DataKeys.OBS: tree_map(lambda x: x[:T].transpose(0, 1), obs)}
        return self.policy.model.apply_view_requirements(batch, kind="all")

    def _pad_mask(self, size: int, valid: int) -> torch.Tensor:
        """``[size]`` bool, ``True`` on the padded slots of a window whose
        last ``valid`` slots hold observations (cached per shape)."""
        key = (size, valid)
        if key not in self._pad_masks:
            self._pad_masks[key] = torch.arange(size, device=self.device) < size - min(valid, size)
        return self._pad_masks[key]

    def _build_last_views(self, window: Any, valid: int) -> dict[str, Any]:
        """The model input of a ``kind="last"`` sample from the carried
        observation window ``[B, S + 1, ...]`` whose last ``valid`` slots
        hold this horizon's observations: ``rl8_tpu``'s
        ``_build_last_views`` for observation keys (the reference's
        ``apply_view_requirements(buffer[:, :t + 1], kind="last")``)."""
        B = self.hparams.num_envs
        out: dict[str, Any] = {}
        for key, vr in self.policy.model.view_requirements.items():
            item = window if key == DataKeys.OBS else get_nested(window, key[1:])
            if vr.shift == 0:
                view = tree_map(lambda t: t[:, -1], item)
            else:
                size = vr.shift + 1
                mask = self._pad_mask(size, valid).expand(B, size)
                view = tree_map(lambda t: {DataKeys.INPUTS: t[:, -size:], DataKeys.PADDING_MASK: mask}, item)
            set_nested(out, key, view)
        return out

    # ------------------------------------------------------------------
    # collect
    # ------------------------------------------------------------------

    def _fused_rollout(self, deterministic: bool) -> tuple[Callable, Callable]:
        """The fused act route's ``(act, bootstrap)``: one act-kernel launch
        per step, with the parameters packed once for the rollout."""
        params = self._pack_params()
        keys = torch.randint(0, 2**32, (self.hparams.horizon, 2), generator=self._key_gen).tolist()
        step = iter(keys)

        def act(obs: torch.Tensor) -> tuple[Any, torch.Tensor, torch.Tensor]:
            return fused_act(params, obs, tuple(next(step)), deterministic=deterministic)

        def bootstrap(obs: torch.Tensor) -> torch.Tensor:
            views = self.policy.model.apply_view_requirements({DataKeys.OBS: obs[:, None]}, kind="last")
            return self._apply_model(views)[1]

        return act, bootstrap

    def _module_rollout(self, deterministic: bool) -> tuple[Callable, Callable]:
        """The module rollout's ``(act, bootstrap)``: each pushes the newest
        observation into a window of the last ``S + 1`` observations of
        this horizon (``S`` the largest view shift; zeros, flagged as
        padding, before the horizon's first) and runs the model on its
        views; ``act`` then samples the distribution (``rl8_tpu``'s
        non-fused scan step)."""
        B = self.hparams.num_envs
        S = max(vr.shift for vr in self.policy.model.view_requirements.values())
        carry: dict[str, Any] = {"window": None, "valid": 0}

        def views(obs: Any) -> dict[str, Any]:
            if carry["window"] is None:
                carry["window"] = tree_map(lambda o: o.new_zeros((B, S + 1, *o.shape[1:])), obs)
            carry["window"] = _map2(lambda w, o: torch.cat([w[:, 1:], o[:, None]], dim=1), carry["window"], obs)
            carry["valid"] = min(carry["valid"] + 1, S + 1)
            return self._build_last_views(carry["window"], carry["valid"])

        def act(obs: Any) -> tuple[Any, torch.Tensor, torch.Tensor]:
            features, values = self._apply_model(views(obs))
            dist = self.policy.distribution_cls(features, self.policy.model)
            actions = dist.deterministic_sample() if deterministic else dist.sample(self._sample_gen)
            return actions, dist.logp(actions), values

        def bootstrap(obs: Any) -> torch.Tensor:
            return self._apply_model(views(obs))[1]

        return act, bootstrap

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
            env_state, obs = state.env_state, tree_map(lambda x: x[-1], buffer[DataKeys.OBS])
            rev = (
                buffer[DataKeys.REVERSED_DISCOUNTED_RETURNS][-1]
                if h.normalize_rewards
                else torch.zeros((B, 1), device=self.device)
            )

        act, bootstrap = (self._fused_rollout if self._fused_act else self._module_rollout)(deterministic)
        cols: dict[str, list[Any]] = {
            DataKeys.OBS: [obs],
            DataKeys.ACTIONS: [],
            DataKeys.LOGP: [],
            DataKeys.VALUES: [],
            DataKeys.REWARDS: [],
            DataKeys.REVERSED_DISCOUNTED_RETURNS: [rev],
        }
        for _ in range(T):
            actions, logp, values = act(obs)
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
        # Bootstrap value at the final observation.
        cols[DataKeys.VALUES].append(bootstrap(obs))

        new_buffer = {key: _stack(values) for key, values in cols.items()}
        for key in (DataKeys.REWARDS, DataKeys.LOGP, DataKeys.VALUES):
            new_buffer[key] = new_buffer[key].to(torch.float32)
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

    def _autodiff_grads_fn(self, unpack: Any, entropy_coeff: float, accum: int) -> Callable:
        """The autodiff route's ``grads_fn`` for ``_sgd_epochs``: the PPO
        losses of a packed minibatch through :meth:`_apply_model` and the
        policy's distribution, their approximate KL, and the gradient of
        ``total / accum`` over the flat parameters, by autograd
        (``rl8_tpu``'s ``_loss_fn``)."""
        h = self.hparams
        model = self.policy.model
        # A literal 0 skips the entropy term (SquashedNormal has none).
        ec: Any = 0.0 if self._static_zero_entropy else torch.tensor(entropy_coeff, device=self.device)

        def grads_fn(flat: torch.Tensor, mb: torch.Tensor) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
            self._load_flat(flat)
            batch = unpack(mb)
            # ``step`` runs without autograd; the loss needs it.
            with torch.enable_grad():
                features, values = self._apply_model(batch[DataKeys.VIEWS])
                dist = self.policy.distribution_cls(features, model)
                losses = ppo_losses(
                    batch, values, dist, clip_param=h.clip_param, dual_clip_param=h.dual_clip_param,
                    entropy_coeff=ec, vf_clip_param=h.vf_clip_param, vf_coeff=h.vf_coeff,
                )
                grads = torch.autograd.grad(losses["total"] / accum, self._params, allow_unused=True)
            ratio = dist.logp(batch[DataKeys.ACTIONS]).detach().reshape(-1) - batch[DataKeys.LOGP].reshape(-1)
            kl = torch.mean((torch.exp(ratio) - 1) - ratio)
            flat_grads = torch.cat(
                [(g if g is not None else torch.zeros_like(p)).reshape(-1) for g, p in zip(grads, self._params)]
            )
            return {k: v.detach() for k, v in losses.items()}, kl, flat_grads

        return grads_fn

    @torch.no_grad()
    def _step_impl(self, lr: float, entropy_coeff: float) -> torch.Tensor:
        """One PPO update from the buffer (``rl8_tpu``'s ``_step_impl``).

        Returns the step's window-averaged stats on the device, in the
        order entropy, policy, vf, total, kl."""
        h = self.hparams
        buffer = self.state.buffer

        advantages, returns = self._advantages()
        packed, unpack = pack_rows(
            {
                DataKeys.ACTIONS: _t2b(buffer[DataKeys.ACTIONS]),
                DataKeys.LOGP: _t2b(buffer[DataKeys.LOGP]),
                DataKeys.ADVANTAGES: _t2b(advantages),
                DataKeys.RETURNS: _t2b(returns),
                DataKeys.VIEWS: self._training_views(buffer[DataKeys.OBS]),
            }
        )
        if self._fused_update:
            cfg = self._loss_config(packed.shape[0] // h.num_minibatches)
            ec = torch.full((), entropy_coeff, dtype=torch.float32, device=self.device)
            # The update's working copy of the parameters, in kernel order.
            params = self._pack_params()

            def grads_fn(flat: torch.Tensor, mb: torch.Tensor):
                return fused_ppo_grads(dataclasses.replace(params, flat=flat), mb, unpack, ec, cfg)

        else:
            grads_fn = self._autodiff_grads_fn(unpack, entropy_coeff, h.num_minibatches if h.accumulate_grads else 1)
        flat, opt_state, stats = self._sgd_epochs(packed, grads_fn, self._flat_params(), lr)
        self._load_flat(flat)
        # Reset the buffer, keeping the final observation.
        new_buffer = {key: tree_map(torch.zeros_like, value) for key, value in buffer.items()}
        _keep_last(new_buffer[DataKeys.OBS], buffer[DataKeys.OBS])
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
            {DataKeys.OBS: tree_map(lambda o: o[:, None], obs)},
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
        views = self._training_views(self._zero_buffer(Bv)[DataKeys.OBS])
        sample_all = self.policy.sample(
            {DataKeys.VIEWS: views},
            kind="all",
            generator=generator,
            return_logp=True,
            return_values=True,
        )
        leading = {leaf.shape[0] for leaf in _leaves(views)}
        if leading != {Bv * T}:
            raise AssertionError(
                "`apply_view_requirements(kind='all')` must produce a batch of"
                f" size ``[B * T, ...]`` = [{Bv * T}, ...] aligned with the"
                f" flattened rollout buffer; got leading sizes {leading}."
            )
        for name, got in (
            ("Training-path action log probabilities", sample_all[DataKeys.LOGP]),
            ("Training-path value estimates", sample_all[DataKeys.VALUES]),
        ):
            if tuple(got.shape) != (Bv * T, 1):
                raise AssertionError(f"{name} must have shape ``[B * T, 1]``.")


def _map2(fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], a: Any, b: Any) -> Any:
    """``fn`` over the leaves of two equally nested dicts."""
    if isinstance(a, dict):
        return {key: _map2(fn, a[key], b[key]) for key in a}
    return fn(a, b)

"""Recurrent PPO algorithm: the rollout with recurrent states, the
advantage stage and the truncated-BPTT update.

PyTorch counterpart of ``rl8_tpu/algorithms/_recurrent.py``. As in the
port's feedforward algorithm, ``collect`` and ``step`` are Python loops
that launch the port's kernels, with one host fetch each:

- ``collect`` loops over the horizon, each step one launch of the
  recurrent act kernel (``ops/fused_rnn_act.py``: the LSTM cells, the
  heads and the sampling, returning the new states), the env step and the
  reversed-return update. The states carry across collects and are
  re-initialized at the start of a sequence every ``seqs_per_state_reset``
  sequences, counted by a host-side ``seqs``; the buffer keeps each
  step's input states and, last, the final ones;
- ``step`` runs the advantage stage through the GAE kernel, cuts the
  buffer into ``[B * T/L, L]`` sequences whose stored initial states seed
  the forward, packs them into one int32 matrix, and per epoch and
  minibatch launches the recurrent update kernel
  (``ops/fused_rnn_ppo.py``), then the clipped Adam update; the KL early
  stop, the accumulation and the stat sums stay on the device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from ..data import DataKeys, RecurrentAlgorithmHparams, RecurrentAlgorithmState
from ..distributions import Distribution, SquashedNormal
from ..env import EnvFactory
from ..ops import fused_rnn_act, fused_rnn_ppo_grads, load_rnn_params, pack_rnn_params, pack_rows
from ..ops import card_takes_rnn_update, supports_fused_rnn_update
from ..parallel import gmax, gmean, gmin, gstd
from ..policies import RecurrentPolicy
from ..schedulers import ScheduleKind
from ..specs import assert_nd_spec
from ..utils.optim import AdamState
from ._base import GenericAlgorithmBase

__all__ = ["RecurrentAlgorithmConfig", "RecurrentAlgorithm"]


def _seq_major(x: torch.Tensor, L: int) -> torch.Tensor:
    """Time-major ``[T, B, ...]`` -> sequence batch ``[B * T/L, L, ...]``,
    in ``rl8_tpu``'s element order (row ``i`` is the same sequence)."""
    T, B = x.shape[:2]
    x = x.reshape(T // L, L, B, *x.shape[2:]).movedim(2, 0)  # [B, T/L, L, ...]
    return x.reshape(B * (T // L), L, *x.shape[3:])


@dataclass
class RecurrentAlgorithmConfig:
    """Config for building a recurrent PPO algorithm.

    The fields of ``rl8_tpu.algorithms.RecurrentAlgorithmConfig`` that this
    port runs, plus ``device``; see
    :class:`~rl8_tpu_torch.algorithms.AlgorithmConfig` for the shared
    ones. The model is the default recurrent model for the env's specs
    (a stacked LSTM), with ``Categorical`` for discrete actions and
    ``Normal`` or ``SquashedNormal`` for continuous ones. ``model``,
    ``model_cls``, ``fused_update``, ``fused_act``, ``optimizer_cls``,
    ``flatten_optimizer``, ``enable_amp``, ``mesh`` and ``exact_sharding``
    exist so that a JAX config carries over; any value but the default
    raises ``NotImplementedError``. ``fused_forward`` is accepted and, as
    in ``rl8_tpu``, stays off for the default model (it declares no
    ``FusedRecurrentApplySpec``).
    """

    #: A custom recurrent model instance: not in this port yet.
    model: Any = None
    #: A custom recurrent model class or factory: not in this port yet.
    model_cls: Any = None
    #: Default model kwargs: ``hidden_size`` (256), ``num_layers`` (1).
    model_config: None | dict[str, Any] = None
    #: Action distribution class; inferred from the action spec
    #: (``Categorical`` or ``Normal``) when omitted. ``SquashedNormal``
    #: trains only with a zero entropy coefficient and no schedule.
    distribution_cls: None | type[Distribution] = None
    #: Number of transitions per :meth:`RecurrentAlgorithm.collect` call.
    horizon: int = 32
    #: Collects between env resets; negative = reset only once.
    horizons_per_env_reset: int = 1
    #: Number of parallelized environment instances.
    num_envs: int = 8192
    #: Truncated backprop-through-time sequence length.
    seq_len: int = 4
    #: Sequences before recurrent states re-initialize (negative = never).
    seqs_per_state_reset: int = 8
    #: ``None`` is Adam; other optimizers come in a later slice.
    optimizer_cls: Any = None
    #: Adam's kwargs; ``{"lr": 1e-3}`` by default.
    optimizer_config: None | dict[str, Any] = None
    #: Accumulate gradients across minibatches before stepping.
    accumulate_grads: bool = False
    #: bf16 mixed precision: not in this port yet.
    enable_amp: bool = False
    lr_schedule: None | list[tuple[int, float]] = None
    lr_schedule_kind: ScheduleKind = "step"
    entropy_coeff: float = 0.0
    entropy_coeff_schedule: None | list[tuple[int, float]] = None
    entropy_coeff_schedule_kind: ScheduleKind = "step"
    gae_lambda: float = 0.95
    gamma: float = 0.95
    #: Minibatch size in sequences; ``None`` = the whole buffer.
    sgd_minibatch_size: None | int = None
    num_sgd_iters: int = 4
    shuffle_minibatches: bool = True
    #: Sequences per shuffle unit.
    shuffle_block_rows: int = 8
    clip_param: float = 0.2
    vf_clip_param: float = 5.0
    dual_clip_param: None | float = None
    vf_coeff: float = 1.0
    target_kl_div: None | float = None
    max_grad_norm: float = 5.0
    normalize_advantages: bool = True
    normalize_rewards: bool = True
    #: Run the optimizer over one flat parameter vector (the only mode of
    #: this port).
    flatten_optimizer: bool = True
    #: The chain kernels of custom recurrent models declaring a
    #: ``FusedRecurrentApplySpec`` (custom recurrent models are a later
    #: slice, ROADMAP Queue 1 #5); off for the default model.
    fused_forward: bool = False
    #: Compute each minibatch's losses and parameter gradients with one
    #: launch of the recurrent update kernel (``ops/fused_rnn_ppo.py``:
    #: LSTM BPTT, heads and PPO losses). The port has no recurrent
    #: autodiff route yet (ROADMAP Queue 1 #5): ``False`` raises.
    fused_update: bool = True
    #: Sample rollout actions, log-probs, values and states with one launch
    #: of the recurrent act kernel per step (``ops/fused_rnn_act.py``).
    #: ``False`` raises, as ``fused_update`` does.
    fused_act: bool = True
    seed: int = 0
    #: Multi-device sharding: not in this port yet.
    mesh: Any = None
    #: ``rl8_tpu``'s GSPMD sharding mode of a ``mesh``: not in this port
    #: yet (ROADMAP Queue 1 #8).
    exact_sharding: bool = False
    #: Device that holds the model, the env and the buffer. The default
    #: is the card; pass ``"cpu"`` to run the kernels' plain versions.
    device: str | torch.device = "cuda"

    def build(self, env_cls: EnvFactory) -> "RecurrentAlgorithm":
        """Build and validate a :class:`RecurrentAlgorithm` from this config."""
        algo = RecurrentAlgorithm(env_cls, config=self)
        algo.validate()
        return algo


class RecurrentAlgorithm(GenericAlgorithmBase[RecurrentAlgorithmHparams, RecurrentAlgorithmState, RecurrentPolicy]):
    """Recurrent PPO on one device.

    Args:
        env_cls: Highly parallelized environment factory.
        config: See :class:`RecurrentAlgorithmConfig`.

    Examples:
        >>> from rl8_tpu_torch.algorithms import RecurrentAlgorithmConfig
        >>> from rl8_tpu_torch.env import DiscreteDummyEnv
        >>> algo = RecurrentAlgorithmConfig(
        ...     num_envs=4, horizon=8, seq_len=2, seqs_per_state_reset=4,
        ...     model_config={"hidden_size": 8}, device="cpu",
        ... ).build(DiscreteDummyEnv)
        >>> int(algo.collect()["env/steps"]), algo.state.seqs
        (32, 4)
        >>> "losses/total" in algo.step()
        True

    """

    def __init__(self, env_cls: EnvFactory, /, config: None | RecurrentAlgorithmConfig = None) -> None:
        config = config or RecurrentAlgorithmConfig()
        params_seed = self._init_common(
            config,
            unported=(
                (
                    config.model is not None or config.model_cls is not None,
                    "custom recurrent models (`model`, `model_cls`; ROADMAP Queue 1 #5)",
                ),
                (
                    not (config.fused_update and config.fused_act),
                    "fused_update=False or fused_act=False on recurrent models: the recurrent"
                    " autodiff route and module rollout (ROADMAP Queue 1 #5)",
                ),
            ),
        )
        num_envs = min(config.num_envs, getattr(env_cls, "max_num_envs", config.num_envs))
        horizon = min(config.horizon, getattr(env_cls, "max_horizon", 1_000_000))
        self.env = env_cls(num_envs, horizon, device=self.device)
        assert_nd_spec(self.env.observation_spec)
        assert_nd_spec(self.env.action_spec)

        self.policy = RecurrentPolicy(
            self.env.observation_spec,
            self.env.action_spec,
            model_config=dict(config.model_config or {}),
            distribution_cls=config.distribution_cls,
        )
        model = self.policy.model
        #: Whether the action distribution squashes through tanh.
        self._squashed_dist = self.policy.distribution_cls is SquashedNormal
        if not supports_fused_rnn_update(model, self.policy.distribution_cls, zero_entropy=self._static_zero_entropy):
            raise NotImplementedError(
                "This port runs the default recurrent models (1 to 8 biased LSTM layers,"
                " float observations): the discrete one with Categorical, the continuous one"
                " with Normal, or with SquashedNormal when the entropy coefficient is 0 with"
                f" no schedule; not {type(model).__name__} with {self.policy.distribution_cls.__name__} here."
            )
        #: The chain kernels for custom recurrent models: never on for the
        #: default model, as in ``rl8_tpu``.
        self._fused_forward = False
        self.hparams = RecurrentAlgorithmHparams(
            **self._hparams_fields(config, num_envs, horizon, rows=num_envs * (horizon // max(config.seq_len, 1))),
            seq_len=config.seq_len,
            seqs_per_state_reset=config.seqs_per_state_reset,
        ).validate()
        self.policy.init_params(torch.Generator().manual_seed(params_seed))
        model.to(self.device)
        if self.device.type == "cuda" and not card_takes_rnn_update(self._pack_params()):
            raise NotImplementedError(
                f"The card's recurrent update kernel does not take hidden_size {model.hidden_size} with these"
                " inputs and heads: its row pass must fit a block's shared memory (the CPU takes any width)."
            )
        self.state = RecurrentAlgorithmState(
            env_state=None,
            buffer=self._zero_buffer(),
            reward_scale=torch.tensor(1.0, device=self.device),
            opt_state=AdamState.zeros_like(self._pack_params().flat),
        )

    def _pack_params(self):
        """The model's current parameters packed for the kernels, with the
        policy's distribution kind."""
        return pack_rnn_params(self.policy.model, squashed=self._squashed_dist)

    def _zero_buffer(self) -> dict[str, Any]:
        """Time-major rollout buffer of zeros, with per-step recurrent
        states ``[T + 1, B, K, H]``."""
        B, T, dev = self.hparams.num_envs, self.hparams.horizon, self.device
        buf: dict[str, Any] = {
            DataKeys.OBS: self.env.observation_spec.zero((T + 1, B), dev),
            DataKeys.STATES: self.policy.state_spec.zero((T + 1, B), dev),
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
        h = self.hparams
        B, T, L = h.num_envs, h.horizon, h.seq_len
        state = self.state
        buffer = state.buffer

        if h.horizons_per_env_reset < 0:
            reset_now = state.horizons == 0
        else:
            reset_now = state.horizons % h.horizons_per_env_reset == 0
        if reset_now:
            env_state, obs = self.env.reset(self._env_gen, state=state.env_state, config=env_config)
            rev = torch.zeros((B, 1), device=self.device)
        else:
            env_state, obs = state.env_state, buffer[DataKeys.OBS][-1]
            rev = (
                buffer[DataKeys.REVERSED_DISCOUNTED_RETURNS][-1]
                if h.normalize_rewards
                else torch.zeros((B, 1), device=self.device)
            )
        # Recurrent states always carry across collects; the cadence below
        # re-initializes them.
        states = {key: value[-1] for key, value in buffer[DataKeys.STATES].items()}

        params = self._pack_params()
        keys = torch.randint(0, 2**32, (T, 2), generator=self._key_gen).tolist()
        cols: dict[str, list[Any]] = {
            DataKeys.OBS: [obs],
            DataKeys.STATES: [],
            DataKeys.ACTIONS: [],
            DataKeys.LOGP: [],
            DataKeys.VALUES: [],
            DataKeys.REWARDS: [],
            DataKeys.REVERSED_DISCOUNTED_RETURNS: [rev],
        }
        seqs = state.seqs
        for t in range(T):
            if h.seqs_per_state_reset < 0:
                reset_states = seqs == 0 and t == 0
            else:
                reset_states = t % L == 0 and seqs % h.seqs_per_state_reset == 0
            if reset_states:
                states = self.policy.init_states(B, self.device)
            actions, logp, values, new_states = fused_rnn_act(
                params, obs, states, tuple(keys[t]), deterministic=deterministic
            )
            env_state, obs, rewards = self.env.step(env_state, actions)
            if h.normalize_rewards:
                rev = h.gamma * rev + rewards
            for key, value in (
                (DataKeys.OBS, obs),
                (DataKeys.STATES, states),
                (DataKeys.ACTIONS, actions),
                (DataKeys.LOGP, logp),
                (DataKeys.VALUES, values),
                (DataKeys.REWARDS, rewards),
                (DataKeys.REVERSED_DISCOUNTED_RETURNS, rev),
            ):
                cols[key].append(value)
            states = new_states
            seqs += (t + 1) % L == 0

        # Bootstrap value at the final observation from the final states,
        # through the module.
        (_, v_last), _ = self.policy.model({DataKeys.OBS: obs[:, None]}, states)
        cols[DataKeys.VALUES].append(v_last)
        cols[DataKeys.STATES].append(states)

        new_buffer: dict[str, Any] = {
            key: torch.stack(values) for key, values in cols.items() if key != DataKeys.STATES
        }
        new_buffer[DataKeys.STATES] = {
            key: torch.stack([s[key] for s in cols[DataKeys.STATES]]) for key in states
        }
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
            seqs=seqs,
        )
        return stats, reset_now

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _step_impl(self, lr: float, entropy_coeff: float) -> torch.Tensor:
        h = self.hparams
        T, L = h.horizon, h.seq_len
        buffer = self.state.buffer

        advantages, returns = self._advantages()
        # Each row is a [seq_len] chunk; its stored initial states seed the
        # forward.
        packed, unpack = pack_rows(
            {
                DataKeys.OBS: _seq_major(buffer[DataKeys.OBS][:T], L),
                DataKeys.STATES: {
                    key: _seq_major(value[:T], L)[:, 0] for key, value in buffer[DataKeys.STATES].items()
                },
                DataKeys.ACTIONS: _seq_major(buffer[DataKeys.ACTIONS], L),
                DataKeys.LOGP: _seq_major(buffer[DataKeys.LOGP], L),
                DataKeys.ADVANTAGES: _seq_major(advantages, L),
                DataKeys.RETURNS: _seq_major(returns, L),
            }
        )
        cfg = self._loss_config(packed.shape[0] // h.num_minibatches)
        ec = torch.full((), entropy_coeff, dtype=torch.float32, device=self.device)
        params = self._pack_params()
        flat, opt_state, stats = self._sgd_epochs(
            packed,
            lambda flat, mb: fused_rnn_ppo_grads(dataclasses.replace(params, flat=flat), mb, unpack, ec, cfg),
            params.flat,
            lr,
        )
        load_rnn_params(self.policy.model, flat)
        # Reset the buffer, keeping the final observation and the final
        # states.
        new_buffer: dict[str, Any] = {
            key: torch.zeros_like(value) for key, value in buffer.items() if key != DataKeys.STATES
        }
        new_buffer[DataKeys.OBS][-1] = buffer[DataKeys.OBS][-1]
        new_buffer[DataKeys.STATES] = {}
        for key, value in buffer[DataKeys.STATES].items():
            new_buffer[DataKeys.STATES][key] = torch.zeros_like(value)
            new_buffer[DataKeys.STATES][key][-1] = value[-1]
        self.state = dataclasses.replace(self.state, buffer=new_buffer, buffered=False, opt_state=opt_state)
        return stats

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------

    @torch.no_grad()
    def validate(self) -> None:
        """Validate env/policy/buffer shape contracts with one real
        reset -> sample -> step round trip."""
        B = self.hparams.num_envs
        generator = torch.Generator(device=self.device).manual_seed(0)
        env_state, obs = self.env.reset(generator)
        sample, new_states = self.policy.sample(
            {DataKeys.OBS: obs[:, None]},
            self.policy.init_states(B, self.device),
            generator=generator,
            return_logp=True,
            return_values=True,
        )
        _, next_obs, rewards = self.env.step(env_state, sample[DataKeys.ACTIONS])
        actions = sample[DataKeys.ACTIONS]
        self.env.observation_spec.assert_is_in(obs)
        if actions.dim() < 2:
            raise AssertionError("Actions must be at least 2D and have shape ``[N, ...]``.")
        self.env.action_spec.assert_is_in(actions)
        for name, got in (
            ("Action log probabilities", sample[DataKeys.LOGP]),
            ("Value estimates", sample[DataKeys.VALUES]),
            ("Rewards", rewards),
        ):
            if tuple(got.shape) != (B, 1):
                raise AssertionError(f"{name} must be 2D with shape ``[N, 1]``.")
        for leaf in new_states.values():
            if leaf.shape[0] != B:
                raise AssertionError("Recurrent states must keep the batch dimension ``[N, ...]``.")
        self.env.observation_spec.assert_is_in(next_obs)

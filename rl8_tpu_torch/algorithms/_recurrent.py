"""Recurrent PPO algorithm: the rollout with recurrent states, the
advantage stage and the truncated-BPTT update.

PyTorch counterpart of ``rl8_tpu/algorithms/_recurrent.py``. As in the
port's feedforward algorithm, ``collect`` and ``step`` are Python loops
that launch the port's kernels, with one host fetch each, and each has
two routes, chosen at build by ``rl8_tpu``'s gates (``fused_act`` and
``fused_update``, each on where the kernels take the model: a default
recurrent model with 1 to 8 biased LSTM layers, no compute dtype, and its
distribution; any other model or distribution, custom recurrent models
(``model``, ``model_cls``) included, takes the module routes):

- ``collect`` loops over the horizon, each step one launch of the
  recurrent act kernel (``ops/fused_rnn_act.py``: the LSTM cells, the
  heads and the sampling, returning the new states) or, on the module
  route, the model's forward from the states and a draw from its
  distribution; then the env step and the reversed-return update. The
  states carry across collects and are re-initialized at the start of a
  sequence every ``seqs_per_state_reset`` sequences, counted by a
  host-side ``seqs``; the buffer keeps each step's input states and,
  last, the final ones. With ``fused_forward=True``, a custom model that
  declares a ``FusedRecurrentApplySpec`` runs its post-recurrence chains
  through the chain kernels (``ops/fused_mlp.py``) wherever its forward
  runs;
- ``step`` runs the advantage stage through the GAE kernel, cuts the
  buffer into ``[B * T/L, L]`` sequences whose stored initial states seed
  the forward, packs them into one int32 matrix, and per epoch and
  minibatch launches the recurrent update kernel
  (``ops/fused_rnn_ppo.py``) or takes the PPO loss's gradient by autograd
  through the model, then the clipped optimizer update; the KL early
  stop, the accumulation and the stat sums stay on the device.

``enable_amp`` gives the default model ``dtype=torch.bfloat16``, which
takes it to the module routes, as in ``rl8_tpu``; a custom model's dtype
is its own.
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
from ..ops import card_takes_rnn_act, card_takes_rnn_update, supports_fused_rnn_update
from ..ops.fused_mlp import fused_recurrent_custom_apply, model_fits_vmem, supports_fused_recurrent_apply
from ..parallel import gstd
from ..policies import RecurrentPolicy
from ..schedulers import ScheduleKind
from ..specs import assert_nd_spec
from ..views import tree_map
from ._base import GenericAlgorithmBase
from ._feedforward import _keep_last, _stack

__all__ = ["RecurrentAlgorithmConfig", "RecurrentAlgorithm"]


def _seq_major(x: Any, L: int) -> Any:
    """Time-major ``[T, B, ...]`` -> sequence batch ``[B * T/L, L, ...]``,
    leaf by leaf, in ``rl8_tpu``'s element order (row ``i`` is the same
    sequence)."""

    def leaf(x: torch.Tensor) -> torch.Tensor:
        T, B = x.shape[:2]
        x = x.reshape(T // L, L, B, *x.shape[2:]).movedim(2, 0)  # [B, T/L, L, ...]
        return x.reshape(B * (T // L), L, *x.shape[3:])

    return tree_map(leaf, x)


@dataclass
class RecurrentAlgorithmConfig:
    """Config for building a recurrent PPO algorithm.

    The fields of ``rl8_tpu.algorithms.RecurrentAlgorithmConfig`` that this
    port runs, plus ``device``; see
    :class:`~rl8_tpu_torch.algorithms.AlgorithmConfig` for the shared
    ones. Without ``model`` or ``model_cls`` the model is the default
    recurrent model for the env's specs (a stacked LSTM), with
    ``Categorical`` for discrete actions and ``Normal`` or
    ``SquashedNormal`` for continuous ones. ``mesh`` and
    ``exact_sharding`` shard the env batch as in
    :class:`~rl8_tpu_torch.algorithms.AlgorithmConfig` (the recurrent
    states are env-batched buffer leaves). ``fused_forward``
    stays off, as in ``rl8_tpu``, for a model that declares no
    ``FusedRecurrentApplySpec`` (the default one).
    """

    #: Recurrent model instance to use (its architecture; its parameters
    #: are initialized from the seed). Mutually exclusive with
    #: ``model_cls``.
    model: Any = None
    #: Custom recurrent model class or factory; the default recurrent
    #: model for the env's specs if omitted.
    model_cls: Any = None
    #: Model kwargs unpacked into the model at instantiation (the default
    #: model's: ``hidden_size`` (256), ``num_layers`` (1)).
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
    #: ``None`` is the hand-written Adam; else a ``torch.optim.Optimizer``
    #: class (see ``AlgorithmConfig.optimizer_cls``).
    optimizer_cls: Any = None
    #: The optimizer's kwargs; ``{"lr": 1e-3}`` by default.
    optimizer_config: None | dict[str, Any] = None
    #: Accumulate gradients across minibatches before stepping.
    accumulate_grads: bool = False
    #: bf16 mixed precision: the default model computes in bf16
    #: (``model_config["dtype"]``, unless given), which takes it to the
    #: module rollout and the autodiff update; custom models are left as
    #: they are.
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
    #: Run a ``torch.optim`` optimizer over one flat parameter vector;
    #: ``False`` gives it one tensor per model leaf (per-leaf state).
    flatten_optimizer: bool = True
    #: Evaluate the post-recurrence chains of a custom recurrent model
    #: declaring a ``FusedRecurrentApplySpec`` through the chain kernels
    #: (``ops/fused_mlp.py``) wherever its forward runs; off for models
    #: without one (the default model). On a CUDA device, chains wider
    #: than the card kernels take raise ``NotImplementedError`` at build.
    fused_forward: bool = False
    #: Compute each minibatch's losses and parameter gradients with one
    #: launch of the recurrent update kernel (``ops/fused_rnn_ppo.py``:
    #: LSTM BPTT, heads and PPO losses); else by autograd through the
    #: model. Off for models the kernels do not take (a compute dtype,
    #: more than 8 layers).
    fused_update: bool = True
    #: Sample rollout actions, log-probs, values and states with one launch
    #: of the recurrent act kernel per step (``ops/fused_rnn_act.py``);
    #: else the model's forward and its distribution's sampler, whose
    #: draws differ from the kernel's at equal seeds. Off under the same
    #: conditions as ``fused_update``.
    fused_act: bool = True
    seed: int = 0
    #: See :class:`rl8_tpu_torch.algorithms.AlgorithmConfig.mesh`.
    mesh: Any = None
    #: See :class:`rl8_tpu_torch.algorithms.AlgorithmConfig.exact_sharding`.
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
    """Recurrent PPO on one device or, with a mesh, on each process of its
    group.

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
        params_seed = self._init_common(config)
        num_envs = min(config.num_envs, getattr(env_cls, "max_num_envs", config.num_envs))
        horizon = min(config.horizon, getattr(env_cls, "max_horizon", 1_000_000))
        self.env = env_cls(num_envs, horizon, device=self.device)
        assert_nd_spec(self.env.observation_spec)
        assert_nd_spec(self.env.action_spec)

        model_config = dict(config.model_config or {})
        if config.model is None and config.model_cls is None and config.enable_amp:
            model_config.setdefault("dtype", torch.bfloat16)
        self.policy = RecurrentPolicy(
            self.env.observation_spec,
            self.env.action_spec,
            model=config.model,
            model_cls=config.model_cls,
            model_config=model_config,
            distribution_cls=config.distribution_cls,
        )
        model = self.policy.model
        #: Whether the action distribution squashes through tanh.
        self._squashed_dist = self.policy.distribution_cls is SquashedNormal
        dist_cls, zero_entropy = self.policy.distribution_cls, self._static_zero_entropy
        kernels_take = supports_fused_rnn_update(model, dist_cls, zero_entropy=zero_entropy)
        #: Whether the update launches the recurrent update kernel (else
        #: autograd), and the rollout the recurrent act kernel (else the
        #: module rollout): ``rl8_tpu``'s gates.
        self._fused_update = config.fused_update and kernels_take and not self._exact
        self._fused_act = config.fused_act and kernels_take and not self._exact
        #: The chain kernels for the chains of a custom recurrent model
        #: declaring a ``FusedRecurrentApplySpec`` (``rl8_tpu``'s gate; never
        #: the default model).
        self._fused_forward = (
            config.fused_forward and supports_fused_recurrent_apply(model) and model_fits_vmem(model) and not self._exact
        )
        self.hparams = RecurrentAlgorithmHparams(
            **self._hparams_fields(config, num_envs, horizon, rows=num_envs * (horizon // max(config.seq_len, 1))),
            seq_len=config.seq_len,
            seqs_per_state_reset=config.seqs_per_state_reset,
        ).validate()
        self._init_sharding(env_cls, num_envs, horizon)
        self.policy.init_params(torch.Generator().manual_seed(params_seed))
        model.to(self.device)
        if self._fused_forward:
            self._check_card_takes_chains(model)
        self._check_card_takes_kernels(model)
        #: The autodiff route's parameters, in the order of its flat vector.
        self._params = list(model.parameters())
        if not self._fused_act:
            #: Generator of the module rollout's action samples.
            self._sample_gen = self._device_generator(int(torch.randint(0, 2**62, (1,), generator=self._key_gen)))
        self.state = RecurrentAlgorithmState(
            env_state=None,
            buffer=self._zero_buffer(),
            reward_scale=torch.tensor(1.0, device=self.device),
        )
        self.state.opt_state = self._init_opt_state()

    def _check_card_takes_kernels(self, model: Any) -> None:
        """On a CUDA device, raise ``NotImplementedError`` at build where a
        kernel route the gates chose does not take the model's shapes, so
        that no collect or step fails on them: the update kernel when
        ``_fused_update`` is on, the act kernel when ``_fused_act`` is on."""
        if self.device.type != "cuda" or not (self._fused_update or self._fused_act):
            return
        packed = self._pack_params()
        checks = ((self._fused_update, card_takes_rnn_update, "update"), (self._fused_act, card_takes_rnn_act, "act"))
        for on, takes, what in checks:
            if on and not takes(packed):
                raise NotImplementedError(
                    f"The card's recurrent {what} kernel does not take {type(model).__name__} with hidden_size"
                    f" {model.hidden_size}, {model.num_layers} layers, {packed.d_in} inputs and heads"
                    f" {packed.head_widths} (the CPU takes any shape)."
                )

    def _pack_params(self):
        """The model's current parameters packed for the kernels, with the
        policy's distribution kind."""
        return pack_rnn_params(self.policy.model, squashed=self._squashed_dist)

    def _load_packed(self, flat: torch.Tensor) -> None:
        load_rnn_params(self.policy.model, flat)

    def _packed_shapes(self) -> list[tuple[int, ...]]:
        params = self._pack_params()
        return [tuple(t.shape) for tensors in (*params.lstm(), *params.heads()) for t in tensors]

    def _apply_model(self, batch: Any, states: Any) -> tuple[tuple[dict[str, torch.Tensor], torch.Tensor], Any]:
        """Model forward: the chain kernels for the chains of a custom
        model declaring a ``FusedRecurrentApplySpec`` with
        ``fused_forward``, the module otherwise."""
        if self._fused_forward:
            return fused_recurrent_custom_apply(self.policy.model, batch, states)
        return self.policy.model(batch, states)

    def _module_act(self, obs: Any, states: Any, deterministic: bool) -> tuple[Any, ...]:
        """The module rollout's step (``rl8_tpu``'s non-fused scan step):
        the model's forward on ``obs`` from ``states``, then a draw from
        its distribution. Returns ``(actions, logp, values, new_states)``."""
        (features, values), new_states = self._apply_model({DataKeys.OBS: tree_map(lambda o: o[:, None], obs)}, states)
        dist = self.policy.distribution_cls(features, self.policy.model)
        actions = self._sample(dist, deterministic)
        return actions, dist.logp(actions), values, new_states

    def _zero_buffer(self) -> dict[str, Any]:
        """Time-major rollout buffer of zeros over this process's envs, with
        per-step recurrent states ``[T + 1, B, K, H]``."""
        B, T, dev = self._impl_B, self.hparams.horizon, self.device
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
        B, T, L = self._impl_B, h.horizon, h.seq_len
        state = self.state
        buffer = state.buffer

        if h.horizons_per_env_reset < 0:
            reset_now = state.horizons == 0
        else:
            reset_now = state.horizons % h.horizons_per_env_reset == 0
        if reset_now:
            env_state, obs = self._reset_env(state.env_state, env_config)
            rev = torch.zeros((B, 1), device=self.device)
        else:
            env_state, obs = state.env_state, tree_map(lambda x: x[-1], buffer[DataKeys.OBS])
            rev = (
                buffer[DataKeys.REVERSED_DISCOUNTED_RETURNS][-1]
                if h.normalize_rewards
                else torch.zeros((B, 1), device=self.device)
            )
        # Recurrent states always carry across collects; the cadence below
        # re-initializes them.
        states = {key: value[-1] for key, value in buffer[DataKeys.STATES].items()}

        if self._fused_act:
            params = self._pack_params()
            keys = self._act_keys()
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
            if self._fused_act:
                actions, logp, values, new_states = fused_rnn_act(
                    params, obs, states, tuple(keys[t]), deterministic=deterministic
                )
            else:
                actions, logp, values, new_states = self._module_act(obs, states, deterministic)
            env_state, obs, rewards = self._impl_env.step(env_state, actions)
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

        # Bootstrap value at the final observation from the final states.
        (_, v_last), _ = self._apply_model({DataKeys.OBS: tree_map(lambda o: o[:, None], obs)}, states)
        cols[DataKeys.VALUES].append(v_last)
        cols[DataKeys.STATES].append(states)

        new_buffer: dict[str, Any] = {key: _stack(values) for key, values in cols.items() if key != DataKeys.STATES}
        new_buffer[DataKeys.STATES] = {
            key: torch.stack([s[key] for s in cols[DataKeys.STATES]]) for key in states
        }
        for key in (DataKeys.REWARDS, DataKeys.LOGP, DataKeys.VALUES):
            new_buffer[key] = new_buffer[key].to(torch.float32)
        if h.normalize_rewards:
            reward_scale = gstd(new_buffer[DataKeys.REVERSED_DISCOUNTED_RETURNS][1:], self._group)
        else:
            del new_buffer[DataKeys.REVERSED_DISCOUNTED_RETURNS]
            reward_scale = torch.tensor(1.0, device=self.device)

        stats = self._rollout_stats(new_buffer[DataKeys.REWARDS])
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
                DataKeys.OBS: _seq_major(tree_map(lambda x: x[:T], buffer[DataKeys.OBS]), L),
                DataKeys.STATES: {
                    key: _seq_major(value[:T], L)[:, 0] for key, value in buffer[DataKeys.STATES].items()
                },
                DataKeys.ACTIONS: _seq_major(buffer[DataKeys.ACTIONS], L),
                DataKeys.LOGP: _seq_major(buffer[DataKeys.LOGP], L),
                DataKeys.ADVANTAGES: _seq_major(advantages, L),
                DataKeys.RETURNS: _seq_major(returns, L),
            }
        )
        if self._fused_update:
            cfg = self._loss_config(packed.shape[0] // h.num_minibatches)
            ec = torch.full((), entropy_coeff, dtype=torch.float32, device=self.device)
            params = self._pack_params()

            def grads_fn(flat: torch.Tensor, mb: torch.Tensor):
                return fused_rnn_ppo_grads(dataclasses.replace(params, flat=flat), mb, unpack, ec, cfg)

            flat0 = params.flat
        else:

            def forward(batch: Any) -> tuple[Any, torch.Tensor, dict[str, torch.Tensor]]:
                # [mb, L] sequences from their stored initial states; the
                # targets flattened to the model's [mb * L] rows.
                (features, values), _ = self._apply_model({DataKeys.OBS: batch[DataKeys.OBS]}, batch[DataKeys.STATES])
                targets = {
                    key: batch[key].reshape(-1, *batch[key].shape[2:])
                    for key in (DataKeys.ACTIONS, DataKeys.LOGP, DataKeys.ADVANTAGES, DataKeys.RETURNS)
                }
                return features, values, targets

            grads_fn = self._autodiff_grads_fn(
                forward, unpack, entropy_coeff, h.num_minibatches if h.accumulate_grads else 1
            )
            flat0 = self._flat_params()
        flat, opt_state, stats = self._sgd_epochs(packed, grads_fn, flat0, lr)
        self._load_flat(flat)
        # Reset the buffer, keeping the final observation and the final
        # states.
        new_buffer: dict[str, Any] = {
            key: tree_map(torch.zeros_like, value) for key, value in buffer.items() if key != DataKeys.STATES
        }
        _keep_last(new_buffer[DataKeys.OBS], buffer[DataKeys.OBS])
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
            {DataKeys.OBS: tree_map(lambda o: o[:, None], obs)},
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

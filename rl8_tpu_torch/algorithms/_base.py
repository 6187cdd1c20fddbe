"""Base algorithm definitions (counterpart of ``rl8_tpu/algorithms/_base.py``).

Beside the type parameters, the base holds what the feedforward and the
recurrent algorithm share: the set-up of the device, the optimizer, the
schedulers and the random streams; the public ``collect``, ``step`` and
``train_steps`` around each algorithm's ``_collect_impl`` and
``_step_impl`` (one host fetch each); the advantage stage; the flat
parameter vector the optimizer updates (the kernels' layout where the
update kernel runs, ``model.parameters()``'s on the autodiff route); the
autodiff route's gradients; and the SGD epochs of an update, whose KL
early stop, gradient accumulation and stat sums stay on the device.

With a ``mesh`` (``rl8_tpu_torch.parallel.create_mesh``) every process
of the group runs the algorithm on its own ``num_envs / world`` envs.
Two modes, as in ``rl8_tpu``:

- ``shard_map`` (the default): each process runs the kernels on its
  shard, with its own env-reset, sampling and shuffle streams (the
  rank folded into each seed; rank 0 keeps the unsharded streams); the
  batch statistics reduce over the group, and each minibatch's
  gradient, losses and KL are averaged by one all-reduce before the KL
  stop and the update, so every process applies the same update.
- exact (``exact_sharding=True``): the single-device run, computed by
  the group. The kernels are off, as ``rl8_tpu``'s gates take them off
  in this mode. Every process draws the global env-reset and sampling
  noise and keeps its own rows; where a minibatch mixes processes'
  rows, the packed batch is all-gathered once a step and each process
  takes its equal part of every global minibatch.
"""

from __future__ import annotations

import dataclasses
import math
from abc import ABC, abstractmethod
from typing import Any, Callable, Generic, TypeVar

import torch

from ..data import AlgorithmHparams, CollectStats, DataKeys, StepStats
from ..env import Env
from ..nn import ppo_losses
from ..ops import PPOLossConfig, block_shuffle, fused_gae
from ..ops.fused_mlp import card_takes_chains, chain_names, named_chains
from ..ops.gae import gae_plain
from ..parallel import ENV_AXIS, _gather_rows, _rank_seed, gmax, gmean, gmin, gstd, pmean_tree, shard_batch
from ..views import tree_map
from ..schedulers import EntropyScheduler, LRScheduler
from ..utils import memory_stats, profile_ms
from ..utils.optim import Adam, AdamState, OptimizerState, TorchOptimizer, adam_step

__all__ = ["GenericAlgorithmBase"]

_Hparams = TypeVar("_Hparams", bound=AlgorithmHparams)
_State = TypeVar("_State")
_Policy = TypeVar("_Policy")

#: ``(losses, kl, grads)`` of one packed minibatch from the flat parameters.
GradsFn = Callable[[torch.Tensor, torch.Tensor], tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]]


class GenericAlgorithmBase(ABC, Generic[_Hparams, _State, _Policy]):
    """Generic algorithm ABC tying hparam/state/policy type params."""

    #: Environment being simulated (one object = ``num_envs`` instances).
    env: Env

    #: Frozen, validated hyperparameters.
    hparams: _Hparams

    #: Policy (model + action distribution); the model holds the parameters.
    policy: _Policy

    #: Dynamic train state.
    state: _State

    #: Device of the model, the env and the buffer.
    device: torch.device

    @property
    def horizons_per_env_reset(self) -> int:
        """Convenience passthrough used by trainers."""
        return self.hparams.horizons_per_env_reset

    @property
    def params(self) -> dict[str, Any]:
        """Flat dict of algorithm parameters for experiment tracking: the
        env, model, distribution and optimizer classes (``adam_step`` for
        the default Adam), and the hyperparameters."""
        out: dict[str, Any] = {
            "env_cls": self.env.__class__.__name__,
            "model_cls": self.policy.model.__class__.__name__,  # type: ignore[attr-defined]
            "distribution_cls": self.policy.distribution_cls.__name__,  # type: ignore[attr-defined]
            "optimizer_cls": getattr(self._optimizer_cls, "__name__", None) or "adam_step",
        }
        out.update(dataclasses.asdict(self.hparams))
        return {k: (v if v is not None else "None") for k, v in out.items()}

    def memory_stats(self) -> dict[str, Any]:
        """Return memory stats of the algorithm's device."""
        return memory_stats(self.device)

    # ------------------------------------------------------------------
    # set-up
    # ------------------------------------------------------------------

    def _check_card_takes_chains(self, model: Any) -> None:
        """On a CUDA device, raise ``NotImplementedError`` where the card's
        chain kernels do not take ``model``'s chains (``fused_forward``)."""
        if self.device.type == "cuda" and not card_takes_chains(named_chains(model, chain_names(model))):
            raise NotImplementedError(
                f"The card's chain kernels do not take {type(model).__name__}'s chains: their weight"
                " copies and partials leave no room for one row block in the staged backward's workspace"
                " budget (the CPU takes any size)."
            )

    def _init_common(self, config: Any) -> int:
        """Set up the mesh, the device, the optimizer's hyperparameters, the
        schedulers and the random streams from ``config``. Returns the seed
        of the parameters' generator.

        One host generator seeds the others and then draws the act
        kernels' per-step Philox keys; it advances alike on every process
        of a mesh. Env resets and minibatch shuffles draw on the device,
        from seeds with the rank folded in (``shard_map`` mode)."""
        #: The device mesh (``None``: one device), its group (what the
        #: collectives run over), its size and this process's rank.
        self.mesh = config.mesh
        self._group: Any = None
        self._world, self._rank = 1, 0
        #: Whether the group computes the single-device run
        #: (``exact_sharding`` with a mesh).
        self._exact = False
        if self.mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(self.mesh, DeviceMesh):
                raise TypeError(
                    "`mesh` must be a DeviceMesh from rl8_tpu_torch.parallel.create_mesh(), not"
                    f" {type(self.mesh).__name__}."
                )
            self._group = self.mesh.get_group(ENV_AXIS)
            self._world, self._rank = self.mesh.size(), self.mesh.get_local_rank(ENV_AXIS)
            self._exact = bool(config.exact_sharding)
        #: Mesh axis of the ``shard_map`` mode (``rl8_tpu``'s ``_axis``):
        #: ``None`` without a mesh and in exact mode.
        self._axis: None | str = ENV_AXIS if self.mesh is not None and not self._exact else None
        #: The rank folded into the device streams and the act kernels'
        #: keys: this process's in ``shard_map`` mode, else 0 (the global
        #: streams).
        self._stream_rank = self._rank if self._axis else 0
        #: Whether the advantage stage launches the GAE kernel; exact mode
        #: takes it off, as ``rl8_tpu``'s gate does.
        self._gae_kernel = not self._exact
        self.device = torch.device(config.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"{type(config).__name__}.device is 'cuda' but CUDA is not available;"
                    " pass device='cpu' to run the kernels' plain versions."
                )
            # Full-f32 products in the model forward (the bootstrap value),
            # so they agree with the act kernels' f32 FMAs; bf16 products
            # (AMP) sum their split-K partials in f32, as XLA does.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        optimizer_config = dict(config.optimizer_config or {"lr": 1e-3})
        if "lr" in optimizer_config and "learning_rate" in optimizer_config:
            raise ValueError(
                "Pass only one of `lr`/`learning_rate` in"
                " `optimizer_config`; both were provided."
            )
        lr0 = optimizer_config.pop("lr", None)
        if lr0 is None:
            lr0 = optimizer_config.pop("learning_rate", 1e-3)
        #: ``None`` for the hand-written Adam (:func:`adam_step`), else the
        #: ``torch.optim`` class and its keywords other than ``lr``.
        self._optimizer_cls = config.optimizer_cls
        self._optimizer_kwargs = optimizer_config
        self._flatten_optimizer = config.flatten_optimizer
        if self._optimizer_cls is None:
            unknown = set(optimizer_config) - {f.name for f in dataclasses.fields(Adam)}
            if unknown:
                raise NotImplementedError(
                    f"The default Adam takes b1, b2, eps and eps_root; for {sorted(unknown)} pass a"
                    " torch.optim class as `optimizer_cls` (e.g. torch.optim.SGD)."
                )
            self.adam = Adam(**optimizer_config)
        elif not callable(self._optimizer_cls):
            raise TypeError(f"optimizer_cls must be a torch.optim.Optimizer class, not {self._optimizer_cls!r}.")
        #: The ``torch.optim`` optimizer (set by :meth:`_init_opt_state`).
        self._torch_optimizer: None | TorchOptimizer = None
        self.lr_scheduler = LRScheduler(lr0, schedule=config.lr_schedule, kind=config.lr_schedule_kind)
        self.entropy_scheduler = EntropyScheduler(
            config.entropy_coeff,
            schedule=config.entropy_coeff_schedule,
            kind=config.entropy_coeff_schedule_kind,
        )
        #: Whether the entropy bonus is statically absent (the kernels then
        #: skip the entropy term entirely, and SquashedNormal, which has no
        #: entropy, can train).
        self._static_zero_entropy = config.entropy_coeff_schedule is None and config.entropy_coeff == 0.0
        self._key_gen = torch.Generator().manual_seed(config.seed)
        params_seed, env_seed, shuffle_seed = torch.randint(0, 2**62, (3,), generator=self._key_gen).tolist()
        self._env_gen = self._device_generator(env_seed)
        self._shuffle_gen = self._device_generator(shuffle_seed)
        return params_seed

    def _device_generator(self, seed: int) -> torch.Generator:
        """A generator on the device, seeded for this process's stream."""
        return torch.Generator(device=self.device).manual_seed(_rank_seed(seed, self._stream_rank))

    def _init_sharding(self, env_cls: Any, num_envs: int, horizon: int) -> None:
        """Check that the mesh divides the env batch and the minibatch, and
        build the env this process steps (``rl8_tpu``'s ``_impl_env``, of
        ``_impl_B = num_envs / world`` envs); ``self.env`` stays the global
        one."""
        #: The env this process steps and its batch size.
        self._impl_env, self._impl_B = self.env, num_envs
        if self._world == 1:
            return
        if num_envs % self._world:
            raise ValueError(f"`num_envs` ({num_envs}) must divide evenly over the mesh's {self._world} devices.")
        mb = self.hparams.sgd_minibatch_size
        if mb % self._world:
            raise ValueError(f"`sgd_minibatch_size` ({mb}) must divide evenly over the mesh's {self._world} devices.")
        self._impl_B = num_envs // self._world
        self._impl_env = env_cls(self._impl_B, horizon, device=self.device)

    def _reset_env(self, env_state: Any, env_config: None | dict[str, Any]) -> tuple[Any, Any]:
        """Reset this process's envs. In exact mode the global env resets
        from the global stream and this process keeps its rows (the
        previous state it hands the reset is its own rows)."""
        if self._exact and self._world > 1:
            env_state, obs = self.env.reset(self._env_gen, state=env_state, config=env_config)
            n = self.hparams.num_envs
            return shard_batch(env_state, self.mesh, n), shard_batch(obs, self.mesh, n)
        return self._impl_env.reset(self._env_gen, state=env_state, config=env_config)

    def _act_keys(self) -> list[tuple[int, int]]:
        """The act kernels' per-step Philox keys of one rollout, from the
        host key stream, with the stream rank folded in."""
        keys = torch.randint(0, 2**32, (self.hparams.horizon, 2), generator=self._key_gen).tolist()
        return [(k0, _rank_seed(k1, self._stream_rank, 32)) for k0, k1 in keys]

    def _sample(self, dist: Any, deterministic: bool) -> Any:
        """The module rollout's actions from ``dist``. In exact mode the
        draw is the global run's: the distribution over the global batch
        (this process's features in its rows, zeros elsewhere) samples the
        global stream, and this process keeps its rows."""
        if deterministic:
            return dist.deterministic_sample()
        if not (self._exact and self._world > 1):
            return dist.sample(self._sample_gen)
        B, r, W = self._impl_B, self._rank, self._world
        padded = tree_map(
            lambda f: torch.cat([f.new_zeros((r * B, *f.shape[1:])), f, f.new_zeros(((W - r - 1) * B, *f.shape[1:]))]),
            dist.features,
        )
        return tree_map(lambda a: a[r * B : (r + 1) * B], type(dist)(padded, dist.model).sample(self._sample_gen))

    def _rollout_stats(self, rewards: torch.Tensor) -> dict[str, torch.Tensor]:
        """The return and reward statistics of a rollout's ``[T, B, 1]``
        rewards, over every process's envs on a mesh."""
        g = self._group
        returns = rewards.sum(dim=0)
        return {
            "returns/min": gmin(returns, g),
            "returns/max": gmax(returns, g),
            "returns/mean": gmean(returns, g),
            "returns/std": gstd(returns, g),
            "rewards/min": gmin(rewards, g),
            "rewards/max": gmax(rewards, g),
            "rewards/mean": gmean(rewards, g),
            "rewards/std": gstd(rewards, g),
        }

    @staticmethod
    def _hparams_fields(config: Any, num_envs: int, horizon: int, rows: int) -> dict[str, Any]:
        """The hyperparameters every algorithm takes from ``config``; a
        ``None`` minibatch size is the whole buffer of ``rows`` rows."""
        return dict(
            accumulate_grads=config.accumulate_grads,
            clip_param=config.clip_param,
            dual_clip_param=config.dual_clip_param,
            enable_amp=config.enable_amp,
            gae_lambda=config.gae_lambda,
            gamma=config.gamma,
            horizon=horizon,
            horizons_per_env_reset=config.horizons_per_env_reset,
            max_grad_norm=config.max_grad_norm,
            normalize_advantages=config.normalize_advantages,
            normalize_rewards=config.normalize_rewards,
            num_envs=num_envs,
            num_sgd_iters=config.num_sgd_iters,
            sgd_minibatch_size=config.sgd_minibatch_size if config.sgd_minibatch_size is not None else rows,
            shuffle_minibatches=config.shuffle_minibatches,
            shuffle_block_rows=config.shuffle_block_rows,
            target_kl_div=config.target_kl_div,
            vf_clip_param=config.vf_clip_param,
            vf_coeff=config.vf_coeff,
        )

    # ------------------------------------------------------------------
    # collect, step, train_steps
    # ------------------------------------------------------------------

    @abstractmethod
    def _collect_impl(
        self, env_config: None | dict[str, Any], deterministic: bool
    ) -> tuple[dict[str, torch.Tensor], bool]:
        """One rollout into a fresh buffer; returns the device-side stats
        and whether the env was reset."""

    @abstractmethod
    def _step_impl(self, lr: float, entropy_coeff: float) -> torch.Tensor:
        """One PPO update from the buffer; returns the step's
        window-averaged stats on the device, in the order entropy, policy,
        vf, total, kl."""

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

    def step(self) -> StepStats:
        """Update the policy using the collected buffer: the advantage
        stage, then ``num_sgd_iters`` epochs of minibatch PPO updates.

        Returns:
            Loss/coefficient/KL stats for the step.

        """
        if not self.state.buffered:  # type: ignore[attr-defined]
            raise RuntimeError(
                f"{self.__class__.__name__} has no buffered rollout to train"
                " on — every `step` must be preceded by a `collect`."
            )
        with profile_ms() as step_timer:
            entropy_coeff = 0.0 if self._static_zero_entropy else self.entropy_scheduler.coeff
            stats = self._step_impl(self.lr_scheduler.coeff, entropy_coeff)
            # The one host fetch of the update; it waits for the device.
            ent, pol, vf, total, kl = stats.tolist()
            count = self.hparams.num_envs * self.state.horizons  # type: ignore[attr-defined]
            self.lr_scheduler.step(count)
            self.entropy_scheduler.step(count)
        return {
            "coefficients/entropy": float(entropy_coeff),
            "coefficients/vf": self.hparams.vf_coeff,
            "losses/entropy": ent,
            "losses/policy": pol,
            "losses/vf": vf,
            "losses/total": total,
            "monitors/kl_div": kl,
            "profiling/step_ms": step_timer(),
        }

    def train_steps(
        self,
        num_steps: int,
        /,
        *,
        env_config: None | dict[str, Any] = None,
    ) -> list[dict[str, float]]:
        """Run ``num_steps`` collect+step iterations and return each
        iteration's stats (collect and step stats together, with
        ``profiling/train_ms`` the mean wall time of an iteration), as
        ``rl8_tpu``'s ``train_steps`` does; the scheduler cadence is
        :meth:`step`'s."""
        if num_steps <= 0:
            raise ValueError("`num_steps` must be > 0.")
        records: list[dict[str, float]] = []
        with profile_ms() as timer:
            for _ in range(num_steps):
                record: dict[str, Any] = dict(self.collect(env_config=env_config))
                record.update(self.step())
                records.append(record)
        elapsed_ms = timer()
        for record in records:
            del record["profiling/collect_ms"], record["profiling/step_ms"]
            record["profiling/train_ms"] = elapsed_ms / num_steps
        return records

    # ------------------------------------------------------------------
    # the update's stages
    # ------------------------------------------------------------------

    def _advantages(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The advantage stage that starts a PPO update: unnormalized
        advantages and returns from the GAE kernel, then (optionally)
        advantages standardized with the batch mean and ``ddof=1`` std.
        Returns ``(advantages [T, B, 1], returns [T, B, 1])``."""
        h = self.hparams
        buffer = self.state.buffer  # type: ignore[attr-defined]
        advantages, returns = (fused_gae if self._gae_kernel else gae_plain)(
            buffer[DataKeys.REWARDS],
            buffer[DataKeys.VALUES],
            self.state.reward_scale,  # type: ignore[attr-defined]
            gamma=h.gamma,
            gae_lambda=h.gae_lambda,
        )
        if h.normalize_advantages:
            advantages = (advantages - gmean(advantages, self._group)) / (gstd(advantages, self._group) + 1e-8)
        return advantages, returns

    def _loss_config(self, n_rows: int) -> PPOLossConfig:
        """The update kernels' loss constants for minibatches of ``n_rows``
        rows."""
        h = self.hparams
        return PPOLossConfig(
            clip_param=h.clip_param,
            vf_clip_param=h.vf_clip_param,
            vf_coeff=h.vf_coeff,
            dual_clip_param=h.dual_clip_param,
            n_rows=n_rows,
            accum=h.num_minibatches if h.accumulate_grads else 1,
            use_entropy=not self._static_zero_entropy,
            squashed=self._squashed_dist,  # type: ignore[attr-defined]
        )

    # ------------------------------------------------------------------
    # the parameters the optimizer updates
    # ------------------------------------------------------------------

    @abstractmethod
    def _pack_params(self) -> Any:
        """The model's current parameters packed for the kernels (a copy;
        ``.flat`` is the flat vector)."""

    @abstractmethod
    def _load_packed(self, flat: torch.Tensor) -> None:
        """Write a flat vector in the kernels' layout into the model."""

    @abstractmethod
    def _packed_shapes(self) -> list[tuple[int, ...]]:
        """The leaves of the kernels' flat layout, in its order."""

    def _flat_params(self) -> torch.Tensor:
        """The parameters as the flat vector the optimizer updates (its
        state keeps this order): the kernels' layout where the update
        kernel runs, ``model.parameters()``'s on the autodiff route."""
        if self._fused_update:  # type: ignore[attr-defined]
            return self._pack_params().flat
        return torch.cat([p.detach().reshape(-1) for p in self._params])  # type: ignore[attr-defined]

    def _load_flat(self, flat: torch.Tensor) -> None:
        """Write a flat vector of :meth:`_flat_params`'s layout into the
        model."""
        if self._fused_update:  # type: ignore[attr-defined]
            self._load_packed(flat)
            return
        off = 0
        with torch.no_grad():
            for p in self._params:  # type: ignore[attr-defined]
                p.copy_(flat[off : off + p.numel()].view_as(p))
                off += p.numel()

    def _init_opt_state(self) -> AdamState | OptimizerState:
        """The optimizer's initial state over :meth:`_flat_params`: Adam's
        zeros, or a new ``torch.optim`` optimizer's (empty) state, over one
        flat tensor or, with ``flatten_optimizer=False``, one view per
        leaf. The default Adam is elementwise, so its flat state is the
        per-leaf state laid end to end either way."""
        flat = self._flat_params()
        if self._optimizer_cls is None:
            return AdamState.zeros_like(flat)
        if self._flatten_optimizer:
            shapes = None
        elif self._fused_update:  # type: ignore[attr-defined]
            shapes = self._packed_shapes()
        else:
            shapes = [tuple(p.shape) for p in self._params]  # type: ignore[attr-defined]
        self._torch_optimizer = TorchOptimizer(
            self._optimizer_cls, flat, lr=self.lr_scheduler.coeff, shapes=shapes, **self._optimizer_kwargs
        )
        return self._torch_optimizer.export()

    def _autodiff_grads_fn(
        self, forward: Callable[[Any], tuple[Any, torch.Tensor, dict[str, torch.Tensor]]], unpack: Any,
        entropy_coeff: float, accum: int,
    ) -> GradsFn:
        """The autodiff route's ``grads_fn`` for :meth:`_sgd_epochs`:
        ``forward(batch)`` gives a packed minibatch's ``(features, values,
        targets)`` (``targets`` holding the actions, log-probs, advantages
        and returns row for row); then the PPO losses through the policy's
        distribution, their approximate KL, and the gradient of ``total /
        accum`` over the flat parameters, by autograd (``rl8_tpu``'s
        ``_loss_fn``)."""
        h = self.hparams
        model = self.policy.model  # type: ignore[attr-defined]
        dist_cls = self.policy.distribution_cls  # type: ignore[attr-defined]
        params = self._params  # type: ignore[attr-defined]
        # A literal 0 skips the entropy term (SquashedNormal has none).
        ec: Any = 0.0 if self._static_zero_entropy else torch.tensor(entropy_coeff, device=self.device)

        def grads_fn(flat: torch.Tensor, mb: torch.Tensor) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
            self._load_flat(flat)
            # ``step`` runs without autograd; the loss needs it.
            with torch.enable_grad():
                features, values, targets = forward(unpack(mb))
                dist = dist_cls(features, model)
                losses = ppo_losses(
                    targets, values, dist, clip_param=h.clip_param, dual_clip_param=h.dual_clip_param,
                    entropy_coeff=ec, vf_clip_param=h.vf_clip_param, vf_coeff=h.vf_coeff,
                )
                grads = torch.autograd.grad(losses["total"] / accum, params, allow_unused=True)
            ratio = dist.logp(targets[DataKeys.ACTIONS]).detach().reshape(-1) - targets[DataKeys.LOGP].reshape(-1)
            kl = torch.mean((torch.exp(ratio) - 1) - ratio)
            flat_grads = torch.cat(
                [(g if g is not None else torch.zeros_like(p)).reshape(-1) for g, p in zip(grads, params)]
            )
            return {k: v.detach() for k, v in losses.items()}, kl, flat_grads

        return grads_fn

    def _sgd_epochs(
        self, packed: torch.Tensor, grads_fn: GradsFn, flat: torch.Tensor, lr: float
    ) -> tuple[torch.Tensor, AdamState | OptimizerState, torch.Tensor]:
        """``num_sgd_iters`` epochs over the packed rows ``[N, D]``, each cut
        into ``num_minibatches`` minibatches (block-shuffled per epoch
        unless there is one, or the epoch accumulates into one update),
        each one call of ``grads_fn(flat, minibatch)`` and, per
        accumulation window, one clipped optimizer update of ``flat``
        (:func:`adam_step`, or the ``torch.optim`` optimizer's ``step``).

        The KL early stop, the accumulation and the stat sums stay on the
        device (the update is gated with ``torch.where``, as ``lax.cond``
        gates it in ``rl8_tpu``). Returns the new parameters, the
        optimizer's state and the window-averaged stats (entropy, policy,
        vf, total, kl).

        On a mesh, each minibatch's gradient, losses and KL are averaged
        over the group by one all-reduce, before the KL stop and the
        accumulation. In exact mode, where a step has several minibatches,
        ``packed`` is gathered from every process first and each process
        takes its equal part of every global minibatch."""
        h = self.hparams
        M = h.num_minibatches
        parts = 1
        if self._exact and self._world > 1 and M > 1:
            packed, parts = _gather_rows(packed, self._group), self._world
        mb_rows = packed.shape[0] // M
        part = mb_rows // parts
        lo = self._rank * part if parts > 1 else 0
        accum = M if h.accumulate_grads else 1
        dev = flat.device
        opt_state = self.state.opt_state  # type: ignore[attr-defined]
        opt = self._torch_optimizer
        if opt is not None:
            flat = opt.bind(flat, opt_state)
        # Device-side carry: the gradient and stat sums of the current
        # accumulation window (entropy, policy, vf, total, kl), their
        # totals over windows, the window count, and the KL stop flag.
        grad_acc = torch.zeros_like(flat)
        window = torch.zeros(5, device=dev)
        totals = torch.zeros(5, device=dev)
        n_windows = torch.zeros((), device=dev)
        stopped = torch.zeros((), dtype=torch.bool, device=dev)
        never = torch.zeros((), dtype=torch.bool, device=dev)
        shuffle = h.shuffle_minibatches and M > 1 and accum == 1
        blk = math.gcd(h.effective_shuffle_block, mb_rows)
        for _ in range(h.num_sgd_iters):
            epoch = block_shuffle(packed, self._shuffle_gen, blk) if shuffle else packed
            for i in range(M):
                start = i * mb_rows + lo
                losses, kl, grads = grads_fn(flat, epoch[start : start + part])
                stats = torch.stack([losses["entropy"], losses["policy"], losses["vf"], losses["total"], kl])
                grads, stats = pmean_tree((grads, stats), self._group)
                # Minibatches after a KL early stop change nothing; the
                # one that triggers it still counts in the stats.
                active = ~stopped
                trigger = stats[4] > 1.5 * h.target_kl_div if h.target_kl_div is not None else never
                window = window + stats / accum
                grad_acc = grad_acc + grads
                if (i + 1) % accum == 0:
                    if opt is None:
                        flat, opt_state = adam_step(
                            flat, grad_acc, opt_state, lr=lr, max_grad_norm=h.max_grad_norm,
                            adam=self.adam, apply=active & ~trigger,
                        )
                    else:
                        opt.step(
                            grad_acc, lr=lr, max_grad_norm=h.max_grad_norm,
                            apply=active & ~trigger if h.target_kl_div is not None else None,
                        )
                    totals = torch.where(active, totals + window, totals)
                    n_windows = torch.where(active, n_windows + 1.0, n_windows)
                    grad_acc = torch.zeros_like(grad_acc)
                    window = torch.zeros_like(window)
                stopped = stopped | trigger
        if opt is not None:
            opt_state = opt.export()
        return flat, opt_state, totals / torch.clamp_min(n_windows, 1.0)

    @abstractmethod
    def validate(self) -> None:
        ...

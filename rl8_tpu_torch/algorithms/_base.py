"""Base algorithm definitions (counterpart of ``rl8_tpu/algorithms/_base.py``).

Beside the type parameters, the base holds what the feedforward and the
recurrent algorithm share: the set-up of the device, the optimizer, the
schedulers and the random streams; the public ``collect``, ``step`` and
``train_steps`` around each algorithm's ``_collect_impl`` and
``_step_impl`` (one host fetch each); the advantage stage; and the SGD
epochs of an update, whose KL early stop, gradient accumulation and stat
sums stay on the device.
"""

from __future__ import annotations

import dataclasses
import math
from abc import ABC, abstractmethod
from typing import Any, Callable, Generic, TypeVar

import torch

from ..data import AlgorithmHparams, CollectStats, DataKeys, StepStats
from ..env import Env
from ..ops import PPOLossConfig, block_shuffle, fused_gae
from ..parallel import gmean, gstd
from ..schedulers import EntropyScheduler, LRScheduler
from ..utils import memory_stats, profile_ms
from ..utils.optim import Adam, AdamState, adam_step

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
        """Flat dict of algorithm parameters for experiment tracking."""
        out: dict[str, Any] = {
            "env_cls": self.env.__class__.__name__,
            "model_cls": self.policy.model.__class__.__name__,  # type: ignore[attr-defined]
            "distribution_cls": self.policy.distribution_cls.__name__,  # type: ignore[attr-defined]
        }
        out.update(dataclasses.asdict(self.hparams))
        return {k: (v if v is not None else "None") for k, v in out.items()}

    def memory_stats(self) -> dict[str, Any]:
        """Return memory stats of the algorithm's device."""
        return memory_stats(self.device)

    # ------------------------------------------------------------------
    # set-up
    # ------------------------------------------------------------------

    def _init_common(self, config: Any, unported: tuple[tuple[bool, str], ...] = ()) -> int:
        """Refuse what the port does not run yet, then set up the device,
        Adam, the schedulers and the random streams from ``config``.
        Returns the seed of the parameters' generator.

        One host generator seeds the others and then draws the act
        kernels' per-step Philox keys; env resets and minibatch shuffles
        draw on the device."""
        for flag, what in (
            (config.optimizer_cls is not None, "optimizers other than Adam"),
            (not config.flatten_optimizer, "flatten_optimizer=False"),
            (config.enable_amp, "enable_amp"),
            (config.exact_sharding, "exact_sharding, rl8_tpu's GSPMD mode of a mesh (ROADMAP Queue 1 #8)"),
            *unported,
        ):
            if flag:
                raise NotImplementedError(
                    f"This port does not run {what} yet; it is a later slice (ROADMAP Queue 1)."
                )
        if config.mesh is not None:
            raise NotImplementedError(
                "Multi-device training is a later slice of the port (ROADMAP Queue 1, multi-device)."
            )
        self.device = torch.device(config.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"{type(config).__name__}.device is 'cuda' but CUDA is not available;"
                    " pass device='cpu' to run the kernels' plain versions."
                )
            # Full-f32 products in the model forward (the bootstrap value),
            # so they agree with the act kernels' f32 FMAs.
            torch.backends.cuda.matmul.allow_tf32 = False
        optimizer_config = dict(config.optimizer_config or {"lr": 1e-3})
        if "lr" in optimizer_config and "learning_rate" in optimizer_config:
            raise ValueError(
                "Pass only one of `lr`/`learning_rate` in"
                " `optimizer_config`; both were provided."
            )
        lr0 = optimizer_config.pop("lr", None)
        if lr0 is None:
            lr0 = optimizer_config.pop("learning_rate", 1e-3)
        unknown = set(optimizer_config) - {f.name for f in dataclasses.fields(Adam)}
        if unknown:
            raise NotImplementedError(
                f"This port's Adam takes b1, b2, eps and eps_root; {sorted(unknown)}"
                " come with other optimizers in a later slice (ROADMAP Queue 1)."
            )
        self.adam = Adam(**optimizer_config)
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
        self._env_gen = torch.Generator(device=self.device).manual_seed(env_seed)
        self._shuffle_gen = torch.Generator(device=self.device).manual_seed(shuffle_seed)
        return params_seed

    @staticmethod
    def _hparams_fields(config: Any, num_envs: int, horizon: int, rows: int) -> dict[str, Any]:
        """The hyperparameters every algorithm takes from ``config``; a
        ``None`` minibatch size is the whole buffer of ``rows`` rows."""
        return dict(
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
        advantages, returns = fused_gae(
            buffer[DataKeys.REWARDS],
            buffer[DataKeys.VALUES],
            self.state.reward_scale,  # type: ignore[attr-defined]
            gamma=h.gamma,
            gae_lambda=h.gae_lambda,
        )
        if h.normalize_advantages:
            advantages = (advantages - gmean(advantages)) / (gstd(advantages) + 1e-8)
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

    def _sgd_epochs(
        self, packed: torch.Tensor, grads_fn: GradsFn, flat: torch.Tensor, lr: float
    ) -> tuple[torch.Tensor, AdamState, torch.Tensor]:
        """``num_sgd_iters`` epochs over the packed rows ``[N, D]``, each cut
        into ``num_minibatches`` minibatches (block-shuffled per epoch
        unless there is one, or the epoch accumulates into one update),
        each one call of ``grads_fn(flat, minibatch)`` and, per
        accumulation window, one clipped Adam update of ``flat``.

        The KL early stop, the accumulation and the stat sums stay on the
        device (the update is gated with ``torch.where``, as ``lax.cond``
        gates it in ``rl8_tpu``). Returns the new parameters, Adam's state
        and the window-averaged stats (entropy, policy, vf, total, kl)."""
        h = self.hparams
        M = h.num_minibatches
        mb_rows = packed.shape[0] // M
        accum = M if h.accumulate_grads else 1
        dev = flat.device
        opt_state = self.state.opt_state  # type: ignore[attr-defined]
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
                losses, kl, grads = grads_fn(flat, epoch[i * mb_rows : (i + 1) * mb_rows])
                # Minibatches after a KL early stop change nothing; the
                # one that triggers it still counts in the stats.
                active = ~stopped
                trigger = kl > 1.5 * h.target_kl_div if h.target_kl_div is not None else never
                window = window + torch.stack(
                    [losses["entropy"], losses["policy"], losses["vf"], losses["total"], kl]
                ) / accum
                grad_acc = grad_acc + grads
                if (i + 1) % accum == 0:
                    flat, opt_state = adam_step(
                        flat, grad_acc, opt_state, lr=lr, max_grad_norm=h.max_grad_norm,
                        adam=self.adam, apply=active & ~trigger,
                    )
                    totals = torch.where(active, totals + window, totals)
                    n_windows = torch.where(active, n_windows + 1.0, n_windows)
                    grad_acc = torch.zeros_like(grad_acc)
                    window = torch.zeros_like(window)
                stopped = stopped | trigger
        return flat, opt_state, totals / torch.clamp_min(n_windows, 1.0)

    @abstractmethod
    def validate(self) -> None:
        ...

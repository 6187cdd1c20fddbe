#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rl8_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``) and
``nvidia-smi``, and imports neither JAX nor ``rl8_tpu``. (``python3
chip_smoke.py --time-updates LABEL`` builds the kernels and times only
the update kernels and their split by kernel, for comparing two
checkouts: see ``time_updates``.)
Phases, each printing one JSON line; any failed check raises and exits
non-zero:

1. build: compile the kernels from ``rl8_tpu_torch/csrc`` and time it;
   print the card's name and power limit.
2. kernels: every kernel of the main paths against its plain PyTorch
   version on the card at the main paths' shapes (discrete act at obs
   [8192, 1] with twin 256-wide torsos, and at A=2, n=3 (its wgmma
   route), at a ragged B=1000 with tanh layers (wgmma), at an obs dim of
   300 and at parameters off 16-byte alignment (its tiled f32 route) and
   at 320/288-wide layers (its streaming route), each route asserted and
   two launches bit-identical; GAE at T = 1, 32, 33 and 512 over B = 8192
   and a ragged 1000, two launches bit-identical, timed beside an empty
   launch of its grid; the discrete PPO update at
   262,144 rows, at a ragged 1,000 rows with entropy, dual clip and
   accumulation, and at ragged weight tiles; the continuous act kernel
   at obs [8192, 1] (Normal and squashed, stochastic draw for draw and
   deterministic) and at a ragged B=1000, A=4 with tanh layers (its
   tiled route), and at 320/288-wide layers (its streaming route), each
   route asserted and two launches bit-identical, plus a moment check of
   its noise; the continuous update at 262,144 rows
   (squashed), at a ragged 1,000 rows (Normal, entropy, dual clip,
   accumulation), at ragged weight tiles and at rows that hit the +-100
   clamp; the recurrent act kernel at obs [8192, 1] with one 256-wide
   LSTM layer (all three kinds, draw for draw and deterministic, new
   states included), at a ragged B=1000 with two layers and at H = 720
   (its 16-row tiles); the recurrent update at 65,536 sequences of 4
   steps (categorical and squashed), at a ragged 1,000 sequences with two
   layers (entropy, dual clip, accumulation) and at samples that hit the
   clamp, and its width limit;
   the chain forward and backward kernels at MischievousMule's chains
   (4,096 and 32,768 rows), at ragged three-chain tanh LayerNorm mixes
   (1,000 rows, d_in 1 and 64), at zero-variance rows, at 160/136-wide
   layers (the tiled forward's general path, the streaming backward) and at
   one 768-wide LayerNorm chain (the forward's and the backward's streaming
   routes; the rest take their tiled routes, each route asserted; two
   launches of each bit-identical)); the discrete act kernel also at the
   CartPole and MountainCar examples' shapes (1024 rows, obs dims 5 and 2,
   A=1, n=3) and the continuous one at Pendulum's (1024 rows, obs dim 3);
   each timed beside its plain version.
3. main paths, each with the kernels' launch counters set to 0 just
   before and read just after, and a profiler breakdown:
   ``AlgorithmConfig(device="cuda").build(DiscreteDummyEnv)`` at the
   defaults (8192 envs, horizon 32, twin 256-wide torsos, a whole-buffer
   minibatch, 4 epochs), first the rollout (one warm-up and five timed
   ``collect()`` calls and the advantage stage), then the training loop
   (one warm-up and five timed ``collect()`` + ``step()`` iterations);
   then the same training loop for ``ContinuousDummyEnv`` with
   ``SquashedNormal`` (gamma 0.99, lambda 0.95, no entropy bonus); then
   ``RecurrentAlgorithmConfig(device="cuda").build(DiscreteDummyEnv)`` at
   its defaults (8192 envs, horizon 32, one 256-wide LSTM layer, seq_len
   4, a whole-buffer minibatch of 65,536 sequences, 4 epochs), one
   warm-up and five timed ``collect()`` + ``step()`` iterations, with the
   rollout's log-probs and values held against the module's forward from
   the stored states; then ``AlgorithmConfig(model_cls=MischievousMule,
   fused_forward=True, num_envs=4096, horizon=32, sgd_minibatch_size=32768,
   device="cuda").build(AlgoTrading)``, one warm-up and five timed
   iterations (chain forward 49, backward 16, GAE 1 per iteration), its
   rollout held against the module on its training views, and the same
   with ``fused_forward=False`` (no chain launch); between the squashed and
   the recurrent paths, the routes ``rl8_tpu`` takes off the kernels at the
   discrete cell's width, one collect and one step each: a ``gelu`` torso
   (module rollout and autograd update, no act or update launch) and
   ``fused_act=False`` (module rollout, 4 update launches).
4. learning: the verify recipe's drive (256 envs, horizon 16, seed 1, 30
   iterations) on the card must learn the optimal greedy policy, for the
   discrete env and for the continuous one with ``SquashedNormal``; the
   recurrent drive (64 envs, horizon 16, seq_len 4, hidden 16, seed 1, 15
   iterations) must raise the mean return.
5. small configurations run on the card and on the CPU (the plain
   versions) from the same seed, two collects and one step, compared:
   the discrete one and the continuous one with ``Normal``, feedforward
   and recurrent, and ``MischievousMule`` (deterministic collects).
6. one step of each classic-control example env (CartPole with both
   integrators, Pendulum, MountainCar) on the card and on the CPU from
   the same state, compared.
7. the entry points, each with the launch counters set to 0 just before
   and read just after: the README quick start (``DiscreteDummyEnv``, 8192
   envs, horizon 32) through the ``train`` CLI in this process, 6 steps
   with an eval every 3 (records, launch counts, every tensor on the
   card, the act route, the trainer's host overhead per step against
   ``collect()`` + ``step()``, whether the memory reading waits for the
   device); the three example configs (1024 envs) through the CLI, 4
   steps each (launch counts: the continuous kernels for Pendulum, the
   discrete ones for the others; the env step's share of a collect; no
   host sync in an env step); and ``Trainer`` on CartPole (256 envs,
   horizon 64, seed 0) for 25 steps against the JAX package's learning
   criterion, then one eval.
8. a ``{"kernels": [...]}`` line, the card line, and the ``{"ok": ...}``
   line last.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
#: f32 outside the tensor cores, dense TF32 on the tensor cores, and HBM3
#: bandwidth. The update kernels' products run on the tensor cores in
#: 3xTF32 (three TF32 products per f32 product), so their records carry a
#: second bound, bound_tc_ms, at that rate.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TF32_PRODUCTS = 3
PEAK_BYTES_PER_S = 3.35e12

#: Tolerances, f32 on both sides. The kernel sums each dot product in
#: another order than cuBLAS/ATen and contracts multiply-adds into FMAs,
#: so values and log-probs differ by a few ulps of the largest partial
#: sums (activations reach ~1e2 with observations of magnitude 1e2).
ACT_RTOL, ACT_ATOL = 1e-4, 1e-4
#: Rows whose top-2 scores are closer than this may legitimately flip.
TIE_GAP = 1e-5
GAE_RTOL, GAE_ATOL = 1e-5, 1e-4
#: Update kernel vs its plain version: each gradient tensor by a
#: norm-relative error, ||k - p|| <= 1e-4 ||p|| + 1e-6, because both sum
#: f32 products over up to 262,144 rows, in another order (row blocks,
#: split-K groups and a fixed-order final sum against cuBLAS/ATen
#: reductions); the losses (means) to rtol 1e-5 with atol 1e-6 for the
#: near-zero policy mean of zero-mean advantages.
PPO_GRAD_RTOL, PPO_GRAD_ATOL = 1e-4, 1e-6
PPO_STAT_RTOL, PPO_STAT_ATOL = 1e-5, 1e-6
#: Chain kernels vs their plain versions: head outputs and dx, f32 with
#: other summation orders (and LayerNorm's E[z^2] - E[z]^2 cancelling in
#: both); parameter gradients by PPO_GRAD_*'s norm-relative error.
CHAIN_RTOL, CHAIN_ATOL = 1e-4, 1e-4
#: Frequency test: draws per row, and the allowed deviation in standard
#: deviations of a sum of independent Bernoulli counts.
FREQ_DRAWS, FREQ_SIGMAS = 64, 5.0
#: Squashed log-probs against the plain version's own: a = tanh(x) rounds
#: to f32 near 1, and the atanh that inverts it magnifies that rounding by
#: 1 / (1 - a^2), so rows are compared directly only where every
#: pre-squash |x| is below this (1 - a^2 > 0.07: a few ulps stay below the
#: act tolerances). Every row is also held against the plain log-prob of
#: the kernel's own actions, which does not go through that rounding.
SQUASH_LIMIT = 2.0


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "rl8_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout holding rl8_tpu_torch/", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]

    # ---------------------------------------------------------------- build
    from rl8_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    ptxas = (lib_path.parent / "ptxas.log").read_text().splitlines()
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "library": lib_path.name,
        "card": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "ptxas": [ln.strip() for ln in ptxas if "registers" in ln or "spill" in ln],
    })
    if sys.argv[1:2] == ["--time-updates"]:
        time_updates(torch, dev, sys.argv[2] if len(sys.argv) > 2 else "", card)
        return 0

    kernels = {
        "act": {
            "name": "discrete_act",
            "route": "cuda",
            "source": "rl8_tpu_torch/csrc/act.cu",
            "replaces": "rl8_tpu/ops/fused_act.py:44 _discrete_act_kernel",
            "library_ms": None,
        },
        "gae": {
            "name": "gae",
            "route": "cuda",
            "source": "rl8_tpu_torch/csrc/gae.cu",
            "replaces": "rl8_tpu/ops/gae.py:46 _gae_kernel",
            "library_ms": None,
        },
        "ppo": {
            "name": "ppo_update",
            "route": "cuda",
            "source": "rl8_tpu_torch/csrc/ppo.cu",
            "replaces": "rl8_tpu/ops/fused_ppo.py:144 _discrete_kernel",
            "library_ms": None,
        },
        "continuous_act": {
            "name": "continuous_act",
            "route": "cuda",
            "source": "rl8_tpu_torch/csrc/act.cu",
            "replaces": "rl8_tpu/ops/fused_act.py:61 _continuous_act_kernel",
            "library_ms": None,
        },
        "continuous_ppo": {
            "name": "continuous_ppo_update",
            "route": "cuda",
            "source": "rl8_tpu_torch/csrc/ppo.cu",
            "replaces": "rl8_tpu/ops/fused_ppo.py:252 _continuous_kernel",
            "library_ms": None,
        },
        "rnn_act": {
            "name": "rnn_act",
            "route": "cuda",
            "source": "rl8_tpu_torch/csrc/rnn_act.cu",
            "replaces": "rl8_tpu/ops/fused_rnn_act.py:32 _kernel",
            "library_ms": None,
        },
        "rnn_ppo": {
            "name": "rnn_ppo_update",
            "route": "cuda",
            "source": "rl8_tpu_torch/csrc/rnn_ppo.cu",
            "replaces": "rl8_tpu/ops/fused_rnn_ppo.py:194 _kernel",
            "library_ms": None,
        },
        "chains_fwd": {
            "name": "chains_fwd",
            "route": "cuda",
            "source": "rl8_tpu_torch/csrc/chains.cu",
            "replaces": "rl8_tpu/ops/fused_mlp.py:306 _fwd_kernel",
            "library_ms": None,
        },
        "chains_bwd": {
            "name": "chains_bwd",
            "route": "cuda",
            "source": "rl8_tpu_torch/csrc/chains.cu",
            "replaces": "rl8_tpu/ops/fused_mlp.py:410 _bwd_kernel",
            "library_ms": None,
        },
    }
    check_act(torch, dev, kernels["act"])
    check_gae(torch, dev, kernels["gae"])
    check_ppo(torch, dev, kernels["ppo"])
    check_continuous_act(torch, dev, kernels["continuous_act"])
    check_continuous_ppo(torch, dev, kernels["continuous_ppo"])
    check_rnn_act(torch, dev, kernels["rnn_act"])
    check_rnn_ppo(torch, dev, kernels["rnn_ppo"])
    check_chains(torch, dev, kernels["chains_fwd"], kernels["chains_bwd"])
    run_main_path(torch, dev)
    run_update_path(torch, dev, kernels)
    run_update_path(torch, dev, kernels, continuous=True)
    run_repaired_routes(torch, dev)
    run_recurrent_path(torch, dev, kernels)
    run_custom_path(torch, dev, kernels)
    check_learning(torch, dev)
    check_learning_continuous(torch, dev)
    check_learning_recurrent(torch, dev)
    for recurrent in (False, True):
        check_small_against_cpu(torch, dev, recurrent=recurrent)
        check_small_against_cpu(torch, dev, continuous=True, recurrent=recurrent)
    check_small_custom_against_cpu(torch, dev)
    check_envs_against_cpu(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        run_cli_main_path(torch, dev, Path(tmp))
        run_examples_path(torch, dev, Path(tmp))
    check_learning_cartpole(torch, dev)

    emit({"kernels": list(kernels.values())})
    print(card, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> tuple[float, float]:
    """``(device ms, host ms)`` per call of ``fn`` over ``iters`` calls.

    The host first times how long it takes to issue the calls, then
    queues them again behind a device-side sleep longer than that, so
    the CUDA events bracket device work only and not the host's issue
    rate (which bounds back-to-back launches of small kernels)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))  # cycles; the SM clock is <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, 1e3 * host_s / iters


#: The act kernels' routes by kind, each by kernel name (for
#: launched_route).
ACT_ROUTES = {
    "discrete": {"discrete_act_wgmma_kernel": "wgmma", "discrete_act_tiles_kernel": "tiled",
                 "discrete_act_kernel": "streaming"},
    "continuous": {"continuous_act_tiles_kernel": "tiled", "continuous_act_kernel": "streaming"},
}


def make_model(torch, action_spec, seed: int, obs_dim: int = 1, **model_config):
    """A default discrete model as the main path initializes it, with the
    logits head re-drawn at lecun scale so that the action probabilities
    are far from uniform and the sampling checks see real distributions."""
    from rl8_tpu_torch.models import DefaultDiscreteModel, lecun_normal_
    from rl8_tpu_torch.specs import Unbounded

    model = DefaultDiscreteModel(Unbounded(obs_dim), action_spec, **model_config)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    with torch.no_grad():
        lecun_normal_(model.feature_head.weight, gen)
    return model.cuda()


def check_act(torch, dev, record: dict) -> None:
    """The discrete act kernel against its plain version on the card, each
    case on the route its shapes pick (asserted from the profiler's kernel
    names), deterministic and draw for draw (the plain version replays the
    kernel's Philox draws), two launches bit-identical: the main path's
    shapes (obs [8192, 1] up to 100 in magnitude, twin 256-wide relu
    torsos, A=1, n=2) and A=2, n=3 there, on the wgmma route, each with a
    frequency test of the draws; on the wgmma route too a ragged B=1000
    with obs dim 3 and 100/72-wide tanh layers; on the tiled f32 route an
    obs dim of 300 (wider than the wgmma route's 256) with 64-wide layers,
    and the main model's parameters 4 bytes off 16-byte alignment; on the
    streaming route 320/288-wide layers. Actions equal except rows whose
    top-2 scores are within TIE_GAP; log-probs and values within ACT_*."""
    from rl8_tpu_torch.distributions import Categorical
    from rl8_tpu_torch.ops import act_plain, fused_act, pack_act_params
    from rl8_tpu_torch.ops.distmath import log_softmax_rows, philox_uniform
    from rl8_tpu_torch.ops.fused_act import ActParams
    from rl8_tpu_torch.ops.fused_mlp import forward_chains
    from rl8_tpu_torch.specs import Discrete

    gen = torch.Generator(device=dev).manual_seed(1)
    configs = {
        "main": dict(B=8192, A=1, n=2, obs_dim=1, obs_scale=100.0, model={}, route="wgmma"),
        "A2n3": dict(B=8192, A=2, n=3, obs_dim=1, obs_scale=100.0, model={}, route="wgmma"),
        "ragged": dict(B=1000, A=2, n=3, obs_dim=3, obs_scale=3.0,
                       model={"hiddens": (100, 72), "activation_fn": "tanh"}, route="wgmma"),
        "wide_obs": dict(B=1000, A=2, n=3, obs_dim=300, obs_scale=3.0, model={"hiddens": (64, 64)}, route="tiled"),
        "misaligned": dict(B=8192, A=1, n=2, obs_dim=1, obs_scale=100.0, model={}, route="tiled"),
        "wide": dict(B=1000, A=2, n=3, obs_dim=2, obs_scale=3.0, model={"hiddens": (320, 288)}, route="streaming"),
        # The classic-control examples' shapes: CartPole and MountainCar.
        "cartpole": dict(B=1024, A=1, n=3, obs_dim=5, obs_scale=4.0, model={}, route="wgmma"),
        "mountain_car": dict(B=1024, A=1, n=3, obs_dim=2, obs_scale=1.2, model={}, route="wgmma"),
    }
    routes = ACT_ROUTES["discrete"]

    def near_tie(scores):
        top2 = scores.topk(2, dim=-1).values
        return ((top2[..., 0] - top2[..., 1]) < TIE_GAP).any(dim=1)

    key = (12345, 678)
    for name, c in configs.items():
        B, A, n = c["B"], c["A"], c["n"]
        obs = c["obs_scale"] * (2.0 * torch.rand((B, c["obs_dim"]), generator=gen, device=dev) - 1.0)
        params = pack_act_params(make_model(torch, Discrete(n, shape=(A,)), seed=A * 10 + n, obs_dim=c["obs_dim"],
                                            **c["model"]))
        if name == "misaligned":
            buf = torch.zeros(params.flat.numel() + 1, device=dev)
            buf[1:] = params.flat
            params = ActParams(**{**params.__dict__, "flat": buf[1:]})
        route = launched_route(torch, f"the discrete act kernel ({name})", lambda: fused_act(params, obs, key),
                               routes, c["route"])
        ((logits,), _), _ = forward_chains(obs, params.chains(), params.activation)
        z = torch.cat([log_softmax_rows(logits[:, a * n : (a + 1) * n]) for a in range(A)], 1)
        zg = z.view(B, A, n)

        # Deterministic: argmax actions, log-probs and values.
        ka, kl, kv = fused_act(params, obs, key, deterministic=True)
        k2 = fused_act(params, obs, key, deterministic=True)
        pa, pl, pv = act_plain(params, obs, key, deterministic=True)
        torch.cuda.synchronize()
        what = f"discrete act {name}"
        check(all(torch.equal(a, b) for a, b in zip((ka, kl, kv), k2)), f"{what} deterministic: two launches bit-identical")
        check(ka.dtype == torch.int32 and tuple(ka.shape) == (B, A), f"{what}: actions [B, A] int32")
        keep = ~near_tie(zg)
        check(bool((ka == pa).all(dim=1)[keep].all()), f"{what}: deterministic actions")
        check(torch.allclose(kl, pl, rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: deterministic logp")
        check(torch.allclose(kv, pv, rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: values")
        det_err = max(float((kl - pl).abs().max()), float((kv - pv).abs().max()))

        # Stochastic: the plain version replays the kernel's Philox draws.
        ka, kl, kv = fused_act(params, obs, key, deterministic=False)
        k2 = fused_act(params, obs, key, deterministic=False)
        pa, pl, _ = act_plain(params, obs, key, deterministic=False)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((ka, kl, kv), k2)), f"{what} stochastic: two launches bit-identical")
        u = philox_uniform(*key, B, A, n, dev).view(B, A, n)
        keep = ~near_tie(zg - torch.log(-torch.log(u)))
        check(bool((ka == pa).all(dim=1)[keep].all()), f"{what}: stochastic actions")
        ref_logp = Categorical({"logits": logits.view(B, A, n)}).logp(ka)
        check(torch.allclose(kl, ref_logp, rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: stochastic logp vs Categorical.logp")
        sto_err = float((kl - ref_logp).abs().max())

        # Frequencies of FREQ_DRAWS draws per row against softmax probs,
        # per category, overall and within ten bins of probability.
        freq_worst = None
        if name in ("main", "A2n3"):
            probs = zg.exp()
            counts = torch.zeros_like(probs)
            cats = torch.arange(n, device=dev)
            for d in range(FREQ_DRAWS):
                a_d, _, _ = fused_act(params, obs, (99, d), deterministic=False)
                counts += (a_d.long()[..., None] == cats).float()
            freq_worst = 0.0
            for a in range(A):
                for cat in range(n):
                    p = probs[:, a, cat].double()
                    hits = counts[:, a, cat].double()
                    bins = torch.clamp((p * 10).long(), max=9)
                    for b in [None, *range(10)]:
                        sel = slice(None) if b is None else bins == b
                        expected = FREQ_DRAWS * p[sel].sum()
                        sigma = math.sqrt(FREQ_DRAWS * float((p[sel] * (1 - p[sel])).sum()))
                        dev_sigmas = abs(float(hits[sel].sum() - expected)) / max(sigma, 1e-12)
                        if sigma > 0:
                            freq_worst = max(freq_worst, dev_sigmas)
                            check(dev_sigmas <= FREQ_SIGMAS,
                                  f"frequency {name} group {a} cat {cat} bin {b}: {dev_sigmas:.2f} sigma")
        emit({
            "phase": "kernel_check", "kernel": "discrete_act", "config": name, "route": route, "A": A, "n": n,
            "B": B, "obs_dim": c["obs_dim"], "hiddens": list(params.hiddens), "activation": params.activation,
            "det_max_abs_err": det_err, "stochastic_logp_max_abs_err": sto_err,
            "frequency_worst_sigmas": freq_worst, "rtol": ACT_RTOL, "atol": ACT_ATOL,
        })
        if name == "main":
            record["max_abs_err"] = max(det_err, sto_err)
            record["kernel"] = f"discrete_act_{route}_kernel"

    # Timing at the main path's shapes: B=8192, twin 256-wide torsos, A=1, n=2.
    B = 8192
    obs = 100.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
    params = pack_act_params(make_model(torch, Discrete(2, shape=(1,)), seed=12))
    H = params.hiddens
    macs_chain = params.d_in * H[0] + sum(H[i] * H[i + 1] for i in range(len(H) - 1))
    flops = 2 * B * (2 * macs_chain + H[-1] * (sum(params.policy_heads) + 1))
    bytes_moved = 4 * (obs.numel() + params.flat.numel() + B * (params.action_dim + 2))
    record["ms"], host_ms = time_ms(torch, lambda: fused_act(params, obs, (1, 2)))
    record["plain_ms"], plain_host_ms = time_ms(
        torch, lambda: act_plain(params, obs, (1, 2), deterministic=False), iters=20
    )
    update_bounds(record, flops, bytes_moved)
    emit({"phase": "kernel_time", "kernel": "discrete_act", "B": B, "flops": flops,
          "bytes": bytes_moved, "host_ms": host_ms, "plain_host_ms": plain_host_ms,
          **{k: record[k] for k in ("ms", "plain_ms", "bound_ms", "bound_tc_ms")}})


def check_gae(torch, dev, record: dict) -> None:
    """The GAE kernel against its plain version at T = 1, 32, 33 (no
    multiple of the kernel's chunk of time steps) and 512 over B = 8192 and
    a ragged 1000 columns, two launches bit-identical; timed at the main
    path's T = 32, B = 8192 beside an empty launch of the same grid
    (``empty_ms``: what a launch costs before it moves a byte)."""
    from rl8_tpu_torch.ops import _build, fused_gae, gae_plain

    gen = torch.Generator(device=dev).manual_seed(2)
    kw = {"gamma": 0.95, "gae_lambda": 0.95}
    for T in (32, 1, 33, 512):
        for B in (8192, 1000):
            rewards = torch.randn((T, B, 1), generator=gen, device=dev)
            values = torch.randn((T + 1, B, 1), generator=gen, device=dev)
            scale = torch.tensor(3.7, device=dev)
            ka, kr = fused_gae(rewards, values, scale, **kw)
            k2 = fused_gae(rewards, values, scale, **kw)
            pa, pr = gae_plain(rewards, values, scale, **kw)
            torch.cuda.synchronize()
            err = max(float((ka - pa).abs().max()), float((kr - pr).abs().max()))
            check(torch.equal(ka, k2[0]) and torch.equal(kr, k2[1]), f"GAE T={T} B={B}: two launches bit-identical")
            check(torch.allclose(ka, pa, rtol=GAE_RTOL, atol=GAE_ATOL), f"GAE advantages T={T} B={B}")
            check(torch.allclose(kr, pr, rtol=GAE_RTOL, atol=GAE_ATOL), f"GAE returns T={T} B={B}")
            emit({"phase": "kernel_check", "kernel": "gae", "T": T, "B": B, "max_abs_err": err,
                  "rtol": GAE_RTOL, "atol": GAE_ATOL})
            if (T, B) != (32, 8192):
                continue
            record["max_abs_err"] = err
            bytes_moved = 4 * ((4 * T + 1) * B + 1)
            flops = 6 * T * B
            record["ms"], host_ms = time_ms(
                torch, lambda: fused_gae(rewards, values, scale, **kw), iters=200
            )
            lib = _build.load()
            record["empty_ms"] = time_ms(
                torch, lambda: lib.rl8_gae_empty(B, 0, torch.cuda.current_stream().cuda_stream), iters=200
            )[0]
            record["plain_ms"], plain_host_ms = time_ms(
                torch, lambda: gae_plain(rewards, values, scale, **kw)
            )
            record["bound_ms"] = 1e3 * max(flops / PEAK_F32_FLOPS, bytes_moved / PEAK_BYTES_PER_S)
            record["bound_by"] = "operations" if flops / PEAK_F32_FLOPS > bytes_moved / PEAK_BYTES_PER_S else "bytes"
            emit({"phase": "kernel_time", "kernel": "gae", "T": T, "B": B, "flops": flops,
                  "bytes": bytes_moved, "host_ms": host_ms, "plain_host_ms": plain_host_ms,
                  **{k: record[k] for k in ("ms", "empty_ms", "plain_ms", "bound_ms")}})


def ppo_inputs(torch, dev, model, N: int, seed: int):
    """A packed training minibatch of N rows for ``model``: observations,
    random actions, old log-probs near the model's own (ratios around 1,
    clipped on both sides), standard-normal advantages, and returns
    around the model's values (both smooth-L1 branches and the clip)."""
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.distributions import Categorical
    from rl8_tpu_torch.ops import pack_act_params, pack_rows
    from rl8_tpu_torch.ops.fused_mlp import forward_chains

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = pack_act_params(model)
    A, n = params.action_dim, params.n
    obs = 20.0 * torch.randn((N, params.d_in), generator=gen, device=dev)
    ((logits,), (values,)), _ = forward_chains(obs, params.chains(), params.activation)
    actions = torch.randint(0, n, (N, A), generator=gen, device=dev, dtype=torch.int32)
    logp = Categorical({"logits": logits.view(N, A, n)}).logp(actions)
    logp = logp + 0.1 * torch.randn((N, 1), generator=gen, device=dev)
    packed, unpack = pack_rows({
        DataKeys.ACTIONS: actions,
        DataKeys.LOGP: logp,
        DataKeys.ADVANTAGES: torch.randn((N, 1), generator=gen, device=dev),
        DataKeys.RETURNS: values + 2.0 * torch.randn((N, 1), generator=gen, device=dev),
        DataKeys.VIEWS: {DataKeys.OBS: obs},
    })
    return params, packed, unpack


def check_ppo(torch, dev, record: dict) -> None:
    """The update kernel against its plain version on the card: (a) the
    main path's shapes, (b) a ragged N with A=2, n=3, entropy, dual clip
    and accumulation, (c) ragged weight tiles (100- and 72-wide tanh
    layers) over three row groups, and the CartPole and MountainCar
    examples' launches (EXAMPLE_UPDATES, the default loss, example_rows
    rows). Two launches must be bit-identical."""
    from rl8_tpu_torch.ops import PPOLossConfig
    from rl8_tpu_torch.specs import Discrete

    configs = {
        "a": dict(N=8192 * 32, spec=Discrete(2, shape=(1,)), model={}, obs_dim=1, ec=0.0,
                  loss=dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)),
        "b": dict(N=1000, spec=Discrete(3, shape=(2,)), model={"hiddens": (64, 32)}, obs_dim=3,
                  ec=0.013, loss=dict(vf_clip_param=1.5, vf_coeff=0.9, dual_clip_param=3.0, accum=3)),
        "c": dict(N=9001, spec=Discrete(2, shape=(3,)),
                  model={"hiddens": (100, 72), "activation_fn": "tanh"}, obs_dim=5, ec=0.02,
                  loss=dict(vf_clip_param=2.0, vf_coeff=0.5, dual_clip_param=None, accum=2)),
    }
    for example in ("cartpole", "mountain_car"):
        e = EXAMPLE_UPDATES[example]
        configs[example] = dict(N=example_rows(example), spec=Discrete(e["n"], shape=(e["A"],)), model={},
                                obs_dim=e["obs_dim"], ec=0.0,
                                loss=dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1))
    for name, c in configs.items():
        seed = sum(map(ord, name))  # ord(name) for the one-letter cases
        model = make_model(torch, c["spec"], seed=40 + seed, obs_dim=c["obs_dim"], **c["model"])
        params, packed, unpack = ppo_inputs(torch, dev, model, c["N"], seed=seed)
        cfg = PPOLossConfig(clip_param=0.2, n_rows=c["N"], use_entropy=c["ec"] != 0.0, **c["loss"])
        ec = torch.tensor(c["ec"], device=dev)
        result = compare_ppo(torch, f"ppo ({name})", params, packed, unpack, ec, cfg)
        emit({"phase": "kernel_check", "kernel": "ppo_update", "config": name, "N": c["N"],
              "hiddens": list(params.hiddens), "A": params.action_dim, "n": params.n,
              "activation": params.activation, "entropy_coeff": c["ec"], **c["loss"],
              **result["summary"]})
        if name == "a":
            time_ppo(torch, "ppo_update", record, result, params, packed, unpack, ec, cfg)


def compare_ppo(torch, what: str, params, packed, unpack, ec, cfg) -> dict:
    """The update kernel twice and its plain version once on one
    minibatch: the launches must be bit-identical, each gradient tensor
    within PPO_GRAD_* of the plain one by norm, the losses and KL within
    PPO_STAT_*."""
    from rl8_tpu_torch.ops import fused_ppo_grads, ppo_grads_plain
    from rl8_tpu_torch.ops.fused_act import ActParams

    k_losses, k_kl, k_grads = fused_ppo_grads(params, packed, unpack, ec, cfg)
    k2_losses, k2_kl, k2_grads = fused_ppo_grads(params, packed, unpack, ec, cfg)
    p_losses, p_kl, p_grads = ppo_grads_plain(params, packed, unpack, ec, cfg)
    torch.cuda.synchronize()
    check(torch.equal(k_grads, k2_grads) and torch.equal(k_kl, k2_kl)
          and all(torch.equal(k_losses[key], k2_losses[key]) for key in k_losses),
          f"{what}: two launches bit-identical")
    worst_grad = 0.0
    for kc, pc in zip(ActParams(**{**params.__dict__, "flat": k_grads}).chains(),
                      ActParams(**{**params.__dict__, "flat": p_grads}).chains()):
        for kt, pt in zip([t for pair in (*kc[0], *kc[1]) for t in pair],
                          [t for pair in (*pc[0], *pc[1]) for t in pair]):
            err, ref = float((kt - pt).norm()), float(pt.norm())
            worst_grad = max(worst_grad, err / max(ref, 1e-30))
            check(err <= PPO_GRAD_RTOL * ref + PPO_GRAD_ATOL,
                  f"{what}: gradient {tuple(pt.shape)} error {err:.3g} vs norm {ref:.3g}")
    stat_err = 0.0
    for key, kv, pv in [(k, k_losses[k], p_losses[k]) for k in p_losses] + [("kl", k_kl, p_kl)]:
        kv, pv = float(kv), float(pv)
        stat_err = max(stat_err, abs(kv - pv))
        check(abs(kv - pv) <= PPO_STAT_RTOL * abs(pv) + PPO_STAT_ATOL, f"{what}: {key} {kv!r} vs plain {pv!r}")
    return {
        "max_abs_err": max(stat_err, float((k_grads - p_grads).abs().max())),
        "summary": {"worst_grad_norm_rel_err": worst_grad, "loss_max_abs_err": stat_err,
                    "bit_identical": True, "losses": {k: float(v) for k, v in k_losses.items()},
                    "kl": float(k_kl)},
    }


def time_ppo(torch, kernel: str, record: dict, result: dict, params, packed, unpack, ec, cfg) -> None:
    """Time the update kernel beside its plain version on one minibatch,
    with its bounds (update_bounds)."""
    from rl8_tpu_torch.ops import fused_ppo_grads, ppo_grads_plain

    record["max_abs_err"] = result["max_abs_err"]
    N, H, d_in = packed.shape[0], params.hiddens, params.d_in
    dense = d_in * H[0] + sum(H[i] * H[i + 1] for i in range(len(H) - 1))
    heads = H[-1] * (sum(params.policy_heads) + 1)
    fwd_macs = 2 * dense + heads
    bwd_macs = fwd_macs + 2 * (dense - d_in * H[0]) + heads  # every dW, dh past layer 1
    flops = 2 * N * (fwd_macs + bwd_macs)
    n_params = params.flat.numel()
    bytes_moved = 4 * (packed.numel() + 2 * n_params + 4 + 1)
    record["ms"], host_ms = time_ms(
        torch, lambda: fused_ppo_grads(params, packed, unpack, ec, cfg), iters=10, warmup=2
    )
    record["plain_ms"], plain_host_ms = time_ms(
        torch, lambda: ppo_grads_plain(params, packed, unpack, ec, cfg), iters=3, warmup=1
    )
    update_bounds(record, flops, bytes_moved)
    record["host_ms"] = host_ms
    emit({"phase": "kernel_time", "kernel": kernel, "N": N, "flops": flops,
          "bytes": bytes_moved, "host_ms": host_ms, "plain_host_ms": plain_host_ms,
          **{k: record[k] for k in ("ms", "plain_ms", "bound_ms", "bound_tc_ms")}})


def update_bounds(record: dict, flops: int, bytes_moved: int) -> None:
    """A kernel's bounds: f32 CUDA cores (bound_ms) and 3xTF32 tensor cores
    (bound_tc_ms), each the larger of its FLOP time and the bytes'
    time."""
    byte_s = bytes_moved / PEAK_BYTES_PER_S
    record["bound_ms"] = 1e3 * max(flops / PEAK_F32_FLOPS, byte_s)
    record["bound_by"] = "operations" if flops / PEAK_F32_FLOPS > byte_s else "bytes"
    record["bound_tc_ms"] = 1e3 * max(TF32_PRODUCTS * flops / PEAK_TF32_FLOPS, byte_s)


def make_continuous_model(torch, action_dim: int, seed: int, obs_dim: int = 1, mean_scale: float = 0.06,
                          log_std_scale: float = 0.003, log_std_bias: float = 0.0, **model_config):
    """A default continuous model as the main path initializes it, with the
    mean and log-std head weights re-drawn uniform in +-mean_scale and
    +-log_std_scale and the log-std bias set, so that the checks see means
    from ~0 to tens (unsaturated, tanh-saturated and +-100-clamped rows)
    and standard deviations away from 1."""
    from rl8_tpu_torch.models import DefaultContinuousModel
    from rl8_tpu_torch.specs import Unbounded

    model = DefaultContinuousModel(Unbounded(obs_dim), Unbounded(action_dim), **model_config)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    with torch.no_grad():
        model.action_mean.weight.uniform_(-mean_scale, mean_scale, generator=gen)
        model.action_log_std.weight.uniform_(-log_std_scale, log_std_scale, generator=gen)
        model.action_log_std.bias.fill_(log_std_bias)
    return model.cuda()


def clamped_rows(torch, actions, mean, log_std):
    """Per row of squashed ``actions``: whether the +-100 clamp cuts any
    dim's base log-prob (from the plain version's quantities)."""
    from rl8_tpu_torch.ops.distmath import squashed_normal_logp

    _, _, gate = squashed_normal_logp(actions, mean, log_std, torch.exp(-2.0 * log_std))
    return (gate == 0).any(dim=1)


def check_continuous_act(torch, dev, record: dict) -> None:
    """The continuous act kernel against its plain version on the card:
    Normal and squashed, deterministic and stochastic (the plain version
    replays the kernel's Philox draws), at the main path's shapes (obs
    [8192, 1] up to 100 in magnitude, twin 256-wide relu torsos, A=1), at
    a ragged B=1000 with obs dim 3, A=4 and 100/72-wide tanh layers (both
    on the tiled route, continuous_act_tiles_kernel) and at B=1000, obs dim
    2, A=2 and 320/288-wide relu layers (wider than the tiled route's 256:
    continuous_act_kernel), each route asserted from the profiler's kernel
    names; two launches bit-identical.
    Actions and values within ACT_*; log-probs within ACT_* of the plain
    distribution's log-prob of the kernel's own actions on every row, and
    of the plain version's own log-probs on every Normal row and every
    squashed row below SQUASH_LIMIT. Then the moments of the noise."""
    from rl8_tpu_torch.distributions import Normal, SquashedNormal
    from rl8_tpu_torch.ops import act_plain, fused_act, pack_act_params
    from rl8_tpu_torch.ops.distmath import SQUASH_EPS, philox_normal
    from rl8_tpu_torch.ops.fused_mlp import forward_chains

    gen = torch.Generator(device=dev).manual_seed(3)
    configs = {
        "main": dict(B=8192, A=1, obs_dim=1, obs_scale=100.0, model={}, heads={"mean_scale": 0.15, "log_std_bias": -2.0},
                     route="tiled"),
        "ragged": dict(B=1000, A=4, obs_dim=3, obs_scale=3.0,
                       model={"hiddens": (100, 72), "activation_fn": "tanh"},
                       heads={"mean_scale": 0.3, "log_std_scale": 0.3}, route="tiled"),
        "wide": dict(B=1000, A=2, obs_dim=2, obs_scale=3.0, model={"hiddens": (320, 288)},
                     heads={"mean_scale": 0.06, "log_std_scale": 0.3}, route="streaming"),
        # The Pendulum example's shapes (obs dim 3, velocities up to 8).
        "pendulum": dict(B=1024, A=1, obs_dim=3, obs_scale=8.0, model={},
                         heads={"mean_scale": 0.06, "log_std_scale": 0.3}, route="tiled"),
    }
    routes = ACT_ROUTES["continuous"]
    key = (12345, 678)
    for name, c in configs.items():
        B, A = c["B"], c["A"]
        obs = c["obs_scale"] * (2.0 * torch.rand((B, c["obs_dim"]), generator=gen, device=dev) - 1.0)
        model = make_continuous_model(torch, A, seed=60 + A, obs_dim=c["obs_dim"], **c["heads"], **c["model"])
        for kind in ("normal", "squashed"):
            params = pack_act_params(model, squashed=kind == "squashed")
            route = launched_route(torch, f"the continuous act kernel ({name})",
                                   lambda: fused_act(params, obs, key), routes, c["route"])
            ((mean, pre), _), _ = forward_chains(obs, params.chains(), params.activation)
            log_std = torch.tanh(pre)
            dist = (SquashedNormal if kind == "squashed" else Normal)({"mean": mean, "log_std": log_std})
            for det in (True, False):
                what = f"continuous act {name} {kind} {'deterministic' if det else 'stochastic'}"
                ka, kl, kv = fused_act(params, obs, key, deterministic=det)
                k2 = fused_act(params, obs, key, deterministic=det)
                pa, pl, pv = act_plain(params, obs, key, deterministic=det)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip((ka, kl, kv), k2)), f"{what}: two launches bit-identical")
                check(ka.dtype == torch.float32 and tuple(ka.shape) == (B, A), f"{what}: actions [B, A] f32")
                check(torch.allclose(ka, pa, rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: actions")
                check(torch.allclose(kv, pv, rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: values")
                own = dist.logp(ka)
                check(torch.allclose(kl, own, rtol=ACT_RTOL, atol=ACT_ATOL),
                      f"{what}: logp vs the plain log-prob of the kernel's actions")
                x = mean if det else mean + torch.exp(log_std) * philox_normal(*key, B, A, dev)
                regimes = {"mean_abs_max": float(mean.abs().max()),
                           "log_std_range": [float(log_std.min()), float(log_std.max())]}
                keep = torch.ones(B, dtype=torch.bool, device=dev)
                if kind == "squashed":
                    keep = (x.abs() < SQUASH_LIMIT).all(dim=1)
                    clipped = (torch.tanh(x).abs() >= 1.0 - SQUASH_EPS).any(dim=1)
                    clamped = clamped_rows(torch, torch.tanh(x), mean, log_std)
                    regimes.update(rows_below_limit=int(keep.sum()), rows_clipped=int(clipped.sum()),
                                   rows_clamped=int(clamped.sum()))
                err = max(float((ka - pa).abs().max()), float((kv - pv).abs().max()),
                          float((kl - own).abs().max()), float((kl[keep] - pl[keep]).abs().max()))
                emit({"phase": "kernel_check", "kernel": "continuous_act", "config": name, "route": route,
                      "kind": kind, "deterministic": det, "B": B, "A": A, "hiddens": list(params.hiddens),
                      "activation": params.activation, "max_abs_err": err, "rtol": ACT_RTOL,
                      "atol": ACT_ATOL, **regimes})
                check(torch.allclose(kl[keep], pl[keep], rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: logp")
                if kind == "squashed":
                    check(int(keep.sum()) >= B // 50, f"{what}: too few rows below the squash limit")
                    if name == "main" and det:
                        check(int(clamped.sum()) > 0, f"{what}: no row reaches the +-100 clamp")
                if name == "main":
                    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)
                    record["kernel"] = f"continuous_act_{'tiles_' if route == 'tiled' else ''}kernel"

    # The noise's moments: Normal at the main shapes, FREQ_DRAWS keys; the
    # standardized draws (a - mean) / std must have mean 0, variance 1 and
    # 68.27% of them within one std, each within FREQ_SIGMAS sampling stds.
    B = 8192
    obs = 100.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
    params = pack_act_params(make_continuous_model(torch, 1, seed=61))
    ((mean, pre), _), _ = forward_chains(obs, params.chains(), params.activation)
    std = torch.exp(torch.tanh(pre))
    z = torch.cat([(fused_act(params, obs, (99, d))[0] - mean) / std for d in range(FREQ_DRAWS)]).double()
    n = z.numel()
    p1 = math.erf(1 / math.sqrt(2))
    moments = {
        "mean": (float(z.mean()), 0.0, 1 / math.sqrt(n)),
        "variance": (float(z.var()), 1.0, math.sqrt(2 / n)),
        "within_1_std": (float((z.abs() < 1).double().mean()), p1, math.sqrt(p1 * (1 - p1) / n)),
    }
    worst = 0.0
    for what, (got, want, sigma) in moments.items():
        worst = max(worst, abs(got - want) / sigma)
        check(abs(got - want) <= FREQ_SIGMAS * sigma, f"continuous act noise {what}: {got} vs {want}")
    emit({"phase": "kernel_check", "kernel": "continuous_act", "noise_draws": n,
          "moments": {k: v[0] for k, v in moments.items()}, "worst_sigmas": worst})

    # Timing at the main path's shapes: B=8192, twin 256-wide relu torsos,
    # A=1, squashed, stochastic.
    params = pack_act_params(make_continuous_model(torch, 1, seed=62), squashed=True)
    H = params.hiddens
    macs_chain = params.d_in * H[0] + sum(H[i] * H[i + 1] for i in range(len(H) - 1))
    flops = 2 * B * (2 * macs_chain + H[-1] * (sum(params.policy_heads) + 1))
    bytes_moved = 4 * (obs.numel() + params.flat.numel() + B * (params.action_dim + 2))
    record["ms"], host_ms = time_ms(torch, lambda: fused_act(params, obs, (1, 2)))
    record["plain_ms"], plain_host_ms = time_ms(
        torch, lambda: act_plain(params, obs, (1, 2), deterministic=False), iters=20
    )
    record["bound_ms"] = 1e3 * max(flops / PEAK_F32_FLOPS, bytes_moved / PEAK_BYTES_PER_S)
    record["bound_by"] = "operations" if flops / PEAK_F32_FLOPS > bytes_moved / PEAK_BYTES_PER_S else "bytes"
    emit({"phase": "kernel_time", "kernel": "continuous_act", "B": B, "flops": flops,
          "bytes": bytes_moved, "host_ms": host_ms, "plain_host_ms": plain_host_ms,
          **{k: record[k] for k in ("ms", "plain_ms", "bound_ms")}})


def continuous_ppo_inputs(torch, dev, model, N: int, seed: int, squashed: bool, clip_share: float = 0.0):
    """A packed continuous minibatch of N rows for ``model``: observations,
    actions drawn from the model's own distribution (tanh-squashed when
    squashed), old log-probs near the model's own, standard-normal
    advantages, and returns around the model's values. A ``clip_share`` of
    the rows get squashed actions of exactly +-1, whose base log-prob lies
    below -100 where the mean is far from the clipped atanh in stds.
    Returns the packed inputs and, per row, whether it hits the +-100
    clamp (from the plain version's quantities)."""
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.distributions import Normal, SquashedNormal
    from rl8_tpu_torch.ops import pack_act_params, pack_rows
    from rl8_tpu_torch.ops.fused_mlp import forward_chains

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = pack_act_params(model, squashed=squashed)
    A = params.action_dim
    obs = 20.0 * torch.randn((N, params.d_in), generator=gen, device=dev)
    ((mean, pre), (values,)), _ = forward_chains(obs, params.chains(), params.activation)
    log_std = torch.tanh(pre)
    actions = mean + torch.exp(log_std) * torch.randn((N, A), generator=gen, device=dev)
    clamped = torch.zeros(N, dtype=torch.bool, device=dev)
    if squashed:
        actions = torch.tanh(actions)
        if clip_share:
            sel = torch.rand((N, 1), generator=gen, device=dev) < clip_share
            sign = torch.where(torch.rand((N, A), generator=gen, device=dev) < 0.5, -1.0, 1.0)
            actions = torch.where(sel, sign, actions)
        clamped = clamped_rows(torch, actions, mean, log_std)
    dist = (SquashedNormal if squashed else Normal)({"mean": mean, "log_std": log_std})
    logp = dist.logp(actions) + 0.1 * torch.randn((N, 1), generator=gen, device=dev)
    packed, unpack = pack_rows({
        DataKeys.ACTIONS: actions,
        DataKeys.LOGP: logp,
        DataKeys.ADVANTAGES: torch.randn((N, 1), generator=gen, device=dev),
        DataKeys.RETURNS: values + 2.0 * torch.randn((N, 1), generator=gen, device=dev),
        DataKeys.VIEWS: {DataKeys.OBS: obs},
    })
    return params, packed, unpack, clamped


def check_continuous_ppo(torch, dev, record: dict) -> None:
    """The continuous update kernel against its plain version on the card
    (compare_ppo's tolerances, bit-identical launches): (a) the main
    path's shapes, squashed without entropy; (b) a ragged N with Normal,
    A=3, entropy, dual clip and accumulation; (c) ragged weight tiles
    (100- and 72-wide tanh layers), squashed; (d) squashed rows with
    actions at +-1 and a small std, so that the +-100 clamp cuts their
    gradients; and the Pendulum example's launches (EXAMPLE_UPDATES,
    Normal, the default loss, example_rows rows)."""
    from rl8_tpu_torch.ops import PPOLossConfig

    configs = {
        "a": dict(N=8192 * 32, A=1, model={}, obs_dim=1, heads={}, squashed=True, ec=0.0, clip_share=0.0,
                  loss=dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)),
        "b": dict(N=1000, A=3, model={"hiddens": (64, 32)}, obs_dim=3, heads={}, squashed=False, ec=0.013,
                  clip_share=0.0, loss=dict(vf_clip_param=1.5, vf_coeff=0.9, dual_clip_param=3.0, accum=3)),
        "c": dict(N=9001, A=2, model={"hiddens": (100, 72), "activation_fn": "tanh"}, obs_dim=5,
                  heads={"mean_scale": 1.0, "log_std_scale": 0.3}, squashed=True, ec=0.0, clip_share=0.0,
                  loss=dict(vf_clip_param=2.0, vf_coeff=0.5, dual_clip_param=None, accum=2)),
        "d": dict(N=4096, A=2, model={"hiddens": (64, 64)}, obs_dim=2,
                  heads={"mean_scale": 0.001, "log_std_bias": -3.0}, squashed=True, ec=0.0, clip_share=0.3,
                  loss=dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)),
    }
    e = EXAMPLE_UPDATES["pendulum"]
    configs["pendulum"] = dict(N=example_rows("pendulum"), A=e["A"], model={}, obs_dim=e["obs_dim"], heads={},
                               squashed=e["kind"] == "squashed", ec=0.0, clip_share=0.0,
                               loss=dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1))
    for name, c in configs.items():
        seed = sum(map(ord, name))  # ord(name) for the one-letter cases
        model = make_continuous_model(torch, c["A"], seed=80 + seed, obs_dim=c["obs_dim"],
                                      **c["heads"], **c["model"])
        params, packed, unpack, clamped = continuous_ppo_inputs(
            torch, dev, model, c["N"], seed=seed, squashed=c["squashed"], clip_share=c["clip_share"]
        )
        if c["clip_share"]:
            check(int(clamped.sum()) >= c["N"] // 10, f"continuous ppo ({name}): too few rows hit the +-100 clamp")
        cfg = PPOLossConfig(clip_param=0.2, n_rows=c["N"], use_entropy=c["ec"] != 0.0,
                            squashed=c["squashed"], **c["loss"])
        ec = torch.tensor(c["ec"], device=dev)
        result = compare_ppo(torch, f"continuous ppo ({name})", params, packed, unpack, ec, cfg)
        emit({"phase": "kernel_check", "kernel": "continuous_ppo_update", "config": name, "N": c["N"],
              "hiddens": list(params.hiddens), "A": params.action_dim, "kind": params.kind,
              "activation": params.activation, "entropy_coeff": c["ec"], **c["loss"],
              "rows_clamped": int(clamped.sum()), **result["summary"]})
        if name == "a":
            time_ppo(torch, "continuous_ppo_update", record, result, params, packed, unpack, ec, cfg)


def make_rnn_model(torch, kind: str, seed: int, obs_dim: int = 1, A: int = 1, n: int = 2, hidden_size: int = 256,
                   num_layers: int = 1, head_scale: float = 0.3, log_std_bias: float = 0.0):
    """A default recurrent model as the main path initializes it, with the
    policy heads re-drawn uniform in +-head_scale (and the log-std bias
    set), so that the checks see action probabilities far from uniform,
    means away from 0 and standard deviations away from 1."""
    from rl8_tpu_torch.models import DefaultContinuousRecurrentModel, DefaultDiscreteRecurrentModel
    from rl8_tpu_torch.specs import Discrete, Unbounded

    config = {"hidden_size": hidden_size, "num_layers": num_layers}
    if kind == "categorical":
        model = DefaultDiscreteRecurrentModel(Unbounded(obs_dim), Discrete(n, shape=(A,)), **config)
        heads = (model.feature_head,)
    else:
        model = DefaultContinuousRecurrentModel(Unbounded(obs_dim), Unbounded(A), **config)
        heads = (model.action_mean, model.action_log_std)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    with torch.no_grad():
        for head in heads:
            head.weight.uniform_(-head_scale, head_scale, generator=gen)
        if kind != "categorical":
            model.action_log_std.bias.fill_(log_std_bias)
    return model.cuda()


def rnn_states(torch, dev, B: int, K: int, H: int, gen) -> dict:
    """Recurrent states as a rollout carries them: h in (-1, 1), c of a few
    units."""
    from rl8_tpu_torch.data import DataKeys

    return {
        DataKeys.HIDDEN_STATES: 2.0 * torch.rand((B, K, H), generator=gen, device=dev) - 1.0,
        DataKeys.CELL_STATES: 2.0 * torch.randn((B, K, H), generator=gen, device=dev),
    }


def rnn_heads_plain(torch, params, obs, states):
    """The heads' outputs of one recurrent step in plain PyTorch."""
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.ops.fused_rnn_act import lstm_cell

    x = obs
    for l, (wi, wh, b) in enumerate(params.lstm()):
        x = lstm_cell(x, states[DataKeys.HIDDEN_STATES][:, l], states[DataKeys.CELL_STATES][:, l], wi, wh, b)[0]
    return [x @ w + b for w, b in params.heads()]


def check_rnn_act(torch, dev, record: dict) -> None:
    """The recurrent act kernel against its plain version on the card, for
    the categorical, Normal and squashed kinds, deterministic and draw for
    draw (the plain version replays the kernel's Philox draws): at the main
    path's shapes (obs [8192, 1], one 256-wide LSTM layer, A = 1) and at a
    ragged B = 1000 with obs dim 3, two 96-wide layers and A = 2 (n = 3).
    The new states, values and continuous actions within ACT_*; discrete
    actions equal except near ties; log-probs within ACT_* of the plain
    distribution's log-prob of the kernel's own actions on every row, and of
    the plain version's own where SQUASH_LIMIT allows (as for the
    feedforward act kernels)."""
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.distributions import Categorical, Normal, SquashedNormal
    from rl8_tpu_torch.ops import fused_rnn_act, pack_rnn_params, rnn_act_plain
    from rl8_tpu_torch.ops.distmath import philox_normal, philox_uniform

    gen = torch.Generator(device=dev).manual_seed(5)
    configs = {
        "main": dict(B=8192, obs_dim=1, A=1, n=2, H=256, K=1),
        "ragged": dict(B=1000, obs_dim=3, A=2, n=3, H=96, K=2),
        # 16-row tiles: 32 rows of a 720-wide layer do not fit two blocks an SM.
        "wide": dict(B=1000, obs_dim=3, A=1, n=2, H=720, K=1),
    }
    key = (24680, 1357)
    for name, c in configs.items():
        B, A, n, H, K = c["B"], c["A"], c["n"], c["H"], c["K"]
        obs = 3.0 * (2.0 * torch.rand((B, c["obs_dim"]), generator=gen, device=dev) - 1.0)
        states = rnn_states(torch, dev, B, K, H, gen)
        for kind in ("categorical", "normal", "squashed"):
            model = make_rnn_model(torch, kind, seed=90 + K, obs_dim=c["obs_dim"], A=A, n=n, hidden_size=H,
                                   num_layers=K, log_std_bias=-1.0)
            params = pack_rnn_params(model, squashed=kind == "squashed")
            outs = rnn_heads_plain(torch, params, obs, states)
            for det in (True, False):
                what = f"rnn act {name} {kind} {'deterministic' if det else 'stochastic'}"
                ka, kl, kv, ks = fused_rnn_act(params, obs, states, key, deterministic=det)
                pa, pl, pv, ps = rnn_act_plain(params, obs, states, key, deterministic=det)
                torch.cuda.synchronize()
                for sk in (DataKeys.HIDDEN_STATES, DataKeys.CELL_STATES):
                    check(tuple(ks[sk].shape) == (B, K, H), f"{what}: {sk} shape")
                    check(torch.allclose(ks[sk], ps[sk], rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: {sk}")
                check(torch.allclose(kv, pv, rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: values")
                keep = torch.ones(B, dtype=torch.bool, device=dev)
                if kind == "categorical":
                    logits = outs[0].view(B, A, n)
                    dist = Categorical({"logits": logits})
                    scores = logits.log_softmax(-1)
                    if not det:
                        scores = scores - torch.log(-torch.log(philox_uniform(*key, B, A, n, dev).view(B, A, n)))
                    top2 = scores.topk(2, dim=-1).values
                    ties = ((top2[..., 0] - top2[..., 1]) < TIE_GAP).any(dim=1)
                    check(bool((ka == pa).all(dim=1)[~ties].all()), f"{what}: actions")
                    err_a = 0.0
                else:
                    log_std = torch.tanh(outs[1])
                    dist = (SquashedNormal if kind == "squashed" else Normal)({"mean": outs[0], "log_std": log_std})
                    check(torch.allclose(ka, pa, rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: actions")
                    err_a = float((ka - pa).abs().max())
                    if kind == "squashed":
                        x = outs[0] if det else outs[0] + torch.exp(log_std) * philox_normal(*key, B, A, dev)
                        keep = (x.abs() < SQUASH_LIMIT).all(dim=1)
                own = dist.logp(ka)
                check(torch.allclose(kl, own, rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: logp vs the plain log-prob of the kernel's actions")
                check(torch.allclose(kl[keep], pl[keep], rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: logp")
                err = max(err_a, float((kv - pv).abs().max()), float((kl - own).abs().max()),
                          float((kl[keep] - pl[keep]).abs().max()),
                          *(float((ks[sk] - ps[sk]).abs().max()) for sk in ks))
                emit({"phase": "kernel_check", "kernel": "rnn_act", "config": name, "kind": kind,
                      "deterministic": det, "B": B, "A": A, "n": n if kind == "categorical" else 0, "H": H,
                      "K": K, "max_abs_err": err, "rows_compared_logp": int(keep.sum()),
                      "rtol": ACT_RTOL, "atol": ACT_ATOL})
                if name == "main":
                    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)

    # Timing at the main path's shapes: B = 8192, one 256-wide layer,
    # categorical A = 1, n = 2, stochastic.
    B, H = 8192, 256
    obs = 3.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
    states = rnn_states(torch, dev, B, 1, H, gen)
    params = pack_rnn_params(make_rnn_model(torch, "categorical", seed=99))
    flops = 2 * B * ((params.d_in + H) * 4 * H + H * sum(params.head_widths))
    bytes_moved = 4 * (obs.numel() + 4 * B * H + params.flat.numel() + B * (params.action_dim + 2))
    record["ms"], host_ms = time_ms(torch, lambda: fused_rnn_act(params, obs, states, (1, 2)))
    record["plain_ms"], plain_host_ms = time_ms(
        torch, lambda: rnn_act_plain(params, obs, states, (1, 2), deterministic=False), iters=20
    )
    update_bounds(record, flops, bytes_moved)
    emit({"phase": "kernel_time", "kernel": "rnn_act", "B": B, "flops": flops, "bytes": bytes_moved,
          "host_ms": host_ms, "plain_host_ms": plain_host_ms,
          **{k: record[k] for k in ("ms", "plain_ms", "bound_ms", "bound_tc_ms")}})


def rnn_ppo_inputs(torch, dev, model, kind: str, N: int, L: int, seed: int, clip_share: float = 0.0):
    """A packed minibatch of N sequences of L steps for ``model``:
    observations, stored initial states, actions (random categories, or
    drawn from the model's own distribution, tanh-squashed when squashed),
    old log-probs near the model's own, standard-normal advantages, and
    returns around the model's values. A ``clip_share`` of the squashed
    samples get actions of exactly +-1, whose base log-prob lies below -100
    where the std is small. Returns the packed inputs and the number of
    samples that hit the +-100 clamp."""
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.distributions import Categorical, Normal, SquashedNormal
    from rl8_tpu_torch.ops import pack_rows

    gen = torch.Generator(device=dev).manual_seed(seed)
    d, K, H, A = model.observation_spec.shape[0], model.num_layers, model.hidden_size, model.action_spec.shape[0]
    obs = 3.0 * torch.randn((N, L, d), generator=gen, device=dev)
    states = rnn_states(torch, dev, N, K, H, gen)
    with torch.no_grad():
        (features, values), _ = model({DataKeys.OBS: obs}, states)
    clamped = 0
    if kind == "categorical":
        n = model.action_spec.n
        actions = torch.randint(0, n, (N * L, A), generator=gen, device=dev, dtype=torch.int32)
        dist = Categorical(features)
    else:
        mean, log_std = features["mean"], features["log_std"]
        actions = mean + torch.exp(log_std) * torch.randn((N * L, A), generator=gen, device=dev)
        dist = (SquashedNormal if kind == "squashed" else Normal)(features)
        if kind == "squashed":
            actions = torch.tanh(actions)
            if clip_share:
                sel = torch.rand((N * L, 1), generator=gen, device=dev) < clip_share
                sign = torch.where(torch.rand((N * L, A), generator=gen, device=dev) < 0.5, -1.0, 1.0)
                actions = torch.where(sel, sign, actions)
            clamped = int(clamped_rows(torch, actions, mean, log_std).sum())
    logp = dist.logp(actions) + 0.1 * torch.randn((N * L, 1), generator=gen, device=dev)
    packed, unpack = pack_rows({
        DataKeys.ACTIONS: actions.view(N, L, A),
        DataKeys.ADVANTAGES: torch.randn((N, L, 1), generator=gen, device=dev),
        DataKeys.LOGP: logp.view(N, L, 1),
        DataKeys.OBS: obs,
        DataKeys.RETURNS: (values + 2.0 * torch.randn((N * L, 1), generator=gen, device=dev)).view(N, L, 1),
        DataKeys.STATES: states,
    })
    return packed, unpack, clamped


def check_rnn_ppo(torch, dev, record: dict) -> None:
    """The recurrent update kernel against its plain version on the card
    (compare_ppo's tolerances, two launches bit-identical): (a) the main
    path's shapes, 65,536 sequences of L = 4 with one 256-wide layer,
    categorical; (b) the same shapes squashed; (c) a ragged 1,000
    sequences, two 64-wide layers, A = 2, n = 3, entropy, dual clip and
    accumulation; (d) the same ragged shapes with Normal, entropy and dual
    clip; (e) squashed samples with actions at +-1 and a small std, so that
    the +-100 clamp cuts their gradients."""
    from rl8_tpu_torch.ops import PPOLossConfig, pack_rnn_params

    main_loss = dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)
    ragged_loss = dict(vf_clip_param=1.5, vf_coeff=0.9, dual_clip_param=3.0, accum=3)
    configs = {
        "a": dict(N=65536, kind="categorical", model={}, ec=0.0, loss=main_loss),
        "b": dict(N=65536, kind="squashed", model={}, ec=0.0, loss=main_loss),
        "c": dict(N=1000, kind="categorical", model=dict(obs_dim=3, A=2, n=3, hidden_size=64, num_layers=2),
                  ec=0.013, loss=ragged_loss),
        "d": dict(N=1000, kind="normal", model=dict(obs_dim=3, A=2, hidden_size=64, num_layers=2), ec=0.013,
                  loss=ragged_loss),
        "e": dict(N=2048, kind="squashed", model=dict(obs_dim=2, A=2, hidden_size=32, head_scale=0.001,
                                                         log_std_bias=-3.0), ec=0.0, clip_share=0.3,
                  loss=main_loss),
    }
    L = 4
    for name, c in configs.items():
        model = make_rnn_model(torch, c["kind"], seed=110 + ord(name), **c["model"])
        params = pack_rnn_params(model, squashed=c["kind"] == "squashed")
        packed, unpack, clamped = rnn_ppo_inputs(torch, dev, model, c["kind"], c["N"], L, seed=ord(name),
                                                 clip_share=c.get("clip_share", 0.0))
        if c.get("clip_share"):
            check(clamped >= c["N"] * L // 10, f"rnn ppo ({name}): too few samples hit the +-100 clamp")
        cfg = PPOLossConfig(clip_param=0.2, n_rows=c["N"], use_entropy=c["ec"] != 0.0,
                            squashed=c["kind"] == "squashed", **c["loss"])
        ec = torch.tensor(c["ec"], device=dev)
        result = compare_rnn_ppo(torch, f"rnn ppo ({name})", params, packed, unpack, ec, cfg)
        emit({"phase": "kernel_check", "kernel": "rnn_ppo_update", "config": name, "N": c["N"], "L": L,
              "H": params.hidden, "K": params.num_layers, "A": params.action_dim, "kind": params.kind,
              "entropy_coeff": c["ec"], **c["loss"], "samples_clamped": clamped, **result["summary"]})
        if name == "a":
            time_rnn_ppo(torch, record, result, params, packed, unpack, ec, cfg)

    # The width limit is the kernel's own (its row pass must fit a block's
    # shared memory): the main width passes, 1024 is refused by the query
    # and by the wrapper.
    from rl8_tpu_torch.ops import card_takes_rnn_update, fused_rnn_ppo_grads

    main_model, wide_model = (make_rnn_model(torch, "categorical", seed=0, hidden_size=h) for h in (256, 1024))
    wide = pack_rnn_params(wide_model)
    check(card_takes_rnn_update(pack_rnn_params(main_model)), "rnn ppo: the kernel refuses the main width")
    check(not card_takes_rnn_update(wide), "rnn ppo: the kernel takes a 1024-wide row pass")
    packed, unpack, _ = rnn_ppo_inputs(torch, dev, wide_model, "categorical", 16, L, seed=0)
    cfg = PPOLossConfig(clip_param=0.2, n_rows=16, use_entropy=False, **main_loss)
    try:
        fused_rnn_ppo_grads(wide, packed, unpack, torch.tensor(0.0, device=dev), cfg)
        refused = False
    except NotImplementedError:
        refused = True
    check(refused, "rnn ppo: the wrapper launched a 1024-wide update")
    emit({"phase": "kernel_check", "kernel": "rnn_ppo_update", "width_limit": {"256": True, "1024": False}})


def compare_rnn_ppo(torch, what: str, params, packed, unpack, ec, cfg) -> dict:
    """The recurrent update kernel twice and its plain version once on one
    minibatch: the launches must be bit-identical, each gradient tensor
    within PPO_GRAD_* of the plain one by norm, the losses and KL within
    PPO_STAT_*."""
    from rl8_tpu_torch.ops import fused_rnn_ppo_grads, rnn_ppo_grads_plain
    from rl8_tpu_torch.ops.fused_rnn_act import RnnParams

    k_losses, k_kl, k_grads = fused_rnn_ppo_grads(params, packed, unpack, ec, cfg)
    k2_losses, k2_kl, k2_grads = fused_rnn_ppo_grads(params, packed, unpack, ec, cfg)
    p_losses, p_kl, p_grads = rnn_ppo_grads_plain(params, packed, unpack, ec, cfg)
    torch.cuda.synchronize()
    check(torch.equal(k_grads, k2_grads) and torch.equal(k_kl, k2_kl)
          and all(torch.equal(k_losses[key], k2_losses[key]) for key in k_losses),
          f"{what}: two launches bit-identical")

    def tensors(flat):
        views = RnnParams(**{**params.__dict__, "flat": flat})
        return [t for layer in views.lstm() for t in layer] + [t for head in views.heads() for t in head]

    worst_grad = 0.0
    for kt, pt in zip(tensors(k_grads), tensors(p_grads)):
        err, ref = float((kt - pt).norm()), float(pt.norm())
        worst_grad = max(worst_grad, err / max(ref, 1e-30))
        check(err <= PPO_GRAD_RTOL * ref + PPO_GRAD_ATOL,
              f"{what}: gradient {tuple(pt.shape)} error {err:.3g} vs norm {ref:.3g}")
    stat_err = 0.0
    for key, kv, pv in [(k, k_losses[k], p_losses[k]) for k in p_losses] + [("kl", k_kl, p_kl)]:
        kv, pv = float(kv), float(pv)
        stat_err = max(stat_err, abs(kv - pv))
        check(abs(kv - pv) <= PPO_STAT_RTOL * abs(pv) + PPO_STAT_ATOL, f"{what}: {key} {kv!r} vs plain {pv!r}")
    return {
        "max_abs_err": max(stat_err, float((k_grads - p_grads).abs().max())),
        "summary": {"worst_grad_norm_rel_err": worst_grad, "loss_max_abs_err": stat_err,
                    "bit_identical": True, "losses": {k: float(v) for k, v in k_losses.items()},
                    "kl": float(k_kl)},
    }


def time_rnn_ppo(torch, record: dict, result: dict, params, packed, unpack, ec, cfg) -> None:
    """Time the recurrent update kernel beside its plain version on one
    minibatch, with its f32 bound: per sample, the forward's gate products,
    the backward's dx products below the top layer, the weight products
    and the heads'; per sequence, the dh products of its L - 1 later steps
    (the stored initial states take no gradient)."""
    from rl8_tpu_torch.ops import fused_rnn_ppo_grads, rnn_ppo_grads_plain
    from rl8_tpu_torch.ops.fused_rnn_ppo import RnnPackedColumns

    record["max_abs_err"] = result["max_abs_err"]
    N, H, K, d_in = packed.shape[0], params.hidden, params.num_layers, params.d_in
    L = RnnPackedColumns.from_unpacker(unpack).seq_len
    G = 4 * H
    step_macs = 0
    for l in range(K):
        d_l = d_in if l == 0 else H
        step_macs += (d_l + H) * G          # forward gate products
        step_macs += G * H if l > 0 else 0  # dx = dz Wi^T into the layer below
        step_macs += (d_l + H + 1) * G      # dWi, dWh, db
    head_out = sum(params.head_widths)
    step_macs += 3 * (H + 1) * head_out     # heads forward, their dh and dW
    seq_macs = L * step_macs + (L - 1) * K * G * H  # dh_t = dz Wh^T at steps t > 0
    flops = 2 * N * seq_macs
    bytes_moved = 4 * (packed.numel() + 2 * params.flat.numel() + 4 + 1)
    record["ms"], host_ms = time_ms(
        torch, lambda: fused_rnn_ppo_grads(params, packed, unpack, ec, cfg), iters=10, warmup=2
    )
    record["plain_ms"], plain_host_ms = time_ms(
        torch, lambda: rnn_ppo_grads_plain(params, packed, unpack, ec, cfg), iters=3, warmup=1
    )
    update_bounds(record, flops, bytes_moved)
    record["host_ms"] = host_ms
    emit({"phase": "kernel_time", "kernel": "rnn_ppo_update", "N": N, "L": L, "flops": flops,
          "bytes": bytes_moved, "host_ms": host_ms, "plain_host_ms": plain_host_ms,
          **{k: record[k] for k in ("ms", "plain_ms", "bound_ms", "bound_tc_ms")}})


def make_mule(torch, seed: int, hiddens=(128, 128)):
    """MischievousMule as the custom main path initializes it, on the CPU,
    with the logits head re-drawn at lecun scale so that its greedy
    actions are not near-ties."""
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule
    from rl8_tpu_torch.models import lecun_normal_

    env = AlgoTrading(1, device="cpu")
    model = MischievousMule(env.observation_spec, env.action_spec, hiddens=hiddens)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    with torch.no_grad():
        lecun_normal_(model.feature_head.weight, gen)
    return model


def random_chains(torch, dev, seed: int, d_in: int, layout):
    """Chains of ``layout`` (per chain: ``[(width, layer_norm), ...]`` and
    the head widths) with lecun-scale weights, biases of 0.1, and
    LayerNorm scales around 1 and biases around 0."""
    gen = torch.Generator().manual_seed(seed)
    chains = []
    for layers, heads in layout:
        k, built = d_in, []
        for width, has_ln in layers:
            layer = [torch.randn((k, width), generator=gen) / math.sqrt(k), 0.1 * torch.randn(width, generator=gen)]
            if has_ln:
                layer += [0.5 + torch.rand(width, generator=gen), 0.1 * torch.randn(width, generator=gen)]
            built.append(tuple(t.to(dev) for t in layer))
            k = width
        head = [(torch.randn((k, w), generator=gen).to(dev) / math.sqrt(k), 0.1 * torch.randn(w, generator=gen).to(dev))
                for w in heads]
        chains.append((tuple(built), tuple(head)))
    return tuple(chains)


def compare_chains(torch, what: str, x, chains, activation: str, seed: int) -> dict:
    """The chain kernels against their plain versions on ``x``: the forward
    twice (bit-identical), every head output within CHAIN_RTOL/ATOL, then
    from random head cotangents the
    backward twice (bit-identical) against ``chains_vjp_plain``: dx within
    CHAIN_RTOL/ATOL and each parameter gradient within PPO_GRAD_* by norm,
    all finite."""
    from rl8_tpu_torch.ops import chains_vjp_plain, forward_chains, fused_chains_bwd, fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, flatten_chains, unflatten_chains

    structure = chain_structure(chains)
    flat = flatten_chains(chains)
    k_outs = fused_chains_fwd(x, flat, structure, activation)
    k2_outs = fused_chains_fwd(x, flat, structure, activation)
    p_outs = [o for chain in forward_chains(x, chains, activation)[0] for o in chain]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(k_outs, k2_outs)), f"{what}: two forward launches bit-identical")
    fwd_err = 0.0
    for i, (k, p) in enumerate(zip(k_outs, p_outs)):
        check(bool(torch.isfinite(k).all()), f"{what}: head {i} output finite")
        check(torch.allclose(k, p, rtol=CHAIN_RTOL, atol=CHAIN_ATOL), f"{what}: head {i} output")
        fwd_err = max(fwd_err, float((k - p).abs().max()))
    gen = torch.Generator(device=x.device).manual_seed(seed)
    douts = [torch.randn(o.shape, generator=gen, device=x.device) for o in p_outs]
    k_dx, k_dflat = fused_chains_bwd(x, flat, structure, activation, douts)
    k2_dx, k2_dflat = fused_chains_bwd(x, flat, structure, activation, douts)
    grouped, i = [], 0
    for _, heads in structure[1]:
        grouped.append(douts[i : i + len(heads)])
        i += len(heads)
    p_dx, p_dchains = chains_vjp_plain(x, chains, activation, grouped)
    torch.cuda.synchronize()
    check(torch.equal(k_dx, k2_dx) and torch.equal(k_dflat, k2_dflat), f"{what}: two backward launches bit-identical")
    check(bool(torch.isfinite(k_dx).all() and torch.isfinite(k_dflat).all()), f"{what}: gradients finite")
    check(torch.allclose(k_dx, p_dx, rtol=CHAIN_RTOL, atol=CHAIN_ATOL), f"{what}: dx")
    worst_grad = 0.0
    k_tensors = [t for layers, heads in unflatten_chains(k_dflat, structure) for ts in (*layers, *heads) for t in ts]
    p_tensors = [t for layers, heads in p_dchains for ts in (*layers, *heads) for t in ts]
    for kt, pt in zip(k_tensors, p_tensors):
        err, ref = float((kt - pt).norm()), float(pt.norm())
        worst_grad = max(worst_grad, err / max(ref, 1e-30))
        check(err <= PPO_GRAD_RTOL * ref + PPO_GRAD_ATOL,
              f"{what}: gradient {tuple(pt.shape)} error {err:.3g} vs norm {ref:.3g}")
    return {"fwd_max_abs_err": fwd_err, "dx_max_abs_err": float((k_dx - p_dx).abs().max()),
            "worst_grad_norm_rel_err": worst_grad, "bit_identical": True,
            "max_abs_err": max(fwd_err, float((k_dx - p_dx).abs().max()), float((k_dflat - flatten_chains(p_dchains)).abs().max()))}


def chain_counts(structure, N: int) -> tuple[int, int, int, int]:
    """``(fwd flops, fwd bytes, bwd flops, bwd bytes)`` of the chain kernels
    on N rows: per row the dense products' multiply-adds (the backward
    recomputes them and adds the dh and weight products, three times
    theirs), LayerNorm's elementwise work left out; each input read once
    and each output written once."""
    d_in, shapes = structure
    macs, n_params, n_out = 0, 0, 0
    for layers, heads in shapes:
        k = d_in
        for width, has_ln in layers:
            macs += k * width
            n_params += k * width + width + (2 * width if has_ln else 0)
            k = width
        for width in heads:
            macs += k * width
            n_params += k * width + width
            n_out += width
    fwd_bytes = 4 * (N * d_in + n_params + N * n_out)
    bwd_bytes = 4 * (2 * N * d_in + 2 * n_params + N * n_out)
    return 2 * N * macs, fwd_bytes, 2 * N * 3 * macs, bwd_bytes


def bound(flops: int, bytes_moved: int) -> tuple[float, str]:
    ops_s, bytes_s = flops / PEAK_F32_FLOPS, bytes_moved / PEAK_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s > bytes_s else "bytes"


def check_chains(torch, dev, fwd_record: dict, bwd_record: dict) -> None:
    """The chain kernels against their plain versions on the card
    (compare_chains): (a) MischievousMule's chains at the main path's
    4,096 rollout rows and 32,768 minibatch rows; (b) a ragged 1,000 rows
    of three tanh chains with mixed LayerNorm flags, 48 and 100 wide, two
    heads (2 and 9 wide) on one chain, at d_in 1 and 64; (c) rows whose pre-LayerNorm
    values are constant (zero variance); (d) one 768-wide LayerNorm chain
    at d_in 7, near the kernels' width limit; (e) 160- and 136-wide layers
    (the tiled forward's passes of 128 columns and its separate LayerNorm
    and head passes). (a) to (c) must take the forward's and the backward's
    tiled routes (chains_fwd_tiles_kernel, chains_bwd_tiles_kernel), (d)
    their streaming routes (chains_fwd_kernel: its tile buffers do not fit a
    block; chains_bwd_rows_kernel: its parameters and gradients do not), (e)
    the tiled forward and the streaming backward. Then each kernel timed
    beside its plain version at the main path's shapes, with its bounds."""
    from rl8_tpu_torch.ops import chains_vjp_plain, forward_chains, fused_chains_bwd, fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, default_chains, flatten_chains

    mule = make_mule(torch, seed=5).to(dev)
    mule_chains = default_chains(mule)
    gen = torch.Generator(device=dev).manual_seed(6)
    xs = {N: 0.5 * torch.randn((N, 7), generator=gen, device=dev) for N in (4096, 32768)}
    for N, x in xs.items():
        result = compare_chains(torch, f"chains (a, N={N})", x, mule_chains, "relu", seed=N)
        emit({"phase": "kernel_check", "kernel": "chains", "config": "a", "N": N, **result,
              "route": backward_route(torch, x, mule_chains, "relu"),
              "forward_route": forward_route(torch, x, mule_chains, "relu")})
        if N == 32768:
            fwd_record["max_abs_err"] = result["fwd_max_abs_err"]
            bwd_record["max_abs_err"] = result["max_abs_err"]
    # The main path's chains take the forward's tiled route (asserted above).
    fwd_record["kernel"] = "chains_fwd_tiles_kernel"
    ragged = (
        ([(48, True), (100, False), (48, True)], [2, 9]),
        ([(100, False), (48, True), (100, True)], [1]),
        ([(48, True), (48, False), (100, False)], [3]),
    )
    for d_in in (1, 64):
        chains = random_chains(torch, dev, seed=d_in, d_in=d_in, layout=ragged)
        x = 2.0 * torch.randn((1000, d_in), generator=gen, device=dev)
        result = compare_chains(torch, f"chains (b, d_in={d_in})", x, chains, "tanh", seed=d_in)
        emit({"phase": "kernel_check", "kernel": "chains", "config": "b", "N": 1000, "d_in": d_in, **result,
              "route": backward_route(torch, x, chains, "tanh"),
              "forward_route": forward_route(torch, x, chains, "tanh")})
    # (c): zero rows of x meet a constant first-layer bias, so those rows'
    # pre-LayerNorm values are exactly 0.5: variance 0, s = 1000.
    layers, heads = mule_chains[0]
    w0, _, scale0, bias0 = layers[0]
    const = ((((w0, torch.full_like(scale0, 0.5), scale0, bias0), *layers[1:]), heads), mule_chains[1])
    x = 0.5 * torch.randn((1000, 7), generator=gen, device=dev)
    x[::3] = 0.0
    result = compare_chains(torch, "chains (c, zero variance)", x, const, "relu", seed=7)
    emit({"phase": "kernel_check", "kernel": "chains", "config": "c", "N": 1000, "zero_variance_rows": 334, **result,
          "route": backward_route(torch, x, const, "relu"), "forward_route": forward_route(torch, x, const, "relu")})
    # (e): layers wider than one pass of the tiled forward (two buffers, a
    # LayerNorm a warp per row), narrow heads after a LayerNorm layer and a
    # 9-wide head; its parameters and gradients do not fit the tiled backward.
    wider = random_chains(torch, dev, seed=10, d_in=7,
                          layout=(([(160, True), (136, False)], [2, 9]), ([(136, True)], [1])))
    x = 0.5 * torch.randn((1000, 7), generator=gen, device=dev)
    result = compare_chains(torch, "chains (e, 160/136 wide)", x, wider, "relu", seed=10)
    emit({"phase": "kernel_check", "kernel": "chains", "config": "e", "N": 1000, "widths": [160, 136], **result,
          "route": backward_route(torch, x, wider, "relu", "streaming"),
          "forward_route": forward_route(torch, x, wider, "relu")})
    near = random_chains(torch, dev, seed=8, d_in=7, layout=(([(768, True)], [3]),))
    x = 0.5 * torch.randn((1000, 7), generator=gen, device=dev)
    result = compare_chains(torch, "chains (d, 768 wide)", x, near, "relu", seed=8)
    emit({"phase": "kernel_check", "kernel": "chains", "config": "d", "N": 1000, "width": 768, **result,
          "route": backward_route(torch, x, near, "relu", "streaming"),
          "forward_route": forward_route(torch, x, near, "relu", "streaming")})
    # The size limit is the kernels' own: the main path's chains pass, a
    # 4096-wide layer (whose rows do not fit a block's shared memory) is
    # refused by the query and by the wrapper.
    from rl8_tpu_torch.ops import card_takes_chains

    wide = random_chains(torch, dev, seed=9, d_in=7, layout=(([(4096, True)], [3]),))
    check(card_takes_chains(mule_chains), "chains: the kernels refuse the main path's chains")
    check(not card_takes_chains(wide), "chains: the kernels take a 4096-wide layer")
    try:
        fused_chains_fwd(xs[4096][:16], flatten_chains(wide), chain_structure(wide), "relu")
        refused = False
    except NotImplementedError:
        refused = True
    check(refused, "chains: the wrapper launched a 4096-wide layer")
    emit({"phase": "kernel_check", "kernel": "chains", "width_limit": {"128": True, "4096": False}})

    structure = chain_structure(mule_chains)
    flat = flatten_chains(mule_chains)
    times = {}
    for N, x in xs.items():
        fwd_flops, fwd_bytes, bwd_flops, bwd_bytes = chain_counts(structure, N)
        ms, host_ms = time_ms(torch, lambda: fused_chains_fwd(x, flat, structure, "relu"), iters=50)
        plain_ms, _ = time_ms(torch, lambda: forward_chains(x, mule_chains, "relu"), iters=20)
        times[N] = dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms, bound=bound(fwd_flops, fwd_bytes))
        emit({"phase": "kernel_time", "kernel": "chains_fwd", "N": N, "flops": fwd_flops, "bytes": fwd_bytes,
              "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": times[N]["bound"][0]})
    t = times[32768]
    fwd_record.update(ms=t["ms"], plain_ms=t["plain_ms"], host_ms=t["host_ms"], rollout_ms=times[4096]["ms"],
                      rollout_plain_ms=times[4096]["plain_ms"], rollout_bound_ms=times[4096]["bound"][0])
    update_bounds(fwd_record, *chain_counts(structure, 32768)[:2])
    N, x = 32768, xs[32768]
    _, _, bwd_flops, bwd_bytes = chain_counts(structure, N)
    douts = [torch.randn((N, w), generator=gen, device=dev) for w in (3, 1)]
    ms, host_ms = time_ms(torch, lambda: fused_chains_bwd(x, flat, structure, "relu", douts), iters=20, warmup=2)
    plain_ms, _ = time_ms(torch, lambda: chains_vjp_plain(x, mule_chains, "relu", [douts[:1], douts[1:]]),
                          iters=10, warmup=2)
    bwd_record.update(ms=ms, plain_ms=plain_ms, host_ms=host_ms)
    update_bounds(bwd_record, bwd_flops, bwd_bytes)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_chains_bwd(x, flat, structure, "relu", douts)
        torch.cuda.synchronize()
    split = {e.key[:60]: e.self_device_time_total / 1e3 for e in prof.key_averages() if e.self_device_time_total > 0}
    emit({"phase": "kernel_time", "kernel": "chains_bwd", "N": N, "flops": bwd_flops, "bytes": bwd_bytes,
          "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bwd_record["bound_ms"],
          "bound_tc_ms": bwd_record["bound_tc_ms"], "split_ms": split})


def launched_route(torch, what: str, fn, routes: dict, want: str) -> str:
    """The route that calls of ``fn`` took (``routes`` maps kernel names to
    routes; the kernels that three calls launched, from ``torch.profiler``),
    which must be ``want``. The profiler sometimes returns no record of a
    short launch at all: a window that saw none of the kernels is taken
    again, up to three windows; any kernel it does see counts."""
    from torch.profiler import ProfilerActivity, profile

    took: list = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        took = [route for kernel, route in routes.items() if any(re.search(rf"\b{kernel}\b", n) for n in names)]
        if took:
            break
    check(took == [want], f"{what} took {took}, not the {want} route")
    return want


def backward_route(torch, x, chains, activation: str, want: str = "tiled") -> str:
    """The route the chain backward took on ``chains``, which must be
    ``want``."""
    from rl8_tpu_torch.ops import fused_chains_bwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, flatten_chains

    structure = chain_structure(chains)
    douts = [torch.zeros((x.shape[0], w), device=x.device) for _, heads in structure[1] for w in heads]
    routes = {"chains_bwd_tiles_kernel": "tiled", "chains_bwd_rows_kernel": "streaming"}
    return launched_route(torch, "the chain backward",
                          lambda: fused_chains_bwd(x, flatten_chains(chains), structure, activation, douts),
                          routes, want)


def forward_route(torch, x, chains, activation: str, want: str = "tiled") -> str:
    """The route the chain forward took on ``chains``, which must be
    ``want``."""
    from rl8_tpu_torch.ops import fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, flatten_chains

    routes = {"chains_fwd_tiles_kernel": "tiled", "chains_fwd_kernel": "streaming"}
    return launched_route(
        torch, "the chain forward",
        lambda: fused_chains_fwd(x, flatten_chains(chains), chain_structure(chains), activation), routes, want,
    )


def time_updates(torch, dev, label: str, card: str) -> None:
    """``--time-updates LABEL``: only the update kernels' device ms per
    launch at the main paths' shapes (``time_ms``: the feedforward kernel,
    262,144 rows, categorical and squashed; the recurrent one, 65,536
    sequences of 4 steps, categorical; the recurrent act kernel, 8,192 rows
    of one 256-wide layer; the continuous (squashed) and discrete act
    kernels, 8,192 rows of twin 256-wide torsos; GAE at T = 32 over 8,192
    columns (200 launches); the chain kernels at MischievousMule's 32,768
    minibatch rows, and the forward at 4,096) and the feedforward (both
    kinds), recurrent, recurrent act, both act kernels', chain forward (both
    row counts) and chain backward launches' device time by kernel
    (``torch.profiler``), on one JSON line with
    LABEL and the card. To compare two commits on one card, unpack one into a
    directory that ``.gitignore`` lists (``git archive``) and run each
    checkout's ``chip_smoke.py --time-updates`` in turns (A, B, B, A) in
    one command."""
    from torch.profiler import ProfilerActivity, profile

    from rl8_tpu_torch import ops
    from rl8_tpu_torch.specs import Discrete

    out = {"phase": "time_updates", "label": label, "card": card}
    loss = dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)
    ec = torch.tensor(0.0, device=dev)

    def device_ms(fn) -> float:
        return time_ms(torch, fn, iters=10, warmup=2)[0]

    def split_ms(fn, width: int = 80) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key[:width]: e.self_device_time_total / 1e3
                for e in prof.key_averages() if e.self_device_time_total > 0}

    N = 8192 * 32
    model = make_model(torch, Discrete(2, shape=(1,)), seed=40 + ord("a"))
    params, packed, unpack = ppo_inputs(torch, dev, model, N, seed=ord("a"))
    cfg = ops.PPOLossConfig(clip_param=0.2, n_rows=N, use_entropy=False, **loss)
    out["ppo_ms"] = device_ms(lambda: ops.fused_ppo_grads(params, packed, unpack, ec, cfg))
    out["ppo_split_ms"] = split_ms(lambda: ops.fused_ppo_grads(params, packed, unpack, ec, cfg))
    model = make_continuous_model(torch, 1, seed=80 + ord("a"))
    params, packed, unpack, _ = continuous_ppo_inputs(torch, dev, model, N, seed=ord("a"), squashed=True)
    cfg = ops.PPOLossConfig(clip_param=0.2, n_rows=N, use_entropy=False, squashed=True, **loss)
    out["continuous_ppo_ms"] = device_ms(lambda: ops.fused_ppo_grads(params, packed, unpack, ec, cfg))
    out["continuous_ppo_split_ms"] = split_ms(lambda: ops.fused_ppo_grads(params, packed, unpack, ec, cfg))

    N = 65536
    model = make_rnn_model(torch, "categorical", seed=110 + ord("a"))
    params = ops.pack_rnn_params(model)
    packed, unpack, _ = rnn_ppo_inputs(torch, dev, model, "categorical", N, 4, seed=ord("a"))
    cfg = ops.PPOLossConfig(clip_param=0.2, n_rows=N, use_entropy=False, **loss)
    out["rnn_ppo_ms"] = device_ms(lambda: ops.fused_rnn_ppo_grads(params, packed, unpack, ec, cfg))
    out["rnn_ppo_split_ms"] = split_ms(lambda: ops.fused_rnn_ppo_grads(params, packed, unpack, ec, cfg))
    B, H = 8192, 256
    gen = torch.Generator(device=dev).manual_seed(5)
    obs = 3.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
    states = rnn_states(torch, dev, B, 1, H, gen)
    params = ops.pack_rnn_params(make_rnn_model(torch, "categorical", seed=99))
    out["rnn_act_ms"] = device_ms(lambda: ops.fused_rnn_act(params, obs, states, (1, 2)))
    out["rnn_act_split_ms"] = split_ms(lambda: ops.fused_rnn_act(params, obs, states, (1, 2)))
    # The act kernels at the main paths' shapes (8,192 rows, twin 256-wide
    # relu torsos): the continuous one squashed, and the discrete one, A=1,
    # n=2. The A/B's controls are the kernels whose code a change leaves
    # alone: for PR 9's (the discrete act kernel and GAE), the chain forward,
    # rnn_act and the continuous act kernel.
    obs = 100.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
    params = ops.pack_act_params(make_continuous_model(torch, 1, seed=62), squashed=True)
    out["continuous_act_ms"] = device_ms(lambda: ops.fused_act(params, obs, (1, 2)))
    out["continuous_act_split_ms"] = split_ms(lambda: ops.fused_act(params, obs, (1, 2)))
    params = ops.pack_act_params(make_model(torch, Discrete(2, shape=(1,)), seed=12))
    out["discrete_act_ms"] = device_ms(lambda: ops.fused_act(params, obs, (1, 2)))
    out["discrete_act_split_ms"] = split_ms(lambda: ops.fused_act(params, obs, (1, 2)))
    # GAE at the main path's T = 32 over 8,192 columns.
    rewards = torch.randn((32, B, 1), generator=gen, device=dev)
    values = torch.randn((33, B, 1), generator=gen, device=dev)
    scale = torch.tensor(3.7, device=dev)
    out["gae_ms"] = time_ms(torch, lambda: ops.fused_gae(rewards, values, scale, gamma=0.95, gae_lambda=0.95),
                            iters=200)[0]

    from rl8_tpu_torch.ops.fused_mlp import chain_structure, default_chains, flatten_chains

    chains = default_chains(make_mule(torch, seed=5).to(dev))
    structure, flat = chain_structure(chains), flatten_chains(chains)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = 0.5 * torch.randn((32768, 7), generator=gen, device=dev)
    douts = [torch.randn((32768, w), generator=gen, device=dev) for w in (3, 1)]
    out["chains_fwd_ms"] = device_ms(lambda: ops.fused_chains_fwd(x, flat, structure, "relu"))
    out["chains_fwd_4096_ms"] = device_ms(lambda: ops.fused_chains_fwd(x[:4096], flat, structure, "relu"))
    out["chains_fwd_split_ms"] = split_ms(lambda: ops.fused_chains_fwd(x, flat, structure, "relu"), 60)
    out["chains_fwd_4096_split_ms"] = split_ms(lambda: ops.fused_chains_fwd(x[:4096], flat, structure, "relu"), 60)
    out["chains_bwd_ms"] = device_ms(lambda: ops.fused_chains_bwd(x, flat, structure, "relu", douts))
    out["chains_bwd_split_ms"] = split_ms(lambda: ops.fused_chains_bwd(x, flat, structure, "relu", douts), 60)
    emit(out)


def run_main_path(torch, dev) -> None:
    """The rollout path: collects and the advantage stage."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.nn import generalized_advantage_estimate
    from rl8_tpu_torch.ops import fused_act, fused_gae

    t0 = time.perf_counter()
    algo = AlgorithmConfig(device="cuda").build(DiscreteDummyEnv)
    build_s = time.perf_counter() - t0
    h = algo.hparams
    fused_act.launches = 0
    fused_gae.launches = 0
    algo.collect()  # warm-up
    collect_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = algo.collect()
        collect_ms.append((time.perf_counter() - t) * 1e3)
    advantages, returns = algo._advantages()
    torch.cuda.synchronize()
    act_launches, gae_launches = fused_act.launches, fused_gae.launches
    check(act_launches == 6 * h.horizon, f"act launches {act_launches} != 6 collects x {h.horizon}")
    check(gae_launches == 1, f"GAE launches {gae_launches} != 1 advantage call")

    buffer = algo.state.buffer
    T, B = h.horizon, h.num_envs
    shapes = {
        DataKeys.OBS: (T + 1, B, 1), DataKeys.ACTIONS: (T, B, 1), DataKeys.LOGP: (T, B, 1),
        DataKeys.VALUES: (T + 1, B, 1), DataKeys.REWARDS: (T, B, 1),
        DataKeys.REVERSED_DISCOUNTED_RETURNS: (T + 1, B, 1),
    }
    for key, shape in shapes.items():
        check(tuple(buffer[key].shape) == shape, f"buffer {key} shape {tuple(buffer[key].shape)}")
        check(bool(torch.isfinite(buffer[key].float()).all()), f"buffer {key} finite")
    check(bool(((buffer[DataKeys.ACTIONS] >= 0) & (buffer[DataKeys.ACTIONS] < 2)).all()), "actions in range")
    check(all(math.isfinite(v) for v in stats.values()), "collect stats finite")
    for name, x in (("advantages", advantages), ("returns", returns)):
        check(tuple(x.shape) == (T, B, 1) and bool(torch.isfinite(x).all()), f"{name} shape/finite")
    ref_adv, ref_ret = generalized_advantage_estimate(
        buffer[DataKeys.REWARDS], buffer[DataKeys.VALUES], gamma=h.gamma,
        gae_lambda=h.gae_lambda, reward_scale=algo.state.reward_scale,
    )
    check(torch.allclose(advantages, ref_adv, rtol=GAE_RTOL, atol=GAE_ATOL), "advantages vs reference")
    check(torch.allclose(returns, ref_ret, rtol=GAE_RTOL, atol=GAE_ATOL * 10), "returns vs reference")
    ms = sorted(collect_ms)[len(collect_ms) // 2]
    emit({
        "phase": "main_path", "num_envs": B, "horizon": T, "hiddens": list(algo.policy.model.hiddens),
        "build_s": build_s, "collect_ms": collect_ms, "collect_ms_median": ms,
        "transitions_per_s": B * T / (ms / 1e3), "act_launches": act_launches,
        "gae_launches": gae_launches, "reward_scale": float(algo.state.reward_scale),
        "returns_mean": stats["returns/mean"],
    })

    def rollout():
        algo.collect()
        algo._advantages()

    profile_window(torch, "collect + advantages", rollout)


def zero_counters() -> None:
    """Set every kernel wrapper's launch counters to 0."""
    from rl8_tpu_torch.ops import (
        fused_act,
        fused_chains_bwd,
        fused_chains_fwd,
        fused_gae,
        fused_ppo_grads,
        fused_rnn_act,
        fused_rnn_ppo_grads,
    )

    for fn in (fused_act, fused_ppo_grads, fused_rnn_act, fused_rnn_ppo_grads):
        fn.launches = fn.continuous_launches = 0
    for fn in (fused_gae, fused_chains_fwd, fused_chains_bwd):
        fn.launches = 0


def time_iterations(torch, algo, iters: int = 6) -> tuple[list, list, list]:
    """``iters`` collect() + step() iterations of ``algo`` with the
    kernels' launch counters set to 0 first and the peak memory reset;
    returns the host ms of each collect and step after the first (the
    warm-up), each ending in its call's one host fetch, and every step's
    stats."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    collect_ms, step_ms, steps = [], [], []
    for i in range(iters):
        t = time.perf_counter()
        algo.collect()
        t_mid = time.perf_counter()
        steps.append(algo.step())
        t_end = time.perf_counter()
        if i:
            collect_ms.append((t_mid - t) * 1e3)
            step_ms.append((t_end - t_mid) * 1e3)
    return collect_ms, step_ms, steps


def run_update_path(torch, dev, kernels: dict, continuous: bool = False) -> None:
    """A main path with the update: collect() + step() at the defaults,
    one warm-up and five timed iterations; every kernel of the path must
    have launched (act 32, GAE 1, update 4 per iteration). The discrete
    path is ``DiscreteDummyEnv`` with ``Categorical``; the continuous one
    the JAX package's second headline config, ``ContinuousDummyEnv`` with
    ``SquashedNormal``, gamma 0.99, lambda 0.95 and no entropy bonus."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.distributions import SquashedNormal
    from rl8_tpu_torch.env import ContinuousDummyEnv, DiscreteDummyEnv
    from rl8_tpu_torch.ops import fused_act, fused_gae, fused_ppo_grads

    if continuous:
        algo = AlgorithmConfig(device="cuda", distribution_cls=SquashedNormal, gamma=0.99, gae_lambda=0.95,
                               entropy_coeff=0.0).build(ContinuousDummyEnv)
        names, counters = ("continuous_act", "gae", "continuous_ppo"), "continuous_launches"
    else:
        algo = AlgorithmConfig(device="cuda").build(DiscreteDummyEnv)
        names, counters = ("act", "gae", "ppo"), "launches"
    wrappers = (fused_act, fused_gae, fused_ppo_grads)
    h = algo.hparams
    n_params = sum(p.numel() for p in algo.policy.model.parameters())
    iters = 6
    collect_ms, step_ms, steps = time_iterations(torch, algo, iters)
    act, gae, ppo = (getattr(fn, "launches" if fn is fused_gae else counters) for fn in wrappers)
    other = (fused_act.launches + fused_ppo_grads.launches if continuous
             else fused_act.continuous_launches + fused_ppo_grads.continuous_launches)
    launches = dict(zip(names, (act, gae, ppo)))
    for key, count in launches.items():
        kernels[key]["launches"] = count
    per_step = h.num_sgd_iters * h.num_minibatches
    check(act == iters * h.horizon, f"act launches {act} != {iters} x {h.horizon}")
    check(gae == iters, f"GAE launches {gae} != {iters} steps")
    check(ppo == iters * per_step, f"update launches {ppo} != {iters} x {per_step}")
    check(other == 0, f"{other} launches of the other distribution family's kernels")
    for stats in steps:
        check(all(math.isfinite(v) for v in stats.values()), f"step stats finite: {stats}")
    for name, param in algo.policy.model.named_parameters():
        check(bool(torch.isfinite(param).all()), f"parameter {name} finite")
    check(tuple(algo.policy.model.vf_model.layers[1].weight.shape) == (256, 256), "torso width")
    check(not algo.state.buffered and int(algo.state.opt_state.count) == iters * per_step,
          "the buffer is spent and Adam counted every update")
    med_collect = sorted(collect_ms)[len(collect_ms) // 2]
    med_step = sorted(step_ms)[len(step_ms) // 2]
    emit({
        "phase": "main_path_continuous" if continuous else "main_path_update",
        "num_envs": h.num_envs, "horizon": h.horizon,
        "hiddens": list(algo.policy.model.hiddens), "num_sgd_iters": h.num_sgd_iters,
        "num_minibatches": h.num_minibatches, "parameters": n_params,
        "collect_ms": collect_ms, "step_ms": step_ms,
        "collect_ms_median": med_collect, "step_ms_median": med_step,
        "transitions_per_s_with_update": h.num_envs * h.horizon / ((med_collect + med_step) / 1e3),
        "launches": launches, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "last_step": steps[-1],
    })
    algo.collect()
    actions = algo.state.buffer[DataKeys.ACTIONS]
    check(bool(torch.isfinite(actions).all()), "buffer actions finite")
    if continuous:
        check(actions.dtype == torch.float32 and bool((actions.abs() <= 1.0).all()),
              "squashed actions are f32 in [-1, 1]")
    profile_window(torch, "continuous step" if continuous else "step", algo.step)


def run_repaired_routes(torch, dev) -> None:
    """The routes ``rl8_tpu`` takes for default models off the kernels, at
    the discrete cell's width (``DiscreteDummyEnv``, 8192 envs, horizon 32,
    twin 256-wide torsos, a whole-buffer minibatch, 4 epochs), one collect
    and one step each with the launch counters set to 0 just before and
    read just after: a ``gelu`` torso collects through the module rollout
    and steps through autograd (no act or update launch); with
    ``fused_act=False`` the module rollout feeds the update kernel (4
    launches, no act launch)."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.ops import fused_act, fused_gae, fused_ppo_grads

    for name, kw in (("gelu", {"model_config": {"activation_fn": "gelu"}}), ("fused_act_off", {"fused_act": False})):
        algo = AlgorithmConfig(device="cuda", **kw).build(DiscreteDummyEnv)
        h = algo.hparams
        per_step = h.num_sgd_iters * h.num_minibatches
        fused = (algo._fused_act, algo._fused_update)
        check(fused == ((False, False) if name == "gelu" else (False, True)), f"{name}: routes {fused}")
        torch.cuda.synchronize()
        zero_counters()
        t = time.perf_counter()
        collect = algo.collect()
        t_mid = time.perf_counter()
        stats = algo.step()
        t_end = time.perf_counter()
        launches = {"act": fused_act.launches + fused_act.continuous_launches, "gae": fused_gae.launches,
                    "ppo": fused_ppo_grads.launches + fused_ppo_grads.continuous_launches}
        want = {"act": 0, "gae": 1, "ppo": 0 if name == "gelu" else per_step}
        check(launches == want, f"{name}: launches {launches} != {want}")
        check(all(math.isfinite(v) for v in (*collect.values(), *stats.values())), f"{name}: stats finite")
        for pname, param in algo.policy.model.named_parameters():
            check(bool(torch.isfinite(param).all()), f"{name}: parameter {pname} finite")
        check(not algo.state.buffered and int(algo.state.opt_state.count) == per_step,
              f"{name}: the buffer is spent and Adam counted every update")
        emit({"phase": "main_path_repaired_route", "route": name, "num_envs": h.num_envs, "horizon": h.horizon,
              "hiddens": list(algo.policy.model.hiddens), "activation": algo.policy.model.activation_fn,
              "fused_act": fused[0], "fused_update": fused[1], "launches": launches,
              "collect_ms": (t_mid - t) * 1e3, "step_ms": (t_end - t_mid) * 1e3, "step": stats})


def run_recurrent_path(torch, dev, kernels: dict) -> None:
    """The recurrent main path: ``RecurrentAlgorithmConfig(device="cuda")
    .build(DiscreteDummyEnv)`` at the JAX package's defaults, one warm-up
    and five timed collect() + step() iterations; every kernel of the path
    must have launched (recurrent act 32, GAE 1, recurrent update 4 per
    iteration) and no other. Then one more collect, whose log-probs and
    values are held against the module's plain forward from the stored
    states, and a profiled collect and step."""
    from rl8_tpu_torch import RecurrentAlgorithmConfig
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.distributions import Categorical
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.ops import fused_act, fused_gae, fused_ppo_grads, fused_rnn_act, fused_rnn_ppo_grads

    algo = RecurrentAlgorithmConfig(device="cuda").build(DiscreteDummyEnv)
    h = algo.hparams
    model = algo.policy.model
    n_params = sum(p.numel() for p in model.parameters())
    iters = 6
    collect_ms, step_ms, steps = time_iterations(torch, algo, iters)
    act, gae, ppo = fused_rnn_act.launches, fused_gae.launches, fused_rnn_ppo_grads.launches
    other = (fused_rnn_act.continuous_launches + fused_rnn_ppo_grads.continuous_launches + fused_act.launches
             + fused_act.continuous_launches + fused_ppo_grads.launches + fused_ppo_grads.continuous_launches)
    kernels["rnn_act"]["launches"], kernels["rnn_ppo"]["launches"] = act, ppo
    per_step = h.num_sgd_iters * h.num_minibatches
    check(act == iters * h.horizon, f"recurrent act launches {act} != {iters} x {h.horizon}")
    check(gae == iters, f"GAE launches {gae} != {iters} steps")
    check(ppo == iters * per_step, f"recurrent update launches {ppo} != {iters} x {per_step}")
    check(other == 0, f"{other} launches of other kernels on the recurrent path")
    for stats in steps:
        check(all(math.isfinite(v) for v in stats.values()), f"step stats finite: {stats}")
    for name, param in model.named_parameters():
        check(bool(torch.isfinite(param).all()), f"parameter {name} finite")
    check(tuple(model.lstm.wh[0].shape) == (256, 1024) and model.num_layers == 1, "LSTM width")
    check(all(v.device.type == "cuda" for v in algo.policy.init_states(4).values()),
          "policy.init_states(4) lies on the model's card")
    check(not algo.state.buffered and int(algo.state.opt_state.count) == iters * per_step,
          "the buffer is spent and Adam counted every update")
    check(algo.state.seqs == iters * h.horizon // h.seq_len, f"sequence counter {algo.state.seqs}")
    med_collect = sorted(collect_ms)[len(collect_ms) // 2]
    med_step = sorted(step_ms)[len(step_ms) // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # The rollout against the module: per step, the plain forward from the
    # stored input states gives the values and the log-probs of the
    # stored actions, and the stored next states.
    algo.collect()
    buffer = algo.state.buffer
    T, B = h.horizon, h.num_envs
    states = buffer[DataKeys.STATES]
    check(tuple(states[DataKeys.HIDDEN_STATES].shape) == (T + 1, B, 1, 256), "buffer states shape")
    worst = 0.0
    with torch.no_grad():
        for t in range(T):
            step_states = {k: v[t] for k, v in states.items()}
            (features, values), new_states = model({DataKeys.OBS: buffer[DataKeys.OBS][t][:, None]}, step_states)
            logp = Categorical(features).logp(buffer[DataKeys.ACTIONS][t])
            for what, got, want in (("values", buffer[DataKeys.VALUES][t], values),
                                    ("logp", buffer[DataKeys.LOGP][t], logp)):
                worst = max(worst, float((got - want).abs().max()))
                check(torch.allclose(got, want, rtol=ACT_RTOL, atol=ACT_ATOL), f"recurrent rollout {what} at t={t}")
            if (t + 1) % h.seq_len or ((t + 1) // h.seq_len + algo.state.seqs - T // h.seq_len) % h.seqs_per_state_reset:
                for k, v in new_states.items():
                    check(torch.allclose(states[k][t + 1], v, rtol=ACT_RTOL, atol=ACT_ATOL),
                          f"recurrent rollout {k} at t={t + 1}")
    emit({
        "phase": "main_path_recurrent", "num_envs": B, "horizon": T, "seq_len": h.seq_len,
        "hidden_size": model.hidden_size, "num_layers": model.num_layers,
        "sequences_per_minibatch": B * T // h.seq_len // h.num_minibatches,
        "num_sgd_iters": h.num_sgd_iters, "num_minibatches": h.num_minibatches, "parameters": n_params,
        "collect_ms": collect_ms, "step_ms": step_ms, "collect_ms_median": med_collect,
        "step_ms_median": med_step,
        "transitions_per_s_with_update": B * T / ((med_collect + med_step) / 1e3),
        "launches": {"rnn_act": act, "gae": gae, "rnn_ppo": ppo}, "peak_memory_gb": peak_gb,
        "rollout_vs_module_max_abs_err": worst, "last_step": steps[-1],
    })
    profile_window(torch, "recurrent collect", algo.collect)
    profile_window(torch, "recurrent step", algo.step)


def run_custom_path(torch, dev, kernels: dict, num_envs: int = 4096, sgd_minibatch_size: int = 32768) -> None:
    """The custom-model main path: ``AlgorithmConfig(model_cls=MischievousMule,
    fused_forward=True, num_envs=4096, horizon=32, sgd_minibatch_size=32768,
    device="cuda").build(AlgoTrading)`` (the JAX package's algotrading bench
    shape at the model's defaults, in f32), one warm-up and five timed
    collect() + step() iterations. Per iteration the chain forward must
    launch 49 times (32 steps and the bootstrap value, 4 epochs x 4
    minibatches), the backward 16, GAE once, and no act or update kernel.
    Then one more collect, whose log-probs and values are held against the
    module forward on the training views of its buffer (the rollout's view
    windows must equal them), a profiled collect and step, and the same
    timing with ``fused_forward=False`` (module forward, autograd on
    cuBLAS), which must launch no chain kernel."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.algorithms._feedforward import _t2b
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.distributions import Categorical
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule
    from rl8_tpu_torch.ops import (
        fused_act,
        fused_chains_bwd,
        fused_chains_fwd,
        fused_gae,
        fused_ppo_grads,
        fused_rnn_act,
        fused_rnn_ppo_grads,
    )

    iters = 6
    phases = {}
    for fused in (True, False):
        algo = AlgorithmConfig(model_cls=MischievousMule, fused_forward=fused, num_envs=num_envs, horizon=32,
                               sgd_minibatch_size=sgd_minibatch_size, device=dev).build(AlgoTrading)
        h = algo.hparams
        model = algo.policy.model
        check(algo._fused_forward == fused, f"fused_forward={fused} but the algorithm's is {algo._fused_forward}")
        check(model.hiddens == (128, 128) and h.num_minibatches == 4 and h.num_sgd_iters == 4, "custom path shape")
        collect_ms, step_ms, steps = time_iterations(torch, algo, iters)
        fwd, bwd, gae = fused_chains_fwd.launches, fused_chains_bwd.launches, fused_gae.launches
        other = sum(fn.launches + fn.continuous_launches
                    for fn in (fused_act, fused_ppo_grads, fused_rnn_act, fused_rnn_ppo_grads))
        per_step = h.num_sgd_iters * h.num_minibatches
        want = (iters * (h.horizon + 1 + per_step), iters * per_step) if fused else (0, 0)
        check((fwd, bwd) == want, f"chain launches (fwd, bwd) {(fwd, bwd)} != {want}")
        check(gae == iters and other == 0, f"GAE launches {gae}, other kernels {other}")
        for stats in steps:
            check(all(math.isfinite(v) for v in stats.values()), f"step stats finite: {stats}")
        for name, param in model.named_parameters():
            check(bool(torch.isfinite(param).all()), f"parameter {name} finite")
        check(not algo.state.buffered and int(algo.state.opt_state.count) == iters * per_step,
              "the buffer is spent and Adam counted every update")
        med_collect = sorted(collect_ms)[len(collect_ms) // 2]
        med_step = sorted(step_ms)[len(step_ms) // 2]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if fused:
            kernels["chains_fwd"]["launches"], kernels["chains_bwd"]["launches"] = fwd, bwd
            # The rollout against the module on the buffer's training views.
            algo.collect()
            buffer = algo.state.buffer
            with torch.no_grad():
                features, values = model(algo._training_views(buffer[DataKeys.OBS]))
                logp = Categorical(features).logp(_t2b(buffer[DataKeys.ACTIONS]))
            worst = 0.0
            for what, got, want_t in (("logp", _t2b(buffer[DataKeys.LOGP]), logp),
                                      ("values", _t2b(buffer[DataKeys.VALUES][:-1]), values)):
                worst = max(worst, float((got - want_t).abs().max()))
                check(torch.allclose(got, want_t, rtol=ACT_RTOL, atol=ACT_ATOL), f"custom rollout {what} vs module")
            masked = features["logits"] < -1e37
            check(bool((masked == ~buffer[DataKeys.OBS]["action_mask"][:-1].transpose(0, 1).reshape(-1, 1, 3)).all()),
                  "masked logits are exactly the masked actions")
            profile_window(torch, "custom collect", algo.collect)
            profile_window(torch, "custom step", algo.step)
        phases[fused] = {
            "collect_ms": collect_ms, "step_ms": step_ms, "collect_ms_median": med_collect,
            "step_ms_median": med_step,
            "transitions_per_s_with_update": h.num_envs * h.horizon / ((med_collect + med_step) / 1e3),
            "launches": {"chains_fwd": fwd, "chains_bwd": bwd, "gae": gae}, "peak_memory_gb": peak_gb,
            "last_step": steps[-1],
        }
        emit({"phase": "main_path_custom" if fused else "main_path_custom_module",
              "model": "MischievousMule", "env": "AlgoTrading", "fused_forward": fused, "num_envs": h.num_envs,
              "horizon": h.horizon, "hiddens": list(model.hiddens), "num_sgd_iters": h.num_sgd_iters,
              "num_minibatches": h.num_minibatches, "parameters": sum(p.numel() for p in model.parameters()),
              **({"rollout_vs_module_max_abs_err": worst} if fused else {}), **phases[fused]})
        if not fused:
            algo.collect()
            profile_window(torch, "custom module step", algo.step)


def check_small_custom_against_cpu(torch, dev) -> None:
    """MischievousMule (16-wide torsos, fused_forward) on AlgoTrading, 64
    envs, horizon 8, on the card and on the CPU (the kernels' plain
    versions) from one seed and the same start states: two deterministic
    collects (the second carrying over) and one whole-buffer step."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule
    from rl8_tpu_torch.models import lecun_normal_
    from rl8_tpu_torch.views import tree_map

    class FixedStart(AlgoTrading):
        def reset(self, generator, *, state=None, config=None):
            s, o = AlgoTrading(self.num_envs, self.horizon, device="cpu").reset(torch.Generator().manual_seed(5))
            return tree_map(lambda t: t.to(self.device), s), tree_map(lambda t: t.to(self.device), o)

    runs = {}
    for device in ("cuda", "cpu"):
        algo = AlgorithmConfig(model_cls=MischievousMule, model_config={"hiddens": (16, 16)}, fused_forward=True,
                               num_envs=64, horizon=8, horizons_per_env_reset=2, seed=7,
                               device=device).build(FixedStart)
        with torch.no_grad():  # logits far from ties, the same on both
            w = torch.empty_like(algo.policy.model.feature_head.weight, device="cpu")
            lecun_normal_(w, torch.Generator().manual_seed(11))
            algo.policy.model.feature_head.weight.copy_(w)
        stats = [algo.collect(deterministic=True), algo.collect(deterministic=True)]
        buffer = {k: tree_map(lambda t: t.cpu(), v) for k, v in algo.state.buffer.items()}
        start = algo._flat_params().cpu()
        runs[device] = (stats, buffer, algo.step(), algo._flat_params().cpu() - start)
    (s_g, b_g, st_g, d_g), (s_c, b_c, st_c, d_c) = runs["cuda"], runs["cpu"]
    check(torch.equal(b_g[DataKeys.ACTIONS], b_c[DataKeys.ACTIONS]), "small custom run actions equal")
    for key in ("action_mask", "invested"):
        check(torch.equal(b_g[DataKeys.OBS][key], b_c[DataKeys.OBS][key]), f"small custom run obs {key}")
    for key in ("LOG_CHANGE(price)", "LOG_CHANGE(price, position)"):
        check(torch.allclose(b_g[DataKeys.OBS][key], b_c[DataKeys.OBS][key], rtol=ACT_RTOL, atol=1e-6),
              f"small custom run obs {key}")
    for key in (DataKeys.LOGP, DataKeys.VALUES, DataKeys.REWARDS, DataKeys.REVERSED_DISCOUNTED_RETURNS):
        check(torch.allclose(b_g[key], b_c[key], rtol=ACT_RTOL, atol=ACT_ATOL), f"small custom run {key}")
    for sg, sc in zip(s_g, s_c):
        for k in sg:
            if k.startswith(("returns/", "rewards/")):
                check(math.isclose(sg[k], sc[k], rel_tol=1e-4, abs_tol=1e-4), f"small custom run stat {k}")
    for k in ("losses/entropy", "losses/policy", "losses/vf", "losses/total", "monitors/kl_div"):
        check(math.isclose(st_g[k], st_c[k], rel_tol=1e-4, abs_tol=1e-6),
              f"small custom run step {k}: {st_g[k]} vs {st_c[k]}")
    delta_err = float((d_g - d_c).norm() / d_c.norm())
    check(delta_err <= 1e-3, f"small custom run parameter change differs by {delta_err:.3g} of its norm")
    emit({"phase": "small_custom_vs_cpu", "num_envs": 64, "horizon": 8, "collects": 2, "steps": 1,
          "logp_max_abs_err": float((b_g[DataKeys.LOGP] - b_c[DataKeys.LOGP]).abs().max()),
          "values_max_abs_err": float((b_g[DataKeys.VALUES] - b_c[DataKeys.VALUES]).abs().max()),
          "step_loss_max_abs_err": max(abs(st_g[k] - st_c[k]) for k in st_c if k.startswith("losses/")),
          "param_change_norm_rel_err": delta_err})


def profile_window(torch, window: str, fn) -> None:
    """Device time by kernel over one call of ``fn``, from
    ``torch.profiler``; the busy share is the summed device time over the
    host wall time of the profiled window (the profiler's own host
    overhead lengthens that window)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if getattr(e, "self_device_time_total", 0) > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit({
        "phase": "profile", "window": window, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
        "top": [{"name": name[:80], "ms": ms, "count": count} for name, ms, count in rows[:10]],
    })


def check_learning(torch, dev) -> None:
    """The verify recipe's learning drive on the card: 256 envs, horizon
    16, seed 1, 30 collect+step iterations with bounds 10; the greedy
    policy must move every position toward the origin."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.env import DiscreteDummyEnv

    t = time.perf_counter()
    algo = AlgorithmConfig(num_envs=256, horizon=16, seed=1, device="cuda").build(DiscreteDummyEnv)
    for _ in range(30):
        collect_stats = algo.collect(env_config={"bounds": 10.0})
        algo.step()
    obs = torch.tensor([[[5.0]], [[-5.0]], [[2.0]], [[-2.0]]], device=dev)
    out = algo.policy.sample({DataKeys.OBS: obs}, kind="last", deterministic=True)
    actions = out[DataKeys.ACTIONS].ravel().tolist()
    check(actions == [0, 1, 0, 1], f"the policy did not learn: greedy actions {actions}")
    emit({"phase": "learning", "iterations": 30, "greedy_actions": actions,
          "final_returns_mean": collect_stats["returns/mean"], "seconds": time.perf_counter() - t})


def check_learning_continuous(torch, dev) -> None:
    """The learning drive for the continuous env with SquashedNormal: 256
    envs, horizon 16, seed 1, 30 collect+step iterations with bounds 10
    (on the CPU both rl8_tpu and the port reach it from the first
    iteration on, for seeds 1-3); the greedy action must point toward the
    origin at [5, -5, 2, -2], with magnitude above 0.5 at +-5 (both
    packages reach above 0.79 there)."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.distributions import SquashedNormal
    from rl8_tpu_torch.env import ContinuousDummyEnv

    t = time.perf_counter()
    algo = AlgorithmConfig(num_envs=256, horizon=16, seed=1, distribution_cls=SquashedNormal,
                           device="cuda").build(ContinuousDummyEnv)
    for _ in range(30):
        collect_stats = algo.collect(env_config={"bounds": 10.0})
        algo.step()
    obs = torch.tensor([[[5.0]], [[-5.0]], [[2.0]], [[-2.0]]], device=dev)
    out = algo.policy.sample({DataKeys.OBS: obs}, kind="last", deterministic=True)
    actions = out[DataKeys.ACTIONS].ravel().tolist()
    signs = [math.copysign(1.0, a) for a in actions]
    check(signs == [-1.0, 1.0, -1.0, 1.0] and min(abs(actions[0]), abs(actions[1])) > 0.5,
          f"the continuous policy did not learn: greedy actions {actions}")
    emit({"phase": "learning_continuous", "iterations": 30, "greedy_actions": actions,
          "final_returns_mean": collect_stats["returns/mean"], "seconds": time.perf_counter() - t})


def check_learning_recurrent(torch, dev) -> None:
    """The recurrent learning drive of the JAX package's tests on the card:
    64 envs, horizon 16, seq_len 4, states reset every 4 sequences, one
    16-wide LSTM layer, seed 1, 15 collect+step iterations with bounds 10;
    the mean return of the last collect must exceed the first's."""
    from rl8_tpu_torch import RecurrentAlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv

    t = time.perf_counter()
    algo = RecurrentAlgorithmConfig(num_envs=64, horizon=16, seq_len=4, seqs_per_state_reset=4, seed=1,
                                    model_config={"hidden_size": 16}, device="cuda").build(DiscreteDummyEnv)
    returns = []
    for _ in range(15):
        returns.append(algo.collect(env_config={"bounds": 10.0})["returns/mean"])
        algo.step()
    check(returns[-1] > returns[0], f"the recurrent policy did not learn: mean returns {returns}")
    emit({"phase": "learning_recurrent", "iterations": 15, "returns_mean": returns,
          "seconds": time.perf_counter() - t})


def check_small_against_cpu(torch, dev, continuous: bool = False, recurrent: bool = False) -> None:
    """The same small configuration on the card and on the CPU (the
    kernels' plain versions), from one seed and the same start positions:
    two stochastic collects (the second carrying over), the advantage
    stage and one step (whole-buffer minibatch, so no shuffle) must
    agree. The discrete run's observations and actions are equal; the
    continuous run (Normal) draws the same noise on both, but its f32
    actions move the positions, so both are held to the act tolerances.
    The recurrent runs (one 32-wide LSTM layer, seq_len 4, states reset
    every 2 sequences) also compare the stored states."""
    from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.distributions import Normal
    from rl8_tpu_torch.env import ContinuousDummyEnv, DiscreteDummyEnv
    from rl8_tpu_torch.ops import pack_rnn_params
    from rl8_tpu_torch.ops.fused_mlp import default_chains, flatten_chains

    class FixedStartEnv(ContinuousDummyEnv if continuous else DiscreteDummyEnv):
        def reset(self, generator, *, state=None, config=None):
            pos = torch.linspace(-50.0, 50.0, self.num_envs).view(-1, 1).to(self.device)
            return {"position": pos, "bounds": torch.tensor(50.0, device=self.device)}, pos

    def flat_params(model):
        if recurrent:
            return pack_rnn_params(model).flat.cpu()
        return flatten_chains(default_chains(model)).cpu()

    runs, steps = {}, {}
    for device in ("cuda", "cpu"):
        common = dict(num_envs=64, horizon=8, horizons_per_env_reset=2, seed=7, device=device,
                      distribution_cls=Normal if continuous else None)
        if recurrent:
            config = RecurrentAlgorithmConfig(model_config={"hidden_size": 32}, seq_len=4, seqs_per_state_reset=2,
                                              **common)
        else:
            config = AlgorithmConfig(model_config={"hiddens": (32, 32)}, **common)
        algo = config.build(FixedStartEnv)
        stats = [algo.collect(), algo.collect()]
        adv, ret = algo._advantages()
        buffer = {k: v.cpu() for k, v in algo.state.buffer.items() if k != DataKeys.STATES}
        if recurrent:
            buffer.update({k: v.cpu() for k, v in algo.state.buffer[DataKeys.STATES].items()})
        runs[device] = (stats, buffer, adv.cpu(), ret.cpu(), algo.state.reward_scale.cpu())
        start = flat_params(algo.policy.model)
        steps[device] = (algo.step(), flat_params(algo.policy.model) - start)
    (s_g, b_g, a_g, r_g, sc_g), (s_c, b_c, a_c, r_c, sc_c) = runs["cuda"], runs["cpu"]
    if recurrent:
        for key in (DataKeys.HIDDEN_STATES, DataKeys.CELL_STATES):
            check(torch.allclose(b_g[key], b_c[key], rtol=ACT_RTOL, atol=ACT_ATOL), f"small recurrent run {key}")
    for key in (DataKeys.OBS, DataKeys.ACTIONS):
        if continuous:
            check(torch.allclose(b_g[key], b_c[key], rtol=ACT_RTOL, atol=ACT_ATOL), f"small run {key}")
        else:
            check(torch.equal(b_g[key], b_c[key]), f"small run {key} equal on card and CPU")
    for key in (DataKeys.LOGP, DataKeys.VALUES, DataKeys.REWARDS, DataKeys.REVERSED_DISCOUNTED_RETURNS):
        check(torch.allclose(b_g[key], b_c[key], rtol=ACT_RTOL, atol=ACT_ATOL), f"small run {key}")
    check(torch.allclose(sc_g, sc_c, rtol=1e-5), "small run reward scale")
    check(torch.allclose(a_g, a_c, rtol=1e-4, atol=1e-4), "small run advantages")
    check(torch.allclose(r_g, r_c, rtol=1e-4, atol=1e-4), "small run returns")
    for sg, sc in zip(s_g, s_c):
        for k in sg:
            if k.startswith(("returns/", "rewards/")):
                check(math.isclose(sg[k], sc[k], rel_tol=1e-4, abs_tol=1e-4), f"small run stat {k}")
    # The step: f32 on both sides with other summation orders (the
    # kernel's blocked sums against ATen's), ~1e-6 relative in the
    # gradients; Adam divides each gradient by its own magnitude, so the
    # parameters are held by a norm-relative error of their change.
    (st_g, d_g), (st_c, d_c) = steps["cuda"], steps["cpu"]
    for k in ("losses/entropy", "losses/policy", "losses/vf", "losses/total", "monitors/kl_div"):
        check(math.isclose(st_g[k], st_c[k], rel_tol=1e-4, abs_tol=1e-6), f"small run step {k}: {st_g[k]} vs {st_c[k]}")
    delta_err = float((d_g - d_c).norm() / d_c.norm())
    check(delta_err <= 1e-3, f"small run parameter change differs by {delta_err:.3g} of its norm")
    phase = "small_" + ("recurrent_" if recurrent else "") + ("continuous_" if continuous else "") + "vs_cpu"
    emit({"phase": phase, "num_envs": 64,
          "horizon": 8, "collects": 2, "steps": 1,
          "logp_max_abs_err": float((b_g[DataKeys.LOGP] - b_c[DataKeys.LOGP]).abs().max()),
          "advantages_max_abs_err": float((a_g - a_c).abs().max()),
          "step_loss_max_abs_err": max(abs(st_g[k] - st_c[k]) for k in st_c if k.startswith("losses/")),
          "param_change_norm_rel_err": delta_err, "param_max_abs_err": float((d_g - d_c).abs().max())})


#: The README quick start's config (``DiscreteDummyEnv``, 8192 envs,
#: horizon 32, gamma 0.95, the default twin 256-wide model) and the
#: classic-control examples' committed configs
#: (``rl8_tpu_torch/examples/*/config.yaml``; the tests hold these copies
#: equal to them), all on the card. They go to the CLI as JSON, so the
#: script needs no PyYAML.
QUICK_START = {"env_cls": "rl8_tpu_torch.env.DiscreteDummyEnv",
               "algorithm_config": {"horizon": 32, "num_envs": 8192, "gamma": 0.95}}
EXAMPLE_CONFIGS = {
    "cartpole": {"env_cls": "rl8_tpu_torch.examples.cartpole.env.CartPole",
                 "algorithm_config": {"horizon": 64, "num_envs": 1024}},
    "pendulum": {"env_cls": "rl8_tpu_torch.examples.pendulum.env.Pendulum",
                 "algorithm_config": {"horizon": 128, "horizons_per_env_reset": 4, "num_envs": 1024}},
    "mountain_car": {"env_cls": "rl8_tpu_torch.examples.mountain_car.env.MountainCar",
                     "algorithm_config": {"horizon": 64, "num_envs": 1024}},
}
#: What each example's update launches get besides the default model's
#: twin 256-wide torsos and the default loss: obs dim, action components
#: and categories (0: continuous) and distribution kind. The update checks
#: (check_ppo, check_continuous_ppo) hold the kernels at these shapes with
#: example_rows rows; run_examples_path asserts that the CLI's runs match.
EXAMPLE_UPDATES = {
    "cartpole": dict(obs_dim=5, A=1, n=3, kind="categorical"),
    "pendulum": dict(obs_dim=3, A=1, n=0, kind="normal"),
    "mountain_car": dict(obs_dim=2, A=1, n=3, kind="categorical"),
}


def example_rows(name: str) -> int:
    """Rows per update launch of an example's config: the whole buffer,
    since ``sgd_minibatch_size`` defaults to num_envs x horizon."""
    c = EXAMPLE_CONFIGS[name]["algorithm_config"]
    return c["num_envs"] * c["horizon"]


def train_cli(torch, tmp: Path, name: str, config: dict, *flags: str):
    """``rl8_tpu_torch.__main__.main(["train", "-f", <config as JSON>,
    "--track-dir", <dir>, *flags])`` in this process, with the kernels'
    launch counters set to 0 just before and read just after. Returns
    the exit code, the trainer the CLI built, the tracked records and the
    launch counts."""
    from rl8_tpu_torch.__main__ import main as cli
    from rl8_tpu_torch.ops import fused_act, fused_gae, fused_ppo_grads
    from rl8_tpu_torch.trainers import TrainConfig, tracking

    path, track = tmp / f"{name}.json", tmp / f"{name}-track"
    path.write_text(json.dumps(config))
    built = []
    build = TrainConfig.build

    def recording_build(self):
        built.append(build(self))
        return built[-1]

    TrainConfig.build = recording_build
    default_run = tracking.get_default_run()
    try:
        torch.cuda.synchronize()
        zero_counters()
        rc = cli(["train", "-f", str(path), "--track-dir", str(track), *flags])
        torch.cuda.synchronize()
        launches = {"act": fused_act.launches, "continuous_act": fused_act.continuous_launches,
                    "gae": fused_gae.launches, "ppo": fused_ppo_grads.launches,
                    "continuous_ppo": fused_ppo_grads.continuous_launches}
    finally:
        # The CLI sets the process's default tracking run to its JSONL run.
        TrainConfig.build = build
        tracking.set_default_run(default_run)
    check(len(built) == 1, f"{name}: the CLI built {len(built)} trainers")
    records = [json.loads(line) for line in (track / "metrics.jsonl").read_text().splitlines()]
    return rc, built[0], records, launches


def cpu_tensors(torch, tree, path: str = "state") -> list[str]:
    """Paths of the tensors in ``tree`` (dataclasses, dicts, lists) that
    are not on the card."""
    import dataclasses

    if isinstance(tree, torch.Tensor):
        return [] if tree.is_cuda else [path]
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in cpu_tensors(torch, v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in cpu_tensors(torch, v, f"{path}/{i}")]
    return []


def check_train_records(records: list, num_envs: int, horizon: int, max_steps: int,
                        steps_per_eval: None | int, what: str) -> tuple[list, list]:
    """The CLI's tracked records: ``max_steps`` train records, each with
    integer counters and ``step`` = ``env/steps`` = num_envs x horizon x
    k, and the evals ``run()``'s cadence gives (after every
    ``steps_per_eval`` steps, never after the stopping one), each logged at
    the step before it; every value finite."""
    train = [r for r in records if "algorithm/steps" in r]
    evals = [r for r in records if "algorithm/steps" not in r]
    check([r["algorithm/steps"] for r in train] == list(range(1, max_steps + 1)), f"{what}: train records")
    for r in train:
        k = r["algorithm/steps"]
        check(isinstance(r["env/steps"], int) and r["step"] == r["env/steps"] == num_envs * horizon * k,
              f"{what}: step {k} logged at {r['step']}, env/steps {r['env/steps']}")
    want_evals = [s for s in range(1, max_steps) if steps_per_eval and s % steps_per_eval == 0]
    check([r["step"] for r in evals] == [num_envs * horizon * s for s in want_evals],
          f"{what}: evals at {[r['step'] for r in evals]}, not after steps {want_evals}")
    for r in records:
        check(all(math.isfinite(v) for v in r.values() if isinstance(v, (int, float))), f"{what}: finite stats")
    return train, evals


def run_cli_main_path(torch, dev, tmp: Path) -> None:
    """The README quick start through the CLI at full width: ``train -f
    <config> --max-steps 6 --steps-per-eval 3`` on the card, in this
    process. Six train records and one eval (after step 3; the stop
    condition ends the run at step 6 before a second); the act kernel
    launched 32 times per collect (six train and one eval collect), GAE
    once and the update num_sgd_iters x num_minibatches times per train
    step, no continuous kernel; no tensor of the algorithm's state off the
    card. Then the trainer's host overhead: Trainer.step() against
    collect() + step() of the same algorithm, in turns."""
    from rl8_tpu_torch.utils import memory_stats

    max_steps, steps_per_eval = 6, 3
    t = time.perf_counter()
    rc, trainer, records, launches = train_cli(torch, tmp, "quick_start", QUICK_START, "--max-steps",
                                               str(max_steps), "--steps-per-eval", str(steps_per_eval))
    cli_s = time.perf_counter() - t
    check(rc == 0, f"the CLI exited {rc}")
    algo = trainer.algorithm
    h = algo.hparams
    check(algo.device.type == "cuda" and (h.num_envs, h.horizon, h.gamma) == (8192, 32, 0.95),
          f"quick start config: {algo.device}, {h.num_envs} envs, horizon {h.horizon}, gamma {h.gamma}")
    train, evals = check_train_records(records, h.num_envs, h.horizon, max_steps, steps_per_eval, "cli_main_path")
    collects = len(train) + sum(r["eval/env/steps"] // (h.num_envs * h.horizon) for r in evals)
    want = {"act": h.horizon * collects, "continuous_act": 0, "gae": len(train),
            "ppo": len(train) * h.num_sgd_iters * h.num_minibatches, "continuous_ppo": 0}
    check(launches == want, f"cli_main_path launches {launches} != {want}")
    off_card = cpu_tensors(torch, algo.state) + [n for n, p in algo.policy.model.named_parameters() if not p.is_cuda]
    check(not off_card, f"cli_main_path: tensors off the card: {off_card}")
    check(trainer.state == {"algorithm/collects": collects, "algorithm/steps": max_steps,
                            "env/steps": max_steps * h.num_envs * h.horizon}, f"trainer state {trainer.state}")
    route = launched_route(torch, "cli_main_path's collect", algo.collect, ACT_ROUTES["discrete"], "wgmma")

    # The trainer's host overhead, in turns: Trainer.step() (memory stats,
    # collect, step, a JSONL line) against collect() + step().
    trainer_ms, algo_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.step()
        trainer_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        algo.collect()
        algo.step()
        algo_ms.append((time.perf_counter() - t) * 1e3)
    # Whether torch.cuda.mem_get_info waits for the device: read it behind
    # ~50 ms of queued device work.
    mem_idle_ms = []
    for _ in range(20):
        t = time.perf_counter()
        memory_stats(dev)
        mem_idle_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e8))  # cycles: >= 50 ms at the SM clock's <= 2 GHz
    t = time.perf_counter()
    memory_stats(dev)
    mem_busy_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    torch.cuda.synchronize()
    sleep_left_ms = (time.perf_counter() - t) * 1e3
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    emit({"phase": "cli_main_path", "config": QUICK_START, "cli_s": cli_s, "train_records": len(train),
          "eval_records": len(evals), "launches": launches, "act_route": f"discrete {route}",
          "memory_percent": train[-1].get("memory/percent"), "trainer_step_ms": trainer_ms,
          "collect_plus_step_ms": algo_ms, "trainer_step_ms_median": med(trainer_ms),
          "collect_plus_step_ms_median": med(algo_ms), "trainer_overhead_ms": med(trainer_ms) - med(algo_ms),
          "memory_stats_ms_median": med(mem_idle_ms), "memory_stats_behind_50ms_of_work_ms": mem_busy_ms,
          "sleep_left_after_it_ms": sleep_left_ms, "last_record": train[-1]})


def run_examples_path(torch, dev, tmp: Path) -> None:
    """The three classic-control example configs through the CLI, 4 steps
    each, at their committed widths on the card: finite stats; the
    discrete act and update kernels for CartPole and MountainCar, the
    continuous ones for Pendulum, each its exact count, GAE once a step,
    the update at the shapes the update checks hold (EXAMPLE_UPDATES,
    example_rows); the env state on the card; the act route. Then one env
    step run with synchronizing calls made errors (no host sync in a
    step), the env step's share of ENV_SHARE_COLLECTS real collects
    (env_share), and a profiled collect."""
    from rl8_tpu_torch.data import DataKeys

    steps = 4
    for name, config in EXAMPLE_CONFIGS.items():
        rc, trainer, records, launches = train_cli(torch, tmp, name, config, "--max-steps", str(steps))
        check(rc == 0, f"{name}: the CLI exited {rc}")
        algo = trainer.algorithm
        h = algo.hparams
        continuous = name == "pendulum"
        check((h.num_envs, h.horizon) == (1024, config["algorithm_config"]["horizon"]), f"{name}: widths")
        train, _ = check_train_records(records, h.num_envs, h.horizon, steps, None, name)
        per_step = h.num_sgd_iters * h.num_minibatches
        want = {"act": 0 if continuous else steps * h.horizon,
                "continuous_act": steps * h.horizon if continuous else 0, "gae": steps,
                "ppo": 0 if continuous else steps * per_step, "continuous_ppo": steps * per_step if continuous else 0}
        check(launches == want, f"{name}: launches {launches} != {want}")
        params = algo._pack_params()
        got = dict(obs_dim=params.d_in, A=params.action_dim, n=params.n, kind=params.kind)
        check(got == EXAMPLE_UPDATES[name] and params.hiddens == (256, 256) and params.activation == "relu"
              and h.sgd_minibatch_size == example_rows(name) and not h.accumulate_grads,
              f"{name}: the update runs at {got}, {params.hiddens} {params.activation}, "
              f"{h.sgd_minibatch_size} rows, not at the shapes the update checks hold")
        off_card = cpu_tensors(torch, algo.state)
        check(not off_card and algo.state.env_state["phys"].is_cuda, f"{name}: tensors off the card: {off_card}")
        kind = "continuous" if continuous else "discrete"
        route = launched_route(torch, f"{name}'s collect", algo.collect, ACT_ROUTES[kind],
                               "tiled" if continuous else "wgmma")

        env, state = algo.env, algo.state.env_state
        actions = algo.state.buffer[DataKeys.ACTIONS][-1]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            env.step(state, actions)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        share = env_share(torch, algo)
        emit({"phase": "examples_path", "example": name, "config": config, "launches": launches,
              "act_route": f"{kind} {route}", "cli_collect_ms": [r["profiling/collect_ms"] for r in train],
              **share, "transitions_per_s_collect": h.num_envs * h.horizon / (share["collect_ms_median"] / 1e3),
              "returns_mean": [r["returns/mean"] for r in train], "last_record": train[-1]})
        profile_window(torch, f"{name} collect", algo.collect)


#: Collects that env_share times.
ENV_SHARE_COLLECTS = 7


def env_share(torch, algo) -> dict:
    """The env step's share of ENV_SHARE_COLLECTS real collects of
    ``algo``: each ``env.step`` call inside the collect loop is wrapped in
    a host timer and a pair of CUDA events (no synchronize inside a
    collect; the wrapper adds two event records, a few µs, to each step),
    and each collect is timed on the host from a synchronize to a
    synchronize. Per collect: the host ms spent in env steps (what the
    host pays to issue them) and the stream ms between each step's events
    (the span the steps hold the stream: device time where the card runs
    behind the host, issue time where it waits for it), each over the
    collect's ms. Returns every collect's readings and their medians."""
    env = algo.env
    step = env.step
    host, spans = [], []

    def timed_step(state, actions):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        out = step(state, actions)
        end.record()
        host.append((time.perf_counter() - t) * 1e3)
        spans.append((start, end))
        return out

    collect_ms, host_ms, stream_ms = [], [], []
    env.step = timed_step
    try:
        for _ in range(ENV_SHARE_COLLECTS):
            host.clear()
            spans.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            algo.collect()
            torch.cuda.synchronize()
            collect_ms.append((time.perf_counter() - t) * 1e3)
            check(len(host) == algo.hparams.horizon, f"env_share: {len(host)} env steps in a collect")
            host_ms.append(sum(host))
            stream_ms.append(sum(a.elapsed_time(b) for a, b in spans))
    finally:
        del env.step
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    host_share = [e / c for e, c in zip(host_ms, collect_ms)]
    stream_share = [e / c for e, c in zip(stream_ms, collect_ms)]
    return {"collect_ms": collect_ms, "collect_ms_median": med(collect_ms),
            "env_host_ms": host_ms, "env_stream_ms": stream_ms,
            "env_host_share": host_share, "env_host_share_median": med(host_share),
            "env_stream_share": stream_share, "env_stream_share_median": med(stream_share)}


def check_learning_cartpole(torch, dev) -> None:
    """The JAX package's CartPole criterion (``tests/test_examples.py``'s
    ``test_cartpole_solves``) on the card through ``Trainer``: 256 envs,
    horizon 64, seed 0, 25 steps; the first step's mean return below -100
    and the last one's above -40; then one eval with finite stats."""
    from rl8_tpu_torch import AlgorithmConfig, Trainer
    from rl8_tpu_torch.examples.cartpole import CartPole

    t = time.perf_counter()
    trainer = Trainer(AlgorithmConfig(num_envs=256, horizon=64, seed=0, device="cuda").build(CartPole))
    returns = [trainer.step()["returns/mean"] for _ in range(25)]
    stats = trainer.eval()
    emit({"phase": "learning_cartpole", "steps": 25, "returns_mean": returns, "eval": stats,
          "seconds": time.perf_counter() - t})
    check(returns[0] < -100.0 and returns[-1] > -40.0,
          f"CartPole did not learn: first mean return {returns[0]}, last {returns[-1]}")
    check(all(math.isfinite(v) for v in stats.values()), f"CartPole eval stats finite: {stats}")


def check_envs_against_cpu(torch, dev) -> None:
    """One step of each classic-control env (CartPole with both
    integrators) from the same state and actions on the card and on the
    CPU: state, observations and rewards within rtol 1e-6, atol 4e-6 (the
    tests' tolerance against rl8_tpu: an ulp of sin/cos carried through
    the dynamics). Pendulum's angles span [-3 pi, 3 pi] (its floor modulo)."""
    from rl8_tpu_torch.examples.cartpole import CartPole
    from rl8_tpu_torch.examples.mountain_car import MountainCar
    from rl8_tpu_torch.examples.pendulum import Pendulum

    B = 4096
    gen = torch.Generator().manual_seed(21)
    u = lambda *shape: torch.rand(shape, generator=gen)  # noqa: E731
    three = lambda: torch.randint(0, 3, (B, 1), generator=gen)  # noqa: E731
    cartpole = (torch.stack([4 * u(B) - 2, 6 * u(B) - 3, 2 * math.pi * u(B) - math.pi, 8 * u(B) - 4], 1), three())
    cases = {
        "cartpole-euler": (CartPole, {}, *cartpole),
        "cartpole-semi-implicit": (CartPole, {"kinematics_integrator": "semi_implicit"}, *cartpole),
        "pendulum": (Pendulum, {}, torch.stack([6 * math.pi * u(B) - 3 * math.pi, 16 * u(B) - 8], 1), 6 * u(B, 1) - 3),
        "mountain_car": (MountainCar, {}, torch.stack([1.9 * u(B) - 1.25, 0.16 * u(B) - 0.08], 1), three()),
    }
    worst = {}
    for name, (env_cls, config, phys, actions) in cases.items():
        out = {}
        for device in ("cuda", "cpu"):
            env = env_cls(B, device=device)
            state, _ = env.reset(torch.Generator(device=device).manual_seed(0), config=config)
            state = {**state, "phys": phys.to(device)}
            new_state, obs, reward = env.step(state, actions.to(device))
            out[device] = [new_state["phys"].cpu(), obs.cpu(), reward.cpu()]
        for what, g, c in zip(("phys", "obs", "reward"), out["cuda"], out["cpu"]):
            check(torch.allclose(g, c, rtol=1e-6, atol=4e-6), f"{name} env step {what} on the card vs the CPU")
        worst[name] = max(float((g - c).abs().max()) for g, c in zip(out["cuda"], out["cpu"]))
    emit({"phase": "envs_vs_cpu", "B": B, "max_abs_err": worst, "rtol": 1e-6, "atol": 4e-6})


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rl8_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``) and
``nvidia-smi``, and imports neither JAX nor ``rl8_tpu``. (``python3
chip_smoke.py --time-updates LABEL`` builds the kernels and times only
the update kernels and their split by kernel, for comparing two
checkouts: see ``time_updates``; ``python3 chip_smoke.py --multi-card`` on a host with several cards runs the
sharded cells one rank a card over NCCL: see ``run_multi_card``.)
Phases, each printing one JSON line; any failed check raises and exits
non-zero:

1. build: compile the kernels from ``rl8_tpu_torch/csrc`` and time it;
   print the card's name and power limit.
2. kernels: every kernel of the main paths against its plain PyTorch
   version on the card at the main paths' shapes (discrete act at obs
   [8192, 1] with twin 256-wide torsos, and at A=2, n=3 (its wgmma
   route), at a ragged B=1000 with tanh layers (wgmma), at an obs dim of
   300 and at parameters off 16-byte alignment (its tiled f32 route) and
   at 320/288-wide layers (its staged route), each route asserted and
   two launches bit-identical; GAE at T = 1, 32, 33 and 512 over B = 8192
   and a ragged 1000, two launches bit-identical, timed beside an empty
   launch of its grid; the discrete PPO update at
   262,144 rows, at a ragged 1,000 rows with entropy, dual clip and
   accumulation, and at ragged weight tiles, and on its staged route's
   edges (20,001 rows, 736 wide; routes asserted) and at a 1,306-layer
   64-wide torso over two chunks; the continuous act kernel
   at obs [8192, 1] (Normal and squashed, stochastic draw for draw and
   deterministic) and at a ragged B=1000, A=4 with tanh layers (its
   tiled route), and at 320/288-wide layers (its staged route), each
   route asserted and two launches bit-identical, plus a moment check of
   its noise; the continuous update at 262,144 rows
   (squashed), at a ragged 1,000 rows (Normal, entropy, dual clip,
   accumulation), at ragged weight tiles and at rows that hit the +-100
   clamp; the recurrent act kernel at obs [8192, 1] with one 256-wide
   LSTM layer (all three kinds, draw for draw and deterministic, new
   states included), at a ragged B=1000 with two layers, at H = 720 and
   at two 1024-wide layers (its staged route); the recurrent update at 65,536 sequences of 4
   steps (categorical and squashed), at a ragged 1,000 sequences with two
   layers (entropy, dual clip, accumulation) and at samples that hit the
   clamp, on its staged route at the rule's edges (16,384 sequences, and
   16,383 on the narrow route), at a ragged 20,001 sequences of two layers
   (entropy, dual clip, accumulation; categorical and Normal), at clamped
   samples, at the ragged 1,000 sequences 768 wide, and at 1024 wide (16
   sequences), every route asserted, the update's and the act's library
   yardsticks (cuDNN ``torch.nn.LSTM`` forward and backward, one
   ``torch.lstm_cell``) timed beside them in f32;
   the chain forward and backward kernels at MischievousMule's chains
   (4,096 and 32,768 rows), at ragged three-chain tanh LayerNorm mixes
   (1,000 rows, d_in 1 and 64), at zero-variance rows, at 160/136-wide
   layers (the tiled forward's general path, the staged backward) and at
   one 768-wide and one 4096-wide LayerNorm chain (the forward's and the
   backward's staged routes; the rest take their tiled routes, each route
   asserted; two launches of each bit-identical)); the chain kernels also at the
   custom-model cells' chains (AttentiveAlpaca's at d_in 11, LazyLemur's at
   d_in 64, twin (64, 64) LayerNorm torsos, 4,096 and 32,768 rows), each
   route recorded and each timed beside its plain version with its bound;
   the discrete act kernel also at the
   CartPole and MountainCar examples' shapes (1024 rows, obs dims 5 and 2,
   A=1, n=3) and the continuous one at Pendulum's (1024 rows, obs dim 3);
   each timed beside its plain version. Then a NaN in one observation row
   on every act route (the recurrent act kernel's 32-row tiles and wide
   route included) and both chain-forward routes (the staged one with a
   narrow and a 9-wide head): that row's log-probs,
   values, new states and head outputs NaN, as in the plain versions
   (``check_nan_routes``).
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
   with ``fused_forward=False`` (no chain launch); after it the wide
   chains: ``chains_wide_sweep`` (both chain kernels on their staged
   routes against their plain versions, routes asserted, the saved
   backward bit-identical to the recompute route's wherever the route rule
   saves, ``backward_rule`` holding its Python mirror to the library, timed
   beside the plain versions with their bounds: MischievousMule's layout at 896, 1024,
   1536, 2048 and 2382 wide, LazyLemur's at 2354, AttentiveAlpaca's at 1024, a
   default twin torso at 2388, 768- and 4096-wide LayerNorm chains, ragged
   chains; 4,096 and 32,768 rows and ragged counts), ``chain_gate_grid``
   (``card_takes_chains`` takes every chain ``chains_fit_vmem`` admits, for
   the custom models and the default torso at the widths where the gate
   flips), ``wide_chain_builds`` (MischievousMule at 2382, LazyLemur at
   2354 and a default model at 2388 with ``fused_forward``, which raised at
   build before: one collect and step each) and ``wide_custom``
   (MischievousMule at ``hiddens=(2048, 2048)`` at the custom cell's
   shapes: one warm-up, three timed and one profiled iteration, chain
   forward 49 and backward 16 launches an iteration on their staged
   routes, the backward on its saved route, the rollout against the
   module forward, one minibatch's step gradient against the module
   route's, both kernels against their plain versions on the model's
   chains with the saved backward bit-identical to the recompute, a
   step's peak memory; its ``fused_forward=False`` twin timed beside it);
   then the deep models: ``deep_sweep``
   (default models of 9, 16 and 32 layers of 256 and rl8_tpu's deepest
   admitted ones, 87 of 256 and 1,306 of 64, for Categorical, Normal and
   SquashedNormal, the act kernel at 4,096 rows and the update at 8,192
   against their plain versions, or both against float64 where the plain
   f32 version drifts off it past the limits; routes asserted, timed with
   bounds), ``deep_memory`` (the update at 87 x 256 on 262,144 rows and the
   chain backward at MischievousMule's deepest admitted layout, 324 x 128,
   on 32,768: halves, bit-identity, workspace and peak memory within their
   12 and 4 GiB budgets), ``deep_gate_grid`` (every depth rl8_tpu's gate admits at
   32, 64, 256 and 512 wide asked of the act, update and chain kernels; the
   first refused depth on the module routes), ``chains_count_sweep`` (5 and
   8 chains, 12 and 24 layers, 5 and 8 heads on the tiled and staged chain
   routes), ``deep_custom`` (MischievousMule at 12 x 128 at the custom
   cell's shapes) and ``deep_torso`` (the slice's cell: 16 x 256, 8192
   envs, horizon 32, act 32, GAE 1, update 4 launches an iteration, beside
   its module twin); between the squashed and
   the recurrent paths, the routes ``rl8_tpu`` takes off the kernels at the
   discrete cell's width, one collect and one step each: a ``gelu`` torso
   (module rollout and autograd update, no act or update launch) and
   ``fused_act=False`` (module rollout, 4 update launches). Then, each
   with the counters set to 0 just before and read just after, one
   warm-up and five timed iterations and a profiled one (idle share):
   ``amp_paths`` (the discrete and the recurrent cell with
   ``enable_amp=True``: bf16 default models on the module routes, GAE
   once an iteration and no other kernel of ours, the rollout held
   against the bf16 module); ``recurrent_module_route`` (the recurrent
   cell with ``fused_act=False, fused_update=False``, f32); ``custom_amp``
   (BASELINE #5: ``MischievousMule`` with ``dtype=bfloat16``,
   ``enable_amp``, ``accumulate_grads``, 4096 envs, horizon 32,
   minibatches of 32,768 rows, ``fused_forward`` True with chain forward
   49 and backward 16 launches an iteration asserted, and False);
   ``custom_alpaca`` and ``custom_lemur`` (AttentiveAlpaca, and LazyLemur
   with seq_len 4 and seqs_per_state_reset 2, on AlgoTrading at the JAX
   bench's shape: 4096 envs, horizon 32, four minibatches an epoch; each in
   f32 with ``fused_forward=True`` (chain forward 33 a collect and 16 a
   step, backward 16 a step, GAE 1, no act or update kernel) and in the
   bench's bf16 regime with ``fused_forward`` True and False; one warm-up
   and three timed iterations each, the rollout held against the module);
   ``surface`` (run_surface: a custom model written with the arguments the
   port gained from ``rl8_tpu``'s surface, a bf16 ``OneHotEmbed`` in its
   input assembly and ``MLP(dropout=0.1)`` torsos called deterministically
   under a ``FusedApplySpec``, at the Custom cell's shapes: one warm-up and
   one timed iteration, chain forward 49, backward 16, GAE 1 launches an
   iteration and both chain routes asserted, the rollout held against the
   bf16 module; a seeded dropout draw on the card; the MLflow serving
   aliases bit-identical to the serving classes);
   ``optimizers`` (the discrete cell with Adam, ``torch.optim.AdamW`` flat
   and per leaf, in turns: act 32, GAE 1, update 4 an iteration, the
   optimizer's state on the card). Between the squashed path and the
   repaired routes, the wide models, whose update kernels run their staged
   and wide routes (``ppo_staged_fwd_kernel`` and ``ppo_staged_bwd_kernel``,
   the main path's route too, and
   ``rnn_staged_fwd_kernel`` and ``rnn_staged_bwd_kernel``, the
   recurrent main path's route too: 128 rows or sequences a block, each
   product staged through shared memory, the forward in f32 on the CUDA
   cores, the backward's dh products on 3xTF32 ``wgmma``), each route
   asserted by its kernel's name, each update held
   to ``PPO_GRAD_*`` against its plain version and two launches
   bit-identical: ``wide_torso`` (``bench.py:366``'s
   line, a 1024-wide twin torso at 8192 envs, horizon 32: one warm-up,
   three timed and one profiled iteration, act 32, GAE 1, update 4 an
   iteration; then both kernels against their plain versions on the first
   8,192 rows of the buffer and timed, the update also at 262,144 rows
   (the whole buffer against the plain version, the synthetic timed rows
   against float64 and over their halves),
   and the continuous kernels (SquashedNormal) at the same widths)
   and ``wide_sweep`` (twin torsos 737 to 2388 wide, three distributions,
   4,096 rows, each act and update kernel against its plain version on
   its asserted route; the gate grid: every default model ``rl8_tpu``'s
   residency gate admits is taken by both kernels; a 2389-wide torso
   builds onto the module routes with no act or update launch). After
   the recurrent main path, the wide LSTMs: ``rnn_wide_sweep`` (LSTMs of
   721 to 1617, one layer, three distributions, and two layers at 721 and
   at rl8_tpu's two-layer limit: each kernel against its plain version on
   its asserted route; 1618 on the module routes with no act or update
   launch; 1300 with ``fused_update=False`` collecting through the act
   kernel's staged route), then ``wide_recurrent`` (one 1024-wide LSTM layer
   at the recurrent cell's shapes: 8192 envs, horizon 32, seq_len 4, a
   whole-buffer minibatch of 65,536 sequences, 4 epochs; one warm-up,
   three timed and one profiled iteration, act 32, GAE 1, update 4 an
   iteration; the rollout against the module; the update against its
   plain version over the whole buffer and against its launches over the
   halves; both kernels timed beside their plain versions; the same cell
   on the module rollout and autodiff update timed beside it).
4. learning: the verify recipe's drive (256 envs, horizon 16, seed 1, 30
   iterations) on the card must learn the optimal greedy policy, for the
   discrete env (in f32 and with ``enable_amp=True``) and
   for the continuous one with ``SquashedNormal``; the recurrent drive
   (64 envs, horizon 16, seq_len 4, hidden 16, seed 1, 15 iterations)
   must raise the mean return.
5. small configurations run on the card and on the CPU (the plain
   versions) from the same seed, two collects and one step, compared:
   the discrete one and the continuous one with ``Normal``, feedforward
   and recurrent, and ``MischievousMule`` (deterministic collects); the
   discrete one with ``torch.optim.SGD`` (momentum 0.9), AdamW
   and AdamW per leaf, and the recurrent one with AdamW per leaf (the
   optimizer's state compared too).
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
   criterion, then one eval; and ``algotrading_cli``: the algotrading
   ``config.yaml`` (AttentiveAlpaca, 512 envs, horizon 64) through the CLI
   for 2 steps.
8. persistence and serving: ``checkpoint_resume`` (the discrete and the
   recurrent cell at full width, and the discrete cell with
   ``torch.optim.AdamW``: train, save, train; restore into a fresh
   algorithm and train; every parameter, Adam, buffer, env and generator
   state bit-identical, the resumed steps' launches counted; an async
   save that publishes only on ``wait_for_checkpoint()``; checkpoint
   bytes, save and restore ms); ``preemption`` (``Trainer.run`` with a
   checkpoint directory while a timer thread sends SIGTERM: it saves and
   returns, and a second run resumes); ``cli_persistence`` (``train
   --checkpoint-dir D --steps-per-checkpoint 2 --max-steps 4 --save OUT``,
   then ``--max-steps 6`` resuming at step 5; ``OUT/policy.pkl`` loads
   onto the card); ``serving`` (``PolicyModel`` and
   ``RecurrentPolicyModel`` on the card against the CPU at B = 1, 7, 100
   and 8192 and at a sample-dropping view, the discrete one also against
   a deterministic act-kernel launch; median predict latency); and
   ``parity_card`` (the five parity configs, seeds 0-2, on the card, with
   both criteria's outcomes against the reference curves).
9. ``sharded`` (``rl8_tpu_torch.parallel``): (a) the default discrete cell
   with ``mesh=create_mesh()`` over a one-process NCCL group, one warm-up
   and five timed iterations beside the same cell without a mesh (act 32,
   GAE 1, update 4 launches an iteration, counted from 0 in each),
   all-reduce calls per collect and per step and ms per call, and three
   iterations against the unsharded run from the same seed (rank 0 draws
   the unsharded streams: the first collect bit-identical, then only the
   two-pass global std rounds); (b) two ranks sharing the card over gloo
   (NCCL refuses two ranks on one card), two subprocesses of this script
   (``--sharded-worker``): the discrete and the recurrent cell at 8192
   envs in all, three iterations each, launches a rank, parameters
   bit-identical across the ranks after every step, global stats
   identical, transitions/s, gloo all-reduce ms; (c) ``exact_sharding``
   at two ranks (2048 envs, four shuffled minibatches, no kernel launch)
   against the single-device run of the same routes; (d) a two-rank
   checkpoint restored onto two ranks and onto one (every tensor equal),
   SIGTERM to one rank making both save and return, ``python -m
   rl8_tpu_torch doctor -f`` on the default cell, ``trace`` of a collect
   holding the act kernel's launches, ``debug_nans`` raising at a poisoned
   parameter and at an act launch whose output holds a NaN.
10. a ``{"kernels": [...]}`` line, the card line, and the ``{"ok": ...}``
   line last.
"""

from __future__ import annotations

import contextlib
import copy
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
#: The chain kernels' staged backward at relu chains: a relu unit whose
#: pre-activation lies a few 1e-8 from 0 may take the other side of the mask
#: in the kernel than in the plain version (both f32, their sums in other
#: orders; seen at 1.5e-8 to 5.2e-8 at 896 and 1024 wide, each changing its
#: row's dx by up to 1.8e-2). The staged backward recomputes the staged
#: forward's activations bit for bit, so compare_chains runs the plain
#: backward on those (kernel_activations), held themselves to the plain
#: forward's at CHAIN_RTOL/ATOL: its masks are the kernel's, and every row
#: is compared.
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
#: The wide sweep's continuous heads: the mean head is scaled so that the
#: pre-squash means have this RMS over the sweep's observations at every
#: width. Left as drawn, the means grow with the torso's width and saturate
#: the tanh; deep in the saturation a squashed row's log-prob is ~10x as
#: sensitive to its mean, and f32 rounding of the forward flips the ratio's
#: clip decisions of enough rows that f32 itself lands up to ~1e-2 off the
#: float64 gradient, the kernel and the plain version alike. Those inputs
#: are held against float64 (compare_ppo_f64).
WIDE_MEAN_RMS = 2.0
#: compare_ppo_f64, for inputs on which the plain f32 version itself lands
#: far off the float64 gradient: per gradient tensor, the update kernel's
#: error off float64 may be at most F64_K times the plain f32 version's,
#: plus PPO_GRAD_*. Both are f32 with other summation orders, and which
#: rows' clip decisions flip is a matter of the last bits, so the ratio
#: scatters around 1: 0.30-2.47 over the sweep's 18 saturated draws, where
#: the control (the plain version with one-pass TF32 products) lands 124x
#: the plain f32 version's error or more (PERF.md section 6).
F64_K = 4.0
#: Input draws of the saturated squashed update at each sweep width.
SATURATED_DRAWS = 3


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
    if sys.argv[1:2] == ["--sharded-worker"]:
        return sharded_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--multi-card-worker"]:
        return multi_card_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5]))

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
    if sys.argv[1:2] == ["--multi-card"]:
        with tempfile.TemporaryDirectory() as tmp:
            run_multi_card(torch, dev, Path(tmp))
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
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
    # Each phase's seconds on a line of its own (a check's cost beside the
    # run's time limit).
    for name, fn in (("act", lambda: check_act(torch, dev, kernels["act"])),
                     ("gae", lambda: check_gae(torch, dev, kernels["gae"])),
                     ("ppo", lambda: check_ppo(torch, dev, kernels["ppo"])),
                     ("continuous_act", lambda: check_continuous_act(torch, dev, kernels["continuous_act"])),
                     ("continuous_ppo", lambda: check_continuous_ppo(torch, dev, kernels["continuous_ppo"])),
                     ("rnn_act", lambda: check_rnn_act(torch, dev, kernels["rnn_act"])),
                     ("rnn_ppo", lambda: check_rnn_ppo(torch, dev, kernels["rnn_ppo"])),
                     ("chains", lambda: check_chains(torch, dev, kernels["chains_fwd"], kernels["chains_bwd"])),
                     ("model_chains",
                      lambda: check_model_chains(torch, dev, kernels["chains_fwd"], kernels["chains_bwd"])),
                     ("nan_routes", lambda: check_nan_routes(torch, dev)),
                     ("main_path", lambda: run_main_path(torch, dev)),
                     ("update_path", lambda: run_update_path(torch, dev, kernels)),
                     ("update_path_continuous", lambda: run_update_path(torch, dev, kernels, continuous=True)),
                     ("wide_torso", lambda: run_wide_torso(torch, dev, kernels)),
                     ("wide_sweep", lambda: run_wide_sweep(torch, dev, kernels)),
                     ("repaired_routes", lambda: run_repaired_routes(torch, dev)),
                     ("recurrent_path", lambda: run_recurrent_path(torch, dev, kernels)),
                     ("rnn_wide_sweep", lambda: run_rnn_wide_sweep(torch, dev, kernels)),
                     ("wide_recurrent", lambda: run_wide_recurrent(torch, dev, kernels)),
                     ("custom_path", lambda: run_custom_path(torch, dev, kernels)),
                     ("chains_wide_sweep", lambda: run_chains_wide_sweep(torch, dev, kernels)),
                     ("chain_gate_grid", lambda: check_chain_gate_grid(torch)),
                     ("wide_chain_builds", lambda: run_wide_chain_builds(torch, dev)),
                     ("wide_custom", lambda: run_wide_custom(torch, dev, kernels)),
                     ("deep_sweep", lambda: run_deep_sweep(torch, dev, kernels)),
                     ("deep_memory", lambda: run_deep_memory(torch, dev, kernels)),
                     ("deep_gate_grid", lambda: check_deep_gate_grid(torch)),
                     ("chains_count_sweep", lambda: run_chains_count_sweep(torch, dev, kernels)),
                     ("deep_custom", lambda: run_deep_custom(torch, dev, kernels)),
                     ("deep_torso", lambda: run_deep_torso(torch, dev, kernels))):
        t0 = time.perf_counter()
        fn()
        emit({"phase": "phase_seconds", "name": name, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    run_amp_paths(torch, dev)
    run_recurrent_module_route(torch, dev)
    run_custom_amp(torch, dev)
    run_custom_models(torch, dev)
    run_surface(torch, dev, card)
    run_optimizers(torch, dev)
    check_learning(torch, dev)
    check_learning(torch, dev, amp=True)
    check_learning_continuous(torch, dev)
    check_learning_recurrent(torch, dev)
    for recurrent in (False, True):
        check_small_against_cpu(torch, dev, recurrent=recurrent)
        check_small_against_cpu(torch, dev, continuous=True, recurrent=recurrent)
    check_small_custom_against_cpu(torch, dev)
    for label, kw in (
        ("sgd_momentum", {"optimizer_cls": torch.optim.SGD, "optimizer_config": {"lr": 1e-2, "momentum": 0.9}}),
        ("adamw", {"optimizer_cls": torch.optim.AdamW}),
        ("adamw_per_leaf", {"optimizer_cls": torch.optim.AdamW, "flatten_optimizer": False}),
    ):
        check_small_against_cpu(torch, dev, label=label, **kw)
    check_small_against_cpu(torch, dev, recurrent=True, label="adamw_per_leaf", optimizer_cls=torch.optim.AdamW,
                            flatten_optimizer=False)
    check_envs_against_cpu(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        run_cli_main_path(torch, dev, Path(tmp))
        run_examples_path(torch, dev, Path(tmp))
        run_algotrading_cli(torch, dev, Path(tmp))
    check_learning_cartpole(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        run_checkpoint_resume(torch, dev, Path(tmp))
        run_preemption(torch, dev, Path(tmp))
        run_cli_persistence(torch, dev, Path(tmp))
        run_serving(torch, dev, Path(tmp))
        run_parity_card(torch, dev, Path(tmp))
        run_sharded(torch, dev, Path(tmp))
    emit({"phase": "phase_seconds", "name": "the other paths", "seconds": time.perf_counter() - t0})
    emit({"phase": "phase_seconds", "name": "check_saved_backward (within the phases above)",
          "seconds": SAVED_CHECK_SECONDS[0]})

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
                 "act_heads_kernel<true": "staged"},
    "continuous": {"continuous_act_tiles_kernel": "tiled", "act_heads_kernel<false": "staged"},
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
    staged route 320/288-wide layers. Actions equal except rows whose
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
        "wide": dict(B=1000, A=2, n=3, obs_dim=2, obs_scale=3.0, model={"hiddens": (320, 288)}, route="staged"),
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
    flops, bytes_moved = act_cost(params, B)
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
    rows); then the staged route's edges: ``ragged`` (20,001 rows, a
    multiple of neither 128 nor 64, with (b)'s heads and loss) and
    ``w736`` (736-wide layers, the narrow route's widest before the staged
    route took the large minibatches, at 16,411 rows), each route asserted
    and their clip ties cleared (clear_clip_ties);
    and ``deep64``: rl8_tpu's deepest admitted 64-wide torso (1,306 tanh
    layers) at 12,288 rows, whose row scratch takes two chunks, held to
    float64 where the plain f32 version drifts off it (compare_ppo_f64).
    Two launches must be bit-identical."""
    from rl8_tpu_torch.ops import PPOLossConfig, fused_ppo_grads
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
    configs["ragged"] = dict(configs["b"], N=20001, model={}, route="staged")
    configs["w736"] = dict(configs["a"], N=16411, model={"hiddens": (736, 736)}, route="staged")
    for name, c in configs.items():
        seed = sum(map(ord, name))  # ord(name) for the one-letter cases
        model = make_model(torch, c["spec"], seed=40 + seed, obs_dim=c["obs_dim"], **c["model"])
        params, packed, unpack = ppo_inputs(torch, dev, model, c["N"], seed=seed)
        cfg = PPOLossConfig(clip_param=0.2, n_rows=c["N"], use_entropy=c["ec"] != 0.0, **c["loss"])
        ec = torch.tensor(c["ec"], device=dev)
        route = launched_route(torch, f"ppo ({name})", lambda: fused_ppo_grads(params, packed, unpack, ec, cfg),
                               PPO_ROUTES[False], c.get("route"), calls=1)
        ties = clear_clip_ties(torch, params, packed, unpack, cfg) if "route" in c else None
        result = compare_ppo(torch, f"ppo ({name})", params, packed, unpack, ec, cfg)
        emit({"phase": "kernel_check", "kernel": "ppo_update", "config": name, "N": c["N"],
              "hiddens": list(params.hiddens), "A": params.action_dim, "n": params.n,
              "activation": params.activation, "entropy_coeff": c["ec"], **c["loss"], "route": route,
              **({"clip_ties_cleared": ties} if ties is not None else {}), **result["summary"]})
        if name == "a":
            time_ppo(torch, "ppo_update", record, result, params, packed, unpack, ec, cfg)
    layers, N = GATE_DEEPEST[64], 12288
    model = deep_model(torch, "categorical", layers, 64, seed=1370, activation="tanh")
    params, packed, unpack, ec, cfg = deep_update_inputs(torch, dev, model, "categorical", N, seed=1371)
    chunk = ppo_chunk_rows(params, N)
    check(-(-N // chunk) == 2, f"ppo (deep64): {chunk}-row chunks, not two")
    route = launched_route(torch, "ppo (deep64)", lambda: fused_ppo_grads(params, packed, unpack, ec, cfg),
                           PPO_ROUTES[False], None, calls=1)
    result = compare_ppo_f64(torch, "ppo (deep64)", params, packed, unpack, ec, cfg, plain_first=True)
    emit({"phase": "kernel_check", "kernel": "ppo_update", "config": "deep64", "N": N,
          "hiddens": f"{layers}x64", "activation": "tanh", "chunk_rows": chunk, "route": route, **result})
    del model, params, packed
    torch.cuda.empty_cache()


def clear_clip_ties(torch, params, packed, unpack, cfg, band: float = 1e-5) -> int:
    """Zero (in place) the advantage of every categorical row whose float64
    probability ratio lies within ``band`` (relative) of a clip boundary, 1
    - clip or 1 + clip. The surrogate's cotangent jumps there (clipped: 0;
    not: adv r), and two f32 forwards that sum in different orders (the
    kernel's and the plain version's, ~1e-6 apart) can put such a row on
    either side: a whole row's gradient apart, past the checks' limit on
    the policy chain (one row of ``w736``'s 16,411 did). With a zero
    advantage both sides give 0. Returns the rows cleared."""
    from rl8_tpu_torch.ops.fused_act import ActParams
    from rl8_tpu_torch.ops.fused_mlp import forward_chains
    from rl8_tpu_torch.ops.fused_ppo import PackedColumns, _categorical_terms

    cols = PackedColumns.from_unpacker(unpack)
    as_f64 = lambda lo, hi: packed[:, lo:hi].contiguous().view(torch.float32).double()  # noqa: E731
    chains = ActParams(**{**params.__dict__, "flat": params.flat.double()}).chains()
    ((logits,), _), _ = forward_chains(as_f64(*cols.obs), chains, params.activation)
    new_logp = _categorical_terms(packed[:, cols.actions[0]:cols.actions[1]], logits, params.n, cfg)[0]
    r = torch.exp(new_logp - as_f64(cols.logp, cols.logp + 1)).flatten()
    near = torch.zeros_like(r, dtype=torch.bool)
    for edge in (1.0 - cfg.clip_param, 1.0 + cfg.clip_param):
        near |= (r / edge - 1.0).abs() < band
    packed[near, cols.advantages] = 0  # the bits of 0.0
    return int(near.sum())


def check_nan_routes(torch, dev) -> None:
    """A NaN in one observation row reaches that row's log-prob and value
    on every act route, and every head output of that row on both chain
    forward routes, as in the plain versions (relu keeps a NaN, as
    ``torch.relu`` and ``jnp.maximum`` do); every other row stays finite
    and within ACT_* or CHAIN_* of the plain version. Sampled actions from
    NaN logits are not compared. Routes: the discrete act kernel's wgmma
    (the main model), tiled (an obs dim of 300) and staged routes
    (320/288-wide layers at obs dims of 2 and 4,000), the continuous one's
    tiled and staged routes (the same shapes), and deep models on them
    (16 layers of 256 on the wgmma and the continuous tiled routes, 12 and
    200 of 64 on the discrete tiled route, 12 of 320 on the continuous
    staged route), each asserted; the
    recurrent act kernel's 32-row tiles (one 64-wide LSTM layer) and its
    staged route (256 wide, the main path's, whose input is folded into
    the gates' epilogue; 1300 wide; two 1024-wide layers), where the NaN
    row's new states are NaN too; the chain forward's tiled route
    (MischievousMule's chains) and staged route (one 768-wide LayerNorm
    chain; MischievousMule's layout at 1024 wide with a 9-wide head, the
    staged route's head product, beside its narrow one)."""
    from rl8_tpu_torch.ops import act_plain, forward_chains, fused_act, fused_chains_fwd, fused_rnn_act, pack_act_params
    from rl8_tpu_torch.ops import pack_rnn_params, rnn_act_plain
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, default_chains, flatten_chains
    from rl8_tpu_torch.specs import Discrete

    B, bad = 1000, 7
    gen = torch.Generator(device=dev).manual_seed(18)
    cases = [
        ("discrete", "wgmma", 1, {}), ("discrete", "tiled", 300, {"hiddens": (64, 64)}),
        ("discrete", "staged", 2, {"hiddens": (320, 288)}),
        ("discrete", "staged", 4000, {"hiddens": (320, 288)}),
        ("continuous", "tiled", 1, {}), ("continuous", "staged", 2, {"hiddens": (320, 288)}),
        ("continuous", "staged", 4000, {"hiddens": (320, 288)}),
        # Deep models: the routes read their layers from the launch's table.
        ("discrete", "wgmma", 1, {"hiddens": (256,) * 16}), ("discrete", "tiled", 300, {"hiddens": (64,) * 12}),
        ("discrete", "tiled", 1, {"hiddens": (64,) * 200}),
        ("continuous", "tiled", 1, {"hiddens": (256,) * 16}), ("continuous", "staged", 1, {"hiddens": (320,) * 12}),
    ]
    seen = []
    for family, want, obs_dim, model_config in cases:
        if family == "discrete":
            model = make_model(torch, Discrete(3, shape=(2,)), seed=obs_dim, obs_dim=obs_dim, **model_config)
        else:
            model = make_continuous_model(torch, 2, seed=obs_dim, obs_dim=obs_dim, **model_config)
        params = pack_act_params(model)
        obs = torch.randn((B, obs_dim), generator=gen, device=dev)
        obs[bad, obs_dim // 2] = float("nan")
        route = launched_route(torch, f"nan {family} act", lambda: fused_act(params, obs, (1, 2)),
                               ACT_ROUTES[family], want)
        _, kl, kv = fused_act(params, obs, (1, 2), deterministic=True)
        _, pl, pv = act_plain(params, obs, (1, 2), deterministic=True)
        torch.cuda.synchronize()
        what = f"nan {family} act ({route})"
        rest = torch.arange(B, device=dev) != bad
        for name, k, p in (("logp", kl, pl), ("values", kv, pv)):
            check(bool(torch.isnan(p[bad]).all()), f"{what}: the plain {name} of the NaN row is not NaN")
            check(bool(torch.isnan(k[bad]).all()), f"{what}: the kernel's {name} of the NaN row is {k[bad].tolist()}")
            check(torch.allclose(k[rest], p[rest], rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: the other rows' {name}")
        seen.append(f"{family}_act_{route}_obs{obs_dim}_{len(params.hiddens)}x{params.hiddens[0]}")
    # The recurrent act kernel's routes: 32-row tiles (a 64-wide LSTM) and
    # the staged route (the main path's 256-wide LSTM, its input folded into
    # the gates' epilogue; 1300 wide; two 1024-wide layers).
    for H, K in ((64, 1), (256, 1), (1300, 1), (1024, 2)):
        params = pack_rnn_params(make_rnn_model(torch, "categorical", seed=H + K, hidden_size=H, num_layers=K))
        obs = torch.randn((B, 1), generator=gen, device=dev)
        obs[bad, 0] = float("nan")
        states = rnn_states(torch, dev, B, K, H, gen)
        route = launched_route(torch, "nan rnn act", lambda: fused_rnn_act(params, obs, states, (1, 2)),
                               RNN_ACT_ROUTES[False], rnn_routes(H, B)[0])
        _, kl, kv, ks = fused_rnn_act(params, obs, states, (1, 2), deterministic=True)
        _, pl, pv, ps = rnn_act_plain(params, obs, states, (1, 2), deterministic=True)
        torch.cuda.synchronize()
        what = f"nan rnn act ({route})"
        rest = torch.arange(B, device=dev) != bad
        for name, k, p in (("logp", kl, pl), ("values", kv, pv), *((sk, ks[sk], ps[sk]) for sk in ks)):
            check(bool(torch.isnan(p[bad]).all()), f"{what}: the plain {name} of the NaN row is not NaN")
            check(bool(torch.isnan(k[bad]).all()), f"{what}: the kernel's {name} of the NaN row is not NaN")
            check(torch.allclose(k[rest], p[rest], rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: the other rows' {name}")
        seen.append(f"rnn_act_{route}_{K}x{H}")
    mule_chains = default_chains(make_mule(torch, seed=5).to(dev))
    near = random_chains(torch, dev, seed=8, d_in=7, layout=(([(768, True)], [3]),))
    wide = random_chains(torch, dev, seed=11, d_in=7,
                         layout=(([(1024, True), (1024, False)], [9, 3]), ([(1024, True), (1024, False)], [1])))
    for chains, want in ((mule_chains, "tiled"), (near, "staged"), (wide, "staged")):
        x = 0.5 * torch.randn((B, 7), generator=gen, device=dev)
        x[bad, 3] = float("nan")
        route = forward_route(torch, x, chains, "relu", want)
        outs = fused_chains_fwd(x, flatten_chains(chains), chain_structure(chains), "relu")
        (plain, _) = forward_chains(x, chains, "relu")
        plain = [t for heads in plain for t in heads]
        torch.cuda.synchronize()
        rest = torch.arange(B, device=dev) != bad
        for k, p in zip(outs, plain):
            check(bool(torch.isnan(p[bad]).all()), "nan chains: the plain outputs of the NaN row are not NaN")
            check(bool(torch.isnan(k[bad]).all()), f"nan chains ({route}): the kernel's NaN row is {k[bad].tolist()}")
            check(torch.allclose(k[rest], p[rest], rtol=CHAIN_RTOL, atol=CHAIN_ATOL),
                  f"nan chains ({route}): other rows")
        seen.append(f"chains_fwd_{route}_{chain_structure(chains)[1][0][0][0][0]}")
    emit({"phase": "kernel_check", "kernel": "nan_observation", "rows": B, "routes": seen})


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
    N = packed.shape[0]
    flops, bytes_moved = ppo_cost(params, packed)
    record["ms"], host_ms = time_ms(
        torch, lambda: fused_ppo_grads(params, packed, unpack, ec, cfg), iters=10, warmup=2
    )
    record["plain_ms"], plain_host_ms = time_ms(
        torch, lambda: ppo_grads_plain(params, packed, unpack, ec, cfg), iters=3, warmup=1
    )
    # The yardstick of the weight products alone (no PyTorch call computes the
    # whole update): one cuBLAS SGEMM a chain of h^T dpre at the top layer's
    # shapes, [width, N] x [N, width], in f32 (TF32 off), on random operands.
    gen = torch.Generator(device=packed.device).manual_seed(N)
    width = params.hiddens[-1]
    operands = [torch.randn((N, width), generator=gen, device=packed.device) for _ in range(4)]
    record["library_ms"] = time_ms(torch, lambda: [torch.mm(h.t(), dp) for h, dp in zip(operands[:2], operands[2:])],
                                   iters=10, warmup=2)[0]
    del operands
    update_bounds(record, flops, bytes_moved)
    record["host_ms"] = host_ms
    emit({"phase": "kernel_time", "kernel": kernel, "N": N, "flops": flops,
          "bytes": bytes_moved, "host_ms": host_ms, "plain_host_ms": plain_host_ms,
          "library": "two cuBLAS SGEMMs (h^T dpre a chain, f32)",
          **{k: record[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_tc_ms")}})


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
                     heads={"mean_scale": 0.06, "log_std_scale": 0.3}, route="staged"),
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
    flops, bytes_moved = act_cost(params, B)
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


def compare_rnn_act(torch, what: str, params, obs, states, key=(24680, 1357)) -> dict:
    """The recurrent act kernel twice and its plain version, deterministic
    and stochastic (the plain version replays the kernel's Philox draws):
    the two launches bit-identical; the new states, values and continuous
    actions within ACT_*; discrete actions equal except near ties; log-probs
    within ACT_* of the plain distribution's log-prob of the kernel's own
    actions on every row, and of the plain version's own where
    SQUASH_LIMIT allows (as for the feedforward act kernels). Returns, per
    mode, the largest difference and the rows whose log-probs were
    compared directly."""
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.distributions import Categorical, Normal, SquashedNormal
    from rl8_tpu_torch.ops import fused_rnn_act, rnn_act_plain
    from rl8_tpu_torch.ops.distmath import philox_normal, philox_uniform

    dev = obs.device
    B, K, H, kind = obs.shape[0], params.num_layers, params.hidden, params.kind
    outs = rnn_heads_plain(torch, params, obs, states)
    out = {}
    for det in (True, False):
        mode = f"{what} {kind} {'deterministic' if det else 'stochastic'}"
        ka, kl, kv, ks = fused_rnn_act(params, obs, states, key, deterministic=det)
        ka2, kl2, kv2, ks2 = fused_rnn_act(params, obs, states, key, deterministic=det)
        pa, pl, pv, ps = rnn_act_plain(params, obs, states, key, deterministic=det)
        torch.cuda.synchronize()
        check(torch.equal(ka, ka2) and torch.equal(kl, kl2) and torch.equal(kv, kv2)
              and all(torch.equal(ks[sk], ks2[sk]) for sk in ks), f"{mode}: two launches bit-identical")
        for sk in (DataKeys.HIDDEN_STATES, DataKeys.CELL_STATES):
            check(tuple(ks[sk].shape) == (B, K, H), f"{mode}: {sk} shape")
            check(torch.allclose(ks[sk], ps[sk], rtol=ACT_RTOL, atol=ACT_ATOL), f"{mode}: {sk}")
        check(torch.allclose(kv, pv, rtol=ACT_RTOL, atol=ACT_ATOL), f"{mode}: values")
        keep = torch.ones(B, dtype=torch.bool, device=dev)
        if kind == "categorical":
            A, n = params.action_dim, params.n
            logits = outs[0].view(B, A, n)
            dist = Categorical({"logits": logits})
            scores = logits.log_softmax(-1)
            if not det:
                scores = scores - torch.log(-torch.log(philox_uniform(*key, B, A, n, dev).view(B, A, n)))
            top2 = scores.topk(2, dim=-1).values
            ties = ((top2[..., 0] - top2[..., 1]) < TIE_GAP).any(dim=1)
            check(bool((ka == pa).all(dim=1)[~ties].all()), f"{mode}: actions")
            err_a = 0.0
        else:
            log_std = torch.tanh(outs[1])
            dist = (SquashedNormal if kind == "squashed" else Normal)({"mean": outs[0], "log_std": log_std})
            check(torch.allclose(ka, pa, rtol=ACT_RTOL, atol=ACT_ATOL), f"{mode}: actions")
            err_a = float((ka - pa).abs().max())
            if kind == "squashed":
                x = outs[0] if det else outs[0] + torch.exp(log_std) * philox_normal(*key, B, params.action_dim, dev)
                keep = (x.abs() < SQUASH_LIMIT).all(dim=1)
        own = dist.logp(ka)
        check(torch.allclose(kl, own, rtol=ACT_RTOL, atol=ACT_ATOL),
              f"{mode}: logp vs the plain log-prob of the kernel's actions")
        check(torch.allclose(kl[keep], pl[keep], rtol=ACT_RTOL, atol=ACT_ATOL), f"{mode}: logp")
        err = max(err_a, float((kv - pv).abs().max()), float((kl - own).abs().max()),
                  float((kl[keep] - pl[keep]).abs().max()),
                  *(float((ks[sk] - ps[sk]).abs().max()) for sk in ks))
        out["deterministic" if det else "stochastic"] = {"max_abs_err": err, "rows_compared_logp": int(keep.sum())}
    return out


def check_rnn_act(torch, dev, record: dict) -> None:
    """The recurrent act kernel against its plain version on the card, for
    the categorical, Normal and squashed kinds (compare_rnn_act), each on
    the route ``rnn_routes`` gives (asserted): at the main path's shapes
    (obs [8192, 1], one 256-wide LSTM layer, A = 1; the staged route), at a
    ragged B = 1000 with obs dim 3 and A = 2 (n = 3) over two 96-wide
    layers (the 32-row tiles) and two 256-wide ones (the staged route, its
    three inputs folded into the first gates' epilogue), at H = 720 and at
    two 1024-wide layers over 4,096 rows (the staged route, one gate launch
    a layer). Then its library yardstick: one torch.lstm_cell at the main
    path's shapes, f32."""
    from rl8_tpu_torch.ops import fused_rnn_act, pack_rnn_params, rnn_act_plain

    gen = torch.Generator(device=dev).manual_seed(5)
    configs = {
        "main": dict(B=8192, obs_dim=1, A=1, n=2, H=256, K=1),
        "ragged": dict(B=1000, obs_dim=3, A=2, n=3, H=96, K=2),
        "ragged_staged": dict(B=1000, obs_dim=3, A=2, n=3, H=256, K=2),
        # The staged route: 32 rows of a 720-wide layer do not fit two blocks an SM.
        "wide": dict(B=1000, obs_dim=3, A=1, n=2, H=720, K=1),
        # Two layers on the staged route: layer 2 reads layer 1's h' from h_out.
        "two_layer_1024": dict(B=4096, obs_dim=1, A=1, n=2, H=1024, K=2),
    }
    for name, c in configs.items():
        B, A, n, H, K = c["B"], c["A"], c["n"], c["H"], c["K"]
        obs = 3.0 * (2.0 * torch.rand((B, c["obs_dim"]), generator=gen, device=dev) - 1.0)
        states = rnn_states(torch, dev, B, K, H, gen)
        for kind in ("categorical", "normal", "squashed"):
            model = make_rnn_model(torch, kind, seed=90 + K, obs_dim=c["obs_dim"], A=A, n=n, hidden_size=H,
                                   num_layers=K, log_std_bias=-1.0)
            params = pack_rnn_params(model, squashed=kind == "squashed")
            if kind == "categorical":
                route = launched_route(torch, f"rnn act {name}", lambda: fused_rnn_act(params, obs, states, (1, 2)),
                                       RNN_ACT_ROUTES[False], rnn_routes(H, B)[0])
            result = compare_rnn_act(torch, f"rnn act {name}", params, obs, states)
            for mode, r in result.items():
                emit({"phase": "kernel_check", "kernel": "rnn_act", "config": name, "kind": kind, "route": route,
                      "deterministic": mode == "deterministic", "B": B, "A": A, "n": n if kind == "categorical" else 0,
                      "H": H, "K": K, **r, "rtol": ACT_RTOL, "atol": ACT_ATOL})
                if name == "main":
                    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), r["max_abs_err"])

    # Timing at the main path's shapes: B = 8192, one 256-wide layer,
    # categorical A = 1, n = 2, stochastic.
    B, H = 8192, 256
    obs = 3.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
    states = rnn_states(torch, dev, B, 1, H, gen)
    params = pack_rnn_params(make_rnn_model(torch, "categorical", seed=99))
    flops, bytes_moved = rnn_act_cost(params, B)
    record["ms"], host_ms = time_ms(torch, lambda: fused_rnn_act(params, obs, states, (1, 2)))
    record["plain_ms"], plain_host_ms = time_ms(
        torch, lambda: rnn_act_plain(params, obs, states, (1, 2), deterministic=False), iters=20
    )
    # The yardstick of the gate part alone (no PyTorch call computes the
    # whole act step): one torch.lstm_cell on the same inputs, f32.
    from rl8_tpu_torch.data import DataKeys

    wi, wh, b = params.lstm()[0]
    h0, c0 = (states[k][:, 0].contiguous() for k in (DataKeys.HIDDEN_STATES, DataKeys.CELL_STATES))
    w_ih, w_hh, zero = wi.t().contiguous(), wh.t().contiguous(), torch.zeros_like(b)
    with f32_library(torch):
        record["library_ms"] = time_ms(torch, lambda: torch.lstm_cell(obs, (h0, c0), w_ih, w_hh, b, zero))[0]
    update_bounds(record, flops, bytes_moved)
    emit({"phase": "kernel_time", "kernel": "rnn_act", "B": B, "flops": flops, "bytes": bytes_moved,
          "host_ms": host_ms, "plain_host_ms": plain_host_ms, "library": "torch.lstm_cell (the gate part alone, f32)",
          **{k: record[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_tc_ms")}})


def rnn_act_cost(params, B: int) -> tuple[int, int]:
    """``(FLOP, bytes)`` of a recurrent act launch of ``B`` rows: every
    layer's gate products and the heads; observations, states (in and out)
    and parameters read or written once, with the actions, log-probs and
    values."""
    H, G = params.hidden, 4 * params.hidden
    macs = sum(((params.d_in if l == 0 else H) + H) * G for l in range(params.num_layers))
    flops = 2 * B * (macs + H * sum(params.head_widths))
    states = 4 * B * params.num_layers * H  # h and c, read and written
    return flops, 4 * (B * params.d_in + states + params.flat.numel() + B * (params.action_dim + 2))


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
    (compare_ppo's tolerances, two launches bit-identical), each on the
    route ``rnn_routes`` gives (asserted): (a) the main path's shapes,
    65,536 sequences of L = 4 with one 256-wide layer, categorical; (b) the
    same shapes squashed; (c) a ragged 1,000 sequences, two 64-wide layers,
    A = 2, n = 3, entropy, dual clip and accumulation; (d) the same ragged
    shapes with Normal, entropy and dual clip; (e) squashed samples with
    actions at +-1 and a small std, so that the +-100 clamp cuts their
    gradients. Then the staged route's rule and options: (f) 16,384
    sequences at 256, its first minibatch, and (g) 16,383, the narrow
    route's last; (h) a ragged last block (20,001 sequences) of two 256-wide
    layers, A = 2, n = 3, entropy, dual clip and accumulation, (i) the same
    with Normal; (j) the clamp case at 16,384 sequences of a 128-wide LSTM;
    (k) the ragged 1,000 sequences at 768 wide (past the narrow row pass),
    Normal, entropy, dual clip and accumulation."""
    from rl8_tpu_torch.ops import PPOLossConfig, fused_rnn_ppo_grads, pack_rnn_params

    main_loss = dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)
    ragged_loss = dict(vf_clip_param=1.5, vf_coeff=0.9, dual_clip_param=3.0, accum=3)
    clamp = dict(kind="squashed", ec=0.0, clip_share=0.3, loss=main_loss)
    configs = {
        "a": dict(N=65536, kind="categorical", model={}, ec=0.0, loss=main_loss),
        "b": dict(N=65536, kind="squashed", model={}, ec=0.0, loss=main_loss),
        "c": dict(N=1000, kind="categorical", model=dict(obs_dim=3, A=2, n=3, hidden_size=64, num_layers=2),
                  ec=0.013, loss=ragged_loss),
        "d": dict(N=1000, kind="normal", model=dict(obs_dim=3, A=2, hidden_size=64, num_layers=2), ec=0.013,
                  loss=ragged_loss),
        "e": dict(N=2048, model=dict(obs_dim=2, A=2, hidden_size=32, head_scale=0.001, log_std_bias=-3.0), **clamp),
        "f": dict(N=RNN_STAGED_MIN_ROWS, kind="categorical", model={}, ec=0.0, loss=main_loss),
        "g": dict(N=RNN_STAGED_MIN_ROWS - 1, kind="categorical", model={}, ec=0.0, loss=main_loss),
        "h": dict(N=20001, kind="categorical", model=dict(obs_dim=3, A=2, n=3, num_layers=2), ec=0.013,
                  loss=ragged_loss),
        "i": dict(N=20001, kind="normal", model=dict(obs_dim=3, A=2, num_layers=2), ec=0.013, loss=ragged_loss),
        "j": dict(N=RNN_STAGED_MIN_ROWS, model=dict(obs_dim=2, A=2, hidden_size=128, head_scale=0.001,
                                                    log_std_bias=-3.0), **clamp),
        "k": dict(N=1000, kind="normal", model=dict(obs_dim=3, A=2, hidden_size=768), ec=0.013, loss=ragged_loss),
    }
    L = 4
    routes = {}
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
        routes[name] = launched_route(torch, f"rnn ppo ({name})",
                                      lambda: fused_rnn_ppo_grads(params, packed, unpack, ec, cfg),
                                      RNN_PPO_ROUTES[params.continuous], rnn_routes(params.hidden, c["N"])[1])
        result = compare_rnn_ppo(torch, f"rnn ppo ({name})", params, packed, unpack, ec, cfg)
        emit({"phase": "kernel_check", "kernel": "rnn_ppo_update", "config": name, "N": c["N"], "L": L,
              "H": params.hidden, "K": params.num_layers, "A": params.action_dim, "kind": params.kind,
              "entropy_coeff": c["ec"], **c["loss"], "samples_clamped": clamped, "route": routes[name],
              **result["summary"]})
        if name == "a":
            time_rnn_ppo(torch, record, result, params, packed, unpack, ec, cfg)

    # The width limit: the main width takes the narrow row pass at 16
    # sequences, and 1024 (past its shared memory) is taken too, on the
    # staged route, by the query and by the wrapper, whose result matches
    # the plain version.
    from rl8_tpu_torch.ops import card_takes_rnn_update

    main_model, wide_model = (make_rnn_model(torch, "categorical", seed=0, hidden_size=h) for h in (256, 1024))
    main, wide = pack_rnn_params(main_model), pack_rnn_params(wide_model)
    check(card_takes_rnn_update(main), "rnn ppo: the kernel refuses the main width")
    check(card_takes_rnn_update(wide), "rnn ppo: the kernel refuses a 1024-wide row pass")
    cfg = PPOLossConfig(clip_param=0.2, n_rows=16, use_entropy=False, **main_loss)
    ec = torch.tensor(0.0, device=dev)
    routes = {}
    for width, params, model in (("256", main, main_model), ("1024", wide, wide_model)):
        packed, unpack, _ = rnn_ppo_inputs(torch, dev, model, "categorical", 16, L, seed=0)
        routes[width] = launched_route(torch, f"rnn ppo {width}",
                                       lambda: fused_rnn_ppo_grads(params, packed, unpack, ec, cfg),
                                       RNN_PPO_ROUTES[False], "narrow" if width == "256" else "staged")
        result = compare_rnn_ppo(torch, f"rnn ppo ({width} wide, 16 sequences)", params, packed, unpack, ec, cfg)
    emit({"phase": "kernel_check", "kernel": "rnn_ppo_update", "width_limit": {"256": True, "1024": True},
          "width_routes": routes, **result["summary"]})


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
    N = packed.shape[0]
    L = RnnPackedColumns.from_unpacker(unpack).seq_len
    flops, bytes_moved = rnn_ppo_cost(params, packed, L)
    record["ms"], host_ms = time_ms(
        torch, lambda: fused_rnn_ppo_grads(params, packed, unpack, ec, cfg), iters=10, warmup=2
    )
    record["plain_ms"], plain_host_ms = time_ms(
        torch, lambda: rnn_ppo_grads_plain(params, packed, unpack, ec, cfg), iters=3, warmup=1
    )
    record["library_ms"] = lstm_library_ms(torch, packed.device, N, L, params.d_in, params.hidden,
                                           params.num_layers)
    update_bounds(record, flops, bytes_moved)
    record["host_ms"] = host_ms
    emit({"phase": "kernel_time", "kernel": "rnn_ppo_update", "N": N, "L": L, "flops": flops,
          "bytes": bytes_moved, "host_ms": host_ms, "plain_host_ms": plain_host_ms,
          "library": "cuDNN torch.nn.LSTM forward and backward (the LSTM part alone, f32)",
          **{k: record[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_tc_ms")}})


@contextlib.contextmanager
def f32_library(torch):
    """cuDNN's and cuBLAS's float32 in full f32 (TF32 off), for the library
    yardsticks; the settings are restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def lstm_library_ms(torch, dev, N: int, L: int, d_in: int, H: int, K: int) -> float:
    """The recurrent update's library yardstick of its LSTM part alone (no
    PyTorch call computes the whole update): cuDNN's ``torch.nn.LSTM``
    forward and backward over N sequences of L steps, K H-wide layers, from
    given states, f32 (TF32 off), on random inputs and output cotangents.
    Device ms a call."""
    gen = torch.Generator(device=dev).manual_seed(N + H)
    lstm = torch.nn.LSTM(d_in, H, num_layers=K, batch_first=True).to(dev)
    x = torch.randn((N, L, d_in), generator=gen, device=dev)
    h0, c0 = (torch.randn((K, N, H), generator=gen, device=dev) for _ in range(2))
    g = torch.randn((N, L, H), generator=gen, device=dev)

    def run():
        out, _ = lstm(x, (h0, c0))
        out.backward(g)

    with f32_library(torch):
        return time_ms(torch, run, iters=5, warmup=2)[0]


def rnn_ppo_cost(params, packed, L: int) -> tuple[int, int]:
    """``(FLOP, bytes)`` of a recurrent update launch over the packed
    sequences of L steps: per sample, the forward's gate products, the
    backward's dx products below the top layer, the weight products and
    the heads'; per sequence, the dh products of its L - 1 later steps
    (the stored initial states take no gradient). The packed rows and the
    parameters read once, the gradient and the stats written once."""
    N, H, K, d_in = packed.shape[0], params.hidden, params.num_layers, params.d_in
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
    return 2 * N * seq_macs, 4 * (packed.numel() + 2 * params.flat.numel() + 4 + 1)


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


#: The width of the identity heads through which kernel_activations reads
#: a layer's activations: a head this wide never fits the tiled forward's
#: shared memory, so the layers run the staged route's launches.
PROBE_WIDTH = 1024


def kernel_activations(torch, x, chains, activation: str) -> list:
    """Each chain's activation stack ``[x, h_1, ..., h_L]`` (as
    ``forward_chains`` returns it) as the staged chain kernels compute it.
    The staged forward computes layer l from h_{l-1} alone (its product
    summed in order of k, then its LayerNorm in place), so h_l is the
    output of a forward launch of layer l on the kernels' h_{l-1}, under
    one identity head zero-padded to at least PROBE_WIDTH columns (which
    sends it to the staged route; each output a sum of h_l times 1 and
    zeros, so exactly h_l): L launches a chain."""
    from rl8_tpu_torch.ops import fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, flatten_chains

    stacks = []
    for layers, _ in chains:
        hs = [x]
        for layer in layers:
            width = layer[0].shape[1]
            cols = max(width, PROBE_WIDTH)
            probe = (((layer,), ((torch.eye(width, cols, device=x.device), torch.zeros(cols, device=x.device)),)),)
            out = fused_chains_fwd(hs[-1], flatten_chains(probe), chain_structure(probe), activation)[0]
            hs.append(out[:, :width].contiguous())
        stacks.append(hs)
    return stacks


def chains_f64(torch, chains):
    """``chains`` with every tensor in float64."""
    return tuple((tuple(tuple(t.double() for t in layer) for layer in layers),
                  tuple(tuple(t.double() for t in head) for head in heads)) for layers, heads in chains)


def chain_tensors(chains) -> list:
    """Every tensor of ``chains`` (or of their gradients) in kernel order:
    per chain each layer's, then each head's."""
    return [t for layers, heads in chains for ts in (*layers, *heads) for t in ts]


#: check_saved_backward's seconds over the run.
SAVED_CHECK_SECONDS = [0.0]


def backward_rule(torch, structure, N: int) -> str:
    """The chain backward's route at N rows by the route rule:
    ``staged_saved`` where the forward keeps the activations for it
    (csrc/chains.cu's rl8_chains_workspace(..., 2) answers its saved
    layout's floats: both take their staged routes and
    rl8_chains_chunk_rows answers N), ``staged_recompute`` on the other
    staged shapes (chunks of rows, or behind the tiled forward),
    ``tiled`` on the tiled route. Checks that fused_mlp's pure-Python
    mirrors of the rule (staged_chunk_rows, staged_saves) answer what the
    library does."""
    from rl8_tpu_torch.ops._build import load
    from rl8_tpu_torch.ops.fused_mlp import _spec, staged_chunk_rows, staged_saves

    spec, n = _spec(structure)
    chunk = load().rl8_chains_chunk_rows(N, structure[0], spec, n)
    saved = load().rl8_chains_workspace(N, structure[0], spec, n, 2)
    check(staged_chunk_rows(structure, N) == chunk,
          f"the route rule's mirror: {staged_chunk_rows(structure, N)} chunk rows, the library {chunk}")
    check(saved >= 0 and (saved > 0) == staged_saves(structure, N) and (saved == 0 or chunk == N),
          f"the saved layout: {saved} floats at chunk {chunk} of {N}, the mirror {staged_saves(structure, N)}")
    return "tiled" if chunk == 0 else "staged_saved" if saved > 0 else "staged_recompute"


def check_saved_backward(torch, what: str, x, chains, activation: str, douts, k_outs, k_dx, k_dflat) -> dict:
    """Where the chain backward takes its saving route (backward_rule), a
    saving forward's outputs bit-identical to the forward's ``k_outs`` and
    the saved backward from the same cotangents bit-identical to the
    recompute route's ``k_dx``, ``k_dflat`` (the same kernels and sums, so
    also within the limits that those are held to). Returns the route and
    what was checked."""
    from rl8_tpu_torch.ops import fused_chains_bwd, fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, flatten_chains

    t0 = time.perf_counter()
    structure, flat, N = chain_structure(chains), flatten_chains(chains), x.shape[0]
    route = backward_rule(torch, structure, N)
    if route != "staged_saved":
        return {"backward_route": route}
    s_outs, kept = fused_chains_fwd(x, flat, structure, activation, save=True)
    check(kept is not None, f"{what}: the saving forward kept its workspace")
    s_dx, s_dflat = fused_chains_bwd(x, flat, structure, activation, douts, saved=kept)
    del kept
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(s_outs, k_outs)),
          f"{what}: the saving forward's outputs bit-identical to the forward's")
    check(torch.equal(s_dx, k_dx) and torch.equal(s_dflat, k_dflat),
          f"{what}: the saved backward bit-identical to the recompute route's")
    SAVED_CHECK_SECONDS[0] += time.perf_counter() - t0
    return {"backward_route": route, "saving_forward_bit_identical": True,
            "saved_bit_identical_to_recompute": True}


def compare_chains(torch, what: str, x, chains, activation: str, seed: int, staged: bool = False,
                   f64_fallback: bool = False) -> dict:
    """The chain kernels against their plain versions on ``x``: the forward
    twice (bit-identical), every head output within CHAIN_RTOL/ATOL, then
    from random head cotangents the backward twice (bit-identical) against
    the plain backward (``chains_vjp_plain``'s arithmetic): dx within
    CHAIN_RTOL/ATOL and each parameter gradient within PPO_GRAD_* by norm,
    all finite, every row. ``staged``: the backward takes its staged route,
    and the plain backward runs on the kernels' own activations
    (kernel_activations, each within CHAIN_RTOL/ATOL of the plain forward's),
    so that both take the same relu masks; where the route rule saves the
    activations (backward_rule), the saving forward and the saved backward
    are held to the recompute route's (check_saved_backward: bit-identical,
    so the saved gradients pass the same comparisons). ``f64_fallback``: where the
    plain f32 backward is no reference (its dx off the float64 backward's,
    run on the same activations, by CHAIN_RTOL/ATOL on some element, or a
    gradient by PPO_GRAD_RTOL / 2 of its norm: down deep LayerNorm chains
    f32 sums drift), dx and each gradient are held to float64 by f64_rule
    instead (slack PPO_GRAD_* of the norm; the control the plain backward
    with one-pass TF32 products)."""
    from rl8_tpu_torch.ops import fused_chains_bwd, fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import _backward, _forward_block, chain_structure, flatten_chains, unflatten_chains

    structure = chain_structure(chains)
    flat = flatten_chains(chains)
    k_outs = fused_chains_fwd(x, flat, structure, activation)
    k2_outs = fused_chains_fwd(x, flat, structure, activation)
    p_chain_outs, p_hs, p_aux = _forward_block(x, chains, activation)
    p_outs = [o for chain in p_chain_outs for o in chain]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(k_outs, k2_outs)), f"{what}: two forward launches bit-identical")
    fwd_err = 0.0
    for i, (k, p) in enumerate(zip(k_outs, p_outs)):
        check(bool(torch.isfinite(k).all()), f"{what}: head {i} output finite")
        check(torch.allclose(k, p, rtol=CHAIN_RTOL, atol=CHAIN_ATOL), f"{what}: head {i} output")
        fwd_err = max(fwd_err, float((k - p).abs().max()))
    hidden_err = None
    if staged:
        k_hs = kernel_activations(torch, x, chains, activation)
        hidden_err = 0.0
        for c, (kh, ph) in enumerate(zip(k_hs, p_hs)):
            for depth, (k, p) in enumerate(zip(kh[1:], ph[1:]), start=1):
                check(torch.allclose(k, p, rtol=CHAIN_RTOL, atol=CHAIN_ATOL), f"{what}: chain {c} h_{depth}")
                hidden_err = max(hidden_err, float((k - p).abs().max()))
        p_hs = k_hs
    gen = torch.Generator(device=x.device).manual_seed(seed)
    douts = [torch.randn(o.shape, generator=gen, device=x.device) for o in p_outs]
    k_dx, k_dflat = fused_chains_bwd(x, flat, structure, activation, douts)
    k2_dx, k2_dflat = fused_chains_bwd(x, flat, structure, activation, douts)
    grouped, i = [], 0
    for _, heads in structure[1]:
        grouped.append(douts[i : i + len(heads)])
        i += len(heads)
    p_dchains, p_dx = _backward(chains, activation, p_hs, p_aux, grouped, need_dx=True)
    torch.cuda.synchronize()
    check(torch.equal(k_dx, k2_dx) and torch.equal(k_dflat, k2_dflat), f"{what}: two backward launches bit-identical")
    check(bool(torch.isfinite(k_dx).all() and torch.isfinite(k_dflat).all()), f"{what}: gradients finite")
    record = {"fwd_max_abs_err": fwd_err, "hidden_max_abs_err": hidden_err, "bit_identical": True}
    if staged:
        del k2_dx, k2_dflat
        record.update(check_saved_backward(torch, what, x, chains, activation, douts, k_outs, k_dx, k_dflat))
    k_tensors = [k_dx, *chain_tensors(unflatten_chains(k_dflat, structure))]
    p_tensors = [p_dx, *chain_tensors(p_dchains)]
    if f64_fallback:
        c64 = chains_f64(torch, chains)
        _, f_hs, f_aux = _forward_block(x.double(), c64, activation)
        if staged:  # the kernels' activations, so that all take their relu masks
            for c, hs in enumerate(p_hs):
                for depth, h in enumerate(hs):
                    f_hs[c][depth] = h.double()
        f_dchains, f_dx = _backward(c64, activation, f_hs, f_aux, [[d.double() for d in g] for g in grouped],
                                    need_dx=True)
        del f_hs, f_aux
        f_tensors = [f_dx, *chain_tensors(f_dchains)]
        rel = lambda a, f: float((a.double() - f).norm()) / max(float(f.norm()), 1e-30)  # noqa: E731
        record["plain_off_float64"] = max(rel(p, f) for p, f in zip(p_tensors, f_tensors))
        if not (torch.allclose(p_dx.double(), f_dx, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
                and max(rel(p, f) for p, f in zip(p_tensors[1:], f_tensors[1:])) <= PPO_GRAD_RTOL / 2):
            c_dchains, c_dx = tf32_control(torch, lambda: _backward(chains, activation, p_hs, p_aux, grouped,
                                                                    need_dx=True))
            c_tensors = [c_dx, *chain_tensors(c_dchains)]
            rows = {f"{i} {tuple(f.shape)}": f64_rule(k, p, f, PPO_GRAD_RTOL * float(f.norm()) + PPO_GRAD_ATOL, c)
                    for i, (k, p, c, f) in enumerate(zip(k_tensors, p_tensors, c_tensors, f_tensors))}
            return {**record, **check_f64(what, rows), "max_abs_err": None}
        record["held_to"] = "plain_f32"
    check(torch.allclose(k_dx, p_dx, rtol=CHAIN_RTOL, atol=CHAIN_ATOL),
          f"{what}: dx, largest error {float((k_dx - p_dx).abs().max()):.3g}")
    worst_grad = 0.0
    for kt, pt in zip(k_tensors[1:], p_tensors[1:]):
        err, ref = float((kt - pt).norm()), float(pt.norm())
        worst_grad = max(worst_grad, err / max(ref, 1e-30))
        check(err <= PPO_GRAD_RTOL * ref + PPO_GRAD_ATOL,
              f"{what}: gradient {tuple(pt.shape)} error {err:.3g} vs norm {ref:.3g}")
    return {**record, "dx_max_abs_err": float((k_dx - p_dx).abs().max()), "worst_grad_norm_rel_err": worst_grad,
            "max_abs_err": max(fwd_err, float((k_dx - p_dx).abs().max()),
                               float((k_dflat - flatten_chains(p_dchains)).abs().max()))}


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


def chain_bwd_bounds(record: dict, fwd_flops: int, bwd_flops: int, bwd_bytes: int, saved_bytes: int = 0) -> dict:
    """The chain backward's bounds, as its kernels run the products:
    bound_ms with the recompute (the forward's operations) at the f32 rate
    and the dh and weight products (the rest) in 3xTF32 on the tensor
    cores; bound_tc_ms with all of it in 3xTF32 (update_bounds). On the
    saved route (``saved_bytes``: the saved activations it reads, an input
    then), no recompute: both bounds are the products in 3xTF32, or those
    bytes and the rest."""
    if saved_bytes:
        ops_s = TF32_PRODUCTS * (bwd_flops - fwd_flops) / PEAK_TF32_FLOPS
        byte_s = (bwd_bytes + saved_bytes) / PEAK_BYTES_PER_S
        record["bound_ms"] = record["bound_tc_ms"] = 1e3 * max(ops_s, byte_s)
        record["bound_by"] = "operations" if ops_s > byte_s else "bytes"
        return record
    update_bounds(record, bwd_flops, bwd_bytes)
    ops_s = fwd_flops / PEAK_F32_FLOPS + TF32_PRODUCTS * (bwd_flops - fwd_flops) / PEAK_TF32_FLOPS
    byte_s = bwd_bytes / PEAK_BYTES_PER_S
    record["bound_ms"] = 1e3 * max(ops_s, byte_s)
    record["bound_by"] = "operations" if ops_s > byte_s else "bytes"
    return record


def check_chains(torch, dev, fwd_record: dict, bwd_record: dict) -> None:
    """The chain kernels against their plain versions on the card
    (compare_chains): (a) MischievousMule's chains at the main path's
    4,096 rollout rows and 32,768 minibatch rows; (b) a ragged 1,000 rows
    of three tanh chains with mixed LayerNorm flags, 48 and 100 wide, two
    heads (2 and 9 wide) on one chain, at d_in 1 and 64; (c) rows whose pre-LayerNorm
    values are constant (zero variance); (d) one 768-wide LayerNorm chain
    at d_in 7; (e) 160- and 136-wide layers (the tiled forward's passes of
    128 columns and its separate LayerNorm and head passes); (f) one
    4096-wide LayerNorm chain at d_in 7, which the card refused before the
    staged routes. (a) to (c) must take the forward's and the backward's
    tiled routes (chains_fwd_tiles_kernel, chains_bwd_tiles_kernel), (d) and
    (f) their staged routes (chains_layer_kernel: the tile buffers do not
    fit a block; chains_dh_kernel: the parameters and gradients do not), (e)
    the tiled forward and the staged backward; at (a) the route rule
    (backward_rule, its mirror held to the library) answers tiled: the
    backward recomputes. Then each kernel timed beside its plain version at
    the main path's shapes, with its bounds."""
    from rl8_tpu_torch.ops import chains_vjp_plain, forward_chains, fused_chains_bwd, fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, default_chains, flatten_chains

    mule = make_mule(torch, seed=5).to(dev)
    mule_chains = default_chains(mule)
    gen = torch.Generator(device=dev).manual_seed(6)
    xs = {N: 0.5 * torch.randn((N, 7), generator=gen, device=dev) for N in (4096, 32768)}
    for N, x in xs.items():
        result = compare_chains(torch, f"chains (a, N={N})", x, mule_chains, "relu", seed=N)
        rule = backward_rule(torch, chain_structure(mule_chains), N)
        check(rule == "tiled", f"chains (a, N={N}): the route rule answers {rule}")
        emit({"phase": "kernel_check", "kernel": "chains", "config": "a", "N": N, **result,
              "route": backward_route(torch, x, mule_chains, "relu"), "route_rule": rule,
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
    result = compare_chains(torch, "chains (e, 160/136 wide)", x, wider, "relu", seed=10, staged=True)
    emit({"phase": "kernel_check", "kernel": "chains", "config": "e", "N": 1000, "widths": [160, 136], **result,
          "route": backward_route(torch, x, wider, "relu", "staged"),
          "forward_route": forward_route(torch, x, wider, "relu")})
    near = random_chains(torch, dev, seed=8, d_in=7, layout=(([(768, True)], [3]),))
    x = 0.5 * torch.randn((1000, 7), generator=gen, device=dev)
    result = compare_chains(torch, "chains (d, 768 wide)", x, near, "relu", seed=8, staged=True)
    emit({"phase": "kernel_check", "kernel": "chains", "config": "d", "N": 1000, "width": 768, **result,
          "route": backward_route(torch, x, near, "relu", "staged"),
          "forward_route": forward_route(torch, x, near, "relu", "staged")})
    # (f): the kernels' only limits are their counts: a 4096-wide layer,
    # refused before the staged routes, is taken by the query and by the
    # wrapper, and equals the plain version.
    from rl8_tpu_torch.ops import card_takes_chains

    wide = random_chains(torch, dev, seed=9, d_in=7, layout=(([(4096, True)], [3]),))
    check(card_takes_chains(mule_chains), "chains: the kernels refuse the main path's chains")
    check(card_takes_chains(wide), "chains: the kernels refuse a 4096-wide layer")
    x = 0.5 * torch.randn((1000, 7), generator=gen, device=dev)
    result = compare_chains(torch, "chains (f, 4096 wide)", x, wide, "relu", seed=9, staged=True)
    emit({"phase": "kernel_check", "kernel": "chains", "config": "f", "N": 1000, "width": 4096, **result,
          "route": backward_route(torch, x, wide, "relu", "staged"),
          "forward_route": forward_route(torch, x, wide, "relu", "staged")})

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
    fwd_flops, _, bwd_flops, bwd_bytes = chain_counts(structure, N)
    douts = [torch.randn((N, w), generator=gen, device=dev) for w in (3, 1)]
    ms, host_ms = time_ms(torch, lambda: fused_chains_bwd(x, flat, structure, "relu", douts), iters=20, warmup=2)
    plain_ms, _ = time_ms(torch, lambda: chains_vjp_plain(x, mule_chains, "relu", [douts[:1], douts[1:]]),
                          iters=10, warmup=2)
    bwd_record.update(ms=ms, plain_ms=plain_ms, host_ms=host_ms)
    chain_bwd_bounds(bwd_record, fwd_flops, bwd_flops, bwd_bytes)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_chains_bwd(x, flat, structure, "relu", douts)
        torch.cuda.synchronize()
    split = {e.key[:60]: e.self_device_time_total / 1e3 for e in prof.key_averages() if e.self_device_time_total > 0}
    emit({"phase": "kernel_time", "kernel": "chains_bwd", "N": N, "flops": bwd_flops, "bytes": bwd_bytes,
          "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bwd_record["bound_ms"],
          "bound_tc_ms": bwd_record["bound_tc_ms"], "split_ms": split})


def custom_model(torch, name: str, seed: int):
    """AttentiveAlpaca or LazyLemur at its defaults, as the custom-model
    phases build them, on the CPU, with the logits head re-drawn at lecun
    scale."""
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, AttentiveAlpaca, LazyLemur
    from rl8_tpu_torch.models import lecun_normal_

    env = AlgoTrading(1, device="cpu")
    model = {"alpaca": AttentiveAlpaca, "lemur": LazyLemur}[name](env.observation_spec, env.action_spec)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    with torch.no_grad():
        lecun_normal_(model.feature_head.weight, gen)
    return model


def surface_model_cls(torch):
    """The ``surface`` phase's model class: a custom feedforward model for
    ``AlgoTrading`` written as a user of ``rl8_tpu`` writes one with its
    arguments, at MischievousMule's widths (d_in 7: a 2-wide embedding of
    the invested flag, the position's log change and four interval sums of
    a 4-step price window; twin (128, 128) LayerNorm torsos, heads of 3 and
    1). Its input assembly embeds through ``OneHotEmbed(2, 2, dtype=dtype)``
    (bf16 by default), its torsos are ``MLP(..., dropout=0.1)`` called
    deterministically, and it declares a ``FusedApplySpec`` over the two
    chains. ``tests/test_torch_surface.py`` holds it against a flax twin
    built from ``rl8_tpu``'s modules."""
    from torch import nn

    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.examples.algotrading.models._common import action_mask_logits
    from rl8_tpu_torch.models import GenericModel, lecun_normal_
    from rl8_tpu_torch.nn import MLP, OneHotEmbed, dense
    from rl8_tpu_torch.nn.modules.mlp import prefixed
    from rl8_tpu_torch.ops.fused_mlp import FusedApplySpec
    from rl8_tpu_torch.views import ViewRequirement

    class SurfaceModel(GenericModel):
        def __init__(self, observation_spec, action_spec, /, *, hiddens=(128, 128), dropout: float = 0.1,
                     seq_len: int = 4, dtype=torch.bfloat16) -> None:
            super().__init__(observation_spec, action_spec)
            self.hiddens, self.seq_len, self.dtype, self.activation_fn = tuple(hiddens), seq_len, dtype, "relu"
            self.invested_embedding = OneHotEmbed(2, 2, dtype=dtype)
            torso = lambda: MLP(7, self.hiddens, layer_norm=True, dropout=dropout, dtype=dtype)  # noqa: E731
            self.feature_model, self.vf_model = torso(), torso()
            self.feature_head = nn.Linear(self.hiddens[-1], 3)
            self.vf_head = nn.Linear(self.hiddens[-1], 1)

        @property
        def view_requirements(self) -> dict:
            return {DataKeys.OBS: ViewRequirement(shift=0),
                    (DataKeys.OBS, "LOG_CHANGE(price)"): ViewRequirement(shift=self.seq_len)}

        def extra_jax_params(self) -> dict:
            return prefixed(("invested_embedding",), self.invested_embedding.jax_leaves())

        def reset_parameters(self, generator) -> None:
            with torch.no_grad():
                self.invested_embedding.reset_parameters(generator)
                for layer in (*self.feature_model.layers, *self.vf_model.layers, self.feature_head, self.vf_head):
                    lecun_normal_(layer.weight, generator)
                    layer.bias.zero_()

        def assemble(self, obs: dict):
            price, L = obs["LOG_CHANGE(price)"][DataKeys.INPUTS], self.seq_len
            sums = [price[:, : L // 4], price[:, : L // 2], price[:, -(L // 2):], price[:, -(L // 4):]]
            x = torch.cat([self.invested_embedding(obs["invested"].reshape(-1)), obs["LOG_CHANGE(price, position)"],
                           *(w.sum(dim=1) for w in sums)], dim=-1)
            return x if self.dtype is None else x.to(self.dtype)

        def forward(self, batch):
            obs = batch[DataKeys.OBS]
            x = self.assemble(obs)
            logits = dense(self.feature_head, torch.relu(self.feature_model(x)), self.dtype)
            values = dense(self.vf_head, torch.relu(self.vf_model(x)), self.dtype)
            return {"logits": logits.float().reshape(-1, 1, 3) + action_mask_logits(obs)}, values.float()

        def fused_apply_spec(self):
            def finalize(batch, outs):
                (logits,), (values,) = outs
                return {"logits": logits.reshape(-1, 1, 3) + action_mask_logits(batch[DataKeys.OBS])}, values

            return FusedApplySpec(assemble=lambda batch: self.assemble(batch[DataKeys.OBS]), finalize=finalize,
                                  chain_names=(("feature_model", ("feature_head",)), ("vf_model", ("vf_head",))))

    return SurfaceModel


#: The custom-model cells' chains: AttentiveAlpaca's (d_in 11: the
#: invested embedding, the position's log change and the pooled 8-wide
#: attention output; 44-byte rows) and LazyLemur's (d_in 64: the LSTM
#: latent), both twin (64, 64) LayerNorm torsos with heads of 3 and 1, at
#: the rollout's 4,096 rows and a minibatch's 32,768 (LazyLemur: 8,192
#: sequences of 4 steps).
MODEL_CHAIN_ROWS = (4096, 32768)


def check_model_chains(torch, dev, fwd_record: dict, bwd_record: dict) -> None:
    """The chain kernels against their plain versions (compare_chains) at
    the custom-model cells' chains and row counts (MODEL_CHAIN_ROWS),
    each route the forward and the backward took (not asserted: a row of
    44 bytes is not 16-byte aligned), and each launch timed beside its
    plain version with its bound. Adds the records to the chain kernels'
    under ``model_shapes``."""
    from rl8_tpu_torch.ops import chains_vjp_plain, forward_chains, fused_chains_bwd, fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, default_chains, flatten_chains

    gen = torch.Generator(device=dev).manual_seed(12)
    fwd_record["model_shapes"], bwd_record["model_shapes"] = [], []
    for name, seed in (("alpaca", 13), ("lemur", 14)):
        chains = default_chains(custom_model(torch, name, seed).to(dev))
        structure, flat = chain_structure(chains), flatten_chains(chains)
        check(structure[0] == {"alpaca": 11, "lemur": 64}[name], f"{name}'s chains take d_in {structure[0]}")
        for N in MODEL_CHAIN_ROWS:
            x = 0.5 * torch.randn((N, structure[0]), generator=gen, device=dev)
            result = compare_chains(torch, f"chains ({name}, N={N})", x, chains, "relu", seed=N + seed)
            routes = {"forward_route": forward_route(torch, x, chains, "relu", None),
                      "route": backward_route(torch, x, chains, "relu", None)}
            fwd_flops, fwd_bytes, bwd_flops, bwd_bytes = chain_counts(structure, N)
            ms, _ = time_ms(torch, lambda: fused_chains_fwd(x, flat, structure, "relu"), iters=30)
            plain_ms, _ = time_ms(torch, lambda: forward_chains(x, chains, "relu"), iters=10)
            fwd_record["model_shapes"].append({"model": name, "N": N, "d_in": structure[0], "ms": ms,
                                               "plain_ms": plain_ms, "bound_ms": bound(fwd_flops, fwd_bytes)[0],
                                               "route": routes["forward_route"]})
            record = {"phase": "kernel_check", "kernel": "chains", "config": name, "N": N, "d_in": structure[0],
                      **result, **routes, "fwd_ms": ms, "fwd_plain_ms": plain_ms,
                      "fwd_bound_ms": bound(fwd_flops, fwd_bytes)[0]}
            if N == MODEL_CHAIN_ROWS[-1]:
                douts = [torch.randn((N, w), generator=gen, device=dev) for w in (3, 1)]
                ms, _ = time_ms(torch, lambda: fused_chains_bwd(x, flat, structure, "relu", douts), iters=10, warmup=2)
                plain_ms, _ = time_ms(torch, lambda: chains_vjp_plain(x, chains, "relu", [douts[:1], douts[1:]]),
                                      iters=5, warmup=1)
                bwd_bound = chain_bwd_bounds({}, fwd_flops, bwd_flops, bwd_bytes)["bound_ms"]
                bwd_record["model_shapes"].append({"model": name, "N": N, "d_in": structure[0], "ms": ms,
                                                   "plain_ms": plain_ms, "bound_ms": bwd_bound,
                                                   "route": routes["route"]})
                record.update(bwd_ms=ms, bwd_plain_ms=plain_ms, bwd_bound_ms=bwd_bound)
            emit(record)


def launched_route(torch, what: str, fn, routes: dict, want: None | str, calls: int = 3) -> str:
    """The route that calls of ``fn`` took (``routes`` maps kernel names to
    routes; the kernels that ``calls`` calls launched, from
    ``torch.profiler``), which must be ``want`` (``None``: one route,
    whichever it is). The profiler sometimes returns no record of a short
    launch at all (once, after a profiled window of ~2,000 kernels, three
    windows in a row held only the host's calls; once five windows in a row
    of a ragged recurrent act launch): a window that saw none of the kernels
    is taken again, up to eight windows, each after the first with more
    calls and held open longer past the launches for late device records;
    any kernel it does see counts."""
    from torch.profiler import ProfilerActivity, profile

    took: list = []
    for attempt in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls * (1 + attempt)):
                fn()
            torch.cuda.synchronize()
            if attempt:
                time.sleep(0.5 * attempt)
        names = [e.key for e in prof.key_averages()]
        took = [route for kernel, route in routes.items() if any(re.search(rf"\b{kernel}\b", n) for n in names)]
        if took:
            break
    check(took == [want] if want else len(took) == 1,
          f"{what} took {took}, not the {want} route (kernels: {[n[:90] for n in names][:12]})")
    return took[0]


def backward_route(torch, x, chains, activation: str, want: None | str = "tiled", calls: int = 3) -> str:
    """The route the chain backward took on ``chains``, which must be
    ``want`` (from ``calls`` launches)."""
    from rl8_tpu_torch.ops import fused_chains_bwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, flatten_chains

    structure = chain_structure(chains)
    douts = [torch.zeros((x.shape[0], w), device=x.device) for _, heads in structure[1] for w in heads]
    routes = {"chains_bwd_tiles_kernel": "tiled", "chains_dh_kernel": "staged"}
    return launched_route(torch, "the chain backward",
                          lambda: fused_chains_bwd(x, flatten_chains(chains), structure, activation, douts),
                          routes, want, calls)


def forward_route(torch, x, chains, activation: str, want: None | str = "tiled") -> str:
    """The route the chain forward took on ``chains``, which must be
    ``want``."""
    from rl8_tpu_torch.ops import fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, flatten_chains

    routes = {"chains_fwd_tiles_kernel": "tiled", "chains_layer_kernel": "staged"}
    return launched_route(
        torch, "the chain forward",
        lambda: fused_chains_fwd(x, flatten_chains(chains), chain_structure(chains), activation), routes, want,
    )


def mule_layout(width: int) -> tuple:
    """MischievousMule's chains at ``hiddens=(width, width)`` (and
    AttentiveAlpaca's and LazyLemur's, at their own d_in): two chains of a
    LayerNorm layer and a plain one, with heads of 3 and 1."""
    return (([(width, True), (width, False)], [3]), ([(width, True), (width, False)], [1]))


def torso_layout(width: int) -> tuple:
    """A default discrete model's chains at ``hiddens=(width, width)`` on
    ``DiscreteDummyEnv`` (``fused_forward``): two plain layers a chain,
    heads of 2 logits and 1 value."""
    return (([(width, False), (width, False)], [2]), ([(width, False), (width, False)], [1]))


#: ``run_chains_wide_sweep``'s shapes, none of which the tiled routes take:
#: ``(name, d_in, layout, rows)``. MischievousMule's layout (d_in 7) from
#: the card's first refused width before the staged routes (896) to
#: rl8_tpu's last admitted one (2382, ``chains_fit_vmem``), with
#: ``wide_custom``'s 2048 between, LazyLemur's (d_in 64; 2354) and a default twin torso (d_in 1; 2388) at rl8_tpu's
#: last admitted widths, AttentiveAlpaca's (d_in 11), check (d)'s 768-wide LayerNorm
#: chain, the 4096-wide one that the card refused before, and ragged
#: chains (three depths; a 9-wide head on a 1200-wide chain) at ragged row
#: counts.
CHAINS_WIDE = (
    ("mule_896", 7, mule_layout(896), (4096, 32768)),
    ("mule_1024", 7, mule_layout(1024), (4096, 32768)),
    ("mule_1536", 7, mule_layout(1536), (4096, 32768, 4999)),
    ("mule_2048", 7, mule_layout(2048), (4096, 32768)),
    ("mule_2382", 7, mule_layout(2382), (4096, 32768)),
    ("lemur_2354", 64, mule_layout(2354), (4096, 32768)),
    ("alpaca_1024", 11, mule_layout(1024), (4096, 32768)),
    ("torso_2388", 1, torso_layout(2388), (4096, 32768)),
    ("ln_768", 7, (([(768, True)], [3]),), (4096, 32768)),
    ("ln_4096", 7, (([(4096, True)], [3]),), (4096, 32768)),
    ("ragged", 5, (([(1200, True), (900, False), (700, True)], [9, 2]), ([(1500, False)], [1]),
                   ([(1000, True), (1000, False)], [4])), (1000, 4097)),
)
#: Rows of the chains' timed launches: the rollout step's and the
#: minibatch's of the custom cells.
CHAIN_TIMED_ROWS = (4096, 32768)


def chain_backward_bytes(structure, N: int) -> dict:
    """The chain backward's workspace and the part of it that its weight
    products' partials take, in bytes, on N rows, as csrc/chains.cu
    answers them (rl8_chains_workspace, rl8_chains_partials)."""
    from rl8_tpu_torch.ops._build import load
    from rl8_tpu_torch.ops.fused_mlp import _spec

    spec, n = _spec(structure)
    return {"workspace_bytes": 4 * load().rl8_chains_workspace(N, structure[0], spec, n, 1),
            "partial_bytes": 4 * load().rl8_chains_partials(N, structure[0], spec, n)}


def run_chains_wide_sweep(torch, dev, kernels: dict) -> None:
    """Both chain kernels on their staged routes at CHAINS_WIDE's shapes:
    each against its plain version (compare_chains, staged: the forward
    and the hidden activations at CHAIN_RTOL/ATOL, dx too, the gradients
    by PPO_GRAD_*'s norm-relative error, two launches bit-identical), the
    route each launched
    (launched_route: the staged kernels, chains_layer_kernel and
    chains_dh_kernel), and each timed beside its plain version with its
    bounds at CHAIN_TIMED_ROWS (the backward at the minibatch's rows, with
    its workspace and partials' bytes, chain_backward_bytes; on its saved
    route where the route rule saves, backward_rule). Where it saves, the
    saved backward is held bit-identical to the recompute route's
    (compare_chains' check_saved_backward). Adds the records to the chain
    kernels' under ``wide``."""
    from rl8_tpu_torch.ops.fused_mlp import chain_structure

    gen = torch.Generator(device=dev).manual_seed(31)
    fwd_records, bwd_records = [], []
    for i, (name, d_in, layout, rows) in enumerate(CHAINS_WIDE):
        chains = random_chains(torch, dev, seed=40 + i, d_in=d_in, layout=layout)
        structure = chain_structure(chains)
        for N in rows:
            x = 0.5 * torch.randn((N, d_in), generator=gen, device=dev)
            result = compare_chains(torch, f"chains_wide ({name}, N={N})", x, chains, "relu", seed=N + i,
                                    staged=True)
            record = {"phase": "chains_wide_sweep", "shape": name, "d_in": d_in, "N": N, **result,
                      "forward_route": forward_route(torch, x, chains, "relu", "staged"),
                      "route": backward_route(torch, x, chains, "relu", "staged")}
            if N in CHAIN_TIMED_ROWS:
                big = N * max(w for layers, _ in layout for w, _ in layers) >= 2**25
                record["fwd"] = {"shape": name, "route": "staged",
                                 **time_chain_kernel(torch, x, chains, False, 5 if big else 20)}
                fwd_records.append(record["fwd"])
            if N == CHAIN_TIMED_ROWS[-1]:
                record["bwd"] = {"shape": name, "route": "staged", **chain_backward_bytes(structure, N),
                                 **time_chain_kernel(torch, x, chains, True, 3)}
                bwd_records.append(record["bwd"])
            emit(record)
        del chains, x
        torch.cuda.empty_cache()
    kernels["chains_fwd"]["wide"], kernels["chains_bwd"]["wide"] = fwd_records, bwd_records


def chain_gate_model(torch, name: str, width: int):
    """A model of the chain gate grid at ``hiddens=(width, width)``, built
    without values (the ``meta`` device): MischievousMule (``mule``) and
    AttentiveAlpaca (``alpaca``) on AlgoTrading, LazyLemur (``lemur``, LSTM
    hidden 64) as a recurrent policy's model, and the default discrete
    model (``torso``) on DiscreteDummyEnv's spaces (its chains with
    ``fused_forward``)."""
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, AttentiveAlpaca, LazyLemur, MischievousMule
    from rl8_tpu_torch.models import DefaultDiscreteModel
    from rl8_tpu_torch.policies import Policy, RecurrentPolicy
    from rl8_tpu_torch.specs import Discrete, Unbounded

    env = AlgoTrading(1, device="cpu")
    config = {"hiddens": (width, width)}
    with torch.device("meta"):
        if name == "torso":
            return DefaultDiscreteModel(Unbounded(1), Discrete(2, shape=(1,)), hiddens=(width, width))
        if name == "lemur":
            return RecurrentPolicy(env.observation_spec, env.action_spec, model_cls=LazyLemur,
                                   model_config={**config, "hidden_size": 64}).model
        cls = {"mule": MischievousMule, "alpaca": AttentiveAlpaca}[name]
        return Policy(env.observation_spec, env.action_spec, model_cls=cls, model_config=config).model


CHAIN_GATE_MODELS = ("mule", "alpaca", "lemur", "torso")


def check_chain_gate_grid(torch) -> None:
    """For each model of CHAIN_GATE_MODELS, at the widths that
    ``tests/test_torch_wide.py``'s custom-model gate test visits (64, 768,
    1024, 2048, the last width rl8_tpu's residency gate admits, the next,
    4096): wherever ``chains_fit_vmem`` (rl8_tpu's gate, the port's route)
    admits the model's chains, ``card_takes_chains`` takes them, so the
    route on the card is the gate's; past the gate the card's kernels take
    them as well (their only limits are the counts)."""
    from rl8_tpu_torch.ops import card_takes_chains, chains_fit_vmem
    from rl8_tpu_torch.ops.fused_mlp import chain_names, named_chains

    def chains_of(name: str, width: int):
        model = chain_gate_model(torch, name, width)
        return named_chains(model, chain_names(model))

    grid = {}
    for name in CHAIN_GATE_MODELS:
        lo, hi = 64, 8192
        check(chains_fit_vmem(chains_of(name, lo)) and not chains_fit_vmem(chains_of(name, hi)),
              f"chain gate grid: {name} flips between {lo} and {hi}")
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if chains_fit_vmem(chains_of(name, mid)) else (lo, mid)
        row = {}
        for width in sorted({64, 768, 1024, 2048, lo, lo + 1, 4096}):
            chains = chains_of(name, width)
            fits, takes = chains_fit_vmem(chains), card_takes_chains(chains)
            check(takes or not fits, f"chain gate grid: the card refuses {name} at {width}, which the gate admits")
            row[width] = {"fits": fits, "card_takes": takes}
        grid[name] = {"last_admitted": lo, "widths": row}
    emit({"phase": "chain_gate_grid", "grid": grid})


def run_wide_chain_builds(torch, dev) -> None:
    """The builds that raised at build on the card before the staged chain
    routes, each built and trained for one collect() and step() at 256 envs
    and horizon 8 (launch counters set to 0 just before and read just
    after; the chain kernels must launch, stats and parameters finite):
    MischievousMule at ``hiddens=(2382, 2382)`` with ``fused_forward``,
    LazyLemur at 2354 (LSTM hidden 64; seq_len 4, a state reset every 2
    sequences), and a default discrete model at 2388 with ``fused_forward``
    (its act and update kernels take it; the chain forward computes the
    bootstrap value)."""
    from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, LazyLemur, MischievousMule
    from rl8_tpu_torch.ops import fused_chains_bwd, fused_chains_fwd

    builds = (
        ("mule_2382", lambda: AlgorithmConfig(model_cls=MischievousMule, fused_forward=True, num_envs=256, horizon=8,
                                              model_config={"hiddens": (2382, 2382)}, device=dev).build(AlgoTrading)),
        ("lemur_2354", lambda: RecurrentAlgorithmConfig(
            model_cls=LazyLemur, fused_forward=True, num_envs=256, horizon=8, seq_len=4, seqs_per_state_reset=2,
            model_config={"hiddens": (2354, 2354), "hidden_size": 64}, device=dev).build(AlgoTrading)),
        ("torso_2388", lambda: AlgorithmConfig(fused_forward=True, num_envs=256, horizon=8,
                                               model_config={"hiddens": (2388, 2388)},
                                               device=dev).build(DiscreteDummyEnv)),
    )
    seen = {}
    for name, build in builds:
        algo = build()
        check(algo._fused_forward, f"{name}: fused_forward is off")
        zero_counters()
        algo.collect()
        stats = algo.step()
        torch.cuda.synchronize()
        fwd, bwd = fused_chains_fwd.launches, fused_chains_bwd.launches
        check(fwd > 0 and (bwd > 0 or name == "torso_2388"), f"{name}: chain launches (fwd, bwd) {(fwd, bwd)}")
        check(all(math.isfinite(v) for v in stats.values()), f"{name}: step stats finite: {stats}")
        for pname, param in algo.policy.model.named_parameters():
            check(bool(torch.isfinite(param).all()), f"{name}: parameter {pname} finite")
        seen[name] = {"chains_fwd": fwd, "chains_bwd": bwd, "losses/total": stats["losses/total"]}
        del algo
        torch.cuda.empty_cache()
    emit({"phase": "wide_chain_builds", "builds": seen})


def step_minibatch_grads(torch, algo, control: bool = False):
    """One minibatch of a freshly collected buffer through the step's
    gradient function (``_autodiff_grads_fn``, advantages from the GAE
    kernel, rows packed as ``step`` packs them) from the same parameters:
    twice with ``fused_forward`` (the chain kernels) and once on the module
    route (with ``control`` once more with one-pass TF32 products).
    Returns ``(fused losses, fused grads, second fused grads, module
    losses, module grads, minibatch, unpacker, control grads or None)``."""
    from rl8_tpu_torch.algorithms._feedforward import _t2b
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.ops import pack_rows

    h = algo.hparams
    algo.collect()
    buffer = algo.state.buffer
    with torch.no_grad():
        advantages, returns = algo._advantages()
        packed, unpack = pack_rows({
            DataKeys.ACTIONS: _t2b(buffer[DataKeys.ACTIONS]), DataKeys.LOGP: _t2b(buffer[DataKeys.LOGP]),
            DataKeys.ADVANTAGES: _t2b(advantages), DataKeys.RETURNS: _t2b(returns),
            DataKeys.VIEWS: algo._training_views(buffer),
        })
    mb = packed[: packed.shape[0] // h.num_minibatches]
    flat = algo._flat_params()

    def grads(fused: bool):
        algo._fused_forward = fused
        return algo._autodiff_grads_fn(lambda batch: (*algo._apply_model(batch[DataKeys.VIEWS]), batch),
                                       unpack, 0.0, 1)(flat, mb)

    k_losses, _, k_grads = grads(True)
    _, _, k2_grads = grads(True)
    p_losses, _, p_grads = grads(False)
    c_grads = tf32_control(torch, lambda: grads(False)[2]) if control else None
    algo._fused_forward = True
    return k_losses, k_grads, k2_grads, p_losses, p_grads, mb, unpack, c_grads


def check_step_gradients(torch, algo, what: str, f64_fallback: bool = False) -> dict:
    """step_minibatch_grads' gradients: the two fused ones bit-identical,
    the fused losses within PPO_STAT_* of the module route's (autograd
    through the modules, the plain version on the card), and each fused
    gradient tensor within PPO_GRAD_* of the module route's by norm,
    finite. ``f64_fallback``: where the module route's f32 gradient is no
    reference (a tensor off the module route's on a float64 copy of the
    model by more than PPO_GRAD_RTOL / 2 of its norm: a deep torso's f32
    sums drift, and a unit near its relu's edge may take the other side),
    each tensor is held to float64 by f64_rule instead (slack PPO_GRAD_*
    of its norm; the control the module route with one-pass TF32
    products)."""
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.nn import ppo_losses

    h = algo.hparams
    k_losses, k_grads, k2_grads, p_losses, p_grads, mb, unpack, c_grads = step_minibatch_grads(torch, algo,
                                                                                             f64_fallback)
    torch.cuda.synchronize()
    check(torch.equal(k_grads, k2_grads), f"{what}: two fused gradients bit-identical")
    for key in ("policy", "vf", "total"):
        check(math.isclose(float(k_losses[key]), float(p_losses[key]), rel_tol=PPO_STAT_RTOL,
                           abs_tol=PPO_STAT_ATOL), f"{what}: loss {key} {float(k_losses[key])} vs {float(p_losses[key])}")
    split = lambda flat: list(torch.split(flat, [p.numel() for p in algo._params]))  # noqa: E731
    record = {"rows": int(mb.shape[0]), "loss_total": float(k_losses["total"]),
              "loss_total_module": float(p_losses["total"])}
    for param, k in zip(algo._params, split(k_grads)):
        check(bool(torch.isfinite(k).all()), f"{what}: gradient {tuple(param.shape)} finite")
    if f64_fallback:
        model64 = copy.deepcopy(algo.policy.model).double()

        def to64(tree):
            if isinstance(tree, dict):
                return {k: to64(v) for k, v in tree.items()}
            return tree.double() if tree.is_floating_point() else tree

        batch = to64(unpack(mb))
        with torch.enable_grad():
            features, values = model64(batch[DataKeys.VIEWS])
            dist = algo.policy.distribution_cls(features, model64)
            losses = ppo_losses(batch, values, dist, clip_param=h.clip_param, dual_clip_param=h.dual_clip_param,
                                entropy_coeff=0.0, vf_clip_param=h.vf_clip_param, vf_coeff=h.vf_coeff)
            f_grads = torch.cat([g.reshape(-1) for g in torch.autograd.grad(losses["total"],
                                                                          list(model64.parameters()))])
        del model64
        rel = lambda a, f: float((a.double() - f).norm()) / max(float(f.norm()), 1e-30)  # noqa: E731
        record["module_off_float64"] = max(rel(p, f) for p, f in zip(split(p_grads), split(f_grads)))
        if record["module_off_float64"] > PPO_GRAD_RTOL / 2:
            rows = {f"{i} {tuple(param.shape)}": f64_rule(k, p, f, PPO_GRAD_RTOL * float(f.norm()) + PPO_GRAD_ATOL, c)
                    for i, (param, k, p, c, f) in enumerate(zip(algo._params, split(k_grads), split(p_grads),
                                                                split(c_grads), split(f_grads)))}
            return {**record, **check_f64(what, rows)}
        record["held_to"] = "module_f32"
    worst = 0.0
    for param, k, p in zip(algo._params, split(k_grads), split(p_grads)):
        err, ref = float((k - p).norm()), float(p.norm())
        worst = max(worst, err / max(ref, 1e-30))
        check(err <= PPO_GRAD_RTOL * ref + PPO_GRAD_ATOL,
              f"{what}: gradient {tuple(param.shape)} error {err:.3g} vs norm {ref:.3g}")
    return {**record, "worst_grad_norm_rel_err_vs_module": worst}


def run_wide_custom(torch, dev, kernels: dict) -> None:
    """The slice's path at full width: ``AlgorithmConfig(model_cls=
    MischievousMule, fused_forward=True, num_envs=4096, horizon=32,
    sgd_minibatch_size=32768, model_config={"hiddens": (2048, 2048)})
    .build(AlgoTrading)`` (the custom cell's shapes, ``bench.py:295-319``;
    8,441,864 parameters, f32), one warm-up, three timed and one profiled
    iteration (time_cell: chain forward 33 + 16, backward 16, GAE 1 an
    iteration, both chain kernels on their staged routes), the rollout held
    against the module forward on the buffer's training views
    (check_custom_rollout), and the step's gradient against the module
    route's on one minibatch of a collected buffer (check_step_gradients);
    both kernels timed on the model's chains (time_chain_kernel: the
    forward at 4,096 and 32,768 rows, the backward at 32,768 on its saved
    route, with its workspace's and partials' bytes, chain_backward_bytes)
    and held to their plain versions on a minibatch's rows of the model's
    chains (compare_chains, staged: the saved backward bit-identical to the
    recompute route's); the peak device memory of one collect() and step()
    (``torch.cuda.max_memory_allocated`` after a reset: the saving forward
    holds the backward's workspace from the minibatch's forward to its
    backward); then the same cell with ``fused_forward=False`` (module
    forward and autograd on cuBLAS, no chain launch) timed beside it."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule
    from rl8_tpu_torch.ops.fused_mlp import chain_names, chain_structure, named_chains

    for fused in (True, False):
        algo = AlgorithmConfig(model_cls=MischievousMule, fused_forward=fused, num_envs=4096, horizon=32,
                               sgd_minibatch_size=32768, model_config={"hiddens": (2048, 2048)},
                               device=dev).build(AlgoTrading)
        h, model = algo.hparams, algo.policy.model
        per_step = h.num_sgd_iters * h.num_minibatches
        check(sum(p.numel() for p in model.parameters()) == 8441864 and per_step == 16
              and algo._fused_forward == fused, "wide_custom: the cell's shapes")
        per_iteration = {"gae": 1}
        extra = {"hiddens": [2048, 2048]}
        if fused:
            per_iteration.update(chains_fwd=h.horizon + 1 + per_step, chains_bwd=per_step)
            chains = named_chains(model, chain_names(model))
            x = torch.randn((4096, chain_structure(chains)[0]), device=dev)
            extra.update(forward_route=forward_route(torch, x, chains, "relu", "staged"),
                         route=backward_route(torch, x, chains, "relu", "staged"))
        record = time_cell(torch, algo, "wide_custom" if fused else "wide_custom_module", per_iteration, per_step,
                           iters=4, **extra)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        algo.collect()
        algo.step()
        torch.cuda.synchronize()
        emit({"phase": "wide_custom_memory", "fused_forward": fused,
              "step_peak_memory_bytes": torch.cuda.max_memory_allocated()})
        if fused:
            chains = tuple((tuple(tuple(t.detach() for t in layer) for layer in layers),
                            tuple(tuple(t.detach() for t in head) for head in heads)) for layers, heads in chains)
            xs = {N: torch.randn((N, chain_structure(chains)[0]), device=dev) for N in (4096, 32768)}
            times = {"fwd": time_chain_kernel(torch, xs[4096], chains, False, 10),
                     "fwd_minibatch": time_chain_kernel(torch, xs[32768], chains, False, 5),
                     "bwd": {**chain_backward_bytes(chain_structure(chains), 32768),
                             **time_chain_kernel(torch, xs[32768], chains, True, 5)}}
            emit({"phase": "kernel_time", "kernel": "chains", "model": "wide_custom", "route": "staged", **times})
            kernels["chains_fwd"]["wide_custom"] = {"launches_per_iteration": per_iteration["chains_fwd"],
                                                    "route": "staged", **times["fwd"],
                                                    "minibatch": times["fwd_minibatch"]}
            kernels["chains_bwd"]["wide_custom"] = {"launches_per_iteration": per_step, "route": "staged",
                                                    **times["bwd"]}
            result = compare_chains(torch, "wide_custom chains", 0.5 * xs[32768], chains, "relu", seed=2048,
                                    staged=True)
            check(result["backward_route"] == "staged_saved", "wide_custom: the chain backward takes its saved route")
            emit({"phase": "kernel_check", "kernel": "wide_custom_chains", **result})
            del xs
            worst, _ = check_custom_rollout(torch, algo, ACT_RTOL, ACT_ATOL)
            emit({"phase": "kernel_check", "kernel": "wide_custom", "rollout_vs_module_max_abs_err": worst,
                  "step_gradient": check_step_gradients(torch, algo, "wide_custom step"),
                  "transitions_per_s_with_update": record["transitions_per_s_with_update"]})
        del algo, model
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- deep models

#: The workspace budgets of the update kernel (csrc/ppo.cu's
#: kWorkspaceFloats, 12 GiB) and of the chain backward's staged route
#: (csrc/chains.cu's, 4 GiB).
PPO_BUDGET_BYTES, CHAINS_BUDGET_BYTES = 12 << 30, 4 << 30
#: rl8_tpu's residency gate's deepest default models (DiscreteDummyEnv and
#: ContinuousDummyEnv shapes, model_fits_vmem) at each width: deep_gate_grid
#: checks them, deep_sweep and deep_memory run them.
GATE_DEEPEST = {32: 4871, 64: 1306, 256: 87, 512: 22}
#: rl8_tpu's deepest admitted MischievousMule at 128 wide (chains_fit_vmem:
#: its first layer with a LayerNorm, 323 plain ones after it).
MULE_DEEPEST = 324


def he_scaled(torch, model):
    """``model`` with its torsos' weights scaled by sqrt(2) (He's scale for
    relu from lecun's): at depth a lecun-scaled relu torso halves its
    activations' variance at every layer, so that 87 layers leave values
    and logits of ~1e-13 and every row's logits a tie; at sqrt(2) they keep
    their scale down the torso."""
    with torch.no_grad():
        for name in ("feature_model", "latent_model", "vf_model"):
            torso = getattr(model, name, None)
            for layer in (torso.layers if torso is not None else ()):
                layer.weight.mul_(math.sqrt(2.0))
    return model


def deep_model(torch, kind: str, layers: int, width: int, seed: int, obs_dim: int = 1, activation: str = "relu"):
    """A default model of ``layers`` x ``width`` for ``kind``, on the card:
    a relu torso he_scaled (the continuous model's mean head scaled to
    WIDE_MEAN_RMS over observations of DEEP_OBS_SCALE["relu"]); a tanh torso
    at lecun's scale, its critical one, where a unit's output shrinks like
    1 / sqrt(2 l) down l layers (~0.02 at 1,306), so its heads (the logits
    or the mean, and the value) are scaled to an RMS of 2 over observations
    of DEEP_OBS_SCALE["tanh"]: otherwise every row's logits tie."""
    from rl8_tpu_torch.ops import forward_chains, pack_act_params
    from rl8_tpu_torch.specs import Discrete

    hiddens = (width,) * layers
    gen = torch.Generator(device="cuda").manual_seed(seed)
    obs = DEEP_OBS_SCALE[activation] * torch.randn((4096, obs_dim), generator=gen, device="cuda")
    if kind == "categorical":
        model = make_model(torch, Discrete(2, shape=(1,)), seed=seed, obs_dim=obs_dim, hiddens=hiddens,
                           activation_fn=activation)
    else:
        model = make_continuous_model(torch, 1, seed=seed, obs_dim=obs_dim, log_std_scale=0.03, hiddens=hiddens,
                                      activation_fn=activation)
    if activation == "relu":
        model = he_scaled(torch, model)
        return model if kind == "categorical" else scale_mean_head(torch, model, obs, WIDE_MEAN_RMS)
    ((first, *_), (values,)), _ = forward_chains(obs, pack_act_params(model).chains(), activation)
    heads = ((model.feature_head if kind == "categorical" else model.action_mean, first), (model.vf_head, values))
    with torch.no_grad():
        for head, out in heads:
            factor = 2.0 / float(out.pow(2).mean().sqrt())
            head.weight.mul_(factor)
            head.bias.mul_(factor)
    return model


def deep_update_inputs(torch, dev, model, kind: str, N: int, seed: int):
    """A packed minibatch for ``model`` and its loss config (Normal with an
    entropy bonus and dual clip; the others without a bonus)."""
    from rl8_tpu_torch.ops import PPOLossConfig

    if kind == "categorical":
        params, packed, unpack = ppo_inputs(torch, dev, model, N, seed=seed)
    else:
        params, packed, unpack, _ = continuous_ppo_inputs(torch, dev, model, N, seed=seed, squashed=kind == "squashed")
    cfg = PPOLossConfig(clip_param=0.2, vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=3.0, n_rows=N, accum=1,
                        use_entropy=kind == "normal", squashed=kind == "squashed")
    ec = torch.tensor(0.01 if kind == "normal" else 0.0, device=dev)
    return params, packed, unpack, ec, cfg


#: deep_sweep's cases: ``(kind, layers, width, obs_dim, act route,
#: update route, activation)``: the discrete act kernel's wgmma route takes chains of
#: up to 1,024 k steps (csrc/act.cu's kWgMaxSteps; 32 layers of 256 take
#: 994), its tiled f32 route deeper ones up to 256 wide, and, at 16 layers, inputs
#: wider than 256 (tiled, at 128 wide: 256-wide layers beside an input of
#: 300 fill its shared memory) and layers wider than 256 (staged); the
#: continuous kinds take the tiled route at any depth up to 256 wide.
#: The 1,306-layer torsos are tanh (deep_model): a relu torso of 1,306
#: layers of 64 collapses at He's scale too (a 64-wide layer's gain
#: scatters, and over 1,306 layers its product vanishes: its logits are
#: ~1e-8 and every row's tie), where a tanh torso at lecun's scale keeps
#: distinct rows (its heads scaled), on observations of scale 1 (at 20 its
#: first layer saturates, and every row of a sign gives the same output).
DEEP_OBS_SCALE = {"relu": 20.0, "tanh": 1.0}
DEEP_SWEEP = [
    *[(kind, layers, 256, 1, act, "narrow", "relu")
      for layers, act in ((9, "wgmma"), (16, "wgmma"), (32, "wgmma"), (GATE_DEEPEST[256], "tiled"))
      for kind in ("categorical", "normal", "squashed")],
    *[(kind, GATE_DEEPEST[64], 64, 1, "tiled", "narrow", "tanh") for kind in ("categorical", "normal", "squashed")],
    ("categorical", 16, 128, 300, "tiled", "narrow", "relu"),
    ("categorical", 16, 320, 1, "staged", "narrow", "relu"),
]


def run_deep_sweep(torch, dev, kernels: dict) -> None:
    """Deep default models on the act and update kernels (DEEP_SWEEP):
    Categorical, Normal (entropy bonus, dual clip) and SquashedNormal at 9,
    16 and 32 layers of 256 and at rl8_tpu's deepest admitted models at
    256 (87 layers; relu, he_scaled) and at 64 (1,306; tanh) wide; the categorical act
    also on its tiled (an obs dim of 300, 128 wide) and staged (320 wide)
    routes at 16 layers. The act kernel at 4,096 rows (compare_act), the update at
    8,192 (compare_ppo_f64), each held to its plain version, or to float64
    where the plain f32 version drifts off it; each route asserted, two
    launches bit-identical, and both timed beside their plain versions
    with their bounds (f32 and 3xTF32, by operations), except Normal's
    (the continuous kernels of the squashed cases, whose work is the
    same)."""
    from rl8_tpu_torch.ops import act_plain, fused_act, fused_ppo_grads, pack_act_params, ppo_grads_plain

    gen = torch.Generator(device=dev).manual_seed(21)
    models = {}  # Normal and SquashedNormal share the continuous model
    for kind, layers, width, obs_dim, want_act, want_ppo, activation in DEEP_SWEEP:
        t0 = time.perf_counter()
        what = f"deep_sweep {kind} {layers}x{width} {activation}" + (f" obs {obs_dim}" if obs_dim != 1 else "")
        family = "discrete" if kind == "categorical" else "continuous"
        shape = (family, layers, width, obs_dim, activation)
        if shape not in models:
            models.clear()
            models[shape] = deep_model(torch, kind, layers, width, seed=layers + width + obs_dim, obs_dim=obs_dim,
                                       activation=activation)
        model = models[shape]
        params = pack_act_params(model, squashed=kind == "squashed")
        obs = DEEP_OBS_SCALE[activation] * torch.randn((4096, obs_dim), generator=gen, device=dev)
        uparams, packed, unpack, ec, cfg = deep_update_inputs(torch, dev, model, kind, 8192, seed=layers + 7)
        want = "tiled" if family == "continuous" and want_act == "wgmma" else want_act
        act_route = launched_route(torch, f"{what} act", lambda: fused_act(params, obs, (1, 2)), ACT_ROUTES[family],
                                   want)
        ppo_route = launched_route(torch, f"{what} update", lambda: fused_ppo_grads(uparams, packed, unpack, ec, cfg),
                                   PPO_ROUTES[uparams.continuous], want_ppo, calls=1)
        act_check = compare_act(torch, f"{what} act", params, obs, f64_fallback=True)
        deep, timed = layers > 200, kind != "normal"
        if timed:
            act_rec = time_kernel(torch, f"{family}_act" if family == "continuous" else "discrete_act",
                                  lambda: fused_act(params, obs, (1, 2)),
                                  lambda: act_plain(params, obs, (1, 2), deterministic=False), act_cost(params, 4096),
                                  iters=2 if deep else 5, plain_iters=1 if deep else 2, plain_warmup=0 if deep else 1,
                                  B=4096, kind=kind, hiddens=f"{layers}x{width}", activation=activation,
                                  obs_dim=obs_dim, route=act_route, launches_per_iteration=0)
        result = compare_ppo_f64(torch, f"{what} update", uparams, packed, unpack, ec, cfg, plain_first=True)
        if timed:
            ppo_rec = time_kernel(torch, "continuous_ppo_update" if uparams.continuous else "ppo_update",
                                  lambda: fused_ppo_grads(uparams, packed, unpack, ec, cfg),
                                  lambda: ppo_grads_plain(uparams, packed, unpack, ec, cfg), ppo_cost(uparams, packed),
                                  iters=1 if deep else 2, plain_iters=1, plain_warmup=0 if deep else 1, N=8192,
                                  kind=kind, hiddens=f"{layers}x{width}", activation=activation, route=ppo_route,
                                  workspace_bytes=4 * ppo_workspace_floats(uparams, 8192))
        emit({"phase": "kernel_check", "kernel": "deep_sweep", "kind": kind, "layers": layers, "width": width,
              "activation": activation, "obs_dim": obs_dim, "act_route": act_route, "act": act_check,
              "update_route": ppo_route, **result, "seconds": time.perf_counter() - t0})
        if kind != "normal" and obs_dim == 1 and width in (256, 64) and layers in (16, GATE_DEEPEST[256],
                                                                                   GATE_DEEPEST[64]):
            key = f"deep_sweep_{layers}x{width}"
            kernels["continuous_act" if family == "continuous" else "act"][key] = {k: act_rec[k] for k in WIDE_RECORD}
            kernels["continuous_ppo" if family == "continuous" else "ppo"][key] = {
                **{k: ppo_rec[k] for k in WIDE_RECORD if k != "launches_per_iteration"},
                "workspace_bytes": ppo_rec["workspace_bytes"]}
        del model, params, uparams, packed
        torch.cuda.empty_cache()


def ppo_workspace_floats(params, N: int) -> int:
    """rl8_ppo_workspace's answer for ``params`` at N rows."""
    import ctypes

    from rl8_tpu_torch.ops._build import load
    from rl8_tpu_torch.ops.fused_act import KINDS

    hidden = (ctypes.c_int * len(params.hiddens))(*params.hiddens)
    return load().rl8_ppo_workspace(N, params.d_in, len(params.hiddens), hidden, KINDS.index(params.kind),
                                    params.action_dim, params.n)


def ppo_chunk_rows(params, N: int) -> int:
    """rl8_ppo_chunk_rows' answer for ``params`` at N rows: the rows of each
    chunk of the update's row pass."""
    import ctypes

    from rl8_tpu_torch.ops._build import load
    from rl8_tpu_torch.ops.fused_act import KINDS

    hidden = (ctypes.c_int * len(params.hiddens))(*params.hiddens)
    return load().rl8_ppo_chunk_rows(N, params.d_in, len(params.hiddens), hidden, KINDS.index(params.kind),
                                     params.action_dim, params.n)


def check_chain_halves(torch, what: str, x, chains, douts) -> float:
    """The chain backward over N rows against its launches over each half:
    dx row for row within CHAIN_RTOL/ATOL and each parameter gradient
    against the halves' sum within PPO_GRAD_* by norm. Returns the worst
    norm-relative gradient error."""
    from rl8_tpu_torch.ops import fused_chains_bwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, flatten_chains

    structure, flat, M = chain_structure(chains), flatten_chains(chains), x.shape[0] // 2
    dx, grads = fused_chains_bwd(x, flat, structure, "relu", douts)
    dx_a, grads_a = fused_chains_bwd(x[:M].contiguous(), flat, structure, "relu", [d[:M].contiguous() for d in douts])
    dx_b, grads_b = fused_chains_bwd(x[M:].contiguous(), flat, structure, "relu", [d[M:].contiguous() for d in douts])
    torch.cuda.synchronize()
    check(torch.allclose(dx, torch.cat([dx_a, dx_b]), rtol=CHAIN_RTOL, atol=CHAIN_ATOL), f"{what}: dx vs the halves'")
    halves = grads_a.double() + grads_b.double()
    err, ref = float((grads.double() - halves).norm()), float(halves.norm())
    check(err <= PPO_GRAD_RTOL * ref + PPO_GRAD_ATOL, f"{what}: gradient error {err:.3g} vs the halves' norm {ref:.3g}")
    return err / ref


def run_deep_memory(torch, dev, kernels: dict) -> None:
    """The bounded workspaces at rl8_tpu's deepest models. The update kernel
    at the deepest 256-wide default model (87 layers, he_scaled) on 262,144
    synthetic rows (the cell's whole-buffer minibatch): two launches
    bit-identical, against its launches over the halves (check_halves), its
    chunks' rows and workspace (rl8_ppo_workspace) and the launch's peak
    device memory (torch.cuda.max_memory_allocated) against its 12 GiB
    budget, timed. Then the chain backward at the deepest admitted
    MischievousMule layout (324 layers of 128, the first with a LayerNorm)
    on 32,768 rows (the custom cell's minibatch), on its staged route: two
    launches bit-identical, against its launches over the halves
    (check_chain_halves) and against the plain backward on the kernels' own
    activations (compare_chains, held to float64 where the plain f32
    version drifts off it), workspace and peak memory against its 4 GiB
    budget, timed."""
    from rl8_tpu_torch.ops import fused_chains_bwd, fused_ppo_grads
    from rl8_tpu_torch.ops._build import load
    from rl8_tpu_torch.ops.fused_mlp import _spec, chain_structure, flatten_chains

    N, layers = 8192 * 32, GATE_DEEPEST[256]
    model = deep_model(torch, "categorical", layers, 256, seed=87)
    params, packed, unpack, ec, cfg = deep_update_inputs(torch, dev, model, "categorical", N, seed=88)
    chunk = ppo_chunk_rows(params, N)
    workspace = 4 * ppo_workspace_floats(params, N)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g1 = fused_ppo_grads(params, packed, unpack, ec, cfg)[2]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    g2 = fused_ppo_grads(params, packed, unpack, ec, cfg)[2]
    torch.cuda.synchronize()
    check(torch.equal(g1, g2) and bool(torch.isfinite(g1).all()), "deep_memory update: two launches bit-identical")
    check(workspace <= PPO_BUDGET_BYTES and peak <= PPO_BUDGET_BYTES + 4 * 2 * params.flat.numel() + 4096,
          f"deep_memory update: workspace {workspace}, peak {peak} over the budget")
    halves = check_halves(torch, "deep_memory update (halves)", params, packed, unpack, ec, cfg)
    ms, _ = time_ms(torch, lambda: fused_ppo_grads(params, packed, unpack, ec, cfg), iters=1, warmup=0)
    record = {"ms": ms, "plain_ms": None, "route": "staged", "N": N, "chunk_rows": chunk, "workspace_bytes": workspace,
              "peak_launch_bytes": peak, "budget_bytes": PPO_BUDGET_BYTES}
    update_bounds(record, *ppo_cost(params, packed))
    emit({"phase": "deep_memory", "kernel": "ppo_update", "hiddens": f"{layers}x256", "parameters": params.flat.numel(),
          "halves_worst_grad_norm_rel_err": halves, "bit_identical": True, **record})
    kernels["ppo"][f"deep_memory_{layers}x256x{N}"] = record
    del g1, g2, packed, params, model
    torch.cuda.empty_cache()

    layout = (([(128, True)] + [(128, False)] * (MULE_DEEPEST - 1), [3]),
              ([(128, True)] + [(128, False)] * (MULE_DEEPEST - 1), [1]))
    chains = random_chains(torch, dev, seed=324, d_in=7, layout=layout)
    # He's scale for the relu layers after the LayerNorm (as he_scaled):
    # at lecun's their signal halves at every layer and the first ~200
    # layers' gradients underflow f32 to exact zeros.
    for layers, _ in chains:
        for layer in layers[1:]:
            layer[0].mul_(math.sqrt(2.0))
    structure, flat, N = chain_structure(chains), flatten_chains(chains), 32768
    spec, n = _spec(structure)
    chunk = load().rl8_chains_chunk_rows(N, 7, spec, n)
    gen = torch.Generator(device=dev).manual_seed(325)
    x = torch.randn((N, 7), generator=gen, device=dev)
    douts = [torch.randn((N, w), generator=gen, device=dev) for w in (3, 1)]
    route = backward_route(torch, x, chains, "relu", "staged", calls=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dx1, g1 = fused_chains_bwd(x, flat, structure, "relu", douts)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    dx2, g2 = fused_chains_bwd(x, flat, structure, "relu", douts)
    torch.cuda.synchronize()
    check(torch.equal(dx1, dx2) and torch.equal(g1, g2) and bool(torch.isfinite(g1).all()),
          "deep_memory chains: two launches bit-identical and finite")
    sizes = chain_backward_bytes(structure, N)
    check(sizes["workspace_bytes"] <= CHAINS_BUDGET_BYTES
          and peak <= CHAINS_BUDGET_BYTES + 4 * (2 * flat.numel() + N * 7) + 4096,
          f"deep_memory chains: workspace {sizes}, peak {peak} over the budget")
    halves = check_chain_halves(torch, "deep_memory chains (halves)", x, chains, douts)
    del dx1, dx2, g1, g2, douts
    torch.cuda.empty_cache()
    # The chunked backward (N / chunk chunks) against the plain backward on
    # the kernels' own activations.
    result = compare_chains(torch, "deep_memory chains", x, chains, "relu", seed=326, staged=True, f64_fallback=True)
    record = {"route": route, "chunk_rows": chunk, "peak_launch_bytes": peak, "budget_bytes": CHAINS_BUDGET_BYTES,
              **sizes, **time_chain_kernel(torch, x, chains, True, 2)}
    emit({"phase": "deep_memory", "kernel": "chains_bwd", "layout": f"mule {MULE_DEEPEST}x128",
          "parameters": flat.numel(), "halves_worst_grad_norm_rel_err": halves, "vs_plain": result, **record})
    kernels["chains_bwd"][f"deep_memory_mule_{MULE_DEEPEST}x128x{N}"] = record


def check_deep_gate_grid(torch) -> None:
    """At 32, 64, 256 and 512 wide, rl8_tpu's residency gate
    (``model_fits_vmem`` on the ``meta`` device) admits the default models
    of GATE_DEEPEST layers and refuses one more; the card's kernels take
    every depth from 1 to that: ``card_takes_act`` (Categorical on
    DiscreteDummyEnv's shapes, Normal on ContinuousDummyEnv's),
    ``card_takes_update`` (Categorical, Normal, SquashedNormal) and
    ``card_takes_chains`` (the twin torso with ``fused_forward``), each
    asked at 1 layer and at the deepest, and at every depth between through
    the library queries they are (``rl8_act_scratch``, ``rl8_ppo_workspace``,
    ``rl8_chains_workspace`` at one row, on arrays built once a width: 4,871
    models of 32 to 4,871 layers through Python's packing would take ~30 s).
    Then the first refused depth at 256 and 512 wide builds onto the module
    routes, as rl8_tpu routes it (``fused_act``, ``fused_update`` and
    ``fused_forward`` off), and at 512 wide trains one collect and one step
    with no act or update launch."""
    import ctypes

    import numpy as np

    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.models import DefaultContinuousModel, DefaultDiscreteModel
    from rl8_tpu_torch.ops import ActParams, card_takes_act, card_takes_chains, card_takes_update, model_fits_vmem
    from rl8_tpu_torch.ops._build import load
    from rl8_tpu_torch.ops.fused_act import KINDS
    from rl8_tpu_torch.ops.fused_mlp import chain_names, named_chains
    from rl8_tpu_torch.specs import Discrete, Unbounded

    lib = load()
    t0 = time.perf_counter()
    for width, deepest in GATE_DEEPEST.items():
        # The gate's boundary (the continuous model's too where its meta
        # models are small: 4,871 layers take seconds to build).
        classes = ((DefaultDiscreteModel, Discrete(2, shape=(1,))), (DefaultContinuousModel, Unbounded(1)))
        models = {}
        for cls, spec in classes[: 1 if deepest > 1000 else 2]:
            for layers, admitted in ((deepest, True), (deepest + 1, False)):
                with torch.device("meta"):
                    models[cls, layers] = cls(Unbounded(1), spec, hiddens=(width,) * layers)
                check(model_fits_vmem(models[cls, layers]) == admitted, f"deep gate grid: the gate at {layers} x {width}")
        for layers in (1, deepest):
            if layers == 1:
                with torch.device("meta"):
                    model = DefaultDiscreteModel(Unbounded(1), Discrete(2, shape=(1,)), hiddens=(width,))
            else:
                model = models[DefaultDiscreteModel, deepest]
            flat = torch.empty(0, device="meta")
            for kind, n in (("categorical", 2), ("normal", 0), ("squashed", 0)):
                params = ActParams(flat=flat, d_in=1, hiddens=(width,) * layers, action_dim=1, n=n, activation="relu",
                                   kind=kind)
                check(card_takes_update(params) and (kind == "squashed" or card_takes_act(params)),
                      f"deep gate grid: a kernel refuses {kind} {layers} x {width}")
            check(card_takes_chains(named_chains(model, chain_names(model))),
                  f"deep gate grid: the chain kernels refuse {layers} x {width}")
        hidden = np.full(deepest, width, dtype=np.int32)
        h_ptr = hidden.ctypes.data_as(ctypes.c_void_p)
        spec = np.empty(2 * (2 * deepest + 3) + 1, dtype=np.int32)
        for layers in range(1, deepest + 1):
            for continuous, n in ((0, 2), (1, 0)):
                check(lib.rl8_act_scratch(1, 1, layers, h_ptr, continuous, 1, n, 1) >= 0,
                      f"deep gate grid: the act kernel refuses {'Normal' if continuous else 'Categorical'}"
                      f" {layers} x {width}")
            for kind, n in (("categorical", 2), ("normal", 0), ("squashed", 0)):
                check(lib.rl8_ppo_workspace(1, 1, layers, h_ptr, KINDS.index(kind), 1, n) >= 0,
                      f"deep gate grid: the update kernel refuses {kind} {layers} x {width}")
            # The torso with fused_forward: 2 chains of `layers` plain layers, heads 2 and 1.
            m = 2 * layers
            spec[0] = 2
            for c, head in enumerate((2, 1)):
                base = 1 + c * (m + 3)
                spec[base] = layers
                spec[base + 1 : base + 1 + m : 2] = width
                spec[base + 2 : base + 2 + m : 2] = 0
                spec[base + 1 + m] = 1
                spec[base + 2 + m] = head
            check(lib.rl8_chains_workspace(1, 1, spec.ctypes.data_as(ctypes.c_void_p), 2 * (m + 3) + 1, 1) >= 0,
                  f"deep gate grid: the chain kernels refuse the torso {layers} x {width}")
    seconds = time.perf_counter() - t0
    routes = {}
    for width, deepest in GATE_DEEPEST.items():
        if deepest > 1000:
            continue  # 4,872 and 1,307 layers take seconds to build; the gate refused them above
        zero_counters()
        algo = AlgorithmConfig(device="cuda", num_envs=64, horizon=8, fused_forward=True,
                               model_config={"hiddens": (width,) * (deepest + 1)}).build(DiscreteDummyEnv)
        flags = (algo._fused_act, algo._fused_update, algo._fused_forward)
        check(flags == (False, False, False), f"deep gate grid: {deepest + 1} x {width} routes {flags}")
        routes[f"{deepest + 1}x{width}"] = flags
        if width == 512:
            algo.collect()
            stats = algo.step()
            launches = launch_counts()
            check(launches["act"] == launches["update"] == launches["chains_fwd"] == 0 and launches["gae"] == 1,
                  f"deep gate grid: {deepest + 1} x 512 launches {launches}")
            check(all(math.isfinite(v) for v in stats.values()), "deep gate grid: step stats finite")
        del algo
        torch.cuda.empty_cache()
    emit({"phase": "deep_gate_grid", "deepest_admitted_by_width": GATE_DEEPEST, "queries_seconds": seconds,
          "first_refused_routes": routes})


#: chains_count_sweep's structures: ``(name, d_in, layout, rows, activation,
#: forward route, backward route)``. The tiled routes take up to 8 layers
#: and 4 heads a chain, any number of chains (4 a launch); deeper chains
#: or more heads take the staged ones.
CHAIN_COUNTS = (
    ("c5_tiled", 7, tuple(([(64, c % 2 == 0), (48, False)], [3] if c else [2, 1]) for c in range(5)), 4096,
     "relu", "tiled", "tiled"),
    ("c8_tiled", 7, tuple(([(32, c % 3 == 0)] * 4, [1, 9, 2, 3] if c == 0 else [2]) for c in range(8)), 4097,
     "tanh", "tiled", "tiled"),
    ("c5_l12_ln_6heads", 7, tuple(([(64, l % 2 == 0) for l in range(12)], [3, 1, 2, 9, 1] if c == 0 else [2])
                                  for c in range(5)), 4096, "relu", "staged", "staged"),
    ("c8_l12_noln", 16, tuple(([(96, False)] * 12, [1]) for c in range(8)), 5000, "relu", "staged", "staged"),
    ("c5_l24_ln_tanh", 16, tuple(([(96, True)] * 24, [4, 8] if c % 2 else [1]) for c in range(5)), 5000, "tanh",
     "staged", "staged"),
    ("c8_l24_8heads", 11, tuple(([(80, c % 2 == 1)] * 24, [1, 2, 3, 9, 1, 2, 3, 1] if c == 7 else [1])
                                for c in range(8)), 4096, "relu", "staged", "staged"),
    ("c5_l3_5heads", 7, tuple(([(128, True), (128, False), (128, False)], [3, 1, 1, 9, 2]) for c in range(5)), 32768,
     "relu", "staged", "staged"),
)


def run_chains_count_sweep(torch, dev, kernels: dict) -> None:
    """The chain kernels past their former counts (CHAIN_COUNTS): 5 and 8
    chains, 12 and 24 layers with and without LayerNorm, 5 and 8 heads on a
    chain (ragged, one 9 wide), on the tiled routes (up to 8 layers and 4
    heads a chain, launches of 4 chains) and the staged ones, each route
    asserted; each against its plain versions (compare_chains: the staged
    backward's on the kernels' own activations; held to float64 where the
    plain f32 backward drifts off it), timed beside them
    with their bounds and the backward's workspace and partial bytes."""
    from rl8_tpu_torch.ops.fused_mlp import chain_structure

    gen = torch.Generator(device=dev).manual_seed(26)
    for name, d_in, layout, N, activation, want_fwd, want_bwd in CHAIN_COUNTS:
        chains = random_chains(torch, dev, seed=len(name) + N, d_in=d_in, layout=layout)
        x = torch.randn((N, d_in), generator=gen, device=dev)
        routes = {"forward": forward_route(torch, x, chains, activation, want_fwd),
                  "backward": backward_route(torch, x, chains, activation, want_bwd)}
        result = compare_chains(torch, f"chains_count_sweep {name}", x, chains, activation, seed=N,
                                staged=want_bwd == "staged", f64_fallback=True)
        structure = chain_structure(chains)
        times = {"fwd": time_chain_kernel(torch, x, chains, False, 5), "bwd": time_chain_kernel(torch, x, chains, True, 3)}
        emit({"phase": "kernel_check", "kernel": "chains_count_sweep", "name": name, "N": N,
              "chains": len(layout), "layers": [len(layers) for layers, _ in layout],
              "heads": [list(heads) for _, heads in layout], "activation": activation, **routes, **result,
              **chain_backward_bytes(structure, N), "times": times})
        if name in ("c8_tiled", "c5_l12_ln_6heads", "c8_l24_8heads"):
            kernels["chains_fwd"][f"count_{name}"] = {"route": routes["forward"], **times["fwd"]}
            kernels["chains_bwd"][f"count_{name}"] = {"route": routes["backward"], **times["bwd"],
                                                      **chain_backward_bytes(structure, N)}


def run_deep_custom(torch, dev, kernels: dict) -> None:
    """MischievousMule with ``hiddens=(128,) * 12`` and ``fused_forward`` at
    the custom cell's shapes (4096 envs, horizon 32, minibatches of 32,768
    rows): it builds (the card's chain kernels take 12 layers: their staged
    routes), and one warm-up, three timed and one profiled iteration
    collect and step through the chain kernels (time_cell: forward 49,
    backward 16, GAE 1 an iteration); its rollout held against its module
    forward (check_custom_rollout) and one minibatch's step gradient
    against the module route's (check_step_gradients: PPO_GRAD_*, or to
    float64 where the module route's f32 gradient drifts off it); both
    kernels timed on the model's chains (the backward on its saved route)
    and held to their plain versions on a minibatch's rows (compare_chains,
    staged, held to float64 where the plain f32 backward drifts off it: the
    saved backward bit-identical to the recompute route's)."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule
    from rl8_tpu_torch.ops.fused_mlp import chain_names, chain_structure, named_chains

    algo = AlgorithmConfig(model_cls=MischievousMule, fused_forward=True, num_envs=4096, horizon=32,
                           sgd_minibatch_size=32768, model_config={"hiddens": (128,) * 12},
                           device=dev).build(AlgoTrading)
    h, model = algo.hparams, algo.policy.model
    per_step = h.num_sgd_iters * h.num_minibatches
    check(algo._fused_forward and per_step == 16, "deep_custom: fused_forward and the cell's shapes")
    chains = named_chains(model, chain_names(model))
    x = torch.randn((4096, chain_structure(chains)[0]), device=dev)
    routes = {"forward_route": forward_route(torch, x, chains, "relu", "staged"),
              "route": backward_route(torch, x, chains, "relu", "staged")}
    record = time_cell(torch, algo, "deep_custom", {"gae": 1, "chains_fwd": h.horizon + 1 + per_step,
                                                     "chains_bwd": per_step}, per_step, iters=4,
                       hiddens="12x128", **routes)
    worst, _ = check_custom_rollout(torch, algo, ACT_RTOL, ACT_ATOL)
    step = check_step_gradients(torch, algo, "deep_custom step", f64_fallback=True)
    chains = tuple((tuple(tuple(t.detach() for t in layer) for layer in layers),
                    tuple(tuple(t.detach() for t in head) for head in heads)) for layers, heads in chains)
    xs = {N: torch.randn((N, chain_structure(chains)[0]), device=dev) for N in (4096, 32768)}
    times = {"fwd": time_chain_kernel(torch, xs[4096], chains, False, 10),
             "bwd": {**chain_backward_bytes(chain_structure(chains), 32768),
                     **time_chain_kernel(torch, xs[32768], chains, True, 5)}}
    result = compare_chains(torch, "deep_custom chains", 0.5 * xs[32768], chains, "relu", seed=1212, staged=True,
                            f64_fallback=True)
    check(result["backward_route"] == "staged_saved", "deep_custom: the chain backward takes its saved route")
    emit({"phase": "kernel_check", "kernel": "deep_custom", "rollout_vs_module_max_abs_err": worst,
          "step_gradient": step, "transitions_per_s_with_update": record["transitions_per_s_with_update"],
          "times": times, "chains": result})
    kernels["chains_fwd"]["deep_custom"] = {"launches_per_iteration": h.horizon + 1 + per_step, "route": "staged",
                                            **times["fwd"]}
    kernels["chains_bwd"]["deep_custom"] = {"launches_per_iteration": per_step, "route": "staged", **times["bwd"]}
    del algo, model, xs
    torch.cuda.empty_cache()


def run_deep_torso(torch, dev, kernels: dict) -> None:
    """The slice's cell: ``DefaultDiscreteModel`` with ``hiddens=(256,) *
    16`` (1,975,555 parameters) on ``DiscreteDummyEnv``, 8192 envs, horizon
    32, a whole-buffer minibatch of 262,144 rows, 4 epochs, Adam, through
    ``AlgorithmConfig(...).build(env)``, ``collect()`` and ``step()``: one
    warm-up, three timed and one profiled iteration (time_cell: act 32, GAE
    1, update 4 launches an iteration, no other kernel), the rollout held
    against the module forward (check_feedforward_rollout). On the cell's
    buffer, both kernels against their plain versions (compare_act at
    8,192 rows; compare_ppo over the whole buffer, 262,144 rows in two
    chunks whose partial gradients are summed in order, and compare_ppo_f64
    against float64 where the plain f32 gradient drifts off it) and the
    update against its launches over the halves (check_halves, each half
    one chunk), then timed beside their plain versions; then its module
    twin (``fused_act=False, fused_update=False``: the module rollout and
    the autodiff update) timed the same way."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.ops import act_plain, fused_act, fused_ppo_grads, ppo_grads_plain

    hiddens = (256,) * 16
    algo = AlgorithmConfig(device="cuda", model_config={"hiddens": hiddens}).build(DiscreteDummyEnv)
    h = algo.hparams
    per_step = h.num_sgd_iters * h.num_minibatches
    check((algo._fused_act, algo._fused_update) == (True, True), "deep_torso: the kernels' routes")
    check(sum(p.numel() for p in algo.policy.model.parameters()) == 1975555
          and (h.num_envs, h.horizon, per_step) == (8192, 32, 4), "deep_torso: the cell's shapes")
    cell = time_cell(torch, algo, "deep_torso", {"act": h.horizon, "gae": 1, "update": per_step}, per_step, iters=4,
                     hiddens="16x256")
    worst = check_feedforward_rollout(torch, algo, ACT_RTOL, ACT_ATOL)
    params = algo._pack_params()
    obs, packed, unpack = buffer_rows(torch, algo, 8192 * 32, seed=27)
    act_obs = obs[:8192].contiguous()
    cfg = algo._loss_config(8192 * 32)
    ec = torch.tensor(0.0, device=dev)
    act_route = launched_route(torch, "deep_torso act", lambda: fused_act(params, act_obs, (1, 2)),
                               ACT_ROUTES["discrete"], "wgmma")
    ppo_route = launched_route(torch, "deep_torso update", lambda: fused_ppo_grads(params, packed, unpack, ec, cfg),
                               PPO_ROUTES[False], "staged", calls=1)
    act_check = compare_act(torch, "deep_torso act", params, act_obs, f64_fallback=True)
    update_check = compare_ppo(torch, "deep_torso update", params, packed, unpack, ec, cfg)
    vs_float64 = compare_ppo_f64(torch, "deep_torso update", params, packed, unpack, ec, cfg, plain_first=True)
    halves = check_halves(torch, "deep_torso update (halves)", params, packed, unpack, ec, cfg)
    act = time_kernel(torch, "discrete_act", lambda: fused_act(params, act_obs, (1, 2)),
                      lambda: act_plain(params, act_obs, (1, 2), deterministic=False), act_cost(params, 8192),
                      iters=20, plain_iters=10, B=8192, hiddens="16x256", route=act_route,
                      launches_per_iteration=h.horizon)
    ppo = time_kernel(torch, "ppo_update", lambda: fused_ppo_grads(params, packed, unpack, ec, cfg),
                      lambda: ppo_grads_plain(params, packed, unpack, ec, cfg), ppo_cost(params, packed), iters=3,
                      plain_iters=2, plain_warmup=0, N=8192 * 32, hiddens="16x256", route=ppo_route,
                      launches_per_iteration=per_step,
                      workspace_bytes=4 * ppo_workspace_floats(params, 8192 * 32))
    kernels["act"]["deep_torso"] = {k: act[k] for k in WIDE_RECORD}
    kernels["ppo"]["deep_torso"] = {**{k: ppo[k] for k in WIDE_RECORD}, "workspace_bytes": ppo["workspace_bytes"]}
    emit({"phase": "kernel_check", "kernel": "deep_torso", "rollout_vs_module_max_abs_err": worst,
          "act_route": act_route, "act": act_check, "update_route": ppo_route, **update_check["summary"],
          "update_vs_float64": vs_float64, "chunk_rows": ppo_chunk_rows(params, 8192 * 32), "halves_worst_grad_norm_rel_err": halves})
    del algo, packed, obs
    torch.cuda.empty_cache()
    module = AlgorithmConfig(device="cuda", model_config={"hiddens": hiddens}, fused_act=False,
                             fused_update=False).build(DiscreteDummyEnv)
    twin = time_cell(torch, module, "deep_torso_module_route", {"gae": 1}, per_step, iters=4, hiddens="16x256")
    emit({"phase": "deep_torso_summary", "hiddens": "16x256",
          "kernels_transitions_per_s_with_update": cell["transitions_per_s_with_update"],
          "module_transitions_per_s_with_update": twin["transitions_per_s_with_update"],
          "kernels_over_module": cell["transitions_per_s_with_update"] / twin["transitions_per_s_with_update"]})
    del module
    torch.cuda.empty_cache()


def saved_activation_bytes(structure, N: int) -> int:
    """Bytes of the activations that the saved chain backward reads on N
    rows: every h_l, and each LayerNorm layer's xhat_l and s_l."""
    return 4 * N * sum(w + (w + 1 if ln else 0) for layers, _ in structure[1] for w, ln in layers)


def saved_bwd_ms(torch, x, flat, structure, activation: str, douts, iters: int) -> float:
    """The saved chain backward's device ms per launch: each after a saving
    forward, CUDA events around the backward alone (one warm-up)."""
    from rl8_tpu_torch.ops import fused_chains_bwd, fused_chains_fwd

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for i in range(iters + 1):
        _, kept = fused_chains_fwd(x, flat, structure, activation, save=True)
        start.record()
        fused_chains_bwd(x, flat, structure, activation, douts, saved=kept)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end) if i else 0.0
        del kept
    return total / iters


def time_chain_kernel(torch, x, chains, backward: bool, iters: int) -> dict:
    """A chain kernel's device ms per launch on ``x`` (the backward from
    normal head cotangents), beside its plain version's, with its bounds
    (update_bounds of chain_counts). The backward on its route
    (backward_rule): where it is ``staged_saved``, ``ms`` is the saved
    backward's (saved_bwd_ms) with its bounds without the recompute, and
    ``recompute_ms`` the recompute route's beside it."""
    from rl8_tpu_torch.ops import chains_vjp_plain, forward_chains, fused_chains_bwd, fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, flatten_chains

    structure, flat, N = chain_structure(chains), flatten_chains(chains), x.shape[0]
    fwd_flops, fwd_bytes, bwd_flops, bwd_bytes = chain_counts(structure, N)
    record = {"N": N}
    if backward:
        gen = torch.Generator(device=x.device).manual_seed(N)
        douts = [torch.randn((N, w), generator=gen, device=x.device) for _, heads in structure[1] for w in heads]
        grouped, q = [], 0
        for _, heads in structure[1]:
            grouped.append(douts[q : q + len(heads)])
            q += len(heads)
        record["route"] = backward_rule(torch, structure, N)
        record["ms"], _ = time_ms(torch, lambda: fused_chains_bwd(x, flat, structure, "relu", douts), iters=iters,
                                  warmup=1)
        saved = record["route"] == "staged_saved"
        if saved:
            record["recompute_ms"] = record["ms"]
            record["ms"] = saved_bwd_ms(torch, x, flat, structure, "relu", douts, iters)
        record["plain_ms"], _ = time_ms(torch, lambda: chains_vjp_plain(x, chains, "relu", grouped), iters=iters,
                                        warmup=1)
        chain_bwd_bounds(record, fwd_flops, bwd_flops, bwd_bytes,
                         saved_activation_bytes(structure, N) if saved else 0)
    else:
        record["ms"], _ = time_ms(torch, lambda: fused_chains_fwd(x, flat, structure, "relu"), iters=iters, warmup=2)
        record["plain_ms"], _ = time_ms(torch, lambda: forward_chains(x, chains, "relu"), iters=max(iters // 2, 3),
                                        warmup=1)
        update_bounds(record, fwd_flops, fwd_bytes)
    return record


#: ``time_updates``' chain shapes beyond the main path's, which a checkout
#: before the staged chain routes takes too (its tiled or streaming
#: routes): ``(name, d_in, layout, rows)``.
CHAINS_AB = (
    ("mule_768", 7, mule_layout(768), 4096),
    ("mule_768", 7, mule_layout(768), 32768),
    ("ln_768", 7, (([(768, True)], [3]),), 32768),
    ("wider_160_136", 7, (([(160, True), (136, False)], [2, 9]), ([(136, True)], [1])), 32768),
)


def time_chains_ab(torch, dev) -> list:
    """``time_updates``' chain kernels at CHAINS_AB's shapes: device ms per
    launch (``time_ms``) and the route each took (the streaming routes'
    kernels named too, for a checkout that has them)."""
    from rl8_tpu_torch.ops import fused_chains_bwd, fused_chains_fwd
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, flatten_chains

    fwd_routes = {"chains_fwd_tiles_kernel": "tiled", "chains_fwd_kernel": "streaming",
                  "chains_layer_kernel": "staged"}
    bwd_routes = {"chains_bwd_tiles_kernel": "tiled", "chains_bwd_rows_kernel": "streaming",
                  "chains_dh_kernel": "staged"}
    gen = torch.Generator(device=dev).manual_seed(51)
    records = []
    for i, (name, d_in, layout, N) in enumerate(CHAINS_AB):
        chains = random_chains(torch, dev, seed=51 + i, d_in=d_in, layout=layout)
        structure, flat = chain_structure(chains), flatten_chains(chains)
        x = 0.5 * torch.randn((N, d_in), generator=gen, device=dev)
        douts = [torch.randn((N, w), generator=gen, device=dev) for _, heads in structure[1] for w in heads]
        fwd = lambda: fused_chains_fwd(x, flat, structure, "relu")  # noqa: E731
        bwd = lambda: fused_chains_bwd(x, flat, structure, "relu", douts)  # noqa: E731
        records.append({"shape": name, "N": N,
                        "fwd_route": launched_route(torch, "time_updates chain forward", fwd, fwd_routes, None),
                        "bwd_route": launched_route(torch, "time_updates chain backward", bwd, bwd_routes, None),
                        "fwd_ms": time_ms(torch, fwd, iters=20, warmup=3)[0],
                        "bwd_ms": time_ms(torch, bwd, iters=10, warmup=2)[0]})
    return records


def time_updates(torch, dev, label: str, card: str) -> None:
    """``--time-updates LABEL``: only the update kernels' device ms per
    launch at the main paths' shapes (``time_ms``: the feedforward kernel,
    262,144 rows, categorical and squashed; the recurrent one, 65,536
    sequences of 4 steps, categorical; the recurrent act kernel, 8,192 rows
    of one 256-wide layer; the continuous (squashed) and discrete act
    kernels, 8,192 rows of twin 256-wide torsos; GAE at T = 32 over 8,192
    columns (200 launches); the chain kernels at MischievousMule's 32,768
    minibatch rows, and the forward at 4,096; both at CHAINS_AB's shapes,
    ``time_chains_ab``) and the feedforward (both
    kinds), recurrent, recurrent act, both act kernels', chain forward (both
    row counts) and chain backward launches' device time by kernel
    (``torch.profiler``), and the wide routes (``time_wide_updates``), on
    one JSON line with LABEL and the card. To compare two commits on one
    card, unpack one into a directory that ``.gitignore`` lists (``git
    archive``) and run each checkout's ``chip_smoke.py --time-updates`` in
    turns (A, B, B, A) in one command (a checkout older than the wide
    routes' timings runs a copy of the newer script). The wide act routes
    are timed too (``time_wide_acts``), and the staged chain routes with
    the ``wide_custom`` cell (``time_wide_chains``)."""
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
    for key in ("ppo", "continuous_ppo"):
        split = out[f"{key}_split_ms"]
        out[f"{key}_row_pass_ms"] = sum(v for k, v in split.items() if re.search(ROW_PASS_KERNELS, k))
        out[f"{key}_weight_products_ms"] = sum(v for k, v in split.items() if re.search(WEIGHT_PRODUCT_KERNELS, k))

    N = 65536
    model = make_rnn_model(torch, "categorical", seed=110 + ord("a"))
    params = ops.pack_rnn_params(model)
    packed, unpack, _ = rnn_ppo_inputs(torch, dev, model, "categorical", N, 4, seed=ord("a"))
    cfg = ops.PPOLossConfig(clip_param=0.2, n_rows=N, use_entropy=False, **loss)
    out["rnn_ppo_ms"] = device_ms(lambda: ops.fused_rnn_ppo_grads(params, packed, unpack, ec, cfg))
    out["rnn_ppo_split_ms"] = split_ms(lambda: ops.fused_rnn_ppo_grads(params, packed, unpack, ec, cfg))
    split = out["rnn_ppo_split_ms"]
    out["rnn_ppo_row_pass_ms"] = sum(v for k, v in split.items() if re.search(ROW_PASS_KERNELS, k))
    out["rnn_ppo_weight_products_ms"] = sum(v for k, v in split.items() if re.search(WEIGHT_PRODUCT_KERNELS, k))
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
    del x, douts
    out["chains_ab"] = time_chains_ab(torch, dev)
    out.update(time_wide_chains(torch, dev, split_ms))
    out.update(time_wide_updates(torch, dev, split_ms))
    out.update(time_wide_acts(torch, dev, split_ms))
    emit(out)


def time_wide_chains(torch, dev, split_ms) -> dict:
    """``time_updates``' staged chain routes, on any checkout since the
    staged routes: ``wide_custom``'s chains (MischievousMule at 2048 wide)
    and ``deep_custom``'s (12 x 128), as ``make_mule`` initializes them. The
    forward at 4,096 and 32,768 rows; the backward at 32,768 rows on the
    route that training takes there (saved, after a saving forward, where
    the checkout's ``fused_chains_fwd`` has ``save``: ``saved_bwd_ms``;
    else recomputed); forward and backward through autograd
    (``fused_chains``) at 32,768 rows; each split by kernel, and each
    forward's and autograd pass's host ms (``time_ms``), with
    ``deep_custom``'s split by host event (``host_split``). Then the
    ``wide_custom`` cell and its module twin (``fused_forward=False``): one
    warm-up and three timed collect() + step() iterations
    (``time_iterations``), and the ``deep_custom`` cell (host-bound, so
    seven timed): the median's transitions/s, and the peak device memory of
    one more collect() and step() after a reset."""
    import inspect

    from rl8_tpu_torch import AlgorithmConfig, ops
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule
    from rl8_tpu_torch.ops.fused_mlp import chain_structure, default_chains, flatten_chains

    saving = "save" in inspect.signature(ops.fused_chains_fwd).parameters
    out = {"chains_saving_api": saving}
    gen = torch.Generator(device=dev).manual_seed(7)
    xs = {N: 0.5 * torch.randn((N, 7), generator=gen, device=dev) for N in (4096, 32768)}
    for name, hiddens in (("wide_custom", (2048, 2048)), ("deep_custom", (128,) * 12)):
        chains = default_chains(make_mule(torch, seed=5, hiddens=hiddens).to(dev))
        structure, flat = chain_structure(chains), flatten_chains(chains)
        for N, x in xs.items():
            run = lambda: ops.fused_chains_fwd(x, flat, structure, "relu")  # noqa: E731
            out[f"{name}_fwd_{N}_ms"], out[f"{name}_fwd_{N}_host_ms"] = time_ms(torch, run, iters=50, warmup=2)
            out[f"{name}_fwd_{N}_split_ms"] = split_ms(run, 60)
            if name == "deep_custom" and N == 4096:
                out[f"{name}_fwd_{N}_host_split"] = host_split(torch, run)
        x = xs[32768]
        douts = [torch.randn((32768, w), generator=gen, device=dev) for _, heads in structure[1] for w in heads]
        if saving:
            out[f"{name}_bwd_32768_ms"] = saved_bwd_ms(torch, x, flat, structure, "relu", douts, 5)
        else:
            out[f"{name}_bwd_32768_ms"] = time_ms(
                torch, lambda: ops.fused_chains_bwd(x, flat, structure, "relu", douts), iters=5, warmup=1)[0]
        leaves = [[tuple(t.detach().requires_grad_() for t in tensors) for tensors in (*layers, *heads)]
                  for layers, heads in chains]
        grad_chains = tuple((tuple(ts[: len(layers)]), tuple(ts[len(layers):]))
                            for ts, (layers, _) in zip(leaves, chains))

        def train():
            outs = ops.fused_chains("relu", x, grad_chains)
            torch.autograd.backward([o for chain in outs for o in chain],
                                    [d for d in douts])

        out[f"{name}_fwd_bwd_32768_ms"], out[f"{name}_fwd_bwd_32768_host_ms"] = time_ms(torch, train, iters=20,
                                                                                       warmup=1)
        out[f"{name}_fwd_bwd_32768_split_ms"] = split_ms(train, 60)
        if name == "deep_custom":
            out[f"{name}_fwd_bwd_32768_host_split"] = host_split(torch, train)
        del chains, leaves, grad_chains, douts
        torch.cuda.empty_cache()
    for key, fused, hiddens, iters in (("wide_custom", True, (2048, 2048), 4),
                                       ("wide_custom_module", False, (2048, 2048), 4),
                                       ("deep_custom", True, (128,) * 12, 8)):
        algo = AlgorithmConfig(model_cls=MischievousMule, fused_forward=fused, num_envs=4096, horizon=32,
                               sgd_minibatch_size=32768, model_config={"hiddens": hiddens},
                               device=dev).build(AlgoTrading)
        collect_ms, step_ms, _ = time_iterations(torch, algo, iters)
        med_collect, med_step = sorted(collect_ms)[iters // 2 - 1], sorted(step_ms)[iters // 2 - 1]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        algo.collect()
        algo.step()
        torch.cuda.synchronize()
        out[f"{key}_cell"] = {"collect_ms": collect_ms, "step_ms": step_ms,
                              "transitions_per_s_with_update": 4096 * 32 / ((med_collect + med_step) / 1e3),
                              "step_peak_memory_bytes": torch.cuda.max_memory_allocated()}
        del algo
        torch.cuda.empty_cache()
    return out


def host_split(torch, fn, calls: int = 20, top: int = 14) -> dict:
    """Where the host's time goes in ``calls`` calls of ``fn``
    (``torch.profiler``, CPU and CUDA activity): the wall µs a call with
    the profiler on, and the ``top`` events by self CPU time, each with its
    count and self CPU µs a call (time outside every event, such as a
    kernel library's own host code between its launches, is the rest of
    the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / calls * 1e6
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    return {"wall_us": wall, **{e.key[:60]: [e.count / calls, e.self_cpu_time_total / calls] for e in rows}}


def time_wide_updates(torch, dev, split_ms) -> dict:
    """``time_updates``' wide routes: the update kernels at the wide cells'
    shapes (the feedforward kernel at 1024 x 262,144 rows, categorical and
    squashed, ``wide_torso``; the recurrent one at H 1024 x 65,536
    sequences of 4, ``wide_recurrent``) and at the widest models
    ``rl8_tpu``'s gates admit (2388 x 4,096 rows; H 1617 x 2,048
    sequences), each with its device ms per launch, the plain version's, the
    f32 and 3xTF32 bounds, and the profiler's split by kernel and into the
    row pass (``row_pass_ms``: the row kernel, and the copies of the weights
    it reads), the weight products and their sums (``weight_products_ms``).
    Each shape's inputs and workspace are freed before the next (the 1024 x
    262,144 row scratch is ~17 GB)."""
    from rl8_tpu_torch import ops
    from rl8_tpu_torch.specs import Discrete

    loss = dict(vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, accum=1)
    ec = torch.tensor(0.0, device=dev)
    out = {}

    def record(name: str, run, plain, cost, iters: int) -> None:
        rec = {"ms": time_ms(torch, run, iters=iters, warmup=1)[0],
               "plain_ms": time_ms(torch, plain, iters=max(2, iters // 2), warmup=1)[0]}
        split = split_ms(run)
        rec["row_pass_ms"] = sum(v for k, v in split.items() if re.search(ROW_PASS_KERNELS, k))
        rec["weight_products_ms"] = sum(split.values()) - rec["row_pass_ms"]
        rec["split_ms"] = split
        update_bounds(rec, *cost)
        out[f"wide_{name}_ms"] = rec.pop("ms")
        out[f"wide_{name}"] = rec
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    for width, N, kind in ((1024, 8192 * 32, "categorical"), (1024, 8192 * 32, "squashed"),
                           (2388, 4096, "categorical")):
        if kind == "squashed":
            model = make_continuous_model(torch, 1, seed=80 + width, hiddens=(width, width))
            params, packed, unpack, _ = continuous_ppo_inputs(torch, dev, model, N, seed=width, squashed=True)
        else:
            model = make_model(torch, Discrete(2, shape=(1,)), seed=40 + width, hiddens=(width, width))
            params, packed, unpack = ppo_inputs(torch, dev, model, N, seed=width)
        cfg = ops.PPOLossConfig(clip_param=0.2, n_rows=N, use_entropy=False, squashed=kind == "squashed", **loss)
        record(f"ppo_{width}x{N}" + ("_squashed" if kind == "squashed" else ""),
               lambda: ops.fused_ppo_grads(params, packed, unpack, ec, cfg),
               lambda: ops.ppo_grads_plain(params, packed, unpack, ec, cfg), ppo_cost(params, packed),
               iters=3 if N > 8192 else 10)
        del model, params, packed, unpack
    for H, N in ((1024, 65536), (1617, 2048)):
        model = make_rnn_model(torch, "categorical", seed=110 + H, hidden_size=H)
        params = ops.pack_rnn_params(model)
        packed, unpack, _ = rnn_ppo_inputs(torch, dev, model, "categorical", N, 4, seed=H)
        cfg = ops.PPOLossConfig(clip_param=0.2, n_rows=N, use_entropy=False, **loss)
        record(f"rnn_ppo_{H}x{N}", lambda: ops.fused_rnn_ppo_grads(params, packed, unpack, ec, cfg),
               lambda: ops.rnn_ppo_grads_plain(params, packed, unpack, ec, cfg), rnn_ppo_cost(params, packed, 4),
               iters=3 if N > 8192 else 10)
        del model, params, packed, unpack
    return out


#: The wide act shapes ``time_wide_acts`` times: (H or width, rows), and
#: for the recurrent kernel the layers. The recurrent cell's (1024 x 8,192)
#: and H 289 to 1617 at 4,096 rows (RNN_WIDE_WIDTHS, 289, 512, two 1024-wide
#: layers); the wide cell's twin torso (1024 x 8,192) and 257 to 2388 at
#: 4,096 rows (WIDE_WIDTHS, 257, 384, 512). Those in *_HEADLINE are timed
#: beside their plain versions too.
RNN_ACT_TIMED = ((1024, 8192, 1), *((H, 4096, 1) for H in (289, 512, 721, 768, 1024, 1209, 1210, 1300, 1617)),
                 (1024, 4096, 2))
RNN_ACT_HEADLINE = ((1024, 8192, 1), (1209, 4096, 1), (1210, 4096, 1), (1617, 4096, 1))
ACT_TIMED = ((1024, 8192), *((w, 4096) for w in (257, 384, 512, 737, 1024, 1813, 1814, 2048, 2388)))
ACT_HEADLINE = ((1024, 8192), (2388, 4096))


def time_wide_acts(torch, dev, split_ms) -> dict:
    """``time_updates``' wide act routes: the recurrent act kernel
    (categorical, its heads drawn at 0.3 sqrt(256 / H) as
    ``run_rnn_wide_sweep`` draws them) over RNN_ACT_TIMED and both act
    kernels (categorical; SquashedNormal with the mean head at
    WIDE_MEAN_RMS) over ACT_TIMED, twin torsos of one width: each shape's
    device ms per launch (stochastic), the profiler's split by kernel, the
    f32 and 3xTF32 bounds, and at the *_HEADLINE shapes the plain
    version's ms. The records' names carry the shape (``wide_rnn_act_{H}x
    {rows}[_{layers}l]``, ``wide_act_{width}x{rows}[_squashed]``)."""
    from rl8_tpu_torch import ops
    from rl8_tpu_torch.specs import Discrete

    out = {}
    gen = torch.Generator(device=dev).manual_seed(21)

    def record(name: str, run, plain, cost, headline: bool) -> None:
        rec = {"ms": time_ms(torch, run, iters=10, warmup=2)[0]}
        if headline:
            rec["plain_ms"] = time_ms(torch, plain, iters=5, warmup=1)[0]
        rec["split_ms"] = split_ms(run)
        update_bounds(rec, *cost)
        out[f"wide_{name}_ms"] = rec.pop("ms")
        out[f"wide_{name}"] = rec

    for H, B, K in RNN_ACT_TIMED:
        params = ops.pack_rnn_params(make_rnn_model(torch, "categorical", seed=H + K, hidden_size=H, num_layers=K,
                                                    head_scale=0.3 * math.sqrt(256 / H)))
        obs = 3.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
        states = rnn_states(torch, dev, B, K, H, gen)
        record(f"rnn_act_{H}x{B}" + (f"_{K}l" if K > 1 else ""),
               lambda: ops.fused_rnn_act(params, obs, states, (1, 2)),
               lambda: ops.rnn_act_plain(params, obs, states, (1, 2), deterministic=False),
               rnn_act_cost(params, B), (H, B, K) in RNN_ACT_HEADLINE)
        del params, obs, states
    for w, B in ACT_TIMED:
        obs = 20.0 * torch.randn((B, 1), generator=gen, device=dev)
        for kind in ("categorical", "squashed"):
            if kind == "categorical":
                model = make_model(torch, Discrete(2, shape=(1,)), seed=w, hiddens=(w, w))
            else:
                model = scale_mean_head(torch, make_continuous_model(torch, 1, seed=w + 1, log_std_scale=0.03,
                                                                     hiddens=(w, w)), obs, WIDE_MEAN_RMS)
            params = ops.pack_act_params(model, squashed=kind == "squashed")
            record(f"act_{w}x{B}" + ("_squashed" if kind == "squashed" else ""),
                   lambda: ops.fused_act(params, obs, (1, 2)),
                   lambda: ops.act_plain(params, obs, (1, 2), deterministic=False), act_cost(params, B),
                   (w, B) in ACT_HEADLINE)
            del model, params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


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


#: The keys of a kernel's record at a wide cell's shapes in the
#: ``{"kernels": [...]}`` line.
WIDE_RECORD = ("ms", "plain_ms", "bound_ms", "bound_tc_ms", "route", "launches_per_iteration")
#: Twin-torso widths of the wide sweep: the update kernel's first width on
#: its wide route (737), the JAX bench's wide line (1024), the earlier
#: streaming act route's last width with its rows in shared memory and its
#: first in a scratch at the dummy envs' shapes (1813, 1814), and rl8_tpu's
#: last admitted width (2388).
WIDE_WIDTHS = (737, 1024, 1813, 1814, 2048, 2388)
#: The update kernel's row-pass routes per distribution family (continuous
#: or not), by kernel name (for launched_route): the narrow route (32-row
#: blocks, small minibatches) and the staged one (128-row blocks).
PPO_ROUTES = {
    False: {"ppo_rows_kernel<false": "narrow", "ppo_staged_fwd_kernel<false": "staged"},
    True: {"ppo_rows_kernel<true": "narrow", "ppo_staged_fwd_kernel<true": "staged"},
}
#: The update kernels' launches by part, by kernel name (the profiler's
#: split): the row pass (the row kernels, and the copies of the weights they
#: read) and the weight products with their fixed-order sum.
ROW_PASS_KERNELS = r"rows_kernel|staged_\w+_kernel|wide_\w+_kernel|transpose|tile_"
WEIGHT_PRODUCT_KERNELS = r"reduce_\w+_kernel|sum_partials_kernel"
#: The recurrent kernels' routes per distribution family (continuous or
#: not), by kernel name (for launched_route): the act kernel's 32-row tiles
#: in shared memory and its staged route (named by its heads kernel); the
#: update's narrow and staged row passes.
RNN_ACT_ROUTES = {
    c: {f"rnn_act_kernel<{b}": "shared32", f"rnn_heads_kernel<{b}": "staged"}
    for c, b in ((False, "false"), (True, "true"))
}
RNN_PPO_ROUTES = {
    c: {f"rnn_rows_kernel<{b}": "narrow", f"rnn_staged_fwd_kernel<{b}": "staged"}
    for c, b in ((False, "false"), (True, "true"))
}


def compare_act(torch, what: str, params, obs, key=(12345, 678), f64_fallback: bool = False):
    """An act kernel twice and its plain version, deterministic and
    stochastic (the plain version replays the kernel's Philox draws) on
    ``obs``: two launches bit-identical; categorical actions equal except
    rows whose top-2 scores are within TIE_GAP, continuous ones within
    ACT_*; values within ACT_*; log-probs within ACT_* of the plain
    distribution's log-prob of the kernel's own actions on every row and
    of the plain version's own where the actions agree (squashed: where
    every pre-squash |x| < SQUASH_LIMIT). Returns the largest error.
    ``f64_fallback``: where the plain f32 forward is no reference (its
    heads or values off the float64 forward's past ACT_RTOL, and ACT_ATOL /
    2 beyond it, on some row: down a deep torso f32 sums drift), the kernel
    is held to float64 instead (act_f64); returns a record of the reference
    held to and its errors."""
    from rl8_tpu_torch.distributions import Categorical, Normal, SquashedNormal
    from rl8_tpu_torch.ops import act_plain, fused_act
    from rl8_tpu_torch.ops.distmath import log_softmax_rows, philox_normal, philox_uniform
    from rl8_tpu_torch.ops.fused_act import ActParams
    from rl8_tpu_torch.ops.fused_mlp import forward_chains

    B, A = obs.shape[0], params.action_dim
    (heads, (values,)), _ = forward_chains(obs, params.chains(), params.activation)
    if f64_fallback:
        p64 = ActParams(**{**params.__dict__, "flat": params.flat.double()})
        (h64, (v64,)), _ = forward_chains(obs.double(), p64.chains(), params.activation)
        drift = max(float(((a.double() - b).abs() - ACT_RTOL * b.abs()).max())
                    for a, b in zip((*heads, values), (*h64, v64)))
        if drift > ACT_ATOL / 2:
            return {"plain_drift": drift, **act_f64(torch, what, params, obs, key, (heads, values), (h64, v64))}
    worst = 0.0
    for det in (True, False):
        name = f"{what} {'deterministic' if det else 'stochastic'}"
        ka, kl, kv = fused_act(params, obs, key, deterministic=det)
        k2 = fused_act(params, obs, key, deterministic=det)
        pa, pl, pv = act_plain(params, obs, key, deterministic=det)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((ka, kl, kv), k2)), f"{name}: two launches bit-identical")
        check(torch.allclose(kv, pv, rtol=ACT_RTOL, atol=ACT_ATOL), f"{name}: values")
        if params.continuous:
            mean, log_std = heads[0], torch.tanh(heads[1])
            dist = (SquashedNormal if params.kind == "squashed" else Normal)({"mean": mean, "log_std": log_std})
            check(torch.allclose(ka, pa, rtol=ACT_RTOL, atol=ACT_ATOL), f"{name}: actions")
            x = mean if det else mean + torch.exp(log_std) * philox_normal(*key, B, A, obs.device)
            keep = (x.abs() < SQUASH_LIMIT).all(dim=1) if params.kind == "squashed" else torch.ones_like(kv[:, 0] > 0)
            worst = max(worst, float((ka - pa).abs().max()))
        else:
            n = params.n
            z = torch.cat([log_softmax_rows(heads[0][:, a * n : (a + 1) * n]) for a in range(A)], 1).view(B, A, n)
            if not det:
                z = z - torch.log(-torch.log(philox_uniform(*key, B, A, n, obs.device).view(B, A, n)))
            top2 = z.topk(2, dim=-1).values
            keep = ~((top2[..., 0] - top2[..., 1]) < TIE_GAP).any(dim=1)
            check(bool((ka == pa).all(dim=1)[keep].all()), f"{name}: actions")
            dist = Categorical({"logits": heads[0].view(B, A, n)})
        own = dist.logp(ka)
        check(torch.allclose(kl, own, rtol=ACT_RTOL, atol=ACT_ATOL),
              f"{name}: logp vs the plain log-prob of its actions")
        check(torch.allclose(kl[keep], pl[keep], rtol=ACT_RTOL, atol=ACT_ATOL), f"{name}: logp")
        worst = max(worst, float((kv - pv).abs().max()), float((kl - own).abs().max()),
                    float((kl[keep] - pl[keep]).abs().max()))
    return {"held_to": "plain_f32", "plain_drift": drift, "max_abs_err": worst} if f64_fallback else worst


def act_dist(torch, params, heads):
    """The plain distribution of an act launch's policy heads: Categorical
    over the logits, or Normal/SquashedNormal over the mean and tanh of the
    pre-log-std."""
    from rl8_tpu_torch.distributions import Categorical, Normal, SquashedNormal

    if not params.continuous:
        return Categorical({"logits": heads[0].view(heads[0].shape[0], params.action_dim, params.n)})
    cls = SquashedNormal if params.kind == "squashed" else Normal
    return cls({"mean": heads[0], "log_std": torch.tanh(heads[1])})


def act_f64(torch, what: str, params, obs, key, plain, f64) -> dict:
    """compare_act's float64 branch, given the plain forward's ``(heads,
    values)`` in f32 and in float64: deterministic and stochastic (the
    kernel's Philox draws), two launches bit-identical; the values, the
    deterministic continuous actions and the log-probs of the kernel's own
    actions (squashed: rows where every pre-squash |x| < SQUASH_LIMIT) held
    to float64 by f64_rule (slack ACT_ATOL a row, by norm; the control the
    plain forward with one-pass TF32 products); the greedy actions equal
    float64's where its top two logits lie 8 times the plain f32 logits'
    largest drift apart."""
    from rl8_tpu_torch.ops import fused_act
    from rl8_tpu_torch.ops.distmath import philox_normal
    from rl8_tpu_torch.ops.fused_mlp import forward_chains

    (h32, v32), (h64, v64) = plain, f64
    (hc, (vc,)), _ = tf32_control(torch, lambda: forward_chains(obs, params.chains(), params.activation))
    B, A = obs.shape[0], params.action_dim
    d32, d64, dc = (act_dist(torch, params, h) for h in (h32, h64, hc))
    squash = torch.tanh if params.kind == "squashed" else (lambda t: t)
    rows, greedy = {}, None
    for det in (True, False):
        name = "deterministic" if det else "stochastic"
        ka, kl, kv = fused_act(params, obs, key, deterministic=det)
        k2 = fused_act(params, obs, key, deterministic=det)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((ka, kl, kv), k2)), f"{what} {name}: two launches bit-identical")
        rows[f"{name} values"] = f64_rule(kv, v32, v64, ACT_ATOL * math.sqrt(v64.numel()), vc)
        keep = torch.ones_like(kv[:, 0] > 0)
        if params.continuous:
            x = h64[0] if det else h64[0] + torch.exp(torch.tanh(h64[1])) * philox_normal(*key, B, A, obs.device)
            if params.kind == "squashed":
                keep = (x.abs() < SQUASH_LIMIT).all(dim=1)
            if det:
                rows[f"{name} actions"] = f64_rule(ka, squash(h32[0]), squash(h64[0]),
                                                   ACT_ATOL * math.sqrt(ka.numel()), squash(hc[0]))
        elif det:
            z64 = h64[0].view(B, A, params.n)
            top2 = z64.topk(2, dim=-1).values
            clear = ((top2[..., 0] - top2[..., 1]) > 8 * float((h32[0].double() - h64[0]).abs().max())).all(dim=1)
            check(bool((ka.long() == z64.argmax(-1))[clear].all()), f"{what} {name}: greedy actions vs float64")
            greedy = int(clear.sum())
        own = ka.double() if params.continuous else ka
        rows[f"{name} logp"] = f64_rule(kl[keep], d32.logp(ka)[keep], d64.logp(own)[keep],
                                        ACT_ATOL * math.sqrt(int(keep.sum())), dc.logp(ka)[keep])
    return {**check_f64(what, rows), "greedy_rows_compared": greedy, "max_abs_err": None}


def scale_mean_head(torch, model, obs, rms: float):
    """Scale a default continuous model's mean head (weights and bias) so
    that its means over ``obs`` have root mean square ``rms``."""
    from rl8_tpu_torch.ops import forward_chains, pack_act_params

    params = pack_act_params(model)
    ((mean, _), _), _ = forward_chains(obs, params.chains(), params.activation)
    with torch.no_grad():
        factor = rms / float(mean.pow(2).mean().sqrt())
        model.action_mean.weight.mul_(factor)
        model.action_mean.bias.mul_(factor)
    return model


def grad_tensors(params, flat) -> list:
    """``(chain, tensor)`` for every weight and bias of a flat gradient laid
    out as ``params`` (chain 0 the policy, 1 the value)."""
    from rl8_tpu_torch.ops.fused_act import ActParams

    return [(chain, t) for chain, (layers, heads) in enumerate(ActParams(**{**params.__dict__, "flat": flat}).chains())
            for pair in (*layers, *heads) for t in pair]


def tf32_control(torch, fn):
    """``fn()`` with one-pass TF32 matrix products: the control of F64_K's
    rule, a plain version computing in lower precision than f32."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return out


def f64_rule(k, p, f, slack: float, c) -> dict:
    """F64_K's rule for one tensor, where the plain f32 version ``p`` is no
    reference: the kernel's ``k`` may lie F64_K times p's distance from the
    float64 version ``f``, plus ``slack``, by norm. ``c`` is the control
    (tf32_control of the plain version), whose distance check_f64 holds to
    the same limit. Returns the distances and the limit."""
    k, p, f, c = k.double(), p.double(), f.double(), c.double()
    row = {"kernel": float((k - f).norm()), "plain": float((p - f).norm()), "control": float((c - f).norm()),
           "vs_plain": float((k - p).norm()), "ref": float(f.norm())}
    row["limit"] = F64_K * row["plain"] + slack
    return row


def check_f64(what: str, rows: dict) -> dict:
    """f64_rule's rows (name -> row): every kernel distance within its
    limit, and the control's past its limit on some row, so that each check
    shows that its limit refuses a version computing with one-pass TF32
    products. Returns the worst kernel and control distances over their
    limits and the worst distances off float64 (and the kernel's off the
    plain f32 version) relative to float64's norm."""
    for name, r in rows.items():
        ref = max(r["ref"], 1e-30)
        check(r["kernel"] <= r["limit"], f"{what} {name}: {r['kernel'] / ref:.3g} off float64, the plain f32 "
              f"version {r['plain'] / ref:.3g}, limit {r['limit'] / ref:.3g}")
    control = max(r["control"] / r["limit"] for r in rows.values())
    check(control > 1.0, f"{what}: the one-pass TF32 control lies within the limit ({control:.3g} of it)")
    rel = lambda key: max(r[key] / max(r["ref"], 1e-30) for r in rows.values())  # noqa: E731
    return {"held_to": "float64", "kernel_over_limit": max(r["kernel"] / r["limit"] for r in rows.values()),
            "tf32_control_over_limit": control, "kernel_off_float64": rel("kernel"),
            "plain_off_float64": rel("plain"), "tf32_control_off_float64": rel("control"),
            "kernel_vs_plain": rel("vs_plain")}


def compare_ppo_f64(torch, what: str, params, packed, unpack, ec, cfg, plain_first: bool = False) -> dict:
    """For inputs on which the plain f32 version is no reference (see F64_K:
    the saturated squashed rows of WIDE_MEAN_RMS, wide_torso's synthetic
    rows at 262,144, deep torsos): the update kernel twice, its plain
    version in f32, in float64 and, as the control, in f32 with one-pass
    TF32 products. The launches must be bit-identical and finite, and each
    gradient tensor is held to float64 by f64_rule (slack PPO_GRAD_* of its
    norm, check_f64). ``plain_first``: where the plain f32 gradient lies
    within PPO_GRAD_RTOL / 2 of float64's on every tensor, the kernel is
    held to it instead (compare_ppo)."""
    from rl8_tpu_torch.ops import fused_ppo_grads, ppo_grads_plain
    from rl8_tpu_torch.ops.fused_act import ActParams

    plain = ppo_grads_plain(params, packed, unpack, ec, cfg)[2]
    f64 = ppo_grads_plain(ActParams(**{**params.__dict__, "flat": params.flat.double()}), packed, unpack, ec, cfg)[2]
    tensors = lambda flat: grad_tensors(params, flat.double())  # noqa: E731
    off = max(float((p - f).norm()) / max(float(f.norm()), 1e-30) for (_, p), (_, f) in zip(tensors(plain),
                                                                                             tensors(f64)))
    if plain_first and off <= PPO_GRAD_RTOL / 2:
        result = compare_ppo(torch, what, params, packed, unpack, ec, cfg)
        return {"held_to": "plain_f32", "plain_off_float64": off, "max_abs_err": result["max_abs_err"],
                **result["summary"]}
    tf32 = tf32_control(torch, lambda: ppo_grads_plain(params, packed, unpack, ec, cfg)[2])
    k1 = fused_ppo_grads(params, packed, unpack, ec, cfg)[2]
    k2 = fused_ppo_grads(params, packed, unpack, ec, cfg)[2]
    torch.cuda.synchronize()
    check(torch.equal(k1, k2) and bool(torch.isfinite(k1).all()), f"{what}: two launches bit-identical and finite")
    rows = {f"{('policy', 'value')[chain]} {i} {tuple(f.shape)}": f64_rule(k, p, f, PPO_GRAD_RTOL * float(f.norm())
                                                                            + PPO_GRAD_ATOL, c)
            for i, ((chain, k), (_, p), (_, c), (_, f)) in enumerate(zip(tensors(k1), tensors(plain), tensors(tf32),
                                                                         tensors(f64)))}
    return {**check_f64(what, rows), "max_abs_err": None}


def check_halves(torch, what: str, params, packed, unpack, ec, cfg) -> float:
    """The update kernel over N rows against the mean of its launches over
    each half (n_rows N / 2 each): per gradient tensor within PPO_GRAD_*.
    At wide_torso's 262,144 rows the wide route's input slab lies past
    2^31 floats of the scratch, at 131,072 below it, so an index that
    wraps at 32 bits shows here. Returns the worst norm-relative error."""
    import dataclasses

    from rl8_tpu_torch.ops import fused_ppo_grads

    M = packed.shape[0] // 2
    half = dataclasses.replace(cfg, n_rows=M)
    full = fused_ppo_grads(params, packed, unpack, ec, cfg)[2]
    a = fused_ppo_grads(params, packed[:M].contiguous(), unpack, ec, half)[2]
    b = fused_ppo_grads(params, packed[M:].contiguous(), unpack, ec, half)[2]
    torch.cuda.synchronize()

    worst = 0.0
    halves = (a.double() + b.double()) / 2
    for (_, f), (_, h) in zip(grad_tensors(params, full.double()), grad_tensors(params, halves)):
        err, ref = float((f - h).norm()), float(h.norm())
        worst = max(worst, err / ref)
        check(err <= PPO_GRAD_RTOL * ref + PPO_GRAD_ATOL, f"{what}: gradient {tuple(h.shape)} error {err:.3g} "
              f"vs the mean of the halves' norm {ref:.3g}")
    return worst


def act_cost(params, B: int) -> tuple[int, int]:
    """``(FLOP, bytes)`` of an act launch of ``B`` rows: both chains'
    products and heads; observations and parameters read once, actions,
    log-probs and values written once."""
    H = params.hiddens
    macs = params.d_in * H[0] + sum(H[i] * H[i + 1] for i in range(len(H) - 1))
    flops = 2 * B * (2 * macs + H[-1] * (sum(params.policy_heads) + 1))
    return flops, 4 * (B * params.d_in + params.flat.numel() + B * (params.action_dim + 2))


def ppo_cost(params, packed) -> tuple[int, int]:
    """``(FLOP, bytes)`` of an update launch (``time_ppo``'s count): both
    chains' forward, and their backward's every dW and every dh past the
    first layer; the packed rows and the parameters read once, the
    gradient and the stats written once."""
    N, H, d_in = packed.shape[0], params.hiddens, params.d_in
    dense = d_in * H[0] + sum(H[i] * H[i + 1] for i in range(len(H) - 1))
    heads = H[-1] * (sum(params.policy_heads) + 1)
    fwd = 2 * dense + heads
    bwd = fwd + 2 * (dense - d_in * H[0]) + heads
    return 2 * N * (fwd + bwd), 4 * (packed.numel() + 2 * params.flat.numel() + 4 + 1)


def time_kernel(torch, what: str, fn, plain, cost: tuple[int, int], iters: int, plain_iters: int,
                plain_warmup: int = 1, **extra) -> dict:
    """A kernel's device ms per launch beside its plain version's, with its
    bounds (update_bounds); emits and returns the record. ``plain_warmup``
    0 where a check has just run the plain version on the same inputs."""
    record = dict(extra)
    record["ms"], record["host_ms"] = time_ms(torch, fn, iters=iters, warmup=1)
    record["plain_ms"], _ = time_ms(torch, plain, iters=plain_iters, warmup=plain_warmup)
    update_bounds(record, *cost)
    record.update(flops=cost[0], bytes=cost[1])
    emit({"phase": "kernel_time", "kernel": what, **record})
    return record


def buffer_rows(torch, algo, N: int, seed: int):
    """The first ``N`` rows of a collected buffer (time-major: the first
    time steps of every env) packed as a training minibatch: observations,
    actions, log-probs and values from the rollout, standard-normal
    advantages, returns around the values. Returns the observations, the
    packed rows and their unpacker."""
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.ops import pack_rows

    buf, T = algo.state.buffer, algo.hparams.horizon
    rows = lambda key: buf[key][:T].reshape(-1, buf[key].shape[-1])[:N]  # noqa: E731
    gen = torch.Generator(device=rows(DataKeys.OBS).device).manual_seed(seed)
    obs, values = rows(DataKeys.OBS).float().contiguous(), rows(DataKeys.VALUES)
    packed, unpack = pack_rows({
        DataKeys.ACTIONS: rows(DataKeys.ACTIONS).to(torch.int32),
        DataKeys.LOGP: rows(DataKeys.LOGP),
        DataKeys.ADVANTAGES: torch.randn((N, 1), generator=gen, device=obs.device),
        DataKeys.RETURNS: values + 2.0 * torch.randn((N, 1), generator=gen, device=obs.device),
        DataKeys.VIEWS: {DataKeys.OBS: obs},
    })
    return obs, packed, unpack


def run_wide_torso(torch, dev, kernels: dict) -> None:
    """``bench.py:366``'s wide line on the card: ``DefaultDiscreteModel``
    with a 1024-wide twin torso on ``DiscreteDummyEnv``, 8192 envs, horizon
    32, the defaults otherwise (a whole-buffer minibatch, 4 epochs, Adam
    1e-3 after the 5.0 clip): one warm-up, three timed and one profiled
    iteration (time_cell: act 32, GAE 1, update 4 launches an iteration).
    Then, on the first 8,192 rows of a collected buffer, the act kernel
    (its streaming route) and the update kernel (its wide route) against
    their plain versions, and both timed beside their plain versions: the
    act at 8,192 rows, the update at 8,192 and at the cell's 262,144 (the
    whole buffer checked against the plain version, the timed synthetic
    rows against float64, compare_ppo_f64, and against the kernel's
    launches over their halves, check_halves). Then the continuous kernels (SquashedNormal, the mean
    head at WIDE_MEAN_RMS) at the same widths: the act checked at 8,192
    rows, the update at 8,192 and 262,144, and timed as the discrete
    ones."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.ops import PPOLossConfig, act_plain, fused_act, fused_ppo_grads, ppo_grads_plain

    algo = AlgorithmConfig(device="cuda", model_config={"hiddens": (1024, 1024)}).build(DiscreteDummyEnv)
    h = algo.hparams
    check((algo._fused_act, algo._fused_update) == (True, True), "wide_torso: the kernels' routes")
    check(tuple(algo.policy.model.vf_model.layers[1].weight.shape) == (1024, 1024), "wide_torso: torso width")
    per_step = h.num_sgd_iters * h.num_minibatches
    check((h.num_envs, h.horizon, per_step) == (8192, 32, 4), "wide_torso: the bench's shapes")
    time_cell(torch, algo, "wide_torso", {"act": h.horizon, "gae": 1, "update": per_step}, per_step, iters=4,
              hiddens=[1024, 1024])
    algo.collect()
    params = algo._pack_params()
    obs, packed, unpack = buffer_rows(torch, algo, 8192, seed=16)
    act_route = launched_route(torch, "wide_torso act", lambda: fused_act(params, obs, (1, 2)),
                               ACT_ROUTES["discrete"], "staged")
    act_err = compare_act(torch, "wide_torso act", params, obs)
    cfg = algo._loss_config(8192)
    ec = torch.tensor(0.0, device=dev)
    ppo_route = launched_route(torch, "wide_torso update", lambda: fused_ppo_grads(params, packed, unpack, ec, cfg),
                               PPO_ROUTES[False], "staged")
    result = compare_ppo(torch, "wide_torso update", params, packed, unpack, ec, cfg)
    emit({"phase": "kernel_check", "kernel": "wide_torso", "N": 8192, "act_route": act_route,
          "act_max_abs_err": act_err, "update_route": ppo_route, **result["summary"]})
    rec = time_kernel(torch, "discrete_act", lambda: fused_act(params, obs, (1, 2)),
                      lambda: act_plain(params, obs, (1, 2), deterministic=False), act_cost(params, 8192),
                      iters=20, plain_iters=10, B=8192, hiddens=[1024, 1024], route=act_route,
                      launches_per_iteration=h.horizon)
    kernels["act"]["wide_torso"] = {k: rec[k] for k in WIDE_RECORD}
    time_kernel(torch, "ppo_update", lambda: fused_ppo_grads(params, packed, unpack, ec, cfg),
                lambda: ppo_grads_plain(params, packed, unpack, ec, cfg), ppo_cost(params, packed),
                iters=10, plain_iters=5, N=8192, hiddens=[1024, 1024], route=ppo_route)
    # At the cell's 262,144 rows: the whole buffer against the plain version,
    # then the synthetic rows that are timed against float64. On those the
    # trained policy's plain f32 gradient lands up to 5e-3 off float64 (the
    # kernel ~1e-5), so it is no reference there (compare_ppo_f64).
    cfg = algo._loss_config(8192 * 32)
    _, packed, unpack = buffer_rows(torch, algo, 8192 * 32, seed=16)
    result = compare_ppo(torch, "wide_torso update", params, packed, unpack, ec, cfg)
    params, packed, unpack = ppo_inputs(torch, dev, algo.policy.model, 8192 * 32, seed=17)
    synthetic = compare_ppo_f64(torch, "wide_torso update (synthetic rows)", params, packed, unpack, ec, cfg)
    halves = check_halves(torch, "wide_torso update (halves)", params, packed, unpack, ec, cfg)
    emit({"phase": "kernel_check", "kernel": "wide_torso", "N": 8192 * 32, "update_route": ppo_route,
          **result["summary"], "synthetic_rows": synthetic, "halves_worst_grad_norm_rel_err": halves})
    time_kernel(torch, "ppo_update", lambda: fused_ppo_grads(params, packed, unpack, ec, cfg),
                lambda: ppo_grads_plain(params, packed, unpack, ec, cfg), ppo_cost(params, packed),
                iters=3, plain_iters=2, N=8192 * 32, hiddens=[1024, 1024], route=ppo_route)
    # The continuous kernels at the same widths and rows (SquashedNormal, as
    # the squashed cell): the act checked and timed at 8,192 rows, the
    # update at 8,192 and 262,144.
    model = scale_mean_head(torch, make_continuous_model(torch, 1, seed=19, log_std_scale=0.03, hiddens=(1024, 1024)),
                            obs, WIDE_MEAN_RMS)
    for N in (8192, 8192 * 32):
        params, packed, unpack, _ = continuous_ppo_inputs(torch, dev, model, N, seed=20, squashed=True)
        cfg = PPOLossConfig(clip_param=0.2, vf_clip_param=h.vf_clip_param, vf_coeff=h.vf_coeff, dual_clip_param=None,
                            n_rows=N, accum=1, use_entropy=False, squashed=True)
        checked = {}
        if N == 8192:
            act_route = launched_route(torch, "wide_torso continuous act", lambda: fused_act(params, obs, (1, 2)),
                                       ACT_ROUTES["continuous"], "staged")
            checked = {"act_route": act_route, "act_max_abs_err": compare_act(torch, "wide_torso continuous act",
                                                                               params, obs)}
        result = compare_ppo(torch, "wide_torso continuous update", params, packed, unpack, ec, cfg)
        emit({"phase": "kernel_check", "kernel": "wide_torso_continuous", "N": N, **checked, **result["summary"]})
        if N == 8192:
            rec = time_kernel(torch, "continuous_act", lambda: fused_act(params, obs, (1, 2)),
                              lambda: act_plain(params, obs, (1, 2), deterministic=False), act_cost(params, N),
                              iters=20, plain_iters=10, B=N, hiddens=[1024, 1024], kind="squashed",
                              route=act_route, launches_per_iteration=0)
            kernels["continuous_act"]["wide_torso_squashed"] = {k: rec[k] for k in WIDE_RECORD}
        time_kernel(torch, "continuous_ppo_update", lambda: fused_ppo_grads(params, packed, unpack, ec, cfg),
                    lambda: ppo_grads_plain(params, packed, unpack, ec, cfg), ppo_cost(params, packed),
                    iters=10 if N == 8192 else 3, plain_iters=5 if N == 8192 else 2, N=N, hiddens=[1024, 1024],
                    kind="squashed", route="staged")


def run_wide_sweep(torch, dev, kernels: dict) -> None:
    """Fixed inputs at 4,096 rows, twin torsos of WIDE_WIDTHS: for
    Categorical (DefaultDiscreteModel), Normal (with an entropy bonus) and
    SquashedNormal (DefaultContinuousModel, its mean head scaled to
    WIDE_MEAN_RMS), the act kernel (compare_act; its staged route) and the update
    kernel (compare_ppo; its staged route) against their plain versions, each
    route asserted; for SquashedNormal also the update on the mean head as
    drawn, deep in the tanh's saturation, against float64 over
    SATURATED_DRAWS input draws (compare_ppo_f64); at
    2388 the act and update kernels timed beside their plain versions.
    The same checks at other depths, widths, inputs and heads: three
    uneven tanh layers (1024, 737, 900) at an obs dim of 3 with A=3, n=3;
    one 3000-wide layer, Normal over 4 dims at an obs dim of 5; eight
    737-wide layers; each with an entropy bonus, dual clip and
    accumulation; and the update alone at 2,000 logits on a 64-wide torso
    (heads that only the wide route takes), the act kernel alone at 4,096
    (its staged route; the gates' and the update kernel's answers
    recorded). Then, over a grid of default models (check_gate_grid),
    every model rl8_tpu's residency gate admits is taken by the card's act
    and update kernels; and a 2389-wide twin torso, past the gate, builds
    onto the module rollout and the autodiff update, as rl8_tpu routes it,
    and trains one collect and one step with no act or update launch."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.ops import PPOLossConfig, act_plain, card_takes_act, card_takes_update, fused_act
    from rl8_tpu_torch.ops import fused_ppo_grads, model_fits_vmem, pack_act_params, ppo_grads_plain
    from rl8_tpu_torch.specs import Discrete

    N = 4096
    gen = torch.Generator(device=dev).manual_seed(15)
    for w in WIDE_WIDTHS:
        obs = 20.0 * torch.randn((N, 1), generator=gen, device=dev)
        saturated = make_continuous_model(torch, 1, seed=w + 1, log_std_scale=0.03, hiddens=(w, w))
        models = {"discrete": make_model(torch, Discrete(2, shape=(1,)), seed=w, hiddens=(w, w)),
                  "continuous": scale_mean_head(torch, copy.deepcopy(saturated), obs, WIDE_MEAN_RMS)}
        for kind in ("categorical", "normal", "squashed"):
            model = models["discrete" if kind == "categorical" else "continuous"]
            params = pack_act_params(model, squashed=kind == "squashed")
            what = f"wide_sweep {kind} {w}"
            act_route = launched_route(torch, f"{what} act", lambda: fused_act(params, obs, (1, 2)),
                                       ACT_ROUTES["continuous" if params.continuous else "discrete"],
                                       "staged")
            act_err = compare_act(torch, f"{what} act", params, obs)
            regimes = {}
            if kind == "categorical":
                params, packed, unpack = ppo_inputs(torch, dev, model, N, seed=w)
            else:
                params, packed, unpack, clamped = continuous_ppo_inputs(torch, dev, model, N, seed=w,
                                                                        squashed=kind == "squashed")
                regimes = {"rows_clamped": int(clamped.sum())}
            cfg = PPOLossConfig(clip_param=0.2, vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=3.0, n_rows=N,
                                accum=1, use_entropy=kind == "normal", squashed=kind == "squashed")
            ec = torch.tensor(0.01 if kind == "normal" else 0.0, device=dev)
            ppo_route = launched_route(torch, f"{what} update",
                                       lambda: fused_ppo_grads(params, packed, unpack, ec, cfg),
                                       PPO_ROUTES[params.continuous], "staged")
            result = compare_ppo(torch, f"{what} update", params, packed, unpack, ec, cfg)
            if kind == "squashed":
                # The same squashed update on the heads as drawn (saturated),
                # over SATURATED_DRAWS draws of the inputs.
                regimes["saturated"] = []
                for draw in range(SATURATED_DRAWS):
                    sat, sat_packed, sat_unpack, sat_clamped = continuous_ppo_inputs(
                        torch, dev, saturated, N, seed=w + 7919 * draw, squashed=True)
                    regimes["saturated"].append({
                        "rows_clamped": int(sat_clamped.sum()),
                        **compare_ppo_f64(torch, f"{what} saturated update (draw {draw})", sat, sat_packed,
                                          sat_unpack, ec, cfg)})
            emit({"phase": "kernel_check", "kernel": "wide_sweep", "width": w, "kind": kind, "N": N,
                  "act_route": act_route, "act_max_abs_err": act_err, "update_route": ppo_route,
                  **regimes, **result["summary"]})
            if w == 2388:
                rec = time_kernel(torch, "continuous_act" if params.continuous else "discrete_act",
                                  lambda: fused_act(params, obs, (1, 2)),
                                  lambda: act_plain(params, obs, (1, 2), deterministic=False), act_cost(params, N),
                                  iters=10, plain_iters=5, B=N, hiddens=[w, w], kind=kind, route=act_route,
                                  launches_per_iteration=0)
                if kind != "normal":
                    key = "continuous_act" if params.continuous else "act"
                    kernels[key][f"wide_sweep_{w}x{N}"] = {k: rec[k] for k in WIDE_RECORD}
                time_kernel(torch, "continuous_ppo_update" if params.continuous else "ppo_update",
                            lambda: fused_ppo_grads(params, packed, unpack, ec, cfg),
                            lambda: ppo_grads_plain(params, packed, unpack, ec, cfg), ppo_cost(params, packed),
                            iters=5, plain_iters=3, N=N, hiddens=[w, w], kind=kind, route=ppo_route)
    # Other depths, widths, inputs and heads on the wide routes: three
    # uneven tanh layers, one 3000-wide layer (admitted: one layer's
    # residents are small) and eight 737-wide layers.
    shapes = [("categorical", 3, (3, 3), {"hiddens": (1024, 737, 900), "activation_fn": "tanh"}, "staged"),
              ("normal", 5, 4, {"hiddens": (3000,)}, "staged"),
              ("categorical", 1, (1, 2), {"hiddens": (737,) * 8}, "staged")]
    for kind, obs_dim, action, config, want in shapes:
        if kind == "categorical":
            model = make_model(torch, Discrete(action[1], shape=(action[0],)), seed=obs_dim, obs_dim=obs_dim, **config)
        else:
            model = make_continuous_model(torch, action, seed=obs_dim, obs_dim=obs_dim, **config)
        obs = 20.0 * torch.randn((N, obs_dim), generator=gen, device=dev)
        if kind != "categorical":
            model = scale_mean_head(torch, model, obs, WIDE_MEAN_RMS)
        params = pack_act_params(model)
        what = f"wide_sweep {kind} {config['hiddens']}"
        act_route = launched_route(torch, f"{what} act", lambda: fused_act(params, obs, (1, 2)),
                                   ACT_ROUTES["continuous" if params.continuous else "discrete"], want)
        act_err = compare_act(torch, f"{what} act", params, obs)
        if kind == "categorical":
            params, packed, unpack = ppo_inputs(torch, dev, model, N, seed=obs_dim)
        else:
            params, packed, unpack, _ = continuous_ppo_inputs(torch, dev, model, N, seed=obs_dim, squashed=False)
        cfg = PPOLossConfig(clip_param=0.2, vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=3.0, n_rows=N,
                            accum=2, use_entropy=True)
        ec = torch.tensor(0.01, device=dev)
        ppo_route = launched_route(torch, f"{what} update", lambda: fused_ppo_grads(params, packed, unpack, ec, cfg),
                                   PPO_ROUTES[params.continuous], "staged")
        result = compare_ppo(torch, f"{what} update", params, packed, unpack, ec, cfg)
        emit({"phase": "kernel_check", "kernel": "wide_sweep", "hiddens": list(params.hiddens), "kind": kind,
              "obs_dim": obs_dim, "activation": params.activation, "policy_heads": list(params.policy_heads), "N": N,
              "act_route": act_route, "act_max_abs_err": act_err, "update_route": ppo_route, **result["summary"]})
    # Heads too wide for the narrow route's shared memory (2,000 logits on a
    # 64-wide torso): the wide route keeps them in its row scratch.
    params, packed, unpack = ppo_inputs(torch, dev, make_model(torch, Discrete(2000, shape=(1,)), seed=64,
                                                               hiddens=(64, 64)), N, seed=64)
    cfg = PPOLossConfig(clip_param=0.2, vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=None, n_rows=N, accum=1,
                        use_entropy=False)
    ec = torch.tensor(0.0, device=dev)
    what = "wide_sweep 2000 logits update"
    ppo_route = launched_route(torch, what, lambda: fused_ppo_grads(params, packed, unpack, ec, cfg),
                               PPO_ROUTES[False], "staged")
    result = compare_ppo(torch, what, params, packed, unpack, ec, cfg)
    emit({"phase": "kernel_check", "kernel": "wide_sweep", "hiddens": [64, 64], "kind": "categorical",
          "policy_heads": list(params.policy_heads), "N": N, "update_route": ppo_route, **result["summary"]})
    # 4,096 logits on a 64-wide torso: heads too wide for the tiled route's
    # shared memory (and for the earlier streaming route's 16 rows); the
    # staged route keeps them in its scratch.
    model = make_model(torch, Discrete(4096, shape=(1,)), seed=65, hiddens=(64, 64))
    params = pack_act_params(model)
    obs = 20.0 * torch.randn((N, 1), generator=gen, device=dev)
    what = "wide_sweep 4096 logits act"
    act_route = launched_route(torch, what, lambda: fused_act(params, obs, (1, 2)), ACT_ROUTES["discrete"], "staged")
    emit({"phase": "kernel_check", "kernel": "wide_sweep", "hiddens": [64, 64], "kind": "categorical",
          "policy_heads": list(params.policy_heads), "N": N, "act_route": act_route,
          "act_max_abs_err": compare_act(torch, what, params, obs), "card_takes_act": card_takes_act(params),
          "card_takes_update": card_takes_update(params), "model_fits_vmem": model_fits_vmem(model)})
    check_gate_grid(torch)
    zero_counters()
    algo = AlgorithmConfig(device="cuda", num_envs=1024, model_config={"hiddens": (2389, 2389)}).build(
        DiscreteDummyEnv)
    flags = (algo._fused_act, algo._fused_update, algo._fused_forward)
    check(flags == (False, False, False), f"wide_sweep 2389: routes {flags}, not rl8_tpu's module routes")
    algo.collect()
    stats = algo.step()
    launches = launch_counts()
    check(launches["act"] == 0 and launches["update"] == 0 and launches["gae"] == 1,
          f"wide_sweep 2389: launches {launches}")
    check(all(math.isfinite(v) for v in stats.values()), f"wide_sweep 2389: step stats finite: {stats}")
    emit({"phase": "wide_sweep_module_route", "hiddens": [2389, 2389], "num_envs": 1024, "routes": flags,
          "launches": launches, "losses/total": stats["losses/total"]})


def check_gate_grid(torch) -> None:
    """Default models built without values (the ``meta`` device) over obs
    dims 1 and 4, Categorical over A x n of 1x2, 3x3 and 1x64 and Normal
    and SquashedNormal over 1 and 6 dims, 1 to 8 layers and widths from 64
    to 4096: every model rl8_tpu's residency gate (``model_fits_vmem``)
    admits is taken by the card's act and update kernels
    (``card_takes_act``, ``card_takes_update``)."""
    from rl8_tpu_torch.models import DefaultContinuousModel, DefaultDiscreteModel
    from rl8_tpu_torch.ops import card_takes_act, card_takes_update, model_fits_vmem, pack_act_params
    from rl8_tpu_torch.specs import Discrete, Unbounded

    widths = (64, 256, 257, 512, 736, 737, 1024, 1500, 1813, 1814, 2048, 2388, 2389, 3000, 4096)
    actions = [("categorical", Discrete(2, shape=(1,))), ("categorical", Discrete(3, shape=(3,))),
               ("categorical", Discrete(64, shape=(1,))), ("normal", Unbounded(1)), ("squashed", Unbounded(1)),
               ("normal", Unbounded(6)), ("squashed", Unbounded(6))]
    admitted = refused = 0
    widest = {}
    for obs_dim in (1, 4):
        for kind, spec in actions:
            cls = DefaultDiscreteModel if kind == "categorical" else DefaultContinuousModel
            for layers in range(1, 9):
                for w in widths:
                    with torch.device("meta"):
                        model = cls(Unbounded(obs_dim), spec, hiddens=(w,) * layers)
                    if not model_fits_vmem(model):
                        refused += 1
                        continue
                    admitted += 1
                    widest[layers] = max(widest.get(layers, 0), w)
                    params = pack_act_params(model, squashed=kind == "squashed")
                    shape = f"obs {obs_dim}, {kind} {params.policy_heads}, {layers} x {w}"
                    check(card_takes_update(params), f"gate grid: the update kernel refuses {shape}")
                    check(card_takes_act(params), f"gate grid: the act kernel refuses {shape}")
    check(admitted > 0 and refused > 0, "gate grid: both sides of the gate")
    emit({"phase": "wide_gate_grid", "admitted": admitted, "refused_by_the_gate": refused,
          "widest_admitted_by_layers": widest})


def run_recurrent_path(torch, dev, kernels: dict) -> None:
    """The recurrent main path: ``RecurrentAlgorithmConfig(device="cuda")
    .build(DiscreteDummyEnv)`` at the JAX package's defaults, one warm-up
    and five timed collect() + step() iterations; every kernel of the path
    must have launched (recurrent act 32, GAE 1, recurrent update 4 per
    iteration) and no other. Then one more collect, whose log-probs and
    values are held against the module's plain forward from the stored
    states, and a profiled collect and step."""
    from rl8_tpu_torch import RecurrentAlgorithmConfig
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

    T, B = h.horizon, h.num_envs
    worst = check_recurrent_rollout(torch, algo, ACT_RTOL, ACT_ATOL)
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


def check_recurrent_rollout(torch, algo, rtol: float, atol: float) -> float:
    """Collect once more and hold the rollout against the module: per
    step, the model's forward from the stored input states gives the
    values and the log-probs of the stored actions, and the stored next
    states (where no reset follows). Returns the largest difference."""
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.views import tree_map

    h, model = algo.hparams, algo.policy.model
    algo.collect()
    buffer = algo.state.buffer
    T, B = h.horizon, h.num_envs
    states = buffer[DataKeys.STATES]
    shape = (T + 1, B, model.num_layers, model.hidden_size)
    check(tuple(states[DataKeys.HIDDEN_STATES].shape) == shape, "buffer states shape")
    check(all(v.dtype == torch.float32 for v in states.values()), "buffer states are f32")
    worst = 0.0
    with torch.no_grad():
        for t in range(T):
            step_states = {k: v[t] for k, v in states.items()}
            obs = tree_map(lambda o: o[t][:, None], buffer[DataKeys.OBS])
            (features, values), new_states = model({DataKeys.OBS: obs}, step_states)
            logp = algo.policy.distribution_cls(features, model).logp(buffer[DataKeys.ACTIONS][t])
            for what, got, want in (("values", buffer[DataKeys.VALUES][t], values),
                                    ("logp", buffer[DataKeys.LOGP][t], logp)):
                worst = max(worst, float((got - want).abs().max()))
                check(torch.allclose(got, want, rtol=rtol, atol=atol), f"recurrent rollout {what} at t={t}")
            if (t + 1) % h.seq_len or ((t + 1) // h.seq_len + algo.state.seqs - T // h.seq_len) % h.seqs_per_state_reset:
                for k, v in new_states.items():
                    check(torch.allclose(states[k][t + 1], v, rtol=rtol, atol=atol),
                          f"recurrent rollout {k} at t={t + 1}")
    return worst


#: The recurrent kernels' wide widths (one layer, the dummy envs' shapes):
#: the update's last narrow width and its staged route (721, 768), the wide
#: cell's (1024), the earlier act routes' last width with 16-row tiles in
#: shared memory and first on their wide route (1209, 1210), and rl8_tpu's
#: last admitted width (1617).
RNN_WIDE_WIDTHS = (721, 768, 1024, 1209, 1210, 1300, 1617)


#: The recurrent update's route rule (csrc/rnn_ppo.cu's kStagedMinRows,
#: kStagedMinWidth): the staged route from this many sequences at this
#: width; the act kernel's (csrc/rnn_act.cu's kStagedMinWidth): its staged
#: route from this width at any row count.
RNN_STAGED_MIN_ROWS, RNN_STAGED_MIN_WIDTH, RNN_ACT_STAGED_MIN_WIDTH = 16384, 64, 128


def rnn_routes(H: int, N: int) -> tuple[str, str]:
    """The routes the recurrent act and update kernels take at one or two
    H-wide layers, N rows (sequences of the update) and the dummy envs'
    inputs and heads (three head outputs): the act kernel's 32-row tiles
    below RNN_ACT_STAGED_MIN_WIDTH, its staged route from there; the
    update's staged route for N of RNN_STAGED_MIN_ROWS or more at H of
    RNN_STAGED_MIN_WIDTH or more and past 724 (where the narrow row pass
    does not fit), its narrow row pass for the rest."""
    act = "shared32" if H < RNN_ACT_STAGED_MIN_WIDTH else "staged"
    staged = H > 724 or (N >= RNN_STAGED_MIN_ROWS and H >= RNN_STAGED_MIN_WIDTH)
    return act, "staged" if staged else "narrow"


def recurrent_buffer_rows(torch, algo):
    """A collected recurrent buffer packed as the algorithm's update packs
    it (``_step_impl``: [seq_len] chunks with their stored initial states,
    advantages and returns from the advantage stage). Returns the packed
    sequences and their unpacker."""
    from rl8_tpu_torch.algorithms._recurrent import _seq_major
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.ops import pack_rows

    h, buf = algo.hparams, algo.state.buffer
    T, L = h.horizon, h.seq_len
    advantages, returns = algo._advantages()
    return pack_rows({
        DataKeys.OBS: _seq_major(buf[DataKeys.OBS][:T], L),
        DataKeys.STATES: {k: _seq_major(v[:T], L)[:, 0] for k, v in buf[DataKeys.STATES].items()},
        DataKeys.ACTIONS: _seq_major(buf[DataKeys.ACTIONS], L),
        DataKeys.LOGP: _seq_major(buf[DataKeys.LOGP], L),
        DataKeys.ADVANTAGES: _seq_major(advantages, L),
        DataKeys.RETURNS: _seq_major(returns, L),
    })


def check_rnn_halves(torch, what: str, params, packed, unpack, ec, cfg) -> float:
    """The recurrent update kernel over N sequences against the mean of its
    launches over each half (n_rows N / 2 each): per gradient tensor within
    PPO_GRAD_*. At 65,536 sequences of a 1024-wide LSTM the workspace
    passes 2^31 floats (its gate scratch alone is 1.07e9), at half of them
    it does not, so an offset that wraps at 32 bits shows here. Returns the
    worst norm-relative error."""
    import dataclasses

    from rl8_tpu_torch.ops import fused_rnn_ppo_grads
    from rl8_tpu_torch.ops.fused_rnn_act import RnnParams

    M = packed.shape[0] // 2
    half = dataclasses.replace(cfg, n_rows=M)
    full = fused_rnn_ppo_grads(params, packed, unpack, ec, cfg)[2]
    a = fused_rnn_ppo_grads(params, packed[:M].contiguous(), unpack, ec, half)[2]
    b = fused_rnn_ppo_grads(params, packed[M:].contiguous(), unpack, ec, half)[2]
    torch.cuda.synchronize()

    def tensors(flat):
        views = RnnParams(**{**params.__dict__, "flat": flat})
        return [t for layer in views.lstm() for t in layer] + [t for head in views.heads() for t in head]

    worst = 0.0
    for f, h in zip(tensors(full.double()), tensors((a.double() + b.double()) / 2)):
        err, ref = float((f - h).norm()), float(h.norm())
        worst = max(worst, err / ref)
        check(err <= PPO_GRAD_RTOL * ref + PPO_GRAD_ATOL, f"{what}: gradient {tuple(h.shape)} error {err:.3g} "
              f"vs the mean of the halves' norm {ref:.3g}")
    return worst


def run_wide_recurrent(torch, dev, kernels: dict) -> None:
    """The wide recurrent cell: ``RecurrentAlgorithmConfig(device="cuda",
    model_config={"hidden_size": 1024}).build(DiscreteDummyEnv)`` (8192
    envs, horizon 32, seq_len 4, a whole-buffer minibatch of 65,536
    sequences, 4 epochs): one warm-up, three timed and one profiled
    iteration (time_cell: recurrent act 32, GAE 1, recurrent update 4
    launches an iteration, no other kernel). Then one more collect, held
    against the module from the stored states; on its buffer, packed as the
    update packs it, the update kernel (its staged route) against its plain
    version over all 65,536 sequences and against its launches over the
    halves (check_rnn_halves), and both kernels timed beside their plain
    versions at the cell's shapes (the act kernel on its staged route).
    Then the same cell with ``fused_act=False, fused_update=False`` (the
    module rollout and the autodiff update) timed the same way."""
    from rl8_tpu_torch import RecurrentAlgorithmConfig
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.ops import fused_rnn_act, fused_rnn_ppo_grads, rnn_act_plain, rnn_ppo_grads_plain

    H = 1024
    algo = RecurrentAlgorithmConfig(device="cuda", model_config={"hidden_size": H}).build(DiscreteDummyEnv)
    h, model = algo.hparams, algo.policy.model
    per_step = h.num_sgd_iters * h.num_minibatches
    check((algo._fused_act, algo._fused_update) == (True, True), "wide_recurrent: the kernels' routes")
    check(tuple(model.lstm.wh[0].shape) == (H, 4 * H) and model.num_layers == 1, "wide_recurrent: LSTM width")
    check((h.num_envs, h.horizon, h.seq_len, per_step) == (8192, 32, 4, 4), "wide_recurrent: the cell's shapes")
    cell = time_cell(torch, algo, "wide_recurrent", {"rnn_act": h.horizon, "gae": 1, "rnn_update": per_step},
                     per_step, iters=4, hidden_size=H)
    worst = check_recurrent_rollout(torch, algo, ACT_RTOL, ACT_ATOL)
    params = algo._pack_params()
    B, T = h.num_envs, h.horizon
    obs = algo.state.buffer[DataKeys.OBS][0].float().contiguous()
    states = {k: v[0].contiguous() for k, v in algo.state.buffer[DataKeys.STATES].items()}
    act_route = launched_route(torch, "wide_recurrent act", lambda: fused_rnn_act(params, obs, states, (1, 2)),
                               RNN_ACT_ROUTES[False], rnn_routes(H, B)[0])
    act = compare_rnn_act(torch, "wide_recurrent act", params, obs, states)
    packed, unpack = recurrent_buffer_rows(torch, algo)
    N = packed.shape[0]
    check(N == B * T // h.seq_len, f"wide_recurrent: {N} sequences in the buffer")
    cfg = algo._loss_config(N)
    check(not cfg.use_entropy, "wide_recurrent: no entropy bonus at the defaults")
    ec = torch.tensor(0.0, device=dev)
    ppo_route = launched_route(torch, "wide_recurrent update",
                               lambda: fused_rnn_ppo_grads(params, packed, unpack, ec, cfg), RNN_PPO_ROUTES[False],
                               rnn_routes(H, N)[1])
    result = compare_rnn_ppo(torch, "wide_recurrent update (whole buffer)", params, packed, unpack, ec, cfg)
    halves = check_rnn_halves(torch, "wide_recurrent update (halves)", params, packed, unpack, ec, cfg)
    emit({"phase": "kernel_check", "kernel": "wide_recurrent", "hidden_size": H, "sequences": N, "seq_len": h.seq_len,
          "rollout_vs_module_max_abs_err": worst, "act_route": act_route, "act": act, "update_route": ppo_route,
          **result["summary"], "halves_worst_grad_norm_rel_err": halves})
    wide = {
        "act": time_kernel(torch, "rnn_act", lambda: fused_rnn_act(params, obs, states, (1, 2)),
                           lambda: rnn_act_plain(params, obs, states, (1, 2), deterministic=False),
                           rnn_act_cost(params, B), iters=20, plain_iters=10, B=B, hidden_size=H, route=act_route,
                           launches_per_iteration=h.horizon),
        "ppo": time_kernel(torch, "rnn_ppo_update", lambda: fused_rnn_ppo_grads(params, packed, unpack, ec, cfg),
                           lambda: rnn_ppo_grads_plain(params, packed, unpack, ec, cfg),
                           rnn_ppo_cost(params, packed, h.seq_len), iters=3, plain_iters=2, N=N, hidden_size=H,
                           route=ppo_route, launches_per_iteration=per_step),
    }
    for key, rec in wide.items():
        kernels["rnn_" + key]["wide_recurrent"] = {k: rec[k] for k in WIDE_RECORD}
    del algo, packed
    torch.cuda.empty_cache()
    module = RecurrentAlgorithmConfig(device="cuda", model_config={"hidden_size": H}, fused_act=False,
                                      fused_update=False).build(DiscreteDummyEnv)
    twin = time_cell(torch, module, "wide_recurrent_module_route", {"gae": 1}, per_step, iters=4, hidden_size=H)
    emit({"phase": "wide_recurrent_summary", "hidden_size": H,
          "kernels_transitions_per_s_with_update": cell["transitions_per_s_with_update"],
          "module_transitions_per_s_with_update": twin["transitions_per_s_with_update"],
          "kernels_over_module": cell["transitions_per_s_with_update"] / twin["transitions_per_s_with_update"]})


def rnn_gate_limit(torch, layers: int) -> int:
    """The widest LSTM of ``layers`` layers that rl8_tpu's residency gate
    (``supports_fused_rnn_update``) admits at the dummy envs' shapes,
    found by bisection on models without values (the ``meta`` device)."""
    from rl8_tpu_torch.distributions import Categorical
    from rl8_tpu_torch.models import DefaultDiscreteRecurrentModel
    from rl8_tpu_torch.ops import supports_fused_rnn_update
    from rl8_tpu_torch.specs import Discrete, Unbounded

    def admitted(H: int) -> bool:
        with torch.device("meta"):
            model = DefaultDiscreteRecurrentModel(Unbounded(1), Discrete(2, shape=(1,)), hidden_size=H,
                                                  num_layers=layers)
        return supports_fused_rnn_update(model, Categorical)

    lo, hi = 1, 1 << 14
    check(admitted(lo) and not admitted(hi), "rnn gate: both sides")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if admitted(mid) else (lo, mid)
    return lo


def check_rnn_gate_grid(torch) -> None:
    """Default recurrent models built without values (the ``meta`` device)
    over obs dims 1 and 64, Categorical over A x n of 1x2, 3x3, 1x64 and
    1x4096 and Normal and SquashedNormal over 1 and 6 dims, 1 to 8 layers
    and H from 16 to 2048: every model rl8_tpu's residency gate
    (``supports_fused_rnn_update``) admits is taken by the card's recurrent
    act and update kernels (``card_takes_rnn_act``,
    ``card_takes_rnn_update``), so none raises at build."""
    from rl8_tpu_torch.distributions import Categorical, Normal, SquashedNormal
    from rl8_tpu_torch.models import DefaultContinuousRecurrentModel, DefaultDiscreteRecurrentModel
    from rl8_tpu_torch.ops import card_takes_rnn_act, card_takes_rnn_update, pack_rnn_params, supports_fused_rnn_update
    from rl8_tpu_torch.specs import Discrete, Unbounded

    widths = (16, 64, 256, 288, 289, 720, 724, 725, 934, 935, 1024, 1209, 1210, 1617, 1618, 2048)
    actions = [("categorical", Discrete(2, shape=(1,))), ("categorical", Discrete(3, shape=(3,))),
               ("categorical", Discrete(64, shape=(1,))), ("categorical", Discrete(4096, shape=(1,))),
               ("normal", Unbounded(1)), ("squashed", Unbounded(1)), ("normal", Unbounded(6)),
               ("squashed", Unbounded(6))]
    dists = {"categorical": Categorical, "normal": Normal, "squashed": SquashedNormal}
    admitted = refused = 0
    widest = {}
    for obs_dim in (1, 64):
        for kind, spec in actions:
            cls = DefaultDiscreteRecurrentModel if kind == "categorical" else DefaultContinuousRecurrentModel
            for layers in range(1, 9):
                for H in widths:
                    with torch.device("meta"):
                        model = cls(Unbounded(obs_dim), spec, hidden_size=H, num_layers=layers)
                    if not supports_fused_rnn_update(model, dists[kind], zero_entropy=True):
                        refused += 1
                        continue
                    admitted += 1
                    widest[layers] = max(widest.get(layers, 0), H)
                    params = pack_rnn_params(model, squashed=kind == "squashed")
                    shape = f"obs {obs_dim}, {kind} {params.head_widths}, {layers} x {H}"
                    check(card_takes_rnn_update(params), f"rnn gate grid: the update kernel refuses {shape}")
                    check(card_takes_rnn_act(params), f"rnn gate grid: the act kernel refuses {shape}")
    check(admitted > 0 and refused > 0, "rnn gate grid: both sides of the gate")
    emit({"phase": "rnn_wide_gate_grid", "admitted": admitted, "refused_by_the_gate": refused,
          "widest_admitted_by_layers": widest})


def run_rnn_wide_sweep(torch, dev, kernels: dict) -> None:
    """The recurrent kernels past their shared-memory tiles, at the dummy
    envs' shapes: one LSTM layer of RNN_WIDE_WIDTHS, Categorical, Normal
    (with an entropy bonus) and SquashedNormal, and two layers at 721 and
    at rl8_tpu's two-layer limit (rnn_gate_limit, Categorical and Normal):
    the act kernel (compare_rnn_act, 4,096 rows) and the update kernel
    (compare_rnn_ppo, 2,048 sequences of 4 steps, dual clip) against their
    plain versions, each on its asserted route (rnn_routes), two launches
    bit-identical; the same for 4,096 categories on a 64-wide LSTM (the
    act kernel's staged route and the update's staged route, for the
    heads). The policy heads are drawn at 0.3 sqrt(256 / H), so that
    their outputs have the main path's spread at every width (as drawn at
    0.3 the squashed means grow with the width into the tanh's saturation,
    where f32 itself is no reference: see F64_K). The act kernel is timed
    beside its plain version at 1209 and 1210 (the last width of the
    earlier 16-row tiles and the first of the earlier wide route) and at
    1617, the update
    kernel at 1617. Then the gate grid (check_rnn_gate_grid); a 1618-wide
    LSTM (past the gate) builds onto the module routes and trains a
    collect and a step with no act or update launch; and a 1300-wide LSTM
    with ``fused_update=False`` builds and collects through the act
    kernel's staged route (its deterministic rollout held against
    rnn_act_plain at every step) and steps by autodiff."""
    from rl8_tpu_torch import RecurrentAlgorithmConfig
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.ops import (
        PPOLossConfig,
        fused_rnn_act,
        fused_rnn_ppo_grads,
        pack_rnn_params,
        rnn_act_plain,
        rnn_ppo_grads_plain,
    )

    B, N, L = 4096, 2048, 4
    gen = torch.Generator(device=dev).manual_seed(16)
    limit2 = rnn_gate_limit(torch, 2)
    # (H, layers, kind, categories, routes): the dummy envs' two categories
    # on rnn_routes (the act's at B rows, the update's at N sequences), and
    # 4,096 categories on a 64-wide LSTM, whose heads take the act kernel's
    # staged route and the update's staged route.
    routes = lambda H: (rnn_routes(H, B)[0], rnn_routes(H, N)[1])  # noqa: E731
    cases = [(H, 1, kind, 2, routes(H)) for H in RNN_WIDE_WIDTHS for kind in ("categorical", "normal", "squashed")]
    cases += [(H, 2, kind, 2, routes(H)) for H in (721, limit2) for kind in ("categorical", "normal")]
    cases += [(64, 1, "categorical", 4096, ("staged", "staged"))]
    for H, K, kind, n, (want_act, want_ppo) in cases:
        model = make_rnn_model(torch, kind, seed=H + K, n=n, hidden_size=H, num_layers=K,
                               head_scale=0.3 * math.sqrt(256 / H), log_std_bias=-1.0)
        params = pack_rnn_params(model, squashed=kind == "squashed")
        what = f"rnn_wide_sweep {kind} {K} x {H}, heads {params.head_widths}"
        obs = 3.0 * (2.0 * torch.rand((B, 1), generator=gen, device=dev) - 1.0)
        states = rnn_states(torch, dev, B, K, H, gen)
        act_route = launched_route(torch, f"{what} act", lambda: fused_rnn_act(params, obs, states, (1, 2)),
                                   RNN_ACT_ROUTES[params.continuous], want_act)
        act = compare_rnn_act(torch, f"{what} act", params, obs, states)
        packed, unpack, _ = rnn_ppo_inputs(torch, dev, model, kind, N, L, seed=H + 31 * K)
        cfg = PPOLossConfig(clip_param=0.2, vf_clip_param=5.0, vf_coeff=1.0, dual_clip_param=3.0, n_rows=N, accum=1,
                            use_entropy=kind == "normal", squashed=kind == "squashed")
        ec = torch.tensor(0.01 if kind == "normal" else 0.0, device=dev)
        ppo_route = launched_route(torch, f"{what} update",
                                   lambda: fused_rnn_ppo_grads(params, packed, unpack, ec, cfg),
                                   RNN_PPO_ROUTES[params.continuous], want_ppo)
        result = compare_rnn_ppo(torch, f"{what} update", params, packed, unpack, ec, cfg)
        emit({"phase": "kernel_check", "kernel": "rnn_wide_sweep", "hidden_size": H, "layers": K, "kind": kind,
              "heads": list(params.head_widths), "B": B, "N": N, "L": L, "act_route": act_route, "act": act,
              "update_route": ppo_route, **result["summary"]})
        if (K, kind, n) == (1, "categorical", 2) and H in (1209, 1210, 1617):
            rec = time_kernel(torch, "rnn_act", lambda: fused_rnn_act(params, obs, states, (1, 2)),
                              lambda: rnn_act_plain(params, obs, states, (1, 2), deterministic=False),
                              rnn_act_cost(params, B), iters=10, plain_iters=5, B=B, hidden_size=H, route=act_route,
                              launches_per_iteration=0)
            kernels["rnn_act"][f"rnn_wide_sweep_{H}x{B}"] = {k: rec[k] for k in WIDE_RECORD}
        if (H, K, kind, n) == (1617, 1, "categorical", 2):
            time_kernel(torch, "rnn_ppo_update", lambda: fused_rnn_ppo_grads(params, packed, unpack, ec, cfg),
                        lambda: rnn_ppo_grads_plain(params, packed, unpack, ec, cfg), rnn_ppo_cost(params, packed, L),
                        iters=5, plain_iters=3, N=N, hidden_size=H, route=ppo_route)
    emit({"phase": "rnn_wide_gate", "two_layer_limit": limit2, "one_layer_limit": rnn_gate_limit(torch, 1)})
    check_rnn_gate_grid(torch)

    # Past the gate: the module routes, as rl8_tpu routes them.
    zero_counters()
    algo = RecurrentAlgorithmConfig(device="cuda", num_envs=1024, model_config={"hidden_size": 1618}).build(
        DiscreteDummyEnv)
    flags = (algo._fused_act, algo._fused_update, algo._fused_forward)
    check(flags == (False, False, False), f"rnn_wide_sweep 1618: routes {flags}, not rl8_tpu's module routes")
    algo.collect()
    stats = algo.step()
    launches = launch_counts()
    check(launches["rnn_act"] == 0 and launches["rnn_update"] == 0 and launches["gae"] == 1,
          f"rnn_wide_sweep 1618: launches {launches}")
    check(all(math.isfinite(v) for v in stats.values()), f"rnn_wide_sweep 1618: step stats finite: {stats}")
    emit({"phase": "rnn_wide_sweep_module_route", "hidden_size": 1618, "num_envs": 1024, "routes": flags,
          "launches": launches, "losses/total": stats["losses/total"]})
    del algo

    # The act kernel alone on its staged route, the update by autodiff: the
    # configuration that built and then failed at its first collect before
    # the act kernel had a capacity check.
    zero_counters()
    H = 1300
    algo = RecurrentAlgorithmConfig(device="cuda", num_envs=1024, fused_update=False,
                                    model_config={"hidden_size": H}).build(DiscreteDummyEnv)
    h = algo.hparams
    check((algo._fused_act, algo._fused_update) == (True, False), "rnn_wide_sweep 1300: routes")
    algo.collect(deterministic=True)
    launches = launch_counts()
    check(launches["rnn_act"] == h.horizon and launches["rnn_update"] == 0, f"rnn_wide_sweep 1300: launches {launches}")
    buf, params = algo.state.buffer, algo._pack_params()
    worst = 0.0
    for t in range(h.horizon):
        step_states = {k: v[t].contiguous() for k, v in buf[DataKeys.STATES].items()}
        actions, logp, values, new_states = rnn_act_plain(params, buf[DataKeys.OBS][t].float(), step_states, (0, 0),
                                                          deterministic=True)
        for name, got, want in (("logp", buf[DataKeys.LOGP][t], logp), ("values", buf[DataKeys.VALUES][t], values)):
            worst = max(worst, float((got - want).abs().max()))
            check(torch.allclose(got, want, rtol=ACT_RTOL, atol=ACT_ATOL), f"rnn_wide_sweep 1300: {name} at t={t}")
        check(bool((buf[DataKeys.ACTIONS][t] == actions).float().mean() > 0.99),
              f"rnn_wide_sweep 1300: actions at t={t}")
    stats = algo.step()
    launches = launch_counts()
    check(launches["rnn_update"] == 0 and all(math.isfinite(v) for v in stats.values()),
          f"rnn_wide_sweep 1300: the autodiff step: {launches}, {stats}")
    emit({"phase": "rnn_wide_sweep_act_only", "hidden_size": H, "num_envs": 1024, "launches": launches,
          "rollout_vs_plain_max_abs_err": worst, "losses/total": stats["losses/total"]})


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
    from rl8_tpu_torch.data import DataKeys
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
            worst, features = check_custom_rollout(torch, algo, ACT_RTOL, ACT_ATOL)
            buffer = algo.state.buffer
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


#: bf16 module forwards (the AMP cells' rollouts held against the module
#: recomputed outside the rollout): one bf16 rounding of an output is
#: 2^-8 relative, and cuBLAS may take another kernel (another summation
#: order) for a strided slice than for a contiguous one, so the two are
#: held a few bf16 roundings apart.
AMP_RTOL, AMP_ATOL = 2.0**-6, 2.0**-6


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter (a wrapper's two families
    summed)."""
    from rl8_tpu_torch.ops import (
        fused_act,
        fused_chains_bwd,
        fused_chains_fwd,
        fused_gae,
        fused_ppo_grads,
        fused_rnn_act,
        fused_rnn_ppo_grads,
    )

    both = lambda fn: fn.launches + fn.continuous_launches  # noqa: E731
    return {"act": both(fused_act), "gae": fused_gae.launches, "update": both(fused_ppo_grads),
            "rnn_act": both(fused_rnn_act), "rnn_update": both(fused_rnn_ppo_grads),
            "chains_fwd": fused_chains_fwd.launches, "chains_bwd": fused_chains_bwd.launches}


def time_cell(torch, algo, phase: str, per_iteration: dict, updates_per_step: int, iters: int = 6, **extra) -> dict:
    """One warm-up and ``iters - 1`` (five) timed collect() + step()
    iterations of a cell (``time_iterations``: counters set to 0 just
    before, read just after):
    every kernel must have launched exactly ``per_iteration`` times an
    iteration (a kernel it leaves out: none), the stats and parameters
    stay finite, the buffer is spent and the optimizer counted
    ``updates_per_step`` updates a step (for the default Adam). Then one
    profiled iteration for the device's idle share. Emits and returns
    the record."""
    h, model = algo.hparams, algo.policy.model
    collect_ms, step_ms, steps = time_iterations(torch, algo, iters)
    launches = launch_counts()
    want = {k: iters * per_iteration.get(k, 0) for k in launches}
    check(launches == want, f"{phase}: launches {launches} != {want}")
    for stats in steps:
        check(all(math.isfinite(v) for v in stats.values()), f"{phase}: step stats finite: {stats}")
    for name, param in model.named_parameters():
        check(bool(torch.isfinite(param).all()), f"{phase}: parameter {name} finite")
    check(not algo.state.buffered, f"{phase}: the buffer is spent")
    if hasattr(algo.state.opt_state, "count"):
        check(int(algo.state.opt_state.count) == iters * updates_per_step, f"{phase}: Adam counted every update")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med_collect = sorted(collect_ms)[len(collect_ms) // 2]
    med_step = sorted(step_ms)[len(step_ms) // 2]
    prof = profile_window(torch, f"{phase} iteration", lambda: (algo.collect(), algo.step()))
    record = {
        "phase": phase, "num_envs": h.num_envs, "horizon": h.horizon,
        "fused_act": algo._fused_act, "fused_update": algo._fused_update, "fused_forward": algo._fused_forward,
        "dtype": str(getattr(model, "dtype", None)), "parameters": sum(p.numel() for p in model.parameters()),
        "collect_ms": collect_ms, "step_ms": step_ms, "collect_ms_median": med_collect, "step_ms_median": med_step,
        "transitions_per_s_with_update": h.num_envs * h.horizon / ((med_collect + med_step) / 1e3),
        "launches_per_iteration": {k: v // iters for k, v in launches.items() if v},
        "device_idle_share": prof["device_idle_share"], "peak_memory_gb": peak_gb, "last_step": steps[-1],
        **extra,
    }
    emit(record)
    return record


def check_custom_rollout(torch, algo, rtol: float, atol: float) -> tuple[float, dict]:
    """Collect once more and hold a custom feedforward model's rollout
    (log-probs of the stored actions, values) against its module forward
    on the training views of the buffer (the rollout's view windows must
    equal them). Returns the largest difference and the module's
    features."""
    from rl8_tpu_torch.algorithms._feedforward import _t2b
    from rl8_tpu_torch.data import DataKeys

    model = algo.policy.model
    algo.collect()
    buffer = algo.state.buffer
    with torch.no_grad():
        features, values = model(algo._training_views(buffer))
        logp = algo.policy.distribution_cls(features, model).logp(_t2b(buffer[DataKeys.ACTIONS]))
    worst = 0.0
    for what, got, want in (("logp", _t2b(buffer[DataKeys.LOGP]), logp),
                            ("values", _t2b(buffer[DataKeys.VALUES][:-1]), values)):
        worst = max(worst, float((got - want).abs().max()))
        check(torch.allclose(got, want, rtol=rtol, atol=atol), f"{type(model).__name__} rollout {what} vs module")
    return worst, features


def check_feedforward_rollout(torch, algo, rtol: float, atol: float) -> float:
    """Collect once more and hold a default model's rollout against its
    module forward on each step's stored observations (log-probs of the
    stored actions, values). Returns the largest difference."""
    from rl8_tpu_torch.data import DataKeys

    model = algo.policy.model
    algo.collect()
    buffer = algo.state.buffer
    check(buffer[DataKeys.LOGP].dtype == buffer[DataKeys.VALUES].dtype == torch.float32, "buffer entries are f32")
    worst = 0.0
    with torch.no_grad():
        for t in range(algo.hparams.horizon):
            features, values = model({DataKeys.OBS: buffer[DataKeys.OBS][t]})
            logp = algo.policy.distribution_cls(features, model).logp(buffer[DataKeys.ACTIONS][t])
            for what, got, want in (("values", buffer[DataKeys.VALUES][t], values),
                                    ("logp", buffer[DataKeys.LOGP][t], logp)):
                worst = max(worst, float((got - want).abs().max()))
                check(torch.allclose(got, want, rtol=rtol, atol=atol), f"rollout {what} at t={t}")
    return worst


def run_amp_paths(torch, dev) -> None:
    """``enable_amp=True`` on the discrete and the recurrent default cells
    at full width (8192 envs, horizon 32; twin 256-wide torsos, one
    256-wide LSTM layer): the default models compute in bf16, which takes
    them off the act, update and recurrent kernels (as in ``rl8_tpu``),
    so an iteration launches GAE once and nothing else of ours; the
    rollout is held against the bf16 module."""
    from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv

    for name, config in (("discrete", AlgorithmConfig), ("recurrent", RecurrentAlgorithmConfig)):
        algo = config(device="cuda", enable_amp=True).build(DiscreteDummyEnv)
        h = algo.hparams
        check(algo.policy.model.dtype is torch.bfloat16 and h.enable_amp, f"amp {name}: bf16 model")
        check((algo._fused_act, algo._fused_update) == (False, False), f"amp {name}: module routes")
        record = time_cell(torch, algo, "amp_paths", {"gae": 1}, h.num_sgd_iters * h.num_minibatches, cell=name)
        rollout = check_recurrent_rollout if name == "recurrent" else check_feedforward_rollout
        worst = rollout(torch, algo, AMP_RTOL, AMP_ATOL)
        emit({"phase": "amp_rollout_vs_module", "cell": name, "max_abs_err": worst,
              "transitions_per_s_with_update": record["transitions_per_s_with_update"]})


def run_recurrent_module_route(torch, dev) -> None:
    """The recurrent cell at full width with ``fused_act=False,
    fused_update=False``: the module rollout and the autodiff update (f32),
    GAE once an iteration and no other kernel of ours; the rollout held
    against the module at the act tolerances."""
    from rl8_tpu_torch import RecurrentAlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv

    algo = RecurrentAlgorithmConfig(device="cuda", fused_act=False, fused_update=False).build(DiscreteDummyEnv)
    h = algo.hparams
    time_cell(torch, algo, "recurrent_module_route", {"gae": 1}, h.num_sgd_iters * h.num_minibatches)
    worst = check_recurrent_rollout(torch, algo, ACT_RTOL, ACT_ATOL)
    emit({"phase": "recurrent_module_route_rollout_vs_module", "max_abs_err": worst})


def run_custom_amp(torch, dev) -> None:
    """BASELINE config #5 as the JAX bench runs it (``bench.py:295-301``,
    ``benchmarks/throughput.py:47-57``): ``MischievousMule`` with
    ``dtype=bfloat16``, ``enable_amp=True``, ``accumulate_grads=True``,
    4096 envs, horizon 32, minibatches of 32,768 rows, with
    ``fused_forward`` True (chain forward 49 and backward 16 launches an
    iteration, asserted: the bf16-assembled input upcast to f32 for the
    f32 chain kernels) and False (the bf16 module on cuBLAS, no chain
    launch). The fused cell's rollout is held against the bf16 module on
    its training views, a few bf16 roundings apart."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule

    for fused in (True, False):
        algo = AlgorithmConfig(model_cls=MischievousMule, model_config={"dtype": torch.bfloat16}, enable_amp=True,
                               accumulate_grads=True, num_envs=4096, horizon=32, sgd_minibatch_size=32768,
                               fused_forward=fused, device="cuda").build(AlgoTrading)
        h, model = algo.hparams, algo.policy.model
        check(model.dtype is torch.bfloat16 and h.accumulate_grads and h.enable_amp, "custom_amp: BASELINE #5")
        check(algo._fused_forward == fused and model.hiddens == (128, 128) and h.num_minibatches == 4,
              f"custom_amp: fused_forward {algo._fused_forward}, shape")
        per_step = h.num_sgd_iters * h.num_minibatches
        want = {"gae": 1, **({"chains_fwd": h.horizon + 1 + per_step, "chains_bwd": per_step} if fused else {})}
        check(not fused or (want["chains_fwd"], want["chains_bwd"]) == (49, 16), f"custom_amp: chain launches {want}")
        # accumulate_grads: one optimizer update per epoch.
        time_cell(torch, algo, "custom_amp", want, h.num_sgd_iters, model="MischievousMule", accumulate_grads=True)
        if fused:
            worst, _ = check_custom_rollout(torch, algo, AMP_RTOL, AMP_ATOL)
            emit({"phase": "custom_amp_rollout_vs_bf16_module", "max_abs_err": worst})


#: The surface phase's dropout draw: its rate (the surface model's) and
#: the allowed deviation of the zero share from it, in standard
#: deviations of a share of independent Bernoulli draws.
SURFACE_DROPOUT, SURFACE_SIGMAS = 0.1, 5.0


def check_dropout_draws(torch, dev, rows: int = 4096) -> dict:
    """An ``MLP(7, (128, 128), layer_norm=True, dropout=0.1)`` on the card,
    its last layer the identity so that its output is the dropped-out
    hidden activation, called with ``deterministic=False`` and a seeded
    CUDA ``torch.Generator``: among the units the deterministic call
    leaves nonzero (relu zeroes the rest), the share of zeros is within
    SURFACE_SIGMAS of the rate, the survivors are the deterministic
    output times 1 / (1 - rate), the same seed repeats the mask and another
    seed draws another. The default call is the deterministic one."""
    from rl8_tpu_torch.nn import MLP

    p = SURFACE_DROPOUT
    mlp = MLP(7, (128, 128), layer_norm=True, dropout=p).to(dev)
    with torch.no_grad():
        mlp.layers[-1].weight.copy_(torch.eye(128, device=dev))
        mlp.layers[-1].bias.zero_()
    x = torch.randn(rows, 7, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    draw = lambda seed: mlp(x, deterministic=False, generator=torch.Generator(device=dev).manual_seed(seed))  # noqa: E731
    with torch.no_grad():
        det, a, b, c = mlp(x, deterministic=True), draw(7), draw(7), draw(8)
        check(torch.equal(mlp(x), det), "surface dropout: the default call is deterministic")
    live = det != 0
    n = int(live.sum())
    share = float(((a == 0) & live).sum()) / n
    sigma = math.sqrt(p * (1.0 - p) / n)
    check(abs(share - p) <= SURFACE_SIGMAS * sigma, f"surface dropout: zero share {share} vs {p} (sigma {sigma})")
    kept = a != 0
    check(bool(torch.equal(kept, kept & live)), "surface dropout: a unit relu zeroed came back")
    check(torch.allclose(a[kept], det[kept] / (1.0 - p), rtol=1e-6, atol=0.0), "surface dropout: survivors scaled")
    check(torch.equal(a, b) and not torch.equal(a, c), "surface dropout: a seed repeats its mask, another does not")
    return {"rate": p, "zero_share": share, "sigma": sigma, "units": n, "sigmas_allowed": SURFACE_SIGMAS}


def check_serving_aliases(torch, dev, policy, obs: dict) -> dict:
    """``MLflowPolicyModel`` serving ``policy`` (the surface model on the
    card) on the composite observations ``obs`` (numpy ``[B, T, ...]``),
    and ``MLflowRecurrentPolicyModel`` serving a default recurrent policy
    on the card, each bit-identical to ``PolicyModel``'s and
    ``RecurrentPolicyModel``'s predictions (outputs and new states)."""
    import numpy as np

    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.policies import RecurrentPolicy
    from rl8_tpu_torch.policies.serving import (
        MLflowPolicyModel,
        MLflowRecurrentPolicyModel,
        PolicyModel,
        RecurrentPolicyModel,
    )
    from rl8_tpu_torch.specs import Discrete, Unbounded

    check(MLflowPolicyModel is PolicyModel and MLflowRecurrentPolicyModel is RecurrentPolicyModel,
          "surface serving: the MLflow names are the serving classes")
    got, want = MLflowPolicyModel(policy)._predict_arrays(obs), PolicyModel(policy)._predict_arrays(obs)
    rpolicy = RecurrentPolicy(Unbounded(1), Discrete(3, shape=(1,)))
    rpolicy.init_params(torch.Generator().manual_seed(12))
    rpolicy.model.to(dev)
    robs = {DataKeys.OBS: np.random.default_rng(12).normal(size=(100, 4, 1)).astype(np.float32)}
    (rgot, rgot_states), (rwant, rwant_states) = (cls(rpolicy)._predict_arrays(robs)
                                                  for cls in (MLflowRecurrentPolicyModel, RecurrentPolicyModel))
    check(all(p.is_cuda for m in (policy.model, rpolicy.model) for p in m.parameters()), "surface serving: on the card")
    for what, g, w in (("feedforward", got, want), ("recurrent", rgot, rwant),
                       ("recurrent states", rgot_states, rwant_states)):
        check(sorted(g) == sorted(w) and all(np.array_equal(g[k], w[k]) for k in w),
              f"surface serving: the MLflow alias's {what} differ")
    for arrays in (got, rgot):
        check(all(np.isfinite(v).all() for v in arrays.values()), "surface serving: finite")
    return {"feedforward_rows": len(got[DataKeys.ACTIONS]), "recurrent_rows": len(rgot[DataKeys.ACTIONS]),
            "bit_identical": True}


def run_surface(torch, dev, card: str) -> None:
    """The ``surface`` phase: the names of ``rl8_tpu``'s surface that the
    port gained, on the card. The surface model (surface_model_cls: bf16
    ``OneHotEmbed``, ``MLP(dropout=0.1)`` torsos called deterministically,
    a ``FusedApplySpec``) at the custom cell's shapes (``AlgoTrading``, 4096
    envs, horizon 32, minibatches of 32,768 rows, 4 epochs,
    ``fused_forward=True``): one warm-up and one timed collect() + step(),
    the counters set to 0 just before; an iteration launches the chain
    forward 49 times, the backward 16 and GAE once, and nothing else of
    ours. The chain kernels' routes on the rollout's rows, the rollout
    against the bf16 module (AMP_RTOL, AMP_ATOL), a seeded dropout draw on
    the card (check_dropout_draws), and the MLflow serving aliases
    (check_serving_aliases). Emits one line with the timed iteration's
    transitions/s beside the card's name and power limit."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.examples.algotrading import AlgoTrading
    from rl8_tpu_torch.ops import fused_custom_apply

    t0 = time.perf_counter()
    algo = AlgorithmConfig(model_cls=surface_model_cls(torch), fused_forward=True, num_envs=4096, horizon=32,
                           sgd_minibatch_size=32768, device=dev).build(AlgoTrading)
    h, model = algo.hparams, algo.policy.model
    check(algo._fused_forward and not (algo._fused_act or algo._fused_update), "surface: the chain kernels' route")
    check(model.hiddens == (128, 128) and model.dtype is torch.bfloat16 and model.feature_model.dropout == 0.1
          and h.num_sgd_iters == 4 and h.num_minibatches == 4, "surface: the model and the cell's shape")
    per_step = h.num_sgd_iters * h.num_minibatches
    per_iteration = {"chains_fwd": h.horizon + 1 + per_step, "chains_bwd": per_step, "gae": 1}
    check(per_iteration == {"chains_fwd": 49, "chains_bwd": 16, "gae": 1}, f"surface: launches {per_iteration}")
    iters = 2
    collect_ms, step_ms, steps = time_iterations(torch, algo, iters)
    launches = {k: v for k, v in launch_counts().items() if v}
    check(launches == {k: iters * v for k, v in per_iteration.items()},
          f"surface: launches {launches} in {iters} iterations, not {per_iteration} each")
    for stats in steps:
        check(all(math.isfinite(v) for v in stats.values()), f"surface: step stats finite: {stats}")
    for name, param in model.named_parameters():
        check(bool(torch.isfinite(param).all()), f"surface: parameter {name} finite")
    check(not algo.state.buffered and int(algo.state.opt_state.count) == iters * per_step,
          "surface: the buffer is spent and Adam counted every update")
    worst, _ = check_custom_rollout(torch, algo, AMP_RTOL, AMP_ATOL)
    views = algo._training_views(algo.state.buffer)
    with torch.no_grad():
        routes = {"chains_fwd": launched_route(
            torch, "surface chain forward", lambda: fused_custom_apply(model, views),
            {"chains_fwd_tiles_kernel": "tiled", "chains_layer_kernel": "staged"}, "tiled", calls=1)}

    def forward_backward() -> None:
        (feats, values) = fused_custom_apply(model, views)
        (feats["logits"].clamp_min(-1e4).sum() + values.sum()).backward()

    routes["chains_bwd"] = launched_route(torch, "surface chain backward", forward_backward,
                                          {"chains_bwd_tiles_kernel": "tiled", "chains_dh_kernel": "staged"},
                                          "tiled", calls=1)
    model.zero_grad(set_to_none=True)
    dropout = check_dropout_draws(torch, dev)
    obs = {DataKeys.OBS: _time_major_numpy(algo.state.buffer[DataKeys.OBS], 8, 100)}
    serving = check_serving_aliases(torch, dev, algo.policy, obs)
    emit({"phase": "surface", "model": "SurfaceModel", "env": "AlgoTrading", "num_envs": h.num_envs,
          "horizon": h.horizon, "sgd_minibatch_size": h.sgd_minibatch_size, "num_sgd_iters": h.num_sgd_iters,
          "dtype": str(model.dtype), "launches_per_iteration": {k: v // iters for k, v in launches.items()},
          "routes": routes, "rollout_vs_module_max_abs_err": worst, "rtol": AMP_RTOL, "atol": AMP_ATOL,
          "dropout": dropout, "serving": serving, "collect_ms": collect_ms, "step_ms": step_ms,
          "transitions_per_s_with_update": h.num_envs * h.horizon / ((collect_ms[0] + step_ms[0]) / 1e3),
          "card": card, "seconds": time.perf_counter() - t0})


def _time_major_numpy(tree, T: int, B: int):
    """The first ``T`` steps of the first ``B`` envs of a time-major buffer
    tree, batch-major ``[B, T, ...]``, as numpy."""
    if isinstance(tree, dict):
        return {k: _time_major_numpy(v, T, B) for k, v in tree.items()}
    return tree[:T, :B].transpose(0, 1).cpu().numpy()


def custom_cell(torch, name: str, fused: bool, amp: bool):
    """``AttentiveAlpaca`` (``custom_alpaca``) or ``LazyLemur``
    (``custom_lemur``) on ``AlgoTrading`` as the JAX bench's diagnostic
    lines build them (``benchmarks/throughput.py:31-75``, ``bench.py:321-363``):
    4096 envs, horizon 32, minibatches of a quarter of the buffer
    (LazyLemur: seq_len 4, seqs_per_state_reset 2, minibatches in
    sequences), at the models' defaults; with ``amp`` the bench's regime
    (``dtype=bfloat16``, ``enable_amp``, ``accumulate_grads``)."""
    from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, AttentiveAlpaca, LazyLemur

    common = dict(model_config={"dtype": torch.bfloat16} if amp else {}, accumulate_grads=amp, enable_amp=amp,
                  num_envs=4096, horizon=32, sgd_minibatch_size=4096 * 32 // 4, fused_forward=fused, device="cuda")
    if name == "custom_alpaca":
        return AlgorithmConfig(model_cls=AttentiveAlpaca, **common).build(AlgoTrading)
    common["sgd_minibatch_size"] //= 4
    return RecurrentAlgorithmConfig(model_cls=LazyLemur, seq_len=4, seqs_per_state_reset=2, **common).build(AlgoTrading)


#: Iterations of each custom-model run: one warm-up, three timed.
CUSTOM_ITERS = 4


def run_custom_models(torch, dev) -> None:
    """The ``custom_alpaca`` and ``custom_lemur`` phases (custom_cell):
    each runs f32 with ``fused_forward=True`` (the chain kernels: chain
    forward 33 launches a collect (32 steps and the bootstrap value) and
    16 a step, backward 16 a step, GAE 1, and no act or update kernel),
    then the bench's bf16 regime with ``fused_forward`` True (the same
    launches) and False (GAE only), each one warm-up and three timed
    iterations and a profiled one (time_cell), with the launches of one
    more collect and step printed apart. Each rollout is held against the
    module forward recomputed on the same batch: 1e-4 in f32, the bf16
    tolerance (AMP_RTOL) in bf16."""
    for name in ("custom_alpaca", "custom_lemur"):
        summary = {}
        for fused, amp in ((True, False), (True, True), (False, True)):
            algo = custom_cell(torch, name, fused, amp)
            h, model = algo.hparams, algo.policy.model
            recurrent = name == "custom_lemur"
            check(algo._fused_forward == fused and not (algo._fused_act or algo._fused_update),
                  f"{name}: routes {algo._fused_forward, algo._fused_act, algo._fused_update}")
            check(model.hiddens == (64, 64) and model.dtype is (torch.bfloat16 if amp else None)
                  and (model.hidden_size == 64 and h.seq_len == 4 if recurrent else model.seq_len == 4),
                  f"{name}: the model's defaults")
            per_step = h.num_sgd_iters * h.num_minibatches
            check(per_step == 16, f"{name}: {per_step} minibatches a step")
            chains = {"chains_fwd": h.horizon + 1 + per_step, "chains_bwd": per_step} if fused else {}
            label = f"{'bf16' if amp else 'f32'}_{'fused' if fused else 'module'}"
            record = time_cell(torch, algo, name, {"gae": 1, **chains}, h.num_sgd_iters if amp else per_step,
                               iters=CUSTOM_ITERS, run=label, model=type(model).__name__)
            # One more collect (its rollout against the module) and step,
            # their launches apart.
            tol = (AMP_RTOL, AMP_ATOL) if amp else (ACT_RTOL, ACT_ATOL)
            torch.cuda.synchronize()
            zero_counters()
            if recurrent:
                worst = check_recurrent_rollout(torch, algo, *tol)
            else:
                worst, _ = check_custom_rollout(torch, algo, *tol)
            torch.cuda.synchronize()
            per_collect = {k: v for k, v in launch_counts().items() if v}
            zero_counters()
            algo.step()
            torch.cuda.synchronize()
            per_step_launches = {k: v for k, v in launch_counts().items() if v}
            want_collect = {"chains_fwd": h.horizon + 1} if fused else {}
            want_step = {"gae": 1, **({"chains_fwd": per_step, "chains_bwd": per_step} if fused else {})}
            check(per_collect == want_collect and per_step_launches == want_step,
                  f"{name} {label}: launches {per_collect} a collect, {per_step_launches} a step")
            summary[label] = {k: record[k] for k in ("transitions_per_s_with_update", "collect_ms_median",
                                                     "step_ms_median", "device_idle_share")}
            emit({"phase": f"{name}_launches", "run": label, "per_collect": per_collect, "per_step": per_step_launches,
                  "rollout_vs_module_max_abs_err": worst, "rtol": tol[0], "atol": tol[1]})
        emit({"phase": f"{name}_summary", "runs": summary})


#: ``rl8_tpu_torch/examples/algotrading/config.yaml`` as JSON (the card's
#: machine may lack PyYAML; the tests hold this copy to the file).
ALGOTRADING_CONFIG = {
    "env_cls": "rl8_tpu_torch.examples.algotrading.env.AlgoTrading",
    "algorithm_config": {"model_cls": "rl8_tpu_torch.examples.algotrading.models.AttentiveAlpaca", "horizon": 64,
                         "num_envs": 512, "accumulate_grads": True, "enable_amp": True, "sgd_minibatch_size": 8192},
}


def run_algotrading_cli(torch, dev, tmp: Path) -> None:
    """``python -m rl8_tpu_torch train -f rl8_tpu_torch/examples/algotrading/config.yaml
    --max-steps 2`` (the committed config, AttentiveAlpaca at 512 envs,
    horizon 64, through the module forward) in this process: two steps
    recorded with finite stats, GAE once a step, no other kernel."""
    steps = 2
    rc, trainer, records, launches = train_cli(torch, tmp, "algotrading", ALGOTRADING_CONFIG, "--max-steps",
                                               str(steps))
    check(rc == 0, f"algotrading: the CLI exited {rc}")
    algo = trainer.algorithm
    h = algo.hparams
    check(type(algo.policy.model).__name__ == "AttentiveAlpaca" and (h.num_envs, h.horizon) == (512, 64),
          "algotrading: the config's model and widths")
    train, _ = check_train_records(records, h.num_envs, h.horizon, steps, None, "algotrading")
    check(launches == {"act": 0, "continuous_act": 0, "gae": steps, "ppo": 0, "continuous_ppo": 0},
          f"algotrading: launches {launches}")
    emit({"phase": "algotrading_cli", "config": ALGOTRADING_CONFIG, "steps": len(train), "launches": launches,
          "returns_mean": [r["returns/mean"] for r in train], "last_record": train[-1]})


def run_optimizers(torch, dev) -> None:
    """The discrete cell at full width with the default Adam, with
    ``optimizer_cls=torch.optim.AdamW`` over the flat vector, and with
    AdamW per leaf (``flatten_optimizer=False``), timed in turns: the
    kernels launch as with Adam (act 32, GAE 1, update 4 an iteration),
    the optimizer's state stays on the card (``capturable=True``: its
    step counts too), and the step's ms sit beside Adam's."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv

    records = {}
    for name, kw in (("adam", {}), ("adamw", {"optimizer_cls": torch.optim.AdamW}),
                     ("adamw_per_leaf", {"optimizer_cls": torch.optim.AdamW, "flatten_optimizer": False})):
        algo = AlgorithmConfig(device="cuda", **kw).build(DiscreteDummyEnv)
        h = algo.hparams
        per_step = h.num_sgd_iters * h.num_minibatches
        records[name] = time_cell(torch, algo, "optimizers", {"act": h.horizon, "gae": 1, "update": per_step},
                                  per_step, optimizer=name)
        if name != "adam":
            opt = algo._torch_optimizer
            check(opt.optimizer.defaults.get("capturable") is True, f"{name}: capturable on the card")
            state = [v for d in algo.state.opt_state.per_param.values() for v in d.values()]
            check(all(v.device.type == "cuda" for v in state), f"{name}: optimizer state on the card")
            check({int(d["step"]) for d in algo.state.opt_state.per_param.values()} == {7 * per_step},
                  f"{name}: step count")
            check(len(opt.params) == (1 if name == "adamw" else len(list(algo.policy.model.parameters()))),
                  f"{name}: optimizer leaves")
    emit({"phase": "optimizers_summary",
          "step_ms_median": {k: r["step_ms_median"] for k, r in records.items()},
          "step_ms_over_adam": {k: r["step_ms_median"] - records["adam"]["step_ms_median"] for k, r in records.items()},
          "transitions_per_s_with_update": {k: r["transitions_per_s_with_update"] for k, r in records.items()}})


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


def profile_window(torch, window: str, fn) -> dict:
    """Device time by kernel over one call of ``fn``, from
    ``torch.profiler``; the busy share is the summed device time of the
    device's own events (kernels and copies, not the host operators that
    launched them, whose device time repeats their kernels') over the
    host wall time of the profiled window (the profiler's own host
    overhead lengthens that window). Emits and returns the record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [
        (e.key, e.device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    record = {
        "phase": "profile", "window": window, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
        "top": [{"name": name[:80], "ms": ms, "count": count} for name, ms, count in rows[:10]],
    }
    emit(record)
    return record


def check_learning(torch, dev, amp: bool = False) -> None:
    """The verify recipe's learning drive on the card: 256 envs, horizon
    16, seed 1, 30 collect+step iterations with bounds 10; the greedy
    policy must move every position toward the origin. With ``amp`` the
    same drive with ``enable_amp=True`` (the bf16 model on the module
    routes)."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.env import DiscreteDummyEnv

    t = time.perf_counter()
    algo = AlgorithmConfig(num_envs=256, horizon=16, seed=1, enable_amp=amp, device="cuda").build(DiscreteDummyEnv)
    check(amp == (algo.policy.model.dtype is torch.bfloat16), "learning: the model's dtype")
    for _ in range(30):
        collect_stats = algo.collect(env_config={"bounds": 10.0})
        algo.step()
    obs = torch.tensor([[[5.0]], [[-5.0]], [[2.0]], [[-2.0]]], device=dev)
    out = algo.policy.sample({DataKeys.OBS: obs}, kind="last", deterministic=True)
    actions = out[DataKeys.ACTIONS].ravel().tolist()
    check(actions == [0, 1, 0, 1], f"the policy did not learn: greedy actions {actions}")
    emit({"phase": "learning_amp" if amp else "learning", "iterations": 30, "greedy_actions": actions,
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


def check_small_against_cpu(torch, dev, continuous: bool = False, recurrent: bool = False, label: str = "",
                            **extra) -> None:
    """The same small configuration on the card and on the CPU (the
    kernels' plain versions), from one seed and the same start positions:
    two stochastic collects (the second carrying over), the advantage
    stage and one step (whole-buffer minibatch, so no shuffle) must
    agree. The discrete run's observations and actions are equal; the
    continuous run (Normal) draws the same noise on both, but its f32
    actions move the positions, so both are held to the act tolerances.
    The recurrent runs (one 32-wide LSTM layer, seq_len 4, states reset
    every 2 sequences) also compare the stored states. ``extra`` goes to
    the config (a ``torch.optim`` optimizer, whose state after the step is
    compared too, by the parameters' norm-relative error), ``label`` to
    the phase's name."""
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

    runs, steps, opt_states = {}, {}, {}
    for device in ("cuda", "cpu"):
        common = dict(num_envs=64, horizon=8, horizons_per_env_reset=2, seed=7, device=device,
                      distribution_cls=Normal if continuous else None, **extra)
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
        opt_states[device] = {
            f"{i}.{k}": v.cpu() for i, d in getattr(algo.state.opt_state, "per_param", {}).items() for k, v in d.items()
        }
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
    check(opt_states["cuda"].keys() == opt_states["cpu"].keys(), "small run optimizer state keys")
    opt_err = 0.0
    for key, want in opt_states["cpu"].items():
        got = opt_states["cuda"][key]
        opt_err = max(opt_err, float((got - want).norm() / max(float(want.norm()), 1e-12)))
    check(opt_err <= 1e-3, f"small run optimizer state differs by {opt_err:.3g} of its norm")
    phase = ("small_" + ("recurrent_" if recurrent else "") + ("continuous_" if continuous else "")
             + (f"{label}_" if label else "") + "vs_cpu")
    emit({"phase": phase, "num_envs": 64, "optimizer_state_norm_rel_err": opt_err if opt_states["cpu"] else None,
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


def state_tensors(torch, algo) -> dict:
    """Every piece of an algorithm's dynamic state by name, as copies:
    the model's parameters, the state's tensors and host values (Adam,
    buffer, env state, counters), every generator's state and the
    schedulers' coefficients."""
    import dataclasses

    out: dict = {}

    def walk(obj, path):
        if isinstance(obj, torch.Tensor):
            out[path] = obj.detach().clone()
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name), f"{path}.{f.name}")
        elif isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{path}[{k}]")
        else:
            out[path] = obj

    walk(algo.state, "state")
    for k, v in algo.policy.model.state_dict().items():
        out[f"model.{k}"] = v.detach().clone()
    for k, v in vars(algo).items():
        if isinstance(v, torch.Generator):
            out[f"generator.{k}"] = v.get_state()
    out["coefficients"] = (algo.lr_scheduler.coeff, algo.entropy_scheduler.coeff)
    return out


def differing(torch, a: dict, b: dict) -> list:
    """Names whose values are not bit-identical (or not in both)."""
    bad = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.device != y.device or not torch.equal(x, y):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return bad


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def run_checkpoint_resume(torch, dev, tmp: Path) -> None:
    """A checkpointed run resumes bit for bit on the card, at full width:
    the discrete cell (8192 envs, horizon 32, twin 256-wide torsos) and
    the recurrent cell (one 256-wide LSTM), and the discrete cell with
    ``torch.optim.AdamW`` (its state on the card). Train 2 steps, save
    (blocking), train 2 more; build a fresh algorithm, restore, train 2
    steps: every parameter, Adam, buffer and env tensor, host counter,
    generator state and coefficient must equal the first run's, and the
    resumed steps must have launched the path's kernels (act 32, GAE 1,
    update 4 per step). Then an async save: latest.json must not move
    until wait_for_checkpoint(), and its generation restores the state at
    the call, bit for bit. The recurrent policy is exported for the
    serving phase."""
    from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
    from rl8_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint, wait_for_checkpoint
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.ops import fused_act, fused_gae, fused_ppo_grads, fused_rnn_act, fused_rnn_ppo_grads

    cells = {
        "discrete": (lambda: AlgorithmConfig(device="cuda").build(DiscreteDummyEnv), fused_act, fused_ppo_grads),
        "recurrent": (lambda: RecurrentAlgorithmConfig(device="cuda").build(DiscreteDummyEnv), fused_rnn_act,
                      fused_rnn_ppo_grads),
        "discrete_adamw": (lambda: AlgorithmConfig(device="cuda", optimizer_cls=torch.optim.AdamW)
                           .build(DiscreteDummyEnv), fused_act, fused_ppo_grads),
    }
    for name, (make, act_fn, ppo_fn) in cells.items():
        ckpt = tmp / f"ckpt-{name}"

        def train(algo, n):
            for _ in range(n):
                algo.collect()
                algo.step()
            torch.cuda.synchronize()

        algo = make()
        h = algo.hparams
        train(algo, 2)
        t = time.perf_counter()
        save_checkpoint(ckpt, algo, trainer_state={"algorithm/steps": 2})
        save_ms = (time.perf_counter() - t) * 1e3
        train(algo, 2)
        want = state_tensors(torch, algo)

        resumed = make()
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer_state = restore_checkpoint(ckpt, resumed)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t) * 1e3
        check(trainer_state == {"algorithm/steps": 2}, f"{name}: restored trainer state {trainer_state}")
        zero_counters()
        train(resumed, 2)
        launches = {"act": act_fn.launches, "gae": fused_gae.launches, "update": ppo_fn.launches}
        per_step = h.num_sgd_iters * h.num_minibatches
        check(launches == {"act": 2 * h.horizon, "gae": 2, "update": 2 * per_step},
              f"{name}: resumed launches {launches}")
        got = state_tensors(torch, resumed)
        bad = differing(torch, want, got)
        check(not bad, f"{name}: the resumed run differs from the uninterrupted one in {bad[:10]}")
        off_card = cpu_tensors(torch, resumed.state)
        check(not off_card, f"{name}: restored tensors off the card: {off_card}")

        # Async: the call returns once the state is in host memory; the
        # generation is published only by wait_for_checkpoint().
        latest = ckpt / "latest.json"
        before = latest.read_text()
        t = time.perf_counter()
        save_checkpoint(ckpt, resumed, trainer_state={"algorithm/steps": 4}, block=False)
        async_ms = (time.perf_counter() - t) * 1e3
        at_save = state_tensors(torch, resumed)
        check(latest.read_text() == before, f"{name}: latest.json moved before the async write was waited for")
        train(resumed, 1)
        check(latest.read_text() == before, f"{name}: latest.json moved while training overlapped the write")
        t = time.perf_counter()
        wait_for_checkpoint()
        wait_ms = (time.perf_counter() - t) * 1e3
        check(json.loads(latest.read_text())["checkpoint"] == "ckpt-00000002", f"{name}: async generation not published")
        # The async generation holds the state at the call, not the one the
        # overlapping step left.
        del algo
        restored = make()
        restore_checkpoint(ckpt, restored)
        bad = differing(torch, at_save, state_tensors(torch, restored))
        check(not bad, f"{name}: the async checkpoint differs from the state at its save in {bad[:10]}")
        del restored
        gen_bytes = dir_bytes(ckpt / "ckpt-00000001")
        if name == "recurrent":
            resumed.policy.save(tmp / "recurrent_policy.pkl")
        emit({"phase": "checkpoint_resume", "cell": name, "num_envs": h.num_envs, "horizon": h.horizon,
              "parameters": sum(p.numel() for p in resumed.policy.model.parameters()),
              "compared": len(want), "bit_identical": True, "resumed_launches": launches,
              "checkpoint_bytes": gen_bytes, "save_ms": save_ms, "restore_ms": restore_ms,
              "async_save_ms": async_ms, "async_wait_ms": wait_ms})


def run_preemption(torch, dev, tmp: Path) -> None:
    """``Trainer.run(checkpoint_dir=..., steps_per_checkpoint=2)`` on the
    discrete cell while a timer thread sends SIGTERM to this process: the
    run saves a checkpoint at the next step boundary and returns, with the
    SIGTERM disposition restored; a second run resumes from its counters
    and stops two steps later."""
    import os
    import signal
    import threading

    from rl8_tpu_torch import AlgorithmConfig, Trainer
    from rl8_tpu_torch.checkpoint import checkpoint_exists
    from rl8_tpu_torch.conditions import HitsUpperBound
    from rl8_tpu_torch.env import DiscreteDummyEnv

    ckpt = tmp / "ckpt-preemption"
    prev = signal.getsignal(signal.SIGTERM)
    sent: list = []

    class SigtermSoon:
        """Starts a timer thread at step 1 that sends SIGTERM 0.3 s later."""

        def __call__(self, stats) -> bool:
            if stats["algorithm/steps"] == 1 and not sent:
                timer = threading.Timer(0.3, lambda: (sent.append(time.perf_counter()),
                                                      os.kill(os.getpid(), signal.SIGTERM)))
                timer.start()
            return False

    make = lambda: Trainer(AlgorithmConfig(device="cuda").build(DiscreteDummyEnv))  # noqa: E731
    trainer = make()
    t = time.perf_counter()
    stats = trainer.run(stop_conditions=[SigtermSoon(), HitsUpperBound("algorithm/steps", 2000)],
                        checkpoint_dir=ckpt, steps_per_checkpoint=2)
    returned = time.perf_counter()
    steps = trainer.state["algorithm/steps"]
    check(bool(sent) and steps < 2000, f"preemption: the run went {steps} steps")
    check(signal.getsignal(signal.SIGTERM) == prev, "preemption: SIGTERM disposition not restored")
    check(checkpoint_exists(ckpt), "preemption: no checkpoint")
    latest = json.loads((ckpt / "latest.json").read_text())
    host = json.loads((ckpt / latest["checkpoint"] / "host_state.json").read_text())
    check(host["trainer_state"] == trainer.state, f"preemption: saved counters {host['trainer_state']}")
    check(stats["algorithm/steps"] == steps, "preemption: the returned stats are the last step's")
    second = make()
    second.run(stop_conditions=[HitsUpperBound("algorithm/steps", steps + 2)], checkpoint_dir=ckpt,
               steps_per_checkpoint=2)
    h = second.algorithm.hparams
    check(second.state == {"algorithm/collects": steps + 2, "algorithm/steps": steps + 2,
                           "env/steps": (steps + 2) * h.num_envs * h.horizon}, f"preemption: resumed {second.state}")
    emit({"phase": "preemption", "steps_before_sigterm_returned": steps, "generation": latest["checkpoint"],
          "sigterm_to_return_ms": (returned - sent[0]) * 1e3, "run_s": returned - t,
          "resumed_state": second.state})


def run_cli_persistence(torch, dev, tmp: Path) -> None:
    """``train -f <config> --checkpoint-dir D --steps-per-checkpoint 2
    --max-steps 4 --save OUT`` through the CLI on the card (the quick
    start's config), then the same with ``--max-steps 6``: the second
    run's records start at step 5 and its launches are two steps' worth;
    ``OUT/policy.pkl`` loads onto the card."""
    from rl8_tpu_torch.policies import Policy

    ckpt, out = tmp / "cli-ckpt", tmp / "cli-out"
    flags = ("--checkpoint-dir", str(ckpt), "--steps-per-checkpoint", "2", "--save", str(out))
    rc, trainer, records, _ = train_cli(torch, tmp, "persist4", QUICK_START, "--max-steps", "4", *flags)
    check(rc == 0, f"cli_persistence: the CLI exited {rc}")
    h = trainer.algorithm.hparams
    check_train_records(records, h.num_envs, h.horizon, 4, None, "cli_persistence")
    gens = sorted(e.name for e in ckpt.iterdir() if e.name.startswith("ckpt-"))
    check(gens == ["ckpt-00000001", "ckpt-00000002"], f"cli_persistence: generations {gens}")
    rc, trainer, records, launches = train_cli(torch, tmp, "persist6", QUICK_START, "--max-steps", "6", *flags)
    check(rc == 0, f"cli_persistence: the resumed CLI exited {rc}")
    steps = [r["algorithm/steps"] for r in records]
    check(steps == [5, 6], f"cli_persistence: the resumed run logged steps {steps}")
    check(records[0]["env/steps"] == 5 * h.num_envs * h.horizon, "cli_persistence: env steps resumed")
    per_step = h.num_sgd_iters * h.num_minibatches
    check(launches["act"] == 2 * h.horizon and launches["gae"] == 2 and launches["ppo"] == 2 * per_step,
          f"cli_persistence: resumed launches {launches}")
    policy = Policy.load(out / "policy.pkl")
    check(all(p.is_cuda for p in policy.model.parameters()), "cli_persistence: policy.pkl did not load onto the card")
    for (k, a), b in zip(trainer.algorithm.policy.model.state_dict().items(), policy.model.state_dict().values()):
        check(torch.equal(a, b), f"cli_persistence: exported {k} differs from the trained model")
    emit({"phase": "cli_persistence", "generations": gens, "resumed_steps": steps, "launches": launches,
          "policy_bytes": (out / "policy.pkl").stat().st_size})


def serving_compare(torch, what: str, got: dict, want: dict, logits) -> dict:
    """Card against CPU serving arrays: actions equal except rows whose
    top-2 ``logits`` (the CPU model's) are within TIE_GAP, log-probs there
    and values everywhere within the act tolerances. Returns the worst
    errors."""
    import numpy as np

    from rl8_tpu_torch.data import DataKeys

    top = torch.topk(logits.reshape(logits.shape[0], -1, logits.shape[-1]), 2, dim=-1).values
    tie = ((top[..., 0] - top[..., 1]) < TIE_GAP).any(dim=-1).numpy()
    diff = (got[DataKeys.ACTIONS] != want[DataKeys.ACTIONS]).reshape(len(tie), -1).any(axis=1)
    check(not bool((diff & ~tie).any()), f"{what}: actions differ away from ties")
    errs = {"action_mismatches": int(diff.sum()), "ties": int(tie.sum())}
    for key in (DataKeys.LOGP, DataKeys.VALUES):
        ok = ~tie if key == DataKeys.LOGP else np.ones_like(tie)
        check(np.allclose(got[key][ok], want[key][ok], rtol=ACT_RTOL, atol=ACT_ATOL), f"{what}: {key}")
        errs[key] = float(np.abs(got[key][ok] - want[key][ok]).max()) if ok.any() else 0.0
    return errs


def run_serving(torch, dev, tmp: Path) -> None:
    """``PolicyModel.load`` of the CLI's exported policy and
    ``RecurrentPolicyModel.load`` of the recurrent cell's on the card:
    ``_predict_arrays`` at B = 1, 7, 100 and 8192 (T = 1) and at a
    sample-dropping view, against the same policy loaded on the CPU; the
    discrete policy also against a deterministic act-kernel launch on the
    same parameters and observations; median predict latency per batch
    size."""
    import numpy as np

    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.models import DefaultDiscreteModel
    from rl8_tpu_torch.ops import fused_act, pack_act_params
    from rl8_tpu_torch.policies import Policy
    from rl8_tpu_torch.policies.serving import PolicyModel, RecurrentPolicyModel
    from rl8_tpu_torch.views import ViewRequirement

    rng = np.random.default_rng(11)
    sizes = (1, 7, 100, 8192)
    card, host = PolicyModel.load(tmp / "cli-out" / "policy.pkl"), PolicyModel.load(tmp / "cli-out" / "policy.pkl", "cpu")
    rcard = RecurrentPolicyModel.load(tmp / "recurrent_policy.pkl")
    rhost = RecurrentPolicyModel.load(tmp / "recurrent_policy.pkl", "cpu")
    check(all(p.is_cuda for m in (card, rcard) for p in m.policy.model.parameters()), "serving: not on the card")
    latency: dict = {"feedforward": {}, "recurrent": {}}
    errors: dict = {"feedforward": {}, "recurrent": {}}

    def median_ms(fn, n: int = 20) -> float:
        fn()
        ms = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t) * 1e3)
        return sorted(ms)[n // 2]

    for B in sizes:
        obs = rng.uniform(-100.0, 100.0, size=(B, 1, 1)).astype(np.float32)
        model_input = {DataKeys.OBS: obs}
        got, want = card._predict_arrays(model_input), host._predict_arrays(model_input)
        with torch.no_grad():
            features, _ = host.policy.model({DataKeys.OBS: torch.from_numpy(obs[:, 0])})
        errors["feedforward"][B] = serving_compare(torch, f"serving B={B}", got, want, features["logits"])
        latency["feedforward"][B] = median_ms(lambda: card._predict_arrays(model_input))
        # The same observations through one deterministic act-kernel launch.
        params = pack_act_params(card.policy.model)
        actions, logp, values = fused_act(params, torch.from_numpy(obs[:, 0]).to(dev), (0, 0), deterministic=True)
        kernel = {DataKeys.ACTIONS: actions.cpu().numpy(), DataKeys.LOGP: logp.cpu().numpy(),
                  DataKeys.VALUES: values.cpu().numpy()}
        errors["feedforward"][f"act_kernel_{B}"] = serving_compare(torch, f"serving vs act kernel B={B}", got, kernel,
                                                                   features["logits"])

        def recurrent_logits(states):
            with torch.no_grad():
                (features, _), _ = rhost.policy.model({DataKeys.OBS: torch.from_numpy(obs)}, states)
            return features["logits"]

        rgot, rstates = rcard._predict_arrays(model_input)
        rwant, rwant_states = rhost._predict_arrays(model_input)
        errors["recurrent"][B] = serving_compare(torch, f"recurrent serving B={B}", rgot, rwant,
                                                 recurrent_logits(rhost.policy.init_states(B, "cpu")))
        for k in rwant_states:
            check(np.allclose(rstates[k], rwant_states[k], rtol=ACT_RTOL, atol=ACT_ATOL), f"recurrent states {k} B={B}")
        # The states fed back continue the recurrence on both devices alike.
        nxt = {DataKeys.OBS: obs, DataKeys.STATES: rwant_states}
        serving_compare(torch, f"recurrent serving from states B={B}", rcard._predict_arrays(nxt)[0],
                        rhost._predict_arrays(nxt)[0],
                        recurrent_logits({k: torch.from_numpy(v) for k, v in rwant_states.items()}))
        latency["recurrent"][B] = median_ms(lambda: rcard._predict_arrays(model_input))

    class LastOfWindow(DefaultDiscreteModel):
        """The default model on the last observation of a rolling window
        that drops the first two samples of a sequence."""

        @property
        def view_requirements(self):
            return {DataKeys.OBS: ViewRequirement(shift=2, method="rolling_window")}

        def forward(self, batch):
            return super().forward({DataKeys.OBS: batch[DataKeys.OBS][:, -1]})

    policy = Policy(card.policy.observation_spec, card.policy.action_spec, model_cls=LastOfWindow)
    policy.model.load_state_dict(host.policy.model.state_dict())
    obs = rng.uniform(-100.0, 100.0, size=(100, 6, 1)).astype(np.float32)
    host_arrays = PolicyModel(policy)._predict_arrays({DataKeys.OBS: obs})
    policy.model.to(dev)
    card_arrays = PolicyModel(policy)._predict_arrays({DataKeys.OBS: obs})
    check(len(card_arrays[DataKeys.VALUES]) == 100 * 4, "serving: drop_size rows not sliced off")
    with torch.no_grad():
        features, _ = host.policy.model({DataKeys.OBS: torch.from_numpy(obs[:, 2:].reshape(-1, 1))})
    errors["drop_size"] = serving_compare(torch, "serving drop_size view", card_arrays, host_arrays, features["logits"])
    emit({"phase": "serving", "batch_sizes": list(sizes), "predict_ms_median": latency, "errors": errors,
          "rtol": ACT_RTOL, "atol": ACT_ATOL, "tie_gap": TIE_GAP})


def run_parity_card(torch, dev, tmp: Path, seeds: tuple = (0, 1, 2)) -> None:
    """The five parity configs (``rl8_tpu_torch.parity``: 256 envs, 40
    trainer steps or 100 for pendulum) on the card, seeds 0-2, with both
    criteria against the reference's curves: one line per config. Any
    non-finite return, or a curve that never reaches the half-max
    threshold, fails the phase; the criteria themselves are reported (a
    card curve differs from a CPU curve by design)."""
    from rl8_tpu_torch import parity

    out = tmp / "parity"
    for name in parity.CONFIGS:
        t = time.perf_counter()
        for seed in seeds:
            parity.run_ours(name, seed=seed, device="cuda", out_dir=str(out))
        curves = [parity.load_curve(str(out / f"{name}_seed{s}.jsonl"))[1] for s in seeds]
        ref = [parity.load_curve(str(Path(parity.REFERENCE_CURVES_DIR) / f"{name}_seed{s}.jsonl"))[1] for s in (0, 1, 2)]
        for seed, records in zip(seeds, curves):
            check(all(math.isfinite(r["returns_mean"]) for r in records), f"parity_card {name} seed {seed}: non-finite")
        summary = parity.summarize(name, curves, ref)
        never = [s for s, n in zip(seeds, summary["ours_steps_to_half_max"]) if n is None]
        check(not never, f"parity_card {name}: seeds {never} never reach the half-max return")
        emit({"phase": "parity_card", "seeds": list(seeds), **summary, "seconds": time.perf_counter() - t})


# ---------------------------------------------------------------------------
# The multi-device path (rl8_tpu_torch.parallel)
# ---------------------------------------------------------------------------

#: The discrete cell's kernels and the recurrent cell's, per iteration.
DISCRETE_LAUNCHES = {"act": 32, "gae": 1, "update": 4}
RECURRENT_LAUNCHES = {"rnn_act": 32, "gae": 1, "rnn_update": 4}
#: A mesh of one draws the unsharded streams; only the global std's two
#: passes (reward scale, advantage normalization) round otherwise, so the
#: parameters' change agrees to this norm-relative error (Adam divides each
#: gradient by its own magnitude, so a parameter whose gradient is pure
#: rounding noise may move by up to lr either way), and the stats to this
#: relative error.
SHARDED_DELTA_REL, SHARDED_STAT_RTOL = 1e-3, 1e-4
#: Exact mode at 2 ranks against the single-device run of the same routes
#: (its stats by |a - b| / max(|b|, 1), as tests/test_parallel.py holds the
#: losses, which can be near 0, by an absolute 1e-4).
EXACT_CELL = {"num_envs": 2048, "sgd_minibatch_size": 16384}
#: Seconds the worker ranks (subprocesses of this script) may take.
SHARDED_WORKER_TIMEOUT = 600


def flat_params(torch, algo):
    return torch.cat([p.detach().reshape(-1) for p in algo.policy.model.parameters()])


def relative_delta(torch, got, want, start) -> float:
    """||(got - start) - (want - start)|| / ||want - start||."""
    return float(torch.linalg.norm((got - start) - (want - start)) / torch.linalg.norm(want - start))


def run_sharded(torch, dev, tmp: Path) -> None:
    """The multi-device phase: (a) one rank over NCCL, (b)-(d) two ranks
    sharing the card over gloo, in two subprocesses of this script, then
    the operations aids."""
    run_sharded_one_rank(torch, dev, tmp)
    run_sharded_two_ranks(torch, dev, tmp)
    run_sharded_operations(torch, dev, tmp)


def run_sharded_one_rank(torch, dev, tmp: Path) -> None:
    """(a) The default discrete cell with ``mesh=create_mesh()`` over a
    one-process NCCL group: one warm-up and five timed iterations beside
    the same cell without a mesh (act 32, GAE 1, update 4 launches an
    iteration in both), all-reduce calls per collect and per step and ms
    per call, and the sharded run against the unsharded one from the same
    seed: rank 0 draws the unsharded streams, so the first collect is
    bit-identical, and afterwards they differ only by the two-pass global
    std's rounding."""
    import torch.distributed as dist

    import rl8_tpu_torch.parallel as tp
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.data import DataKeys
    from rl8_tpu_torch.env import DiscreteDummyEnv

    tp.initialize_multihost(f"file://{tmp / 'rdzv-nccl'}", 1, 0)
    try:
        check(dist.get_backend() == "nccl", f"sharded: backend {dist.get_backend()}")
        mesh = tp.create_mesh()
        group = mesh.get_group(tp.ENV_AXIS)
        twin = time_cell(torch, AlgorithmConfig(device="cuda").build(DiscreteDummyEnv), "sharded_one_rank_twin",
                         DISCRETE_LAUNCHES, 4)
        sharded = AlgorithmConfig(device="cuda", mesh=mesh).build(DiscreteDummyEnv)
        record = time_cell(torch, sharded, "sharded_one_rank", DISCRETE_LAUNCHES, 4, backend="nccl",
                           num_envs_per_rank=sharded._impl_B)
        calls = tp._all_reduce.calls
        sharded.collect()
        collect_calls = tp._all_reduce.calls - calls
        sharded.step()
        step_calls = tp._all_reduce.calls - calls - collect_calls

        n = sum(p.numel() for p in sharded.policy.model.parameters()) + 5
        timings = {}
        for label, size in (("update", n), ("stat", 1)):
            x = torch.randn(size, device=dev)
            for _ in range(5):
                tp.pmean_tree(x, group)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(50):
                tp.pmean_tree(x, group)
            end.record()
            torch.cuda.synchronize()
            timings[label] = {"floats": size, "bytes": 4 * size, "ms": start.elapsed_time(end) / 50}

        runs = []
        for m in (None, mesh):
            algo = AlgorithmConfig(device="cuda", mesh=m).build(DiscreteDummyEnv)
            start_params = flat_params(torch, algo)
            first = algo.collect()
            buffer = {k: algo.state.buffer[k].clone() for k in (DataKeys.OBS, DataKeys.ACTIONS, DataKeys.REWARDS)}
            records = [{**first, **algo.step()}]
            for _ in range(2):
                records.append({**algo.collect(), **algo.step()})
            runs.append((buffer, records, flat_params(torch, algo)))
        (ub, ur, up), (sb, sr, sp) = runs
        for key in ub:
            check(torch.equal(ub[key], sb[key]), f"sharded: the first collect's {key} differs from the unsharded one")
        stat_keys = ("returns/mean", "returns/std", "losses/total", "losses/vf", "monitors/kl_div")
        stat_err = max(abs(s[k] - u[k]) / max(abs(u[k]), 1e-6) for s, u in zip(sr, ur) for k in stat_keys)
        delta = relative_delta(torch, sp, up, start_params)
        check(stat_err <= SHARDED_STAT_RTOL, f"sharded: stats differ from the unsharded run by {stat_err}")
        check(delta <= SHARDED_DELTA_REL, f"sharded: the parameters' change differs by {delta} (relative)")
        iteration = lambda r: r["collect_ms_median"] + r["step_ms_median"]  # noqa: E731
        emit({
            "phase": "sharded_one_rank_summary", "backend": "nccl", "world": mesh.size(),
            "transitions_per_s_with_update": record["transitions_per_s_with_update"],
            "unsharded_transitions_per_s_with_update": twin["transitions_per_s_with_update"],
            "iteration_ms_overhead": iteration(record) - iteration(twin),
            "all_reduce_calls_per_collect": collect_calls, "all_reduce_calls_per_step": step_calls,
            "all_reduce": timings, "first_collect_bit_identical": True, "max_stat_rel_err_3_iterations": stat_err,
            "param_change_rel_err_3_iterations": delta, "param_max_abs_err": float((sp - up).abs().max()),
        })
    finally:
        dist.destroy_process_group()


def all_reduce_ms(torch, group, iters: int = 20) -> dict:
    """Host ms per ``pmean_tree`` call of the update's size (133,384
    floats: the gradient, the losses and the KL) and of one statistic's,
    over ``iters`` calls after a barrier, ending in a synchronize."""
    import torch.distributed as dist

    from rl8_tpu_torch.parallel import pmean_tree

    out = {}
    for label, size in (("update", 133384), ("stat", 1)):
        x = torch.randn(size, device="cuda")
        for _ in range(3):
            pmean_tree(x, group)
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(iters):
            pmean_tree(x, group)
        torch.cuda.synchronize()
        out[label] = {"floats": size, "bytes": 4 * size, "ms": (time.perf_counter() - t) * 1e3 / iters}
    return out


def sharded_iterations(torch, algo, group, per_iteration: dict, iters: int) -> dict:
    """``iters`` collect() + step() iterations of a sharded ``algo`` (the
    first a warm-up), the launch counters set to 0 just before and read
    just after: host ms of each (from a barrier), and after every step the
    parameters and the global stats gathered from every rank and compared
    bit for bit. Returns the cell's record."""
    import torch.distributed as dist

    from rl8_tpu_torch.parallel import _gather_rows

    zero_counters()
    iterations = []
    for _ in range(iters):
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        stats = {**algo.collect(), **algo.step()}
        ms = (time.perf_counter() - t) * 1e3
        params = _gather_rows(flat_params(torch, algo)[None], group)
        keys = sorted(k for k in stats if not k.startswith("profiling/"))
        values = _gather_rows(torch.tensor([[stats[k] for k in keys]], dtype=torch.float64, device="cuda"), group)
        iterations.append({"ms": ms, "params_identical": all(torch.equal(params[0], p) for p in params[1:]),
                           "stats_identical": all(torch.equal(values[0], v) for v in values[1:]),
                           "returns_mean": stats["returns/mean"], "losses_total": stats["losses/total"]})
    ms = sorted(it["ms"] for it in iterations[1:])
    h = algo.hparams
    return {
        "num_envs": h.num_envs, "num_envs_per_rank": algo._impl_B,
        "launches": {k: v for k, v in launch_counts().items() if v},
        "launches_want": {k: iters * v for k, v in per_iteration.items()}, "iterations": iterations,
        "iteration_ms_median": ms[len(ms) // 2],
        "transitions_per_s_with_update": h.num_envs * h.horizon / (ms[len(ms) // 2] / 1e3),
    }


def check_sharded_cell(name: str, cell: dict) -> None:
    check(cell["launches"] == cell["launches_want"], f"sharded: {name} launches {cell['launches']} != "
          f"{cell['launches_want']}")
    for i, it in enumerate(cell["iterations"]):
        check(it["params_identical"], f"sharded: {name} parameters differ across ranks after step {i + 1}")
        check(it["stats_identical"], f"sharded: {name} global stats differ across ranks at step {i + 1}")


def sharded_worker(rank: int, rdzv: str, out: str) -> int:
    """One of the two ranks of (b)-(d), sharing the card over gloo: the
    discrete and the recurrent cell at 8192 envs in all (4096 a rank),
    three iterations each, with the parameters gathered and compared after
    every step; exact mode against the single-device run; a checkpoint of
    the discrete cell, restored onto two ranks here and onto one by the
    parent; SIGTERM to rank 1 during ``Trainer.run``. Writes its results
    to ``out/rank<rank>.json``."""
    import os
    import signal

    import torch
    import torch.distributed as dist

    import rl8_tpu_torch.parallel as tp
    from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig, Trainer
    from rl8_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
    from rl8_tpu_torch.conditions import HitsUpperBound
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    tp.initialize_multihost(f"file://{rdzv}", 2, rank, cpu_collectives="gloo")
    try:
        mesh = tp.create_mesh()
        group = mesh.get_group(tp.ENV_AXIS)
        result: dict = {"rank": rank, "backend": dist.get_backend(), "world": mesh.size(),
                        "all_reduce": all_reduce_ms(torch, group)}
        cells = {
            "discrete": (lambda: AlgorithmConfig(device="cuda", mesh=mesh).build(DiscreteDummyEnv), DISCRETE_LAUNCHES),
            "recurrent": (lambda: RecurrentAlgorithmConfig(device="cuda", mesh=mesh).build(DiscreteDummyEnv),
                          RECURRENT_LAUNCHES),
        }
        for name, (make, per_iteration) in cells.items():
            algo = make()
            result[name] = sharded_iterations(torch, algo, group, per_iteration, 3)
            if name == "discrete":
                algo.collect()
                save_checkpoint(f"{out}/ckpt", algo)
                saved = state_tensors(torch, algo)
                torch.save({k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in saved.items()},
                           f"{out}/state{rank}.pt")
                restored = make()
                restore_checkpoint(f"{out}/ckpt", restored)
                result["restored_onto_two_ranks_differing"] = differing(torch, state_tensors(torch, restored), saved)

        # (c) exact mode against the single-device run of the same routes.
        exact = AlgorithmConfig(device="cuda", mesh=mesh, exact_sharding=True, **EXACT_CELL).build(DiscreteDummyEnv)
        start = flat_params(torch, exact)
        zero_counters()
        exact_stats = [{**exact.collect(), **exact.step()} for _ in range(2)]
        result["exact_launches"] = {k: v for k, v in launch_counts().items() if v}
        if rank == 0:
            single = AlgorithmConfig(device="cuda", fused_act=False, fused_update=False, **EXACT_CELL).build(
                DiscreteDummyEnv
            )
            single_stats = [{**single.collect(), **single.step()} for _ in range(2)]
            keys = ("returns/mean", "returns/std", "losses/total", "losses/policy", "losses/vf", "monitors/kl_div")
            got, want = flat_params(torch, exact), flat_params(torch, single)
            result["exact"] = {
                **EXACT_CELL, "max_stat_err": max(abs(e[k] - s[k]) / max(abs(s[k]), 1.0)
                                                  for e, s in zip(exact_stats, single_stats) for k in keys),
                "param_change_rel_err": relative_delta(torch, got, want, start),
                "param_max_abs_err": float((got - want).abs().max()),
                "params_within_rtol_1e-4_atol_1e-6": bool(torch.allclose(got, want, rtol=1e-4, atol=1e-6)),
            }
        dist.barrier()

        # (d) SIGTERM to rank 1 in step 2: both save at the next boundary.
        class SigtermRank1:
            def __call__(self, stats) -> bool:
                if rank == 1 and stats["algorithm/steps"] == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return False

        trainer = Trainer(cells["discrete"][0]())
        stats = trainer.run(stop_conditions=[SigtermRank1(), HitsUpperBound("algorithm/steps", 12)],
                            checkpoint_dir=f"{out}/preempt")
        result["preempted_at_step"] = int(stats["algorithm/steps"])
        Path(f"{out}/rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()
    return 0


def run_workers(mode: str, n: int, rdzv: Path, out: Path, *extra: str) -> list:
    """Run ``n`` ranks as subprocesses of this script (``mode RANK RDZV OUT
    *extra``), each writing ``out/rank<r>.json``; stop every one of them,
    raise if one failed, and return their results in rank order."""
    out.mkdir()
    procs = [
        subprocess.Popen([sys.executable, str(Path(__file__).resolve()), mode, str(r), str(rdzv), str(out), *extra],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SHARDED_WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"{mode}: rank {r} exited {p.returncode}:\n{log[-4000:]}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]


def run_sharded_two_ranks(torch, dev, tmp: Path) -> None:
    """(b)-(d) Two ranks on the one card over gloo (NCCL refuses two ranks
    on one card), as two subprocesses of this script: per-rank launches
    (act 32, GAE 1, update 4 an iteration in the discrete cell; the
    recurrent kernels in the recurrent one), parameters bit-identical
    across the ranks after every step, global stats identical on both,
    transitions/s; exact mode against the single-device run; the
    two-rank checkpoint restored onto two ranks there and onto one rank
    here, every tensor equal; SIGTERM to one rank saving on both."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.checkpoint import restore_checkpoint
    from rl8_tpu_torch.env import DiscreteDummyEnv

    out = tmp / "sharded"
    t = time.perf_counter()
    ranks = run_workers("--sharded-worker", 2, tmp / "rdzv-gloo", out)
    for res in ranks:
        check(res["backend"] == "gloo" and res["world"] == 2, f"sharded: rank {res['rank']} group")
        for name in ("discrete", "recurrent"):
            check_sharded_cell(f"rank {res['rank']} {name}", res[name])
            check(res[name]["num_envs_per_rank"] == 4096, f"sharded: {name} envs a rank {res[name]['num_envs_per_rank']}")
        check(not res["restored_onto_two_ranks_differing"],
              f"sharded: restored onto two ranks, {res['restored_onto_two_ranks_differing']} differ")
        check(res["exact_launches"] == {}, f"sharded: exact mode launched {res['exact_launches']}")
        check(res["preempted_at_step"] == 3, f"sharded: SIGTERM returned at step {res['preempted_at_step']}")
    exact = ranks[0]["exact"]
    check(exact["max_stat_err"] <= SHARDED_STAT_RTOL, f"sharded: exact-mode stats err {exact['max_stat_err']}")
    check(exact["param_change_rel_err"] <= SHARDED_DELTA_REL,
          f"sharded: exact-mode parameter change err {exact['param_change_rel_err']}")
    preempt = out / "preempt"
    latest = json.loads((preempt / "latest.json").read_text())["checkpoint"]
    host = json.loads((preempt / latest / "host_state.json").read_text())
    check(host["trainer_state"]["algorithm/steps"] == 3, f"sharded: preemption checkpoint {host}")
    check(sorted(p.name for p in (preempt / latest).glob("shard-*")) == [
        "shard-00000-of-00002.pt", "shard-00001-of-00002.pt"], "sharded: the preemption checkpoint's shards")

    # The two-rank checkpoint onto one rank: shards joined along their batch axes.
    algo = AlgorithmConfig(device="cuda").build(DiscreteDummyEnv)
    restore_checkpoint(out / "ckpt", algo)
    got = state_tensors(torch, algo)
    saved = [torch.load(out / f"state{r}.pt", weights_only=False) for r in range(2)]
    bad = sorted(set(got) ^ set(saved[0]))
    for key in set(got) & set(saved[0]):
        want = saved[0][key]
        if key.startswith(("state.env_state[position]", "state.buffer[")):
            want = torch.cat([want, saved[1][key]], dim=0 if key.startswith("state.env_state") else 1)
        if not (torch.equal(got[key].cpu(), want) if isinstance(want, torch.Tensor) else got[key] == want):
            bad.append(key)
    check(not bad, f"sharded: restored onto one rank, {sorted(bad)} differ")
    emit({
        "phase": "sharded_two_ranks", "backend": "gloo", "world": 2, "seconds": time.perf_counter() - t,
        **{name: {k: ranks[0][name][k] for k in ("num_envs", "num_envs_per_rank", "launches",
                                                  "transitions_per_s_with_update")}
           | {"iteration_ms": [[it["ms"] for it in res[name]["iterations"]] for res in ranks],
              "params_identical_after_every_step": True, "stats_identical": True}
           for name in ("discrete", "recurrent")},
        "all_reduce": [res["all_reduce"] for res in ranks],
        "exact": exact, "restored_onto_one_rank_every_tensor_equal": True, "preempted_at_step": 3,
        "checkpoint_bytes": dir_bytes(out / "ckpt"),
    })


def multi_card_worker(rank: int, rdzv: str, out: str, world: int) -> int:
    """One rank a card over NCCL (``--multi-card``): the all-reduces' ms,
    then six iterations (one a warm-up) of the discrete cell at 8192 envs
    in all, of the discrete cell at 8192 envs a rank, and of the
    recurrent cell at 8192 envs in all, each with the parameters and
    global stats compared across every rank after every step. Writes
    ``out/rank<rank>.json``."""
    import torch
    import torch.distributed as dist

    import rl8_tpu_torch.parallel as tp
    from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    tp.initialize_multihost(f"file://{rdzv}", world, rank)
    _build.load()
    try:
        mesh = tp.create_mesh()
        group = mesh.get_group(tp.ENV_AXIS)
        result: dict = {"rank": rank, "backend": dist.get_backend(), "world": mesh.size(),
                        "device": torch.cuda.current_device(), "all_reduce": all_reduce_ms(torch, group, iters=50)}
        cells = {
            "discrete_8192_in_all": (AlgorithmConfig(device="cuda", mesh=mesh), DISCRETE_LAUNCHES),
            "discrete_8192_a_rank": (AlgorithmConfig(device="cuda", mesh=mesh, num_envs=8192 * world), DISCRETE_LAUNCHES),
            "recurrent_8192_in_all": (RecurrentAlgorithmConfig(device="cuda", mesh=mesh), RECURRENT_LAUNCHES),
        }
        for name, (config, per_iteration) in cells.items():
            result[name] = sharded_iterations(torch, config.build(DiscreteDummyEnv), group, per_iteration, 6)
        Path(f"{out}/rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()
    return 0


def run_multi_card(torch, dev, tmp: Path) -> None:
    """``python3 chip_smoke.py --multi-card``: one rank per card over NCCL
    on every card of the host (the default run needs one card and does not
    run this). The single-card cells first (card 0, one warm-up and five
    timed iterations), then the ranks (``multi_card_worker``): per-rank
    launches, parameters bit-identical across every rank after every
    step, NCCL all-reduce ms, transitions/s at 8192 envs in all (strong
    scaling) and at 8192 a rank (weak scaling) against one card."""
    from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv

    world = torch.cuda.device_count()
    check(world >= 2, f"--multi-card needs two cards or more, not {world}")
    single = time_cell(torch, AlgorithmConfig(device="cuda").build(DiscreteDummyEnv), "multi_card_single_discrete",
                       DISCRETE_LAUNCHES, 4)
    single_rec = time_cell(torch, RecurrentAlgorithmConfig(device="cuda").build(DiscreteDummyEnv),
                           "multi_card_single_recurrent", RECURRENT_LAUNCHES, 4)
    t = time.perf_counter()
    ranks = run_workers("--multi-card-worker", world, tmp / "rdzv-nccl-cards", tmp / "cards", str(world))
    check(sorted(res["device"] for res in ranks) == list(range(world)), "--multi-card: one rank a card")
    cells = ("discrete_8192_in_all", "discrete_8192_a_rank", "recurrent_8192_in_all")
    for res in ranks:
        check(res["backend"] == "nccl" and res["world"] == world, f"--multi-card: rank {res['rank']} group")
        for name in cells:
            check_sharded_cell(f"rank {res['rank']} {name}", res[name])
    rate = {name: ranks[0][name]["transitions_per_s_with_update"] for name in cells}
    one = single["transitions_per_s_with_update"]
    emit({
        "phase": "multi_card", "backend": "nccl", "world": world, "seconds": time.perf_counter() - t,
        **{name: {"num_envs": ranks[0][name]["num_envs"], "num_envs_per_rank": ranks[0][name]["num_envs_per_rank"],
                  "launches": ranks[0][name]["launches"], "transitions_per_s_with_update": rate[name],
                  "iteration_ms_median": [res[name]["iteration_ms_median"] for res in ranks],
                  "params_identical_after_every_step": True}
           for name in cells},
        "single_card_transitions_per_s_with_update": {"discrete": one,
                                                      "recurrent": single_rec["transitions_per_s_with_update"]},
        "strong_scaling_discrete": rate["discrete_8192_in_all"] / one,
        "weak_scaling_efficiency_discrete": rate["discrete_8192_a_rank"] / (world * one),
        "strong_scaling_recurrent": rate["recurrent_8192_in_all"] / single_rec["transitions_per_s_with_update"],
        "all_reduce": [res["all_reduce"] for res in ranks],
    })


def run_sharded_operations(torch, dev, tmp: Path) -> None:
    """(d) ``python -m rl8_tpu_torch doctor -f <config>`` on the default
    discrete cell exits 0 and names the kernels on; ``trace`` of a collect
    captures the act kernel's launches; ``debug_nans`` raises at a poisoned
    parameter (an ATen operator) and at a launch whose output holds a NaN
    (the act kernel's wrapper: a NaN observation reaches its outputs)."""
    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.env import DiscreteDummyEnv
    from rl8_tpu_torch.ops import fused_act, pack_act_params
    from rl8_tpu_torch.utils.debugging import debug_nans, trace

    config = tmp / "doctor.json"
    config.write_text(json.dumps({"env_cls": "rl8_tpu_torch.env.DiscreteDummyEnv", "algorithm_config": {}}))
    doctor = subprocess.run([sys.executable, "-m", "rl8_tpu_torch", "doctor", "-f", str(config)],
                            capture_output=True, text=True, cwd=str(Path(__file__).resolve().parent), timeout=300)
    lines = doctor.stdout.splitlines()
    check(doctor.returncode == 0, f"doctor exited {doctor.returncode}: {doctor.stdout}{doctor.stderr}")
    on = "ok: fast paths on: act kernel (csrc/act.cu), update kernel (csrc/ppo.cu), GAE kernel (csrc/gae.cu)"
    check(any(ln.startswith(on) for ln in lines), f"doctor does not name the kernels on: {lines}")
    check("ok: execution mode: single-device" in lines, f"doctor: {lines}")
    check(lines[0].startswith("ok: 1 device(s) [") and "on platform 'cuda'" in lines[0], f"doctor: {lines[0]}")

    algo = AlgorithmConfig(device="cuda").build(DiscreteDummyEnv)
    params = pack_act_params(algo.policy.model)
    obs = torch.randn(8192, 1, device=dev)
    # A collect, as a user traces one: 32 act launches. (A lone launch as
    # the first work of a trace after earlier profiler sessions in the
    # process left no record in three tries on the card.)
    with trace(str(tmp / "trace")):
        algo.collect()
    (path,) = (tmp / "trace").iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    launches = [e for e in events if e.get("cat") == "kernel" and "discrete_act" in e["name"]]
    kernels = sorted({e["name"][:80] for e in events if e.get("cat") == "kernel"})
    check(bool(launches), f"trace: no act kernel among {kernels}")

    raised = {}
    small = AlgorithmConfig(num_envs=64, horizon=8, device="cuda").build(DiscreteDummyEnv)
    with torch.no_grad():
        next(small.policy.model.parameters())[0, 0] = float("nan")
    # A NaN observation reaches its row's log-prob and value (the kernels'
    # relu keeps a NaN: check_nan_routes).
    bad = obs.clone()
    bad[5, 0] = float("nan")
    for what, fn in (("poisoned parameter", small.collect), ("act launch", lambda: fused_act(params, bad, (1, 2)))):
        try:
            with debug_nans():
                fn()
        except FloatingPointError as e:
            raised[what] = str(e)
    check(set(raised) == {"poisoned parameter", "act launch"}, f"debug_nans raised only for {raised}")
    check("act kernel" in raised["act launch"], f"debug_nans: {raised['act launch']}")
    fused_act(params, bad, (1, 2))  # outside the block nothing raises
    emit({"phase": "sharded_operations", "doctor": lines, "trace_kernels": kernels, "trace_act_launches": len(launches),
          "debug_nans": raised})


if __name__ == "__main__":
    sys.exit(main())

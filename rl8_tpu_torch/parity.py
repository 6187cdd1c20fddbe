"""Learning-curve parity of the port against the reference's recorded curves.

Counterpart of the repo's ``benchmarks/parity.py``, for ``rl8_tpu_torch``:
the same five configs (``CONFIGS``), built on the port's own envs and
models at the same hyperparameters and ``num_envs``, trained with the
port's own initialisation, and written as curve files of the same schema
(one meta line, then one record per trainer step) to
``rl8_tpu_torch/curves/``. The reference's curves are read as data files
from ``benchmarks/curves/reference/``.

:func:`check_parity` applies the two criteria of the JAX package's
harness, copied here (the port imports nothing of ``benchmarks``):

- **Final value**: each curve's final-quarter mean return is at least
  the reference seeds' minimum less twice their cross-seed std.
- **Sample efficiency**: the env-steps at which the curve's 3-record
  trailing mean first reaches the reference's half-max return (start +
  0.5 * (final - start)) are at most the reference seeds' largest plus
  the larger of twice their std and one trainer step of env-steps.

Examples:
    python -m rl8_tpu_torch.parity --device cpu             # record + check all
    python -m rl8_tpu_torch.parity cartpole --seeds 0 1 2   # one config
    python -m rl8_tpu_torch.parity --check-only             # assert the committed curves
    OMP_NUM_THREADS=1 python -m rl8_tpu_torch.parity --device cpu  # as committed (one thread)

A run on the card (``--device cuda``, the default) draws env resets and
minibatch shuffles from device generators, so its curves differ from the
CPU's by design; the committed curves are CPU runs.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any

__all__ = [
    "CONFIGS",
    "CURVES_DIR",
    "PARITY_NUM_ENVS",
    "REFERENCE_CURVES_DIR",
    "build",
    "check_parity",
    "load_curve",
    "run_ours",
    "summarize",
    "train_curve",
    "write_curve",
]

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Where the port's curves live.
CURVES_DIR = os.path.join(_REPO, "rl8_tpu_torch", "curves")
#: The reference library's recorded curves (data files of the repo).
REFERENCE_CURVES_DIR = os.path.join(_REPO, "benchmarks", "curves", "reference")

#: num_envs shared by the reference recordings and the parity runs.
PARITY_NUM_ENVS = 256

#: Trainer steps per config: the reference example run scripts' values.
CONFIGS: dict[str, dict[str, int]] = {
    "cartpole": {"steps": 40},
    "pendulum": {"steps": 100},
    "mountain_car": {"steps": 40},
    "algotrading": {"steps": 40},
    "recurrent": {"steps": 40},
}


def build(name: str, num_envs: int, seed: int, device: str = "cuda") -> Any:
    """The algorithm of parity config ``name`` on ``device``."""
    from . import AlgorithmConfig, RecurrentAlgorithmConfig

    if name == "cartpole":
        from .examples.cartpole import CartPole

        return AlgorithmConfig(horizon=64, num_envs=num_envs, seed=seed, device=device).build(CartPole)
    if name == "pendulum":
        from .examples.pendulum import Pendulum

        return AlgorithmConfig(
            horizon=128, horizons_per_env_reset=4, num_envs=num_envs, seed=seed, device=device
        ).build(Pendulum)
    if name == "mountain_car":
        from .examples.mountain_car import MountainCar

        return AlgorithmConfig(
            horizon=128, horizons_per_env_reset=4, num_envs=num_envs, seed=seed, device=device
        ).build(MountainCar)
    if name == "algotrading":
        from .examples.algotrading import AlgoTrading, MischievousMule

        return AlgorithmConfig(model_cls=MischievousMule, num_envs=num_envs, seed=seed, device=device).build(
            AlgoTrading
        )
    if name == "recurrent":
        from .env import DiscreteDummyEnv

        return RecurrentAlgorithmConfig(num_envs=num_envs, seed=seed, device=device).build(DiscreteDummyEnv)
    raise ValueError(f"unknown parity config {name!r}")


def train_curve(algo: Any, steps: int) -> list[dict[str, Any]]:
    """Train ``algo`` for ``steps`` trainer steps and return one record
    per step (the curve files' schema)."""
    records = []
    env_steps = 0
    start = time.perf_counter()
    for step in range(1, steps + 1):
        stats = algo.train_steps(1)[0]
        env_steps += int(stats["env/steps"])
        records.append(
            {
                "step": step,
                "env_steps": env_steps,
                "returns_mean": stats["returns/mean"],
                "returns_std": stats["returns/std"],
                "seconds": time.perf_counter() - start,
            }
        )
    return records


def write_curve(path: str, meta: dict[str, Any], records: list[dict[str, Any]]) -> str:
    """Write a curve file: the meta line, then the records."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({"meta": meta}) + "\n")
        for r in records:
            f.write(json.dumps(r) + "\n")
    return path


def run_ours(
    name: str,
    *,
    num_envs: int = PARITY_NUM_ENVS,
    seed: int = 0,
    device: str = "cuda",
    out_dir: str = CURVES_DIR,
) -> str:
    """Train the port on parity config ``name`` and write its curve file
    ``<out_dir>/<name>_seed<seed>.jsonl``; returns the path.

    One throwaway step first builds the kernels (on the card) outside the
    timed window, as the JAX harness compiles first. The meta line records the device and, since a CPU run's sums depend
    on how ATen splits them, the number of CPU threads."""
    import torch

    t0 = time.perf_counter()
    build(name, num_envs, seed, device).train_steps(1)
    compile_s = time.perf_counter() - t0
    algo = build(name, num_envs, seed, device)
    records = train_curve(algo, CONFIGS[name]["steps"])
    meta = {
        "config": name,
        "seed": seed,
        "num_envs": num_envs,
        "horizon": algo.hparams.horizon,
        "compile_s": compile_s,
        "source": "rl8_tpu_torch",
        "device": str(algo.device),
        "threads": torch.get_num_threads(),
    }
    return write_curve(os.path.join(out_dir, f"{name}_seed{seed}.jsonl"), meta, records)


def load_curve(path: str) -> tuple[dict[str, Any], list[dict[str, Any]]]:
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    if lines and "meta" in lines[0]:
        return lines[0]["meta"], lines[1:]
    return {}, lines


def _final_quarter_mean(records: list[dict[str, Any]]) -> float:
    tail = records[-max(1, len(records) // 4) :]
    return sum(r["returns_mean"] for r in tail) / len(tail)


def _smoothed_returns(records: list[dict[str, Any]], window: int = 3) -> list[float]:
    """Trailing-window running mean of ``returns_mean``."""
    vals = [r["returns_mean"] for r in records]
    out = []
    for i in range(len(vals)):
        lo = max(0, i - window + 1)
        out.append(sum(vals[lo : i + 1]) / (i + 1 - lo))
    return out


def _steps_to_threshold(records: list[dict[str, Any]], threshold: float) -> None | int:
    """First ``env_steps`` at which the smoothed return reaches
    ``threshold`` (``None`` if never)."""
    for r, v in zip(records, _smoothed_returns(records)):
        if v >= threshold:
            return int(r["env_steps"])
    return None


def _std(xs: list[float]) -> float:
    n = len(xs)
    if n < 2:
        return 0.0
    m = sum(xs) / n
    return math.sqrt(sum((x - m) ** 2 for x in xs) / (n - 1))


def _curves(directory: str, name: str) -> list[tuple[dict[str, Any], list[dict[str, Any]]]]:
    out = []
    for fn in sorted(os.listdir(directory)):
        if fn.startswith(f"{name}_seed") and fn.endswith(".jsonl"):
            out.append(load_curve(os.path.join(directory, fn)))
    return out


def summarize(
    name: str,
    ours: list[list[dict[str, Any]]],
    reference: list[list[dict[str, Any]]],
) -> dict[str, Any]:
    """Both criteria's figures for curves ``ours`` against ``reference``
    (lists of record lists), with ``final_ok`` and ``steps_ok`` per
    curve; raises nothing about ``ours``."""
    ref_finals = [_final_quarter_mean(r) for r in reference]
    our_finals = [_final_quarter_mean(r) for r in ours]
    ref_std = _std(ref_finals) or abs(sum(ref_finals) / len(ref_finals)) * 0.05
    band_low = min(ref_finals) - 2 * ref_std
    ref_starts = [r[0]["returns_mean"] for r in reference]
    ref_start = sum(ref_starts) / len(ref_starts)
    ref_final = sum(ref_finals) / len(ref_finals)
    threshold = ref_start + 0.5 * (ref_final - ref_start)
    ref_steps = [_steps_to_threshold(r, threshold) for r in reference]
    if any(s is None for s in ref_steps):
        raise AssertionError(
            f"{name}: a reference curve never reaches its own half-max"
            f" {threshold:.3f} — recorded curves are inconsistent"
        )
    step_granularity = reference[0][0]["env_steps"]  # env-steps per record
    allowed = max(ref_steps) + max(2 * _std([float(s) for s in ref_steps]), float(step_granularity))  # type: ignore[arg-type]
    our_steps = [_steps_to_threshold(r, threshold) for r in ours]
    return {
        "config": name,
        "reference_final_returns": ref_finals,
        "ours_final_returns": our_finals,
        "band_low": band_low,
        "half_max_threshold": threshold,
        "reference_steps_to_half_max": ref_steps,
        "ours_steps_to_half_max": our_steps,
        "allowed_steps_to_half_max": allowed,
        "final_ok": [f >= band_low for f in our_finals],
        "steps_ok": [s is not None and s <= allowed for s in our_steps],
    }


def check_parity(
    name: str, curves_dir: str = CURVES_DIR, reference_dir: str = REFERENCE_CURVES_DIR
) -> dict[str, Any]:
    """Assert the curves of ``name`` in ``curves_dir`` reach the
    reference's seed band on both criteria; returns the summary (the JAX
    harness's keys) or raises ``AssertionError`` naming the first miss."""
    ref = _curves(reference_dir, name)
    ours = _curves(curves_dir, name)
    assert ref, f"no reference curves recorded for {name!r}"
    assert ours, f"no curves recorded for {name!r} under {curves_dir}"
    for meta, _ in ref + ours:
        assert meta.get("num_envs") == PARITY_NUM_ENVS, (
            f"{name}: curve recorded at num_envs={meta.get('num_envs')} —"
            f" parity compares at {PARITY_NUM_ENVS}"
        )
    summary = summarize(name, [r for _, r in ours], [r for _, r in ref])
    band_low, threshold = summary["band_low"], summary["half_max_threshold"]
    ref_finals, allowed = summary["reference_final_returns"], summary["allowed_steps_to_half_max"]
    for (meta, _), final in zip(ours, summary["ours_final_returns"]):
        seed = meta.get("seed")
        assert final >= band_low, (
            f"{name} seed {seed}: final return {final:.3f} below the"
            f" reference seed band (min {min(ref_finals):.3f} - 2*std ="
            f" {band_low:.3f})"
        )
    for (meta, _), s in zip(ours, summary["ours_steps_to_half_max"]):
        seed = meta.get("seed")
        assert s is not None, f"{name} seed {seed}: never reaches the reference's half-max return {threshold:.3f}"
        assert s <= allowed, (
            f"{name} seed {seed}: {s} env-steps to reach the reference's"
            f" half-max return {threshold:.3f} — reference seeds took"
            f" {summary['reference_steps_to_half_max']} (allowed <= {allowed:.0f})"
        )
    return {k: v for k, v in summary.items() if k not in ("final_ok", "steps_ok")}


def main(argv: None | list[str] = None) -> None:
    parser = argparse.ArgumentParser(description="Learning-curve parity of rl8_tpu_torch.")
    parser.add_argument("configs", nargs="*", default=list(CONFIGS))
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    parser.add_argument("--out-dir", default=CURVES_DIR, help="Where to write (and check) the curves.")
    parser.add_argument("--check-only", action="store_true", help="Skip training; check the curves.")
    args = parser.parse_args(argv)
    for name in args.configs:
        if not args.check_only:
            for seed in args.seeds:
                path = run_ours(name, seed=seed, device=args.device, out_dir=args.out_dir)
                print(f"wrote {path}", flush=True)
        if args.check_only:
            print(json.dumps(check_parity(name, curves_dir=args.out_dir)), flush=True)
            continue
        ours = [r for _, r in _curves(args.out_dir, name)]
        ref = [r for _, r in _curves(REFERENCE_CURVES_DIR, name)]
        print(json.dumps(summarize(name, ours, ref)), flush=True)


if __name__ == "__main__":
    main()

"""Same-initialisation parity runs of both packages, on the CPU.

Trains ``rl8_tpu`` and ``rl8_tpu_torch`` on a parity config
(``benchmarks/parity.py``'s, 256 envs) from the same initial parameters:
the port loads ``rl8_tpu``'s parameters of the same seed through
``rl8_tpu_torch.models.load_jax_params``. Everything else (env resets,
action samples, minibatch order) is each package's own. The summary
applies the decision rule recorded in ``PERF.md`` §6: the port's mean final
(or mean steps to half-max) within 2 standard errors of ``rl8_tpu``'s,
and a Brown-Forsythe test (``scipy.stats.levene(center="median")``) at
p >= 0.05.

Run one package's seeds (each in its own process; the two packages'
runs are independent):

    JAX_PLATFORMS=cpu python tools/parity_same_init.py run --package jax \\
        --config algotrading --seeds 0 1 2 --out-dir build/same_init
    JAX_PLATFORMS=cpu python tools/parity_same_init.py run --package torch \\
        --config algotrading --seeds 0 1 2 --out-dir build/same_init
    python tools/parity_same_init.py summary --out-dir build/same_init

And compare both packages' initial parameter distributions at the
parity configs' default widths, seeds 0-19 (per leaf: pooled mean, std,
range and a two-sample KS p-value; constant leaves compared exactly):

    JAX_PLATFORMS=cpu python tools/parity_same_init.py init
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rl8_tpu_torch.parity import (  # noqa: E402
    CONFIGS,
    PARITY_NUM_ENVS,
    REFERENCE_CURVES_DIR,
    _curves,
    build,
    summarize,
    train_curve,
    write_curve,
)


def _jax_algo(name: str, seed: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from benchmarks.parity import _build

    return _build(name, PARITY_NUM_ENVS, seed)


def run(package: str, name: str, seed: int, out_dir: str) -> str:
    import jax

    jalgo = _jax_algo(name, seed)
    if package == "jax":
        algo = jalgo
    else:
        from rl8_tpu_torch.models import load_jax_params

        algo = build(name, PARITY_NUM_ENVS, seed, device="cpu")
        load_jax_params(algo.policy.model, jax.device_get(jalgo.state.params))
    t0 = time.perf_counter()
    records = train_curve(algo, CONFIGS[name]["steps"])
    meta = {
        "config": name,
        "seed": seed,
        "num_envs": PARITY_NUM_ENVS,
        "source": "rl8_tpu" if package == "jax" else "rl8_tpu_torch",
        "init": "rl8_tpu",
        "device": "cpu",
        "seconds": time.perf_counter() - t0,
    }
    return write_curve(os.path.join(out_dir, package, f"{name}_seed{seed}.jsonl"), meta, records)


def _mean_sd(xs: list[float]) -> tuple[float, float]:
    m = sum(xs) / len(xs)
    return m, math.sqrt(sum((x - m) ** 2 for x in xs) / (len(xs) - 1))


def summary(out_dir: str) -> None:
    """Per config with runs of both packages: each criterion's figures and
    the rule's verdict on both metrics (the mean final, and the mean
    env-steps to half-max, where every run reaches it)."""
    from scipy.stats import levene

    for name in sorted(CONFIGS):
        ref = [r for _, r in _curves(REFERENCE_CURVES_DIR, name)]
        per = {}
        for package in ("jax", "torch"):
            directory = os.path.join(out_dir, package)
            curves = _curves(directory, name) if os.path.isdir(directory) else []
            if curves:
                per[package] = (sorted(m["seed"] for m, _ in curves), summarize(name, [r for _, r in curves], ref))
        if len(per) < 2:
            continue
        row = {"config": name, "seeds": {p: per[p][0] for p in per}}
        for key in ("ours_final_returns", "ours_steps_to_half_max"):
            j, t = ([float(x) for x in per[p][1][key] if x is not None] for p in ("jax", "torch"))
            if len(j) < 2 or len(t) < 2:
                continue
            (mj, sj), (mt, st) = _mean_sd(j), _mean_sd(t)
            se = math.sqrt(sj**2 / len(j) + st**2 / len(t))
            p = float(levene(j, t, center="median").pvalue) if (sj or st) else 1.0
            within = abs(mt - mj) <= 2 * se
            row[key.replace("ours_", "")] = {
                "jax": j, "torch": t, "jax_mean": mj, "jax_sd": sj, "torch_mean": mt, "torch_sd": st,
                "se_of_difference": se, "difference": mt - mj, "within_2se": within, "levene_median_p": p,
                "verdict": "seed spread" if within and p >= 0.05 else "fault",
            }
        for p in ("jax", "torch"):
            row[f"{p}_criteria"] = {k: per[p][1][k] for k in ("final_ok", "steps_ok")}
        print(json.dumps(row), flush=True)


def init_distributions(seeds: int = 20) -> None:
    import jax
    import numpy as np
    import torch
    from scipy.stats import ks_2samp

    from rl8_tpu_torch.models import to_jax_params

    def flat(tree: dict, prefix: str = "") -> dict:
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
        return out

    for name in ("algotrading", "recurrent"):
        talgo, jalgo = build(name, 4, 0, device="cpu"), _jax_algo(name, 0)
        policy, jinit = talgo.policy, jax.jit(jalgo.policy.init_params)
        drawn: dict = {}
        jdrawn: dict = {}
        for seed in range(seeds):
            policy.init_params(torch.Generator().manual_seed(seed))
            for k, v in flat(to_jax_params(policy.model)).items():
                drawn.setdefault(k, []).append(v)
            for k, v in flat(jax.device_get(jinit(jax.random.key(seed)))).items():
                jdrawn.setdefault(k, []).append(v)
        for key in sorted(jdrawn):
            a, b = np.stack(drawn[key]), np.stack(jdrawn[key])
            row = {"config": name, "leaf": key, "shape": list(b.shape[1:])}
            for tag, x in (("torch", a), ("jax", b)):
                row[tag] = {"mean": float(x.mean()), "std": float(x.std()), "min": float(x.min()), "max": float(x.max())}
            if b.std() == 0:
                row["constant_equal"] = bool(np.array_equal(a, b))
            else:
                row["ks_p"] = float(ks_2samp(a.ravel(), b.ravel()).pvalue)
            print(json.dumps(row), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)
    r = sub.add_parser("run")
    r.add_argument("--package", choices=("jax", "torch"), required=True)
    r.add_argument("--config", choices=sorted(CONFIGS), required=True)
    r.add_argument("--seeds", type=int, nargs="+", default=list(range(9)))
    r.add_argument("--out-dir", required=True)
    s = sub.add_parser("summary")
    s.add_argument("--out-dir", required=True)
    sub.add_parser("init")
    args = parser.parse_args()
    if args.command == "run":
        for seed in args.seeds:
            print("wrote", run(args.package, args.config, seed, args.out_dir), flush=True)
    elif args.command == "summary":
        summary(args.out_dir)
    else:
        init_distributions()


if __name__ == "__main__":
    main()

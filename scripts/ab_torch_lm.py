"""Time the port's bench solve against an older tree of the port, interleaved.

Loads ``multicam_calibration_tpu_torch`` from this repository and, under
another module name, from ``--parent`` (the root of an older checkout, e.g.
one unpacked with ``git archive``), and runs ``lm_solve`` on the bench
problem of chip_smoke.py (6 x 922 x 35 from ``data/bench_x0.npz``, the
bench's options) on each, in one process, alternating which side runs first
from round to round. Variants: ``kernel`` (the default routes: block build
and per-try cost through the CUDA kernels) and ``plain`` (both impls
"torch"). Per variant and side: the median wall (host clock around work
that ends in ``torch.cuda.synchronize()``), the spread between its quartiles,
iterations, final cost and, from one solve under ``torch.profiler``, the
CUDA launches; and the rounds the change wins. The verdict is "faster" or
"slower" only when one side wins at least 9 rounds in 10 and the medians
differ by more than the parent's quartile spread, else "unresolved". Needs a CUDA device; run from
the repository root:

    python scripts/ab_torch_lm.py --parent <dir> [--rounds 20] [--out <dir>]
"""
import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PKG = "multicam_calibration_tpu_torch"


def load_port(root, name):
    """The port's package under ``root``, imported as ``name``."""
    pkg = os.path.join(root, PKG)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(name + ".models.lm_core"),
            importlib.import_module(name + ".convert"))


def quartile_spread(xs):
    q = statistics.quantiles(xs, n=4)
    return q[2] - q[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="root of the older checkout")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--out", help="directory for ab_torch_lm.json")
    args = ap.parse_args()

    import torch

    from chip_smoke import BENCH_JAX_OPTIONS, bench_problem, profile_calls

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card)
    sides = {"parent": load_port(os.path.abspath(args.parent), "parent_port"),
             "change": load_port(ROOT, PKG)}
    dev = torch.device("cuda", torch.cuda.current_device())
    cam0, poses0, obs, mask, objp = bench_problem(torch, dev)

    def options(side, variant):
        lm_core, convert = sides[side]
        opts = convert.lm_options_from_jax(BENCH_JAX_OPTIONS)
        if variant == "plain":
            opts = dataclasses.replace(opts, block_impl="torch", cost_impl="torch")
        return opts

    def solve(side, opts):
        return sides[side][0].lm_solve(cam0, poses0, obs, mask, objp, opts)

    report = {"card": card, "rounds": args.rounds, "variants": {}}
    for variant in ("kernel", "plain"):
        opts = {side: options(side, variant) for side in sides}
        walls = {side: [] for side in sides}
        info = {}
        for side in sides:  # warm-up, and one profiled solve each
            info[side] = solve(side, opts[side])[2]
            info[side]["launches"] = profile_calls(torch, lambda: solve(side, opts[side]),
                                                   calls=1)[0]
        for r in range(args.rounds):
            order = ("parent", "change") if r % 2 == 0 else ("change", "parent")
            for side in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solve(side, opts[side])
                torch.cuda.synchronize()
                walls[side].append(time.perf_counter() - t0)
        wins = sum(c < p for p, c in zip(walls["parent"], walls["change"]))
        losses = sum(c > p for p, c in zip(walls["parent"], walls["change"]))
        med = {side: statistics.median(w) for side, w in walls.items()}
        spread = quartile_spread(walls["parent"])
        verdict = "unresolved"
        if abs(med["change"] - med["parent"]) > spread:
            if wins >= 0.9 * args.rounds:
                verdict = "faster"
            elif losses >= 0.9 * args.rounds:
                verdict = "slower"
        v = report["variants"][variant] = {
            "walls_s": walls, "median_s": med, "parent_quartile_spread_s": spread,
            "change_wins": wins, "change_losses": losses, "verdict": verdict,
            "n_iters": {s: int(i["n_iters"]) for s, i in info.items()},
            "final_cost": {s: float(i["final_cost"]) for s, i in info.items()},
            "launches_per_solve": {s: i["launches"] for s, i in info.items()},
        }
        print(f"{variant}: median parent {med['parent']:.4f} s, change {med['change']:.4f} s "
              f"(parent quartile spread {spread:.4f}); change wins {wins} of {args.rounds}, "
              f"loses {losses}: {verdict}; n_iters {v['n_iters']}; final cost "
              f"{v['final_cost']}; CUDA launches per solve {v['launches_per_solve']}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "ab_torch_lm.json"), "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

"""Variants of the port's CUDA per-try cost kernel, timed on the GPU at the bench shape.

The counterpart of ``scripts/exp_torch_ba_blocks.py`` for ``ba_cost_kernel``:
each variant is ``multicam_calibration_tpu_torch/csrc/ba_kernels.cu`` with
textual substitutions (a change to one constant) or, for a probe, with one
phase cut out to see what it costs (a probe's results are wrong by
construction and are not checked). All variants are compiled at once, one
nvcc each, with the flags of ``ops/_build.py``, into ``<out>/``. For each: the
ptxas registers, stack and spills of ``ba_cost_kernel``, the fragments and
total against the plain twin (chip_smoke's tolerances), and from
``torch.profiler`` the kernel's device time per call over 20 calls after a
warm-up, on the bench problem of chip_smoke.py (6 cameras x 922 frames x 35
points). Last, the host side of one ``ba_chunk_cost`` call through the
committed library: the wrapper's input checks, its look-up of the current
stream, its allocation, views and launch, and the whole call, on the host
clock over 2000 calls each. Needs a CUDA device;
from the repository root:

    python scripts/exp_torch_ba_cost.py --out <dir>

Prints one line per variant and writes ``<dir>/exp_torch_ba_cost.json``.
"""
import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CALLS = 20

FRONT = "  TilePoint tp[kCostTiles];\n"
PACKS = "  tile_packs<false>("
CHAIN = "    if (tp[j].live) {\n      double pw[3], rbd[3];"
NO_CHAIN = (CHAIN, CHAIN.replace("tp[j].live", "N < 0"))
TICKET = "  const unsigned int n_blocks = gridDim.x * gridDim.y;\n"
TILES = "kCostTiles = 2; "
MIN_BLOCKS = "kCostMinBlocksPerSM = 3;"
VARIANTS = {  # name -> [(old, new), ...] applied to the committed source
    "as committed": [],
    "1 tile a block, min 4 blocks/SM": [(TILES, "kCostTiles = 1; "),
                                        (MIN_BLOCKS, "kCostMinBlocksPerSM = 4;")],
    "3 tiles a block, min 2 blocks/SM": [(TILES, "kCostTiles = 3; "),
                                         (MIN_BLOCKS, "kCostMinBlocksPerSM = 2;")],
    "min 2 blocks/SM": [(MIN_BLOCKS, "kCostMinBlocksPerSM = 2;")],
    "min 4 blocks/SM": [(MIN_BLOCKS, "kCostMinBlocksPerSM = 4;")],
    "probe: empty body": [(FRONT, "  if (N > 0) return;\n" + FRONT)],
    "probe: no packs": [(PACKS, "  if (N < 0) tile_packs<false>(")],
    "probe: no chain": [NO_CHAIN],
    "probe: no packs, no chain": [(PACKS, "  if (N < 0) tile_packs<false>("), NO_CHAIN],
    "probe: no total": [("  if (!s_last) return;", "  if (N > 0) return;")],
    "probe: no ticket, no total": [(TICKET, TICKET + "  if (N > 0) return;\n")],
}


def host_us(fn, calls=2000):
    """Host clock per call of fn() in us, after a warm-up (no synchronize:
    what the caller's thread spends before it can go on)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return 1e6 * (time.perf_counter() - t0) / calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the builds and the JSON")
    args = ap.parse_args()

    import torch

    from chip_smoke import bench_problem, compare_cost, cuda_ms, profile_calls, ptxas_of
    from exp_torch_ba_blocks import build
    from multicam_calibration_tpu_torch.device import cuda_device
    from multicam_calibration_tpu_torch.ops import _build, ba_cuda

    dev = cuda_device()
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card, flush=True)
    with open(_build.CSRC_DIR / "ba_kernels.cu") as f:
        src_text = f.read()
    nvcc = _build._nvcc()
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        futures = {
            name: pool.submit(build, nvcc, _build.NVCC_FLAGS, src_text, subs,
                              os.path.join(args.out, f"libba_cost_variant{i}.so"))
            for i, (name, subs) in enumerate(VARIANTS.items())
        }
        logs = {name: fut.result() for name, fut in futures.items()}

    cam0, poses0, obs, mask, objp = bench_problem(torch, dev)
    bench = (cam0, poses0, *ba_cuda.ba_prepare_obs(obs, mask), objp)
    ref = ba_cuda.ba_chunk_cost_reference(*bench)
    stream = torch.cuda.current_stream().cuda_stream
    report = {"device": card, "shape": list(mask.shape), "calls": CALLS, "variants": {}}
    for i, name in enumerate(VARIANTS):
        lib = ba_cuda.bind(ctypes.CDLL(os.path.join(args.out, f"libba_cost_variant{i}.so")))
        run = lambda: ba_cuda._launch_cost(lib, stream, *bench, 1.0, False)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        entry = {"ptxas": ptxas_of(logs[name], "ba_cost_kernel")}
        if not name.startswith("probe"):
            entry["max_abs_err"], entry["total_rel_err"] = compare_cost(got, ref, run())
        entry["launches_per_call"], ms, per = profile_calls(torch, run, CALLS)
        entry["device_us_per_call"] = 1e3 * ms
        torch.cuda.synchronize()
        ba_cuda._ticket(dev, stream).zero_()  # a probe may leave arrivals counted
        report["variants"][name] = entry
        print(f"{name}: {entry['device_us_per_call']:.2f} us per call; ptxas "
              + ", ".join(f"{k} {v}" for k, v in entry["ptxas"].items())
              + (f"; fragments max|err| {entry['max_abs_err']:.2e}"
                 if "max_abs_err" in entry else ""), flush=True)

    lib = ba_cuda._lib()
    def device_context():
        with torch.cuda.device(dev):
            pass

    host = {
        "check": host_us(lambda: ba_cuda._check(*bench)),
        "current stream": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "device context (entered only for another device)": host_us(device_context),
        "launch (allocation, views, kernel)": host_us(
            lambda: ba_cuda._launch_cost(lib, stream, *bench, 1.0, False)),
        "ba_chunk_cost": host_us(lambda: ba_cuda.ba_chunk_cost(*bench)),
    }
    torch.cuda.synchronize()
    report["wrapper_host_us_per_call"] = host
    report["wrapper_cuda_events_ms_per_call"] = cuda_ms(
        torch, lambda: ba_cuda.ba_chunk_cost(*bench))
    print("wrapper, host us per call: " + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
          + f"; CUDA events over 20 back-to-back calls {report['wrapper_cuda_events_ms_per_call']:.4f} ms",
          flush=True)
    with open(os.path.join(args.out, "exp_torch_ba_cost.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

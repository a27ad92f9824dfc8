"""Variants of the port's CUDA block build, timed on the GPU at the bench shape.

Each variant is ``multicam_calibration_tpu_torch/csrc/ba_kernels.cu`` with
textual substitutions (a change to one step) or, for a probe, with one
phase cut out to see what it costs (a probe's results are wrong by
construction and are not checked). All variants are compiled at
once, one nvcc each, with the flags of ``ops/_build.py``, into ``<out>/``.
For each: the ptxas registers, stack and spills of ``ba_blocks_kernel``, the
blocks against the plain twin (chip_smoke's tolerances), and from
``torch.profiler`` the device time per call of each of the two kernels over
20 calls after a warm-up, on the bench problem of chip_smoke.py (6 cameras x
922 frames x 35 points). Needs a CUDA device; from the repository root:

    python scripts/exp_torch_ba_blocks.py --out <dir>

Prints one line per variant and writes ``<dir>/exp_torch_ba_blocks.json``.
"""
import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CALLS = 20

GRAM_LOOP = "for (int r = 0; r < N; ++r) {"
OUTPUTS = "if (frame_ok) {\n      for (int k = lane; k < kStageGcam; k += 32)"
VARIANTS = {  # name -> [(old, new), ...] applied to the committed source
    "as committed": [],
    "Gram loop unrolled 5": [(GRAM_LOOP, "#pragma unroll 5\n      " + GRAM_LOOP)],
    "min 2 blocks/SM": [("kMinBlocksPerSM = 3;", "kMinBlocksPerSM = 2;")],
    "probe: empty body": [("float* rows = reinterpret_cast<float*>(rows_smem);",
                           "if (N > 0) return;\n  float* rows = reinterpret_cast<float*>(rows_smem);")],
    "probe: no packs": [("if (warp == 0) {", "if (false) {")],
    "probe: no point rows": [("if (tp.live) {", "if (false) {")],
    "probe: no Gram loop": [(GRAM_LOOP, "for (int r = 0; r < 0; ++r) {")],
    "probe: no rows, no Gram": [("if (tp.live) {", "if (false) {"),
                                (GRAM_LOOP, "for (int r = 0; r < 0; ++r) {")],
    "probe: no global outputs": [(OUTPUTS, OUTPUTS.replace("frame_ok", "false"))],
}


def build(nvcc, flags, src_text, subs, path):
    for old, new in subs:
        if old not in src_text:
            raise ValueError(f"substitution target not in the source: {old!r}")
        src_text = src_text.replace(old, new)
    cu = path + ".cu"
    with open(cu, "w") as f:
        f.write(src_text)
    proc = subprocess.run([nvcc, *flags, "-o", path, cu], capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the builds and the JSON")
    args = ap.parse_args()

    import torch

    from chip_smoke import bench_problem, compare_blocks, profile_calls, ptxas_of
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
                              os.path.join(args.out, f"libba_variant{i}.so"))
            for i, (name, subs) in enumerate(VARIANTS.items())
        }
        logs = {name: fut.result() for name, fut in futures.items()}

    cam0, poses0, obs, mask, objp = bench_problem(torch, dev)
    bench = (cam0, poses0, *ba_cuda.ba_prepare_obs(obs, mask), objp)
    ref = ba_cuda.ba_chunk_blocks_reference(*bench)
    stream = torch.cuda.current_stream().cuda_stream
    report = {"device": card, "shape": list(mask.shape), "calls": CALLS, "variants": {}}
    for i, name in enumerate(VARIANTS):
        lib = ba_cuda.bind(ctypes.CDLL(os.path.join(args.out, f"libba_variant{i}.so")))
        run = lambda: ba_cuda._launch_blocks(lib, stream, *bench, 1.0, False)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        entry = {"ptxas": ptxas_of(logs[name], "ba_blocks_kernel")}
        if not name.startswith("probe"):
            entry["max_abs_err"], entry["err_over_tol"] = compare_blocks(got, ref)
        entry["launches_per_call"], ms, per = profile_calls(torch, run, CALLS)
        entry["device_us_per_call"] = per
        entry["total_us_per_call"] = 1e3 * ms
        report["variants"][name] = entry
        print(f"{name}: {entry['total_us_per_call']:.2f} us per call ("
              + ", ".join(f"{k} {v:.2f}" for k, v in per.items()) + "); ptxas "
              + ", ".join(f"{k} {v}" for k, v in entry["ptxas"].items())
              + (f"; err/tol max {max(entry['err_over_tol'].values()):.2e}"
                 if "err_over_tol" in entry else ""), flush=True)
    with open(os.path.join(args.out, "exp_torch_ba_blocks.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

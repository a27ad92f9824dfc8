"""Variants of the port's CUDA corner kernel, timed on the GPU at the bench shape.

Each variant is ``multicam_calibration_tpu_torch/csrc/corner_kernels.cu``
with textual substitutions (another tile height or window length) or, for a
probe, with one stage cut out to see what it costs (a probe's results are
wrong by construction and are not checked). ``--parent <file>`` adds an
older source of the same C interface as one more variant, so the two are
timed in one process on one card. All variants are compiled at once, one
nvcc each, with the flags of ``ops/_build.py``, into ``<out>/``. For each:
ptxas registers, stack and spills of every instantiation; the response and
peaks against the plain twin bit for bit at sigma 1.5 and 9; and the device
time per call (CUDA events over 20 back-to-back calls after a warm-up) with
peaks at sigma 1.5, 3.5, 6 and 9 and without at 1.5, on chip_smoke.py's
bench batch (the 8 clean stored frames tiled to 128 x 480 x 640). The list
is timed twice, the second time in reverse order. Needs a CUDA device; from
the repository root:

    python scripts/exp_torch_corner.py --out <dir> [--parent <corner_kernels.cu>]

Prints one line per variant and pass and writes ``<dir>/exp_torch_corner.json``.
"""
import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
NMS = 4
SIGMAS = (1.5, 3.5, 6.0, 9.0)

TILE_H = "return RG == 0 ? 32 : RG == 11 || RG == 27 ? 64 : 48;"
STAGE = "constexpr int kStageRows = 4;"
VARIANTS = {  # name -> [(old, new), ...] applied to the committed source
    "as committed": [],
    "tile 32 rows": [(TILE_H, "return 32;")],
    "tile 48 rows": [(TILE_H, "return RG == 0 ? 32 : 48;")],
    "tile 64 rows": [(TILE_H, "return RG == 0 ? 32 : 64;")],
    "window 4": [("constexpr int kS = 8;", "constexpr int kS = 4;")],
    "stage 2 rows at once": [(STAGE, "constexpr int kStageRows = 2;")],
    "stage 8 rows at once": [(STAGE, "constexpr int kStageRows = 8;")],
    "probe: no window maxima": [("d <= 2 * n; ++d", "d <= 0; ++d")],
    "probe: no Gaussian passes": [("if (r < L.inH)\n", "if (false)\n"),
                                  ("if (c < L.gW)\n", "if (false)\n")],
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


def all_ptxas(log, ptxas_of):
    """{instantiation: ptxas report} for every corner kernel in a build log."""
    names = re.findall(r"Compiling entry function '(\S*corner_kernel\S*)'", log)
    return {re.sub(r".*corner_kernelI(.*?)EEv.*", r"<\1>", n): ptxas_of(log, n) for n in names}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the builds and the JSON")
    ap.add_argument("--parent", help="an older corner_kernels.cu to time beside the variants")
    args = ap.parse_args()

    import torch

    from chip_smoke import BATCH, corner_bound, cuda_ms, ptxas_of
    from multicam_calibration_tpu_torch.device import cuda_device
    from multicam_calibration_tpu_torch.ops import _build, corner_cuda as cc

    dev = cuda_device()
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card, flush=True)
    with open(_build.CSRC_DIR / "corner_kernels.cu") as f:
        committed = f.read()
    sources = {name: (committed, subs) for name, subs in VARIANTS.items()}
    if args.parent:
        with open(args.parent) as f:
            sources["parent"] = (f.read(), [])
    nvcc = _build._nvcc()
    paths = {name: os.path.join(args.out, f"libcorner_variant{i}.so")
             for i, name in enumerate(sources)}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        futures = {name: pool.submit(build, nvcc, _build.NVCC_FLAGS, text, subs, paths[name])
                   for name, (text, subs) in sources.items()}
        logs = {name: fut.result() for name, fut in futures.items()}

    d = np.load(os.path.join(ROOT, "multicam_calibration_tpu_torch", "data", "detect_frames.npz"))
    clean = d["frames"][d["kind"] == "clean"]
    tiled = np.concatenate([clean] * -(-BATCH // len(clean)))[:BATCH]
    gray = torch.as_tensor(tiled, device=dev).float() / 255.0
    B, H, W = gray.shape
    twins = {s: cc.corner_response_peaks_reference(gray, s, NMS) for s in (1.5, 9.0)}
    stream = torch.cuda.current_stream().cuda_stream
    report = {"device": card, "shape": [B, H, W], "nms": NMS,
              "bound_ms": {str(s): corner_bound(B, H, W, s, NMS, True)[0] for s in SIGMAS},
              "variants": {}}
    libs = {}
    for name in sources:
        lib = ctypes.CDLL(paths[name])
        try:
            cc.bind(lib)
        except AttributeError:  # an older source without corner_smem_bytes
            pass
        libs[name] = lib
        entry = {"ptxas": all_ptxas(logs[name], ptxas_of), "runs": []}
        if not name.startswith("probe"):
            for s, (resp_t, peak_t) in twins.items():
                resp, peak = cc._launch(lib, stream, gray, s, NMS, True, name)
                if not (torch.equal(resp, resp_t) and torch.equal(peak.view(torch.bool), peak_t)):
                    raise AssertionError(f"{name}: kernel != twin at sigma {s}")
            entry["bit_equal_to_twin"] = True
        report["variants"][name] = entry
    order = list(sources)
    for pass_no, names in enumerate((order, order[::-1])):
        for name in names:
            lib = libs[name]
            ms = {f"peaks {s}": cuda_ms(torch, lambda: cc._launch(lib, stream, gray, s, NMS, True, name))
                  for s in SIGMAS}
            ms["response 1.5"] = cuda_ms(torch, lambda: cc._launch(lib, stream, gray, 1.5, 0, False, name))
            report["variants"][name]["runs"].append(ms)
            regs = {k: v["registers"] for k, v in report["variants"][name]["ptxas"].items()}
            spills = sum(v["spill_stores"] + v["spill_loads"]
                         for v in report["variants"][name]["ptxas"].values())
            print(f"pass {pass_no + 1} {name}: ms per call " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f"; registers {regs}; spill bytes {spills}", flush=True)
    with open(os.path.join(args.out, "exp_torch_corner.json"), "w") as f:
        json.dump(report, f, indent=1)
    for path in paths.values():  # the output directory is size-capped
        os.remove(path)


if __name__ == "__main__":
    main()

"""The suite's OpenMP setting: idle pool threads sleep, thread counts stay.

The repo's root conftest.py sets ``OMP_WAIT_POLICY=PASSIVE`` unless the
caller set it, before anything loads libgomp, so the xdist workers' idle
OpenMP threads stop spinning on each other's cores. It must change no thread
count: some tests' numbers depend on the BLAS thread count
(tests/test_torch_intrinsics_batch.py).

Real pytest runs with the suite's plugins run this file's parallel-region
test with ``OMP_DISPLAY_ENV=VERBOSE``, so libgomp itself reports the spin
count it took in every process that loads it: 0 for passive waiting, 3e10
for active, 3e5 when unset. A plugin or an import that loaded libgomp before
the conftest's line would report 3e5.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.abspath(__file__) + "::test_a_parallel_region"
SUITE_FLAGS = ["-q", "-s", "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "xdist"]
CASES = {  # name: (the caller's OMP_WAIT_POLICY, extra pytest flags, spin count)
    "unset-xdist-worker": (None, ["-n", "1"], "0"),
    "active-in-process": ("ACTIVE", [], "30000000000"),
}


def _env(**overrides):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")
           and k not in ("OMP_WAIT_POLICY", "GOMP_SPINCOUNT", "OMP_DISPLAY_ENV")}
    env.update({k: v for k, v in overrides.items() if v is not None})
    return env


def _threads(text):
    return int(re.search(r"THREADS (\d+)", text).group(1))


@pytest.fixture(scope="module")
def runs():
    """(stdout + stderr) of a pytest run of the parallel-region test for each
    case, and of a plain interpreter without the conftests ("plain"), run
    side by side."""
    cmds = {"plain": ([sys.executable, "-c",
                       "import torch; print('THREADS', torch.get_num_threads())"], _env())}
    for name, (caller, flags, _) in CASES.items():
        cmds[name] = ([sys.executable, "-m", "pytest", *SUITE_FLAGS, *flags, TARGET],
                      _env(OMP_WAIT_POLICY=caller, OMP_DISPLAY_ENV="VERBOSE"))
    procs = {k: subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, (cmd, env) in cmds.items()}
    try:
        out = {k: p.communicate(timeout=240) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        assert p.returncode == 0, "\n".join(out[k])
    return {k: "\n".join(o) for k, o in out.items()}


def test_a_parallel_region():
    """What the pytest runs below run: one parallel op, and torch's count."""
    assert torch.ones(1 << 16).sum().item() == 1 << 16
    print("THREADS", torch.get_num_threads(), file=sys.stderr)  # xdist keeps stdout


@pytest.mark.parametrize("case", list(CASES))
def test_every_test_process_takes_the_wait_policy_and_keeps_its_threads(case, runs):
    spincounts = re.findall(r"GOMP_SPINCOUNT = '(\d+)'", runs[case])
    assert spincounts and set(spincounts) == {CASES[case][2]}, runs[case]
    assert _threads(runs[case]) == _threads(runs["plain"])
    assert torch.get_num_threads() == _threads(runs["plain"])

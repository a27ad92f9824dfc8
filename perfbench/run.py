"""Run one benchmark cell once on this machine's CUDA device(s):

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output (see
``perfbench/harness/core.py``); exits with another code and prints no
result where the cell's cards are missing.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
# The checkout's root, not this folder, heads the import path: the program
# is imported from the checkout, and no folder here shadows a library.
sys.path = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path.insert(0, os.path.dirname(_HERE))

from perfbench.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))

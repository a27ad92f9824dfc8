"""Process settings for every test run from this checkout.

pytest loads a parent directory's conftest before a child's, so this file
runs before tests/conftest.py imports jax, and so before anything loads torch.
"""
import os

# Six xdist workers each keep an 8-thread OpenMP pool (torch's GNU OpenMP and
# MKL), and libgomp's default wait policy spins every idle pool thread on its
# core after each parallel region: 48 spinning threads starve the workers'
# real work. Passive waiting sleeps them and leaves every thread count, and so
# every parallel region's partition, as it was. libgomp reads the variable
# once, when it loads, so nothing may load it before this line (numpy, which
# pytest's plugins load first, brings no libgomp). Spawned ranks and
# subprocesses inherit it; a caller's own setting wins.
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")

"""`python -m multicam_calibration_tpu_torch` -> the CLI."""
import sys

from .cli import main

sys.exit(main())

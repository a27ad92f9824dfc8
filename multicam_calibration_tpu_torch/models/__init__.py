"""Model layer: the Schur-LM engine (``lm_core``), calibration
initialization (``initialize``) and bundle adjustment
(``bundle_adjustment``)."""

"""Model layer: the Schur-LM engine (``lm_core``), calibration
initialization (``initialize``), bundle adjustment (``bundle_adjustment``),
calibration uncertainty (``uncertainty``), flatibration
(``flatibration``) and rolling re-calibration (``streaming``)."""

"""Utilities: structured metrics and stage timers (``metrics``)."""
from .metrics import Metrics, metrics

__all__ = ["Metrics", "metrics"]

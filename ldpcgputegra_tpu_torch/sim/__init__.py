"""Monte-Carlo BER/FER simulation services."""

from .analyzer import ErrorAnalyzer, count_errors
from .terminal import Terminal
from .sweep import SnrPoint, SweepConfig, SweepResult, run_sweep

__all__ = [
    "ErrorAnalyzer",
    "count_errors",
    "Terminal",
    "SnrPoint",
    "SweepConfig",
    "SweepResult",
    "run_sweep",
]

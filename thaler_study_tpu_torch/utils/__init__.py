"""Profiling, instrumentation, and configuration utilities."""

from .config import (
    DEFAULT,
    FrameworkConfig,
    get_config,
    set_config,
    use_config,
)
from .counters import COUNTS, count_round
from .profiling import RoundTimer, device_trace

__all__ = [
    "COUNTS",
    "count_round",
    "FrameworkConfig",
    "DEFAULT",
    "RoundTimer",
    "device_trace",
    "get_config",
    "set_config",
    "use_config",
]

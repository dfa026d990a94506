"""Utilities (twin of ``allegro_tpu.utils``): rank-aware logging and
``profile_trace``."""

from .logging import RankedLogger
from .profiling import profile_trace

__all__ = ["RankedLogger", "profile_trace"]

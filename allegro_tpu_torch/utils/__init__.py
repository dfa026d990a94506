"""Utilities (twin of ``allegro_tpu.utils``): ``profile_trace``."""

from .profiling import profile_trace

__all__ = ["profile_trace"]

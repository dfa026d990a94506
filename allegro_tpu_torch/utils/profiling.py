"""Profiling hook (twin of ``allegro_tpu/utils/profiling.py``, which takes a
``jax.profiler`` trace): a ``torch.profiler`` trace of the block, CPU
activity and, where a card is present, CUDA kernels."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace the block with ``torch.profiler`` into ``log_dir`` as a Chrome
    trace (``trace_<pid>_<ns>.json``, viewable in Perfetto or
    ``chrome://tracing``); yields the profiler (its ``key_averages()`` gives
    time by operator and kernel). A no-op yielding None when ``log_dir`` is
    None or empty. The device is synchronized before the trace ends, so
    kernels queued in the block are in it."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))

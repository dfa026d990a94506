"""Rank-aware logging (twin of ``allegro_tpu/utils/logging.py``, the role
of nequip's ``RankedLogger``): in a run of several processes only process 0
emits, so logs are not repeated."""

from __future__ import annotations

import logging

import torch


def process_rank() -> int:
    """``torch.distributed.get_rank()`` where a process group is
    initialized; 0 otherwise (one process, as every entry point of the port
    runs: a mesh of several devices is one process)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class RankedLogger:
    def __init__(self, name: str = "allegro_tpu_torch", rank_zero_only: bool = True):
        self._logger = logging.getLogger(name)
        self.rank_zero_only = rank_zero_only

    def _should_log(self) -> bool:
        return not self.rank_zero_only or process_rank() == 0

    def __getattr__(self, level):
        if level in ("debug", "info", "warning", "error", "critical"):

            def log(msg, *args, **kwargs):
                if self._should_log():
                    getattr(self._logger, level)(msg, *args, **kwargs)

            return log
        raise AttributeError(level)

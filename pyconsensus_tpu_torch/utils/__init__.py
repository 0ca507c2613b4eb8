"""Profiling helpers (``pyconsensus_tpu/utils``): phase timers over
``obs`` and the profiler hook behind the command line's ``--profile``."""

from .profiling import PhaseTimer, trace

__all__ = ["PhaseTimer", "trace"]
